"""Weights: the JAX package's variables -> the port's state_dicts (detector,
physique net, discriminator), seeded random weights, conditioning of
random detector weights for a stable eval forward, and the ImageNet
backbone initialization (resolve_backbone_init, init_backbone).

The JAX detector's variables are ``{'params': ..., 'batch_stats': ...}``
trees under ``net/backbone`` (``Conv_0``, ``_BN_0``, ``Bottleneck_i`` or
``BasicBlock_i`` with ``Conv_j`` and ``_BN_j/BatchNorm_0``) and ``net/head``
(``ConvTranspose_i``, ``_BN_i``, ``Conv_0``). They arrive as nested dicts of
arrays, or as a flat ``.npz`` whose keys are ``params/<path>`` and
``batch_stats/<path>`` (the format of the JAX package's
tools/convert_torch_resnet.py). The port's keys are torchvision's plus
``head.features.N``, under ``net.``.

Conversions: conv kernels HWIO -> OIHW; a flax ConvTranspose kernel is the
torch ConvTranspose2d(k4, s2, p1) weight spatially flipped and transposed, so
its inverse is a flip, then a permute to (Cin, Cout, kh, kw); a flax Dense
kernel (in, out) is a Linear weight (out, in) transposed.

The physique net's flax tree is ``Conv_i`` (kernel, bias) and
``_BN_i/BatchNorm_0``; the port's is ``convs.i`` and ``bns.i``. The
discriminators':

* decoupled: ``{joint,bone}_input``, ``{joint,bone}_block<i>`` and
  ``{joint,bone}_final`` (``DenseSAGE_j/{lin_neigh,lin_root}``,
  ``GraphLayerNorm_j``) and ``header/Dense_{0,1}``; the port's
  ``{tag}_input``, ``{tag}_blocks.i.{sage,norm}.j``,
  ``{tag}_final.{sage,norm}.0`` and ``header.dense{0,1}``;
* SAGE: ``input``, ``block<i>``, ``final`` (as above) and ``header``; the
  port's ``input``, ``blocks.i``, ``final`` and ``header``;
* GCN: ``input``, ``DenseGCNLayer_k`` (``Dense_0/kernel`` and ``bias``),
  ``_StatelessBN_k`` (``scale``, ``bias``) and ``header``; the port's
  ``input``, ``gcn.k.{lin.weight,bias}``, ``bns.k.{weight,bias}`` and
  ``header``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn

from .models.physique import Conv3x3
from .models.resnet import RESNET_SPEC, BasicBlock, Bottleneck


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _conv(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))  # HWIO -> OIHW


def _conv_transpose(k) -> torch.Tensor:
    k = np.asarray(k)[::-1, ::-1]  # undo the spatial flip
    return _t(np.transpose(k, (2, 3, 0, 1)))  # (kh, kw, Cin, Cout) -> torch


def _bn(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    p, s = params["BatchNorm_0"], stats["BatchNorm_0"]
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])
    sd[prefix + ".running_mean"] = _t(s["mean"])
    sd[prefix + ".running_var"] = _t(s["var"])
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0)


def _depth(params: dict) -> int:
    for kind, name in (("bottleneck", "Bottleneck"), ("basic", "BasicBlock")):
        blocks = sum(1 for k in params if k.startswith(name + "_"))
        for depth, (k, counts) in RESNET_SPEC.items():
            if blocks and k == kind and sum(counts) == blocks:
                return depth
    raise ValueError("backbone tree matches no ResNet depth")


def state_dict_from_variables(variables: dict) -> dict:
    """JAX detector variables (nested dicts of arrays) -> the port's
    detector state_dict (``net.backbone.*``, ``net.head.*``)."""
    params = variables["params"]["net"]
    stats = variables["batch_stats"]["net"]
    sd = _backbone_state_dict(params["backbone"], stats["backbone"])
    hp, hs = params["head"], stats["head"]
    layer = 0
    while f"ConvTranspose_{layer}" in hp:
        sd[f"net.head.features.{3 * layer}.weight"] = _conv_transpose(
            hp[f"ConvTranspose_{layer}"]["kernel"])
        _bn(sd, f"net.head.features.{3 * layer + 1}", hp[f"_BN_{layer}"],
            hs[f"_BN_{layer}"])
        layer += 1
    sd[f"net.head.features.{3 * layer}.weight"] = _conv(hp["Conv_0"]["kernel"])
    sd[f"net.head.features.{3 * layer}.bias"] = _t(hp["Conv_0"]["bias"])
    return sd


def _backbone_state_dict(bp: dict, bs: dict) -> dict:
    """A JAX ResNetBackbone's params and batch_stats -> ``net.backbone.*``
    entries of the port's detector state_dict."""
    kind, counts = RESNET_SPEC[_depth(bp)]
    sd: dict = {"net.backbone.conv1.weight": _conv(bp["Conv_0"]["kernel"])}
    _bn(sd, "net.backbone.bn1", bp["_BN_0"], bs["_BN_0"])
    name = "BasicBlock" if kind == "basic" else "Bottleneck"
    n_convs = 2 if kind == "basic" else 3
    flax_block = 0
    for stage, blocks in enumerate(counts):
        for i in range(blocks):
            mod = f"{name}_{flax_block}"
            pre = f"net.backbone.layer{stage + 1}.{i}"
            for c in range(n_convs):
                sd[f"{pre}.conv{c + 1}.weight"] = _conv(
                    bp[mod][f"Conv_{c}"]["kernel"])
                _bn(sd, f"{pre}.bn{c + 1}", bp[mod][f"_BN_{c}"],
                    bs[mod][f"_BN_{c}"])
            if f"Conv_{n_convs}" in bp[mod]:
                sd[f"{pre}.downsample.0.weight"] = _conv(
                    bp[mod][f"Conv_{n_convs}"]["kernel"])
                _bn(sd, f"{pre}.downsample.1", bp[mod][f"_BN_{n_convs}"],
                    bs[mod][f"_BN_{n_convs}"])
            flax_block += 1
    return sd


def physique_state_dict(variables: dict) -> dict:
    """JAX physique variables ({'params', 'batch_stats'}) -> the port's
    PhysiqueMaskGenerator state_dict."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict = {}
    i = 0
    while f"Conv_{i}" in params:
        sd[f"convs.{i}.weight"] = _conv(params[f"Conv_{i}"]["kernel"])
        sd[f"convs.{i}.bias"] = _t(params[f"Conv_{i}"]["bias"])
        if f"_BN_{i}" in params:
            _bn(sd, f"bns.{i}", params[f"_BN_{i}"], stats[f"_BN_{i}"])
        i += 1
    return sd


def _dense(sd: dict, prefix: str, p: dict) -> None:
    sd[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])


def discriminator_state_dict(params: dict) -> dict:
    """JAX discriminator params (any of the three) -> the port's
    state_dict."""
    sd: dict = {}

    def block(prefix: str, p: dict) -> None:
        j = 0
        while f"DenseSAGE_{j}" in p:
            sage = p[f"DenseSAGE_{j}"]
            _dense(sd, f"{prefix}.sage.{j}.lin_neigh", sage["lin_neigh"])
            _dense(sd, f"{prefix}.sage.{j}.lin_root", sage["lin_root"])
            norm = p[f"GraphLayerNorm_{j}"]
            sd[f"{prefix}.norm.{j}.weight"] = _t(norm["scale"])
            sd[f"{prefix}.norm.{j}.bias"] = _t(norm["bias"])
            j += 1

    if "DenseGCNLayer_0" in params:  # GCNDiscriminator
        k = 0
        while f"DenseGCNLayer_{k}" in params:
            layer = params[f"DenseGCNLayer_{k}"]
            _dense(sd, f"gcn.{k}.lin", layer["Dense_0"])
            sd[f"gcn.{k}.bias"] = _t(layer["bias"])
            k += 1
        k = 0
        while f"_StatelessBN_{k}" in params:
            sd[f"bns.{k}.weight"] = _t(params[f"_StatelessBN_{k}"]["scale"])
            sd[f"bns.{k}.bias"] = _t(params[f"_StatelessBN_{k}"]["bias"])
            k += 1
    for tag in ("joint_", "bone_", ""):
        if f"{tag}input" not in params:
            continue
        _dense(sd, f"{tag}input", params[f"{tag}input"])
        i = 0
        while f"{tag}block{i}" in params:
            block(f"{tag}blocks.{i}", params[f"{tag}block{i}"])
            i += 1
        if f"{tag}final" in params:
            block(f"{tag}final", params[f"{tag}final"])
    if "Dense_0" in params["header"]:  # the decoupled FFN header
        _dense(sd, "header.dense0", params["header"]["Dense_0"])
        _dense(sd, "header.dense1", params["header"]["Dense_1"])
    else:
        _dense(sd, "header", params["header"])
    return sd


def _load_npz_tree(path: str) -> dict:
    """A flat ``.npz`` whose keys are ``/``-separated paths -> nested
    dicts of arrays."""
    variables: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = variables
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return variables


def load_npz(path: str) -> dict:
    """A flat ``.npz`` of detector variables -> the port's state_dict."""
    return state_dict_from_variables(_load_npz_tree(path))


DEFAULT_PRETRAINED_DIR = "data/pretrained"


def resolve_backbone_init(spec: str | None, depth: int) -> str | None:
    """The file an ImageNet backbone initialization reads, as the JAX
    package's tools/convert_torch_resnet.py:resolve_backbone_init finds it
    (the reference loads the torchvision model zoo at construction,
    network.py:46-54; nothing is fetched here):

      * ``None``: ``data/pretrained/resnet<depth>_imagenet.npz``, else a
        ``.pth`` or ``.pt`` of that name, else None (fresh weights);
      * ``*.npz``: the JAX package's converted backbone, used as-is;
      * ``*.pth`` / ``*.pt`` / ``*.pth.tar``: a torchvision checkpoint,
        whose names are the port's, so it loads without a conversion.

    A named file that does not exist is an error."""
    if spec is None:
        base = os.path.join(DEFAULT_PRETRAINED_DIR,
                            f"resnet{depth}_imagenet")
        for ext in (".npz", ".pth", ".pt"):
            if os.path.isfile(base + ext):
                return base + ext
        return None
    if spec.endswith(".npz"):
        if not os.path.isfile(spec):
            raise FileNotFoundError(
                f"backbone_init npz not found: {spec} — convert a "
                "torchvision checkpoint with tools/convert_torch_resnet "
                "or pass the .pth directly for auto-conversion"
            )
        return spec
    if spec.endswith((".pth", ".pt", ".pth.tar")):
        if not os.path.isfile(spec):
            raise FileNotFoundError(
                f"backbone_init torch checkpoint not found: {spec}"
            )
        return spec
    raise ValueError(
        f"backbone_init must be a .npz or torch .pth/.pt checkpoint, "
        f"got: {spec}"
    )


def backbone_state_dict(path: str) -> dict:
    """The ``net.backbone.*`` entries of the port's detector state_dict in
    a backbone file: a JAX npz (``params/...``, ``batch_stats/...`` of a
    ResNetBackbone) or a torchvision state_dict (its ``fc`` and
    ``num_batches_tracked`` entries dropped)."""
    if path.endswith(".npz"):
        tree = _load_npz_tree(path)
        sd = _backbone_state_dict(tree["params"], tree["batch_stats"])
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        sd = {"net.backbone." + k: v.float() for k, v in raw.items()
              if not k.startswith("fc.")}
    return {k: v for k, v in sd.items() if "num_batches_tracked" not in k}


def init_backbone(detector: nn.Module, path: str) -> None:
    """Loads the backbone of `path` (backbone_state_dict) into `detector`;
    every entry must name one of its tensors, at its shape."""
    sd = backbone_state_dict(path)
    own = detector.state_dict()
    bad = [k for k, v in sd.items()
           if k not in own or own[k].shape != v.shape]
    if bad:
        raise ValueError(f"backbone_init {path}: entries that match no "
                         f"tensor of the detector: {bad[:8]}")
    detector.load_state_dict(sd, strict=False)


def init_weights(module: nn.Module, seed: int) -> None:
    """Seeded random weights, as the JAX package initializes them:
    He-normal (fan-out) convs with zero bias; LeCun-normal (fan-in) Linear
    weights with zero bias (flax's lecun_normal draws from a truncated
    normal); BN scale 1, bias 0, fresh statistics; LayerNorm-style
    parameters stay as built (ones and zeros)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, Conv3x3)):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                nn.init.kaiming_normal_(w, mode="fan_out",
                                        nonlinearity="relu", generator=gen)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def condition_for_eval(det: nn.Module, images: torch.Tensor,
                       branch_gamma: float = 0.1) -> None:
    """Make random weights give a stable eval forward.

    An untrained 50-layer eval forward with fresh running statistics
    (mean 0, var 1) amplifies rounding until its outputs are noise. So the
    last BN scale of each residual branch is set to `branch_gamma`, and every
    BN's running statistics become the batch statistics of one train-mode
    forward over `images` (CPU only: train mode runs the plain layers)."""
    if images.device.type != "cpu":
        raise ValueError("condition_for_eval runs on the CPU")
    bns = [m for m in det.modules() if isinstance(m, nn.BatchNorm2d)]
    with torch.no_grad():
        for m in det.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.fill_(branch_gamma)
            elif isinstance(m, BasicBlock):
                m.bn2.weight.fill_(branch_gamma)
        for bn in bns:
            bn.reset_running_stats()
            bn.momentum = None  # cumulative average: one batch = its stats
        det.train()
        try:
            det.net(images)
        finally:
            for bn in bns:
                bn.momentum = 0.1
            det.eval()
