"""Plain PyTorch reference of the measured model: the integral pose
detector (ResNet backbone, deconvolution head, multi-hypothesis soft-argmax
decode), the physique mask net, the decoupled SAGE pose discriminator, the
line renderer, every loss of the fused GAN step and both Adams.

It follows the paper's model (arXiv 2411.13026) as the configuration files
under ``bench_h100/configs`` state it, in float32 with TF32 off, with no
custom kernel, no fused BatchNorm link and no cache. It imports nothing of
the program under test. Parameter and buffer names are the program's, so
one state dict made by the benchmark loads into both.

``Numerics`` says how the GEMM-like operations (convolutions, transposed
convolutions, linear layers, the graph's adjacency products) round their
operands: float32 as they come, or float8 e4m3 with one scale per tensor
(the correctness control, one precision below the program's bfloat16).

Memory: at 4 cameras x 32 images of 256^2 a step keeps some 80 GB of
float32 activations. ``checkpoint_regions`` makes each backbone stage, the
head, the decode, the line render and the physique net a region that keeps
its inputs and recomputes the rest in the backward (torch.utils.checkpoint).
The arithmetic is the same either way. BatchNorm here normalizes with the
batch statistics in training and keeps no running statistics: the
compared numbers do not read them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

E4M3_MAX = 448.0


@dataclass
class Numerics:
    """``operands``: "fp32" or "fp8" (per-tensor scaled e4m3)."""

    operands: str = "fp32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.operands == "fp32":
            return x
        if self.operands != "fp8":
            raise ValueError(f"unknown operand precision {self.operands!r}")
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = E4M3_MAX / amax
        # rounded in the forward, straight through in the backward; the
        # backward's GEMMs take the rounded operands saved by autograd
        r = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (r - x).detach()


FP32 = Numerics()


# ------------------------------------------------------------------ layers


class BN(nn.Module):
    """BatchNorm2d: batch statistics in training (biased variance), the
    running statistics in eval."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))
        # set by ``condition_running_stats``: the next training forward
        # writes its batch mean and biased variance into the running ones
        self.record = False

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        if self.record:
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        c = (1, -1, 1, 1)
        return ((x - mean.view(c)) * torch.rsqrt(var.view(c) + self.eps)
                * self.weight.view(c) + self.bias.view(c))


class Conv(nn.Conv2d):
    num = FP32

    def forward(self, x):
        q = self.num.q
        return F.conv2d(q(x), q(self.weight), self.bias, self.stride,
                        self.padding)


class Deconv(nn.ConvTranspose2d):
    num = FP32

    def forward(self, x):
        q = self.num.q
        return F.conv_transpose2d(q(x), q(self.weight), None, self.stride,
                                  self.padding)


class Linear(nn.Linear):
    num = FP32

    def forward(self, x):
        q = self.num.q
        return F.linear(q(x), q(self.weight), self.bias)


def set_numerics(module: nn.Module, num: Numerics) -> None:
    for m in module.modules():
        if isinstance(m, (Conv, Deconv, Linear, Conv3x3, DenseSAGE)):
            m.num = num


# ---------------------------------------------------------------- detector

RESNET = {18: ("basic", (2, 2, 2, 2)), 50: ("bottleneck", (3, 4, 6, 3))}


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride, down):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BN(planes)
        self.conv2 = Conv(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BN(planes)
        self.downsample = (nn.Sequential(Conv(cin, planes, 1, stride,
                                              bias=False), BN(planes))
                           if down else None)

    def forward(self, x):
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride, down):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1, bias=False)
        self.bn1 = BN(planes)
        self.conv2 = Conv(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BN(planes)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False)
        self.bn3 = BN(planes * 4)
        self.downsample = (nn.Sequential(Conv(cin, planes * 4, 1, stride,
                                              bias=False), BN(planes * 4))
                           if down else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Backbone(nn.Module):
    def __init__(self, depth: int):
        super().__init__()
        kind, counts = RESNET[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BN(64)
        cin = 64
        for s, n in enumerate(counts):
            planes = 64 * 2 ** s
            layers = []
            for i in range(n):
                stride = 2 if s > 0 and i == 0 else 1
                out = planes * block.expansion
                layers.append(block(cin, planes, stride,
                                    stride != 1 or cin != out))
                cin = out
            self.add_module(f"layer{s + 1}", nn.Sequential(*layers))
        self.out_channels = cin

    def stages(self):
        stem = lambda x: F.max_pool2d(  # noqa: E731
            F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        return [stem] + [getattr(self, f"layer{i}") for i in range(1, 5)]


class Head(nn.Module):
    def __init__(self, cin: int, k: int, d: int, filters: int = 256):
        super().__init__()
        layers = []
        for i in range(3):
            layers += [Deconv(cin if i == 0 else filters, filters, 4, 2, 1,
                              bias=False), BN(filters), nn.ReLU()]
        layers.append(Conv(filters, k * d, 1))
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        return self.features(x)


class PoseNet(nn.Module):
    def __init__(self, k: int, d: int, depth: int):
        super().__init__()
        self.backbone = Backbone(depth)
        self.head = Head(self.backbone.out_channels, k, d)


class Detector(nn.Module):
    """Images (N, 3, S, S) -> keypoints (N, hypotheses, K, 3) in [-1, 1]."""

    def __init__(self, p: dict):
        super().__init__()
        self.k, self.d = p["num_kp"], p["depth_dim"]
        self.hypos, self.window = p["num_hypo"], p["neighbor_size"]
        self.net = PoseNet(self.k, self.d, p.get("num_layers", 50))
        self.checkpoint_regions = False

    def _region(self, fn, x):
        if self.checkpoint_regions and torch.is_grad_enabled():
            return _checkpoint(fn, x, use_reentrant=False)
        return fn(x)

    def forward(self, img):
        x = img
        for stage in self.net.backbone.stages():
            x = self._region(stage, x)
        logits = self._region(self.net.head, x)
        return self._region(self.decode, logits)

    def decode(self, logits):
        return decode_multi(logits, self.k, self.hypos, self.window)


def decode_multi(logits, k: int, hypos: int, window: int):
    """Softmax over each joint's (D, H, W) volume; x, y the expectations of
    its marginals; z the expectation over a window of `window` bins about
    each of the `hypos` strongest local maxima of the depth marginal
    (strongest first, ties to the lower bin)."""
    b, c, h, w = logits.shape
    d = c // k
    p = torch.softmax(logits.reshape(b, k, d * h * w), dim=-1)
    p = p.reshape(b, k, d, h, w)
    mx, my, mz = p.sum(dim=(2, 3)), p.sum(dim=(2, 4)), p.sum(dim=(3, 4))

    def expect(m):
        return (m * torch.arange(m.shape[-1], device=m.device,
                                 dtype=m.dtype)).sum(-1)

    x = expect(mx) / h * 2.0 - 1.0
    y = expect(my) / w * 2.0 - 1.0
    inner = mz[..., 1:-1]
    peak = (inner >= mz[..., :-2]) & (inner >= mz[..., 2:])
    score = torch.where(peak, inner, torch.zeros_like(inner))
    idx = torch.sort(score, dim=-1, descending=True,
                     stable=True).indices[..., :hypos] + 1
    bins = torch.arange(d, device=mz.device, dtype=mz.dtype)
    pad = window // 2

    def wsum(v):
        return F.pad(v, (pad, pad)).unfold(-1, window, 1).sum(-1)

    z = wsum(mz * bins).gather(-1, idx) / wsum(mz).gather(-1, idx)
    z = z / d * 2.0 - 1.0
    xy = torch.stack([x, y], -1)[:, None].expand(b, hypos, k, 2)
    return torch.cat([xy, z.permute(0, 2, 1)[..., None]], dim=-1)


# ------------------------------------------------------------ physique net


class Conv3x3(nn.Module):
    num = FP32

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        q = self.num.q
        return F.conv2d(q(x), q(self.weight), self.bias, self.stride, 1)


class Physique(nn.Module):
    """Rendered line mask (N, 1, S, S) -> silhouette (N, 1, S, S): an
    encoder of (conv, stride-2 conv) pairs and a decoder of (conv, 2x
    bilinear upsample, conv), each conv followed by BatchNorm and a leaky
    ReLU of slope 0.01, then a last conv and a sigmoid."""

    def __init__(self, nf):
        super().__init__()
        ops = [("conv", nf[0], 1)]
        for i in range(1, len(nf)):
            ops += [("conv", nf[i - 1], 1), ("conv", nf[i], 2)]
        for i in range(len(nf) - 1, 0, -1):
            ops += [("conv", nf[i], 1), ("up",), ("conv", nf[i - 1], 1)]
        self.ops = ops
        convs, bns, cin = [], [], 1
        for op in ops:
            if op[0] == "conv":
                convs.append(Conv3x3(cin, op[1], op[2]))
                bns.append(BN(op[1]))
                cin = op[1]
        convs.append(Conv3x3(cin, 1))
        self.convs, self.bns = nn.ModuleList(convs), nn.ModuleList(bns)

    def forward(self, x):
        i = 0
        for op in self.ops:
            if op[0] == "up":
                x = F.interpolate(x, scale_factor=2, mode="bilinear",
                                  align_corners=False)
                continue
            x = F.leaky_relu(self.bns[i](self.convs[i](x)), 0.01)
            i += 1
        return torch.sigmoid(self.convs[i](x))


# ----------------------------------------------------------- discriminator


def _adjacency(parents, children, n: int, self_loop: bool) -> np.ndarray:
    a = np.eye(n, dtype=np.float32) if self_loop else np.zeros(
        (n, n), dtype=np.float32)
    for p, c in zip(parents, children):
        a[p, c] = a[c, p] = 1.0
    return a / a.sum(axis=1, keepdims=True).clip(1e-12)


def _positional(n: int, c: int) -> np.ndarray:
    pe = np.zeros((n, c), dtype=np.float32)
    for i in range(n):
        for j in range(c):
            arg = i / 10000 ** (2 * j / c)
            pe[i, j] = math.sin(arg) if j % 2 == 0 else math.cos(arg)
    return pe


class DenseSAGE(nn.Module):
    """Mean-aggregating graph convolution on a fixed adjacency with self
    loops: rownorm(A) x W_neigh + b + x W_root."""

    num = FP32

    def __init__(self, cin, cout):
        super().__init__()
        self.lin_neigh = Linear(cin, cout)
        self.lin_root = Linear(cin, cout, bias=False)

    def forward(self, x, adj):
        q = self.num.q
        return self.lin_neigh(torch.einsum("ij,bjc->bic", q(adj), q(x))) \
            + self.lin_root(x)


class GraphNorm(nn.Module):
    """LayerNorm over the (nodes, channels) of each sample."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(-2, -1), keepdim=True,
                                   correction=0)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight \
            + self.bias


class SAGEBlock(nn.Module):
    def __init__(self, cin, hidden, cout, single=False):
        super().__init__()
        self.single = single
        dims = [(cin, cout)] if single else [(cin, hidden), (hidden, cout)]
        self.sage = nn.ModuleList([DenseSAGE(a, b) for a, b in dims])
        self.norm = nn.ModuleList([GraphNorm(b) for _, b in dims])

    def forward(self, x, adj):
        y = x
        for sage, norm in zip(self.sage, self.norm):
            y = F.relu(norm(sage(y, adj)))
        return y if self.single else y + x


class Header(nn.Module):
    def __init__(self, cin, hidden=512, p=0.2):
        super().__init__()
        self.dense0 = Linear(cin, hidden)
        self.dense1 = Linear(hidden, 1)
        self.p = p

    def forward(self, x, generator):
        x = F.relu(self.dense0(x))
        if self.training and self.p > 0:
            keep = 1.0 - self.p
            u = torch.rand(x.shape, generator=generator, device=x.device,
                           dtype=x.dtype)
            x = torch.where(u < keep, x / keep, torch.zeros_like(x))
        return self.dense1(x)


class Discriminator(nn.Module):
    """Two SAGE streams, over joint positions and over root-padded bone
    vectors (each with a sinusoidal joint encoding), concatenated into a
    dropout FFN: poses (N, K, 3) -> logits (N, 1)."""

    def __init__(self, p: dict, parents, children):
        super().__init__()
        if not p.get("use_pe", False) or p.get("use_aug", False):
            raise ValueError("the reference has the decoupled discriminator "
                             "with use_pe and without use_aug")
        n, c = p["num_node"], p.get("disc_sup_dim", 3)
        self.sup = c
        self.parents, self.children_ids = list(parents), list(children)
        self.register_buffer("adj", torch.from_numpy(
            _adjacency(parents, children, n, p.get("use_self_loop", True))),
            persistent=False)
        self.register_buffer("pe", torch.from_numpy(_positional(n, c)),
                             persistent=False)
        ind, hid, out = p["input_dim"], p["hidden_dim"], p["output_dim"]
        for tag in ("joint", "bone"):
            setattr(self, f"{tag}_input", Linear(2 * c, ind))
            setattr(self, f"{tag}_blocks", nn.ModuleList([
                SAGEBlock(ind if i == 0 else hid, hid, hid)
                for i in range(p.get("num_layers", 2))]))
            setattr(self, f"{tag}_final", SAGEBlock(hid, hid, out, True))
        self.header = Header(2 * n * out)

    def _stream(self, x, tag):
        x = getattr(self, f"{tag}_input")(x)
        for block in getattr(self, f"{tag}_blocks"):
            x = block(x, self.adj)
        x = getattr(self, f"{tag}_final")(x, self.adj)
        return x.reshape(x.shape[0], -1)

    def forward(self, poses, generator):
        poses = poses[..., :self.sup]
        b = poses.shape[0]
        bone = torch.cat([poses.new_zeros((b, 1, poses.shape[2])),
                          poses[:, self.parents] - poses[:, self.children_ids]],
                         dim=1)
        pe = self.pe.expand(b, -1, -1)
        feats = torch.cat([self._stream(torch.cat([poses, pe], -1), "joint"),
                           self._stream(torch.cat([bone, pe], -1), "bone")],
                          dim=-1)
        return self.header(feats, generator)


# ---------------------------------------------------------------- geometry


def skeleton_lines(parent_ids, line_select_ids, extension: bool):
    """(parents, children) of the bones: joint 0 dropped, the selected
    lines kept, and for rendering 8 body lines appended."""
    parents = list(parent_ids)[1:]
    children = list(range(1, len(parent_ids)))
    if line_select_ids is not None:
        parents = [parents[i] for i in line_select_ids]
        children = [children[i] for i in line_select_ids]
    if extension:
        parents += [7, 7, 7, 7, 0, 0, 1, 4]
        children += [1, 4, 11, 14, 2, 5, 14, 11]
    return parents, children


def render_lines(kps2d, side: int, parents, children, width: float):
    """max over bones of exp(-d^2 / width), d the distance of each pixel
    centre of an S^2 grid over [-1, 1]^2 to the bone's segment: (N, 1, S,
    S). The four arm bones fall off twice as fast when there are >= 21
    lines."""
    s = kps2d[:, children]  # (N, L, 2) start
    e = kps2d[:, parents]
    v = e - s
    coord = torch.linspace(-1.0, 1.0, side, device=kps2d.device)
    gy, gx = torch.meshgrid(coord, coord, indexing="ij")
    g = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)  # (S*S, 2)
    ds = g[None, None] - s[:, :, None]  # (N, L, S*S, 2)
    t = (ds * v[:, :, None]).sum(-1) / (1e-8 + (v * v).sum(-1))[..., None]
    de = g[None, None] - e[:, :, None]
    foot = ds - t[..., None] * v[:, :, None]
    sq = torch.where(t <= 0, (ds * ds).sum(-1),
                     torch.where(t >= 1, (de * de).sum(-1),
                                 (foot * foot).sum(-1)))
    neg = -sq / width
    if len(parents) >= 21:
        sharp = torch.ones(len(parents), device=kps2d.device)
        sharp[[11, 12, 14, 15]] = 2.0
        neg = neg * sharp[None, :, None]
    n = kps2d.shape[0]
    return torch.exp(neg).amax(dim=1).reshape(n, 1, side, side)


def patch_to_world(kps, cam: dict, side: int, rect: float = 2000.0):
    """Normalized patch keypoints (N, K, 3) -> world mm: patch pixels ->
    full image through the inverse crop affine, depth scaled by rect / side
    about the pelvis, pinhole back-projection, then R^T (x_cam - t)."""
    x = (kps[..., 0] + 1.0) / 2.0 * (side - 1)
    y = (kps[..., 1] + 1.0) / 2.0 * (side - 1)
    z = kps[..., 2] * (side - 1)
    a = cam["trans_image"]
    lin, off = a[:, :, :2], a[:, :, 2]
    xy = torch.stack([x, y], -1) - off[:, None]
    xy = torch.einsum("nij,nkj->nki", torch.linalg.inv(lin), xy)
    z = z * (rect / side) + cam["pelvis"][:, 2:3]
    k = cam["k_mat"]
    u = (xy[..., 0] - k[:, 0, 2:3]) / k[:, 0, 0:1] * z
    v = (xy[..., 1] - k[:, 1, 2:3]) / k[:, 1, 1:2] * z
    c = torch.stack([u, v, z], -1) - cam["trans_world"][:, None]
    return torch.einsum("nij,nkj->nki", torch.linalg.inv(cam["rot_world"]), c)


# ------------------------------------------------------------------ losses

_BONE_CHILD = (16, 15, 13, 12, 3, 2, 6, 5)
_BONE_PARENT = (15, 14, 12, 11, 2, 1, 5, 4)


def bone_sym(kw):
    length = torch.linalg.vector_norm(
        kw[:, list(_BONE_CHILD)] - kw[:, list(_BONE_PARENT)], dim=2) * 1e-3
    return ((length[:, 0::2] - length[:, 1::2]) ** 2).mean()


def kp_sym(kw, metric: bool = True):
    center = (kw[:, [11, 1]] + kw[:, [14, 4]]) / 2.0
    d = center - kw[:, [kw.shape[1] - 1, 0]]
    return ((d * 1e-3) ** 2).mean() if metric else (d ** 2).mean()


def lsgan(pred, real=None):
    """Least squares GAN loss, min over hypotheses of (N, H, 1) logits."""
    def red(t):
        return torch.amin(t, dim=1).mean() if t.dim() == 3 else t.mean()

    if real is None:
        return red((pred - 1.0) ** 2)
    return 0.5 * red((real - 1.0) ** 2) + 0.5 * red(pred ** 2)


# -------------------------------------------------------------------- GAN


class Gan(nn.Module):
    """The detector, physique net and discriminator of a configuration, in
    float32, named as the program names them."""

    def __init__(self, config: dict):
        super().__init__()
        mp = config["model_params"]
        self.cams = list(mp["cam_id_list"])
        self.loss_config = mp["loss_config"]
        self.side = int(config["train_params"]["patch_width"])
        self.rect = float(config["train_params"].get("rect_3d_width", 2000))
        self.width = float(mp.get("body_width", 3.0)) * 1e-3
        self.render_parents, self.render_children = skeleton_lines(
            mp["parent_ids"], mp.get("line_select_ids"), True)
        dp, dc = skeleton_lines(mp["parent_ids"], mp.get("line_select_ids"),
                                False)
        self.detector = Detector(mp["detector_params"])
        self.physique = Physique(
            mp["physique_mask_generator_params"]["layers"])
        self.discriminator = Discriminator(mp["smpl_disc_params"], dp, dc)
        self.checkpoint_regions = False

    def set_checkpoint_regions(self, on: bool) -> None:
        self.checkpoint_regions = on
        self.detector.checkpoint_regions = on

    def _region(self, fn, *args):
        if self.checkpoint_regions and torch.is_grad_enabled():
            return _checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _stack(self, batch, suffix):
        return torch.cat([batch[f"cam_{c}_{suffix}"] for c in self.cams])

    def generator_losses(self, batch, generator):
        """(losses {name: scalar}, the camera stream's keypoints)."""
        cfg, nc, side = self.loss_config, len(self.cams), self.side
        imgs = self._stack(batch, "img").permute(0, 3, 1, 2)
        b = imgs.shape[0] // nc
        kps = self.detector(imgs)
        kps_all = kps.reshape(nc, b, *kps.shape[1:])  # (C, B, H, K, 3)
        nh = kps_all.shape[2]
        world = []
        for i, c in enumerate(self.cams):
            cam = {k: batch[f"cam_{c}_{k}"].repeat_interleave(nh, dim=0)
                   for k in ("trans_image", "pelvis", "k_mat", "trans_world",
                             "rot_world")}
            w = patch_to_world(kps_all[i].reshape(b * nh, -1, 3), cam, side,
                               self.rect)
            world.append(w.reshape(b, nh, -1, 3))
        losses = {}
        kps2d = kps_all[:, :, 0, :, :2].reshape(nc * b, -1, 2)
        masks = self._region(
            lambda k: render_lines(k, side, self.render_parents,
                                   self.render_children, self.width), kps2d)
        if "symmetry_loss" in cfg:
            w8 = cfg["symmetry_loss"]["weight"]
            total = 0.0
            for i in range(nc):
                per = []
                for h in range(nh):
                    kw = world[i][:, h]
                    val = bone_sym(kw) * w8["bone"] + kp_sym(kw) * w8["kp"]
                    if "kp_2d" in w8:
                        val = val + kp_sym(kps_all[i, :, h, :, :2],
                                           False) * 1e2 * w8["kp_2d"]
                    per.append(val)
                total = total + torch.amin(torch.stack(per))
            losses["symmetry"] = total
        if "smpl_gen_loss" in cfg:
            pw = torch.stack(world)
            pw = (pw - pw[:, :, :, :1]) / 1000.0
            logits = self.discriminator(
                pw.reshape(nc * b * nh, -1, 3).detach(), generator)
            losses["smpl_gen"] = (lsgan(logits.reshape(nc * b, nh, 1)) * nc
                                  * cfg["smpl_gen_loss"]["weight"])
        if "smpl_pseudo_img_loss" in cfg:
            kp = self.detector(self._stack(batch, "pseudo_img").permute(
                0, 3, 1, 2))
            kp = kp.reshape(nc, b, *kp.shape[1:])
            total = 0.0
            for i, c in enumerate(self.cams):
                gt = batch[f"cam_{c}_pseudo_joints"]
                total = total + torch.amin(torch.stack(
                    [((kp[i, :, h] - gt) ** 2).mean() for h in range(nh)]))
            losses["smpl_pseudo_img"] = (total
                                         * cfg["smpl_pseudo_img_loss"]["weight"])
        gt_masks = self._stack(batch, "mask").permute(0, 3, 1, 2)
        if "physique_recons_loss" in cfg:
            phy = self._region(self.physique, masks)
            losses["physique_recons"] = (((phy - gt_masks) ** 2).mean() * nc
                                         * cfg["physique_recons_loss"]["weight"])
        if "recons_loss" in cfg:
            total = 0.0
            for i in range(nc):
                m, g = masks[i * b:(i + 1) * b], gt_masks[i * b:(i + 1) * b]
                mse = ((m - g) ** 2).mean()
                total = total + mse * (m > 0.1).float().mean()
            losses["reconstruction"] = total * cfg["recons_loss"]["weight"]
        return losses, kps

    def discriminator_loss(self, batch, kps, generator):
        nc = len(self.cams)
        pred = kps.detach()
        cb, nh = pred.shape[:2]
        smpl = self._stack(batch, "pseudo_joints")
        pred_logits = self.discriminator(pred.reshape(cb * nh, -1, 3),
                                         generator).reshape(cb, nh, 1)
        real_logits = self.discriminator(smpl, generator)
        return (lsgan(pred_logits, real_logits) * nc
                * self.loss_config["smpl_disc_loss"]["weight"])


class Adam:
    """Adam(betas, eps) on a list of tensors, by the textbook update."""

    def __init__(self, params, betas=(0.5, 0.999), eps=1e-8):
        self.params = params
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads, lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * (m / c1) / ((v / c2).sqrt() + self.eps))


class GanTrainer:
    """The fused GAN step: generator losses and their gradients (the
    discriminator's share of them carried to its next update), the
    discriminator's loss on the detached predictions, then both Adams."""

    def __init__(self, gan: Gan, config: dict):
        self.gan = gan.train()
        tp = config["train_params"]
        self.lr_gen = float(tp["lr_kp_detector"])
        self.lr_disc = float(tp["lr_discriminator"])
        self.gen = [("detector." + n, p)
                    for n, p in gan.detector.named_parameters()]
        self.gen += [("physique." + n, p)
                     for n, p in gan.physique.named_parameters()]
        self.disc = [("discriminator." + n, p)
                     for n, p in gan.discriminator.named_parameters()]
        self.opt_gen = Adam([p for _, p in self.gen])
        self.opt_disc = Adam([p for _, p in self.disc])
        self.carry = [torch.zeros_like(p) for _, p in self.disc]
        # {leaf: the gradient each Adam took at the first step}
        self.first_grads = None

    def step(self, batch, generator) -> dict:
        gen_p = [p for _, p in self.gen]
        disc_p = [p for _, p in self.disc]
        losses, kps = self.gan.generator_losses(batch, generator)
        total = sum(v.mean() for v in losses.values())
        grads = torch.autograd.grad(total, gen_p + disc_p, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, gen_p + disc_p)]
        g_gen, g_carry = grads[:len(gen_p)], grads[len(gen_p):]
        loss_disc = self.gan.discriminator_loss(batch, kps, generator)
        d = torch.autograd.grad(loss_disc, disc_p, allow_unused=True)
        d = [torch.zeros_like(p) if g is None else g
             for g, p in zip(d, disc_p)]
        d = [a + c for a, c in zip(d, self.carry)]
        if self.first_grads is None:
            self.first_grads = {n: g.detach().clone() for (n, _), g in
                                zip(self.gen + self.disc, g_gen + d)}
        self.opt_disc.step(d, self.lr_disc)
        self.opt_gen.step(g_gen, self.lr_gen)
        self.carry = [g.detach() for g in g_carry]
        return {"loss_total": float(total.detach()),
                "loss_disc": float(loss_disc.detach())}

    def named_params(self) -> dict:
        return {n: p for n, p in self.gen + self.disc}
