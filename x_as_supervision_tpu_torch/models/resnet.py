"""ResNet backbone + deconvolution head of the integral pose detector,
ported from the JAX package's models/resnet.py, in eval and train mode.

Parameter names follow torchvision's ResNet (conv1, bn1, layer1.0.conv1, ...,
layer1.0.downsample.0) and the reference head (head.features.N), so a
detector's state_dict converts to the JAX package's tree with its
tools/convert_torch_resnet.py:convert_full_detector.

Types, as the JAX package's ``param_dtype=float32, dtype=<working type>``:
every parameter and BatchNorm statistic is fp32. The working type is cast in
at two points: the backbone casts its input images to ``dtype``, and each
conv casts its fp32 weight (and bias) to its input's type inside
``forward``. BatchNorm takes working-type input with fp32 parameters,
reduces in fp32 and returns the working type.

BatchNorm (``BatchNorm2d``, eps 1e-5) follows flax's ``nn.BatchNorm``: in
train mode it normalizes with the batch statistics and folds the batch mean
and the *biased* batch variance into the running statistics with momentum
0.1 (flax's 0.9); ``nn.BatchNorm2d`` would fold the unbiased one.

The stride-1 bottlenecks with planes >= 256 (5 + 2 of them in ResNet-50)
run their BN -> ReLU -> conv3x3 link through ops/conv_bn.py, as the JAX
package's ``Bottleneck(fuse_bn=True)``: bn1 is folded into (scale, shift)
(running statistics in eval; the batch statistics of the 1x1 conv's output,
two-pass, in train), the link computes relu(y * scale + shift) -> conv3x3
plus (sum, sumsq) of its output, and bn2 applies its running statistics in
eval or, in train, the link's (sum, sumsq) through make_stats_fold's
clamped one-pass variance. Both paths are differentiable.

Per-camera BatchNorm (``set_bn_groups``, the JAX package's ``bn_groups``):
the cameras are folded into the batch camera-major, and with G groups each
camera's contiguous slice of the batch gets its own train-mode statistics;
the running statistics take G sequential momentum updates in camera order,
as the reference's one forward per camera gives them. Eval uses the running
statistics, so it is the same either way, and the parameters and buffers
keep their names. Under G groups the link runs once per camera slice, each
launch with that camera's folded statistics, returning that camera's
(sum, sumsq).

Data parallelism (parallel/): in a process group every train-mode
statistic is taken over the global batch, each camera slice with the same
camera's slices on the other ranks, so P ranks compute what one process
computes at the global batch. BatchNorm2d runs ``_SyncedBatchNorm``: each
rank's statistics of its rows combined exactly over the ranks in the
forward and the two gradient sums all-reduced in the backward (the
SyncBatchNorm recipe, through PyTorch's fused BatchNorm kernels on the
card; the biased variance goes into the running statistics, flax's rule,
where nn.SyncBatchNorm folds the unbiased one).
The link's bn1 takes its two-pass statistics the same way
(``synced_moments``), and the link's (sum, sumsq) output is all-reduced,
all camera slices stacked in one call, before bn2 folds it with the global
count. The kernel itself does not change. Without a process group none of
this runs and no collective is called.

Tensor parallelism (parallel/tp.py): a conv whose weight holds fewer output
channels than the layer's width is this rank's shard. It takes its whole
input through ``copy_to_model`` and returns its channel shard; the
BatchNorm after it normalizes the shard (statistics over the data ranks)
and gathers the channels, or, where the BatchNorm is replicated, gathers
them first. The link takes conv1's shard, bn1's moments on it, and gathers
the pre-BN activation and the folded (scale, shift) before the kernel,
which then runs conv2's Cout shard (tp.link_route: or conv2's whole weight
where the shard is too narrow for the kernel); bn2 folds the shard's
stats and applies them to the shard, which is then gathered. The head's
logits are gathered before the decode.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv_bn import fused_link, make_stats_fold
from ..parallel import collectives as C
from ..parallel import tp

# {depth: (block kind, blocks per stage)}
RESNET_SPEC = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def split_input(x, bias, shard: int):
    """A layer whose weight holds a shard of `shard` output channels: its
    input through copy_to_model and its bias cut to the shard (a
    replicated bias by model_slice)."""
    if bias is not None and bias.shape[0] != shard:
        bias = C.model_slice(bias)
    return C.copy_to_model(x), bias


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose fp32 weight (and bias) is cast to the input's type;
    a weight of fewer output channels than out_channels is this rank's
    shard, and the output is that channel shard (module docstring)."""

    def forward(self, x):
        bias = self.bias
        if self.weight.shape[0] != self.out_channels:
            x, bias = split_input(x, bias, self.weight.shape[0])
        bias = None if bias is None else bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d whose fp32 weight is cast to the input's type; a
    weight of fewer output channels (dim 1) than out_channels is this
    rank's shard, and the output is that channel shard."""

    def forward(self, x):
        if self.weight.shape[1] != self.out_channels:
            x = C.copy_to_model(x)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def update_running_stats(bn: nn.BatchNorm2d, mean, var) -> None:
    """Fold batch statistics (fp32, biased variance) into bn's running ones:
    running = (1 - momentum) * running + momentum * batch, flax's
    momentum * running + (1 - momentum) * batch with its momentum 0.9;
    momentum None is torch's cumulative average."""
    with torch.no_grad():
        bn.num_batches_tracked += 1
        f = (1.0 / float(bn.num_batches_tracked) if bn.momentum is None
             else bn.momentum)
        bn.running_mean.mul_(1.0 - f).add_(mean.detach(), alpha=f)
        bn.running_var.mul_(1.0 - f).add_(var.detach(), alpha=f)


def camera_slices(x, groups: int):
    """The `groups` contiguous camera slices of a camera-major batch."""
    if x.shape[0] % groups:
        raise ValueError(f"bn_groups={groups} must divide the camera-major "
                         f"batch {x.shape[0]}")
    return x.chunk(groups) if groups > 1 else (x,)


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


# the reduced dimensions of a camera-major batch split into its camera
# slices, (G, B, C, H, W)
_SLICE_DIMS = (1, 3, 4)


def _per_channel(v):
    """(G, C) -> (G, 1, C, 1, 1), against (G, B, C, H, W)."""
    return v[:, None, :, None, None]


def _per_sample(v, b: int):
    """(G, C) -> (G B, C, 1, 1): each camera slice's row for each of its b
    samples, against the camera-major (G B, C, H, W)."""
    return v.repeat_interleave(b, dim=0)[:, :, None, None]


def _memory_format(x):
    return (torch.channels_last
            if x.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def _combine_moments(mean_l, var_l):
    """The global batch's (mean, biased variance), each (G, C) fp32, from
    every rank's own over equal counts: the mean of the means, then of
    var + (mean - global mean)^2 (Chan's exact combine), two all-reduces."""
    p = C.data_size()
    mean = C.all_reduce_(mean_l.clone()) / p
    var = C.all_reduce_(var_l + (mean_l - mean) ** 2) / p
    return mean, var


class _SyncedBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of each of `groups` camera slices over the
    global batch, returning y in x's type and the (G, C) batch mean and
    biased variance (fp32). Forward: each rank's statistics of its rows,
    combined through two all-reduces; backward: one all-reduce, of the two
    gradient sums. On a CUDA tensor every pass over the activations is one
    of PyTorch's fused BatchNorm kernels, those of its native BatchNorm
    and nn.SyncBatchNorm (``batch_norm_stats`` (Welford),
    ``batch_norm_elemt``, ``batch_norm_backward_reduce`` and ``_elemt``,
    which exist for CUDA only); on the CPU their plain versions. Saves x in
    its own type."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups: int, eps: float):
        x = x.contiguous(memory_format=_memory_format(x))
        slices = camera_slices(x, groups)
        b = slices[0].shape[0]
        n = b * x.shape[2] * x.shape[3] * C.data_size()
        if x.is_cuda:
            local = [torch.batch_norm_stats(xs, eps) for xs in slices]
            mean_l = torch.stack([m for m, _ in local])
            var_l = torch.stack([i for _, i in local]) ** -2 - eps
        else:
            var_l, mean_l = torch.var_mean(
                x.float().unflatten(0, (groups, -1)), dim=_SLICE_DIMS,
                correction=0)
        mean, var = _combine_moments(mean_l, var_l)
        invstd = torch.rsqrt(var + eps)
        if x.is_cuda:
            y = _cat([torch.batch_norm_elemt(xs, weight, bias, m, i, eps)
                      for xs, m, i in zip(slices, mean, invstd)])
        else:
            # y in x's 4-D shape (not a view: ReLU works on it in place)
            y = ((x.float() - _per_sample(mean, b))
                 * _per_sample(invstd * weight, b)
                 + bias.view(1, -1, 1, 1)).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.groups, ctx.n = groups, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        if x.is_cuda:
            gys = camera_slices(gy.contiguous(memory_format=_memory_format(x)),
                                ctx.groups)
            xs = camera_slices(x, ctx.groups)
            red = [torch.batch_norm_backward_reduce(g, s, m, i, weight,
                                                    True, True, True)
                   for g, s, m, i in zip(gys, xs, mean, invstd)]
            # (G, 2, C): the sums of dy and of dy (x - mean) on this rank
            sums = torch.stack([torch.stack(r[:2]) for r in red])
            # the affine's gradients from this rank's rows: the step sums
            # them over the ranks with the other gradients
            gweight = sum(r[2] for r in red)
            gbias = sum(r[3] for r in red)
            C.all_reduce_(sums)
            # filled on the card: a tensor copied from the host would make
            # the host wait for the card at every BatchNorm
            count = torch.full((1,), ctx.n, dtype=torch.int32,
                               device=x.device)
            gx = _cat([torch.batch_norm_backward_elemt(
                g, s, m, i, weight, t[0], t[1], count)
                for g, s, m, i, t in zip(gys, xs, mean, invstd, sums)])
            return gx, gweight, gbias, None, None
        xhat = ((x.unflatten(0, (ctx.groups, -1)).float()
                 - _per_channel(mean)) * _per_channel(invstd))
        g = gy.unflatten(0, (ctx.groups, -1)).float()
        sums = torch.stack([g.sum(dim=_SLICE_DIMS),
                            (g * xhat).sum(dim=_SLICE_DIMS)])  # (2, G, C)
        gweight, gbias = sums[1].sum(0), sums[0].sum(0)
        tot = C.all_reduce_(sums.clone()) / ctx.n
        gx = ((g - _per_channel(tot[0]) - xhat * _per_channel(tot[1]))
              * _per_channel(invstd * weight))
        return gx.to(x.dtype).flatten(0, 1), gweight, gbias, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's train-mode semantics (see the module
    docstring), per camera slice under ``groups`` > 1; eval is
    nn.BatchNorm2d's. In a process group the train-mode statistics are the
    global batch's (``_SyncedBatchNorm``). Under tensor parallelism a
    BatchNorm whose parameters are a channel shard normalizes the input's
    shard and returns the channels gathered; a replicated one gathers a
    sharded input first."""

    groups = 1

    def forward(self, x):
        width = self.weight.shape[0]
        if width == self.num_features:
            return self._forward(tp.full_channels(x, width))
        if x.shape[1] != width:
            raise ValueError(f"BatchNorm of a {width}-channel shard given "
                             f"{x.shape[1]} channels")
        return C.gather_channels(self._forward(x))

    def _forward(self, x):
        if not self.training:
            return super().forward(x)
        if C.is_distributed():
            y, mean, var = _SyncedBatchNorm.apply(
                x, self.weight, self.bias, self.groups, self.eps)
            for m, v in zip(mean, var):
                update_running_stats(self, m, v)
            return y
        ys = []
        for xs in camera_slices(x, self.groups):
            y, mean, invstd = torch.native_batch_norm(
                xs, self.weight, self.bias, None, None, True, 0.0, self.eps)
            # the biased variance, back from invstd = (var + eps)^-1/2 (fp32)
            update_running_stats(self, mean, invstd.detach() ** -2 - self.eps)
            ys.append(y)
        return _cat(ys)


def set_bn_groups(module: nn.Module, groups: int) -> None:
    """Per-camera statistics in every BatchNorm2d of `module`: `groups`
    camera slices of each train-mode batch (1: pooled)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.groups = int(groups)


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(cin, cout, 1, stride=stride, bias=False), _bn(cout)
    )


def fold_running_stats(bn: nn.BatchNorm2d):
    """(scale, shift) in fp32 with bn(x) == x * scale + shift in eval."""
    inv = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return inv, bn.bias.float() - bn.running_mean.float() * inv


def fold_batch_stats(bn: nn.BatchNorm2d, x):
    """(scale, shift) in fp32 with the batch statistics of x (two-pass,
    biased; the JAX package's _StatsBN 'fold'), differentiable, and the
    running statistics updated."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = ((xf - mean.view(1, -1, 1, 1)) ** 2).mean(dim=(0, 2, 3))
    update_running_stats(bn, mean, var)
    inv = bn.weight * torch.rsqrt(var + bn.eps)
    return inv, bn.bias - mean * inv


def synced_moments(x, groups: int):
    """(mean, var), each (G, C) fp32, of each of `groups` camera slices of
    x over the global batch (that camera's slices on every rank): two-pass,
    biased, differentiable through the two all-reduces."""
    xf = x.float().unflatten(0, (groups, -1))
    n = xf.shape[1] * xf.shape[3] * xf.shape[4] * C.data_size()
    mean = C.psum_data(xf.sum(dim=_SLICE_DIMS)) / n
    var = C.psum_data(((xf - _per_channel(mean)) ** 2).sum(
        dim=_SLICE_DIMS)) / n
    return mean, var


def apply_stats(bn: nn.BatchNorm2d, y, stats, n: int | None = None):
    """bn(y) in train mode from y's (sum, sumsq) over `n` values (the
    link's stats output; the JAX package's _StatsBN 'apply'; n defaults to
    y's own count), differentiable through stats, and the running
    statistics updated."""
    if n is None:
        n = y.shape[0] * y.shape[2] * y.shape[3]
    scale, shift = make_stats_fold(stats, bn.weight, bn.bias, n, bn.eps)
    mean = stats[0] / n
    update_running_stats(bn, mean,
                         torch.clamp(stats[1] / n - mean**2, min=0.0))
    c = (1, -1, 1, 1)
    return (y.float() * scale.view(c) + shift.view(c)).to(y.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = (_downsample(inplanes, planes, stride)
                           if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here, as torchvision v1.5) -> 1x1 bottleneck."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = (_downsample(inplanes, planes * 4, stride)
                           if downsample else None)
        # the JAX package's Bottleneck.fuse_bn region (models/resnet.py)
        self.fused_link = stride == 1 and planes >= 256

    def _synced_link(self, y):
        """The train-mode link in a process group: bn1's statistics over
        the global batch, one launch per camera slice, and the slices'
        (sum, sumsq) all-reduced in one call before bn2 folds them; under
        tensor parallelism on conv1's and conv2's channel shards (module
        docstring), the output gathered."""
        g = self.bn1.groups
        mean, var = synced_moments(y, g)
        for m, v in zip(mean, var):
            update_running_stats(self.bn1, m, v)
        scale = self.bn1.weight * torch.rsqrt(var + self.bn1.eps)  # (G, C)
        shift = self.bn1.bias - mean * scale
        w = self.conv2.weight
        shard = w.shape[0]
        route = None
        if shard != self.conv2.out_channels:
            # the kernel's input channels whole on every model rank; its
            # gradients for them, from this rank's Cout shard, summed
            y, scale, shift = (C.copy_to_model(C.gather_channels(t))
                               for t in (y, scale, shift))
            route = tp.link_route(shard)
            if route == "gathered_weight":
                w = C.gather_channels(w, 0)
        outs = [fused_link(ys, w, scale[i], shift[i])
                for i, ys in enumerate(camera_slices(y, g))]
        if route == "gathered_weight":
            outs = [(tp.take_shard(ys, 1), tp.take_shard(st, 1))
                    for ys, st in outs]
        stats = C.psum_data(torch.stack([s for _, s in outs]))  # (G, 2, C)
        ys = outs[0][0]
        n = ys.shape[0] * ys.shape[2] * ys.shape[3] * C.data_size()
        y = _cat([apply_stats(self.bn2, ys, st, n)
                  for (ys, _), st in zip(outs, stats)])
        return tp.full_channels(y, self.conv2.out_channels)

    def forward(self, x):
        y = self.conv1(x)
        if self.fused_link and self.training and C.is_distributed():
            y = self._synced_link(y)
        elif self.fused_link and self.training:
            # one launch per camera slice, each with its own statistics
            parts = []
            for ys in camera_slices(y, self.bn1.groups):
                ys, stats = fused_link(ys, self.conv2.weight,
                                       *fold_batch_stats(self.bn1, ys))
                parts.append(apply_stats(self.bn2, ys, stats))
            y = _cat(parts)
        elif self.fused_link:
            y, _ = fused_link(y, self.conv2.weight,
                              *fold_running_stats(self.bn1))
            y = self.bn2(y)
        else:
            y = self.bn2(self.conv2(F.relu(self.bn1(y))))
        y = F.relu(y)
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class ResNetBackbone(nn.Module):
    """7x7 stem -> maxpool -> 4 stages; (B, 3, S, S) -> (B, C, S/32, S/32)."""

    def __init__(self, num_layers: int = 50,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype  # the working type the input is cast to
        kind, counts = RESNET_SPEC[num_layers]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for stage, blocks in enumerate(counts):
            planes = 64 * 2**stage
            layers = []
            for i in range(blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                out = planes * block.expansion
                layers.append(block(inplanes, planes, stride,
                                    stride != 1 or inplanes != out))
                inplanes = out
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layers))
        self.out_channels = inplanes

    def forward(self, x):
        # cuDNN's tensor-core convs and the link kernel work in channels-last
        # memory; the logical layout stays NCHW
        x = x.to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x


class DeconvHead(nn.Module):
    """num_layers x (ConvTranspose k4 s2 + BN + ReLU) + 1x1 projection to
    K*D channels: (B, C, 8, 8) -> (B, K*D, 64, 64)."""

    def __init__(self, in_channels: int, num_joints: int, depth_dim: int,
                 num_deconv_layers: int = 3, num_filters: int = 256,
                 fp32_logits: bool = True):
        super().__init__()
        layers = []
        for i in range(num_deconv_layers):
            cin = in_channels if i == 0 else num_filters
            layers += [
                ConvTranspose2d(cin, num_filters, 4, stride=2, padding=1,
                                bias=False),
                _bn(num_filters),
                nn.ReLU(inplace=True),
            ]
        layers.append(Conv2d(num_filters, num_joints * depth_dim, 1))
        self.features = nn.Sequential(*layers)
        self.fp32_logits = fp32_logits

    def forward(self, x):
        x = self.features[:-1](x)
        # the decode kernel reads each joint's volume as one contiguous block,
        # so the logits are produced in NCHW memory (and gathered whole
        # under tensor parallelism: the decode runs on every model rank)
        final = self.features[-1]
        x = tp.full_channels(final(x.contiguous()), final.out_channels)
        return x.float() if self.fp32_logits else x


class ResPoseNet(nn.Module):
    """Backbone + head: (B, 3, S, S) images -> (B, K*D, S/4, S/4) logits."""

    def __init__(self, num_joints: int, depth_dim: int, num_layers: int = 50,
                 fp32_logits: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = ResNetBackbone(num_layers, dtype)
        self.head = DeconvHead(self.backbone.out_channels, num_joints,
                               depth_dim, fp32_logits=fp32_logits)

    def forward(self, x):
        return self.head(self.backbone(x))
