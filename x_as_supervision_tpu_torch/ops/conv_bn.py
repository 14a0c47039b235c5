"""Fused BN-apply -> ReLU -> 3x3 conv -> output-stats link: the CUDA kernel
``csrc/conv_bn_link.cu``, its plain PyTorch version, and ``fused_link``, the
differentiable link whose backward is plain PyTorch (as the JAX package's is
plain XLA).

    y     = conv3x3_SAME(relu(x * scale + shift), w)   # stride 1, no bias
    stats = (sum over pixels and batch of y, of y^2)    # (2, Cout) fp32

x is (B, Cin, H, W) in fp32 or bf16, w (Cout, Cin, 3, 3), scale and shift
(Cin,) fp32. The activation is computed in fp32 and rounded to x's type
before the conv; the conv accumulates in fp32; y comes back in x's type and
the stats are taken from the fp32 values before that rounding. The kernel
works in channels-last memory; the wrapper converts x explicitly and returns
y in channels-last memory (the same logical NCHW tensor).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bn_relu_conv_plain(x, w, scale, shift):
    """Plain PyTorch version of the kernel (the JAX package's
    ops/conv_bn_pallas.py:xla_bn_relu_conv in NCHW). The CPU path and the
    kernel's reference."""
    a = torch.relu(x.float() * scale.view(1, -1, 1, 1)
                   + shift.view(1, -1, 1, 1)).to(x.dtype)
    # fp32 products of working-type values, as a fp32 accumulator sees them
    y = F.conv2d(a.float(), w.to(x.dtype).float(), padding=1)
    stats = torch.stack([y.sum(dim=(0, 2, 3)), (y * y).sum(dim=(0, 2, 3))])
    return y.to(x.dtype), stats


def fused_bn_relu_conv(x, w, scale, shift):
    """The link on x: the kernel for a CUDA tensor, the plain version for a
    CPU tensor. Returns (y (B, Cout, H, W) in x's type, stats (2, Cout))."""
    if x.device.type == "cpu":
        return bn_relu_conv_plain(x, w, scale, shift)
    if x.device.type != "cuda":
        raise ValueError(f"no link kernel for device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError("link kernel takes (B, Cin, H, W) fp32 or bf16 x, "
                         f"got {tuple(x.shape)} {x.dtype}")
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 3, 3) or w.device != x.device:
        raise ValueError(f"w must be (Cout, {cin}, 3, 3) on {x.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    if cin % 32 or cout % 64:
        raise ValueError(f"link kernel needs Cin % 32 == 0 and Cout % 64 == "
                         f"0, got Cin={cin} Cout={cout}")
    for name, v in (("scale", scale), ("shift", shift)):
        if v.shape != (cin,) or v.dtype != torch.float32 or v.device != x.device:
            raise ValueError(f"{name} must be ({cin},) fp32 on {x.device}")
    x_cl = x.contiguous(memory_format=torch.channels_last)
    if x_cl.data_ptr() % 16:
        raise ValueError("link kernel needs 16-byte aligned x")
    w9 = w.to(x.dtype).permute(2, 3, 1, 0).contiguous()  # (3, 3, Cin, Cout)
    scale, shift = scale.contiguous(), shift.contiguous()
    y = torch.empty((b, cout, h, wd), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    lib = _lib()
    tiles = lib.xas_conv_bn_link_tiles(b, h, wd)
    partial = torch.empty((tiles, 2, cout), dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.xas_conv_bn_link(
            _DTYPES[x.dtype], x_cl.data_ptr(), w9.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
            partial.data_ptr(), stats.data_ptr(), b, h, wd, cin, cout,
            _build.stream_handle(x),
        )
    _build.check(lib, err, "conv_bn_link")
    fused_bn_relu_conv.launches += 1
    return y, stats


fused_bn_relu_conv.launches = 0


def fused_link_backward(x, w, scale, shift, y, gy, gstats):
    """Gradient of the link, plain PyTorch: the JAX package's
    ops/conv_bn_pallas.py:_fused_link_bwd (plain XLA there too). Elementwise
    work stays in x's type, channel sums accumulate in fp32, and the conv's
    input and weight gradients go to the library (cuDNN on the card).
    Returns (gx, gw, gscale, gshift)."""
    cdt = x.dtype
    c = (1, -1, 1, 1)
    g = (gy.to(cdt) + gstats[0].view(c).to(cdt)
         + 2.0 * y * gstats[1].view(c).to(cdt))
    pre = x * scale.view(c).to(cdt) + shift.view(c).to(cdt)
    a = torch.relu(pre)
    ga, gw, _ = torch.ops.aten.convolution_backward(
        g.contiguous(memory_format=torch.channels_last), a, w.to(cdt), None,
        [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, False])
    gpre = torch.where(pre > 0, ga, torch.zeros((), dtype=ga.dtype,
                                                device=ga.device))
    gx = gpre * scale.view(c).to(cdt)
    gpre32 = gpre.float()
    gscale = (gpre32 * x.float()).sum(dim=(0, 2, 3))
    gshift = gpre32.sum(dim=(0, 2, 3))
    return gx, gw.to(w.dtype), gscale, gshift


class _FusedLink(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, shift):
        y, stats = fused_bn_relu_conv(x, w, scale, shift)
        ctx.save_for_backward(x, w, scale, shift, y)
        return y, stats

    @staticmethod
    def backward(ctx, gy, gstats):
        x, w, scale, shift, y = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(y)
        if gstats is None:
            gstats = torch.zeros((2, w.shape[0]), dtype=torch.float32,
                                 device=y.device)
        return fused_link_backward(x, w, scale, shift, y, gy, gstats)


def fused_link(x, w, scale, shift):
    """The differentiable link (the JAX package's conv_bn_pallas.fused_link):
    ``fused_bn_relu_conv`` forward, ``fused_link_backward`` backward."""
    if not torch.is_grad_enabled():
        return fused_bn_relu_conv(x, w, scale, shift)
    return _FusedLink.apply(x, w, scale, shift)


def make_stats_fold(stats, gamma, beta, n: int, eps: float = 1e-5):
    """Turn a link's (sum, sumsq) output into the next link's (scale, shift):
    BN(x) * gamma + beta == x * scale + shift with the batch statistics of
    the link's output."""
    mean = stats[0] / n
    # one-pass sumsq/n - mean^2 can cancel slightly negative on a
    # near-constant channel, and rsqrt(var + eps) would then be NaN
    var = torch.clamp(stats[1] / n - mean**2, min=0.0)
    inv = gamma * torch.rsqrt(var + eps)
    return inv, beta - mean * inv


def _lib():
    lib = _build.load("conv_bn_link")
    fn = lib.xas_conv_bn_link
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
        lib.xas_conv_bn_link_tiles.argtypes = [i, i, i]
        lib.xas_conv_bn_link_tiles.restype = i
    return lib
