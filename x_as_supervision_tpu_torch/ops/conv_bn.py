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
works in channels-last memory; the wrapper converts x explicitly, packs the
weights (``pack_link_weights``), picks the bf16 tile and its regions from
the shape (``link_tile``, ``link_regions``) and returns y in channels-last
memory (the same logical NCHW tensor).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from ..spans import BACKWARD, CONV_BN_LINK, span

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


# (BM, BN) pixel x output-channel tiles of the bf16 wgmma kernel, largest
# first; csrc/conv_bn_link.cu instantiates exactly these
LINK_TILES = ((128, 256), (128, 128), (64, 128), (128, 64), (64, 64))
FMA_TILE = (64, 64)


def link_regions(bm: int, h: int, w: int) -> tuple[int, int, int]:
    """How the bf16 kernel cuts BM pixels into regions it stages with a
    one-pixel halo: (RH, RW, G), G regions of RH x RW pixels of one image
    each, RH and RW multiples of 8 (the kernel's 8x8 m64 tiles). Images of
    at most 8x8 go whole, G = BM / 64 of them to a block; larger ones in
    16-wide patches (8-wide where W <= 8 or BM = 64)."""
    if (h <= 8 and w <= 8) or bm == 64:
        return 8, 8, bm // 64 if h <= 8 and w <= 8 else 1
    rw = 16 if w > 8 else 8
    return bm // rw, rw, 1


def link_blocks(b: int, h: int, w: int, tile) -> int:
    """Blocks along the pixels for a tile: one per G images x RH x RW."""
    rh, rw, g = link_regions(tile[0], h, w)
    return -(-b // g) * -(-h // rh) * -(-w // rw)


def link_tile(b: int, h: int, w: int, cout: int,
              sms: int) -> tuple[int, int]:
    """The bf16 kernel's (BM, BN) tile for a (B, Cin, H, W) input and Cout
    output channels on a card of `sms` SMs: the largest tile whose grid
    still fills at least 90 % of the SMs (one block each), else the one with
    the most blocks. K is never split: the stats need each pixel's full
    sum."""
    fits = [t for t in LINK_TILES if cout % t[1] == 0]
    if not fits:
        raise ValueError(f"no link tile for Cout={cout} "
                         "(needs Cout % 64 == 0)")

    def blocks(t):
        return link_blocks(b, h, w, t) * (cout // t[1])

    for t in fits:
        if blocks(t) * 10 >= 9 * sms:
            return t
    return max(fits, key=blocks)


def pack_link_weights(w, dtype):
    """w (Cout, Cin, 3, 3) packed for the kernel, K = (tap, Cin) tap-major:
    bf16 (9, Cout, Cin), each output channel's K contiguous (the K-major
    layout wgmma reads untransposed); fp32 (9, Cin, Cout) for the FMA
    path. Plain torch, so the CPU tests check it."""
    cout, cin = w.shape[:2]
    if dtype == torch.float32:
        out = torch.empty((9, cin, cout), dtype=dtype, device=w.device)
        out.view(3, 3, cin, cout).copy_(w.permute(2, 3, 1, 0))
    else:
        out = torch.empty((9, cout, cin), dtype=dtype, device=w.device)
        out.view(3, 3, cout, cin).copy_(w.permute(2, 3, 0, 1))
    return out  # one cast-and-permute copy


def fused_bn_relu_conv(x, w, scale, shift):
    """The link on x: the kernel for a CUDA tensor, the plain version for a
    CPU tensor. Returns (y (B, Cout, H, W) in x's type, stats (2, Cout)).
    bf16 runs the wgmma kernel (count ``launches_wgmma``), fp32 the FMA one
    (``launches_fma``); ``launches`` counts both."""
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
    wgmma = x.dtype == torch.bfloat16
    bm, bn, rh, rw, g, blocks = _plan(wgmma, b, h, wd, cout, _sms(x.device))
    wp = pack_link_weights(w, x.dtype)
    scale, shift = scale.contiguous(), shift.contiguous()
    y = torch.empty((b, cout, h, wd), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    # the per-block partial sums, then the stats, in one allocation
    sums = torch.empty(((blocks + 1) * 2 * cout,), dtype=torch.float32,
                       device=x.device)
    partial, stats = sums[:-2 * cout], sums[-2 * cout:].view(2, cout)
    lib = _lib()
    with _build.device_guard(x):
        err = lib.xas_conv_bn_link(
            _DTYPES[x.dtype], bm, bn, rh, rw, g, x_cl.data_ptr(),
            wp.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
            partial.data_ptr(), stats.data_ptr(), b, h, wd, cin, cout,
            _build.stream_handle(x),
        )
    _build.check(lib, err, "conv_bn_link")
    fused_bn_relu_conv.launches += 1
    if wgmma:
        fused_bn_relu_conv.launches_wgmma += 1
    else:
        fused_bn_relu_conv.launches_fma += 1
    return y, stats


fused_bn_relu_conv.launches = 0
fused_bn_relu_conv.launches_wgmma = 0
fused_bn_relu_conv.launches_fma = 0


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
        with span(CONV_BN_LINK + BACKWARD):
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
    with span(CONV_BN_LINK):
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


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _plan(wgmma: bool, b: int, h: int, w: int, cout: int, sms: int):
    """(BM, BN, RH, RW, G, pixel blocks) of a launch, once per shape."""
    if not wgmma:
        return (*FMA_TILE, 0, 0, 0, -(-b * h * w // FMA_TILE[0]))
    tile = link_tile(b, h, w, cout, sms)
    return (*tile, *link_regions(tile[0], h, w), link_blocks(b, h, w, tile))


def _lib():
    lib = _build.load("conv_bn_link")
    fn = lib.xas_conv_bn_link
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i, i, i, i, p, p, p, p, p, p, p, i, i, i, i,
                       i, p]
        fn.restype = i
    return lib
