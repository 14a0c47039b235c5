"""The layouts the port's conv kernels rely on, checked on the CPU: the
wrappers' weight packing (plain torch) contracted with an explicit im2col of
a seeded input, in each kernel's K order, reproduces the plain versions;
and which tile or path each shape takes.

- conv3x3, tensor cores: w packed (Cin/32, 9, Cout, 32), K = (slice, tap,
  channel of the slice); CUDA cores: (Cin, 9, Cout), K = (channel, tap).
- link: bf16 (9, Cout, Cin), K = (tap, channel), K-major per output channel
  for wgmma; fp32 (9, Cin, Cout). The halo is zero after the activation.
"""

import numpy as np
import pytest
import torch

from x_as_supervision_tpu_torch.ops.conv3x3 import (
    CC,
    TC,
    TC_SLICE,
    channels_last,
    conv3x3_path,
    conv3x3_plain,
    pack_weights,
)
from x_as_supervision_tpu_torch.ops.conv_bn import (
    LINK_TILES,
    bn_relu_conv_plain,
    link_blocks,
    link_regions,
    link_tile,
    pack_link_weights,
)

H100_SMS = 132


def _im2col(x: np.ndarray, stride: int) -> np.ndarray:
    """(B, C, H, W) -> (B, Ho, Wo, C, 3, 3): the SAME-padded 3x3 patches."""
    b, c, h, w = x.shape
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    cols = np.empty((b, ho, wo, c, 3, 3), x.dtype)
    for ky in range(3):
        for kx in range(3):
            cols[..., ky, kx] = xp[:, :, ky:ky + stride * (ho - 1) + 1:stride,
                                   kx:kx + stride * (wo - 1) + 1:stride
                                   ].transpose(0, 2, 3, 1)
    return cols


def _conv_case(b, cin, cout, h, w, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, cin, h, w)).astype(np.float32)
    wt = (rng.normal(size=(cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(
        np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    return x, wt, bias


def _close(got: np.ndarray, want: np.ndarray) -> None:
    # fp32 sums of the same products in another order
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


_TC_CASES = [(2, 32, 64, 9, 11, 1), (1, 64, 32, 10, 7, 2),
             (1, 96, 32, 5, 6, 1)]
_CC_CASES = [
    (2, 1, 32, 8, 9, 1),     # Cin = 1
    (1, 32, 1, 7, 8, 2),     # Cout = 1
    (2, 5, 7, 9, 13, 1),     # odd channel counts
    (1, 6, 3, 11, 9, 2),
]


@pytest.mark.parametrize("path,b,cin,cout,h,w,stride",
                         [(TC, *c) for c in _TC_CASES]
                         + [(CC, *c) for c in _TC_CASES + _CC_CASES])
def test_conv3x3_packing_in_kernel_k_order(path, b, cin, cout, h, w, stride):
    x, wt, bias = _conv_case(b, cin, cout, h, w)
    packed = pack_weights(torch.from_numpy(wt), path).numpy()
    cols = _im2col(x, stride)  # (B, Ho, Wo, Cin, ky, kx)
    pix = cols.shape[:3]
    if path == TC:
        s = cin // TC_SLICE
        a = cols.reshape(*pix, s, TC_SLICE, 3, 3).transpose(
            0, 1, 2, 3, 5, 6, 4)
        wk = packed.transpose(0, 1, 3, 2)  # (slice, tap, channel, Cout)
        assert packed.shape == (s, 9, cout, TC_SLICE)
    else:
        a = cols
        wk = packed  # (channel, tap, Cout)
        assert packed.shape == (cin, 9, cout)
    y = a.reshape(-1, 9 * cin) @ wk.reshape(9 * cin, cout) + bias
    want = conv3x3_plain(torch.from_numpy(x), torch.from_numpy(wt),
                         torch.from_numpy(bias), stride)
    _close(y.reshape(*pix, cout), want.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,cin,cout,h,w,shift_mean", [
    (2, 64, 64, 6, 7, 0.0),
    (1, 32, 128, 5, 7, 0.0),  # Cin % 64 == 32: half a wgmma K step
    # relu(shift) > 0: a halo of relu(shift) instead of zero would change
    # every border pixel
    (2, 64, 64, 4, 5, 2.0),
])
def test_link_packing_in_kernel_k_order(dtype, b, cin, cout, h, w,
                                        shift_mean):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(b, cin, h, w)).astype(np.float32)
    wt = (rng.normal(size=(cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(
        np.float32)
    wt = torch.from_numpy(wt).to(dtype).float()  # the values the kernel sees
    scale = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    shift = (shift_mean + rng.normal(size=cin) * 0.1).astype(np.float32)
    packed = pack_link_weights(wt, dtype).float().numpy()
    if dtype == torch.bfloat16:
        assert packed.shape == (9, cout, cin)
        wk = packed.transpose(0, 2, 1)  # (tap, Cin, Cout)
    else:
        assert packed.shape == (9, cin, cout)
        wk = packed
    a = np.maximum(x * scale.reshape(1, -1, 1, 1)
                   + shift.reshape(1, -1, 1, 1), 0)  # zero-padded after
    cols = _im2col(a, 1).transpose(0, 1, 2, 4, 5, 3)  # K = (ky, kx, Cin)
    y = cols.reshape(-1, 9 * cin) @ wk.reshape(9 * cin, cout)
    want_y, want_s = bn_relu_conv_plain(
        torch.from_numpy(x), wt, torch.from_numpy(scale),
        torch.from_numpy(shift))
    _close(y.reshape(b, h, w, cout), want_y.permute(0, 2, 3, 1).numpy())
    stats = np.stack([y.sum(0), (y * y).sum(0)])
    mags = np.stack([np.abs(y).sum(0), (y * y).sum(0)])
    assert (np.abs(stats - want_s.numpy()) <= 1e-5 * mags).all()


@pytest.mark.parametrize("path", [TC, CC])
def test_conv3x3_packing_takes_the_input_gradients_weights(path):
    """The stride-1 input gradient packs flipped, transposed (so not
    contiguous) weights, cast to the working type on the way."""
    w = torch.from_numpy(_conv_case(1, 64, 32, 4, 4)[1])
    wt = w.flip(2, 3).transpose(0, 1)
    assert not wt.is_contiguous()
    got = pack_weights(wt, path, torch.bfloat16)
    want = pack_weights(wt.contiguous().bfloat16(), path)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_link_tiles_by_shape():
    """On a 132-SM card: the training shapes take the largest tile, the
    serving shapes (B = 32) smaller ones so the grid still fills the card,
    and the card tests' shapes cover every tile the kernel has."""
    assert link_tile(128, 16, 16, 256, H100_SMS) == (128, 256)
    assert link_tile(128, 8, 8, 512, H100_SMS) == (128, 256)
    assert link_tile(32, 16, 16, 256, H100_SMS) == (128, 128)
    assert link_tile(32, 8, 8, 512, H100_SMS) == (64, 128)
    # tests/test_torch_kernels_cuda.py::test_link_kernel_matches_plain
    card = [(2, 64, 8, 8), (3, 128, 5, 7), (2, 64, 6, 6), (32, 256, 16, 16),
            (32, 512, 8, 8), (128, 256, 16, 16), (7, 256, 47, 47),
            (64, 64, 32, 32)]
    tiles = {link_tile(b, h, w, co, H100_SMS) for b, co, h, w in card}
    assert tiles == set(LINK_TILES)
    # that case's regions are cut by the image's edge in both directions
    assert link_tile(7, 47, 47, 256, H100_SMS) == (128, 256)
    assert 47 % 8 and 47 % 16 and link_regions(128, 47, 47) == (8, 16, 1)
    with pytest.raises(ValueError):
        link_tile(1, 8, 8, 96, H100_SMS)


@pytest.mark.parametrize("bm", [t[0] for t in LINK_TILES])
@pytest.mark.parametrize("h,w", [(16, 16), (8, 8), (5, 7), (47, 47), (1, 1),
                                 (40, 8), (8, 40), (3, 100)])
def test_link_regions_cover_each_pixel_once(bm, h, w):
    """The kernel's regions: G * RH * RW == BM in 8x8 tiles, at most 100
    halo slots per m64 tile (its shared-memory budget), and the blocks of a
    batch cover every pixel exactly once."""
    rh, rw, g = link_regions(bm, h, w)
    assert g * rh * rw == bm and rh % 8 == 0 and rw % 8 == 0
    assert g * (rh + 2) * (rw + 2) <= bm // 64 * 100
    b = 3
    seen = np.zeros((b, h, w), int)
    tiles_w, tiles_h = -(-w // rw), -(-h // rh)
    blocks = link_blocks(b, h, w, (bm, 64))
    for bx in range(blocks):  # the kernel's block -> region mapping
        w0 = bx % tiles_w * rw
        h0 = bx // tiles_w % tiles_h * rh
        b0 = bx // (tiles_w * tiles_h) * g
        seen[b0:b0 + g, h0:h0 + rh, w0:w0 + rw] += 1
    assert (seen == 1).all()


def test_conv3x3_path_by_shape():
    bf, f32 = torch.bfloat16, torch.float32
    # the flagship physique net: 14 tensor-core convs and 4 on the CUDA
    # cores per step (10 forwards, 8 stride-1 input gradients)
    fwd = [(1, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128),
           (128, 64), (64, 64), (64, 32), (32, 1)]
    dgrad = [(co, ci) for ci, co in fwd[:2] + fwd[3:4] + fwd[5:]]
    assert len(dgrad) == 8
    paths = [conv3x3_path(bf, ci, co) for ci, co in fwd + dgrad]
    assert paths.count(TC) == 14 and paths.count(CC) == 4
    assert conv3x3_path(f32, 128, 128) == CC
    assert conv3x3_path(bf, 5, 7) == CC


def test_channels_last_gives_nhwc_strides():
    x = torch.zeros(2, 1, 4, 5)  # C = 1: contiguous in both formats
    assert x.is_contiguous(memory_format=torch.channels_last)
    y = channels_last(x)
    assert y.stride() == (20, 1, 5, 1) and y.data_ptr() == x.data_ptr()
    z = torch.arange(2 * 3 * 4 * 5.0).reshape(2, 3, 4, 5)
    zc = channels_last(z)
    assert zc.stride() == (60, 1, 15, 3) and torch.equal(zc, z)
    assert channels_last(zc).data_ptr() == zc.data_ptr()  # no second copy
