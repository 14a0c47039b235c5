"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernels are built
with nvcc at first use) and skip without one. They import no JAX, so they run
on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the other tests.)
"""

import numpy as np
import pytest
import torch

from x_as_supervision_tpu_torch.models.detector import build_detector
from x_as_supervision_tpu_torch.ops.conv3x3 import (
    TC,
    conv3x3,
    conv3x3_kernel,
    conv3x3_path,
    conv3x3_plain,
)
from x_as_supervision_tpu_torch.ops.conv_bn import (
    bn_relu_conv_plain,
    fused_bn_relu_conv,
    fused_link,
)
from x_as_supervision_tpu_torch.ops.integral_kernel import (
    integral_marginals,
    marginals,
    marginals_backward,
    marginals_backward_plain,
    marginals_plain,
)
from x_as_supervision_tpu_torch import weights

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card, with full-fp32 convs and matmuls for the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _marginals_input(dev, shape, fill, dtype):
    b, k, d, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((b, k * d, h, w), generator=gen, device=dev) * 3
    if fill == "constant":
        x.fill_(0.75)
    elif fill == "tie":
        # every joint's max twice, in its first and last slice: in the
        # first and last block of its cluster
        vol = x.view(b, k, d, h, w)
        vol[:, :, 0, 1, 2] = 20.0
        vol[:, :, -1, h - 1, w - 3] = 20.0
    elif fill == "steps":
        # slices more than 80 apart: the rescales underflow to 0
        step = (5 * torch.arange(d, device=dev)) % 7
        x.view(b, k, d, h, w).add_(110.0 * step.view(1, 1, d, 1, 1))
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,fill", [
    ((2, 3, 8, 8, 8), "randn"),     # (B, K, D, H, W): small
    ((1, 2, 5, 6, 12), "randn"),    # 18 accesses of 256 threads; bf16 8-byte
    ((2, 18, 64, 64, 64), "randn"),  # the serving shape at batch 2
    ((128, 18, 64, 64, 64), "randn"),  # the training shape
    ((2, 3, 8, 96, 96), "randn"),   # H*W > 4096: three chunks per slice
    ((1, 2, 4, 7, 40), "randn"),    # ragged H
    ((1, 2, 4, 68, 100), "randn"),  # H*W > 4096, bf16 W % 8 != 0
    ((2, 3, 16, 64, 64), "constant"),
    ((2, 3, 16, 64, 64), "tie"),
    ((2, 3, 16, 64, 64), "steps"),
])
def test_marginals_kernel_matches_plain(dev, dtype, shape, fill):
    b, k, d, h, w = shape
    x = _marginals_input(dev, shape, fill, dtype)
    before = integral_marginals.launches
    got = integral_marginals(x, k)
    torch.cuda.synchronize()
    assert integral_marginals.launches == before + 1
    want = marginals_plain(x, k)
    # fp32 sums in another order, and __expf's error, relative to the
    # argument's size (about 1e-6 at the |logit - max| of ~20 seen here)
    for g, r in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)  # max: exact
    torch.testing.assert_close(got[4], want[4], rtol=1e-5, atol=0)


def _link_case(dev, b, c, co, h, w, dtype, shift_mean=0.0):
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((b, c, h, w), generator=gen, device=dev).to(dtype)
    wt = torch.randn((co, c, 3, 3), generator=gen, device=dev) * (2 / (9 * c)) ** 0.5
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    shift = torch.randn(c, generator=gen, device=dev) * 0.1 + shift_mean
    return x, wt.to(dtype), scale, shift


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,co,h,w,shift_mean", [
    (2, 64, 64, 8, 8, 0.0),
    (3, 32, 128, 5, 7, 0.0),     # ragged last pixel tile, non-square
    (2, 64, 64, 6, 6, 2.0),      # relu(shift) > 0: the halo must stay zero
    (32, 256, 256, 16, 16, 0.0),  # stage 3 at the serving batch
    (32, 512, 512, 8, 8, 0.0),    # stage 4
    # the bf16 tiles (tests/test_torch_conv_layout.py holds which shape
    # takes which on a 132-SM card): 128x256 at the training shape, and with
    # 8x16 regions cut by the image's edge (47x47); 128x64 for Cout = 64
    (128, 256, 256, 16, 16, 0.0),
    (7, 256, 256, 47, 47, 0.0),
    (64, 64, 64, 32, 32, 0.0),
])
def test_link_kernel_matches_plain(dev, dtype, b, c, co, h, w, shift_mean):
    x, wt, scale, shift = _link_case(dev, b, c, co, h, w, dtype, shift_mean)
    before = (fused_bn_relu_conv.launches, fused_bn_relu_conv.launches_wgmma,
              fused_bn_relu_conv.launches_fma)
    y, stats = fused_bn_relu_conv(x, wt, scale, shift)
    torch.cuda.synchronize()
    wgmma = int(dtype == torch.bfloat16)
    assert (fused_bn_relu_conv.launches, fused_bn_relu_conv.launches_wgmma,
            fused_bn_relu_conv.launches_fma) == (
        before[0] + 1, before[1] + wgmma, before[2] + 1 - wgmma)
    assert y.dtype == dtype and y.shape == (b, co, h, w)
    ry, rstats = bn_relu_conv_plain(x, wt, scale, shift)
    ymax = ry.float().abs().max().item()
    if dtype == torch.float32:
        # fp32 products, summed in another order over 9*Cin terms
        tol = 1e-5 * ymax
    else:
        # same bf16 products and fp32 sums; y is then rounded to bf16,
        # where another summation order can move it by one step (2^-8)
        tol = 2 ** -7 * ymax
    torch.testing.assert_close(y.float(), ry.float(), rtol=0, atol=tol)
    # stats sum B*H*W fp32 values of y (and y^2) in another order: the
    # error is relative to the sum of magnitudes, not to the cancelling sum
    yf = ry.float()
    mags = torch.stack([yf.abs().sum(dim=(0, 2, 3)),
                        (yf * yf).sum(dim=(0, 2, 3))])
    assert ((stats - rstats).abs() <= 1e-5 * mags).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,side", [(256, 16), (512, 8)])
def test_link_kernel_on_camera_slices_matches_plain(dev, dtype, c, side):
    """Per-camera BatchNorm: the link on each camera's slice of a
    channels-last (128, C, H, W) batch, a view at an offset of 32 images,
    with that camera's scale and shift."""
    x, wt, _, _ = _link_case(dev, 128, c, c, side, side, dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    gen = torch.Generator(device=dev).manual_seed(3)
    for g, xs in enumerate(x.chunk(4)):
        assert xs.is_contiguous(memory_format=torch.channels_last)
        offset = g * xs.numel() * x.element_size()
        assert xs.data_ptr() == x.data_ptr() + offset
        scale = torch.rand(c, generator=gen, device=dev) + 0.5
        shift = torch.randn(c, generator=gen, device=dev) * 0.1
        y, stats = fused_bn_relu_conv(xs, wt, scale, shift)
        ry, rstats = bn_relu_conv_plain(xs, wt, scale, shift)
        yf = ry.float()
        # the bounds of test_link_kernel_matches_plain
        tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * yf.abs().max()
        torch.testing.assert_close(y.float(), yf, rtol=0, atol=tol.item())
        # stats: each y is a fp32 sum of 9 * Cin products, accumulated in
        # another order (bf16: by wgmma), then summed over the pixels; the
        # error is relative to the magnitude of the products summed
        # (conv(|a|, |w|)), which at 512 channels is where the cancelling
        # sums of y leave the error, not relative to |y|
        a = torch.relu(xs.float() * scale.view(1, -1, 1, 1)
                       + shift.view(1, -1, 1, 1)).to(dtype).float()
        t = torch.nn.functional.conv2d(a, wt.float().abs(), padding=1)
        mags = torch.stack([t.sum(dim=(0, 2, 3)),
                            (2 * yf.abs() * t).sum(dim=(0, 2, 3))])
        assert ((stats - rstats).abs() <= 1e-5 * mags).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_bottleneck_on_card_matches_plain_grouped_path(dev, dtype):
    """A train-mode Bottleneck with 4 camera groups: the link launched once
    per camera slice, output and running statistics as the plain grouped
    path's (BatchNorm per slice, cuDNN's conv) on the same input."""
    import copy

    from x_as_supervision_tpu_torch.models.resnet import (
        Bottleneck,
        set_bn_groups,
    )

    block = Bottleneck(1024, 256)
    weights.init_weights(block, 0)
    set_bn_groups(block, 4)
    block = block.to(dev).train()
    plain = copy.deepcopy(block)
    plain.fused_link = False
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((128, 1024, 16, 16), generator=gen, device=dev).to(
        dtype).contiguous(memory_format=torch.channels_last)
    before = fused_bn_relu_conv.launches
    with torch.no_grad():
        y = block(x).float()
        torch.cuda.synchronize()
        assert fused_bn_relu_conv.launches - before == 4
        ry = plain(x).float()
    # fp32: convs and per-camera statistics summed in other orders; bf16:
    # the paths round activations to bf16 at other points, through two
    # normalizations
    tol = 1e-4 if dtype == torch.float32 else 2 ** -5
    assert (y - ry).abs().max() <= tol * ry.abs().max()
    want = plain.state_dict()
    for k, v in block.state_dict().items():
        if "running" in k:
            assert ((v - want[k]).abs() <= 1e-2 * (want[k].abs() + 1e-3)
                    ).all(), k


def _bwd_case(dev, shape, dtype):
    b, k, d, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(2)
    x = (torch.randn((b, k * d, h, w), generator=gen, device=dev) * 3
         ).to(dtype)
    gs = [torch.randn((b, k, n), generator=gen, device=dev) for n in (w, h, d)]
    return x, gs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 3, 8, 8, 8),
    (1, 2, 5, 6, 16),    # D, H not powers of two
    (2, 18, 64, 64, 64),  # the flagship shape at batch 2
])
def test_marginals_backward_kernel_matches_plain(dev, dtype, shape):
    x, (gx, gy, gz) = _bwd_case(dev, shape, dtype)
    k = shape[1]
    ax, ay, az, m, z = integral_marginals(x, k)
    before = marginals_backward.launches
    got = marginals_backward(x, m, z, ax, ay, az, gx, gy, gz, k)
    torch.cuda.synchronize()
    assert marginals_backward.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = marginals_backward_plain(x, gx, gy, gz, k)
    scale = want.float().abs().max().item()
    # fp32: the same products summed in another order; bf16: both round the
    # fp32 gradient to bf16, which another order can move by one step
    tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_marginals_autograd_matches_plain(dev, dtype):
    x, (gx, gy, gz) = _bwd_case(dev, (2, 4, 8, 16, 16), dtype)
    xg = x.clone().requires_grad_(True)
    ax, ay, az, _, _ = marginals(xg, 4)
    (got,) = torch.autograd.grad((ax, ay, az), xg, (gx, gy, gz))
    want = marginals_backward_plain(x, gx, gy, gz, 4)
    tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def _conv_case(dev, b, cin, cout, h, w, dtype, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, cin, h, w), generator=gen, device=dev).to(dtype)
    wt = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (2 / (9 * cin)) ** 0.5
    bias = torch.randn(cout, generator=gen, device=dev) * 0.1
    return x, wt, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,cin,cout,h,w,stride", [
    (2, 1, 32, 64, 64, 1),     # Cin = 1, the first physique conv
    (2, 32, 1, 64, 64, 1),     # Cout = 1, the last
    (2, 32, 64, 64, 64, 2),    # stride 2
    (2, 64, 128, 32, 32, 2),
    (2, 128, 128, 16, 16, 1),
    (3, 5, 7, 19, 37, 1),      # ragged tiles, channels not a block multiple
    (1, 6, 3, 21, 35, 2),      # odd sides at stride 2
    # every physique shape of the flagship step (Cin, Cout, side, stride) at
    # batch 2: forwards, then the input gradients no forward has
    (2, 1, 32, 256, 256, 1), (2, 32, 32, 256, 256, 1),
    (2, 32, 64, 256, 256, 2), (2, 64, 64, 128, 128, 1),
    (2, 64, 128, 128, 128, 2), (2, 128, 128, 64, 64, 1),
    (2, 128, 64, 128, 128, 1), (2, 64, 32, 256, 256, 1),
    (2, 32, 1, 256, 256, 1), (2, 64, 128, 128, 128, 1),
    (2, 32, 64, 256, 256, 1),
    # tensor-core tiles cut by odd sides, and 32-channel output blocks
    (2, 32, 64, 37, 45, 1), (2, 64, 32, 29, 51, 2), (1, 96, 96, 19, 23, 1),
])
def test_conv3x3_kernel_matches_plain(dev, dtype, b, cin, cout, h, w, stride):
    x, wt, bias = _conv_case(dev, b, cin, cout, h, w, dtype)
    before = (conv3x3_kernel.launches, conv3x3_kernel.launches_tc,
              conv3x3_kernel.launches_cuda_core)
    got = conv3x3_kernel(x, wt, bias, stride)
    torch.cuda.synchronize()
    tc = int(conv3x3_path(dtype, cin, cout) == TC)
    assert tc == int(dtype == torch.bfloat16 and min(cin, cout) >= 32)
    assert (conv3x3_kernel.launches, conv3x3_kernel.launches_tc,
            conv3x3_kernel.launches_cuda_core) == (
        before[0] + 1, before[1] + tc, before[2] + 1 - tc)
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = conv3x3_plain(x, wt, bias, stride)
    assert got.dtype == dtype and got.shape == want.shape
    ymax = want.float().abs().max().item()
    # fp32: the same fp32 products summed in another order over 9*Cin terms;
    # bf16: y is then rounded to bf16, one step (2^-8) apart at most
    tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * ymax
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3_autograd_matches_plain(dev, stride):
    x, wt, bias = _conv_case(dev, 2, 8, 16, 20, 24, torch.float32)
    g = torch.randn((2, 16, (20 - 1) // stride + 1, (24 - 1) // stride + 1),
                    device=dev)
    args = [t.clone().requires_grad_(True) for t in (x, wt, bias)]
    before = conv3x3_kernel.launches
    got = torch.autograd.grad(conv3x3(*args, stride), args, g)
    # forward, plus the stride-1 input gradient
    assert conv3x3_kernel.launches == before + (2 if stride == 1 else 1)
    args = [t.clone().requires_grad_(True) for t in (x, wt, bias)]
    want = torch.autograd.grad(conv3x3_plain(*args, stride), args, g)
    for a, r in zip(got, want):
        # fp32 sums of up to B*H*W terms in another order
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4 * r.abs().max().item())


def test_link_autograd_matches_plain(dev):
    x, wt, scale, shift = _link_case(dev, 2, 64, 64, 8, 8, torch.float32)
    gy = torch.randn((2, 64, 8, 8), device=dev)
    gs = torch.randn((2, 64), device=dev) * 1e-3
    args = [t.clone().requires_grad_(True) for t in (x, wt, scale, shift)]
    y, stats = fused_link(*args)
    got = torch.autograd.grad((y, stats), args, (gy, gs))
    args = [t.clone().requires_grad_(True) for t in (x, wt, scale, shift)]
    y, stats = bn_relu_conv_plain(*args)
    want = torch.autograd.grad((y, stats), args, (gy, gs))
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4 * r.abs().max().item())


def test_kernels_raise_on_unsupported_cuda_input(dev):
    x = torch.zeros((1, 48, 4, 4), device=dev)  # Cin % 32 != 0
    with pytest.raises(ValueError):
        fused_bn_relu_conv(x, torch.zeros((64, 48, 3, 3), device=dev),
                           torch.ones(48, device=dev),
                           torch.zeros(48, device=dev))
    with pytest.raises(ValueError):  # W % 4 != 0
        integral_marginals(torch.zeros((1, 8, 4, 6), device=dev), 1)
    with pytest.raises(ValueError):  # fp16 has no kernel
        integral_marginals(torch.zeros((1, 8, 4, 4), device=dev,
                                       dtype=torch.float16), 1)
    x = torch.zeros((1, 8, 4, 12), device=dev, dtype=torch.bfloat16)
    ones = torch.ones((1, 1), device=dev)
    with pytest.raises(ValueError):  # bf16 needs W % 8 == 0
        marginals_backward(x, ones, ones, torch.zeros((1, 1, 12), device=dev),
                           torch.zeros((1, 1, 4), device=dev),
                           torch.zeros((1, 1, 8), device=dev),
                           torch.zeros((1, 1, 12), device=dev),
                           torch.zeros((1, 1, 4), device=dev),
                           torch.zeros((1, 1, 8), device=dev), 1)
    with pytest.raises(ValueError):  # fp16 has no conv3x3 kernel
        conv3x3_kernel(torch.zeros((1, 2, 4, 4), device=dev,
                                   dtype=torch.float16),
                       torch.zeros((3, 2, 3, 3), device=dev),
                       torch.zeros(3, device=dev))
    with pytest.raises(ValueError):  # stride 3
        conv3x3_kernel(torch.zeros((1, 2, 4, 4), device=dev),
                       torch.zeros((3, 2, 3, 3), device=dev),
                       torch.zeros(3, device=dev), 3)
    with pytest.raises(ValueError):  # tensor-core shape, Cin % 32 != 0
        conv3x3_kernel(torch.zeros((1, 40, 4, 4), device=dev,
                                   dtype=torch.bfloat16),
                       torch.zeros((64, 40, 3, 3), device=dev),
                       torch.zeros(64, device=dev))


def test_detector_on_card_matches_cpu(dev):
    """ResNet-50 at 64^2, D = 8: the card's forward goes through both
    kernels (one decode, seven links) and matches the CPU's plain path."""
    params = dict(name="resnet_multi", num_kp=18, depth_dim=8, num_hypo=3,
                  neighbor_size=3, num_layers=50)
    det = build_detector(params)
    weights.init_weights(det, seed=0)
    images = torch.from_numpy(
        np.random.default_rng(0).uniform(0, 1, (2, 3, 64, 64))
        .astype(np.float32))
    weights.condition_for_eval(det, images)
    with torch.no_grad():
        want = det(images).kps
        card = build_detector(params).to(dev)
        card.load_state_dict(det.state_dict())
        decode0, link0 = integral_marginals.launches, fused_bn_relu_conv.launches
        got = card(images.to(dev)).kps
        torch.cuda.synchronize()
    assert integral_marginals.launches - decode0 == 1
    assert fused_bn_relu_conv.launches - link0 == 7
    # fp32 through 50 conditioned layers, convs summed in another order
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("switch_all", [False, True])
def test_switch_points_on_card_matches_cpu(dev, switch_all):
    """The eval's L/R switch on CUDA tensors: the same points and masks as
    on the CPU, ties (points equal to their own swap) kept."""
    from x_as_supervision_tpu_torch.train.eval_utils import (
        DEFAULT_SWITCH_LIST, switch_points)

    gen = torch.Generator().manual_seed(0)
    pts = torch.rand((64, 18, 3), generator=gen) * 2 - 1
    gt = torch.rand((64, 18, 3), generator=gen) * 2 - 1
    perm = list(range(18))
    for a, b in DEFAULT_SWITCH_LIST:
        perm[a], perm[b] = b, a
    pts[:8] = (pts[:8] + pts[:8, perm]) / 2
    want, want_mask = switch_points(pts, gt, switch_all=switch_all)
    got, got_mask = switch_points(pts.to(dev), gt.to(dev),
                                  switch_all=switch_all)
    assert torch.equal(got_mask.cpu(), want_mask)
    assert torch.equal(got.cpu(), want)
    assert not want_mask[:8].any()


def test_argmin_on_card_takes_the_first_of_ties(dev):
    """Best-mode eval relies on it: the hypotheses' 2D errors are equal."""
    gen = torch.Generator().manual_seed(1)
    err = torch.rand((32, 3, 18), generator=gen)
    err[:, 1] = err[:, 0]  # 0 and 1 tied everywhere
    err[:16, 2] = err[:16, 0]  # all three tied in half the batch
    err[::2, 2] = err[::2, 0] + 1  # never the minimum there
    want = torch.argmin(err, dim=1)
    got = torch.argmin(err.to(dev), dim=1).cpu()
    assert torch.equal(got, want)
    assert (want != 1).all()
    assert (want[:16] == 0).all()


def test_triangulation_on_card_matches_cpu(dev):
    """The DLT's batched SVD on the card (cuSOLVER) against the CPU's on
    exact projections of known world points: both recover them."""
    from x_as_supervision_tpu_torch.ops.geometry import batch_triangulate

    rng = np.random.default_rng(2)
    world = rng.normal(0, 500, (32, 18, 3))
    pts, pmats = [], []
    for _ in range(4):
        rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        t = np.array([0.0, 0.0, 5000.0]) + rng.normal(0, 100, 3)
        k = np.array([[1100.0, 0, 500], [0, 1100.0, 500], [0, 0, 1]])
        p = k @ np.concatenate([rot, t[:, None]], axis=1)
        h = world @ p[:, :3].T + p[:, 3]
        pts.append(np.concatenate([h[..., :2] / h[..., 2:], h[..., 2:]],
                                  axis=-1))
        pmats.append(np.broadcast_to(p, (32, 3, 4)))
    kp = torch.from_numpy(np.stack(pts, axis=1)).float()
    pm = torch.from_numpy(np.stack(pmats, axis=1).copy()).float()
    want = batch_triangulate(kp, pm)
    got = batch_triangulate(kp.to(dev), pm.to(dev))
    assert got.device.type == "cuda"
    # the fp32 DLT keeps about 4 digits of a system whose 4th column (the
    # cameras 5 m away) is ~1e3 times the others: 0.26 mm off on the CPU
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1.0)
    torch.testing.assert_close(want[..., :3], torch.from_numpy(world).float(),
                               rtol=0, atol=1.0)


def test_vis_step_on_card_writes_readable_events(dev, tmp_path):
    """One step of the tiny flagship config on the card with a writer: a
    vis step (outputs fetched in one copy, tb_vis's panels) whose events
    read back with every CRC valid, under train_params.profile, whose
    Chrome trace holds the step's CUDA kernels."""
    import json
    import os

    from x_as_supervision_tpu_torch.checks import events_in
    from x_as_supervision_tpu_torch.data.synthetic import (
        SyntheticPoseDataset,
    )
    from x_as_supervision_tpu_torch.train.factory import flagship_config
    from x_as_supervision_tpu_torch.train.logging import create_writer
    from x_as_supervision_tpu_torch.train.trainer import Trainer

    cfg = flagship_config(tiny=True)
    cfg["train_params"].update(batch_size=2, num_epochs=1,
                               profile={"start_step": 0, "num_steps": 0})
    ds = SyntheticPoseDataset(num_samples=2, cam_id_list=(0, 1),
                              patch_size=64)
    trainer = Trainer(cfg, ds, seed=0, dtype=torch.bfloat16, device=dev,
                      save_dir=str(tmp_path / "run"), num_workers=2)
    writer = create_writer(str(tmp_path / "run" / "tensorboard"))
    history = trainer.train(max_steps=1, log=lambda _: None,
                            tb_logger=writer)
    writer.close()
    assert len(history) == 1 and np.isfinite(list(history[0].values())).all()
    (events,) = events_in(str(tmp_path / "run" / "tensorboard")).values()
    assert [e["file_version"] for e in events[:1]] == ["brain.Event:2"]
    scalars = {t: v for e in events for t, v in e["scalars"].items()}
    images = {t for e in events for t in e["images"]}
    for k, v in history[0].items():
        tag = {"loss_total": "training_loss/total_loss",
               "loss_disc": "training_loss/smpl_disc"}.get(
                   k, "training_loss/" + k.split("/", 1)[-1])
        assert scalars[tag] == np.float32(v), tag
    assert {"training_img/cam_0_img", "training_mask/cam_1_mask",
            "training_mask/mask_physique_cam_0",
            "training_pose_2d/pose_2d_pred_cam_1_ori"} <= images
    figures = {"training_pose_3d/src_gt_pose_3d",
               "training_depth/depth_map_cam_0"}
    assert figures <= images | set(writer.skipped)
    (trace,) = os.listdir(tmp_path / "run" / "profile")
    with open(tmp_path / "run" / "profile" / trace) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    assert any("marginals_kernel" in k for k in kernels), kernels[:20]


def test_real_data_uint8_feed_on_card_matches_cpu(dev, tmp_path):
    """A batch of the on-disk H36M fixture (with its SURREAL pseudo stream)
    fed as uint8 and normalized by preprocess_batch on the card equals the
    same on the CPU, and the float feed, exactly."""
    pytest.importorskip("cv2")
    import os

    from x_as_supervision_tpu_torch import checks
    from x_as_supervision_tpu_torch.data.factory import basic_data
    from x_as_supervision_tpu_torch.models.composed import preprocess_batch
    from x_as_supervision_tpu_torch.train.factory import (
        build_gan_spec,
        flagship_config,
    )

    root = str(tmp_path / "tree")
    checks.write_mini_h36m(root, img_size=256, n_frames=4, seed=0)
    checks.write_surreal_pseudo(os.path.join(root, "surreal_h36m_pose"), 8,
                                seed=1)
    batches = {}
    for uint8 in (False, True):
        cfg = flagship_config(tiny=True)
        cfg["dataset_params"] = dict(checks.hm36_dataset_params(root),
                                     cam_id_list=[0, 1], uint8_feed=uint8)
        cfg["train_params"].update(batch_size=4, aug=dict(checks.NO_AUG))
        batches[uint8] = basic_data(cfg, seed=0).device_batch(0, 4)
    spec = build_gan_spec(cfg)
    fed = {k: torch.as_tensor(v) for k, v in batches[True].items()}
    assert fed["cam_0_img"].dtype == torch.uint8
    cpu = preprocess_batch(fed, spec)
    card = preprocess_batch({k: v.to(dev) for k, v in fed.items()}, spec)
    for k, v in cpu.items():
        assert card[k].device.type == "cuda"
        assert torch.equal(card[k].cpu(), v), k
        np.testing.assert_array_equal(v.numpy(), batches[False][k], err_msg=k)
