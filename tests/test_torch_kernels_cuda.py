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
from x_as_supervision_tpu_torch.ops.conv_bn import (
    bn_relu_conv_plain,
    fused_bn_relu_conv,
)
from x_as_supervision_tpu_torch.ops.integral_kernel import (
    integral_marginals,
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 3, 8, 8, 8),     # (B, K, D, H, W): small
    (1, 2, 5, 6, 12),    # H*W/4 = 18 threads: a partly idle warp
    (2, 18, 64, 64, 64),  # the serving shape
])
def test_marginals_kernel_matches_plain(dev, dtype, shape):
    b, k, d, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn((b, k * d, h, w), generator=gen, device=dev) * 3
         ).to(dtype)
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
])
def test_link_kernel_matches_plain(dev, dtype, b, c, co, h, w, shift_mean):
    x, wt, scale, shift = _link_case(dev, b, c, co, h, w, dtype, shift_mean)
    before = fused_bn_relu_conv.launches
    y, stats = fused_bn_relu_conv(x, wt, scale, shift)
    torch.cuda.synchronize()
    assert fused_bn_relu_conv.launches == before + 1
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
