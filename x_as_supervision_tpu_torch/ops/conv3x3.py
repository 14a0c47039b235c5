"""3x3 SAME convolution with bias for small channel counts (the physique
net): the CUDA kernels ``csrc/conv3x3.cu``, their plain PyTorch version, and
``conv3x3``, the differentiable entry point.

    y = conv3x3_SAME(x, w, stride) + bias      # stride 1 or 2, padding 1

x is (B, Cin, H, W) in fp32 or bf16, w (Cout, Cin, 3, 3) (cast to x's type),
bias (Cout,) (fp32 in the sum). Products and sums are fp32; y comes back in
x's type. The kernels work in channels-last memory: the wrapper converts x
explicitly (a no-op for the physique net, which keeps its activations
channels-last) and returns y channels-last, the same logical NCHW tensor.

Two kernels, chosen by shape in one place, ``conv3x3_path``: bf16 with
Cin >= 32 and Cout >= 32 runs the tensor-core implicit GEMM (it needs
Cin % 32 == Cout % 32 == 0 and raises otherwise); everything else (fp32,
and bf16 with a side below 32 channels, such as 1->32 and 32->1) runs the
CUDA-core kernel. Each path counts its own launches.

The gradient follows the JAX package's conv_pallas.py custom VJP: the
stride-1 input gradient is the same kernel with the spatially flipped,
Cin<->Cout-swapped weights and zero bias; the stride-2 input gradient and
every weight gradient go to the library's convolution backward, as the JAX
package leaves them to XLA; the bias gradient is the sum of g.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC = "tensor_core"
CC = "cuda_core"
TC_SLICE = 32  # input channels per staged slice of the tensor-core kernel


def conv3x3_plain(x, w, bias, stride: int = 1):
    """Plain PyTorch version of the kernels. The CPU path and the kernels'
    reference: fp32 products of working-type values, fp32 sums."""
    y = F.conv2d(x.float(), w.to(x.dtype).float(), bias.float(),
                 stride=stride, padding=1)
    return y.to(x.dtype)


def channels_last(x):
    """x in channels-last memory with the dense NHWC strides: copied when its
    memory is not NHWC, and only restrided (free) when it is. A tensor with
    C = 1 is contiguous in both formats and may carry either one's strides,
    so ``is_contiguous`` alone does not say which strides it has."""
    x = x.contiguous(memory_format=torch.channels_last)
    b, c, h, w = x.shape
    want = (h * w * c, 1, w * c, c)
    return x if x.stride() == want else x.as_strided(x.shape, want)


def conv3x3_path(dtype, cin: int, cout: int) -> str:
    """Which kernel a conv runs: the tensor-core path for bf16 with at least
    32 input and 32 output channels (8 forwards and 6 input gradients of the
    flagship physique net), else the CUDA-core path (fp32; bf16 1->32, 32->1
    and odd channel counts)."""
    if dtype == torch.bfloat16 and cin >= 32 and cout >= 32:
        return TC
    return CC


def pack_weights(w, path: str, dtype=None):
    """w (Cout, Cin, 3, 3) packed for the kernel of `path`, in `dtype` (w's
    by default), by one cast-and-permute copy. Tensor cores: (Cin/32, 9,
    Cout, 32), K = (slice, tap, channel of the slice), each output
    channel's 32 K values contiguous (what ldmatrix reads as mma's B). CUDA
    cores: (Cin, 9, Cout), K = (channel, tap). Plain torch, so the CPU tests
    check it."""
    cout, cin = w.shape[:2]
    dtype = dtype or w.dtype
    if path == TC:
        s = cin // TC_SLICE
        out = torch.empty((s, 9, cout, TC_SLICE), dtype=dtype, device=w.device)
        out.view(s, 3, 3, cout, TC_SLICE).copy_(
            w.reshape(cout, s, TC_SLICE, 3, 3).permute(1, 3, 4, 0, 2))
        return out
    out = torch.empty((cin, 9, cout), dtype=dtype, device=w.device)
    out.view(cin, 3, 3, cout).copy_(w.permute(1, 2, 3, 0))
    return out


def conv3x3_kernel(x, w, bias, stride: int = 1):
    """The conv on x: a kernel for a CUDA tensor, the plain version for a
    CPU tensor. No gradient; ``conv3x3`` is the differentiable form."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, bias, stride)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3x3 kernel for device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError("conv3x3 kernel takes (B, Cin, H, W) fp32 or bf16 x, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if stride not in (1, 2):
        raise ValueError(f"conv3x3 kernel takes stride 1 or 2, got {stride}")
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 3, 3) or w.device != x.device:
        raise ValueError(f"w must be (Cout, {cin}, 3, 3) on {x.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    if bias.shape != (cout,) or bias.device != x.device:
        raise ValueError(f"bias must be ({cout},) on {x.device}")
    path = conv3x3_path(x.dtype, cin, cout)
    if path == TC and (cin % TC_SLICE or cout % 32):
        raise ValueError(f"the tensor-core conv3x3 needs Cin % {TC_SLICE} == "
                         f"0 and Cout % 32 == 0, got {cin}->{cout}")
    x = channels_last(x)
    if x.data_ptr() % 16:
        raise ValueError("conv3x3 kernel needs 16-byte aligned x")
    wp = pack_weights(w, path, x.dtype)
    bias = bias.float().contiguous()
    y = torch.empty((b, cout, (h - 1) // stride + 1, (wd - 1) // stride + 1),
                    dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    lib = _lib()
    args = (x.data_ptr(), wp.data_ptr(), bias.data_ptr(), y.data_ptr(), b,
            cin, cout, h, wd, stride, _build.stream_handle(x))
    with _build.device_guard(x):
        if path == TC:
            err = lib.xas_conv3x3_tc(*args)
        else:
            err = lib.xas_conv3x3_cc(_DTYPES[x.dtype], *args)
    _build.check(lib, err, f"conv3x3 ({path})")
    conv3x3_kernel.launches += 1
    if path == TC:
        conv3x3_kernel.launches_tc += 1
    else:
        conv3x3_kernel.launches_cuda_core += 1
    return y


conv3x3_kernel.launches = 0
conv3x3_kernel.launches_tc = 0
conv3x3_kernel.launches_cuda_core = 0


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, w)
        return conv3x3_kernel(x, w, bias, stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride = ctx.stride
        g = channels_last(g.to(x.dtype))
        wc = w.to(x.dtype)
        dx = None
        if ctx.needs_input_grad[0] and stride == 1:
            wt = wc.flip(2, 3).transpose(0, 1)  # (Cin, Cout, 3, 3)
            dx = conv3x3_kernel(g, wt, torch.zeros(
                x.shape[1], dtype=torch.float32, device=x.device), 1)
        mask = [ctx.needs_input_grad[0] and stride != 1,
                ctx.needs_input_grad[1], False]
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g, x, wc, None, [stride, stride], [1, 1], [1, 1], False, [0, 0],
            1, mask)
        if mask[0]:
            dx = gx
        dw = gw.to(w.dtype) if gw is not None else None
        db = g.float().sum(dim=(0, 2, 3)) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None


def conv3x3(x, w, bias, stride: int = 1):
    """Differentiable 3x3 SAME conv with bias (see the module docstring)."""
    return _Conv3x3.apply(x, w, bias, stride)


def _lib():
    lib = _build.load("conv3x3")
    if lib.xas_conv3x3_tc.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xas_conv3x3_tc.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.xas_conv3x3_tc.restype = i
        lib.xas_conv3x3_cc.argtypes = [i, p, p, p, p, i, i, i, i, i, i, p]
        lib.xas_conv3x3_cc.restype = i
    return lib
