"""3x3 SAME convolution with bias for small channel counts (the physique
net): the CUDA kernels ``csrc/conv3x3.cu``, their plain PyTorch version, and
``conv3x3``, the differentiable entry point.

    y = conv3x3_SAME(x, w, stride) + bias      # stride 1 or 2, padding 1

x is (B, Cin, H, W) in fp32 or bf16, w (Cout, Cin, 3, 3) (cast to x's type),
bias (Cout,) (fp32 in the sum). Products and sums are fp32; y comes back in
x's type. The kernels work in channels-last memory: the wrapper converts x
explicitly (a no-op for the physique net, which keeps its activations
channels-last) and returns y channels-last, the same logical NCHW tensor.

Three kernels, chosen by shape in one place, ``conv3x3_path``: Cin = 1 or
Cout = 1 (the physique net's first and last convs and their input
gradients) runs the thin kernel, in either type; bf16 with Cin and Cout
multiples of 16 runs the tensor-core implicit GEMM (a last slice of 16
input channels is zero-filled to 32); everything else (fp32 at every width,
bf16 with channel counts off the multiples of 16) runs the FMA kernel, a
register-tiled implicit GEMM on the CUDA cores. Each path counts its own
launches.

The gradient follows the JAX package's conv_pallas.py custom VJP: the
stride-1 input gradient is the same kernel with the spatially flipped,
Cin<->Cout-swapped weights and no bias; the stride-2 input gradient and
every weight gradient go to the library's convolution backward, as the JAX
package leaves them to XLA; the bias gradient is the sum of g. The input
gradient of 1->32 is a 32->1 conv and that of 32->1 a 1->32 one: the thin
kernel again.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from ..spans import BACKWARD, CONV3X3, span

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC = "tensor_core"
THIN = "thin"
CC = "cuda_core"
# each path's launch counter on conv3x3_kernel
PATH_COUNTER = {TC: "launches_tc", THIN: "launches_thin",
                CC: "launches_cuda_core"}
TC_SLICE = 32  # input channels per staged slice of the tensor-core kernel
FMA_KC = 8     # input channels per stage of the FMA kernel


def conv3x3_plain(x, w, bias, stride: int = 1):
    """Plain PyTorch version of the kernels. The CPU path and the kernels'
    reference: fp32 products of working-type values, fp32 sums (float64
    ones for float64 x). bias may be None (no bias)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = F.conv2d(x.to(acc), w.to(x.dtype).to(acc),
                 None if bias is None else bias.to(acc), stride=stride,
                 padding=1)
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
    """Which kernel a conv runs: the thin kernel where one side has one
    channel (the flagship physique net's 1->32 and 32->1 and their input
    gradients, in either type); the tensor cores for bf16 with both sides
    multiples of 16 (its other 8 forwards and 6 input gradients, and a
    tensor-parallel rank's 16-channel shards); else the FMA kernel (fp32,
    and bf16 with channel counts off the multiples of 16)."""
    if cin == 1 or cout == 1:
        return THIN
    if dtype == torch.bfloat16 and cin % 16 == 0 and cout % 16 == 0:
        return TC
    return CC


def fma_block_n(cout: int) -> int:
    """Output channels per block of the FMA kernel (16, 32 or 64): a
    thread owns 8 of them for 8 pixels, and a block 128 threads."""
    return 16 if cout <= 16 else 32 if cout <= 32 else 64


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_weights(w, path: str, dtype=None):
    """w (Cout, Cin, 3, 3) packed for the kernel of `path` by a
    cast-and-permute copy, its values rounded to `dtype` (w's by default).
    Plain torch, so the CPU tests check it.

    - tensor cores, in `dtype`: (ceil(Cin/32), 9, Cout, 32), K = (slice,
      tap, channel of the slice), each output channel's 32 K values
      contiguous (what ldmatrix reads as mma's B); zeros past Cin.
    - thin: (C, 9) fp32, C the side that is not 1 (Cout where Cin is 1,
      else Cin), K = (channel, tap): w's own values as a view where w is
      fp32 and contiguous (no copy, no launch); the kernel rounds them to
      `dtype`.
    - FMA, fp32: (Cin padded to 8, 9, Cout padded to fma_block_n(Cout)),
      K = (channel, tap); zeros in the padding."""
    cout, cin = w.shape[:2]
    dtype = dtype or w.dtype
    if path == TC:
        s = -(-cin // TC_SLICE)
        if s * TC_SLICE > cin:  # a last slice of 16 channels
            w = F.pad(w, (0, 0, 0, 0, 0, s * TC_SLICE - cin))
        out = torch.empty((s, 9, cout, TC_SLICE), dtype=dtype,
                          device=w.device)
        out.view(s, 3, 3, cout, TC_SLICE).copy_(
            w.reshape(cout, s, TC_SLICE, 3, 3).permute(1, 3, 4, 0, 2))
        return out
    if path == THIN:  # (C, 1, 3, 3) or (1, C, 3, 3)
        return w.reshape(max(cin, cout), 9).float().contiguous()
    wq = w.to(dtype).float()
    out = torch.zeros((_up(cin, FMA_KC), 9, _up(cout, fma_block_n(cout))),
                      dtype=torch.float32, device=w.device)
    out[:cin, :, :cout].copy_(wq.reshape(cout, cin, 9).permute(1, 2, 0))
    return out


def conv3x3_kernel(x, w, bias=None, stride: int = 1):
    """The conv on x: a kernel for a CUDA tensor, the plain version for a
    CPU tensor. bias may be None (the input gradient's launch). No
    gradient; ``conv3x3`` is the differentiable form."""
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
    if bias is not None and (bias.shape != (cout,)
                             or bias.device != x.device):
        raise ValueError(f"bias must be ({cout},) on {x.device}")
    path = conv3x3_path(x.dtype, cin, cout)
    x = channels_last(x)
    if x.data_ptr() % 16:
        raise ValueError("conv3x3 kernel needs 16-byte aligned x")
    wp = pack_weights(w, path, x.dtype)
    bias = None if bias is None else bias.float().contiguous()
    y = torch.empty((b, cout, (h - 1) // stride + 1, (wd - 1) // stride + 1),
                    dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    lib = _lib()
    ptrs = (x.data_ptr(), wp.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr())
    shape = (b, cin, cout, h, wd, stride)
    with _build.device_guard(x):
        if path == TC:
            err = lib.xas_conv3x3_tc(*ptrs, *shape, _build.stream_handle(x))
        elif path == THIN:
            err = lib.xas_conv3x3_thin(_DTYPES[x.dtype], *ptrs, *shape,
                                       _build.stream_handle(x))
        else:
            err = lib.xas_conv3x3_fma(_DTYPES[x.dtype], *ptrs, *shape,
                                      fma_block_n(cout),
                                      _build.stream_handle(x))
    _build.check(lib, err, f"conv3x3 ({path})")
    conv3x3_kernel.launches += 1
    counter = PATH_COUNTER[path]
    setattr(conv3x3_kernel, counter, getattr(conv3x3_kernel, counter) + 1)
    return y


conv3x3_kernel.launches = 0
for _counter in PATH_COUNTER.values():
    setattr(conv3x3_kernel, _counter, 0)


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, w)
        return conv3x3_kernel(x, w, bias, stride)

    @staticmethod
    def backward(ctx, g):
        with span(CONV3X3 + BACKWARD):
            x, w = ctx.saved_tensors
            stride = ctx.stride
            g = channels_last(g.to(x.dtype))
            wc = w.to(x.dtype)
            dx = None
            if ctx.needs_input_grad[0] and stride == 1:
                wt = wc.flip(2, 3).transpose(0, 1)  # (Cin, Cout, 3, 3)
                dx = conv3x3_kernel(g, wt, None, 1)
            mask = [ctx.needs_input_grad[0] and stride != 1,
                    ctx.needs_input_grad[1], False]
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, wc, None, [stride, stride], [1, 1], [1, 1], False,
                [0, 0], 1, mask)
            if mask[0]:
                dx = gx
            dw = gw.to(w.dtype) if gw is not None else None
            db = (g.to(torch.promote_types(g.dtype, torch.float32)).sum(
                dim=(0, 2, 3)) if ctx.needs_input_grad[2] else None)
            return dx, dw, db, None


def conv3x3(x, w, bias, stride: int = 1):
    """Differentiable 3x3 SAME conv with bias (see the module docstring)."""
    with span(CONV3X3):
        return _Conv3x3.apply(x, w, bias, stride)


def _lib():
    lib = _build.load("conv3x3")
    if lib.xas_conv3x3_tc.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xas_conv3x3_tc.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.xas_conv3x3_tc.restype = i
        lib.xas_conv3x3_thin.argtypes = [i, p, p, p, p, i, i, i, i, i, i, p]
        lib.xas_conv3x3_thin.restype = i
        lib.xas_conv3x3_fma.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.xas_conv3x3_fma.restype = i
    return lib
