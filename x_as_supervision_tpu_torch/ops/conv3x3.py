"""3x3 SAME convolution with bias for small channel counts (the physique
net): the CUDA kernel ``csrc/conv3x3.cu``, its plain PyTorch version, and
``conv3x3``, the differentiable entry point.

    y = conv3x3_SAME(x, w, stride) + bias      # stride 1 or 2, padding 1

x is (B, Cin, H, W) in fp32 or bf16, w (Cout, Cin, 3, 3) (cast to x's type),
bias (Cout,) (fp32 in the sum). Products and sums are fp32; y comes back in
x's type. The gradient follows the JAX package's conv_pallas.py custom VJP:
the stride-1 input gradient is the same kernel with the spatially flipped,
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


def conv3x3_plain(x, w, bias, stride: int = 1):
    """Plain PyTorch version of the kernel. The CPU path and the kernel's
    reference: fp32 products of working-type values, fp32 sums."""
    y = F.conv2d(x.float(), w.to(x.dtype).float(), bias.float(),
                 stride=stride, padding=1)
    return y.to(x.dtype)


def conv3x3_kernel(x, w, bias, stride: int = 1):
    """The conv on x: the kernel for a CUDA tensor, the plain version for a
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
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    bias = bias.float().contiguous()
    y = torch.empty((b, cout, (h - 1) // stride + 1, (wd - 1) // stride + 1),
                    dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.xas_conv3x3(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
                              bias.data_ptr(), y.data_ptr(), b, cin, cout, h,
                              wd, stride, _build.stream_handle(x))
    _build.check(lib, err, "conv3x3")
    conv3x3_kernel.launches += 1
    return y


conv3x3_kernel.launches = 0


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
        g = g.to(x.dtype).contiguous()
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
    fn = lib.xas_conv3x3
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
    return lib
