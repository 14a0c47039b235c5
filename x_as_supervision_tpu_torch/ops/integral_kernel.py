"""Softmax marginals of the integral decode and their gradient: the CUDA
kernels ``csrc/integral_marginals.cu`` (forward) and
``csrc/integral_marginals_bwd.cu`` (backward), each with its plain PyTorch
version, and ``marginals``, the differentiable entry point that joins them.

Logits are (B, K*D, H, W) with channel k*D + d (the JAX package's channel
index, in NCHW): joint k's D*H*W volume is one contiguous block. The forward
returns fp32 accu_x (B, K, W), accu_y (B, K, H), accu_z (B, K, D), the joint
max m (B, K) and Z = sum exp(logits - m) (B, K); the backward turns the
marginals' cotangents into dlogits in the logits' type.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def marginals_plain(logits: torch.Tensor, num_joints: int):
    """Plain PyTorch version of the kernel (the math of the JAX package's
    ops/integral.py:heatmap_marginals). The CPU path and the kernel's
    reference."""
    b, c, h, w = logits.shape
    d = c // num_joints
    vol = logits.reshape(b, num_joints, d, h, w).float()
    m = vol.amax(dim=(2, 3, 4), keepdim=True)
    # the shift carries no gradient (softmax is shift-invariant), as the
    # JAX package's stop_gradient on it
    e = torch.exp(vol - m.detach())
    sx = e.sum(dim=(2, 3))  # (B, K, W)
    sy = e.sum(dim=(2, 4))  # (B, K, H)
    sz = e.sum(dim=(3, 4))  # (B, K, D)
    z = sz.sum(dim=-1, keepdim=True)
    zinv = 1.0 / torch.where(z > 0, z, torch.ones_like(z))
    return sx * zinv, sy * zinv, sz * zinv, m.reshape(b, num_joints), z[..., 0]


def integral_marginals(logits: torch.Tensor, num_joints: int):
    """Marginals of (B, K*D, H, W) logits: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if logits.device.type == "cpu":
        return marginals_plain(logits, num_joints)
    if logits.device.type != "cuda":
        raise ValueError(f"no marginals kernel for device {logits.device}")
    if logits.dim() != 4 or logits.dtype not in _DTYPES:
        raise ValueError("marginals kernel takes (B, K*D, H, W) fp32 or bf16 "
                         f"logits, got {tuple(logits.shape)} {logits.dtype}")
    b, c, h, w = logits.shape
    if c % num_joints:
        raise ValueError(f"{c} channels do not split into {num_joints} joints")
    if w % 4 or h * w > 4096:
        raise ValueError(f"marginals kernel needs W % 4 == 0 and H*W <= 4096, "
                         f"got H={h} W={w}")
    if not logits.is_contiguous() or logits.data_ptr() % 16:
        raise ValueError("marginals kernel needs contiguous, 16-byte aligned "
                         "(B, K*D, H, W) logits")
    d = c // num_joints
    f32 = dict(dtype=torch.float32, device=logits.device)
    ax = torch.empty((b, num_joints, w), **f32)
    ay = torch.empty((b, num_joints, h), **f32)
    az = torch.empty((b, num_joints, d), **f32)
    m = torch.empty((b, num_joints), **f32)
    z = torch.empty((b, num_joints), **f32)
    lib = _lib()
    with torch.cuda.device(logits.device):
        err = lib.xas_integral_marginals(
            _DTYPES[logits.dtype], logits.data_ptr(), b * num_joints, d, h, w,
            ax.data_ptr(), ay.data_ptr(), az.data_ptr(), m.data_ptr(),
            z.data_ptr(), _build.stream_handle(logits),
        )
    _build.check(lib, err, "integral_marginals")
    integral_marginals.launches += 1
    return ax, ay, az, m, z


integral_marginals.launches = 0


def marginals_backward_plain(logits, gx, gy, gz, num_joints: int):
    """Plain PyTorch version of the backward kernel: autograd of
    ``marginals_plain``. The CPU path and the kernel's reference."""
    with torch.enable_grad():
        x = logits.detach().requires_grad_(True)
        ax, ay, az, _, _ = marginals_plain(x, num_joints)
        (dx,) = torch.autograd.grad((ax, ay, az), x, (gx, gy, gz))
    return dx


def marginals_backward(logits, m, z, ax, ay, az, gx, gy, gz,
                       num_joints: int):
    """dlogits from the cotangents gx (B, K, W), gy (B, K, H), gz (B, K, D)
    of the forward's marginals ax, ay, az (with its m, Z): the kernel for a
    CUDA tensor, the plain version for a CPU tensor. In the logits' type."""
    if logits.device.type == "cpu":
        return marginals_backward_plain(logits, gx, gy, gz, num_joints)
    if logits.device.type != "cuda":
        raise ValueError(f"no marginals backward kernel for {logits.device}")
    if logits.dim() != 4 or logits.dtype not in _DTYPES:
        raise ValueError("marginals backward kernel takes (B, K*D, H, W) "
                         f"fp32 or bf16 logits, got {tuple(logits.shape)} "
                         f"{logits.dtype}")
    b, c, h, w = logits.shape
    vec = 16 // logits.element_size()
    if c % num_joints or w % vec:
        raise ValueError(f"marginals backward kernel needs C % K == 0 and "
                         f"W % {vec} == 0, got C={c} K={num_joints} W={w}")
    if not logits.is_contiguous() or logits.data_ptr() % 16:
        raise ValueError("marginals backward kernel needs contiguous, "
                         "16-byte aligned logits")
    # <p, g> per joint collapses onto the forward marginals
    # (the TPU version's _marginals_vjp_bwd does the same outside its kernel)
    gx, gy, gz = (g.float().contiguous() for g in (gx, gy, gz))
    inner = ((gx * ax).sum(-1) + (gy * ay).sum(-1)
             + (gz * az).sum(-1)).contiguous()
    dx = torch.empty_like(logits)
    m, z = m.contiguous(), z.contiguous()
    lib = _lib("integral_marginals_bwd")
    with torch.cuda.device(logits.device):
        err = lib.xas_integral_marginals_bwd(
            _DTYPES[logits.dtype], logits.data_ptr(), m.data_ptr(),
            z.data_ptr(), inner.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            gz.data_ptr(), dx.data_ptr(), b * num_joints, c // num_joints, h,
            w, _build.stream_handle(logits),
        )
    _build.check(lib, err, "integral_marginals_bwd")
    marginals_backward.launches += 1
    return dx


marginals_backward.launches = 0


class _Marginals(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, num_joints):
        ax, ay, az, m, z = integral_marginals(logits, num_joints)
        ctx.num_joints = num_joints
        ctx.save_for_backward(logits, m, z, ax, ay, az)
        ctx.mark_non_differentiable(m, z)
        return ax, ay, az, m, z

    @staticmethod
    def backward(ctx, gx, gy, gz, _gm, _gz):
        logits, m, z, ax, ay, az = ctx.saved_tensors
        gx, gy, gz = (torch.zeros_like(a) if g is None else g
                      for g, a in ((gx, ax), (gy, ay), (gz, az)))
        return marginals_backward(logits, m, z, ax, ay, az, gx, gy, gz,
                                  ctx.num_joints), None


def marginals(logits: torch.Tensor, num_joints: int):
    """Differentiable marginals (ax, ay, az, m, Z) of (B, K*D, H, W) logits:
    ``integral_marginals`` forward, ``marginals_backward`` backward."""
    if not (torch.is_grad_enabled() and logits.requires_grad):
        return integral_marginals(logits, num_joints)
    return _Marginals.apply(logits, num_joints)


def _lib(name: str = "integral_marginals"):
    lib = _build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "integral_marginals":
        fn = lib.xas_integral_marginals
        argtypes = [i, p, i, i, i, i, p, p, p, p, p, p]
    else:
        fn = lib.xas_integral_marginals_bwd
        argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, p]
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = i
    return lib
