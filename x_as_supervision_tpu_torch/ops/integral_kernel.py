"""Softmax marginals of the integral decode: the CUDA kernel
``csrc/integral_marginals.cu`` and its plain PyTorch version.

Logits are (B, K*D, H, W) with channel k*D + d (the JAX package's channel
index, in NCHW): joint k's D*H*W volume is one contiguous block. Both
versions return fp32 accu_x (B, K, W), accu_y (B, K, H), accu_z (B, K, D),
the joint max m (B, K) and Z = sum exp(logits - m) (B, K).
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
    e = torch.exp(vol - m)
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


def _lib():
    lib = _build.load("integral_marginals")
    fn = lib.xas_integral_marginals
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, i, i, i, i, p, p, p, p, p, p]
        fn.restype = i
    return lib
