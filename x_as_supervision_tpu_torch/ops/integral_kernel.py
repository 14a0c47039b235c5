"""Softmax marginals of the integral decode and their gradient: the CUDA
kernels ``csrc/integral_marginals.cu`` (forward) and
``csrc/integral_marginals_bwd.cu`` (backward), each with its plain PyTorch
version, and ``marginals``, the differentiable entry point that joins them.

Logits are (B, K*D, H, W) with channel k*D + d (the JAX package's channel
index, in NCHW): joint k's D*H*W volume is one contiguous block. The forward
returns fp32 accu_x (B, K, W), accu_y (B, K, H), accu_z (B, K, D), the joint
max m (B, K) and Z = sum exp(logits - m) (B, K); the backward turns the
marginals' cotangents into dlogits in the logits' type.

The forward kernel splits each joint's D slices over a cluster of 1, 2 or 4
blocks; each block walks its slices in chunks of 4096 logits with 16-byte
copies (8-byte for bf16 with W % 8 != 0) into a ring of several slices in
shared memory, keeps its online-softmax state per warp with no block
barrier in the slice loop, and the cluster combines its (max, Z, sums) once
in distributed shared memory. ``marginals_plan`` works the launch out from
the shapes: it takes W % 4 == 0 and any H*W; D, H and W are bounded only by
the block's shared memory (the ring, and W + H + 17 * ceil(D / split)
floats, within 227 KB).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build
from ..spans import BACKWARD, INTEGRAL_MARGINALS, span

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The forward kernel's variants, as csrc/integral_marginals.cu instantiates
# them: (logits per access V, accesses per thread per chunk U, ring stages
# P). A chunk is THREADS * U * V = 4096 logits; P - 1 slices are in flight.
THREADS = 256
VARIANTS = {
    0: (4, 4, 4),  # fp32, 16-byte copies
    1: (8, 2, 6),  # bf16, 16-byte copies (W % 8 == 0)
    2: (4, 4, 6),  # bf16, 8-byte copies
}
BLOCKS_PER_SM = 3  # the kernel's __launch_bounds__(256, 3)
SPLITS = (1, 2, 4)  # blocks (one cluster) per joint
MAX_SMEM = 227 * 1024
_SMEM_FIXED = 2 * (THREADS // 32) + 2  # floats: warp maxima, Z partials, (M, Z)


@dataclass(frozen=True)
class MarginalsPlan:
    """One launch of the forward kernel: its variant (see VARIANTS), logits
    per access and bytes per access, accesses per thread per chunk, ring
    stages, blocks per joint (the cluster), chunks per slice, blocks in the
    grid, waves at BLOCKS_PER_SM, and shared memory per block."""

    variant: int
    vec: int
    access_bytes: int
    vectors: int
    stages: int
    split: int
    chunks: int
    blocks: int
    waves: float
    smem_bytes: int


def _split(joints: int, d: int, sms: int) -> int:
    """Blocks per joint: the smallest split whose last wave (at
    BLOCKS_PER_SM) is at least 90 % full, else the one whose last wave is
    fullest; never more than D."""
    cands = [s for s in SPLITS if s <= d] or [1]

    def fill(s):
        waves = joints * s / (sms * BLOCKS_PER_SM)
        return waves / -(-waves // 1)

    for s in cands:
        if fill(s) >= 0.9:
            return s
    return max(cands, key=fill)


@functools.lru_cache(maxsize=None)
def marginals_plan(b: int, k: int, d: int, h: int, w: int, dtype,
                   sms: int) -> MarginalsPlan:
    """The forward kernel's launch for (B, K*D, H, W) logits of `dtype` on a
    card of `sms` SMs. Raises ValueError on a shape the kernel does not
    take."""
    if dtype not in _DTYPES:
        raise ValueError(f"marginals kernel takes fp32 or bf16 logits, got "
                         f"{dtype}")
    if w % 4:
        raise ValueError(f"marginals kernel needs W % 4 == 0, got W={w}")
    if dtype == torch.float32:
        variant = 0
    else:
        variant = 1 if w % 8 == 0 else 2
    vec, vectors, stages = VARIANTS[variant]
    elt = 4 if dtype == torch.float32 else 2
    joints = b * k
    split = _split(joints, d, sms)
    chunk = THREADS * vectors * vec
    smem = stages * chunk * elt + 4 * (
        _SMEM_FIXED + w + h + (2 * (THREADS // 32) + 1) * -(-d // split))
    if smem > MAX_SMEM:
        raise ValueError(f"marginals kernel needs {smem} bytes of shared "
                         f"memory for D={d} H={h} W={w}, over {MAX_SMEM}")
    return MarginalsPlan(
        variant=variant, vec=vec, access_bytes=vec * elt, vectors=vectors,
        stages=stages, split=split, chunks=-(-h * w // chunk),
        blocks=joints * split,
        waves=joints * split / (sms * BLOCKS_PER_SM), smem_bytes=smem)


def marginals_plain(logits: torch.Tensor, num_joints: int):
    """Plain PyTorch version of the kernel (the math of the JAX package's
    ops/integral.py:heatmap_marginals). The CPU path and the kernel's
    reference. In fp32, float64 logits in float64."""
    b, c, h, w = logits.shape
    d = c // num_joints
    vol = logits.reshape(b, num_joints, d, h, w).to(
        torch.promote_types(logits.dtype, torch.float32))
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
    if not logits.is_contiguous() or logits.data_ptr() % 16:
        raise ValueError("marginals kernel needs contiguous, 16-byte aligned "
                         "(B, K*D, H, W) logits")
    d = c // num_joints
    plan = marginals_plan(b, num_joints, d, h, w, logits.dtype,
                          _sms(logits.device))
    f32 = dict(dtype=torch.float32, device=logits.device)
    ax = torch.empty((b, num_joints, w), **f32)
    ay = torch.empty((b, num_joints, h), **f32)
    az = torch.empty((b, num_joints, d), **f32)
    m = torch.empty((b, num_joints), **f32)
    z = torch.empty((b, num_joints), **f32)
    lib = _lib()
    with torch.cuda.device(logits.device):
        err = lib.xas_integral_marginals(
            plan.variant, logits.data_ptr(), b * num_joints, d, h, w,
            plan.split,
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
        with span(INTEGRAL_MARGINALS + BACKWARD):
            logits, m, z, ax, ay, az = ctx.saved_tensors
            gx, gy, gz = (torch.zeros_like(a) if g is None else g
                          for g, a in ((gx, ax), (gy, ay), (gz, az)))
            return marginals_backward(logits, m, z, ax, ay, az, gx, gy, gz,
                                      ctx.num_joints), None


def marginals(logits: torch.Tensor, num_joints: int):
    """Differentiable marginals (ax, ay, az, m, Z) of (B, K*D, H, W) logits:
    ``integral_marginals`` forward, ``marginals_backward`` backward."""
    with span(INTEGRAL_MARGINALS):
        if not (torch.is_grad_enabled() and logits.requires_grad):
            return integral_marginals(logits, num_joints)
        return _Marginals.apply(logits, num_joints)


def marginals_kernel_info(plan: MarginalsPlan, d: int, h: int,
                          w: int) -> dict:
    """What the card makes of the forward kernel at a plan: registers and
    local (spill) bytes a thread, shared bytes a block, resident blocks per
    SM and resident clusters on the card (cudaOccupancy*)."""
    out = (ctypes.c_int * 5)()
    lib = _lib()
    err = lib.xas_integral_marginals_info(plan.variant, d, h, w, plan.split,
                                          ctypes.cast(out, ctypes.c_void_p))
    _build.check(lib, err, "integral_marginals_info")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm", "clusters"), out))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib(name: str = "integral_marginals"):
    lib = _build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "integral_marginals":
        fn = lib.xas_integral_marginals
        argtypes = [i, p, i, i, i, i, i, p, p, p, p, p, p]
    else:
        fn = lib.xas_integral_marginals_bwd
        argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, p]
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = i
        if name == "integral_marginals":
            info = lib.xas_integral_marginals_info
            info.argtypes, info.restype = [i, i, i, i, i, p], i
    return lib
