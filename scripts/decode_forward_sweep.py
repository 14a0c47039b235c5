#!/usr/bin/env python3
"""Sweep of the decode-forward kernel (x_as_supervision_tpu_torch/csrc/
integral_marginals.cu) on one NVIDIA card: copies of the source with other
blocks per SM and ring depths, and two diagnostic copies that drop work
(their results are wrong; only their times mean something), each timed at
split 1, 2 and 4 on the four decode cases of chip_smoke.py.

    python3 scripts/decode_forward_sweep.py     # from the repository root

Prints the card's name and power limit, then one JSON line per (copy, case,
split): ms (CUDA events, mean of 50 back-to-back launches), share of the
byte bound, whether the result matched the plain version, and what ptxas
and the occupancy calculator say of the copy. Needs a card; builds into
build/sweep/.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HBM_BYTES_PER_S = 3.35e12
K, D, SIDE = 18, 64, 64
CASES = ((32, "fp32"), (128, "bf16"), (32, "bf16"), (128, "fp32"))
SPLITS = (1, 2, 4)
ITERS = 50

BLOCKS = "__launch_bounds__(kThreads, 3)"
RING_FP32 = "Variant<float, 4, 4, 4>"
RING_BF16 = "Variant<__nv_bfloat16, 8, 2, 6>"
# name: text substitutions of the source
COPIES = {
    "as_built": [],
    "4_blocks_shallow_ring": [
        (BLOCKS, "__launch_bounds__(kThreads, 4)"),
        (RING_FP32, "Variant<float, 4, 4, 3>"),
        (RING_BF16, "Variant<__nv_bfloat16, 8, 2, 4>")],
    "2_blocks_deep_ring": [
        (BLOCKS, "__launch_bounds__(kThreads, 2)"),
        (RING_FP32, "Variant<float, 4, 4, 6>"),
        (RING_BF16, "Variant<__nv_bfloat16, 8, 2, 8>")],
    "l2_prefetch_256": [
        ("    xas::cp_async16(dst, src, true);",
         '    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], '
         '16;\\n" ::"r"(dst), "l"(src) : "memory");')],
    # diagnostics: no exp (x - m is summed), no per-slice warp sum
    "diag_no_exp": [("const float e = __expf(v[u][j] - m);",
                     "const float e = v[u][j] - m;")],
    "diag_no_warp_sum": [("        s = warp_sum(s);\n", "")],
}


def build(out_dir: Path) -> dict:
    from x_as_supervision_tpu_torch.ops import _build

    src = (_build.CSRC / "integral_marginals.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in COPIES.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: source has no {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xas_integral_marginals.argtypes = [i, p, i, i, i, i, i] + [p] * 6
        lib.xas_integral_marginals.restype = i
        lib.xas_integral_marginals_info.argtypes = [i, i, i, i, i, p]
        lib.xas_integral_marginals_info.restype = i
        libs[name] = (lib, dict(
            registers=[int(r) for r in
                       re.findall(r"Used (\d+) registers", out)],
            spill_stores=[int(r) for r in
                          re.findall(r"(\d+) bytes spill stores", out)]))
    return libs


def cuda_ms(fn) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main() -> int:
    import torch

    from x_as_supervision_tpu_torch.ops.integral_kernel import (
        marginals_plain)

    if not torch.cuda.is_available():
        print("decode_forward_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build(ROOT / "build" / "sweep")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch, kind in CASES:
        dtype = torch.float32 if kind == "fp32" else torch.bfloat16
        x = (torch.randn((batch, K * D, SIDE, SIDE), generator=gen,
                         device="cuda") * 3).to(dtype)
        want = marginals_plain(x, K)
        outs = [torch.empty((batch, K, n), device="cuda")
                for n in (SIDE, SIDE, D)]
        outs += [torch.empty((batch, K), device="cuda") for _ in range(2)]
        ptrs = [o.data_ptr() for o in outs]
        nbytes = x.numel() * x.element_size() + sum(
            o.numel() * 4 for o in outs)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        variant = 0 if kind == "fp32" else 1
        for name, (lib, ptxas) in libs.items():
            for split in SPLITS:
                def launch():
                    err = lib.xas_integral_marginals(
                        variant, x.data_ptr(), batch * K, D, SIDE, SIDE,
                        split, *ptrs, stream)
                    if err:
                        raise RuntimeError(f"{name} split {split}: {err}")

                launch()
                torch.cuda.synchronize()
                err = max((g - w).abs().max().item()
                          for g, w in zip(outs[:3], want[:3]))
                info = (ctypes.c_int * 5)()
                lib.xas_integral_marginals_info(
                    variant, D, SIDE, SIDE, split,
                    ctypes.cast(info, ctypes.c_void_p))
                ms = cuda_ms(launch)
                print(json.dumps(dict(
                    copy=name, dtype=kind, shape=list(x.shape), split=split,
                    ms=ms, bound_ms=bound, share_of_bound=bound / ms,
                    matches_plain=bool(err <= 1e-5
                                       and torch.equal(outs[3], want[3])),
                    blocks_per_sm=info[3], clusters=info[4], **ptxas)),
                    flush=True)
        del x, want, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
