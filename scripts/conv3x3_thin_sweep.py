#!/usr/bin/env python3
"""Sweep of conv3x3's thin kernel (x_as_supervision_tpu_torch/csrc/
conv3x3.cu, Cout = 1 and Cin = 1) on one NVIDIA card: copies of the source
with other output rows a thread (THIN_R_ROWS), tiles a block (THIN_R_TILES:
1 is one stage, more a double-buffered pipeline down the column strip) and
blocks an SM, each timed on the physique net's 32->1 and 1->32 at the
flagship's batch (128) and a camera's (32).

    python3 scripts/conv3x3_thin_sweep.py     # from the repository root

Prints the card's name and power limit, then one JSON line per (copy,
case): ms (CUDA events, mean of 50 back-to-back launches, the stream held
while the host queues them), share of the byte bound, the largest error
against conv3x3_plain, and what ptxas says of the copy's thin kernels.
Needs a card; builds into build/sweep/.
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
ITERS = 50
# (batch, Cin, Cout, side, stride, type)
CASES = ((128, 32, 1, 256, 1, "bf16"), (32, 32, 1, 256, 1, "bf16"),
         (128, 32, 1, 256, 1, "fp32"), (128, 32, 1, 256, 2, "bf16"),
         (128, 1, 32, 256, 1, "bf16"), (32, 1, 32, 256, 1, "bf16"))

ROWS = "constexpr int THIN_R_ROWS = 4;"
TILES = "constexpr int THIN_R_TILES = 1;"
BLOCKS = "__launch_bounds__(EXPAND ? THIN_E_NT : THIN_R_NT, EXPAND ? 2 : 4)"
# name: text substitutions of the source
COPIES = {
    "as_built": [],
    "rows4_tiles2": [(TILES, "constexpr int THIN_R_TILES = 2;")],
    "rows4_tiles4": [(TILES, "constexpr int THIN_R_TILES = 4;")],
    "rows2_tiles1": [(ROWS, "constexpr int THIN_R_ROWS = 2;")],
    "rows2_tiles4": [(ROWS, "constexpr int THIN_R_ROWS = 2;"),
                     (TILES, "constexpr int THIN_R_TILES = 4;")],
    "rows2_tiles8_6_blocks": [
        (ROWS, "constexpr int THIN_R_ROWS = 2;"),
        (TILES, "constexpr int THIN_R_TILES = 8;"),
        (BLOCKS, "__launch_bounds__(EXPAND ? THIN_E_NT : THIN_R_NT, "
                 "EXPAND ? 2 : 6)")],
}


def build(out_dir: Path) -> dict:
    from x_as_supervision_tpu_torch.ops import _build

    src = (_build.CSRC / "conv3x3.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in COPIES.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: source has no {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"conv3x3_{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out_dir / f"conv3x3_{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"conv3x3_{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xas_conv3x3_thin.argtypes = [i, p, p, p, p] + [i] * 6 + [p]
        lib.xas_conv3x3_thin.restype = i
        # ptxas of the thin kernels only: "Compiling entry function" lines
        # name the kernel, the next lines its registers and spills
        thin = re.findall(r"conv3x3_thin_kernel(I\w+)' for 'sm_90a'\n"
                          r"(?:.*\n)*?.*Used (\d+) registers", out)
        libs[name] = (lib, {k: int(r) for k, r in thin})
    return libs


def cuda_ms(fn) -> float:
    import torch

    from x_as_supervision_tpu_torch.tools.measure import HOLD_CYCLES

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main() -> int:
    import torch

    from x_as_supervision_tpu_torch.ops.conv3x3 import (
        THIN, channels_last, conv3x3_plain, pack_weights)

    if not torch.cuda.is_available():
        print("conv3x3_thin_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    # the plain version in full fp32
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build(ROOT / "build" / "sweep")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch, cin, cout, side, stride, kind in CASES:
        dtype = torch.float32 if kind == "fp32" else torch.bfloat16
        x = channels_last(torch.randn((batch, cin, side, side), generator=gen,
                                      device="cuda").to(dtype))
        w = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * (
            2 / (9 * cin)) ** 0.5
        bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
        want = conv3x3_plain(x, w, bias, stride)
        y = torch.empty_like(want, memory_format=torch.channels_last)
        wp = pack_weights(w, THIN, dtype)
        nbytes = (x.numel() + y.numel()) * x.element_size() + w.numel() * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        for name, (lib, registers) in libs.items():
            def launch():
                err = lib.xas_conv3x3_thin(
                    int(kind == "bf16"), x.data_ptr(), wp.data_ptr(),
                    bias.data_ptr(), y.data_ptr(), batch, cin, cout, side,
                    side, stride, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            err = (y.float() - want.float()).abs().max().item()
            ms = cuda_ms(launch)
            print(json.dumps(dict(
                copy=name, dtype=kind, batch=batch, cin=cin, cout=cout,
                side=side, stride=stride, ms=ms, bound_ms=bound,
                share_of_bound=bound / ms, max_abs_err=err,
                ymax=want.float().abs().max().item(),
                thin_registers=registers)), flush=True)
        del x, want, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
