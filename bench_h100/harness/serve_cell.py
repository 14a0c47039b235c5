"""A serving cell: one caller in a closed loop through the program's
``serve.py:PoseEstimator``, each request a slice of uint8 crops in pageable
host memory, timed from the call to the returned ``PoseResult``.

The weights are the seed's, their BatchNorm running statistics those of
one training forward of the reference over the first crops of the pool
(harness/weights.py). After the window the program is freed and the
reference's float32 forward runs over every pool slot that a sample of the
window's requests, drawn from the seed, read.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from reference import gan as R

from . import checks
from . import traffic as T
from . import weights
from . import work as W
from .bench import SHORT
from .trace import WINDOW, profile, summarize
from .train_cell import sync

CONDITION_IMAGES = 64
WARMUP_REQUESTS = 2


def _feed(config: dict, crops, device) -> torch.Tensor:
    """uint8 (N, S, S, 3) -> the float (N, 3, S, S) the detector takes:
    (x - mean) / std with the configuration's dataiter values."""
    di = config["dataset_params"].get("dataiter", {})
    x = torch.as_tensor(crops).to(device).float()
    if di.get("mean") is not None and di.get("std") is not None:
        x = ((x - torch.tensor(di["mean"], device=device))
             / torch.tensor(di["std"], device=device))
    return x.permute(0, 3, 1, 2).contiguous()


def detector_state(config: dict, seed: int, pool: np.ndarray,
                   device) -> dict:
    """The seed's detector weights with conditioned running statistics, as
    host tensors (computed with TF32 off)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        det = weights.reference_gan(config, seed, device).detector
        crops = pool.reshape(-1, *pool.shape[2:])[:CONDITION_IMAGES]
        weights.condition_running_stats(det, _feed(config, crops, device))
        return {k: v.cpu() for k, v in det.state_dict().items()}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def program(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, call_fn=None) -> dict:
    """Set-up, the window and (with `trace`) a traced stretch of requests;
    `call_fn(estimator, crops)` stands in for the call (a fault)."""
    from x_as_supervision_tpu_torch.serve import PoseEstimator

    config, tr = cell.config, cell.traffic
    pool = T.serve_pool(config, tr, seed, device)
    state = detector_state(config, seed, pool, device)
    est = PoseEstimator(config, det_state=state,
                        batch_size=int(tr["server_batch"]),
                        dtype=cell.dtype, device=device)
    call = call_fn or (lambda e, crops: e(crops))
    for r in range(WARMUP_REQUESTS):
        call(est, pool[r % len(pool)])
    sync(device)
    setup_s = time.perf_counter() - t_start

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    served, ms = [], []
    r = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        slot = r % len(pool)
        a = time.perf_counter()
        out = call(est, pool[slot])
        ms.append((time.perf_counter() - a) * 1e3)
        served.append((slot, out.kps_patch))
        r += 1
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    summary = None
    if trace:
        n = int(tr["traced_requests"])
        with profile() as prof:
            with torch.profiler.record_function(WINDOW):
                for k in range(n):
                    call(est, pool[(r + k) % len(pool)])
                sync(device)
        summary = summarize(prof, n)
    del est
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"served": served, "request_ms": ms, "pool": pool,
            "state": state, "setup_s": setup_s, "window_s": window_s,
            "attempted": r, "images": r * pool.shape[1],
            "peak_bytes": peak, "trace": summary}


def sample(seed: int, served: list, n: int) -> list:
    """n of the window's answers, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 7])
    pick = rng.choice(len(served), size=min(n, len(served)), replace=False)
    return [served[i] for i in sorted(pick)]


def reference(cell, pool: np.ndarray, state: dict, slots, device,
              operands: str = "fp32", block: int = 128) -> dict:
    """{slot: keypoints (N, H, K, 3)} of the reference's float32 eval
    forward (TF32 off) over each pool slot; `operands` "fp8" is the
    control."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    det = R.Detector(cell.config["model_params"]["detector_params"])
    det.load_state_dict(state)
    det = det.to(device).eval()
    R.set_numerics(det, R.Numerics(operands))
    out = {}
    with torch.no_grad():
        for slot in sorted(set(slots)):
            crops = pool[slot]
            parts = [det(_feed(cell.config, crops[s:s + block], device))
                     for s in range(0, len(crops), block)]
            out[slot] = torch.cat(parts).double().cpu().numpy()
    del det
    gc.collect()
    return out


def work(cell, peaks: dict) -> dict:
    n = int(cell.traffic["request_images"])
    return W.serve_request_work(cell.config, n, int(cell.traffic["server_batch"]),
                                SHORT[cell.dtype], peaks)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, call_fn=None) -> dict:
    """The program's run, then the reference over the pool slots of a
    sample of its answers and the numbers that decide ``correct``."""
    out = program(cell, seed, seconds, trace, device, t_start, call_fn)
    picked = sample(seed, out.pop("served"),
                    int(cell.traffic["checked_requests"]))
    t = time.perf_counter()
    ref = reference(cell, out.pop("pool"), out.pop("state"),
                    [s for s, _ in picked], device)
    out["values"] = checks.serve_numbers(picked, ref)
    out["where"] = {"checked_requests": len(picked),
                    "reference_s": time.perf_counter() - t}
    out["failed"] = 0
    return out
