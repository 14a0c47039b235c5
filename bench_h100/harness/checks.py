"""The numbers that decide ``correct``, each against its limit (the
limits, per cell, in ``workloads/<cell>.json``).

Training, over the first three steps of the one train state that the
window then drives, against the reference's three steps from the same
weights, batches and dropout draws:

  * ``loss1_gap``: the larger relative gap of the first step's two losses
    (the generator's total and the discriminator's);
  * ``grad_gap_p90``: the first step's gradient as each Adam took it
    (twice its first moment after one step, beta1 = 0.5), leaf by leaf:
    the gap between the program's norm and the reference's over the
    larger of the reference's norm and its median leaf's; the 90th
    percentile over the leaves;
  * ``delta_gap``: the same gap for each leaf's change over the three
    steps, the worst leaf.

Leaves whose reference gradient is under a thousandth of the median
leaf's (biases that a BatchNorm cancels) move under Adam by rounding alone
and are left out of both, by that rule. ``loss_gap`` (the worst of the
three steps' losses) and ``grad_gap`` (the worst leaf) are reported
beside them and not compared: both read the noise of the later steps or
of one small leaf (PERF.md).

Serving, over a sample of the window's answers drawn from the seed,
against the reference's forward over the same crops:

  * ``xy_gap_p99``: the 99th percentile of the gaps of the served x and y
    keypoint coordinates (normalized to [-1, 1]);
  * ``z_gap_med``: the median gap of the served depths.

The widest x, y and depth gaps are reported and not compared: the widest
x or y gap swings from seed to seed by its nature (one seed in 14 read
four times the others), and a depth hypothesis can jump between two peaks
of the depth marginal.
"""

import numpy as np

# a leaf whose reference gradient norm is under this share of the median
# leaf's is left out of the gradient and change gaps
STILL_LEAF = 1e-3


def _gaps(prog: dict, ref: dict, keep) -> tuple[list, np.ndarray, float]:
    """Each kept leaf's gap: |program norm - reference norm| over the
    larger of the reference's norm and its median leaf's."""
    names = [n for n in ref if n in keep]
    r = np.array([ref[n] for n in names])
    p = np.array([prog[n] for n in names])
    med = float(np.median(r))
    gaps = np.abs(p - r) / np.maximum(r, med if med > 0 else 1.0)
    return names, gaps, med


def train_numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """({number: value}, {number: what it was read from}) of two readings
    (``losses`` [(total, disc)] per step, ``grad`` and ``delta`` {leaf:
    norm}); ``prog`` may be the reference run another way (the control)."""
    def rel(p, r):
        gap = abs(p - r) / max(abs(r), 1e-12)
        return gap if np.isfinite(gap) else float("inf")

    gaps = [max(rel(pt, rt), rel(pd, rd))
            for (pt, pd), (rt, rd) in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        gaps.append(float("inf"))
    med = float(np.median(list(ref["grad"].values())))
    moving = {n for n, g in ref["grad"].items() if g >= STILL_LEAF * med}
    values = {"loss_gap": max(gaps), "loss1_gap": gaps[0]}
    where = {"still_leaves": sorted(set(ref["grad"]) - moving),
             "least_moving_over_median": min(
                 ref["grad"][n] for n in moving) / med}
    for key in ("grad", "delta"):
        names, g, m = _gaps(prog[key], ref[key], moving)
        g = np.nan_to_num(g, nan=np.inf)
        i = int(np.argmax(g))
        values[f"{key}_gap"] = float(g[i])
        where[f"{key}_gap"] = names[i]
        where[f"{key}_gap_ref_over_median"] = float(ref[key][names[i]] / m)
        if key == "grad":
            values["grad_gap_p90"] = float(np.quantile(g, 0.9))
    return values, where


def serve_numbers(served: list, ref: dict) -> dict:
    """served: [(pool slot, kps (N, H, K, 3))]; ref: {slot: kps}."""
    d = np.concatenate([np.abs(np.asarray(kps, np.float64) - ref[slot])
                        for slot, kps in served])
    d = np.nan_to_num(d, nan=np.inf)
    return {"xy_gap_p99": float(np.quantile(d[..., :2], 0.99)),
            "z_gap_med": float(np.median(d[..., 2])),
            "xy_gap": float(d[..., :2].max()),
            "z_gap": float(d[..., 2].max())}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    out = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
