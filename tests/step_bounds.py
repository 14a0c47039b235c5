"""The bounds a train step of the port is held to against a reference
step from the same state (tests/torch_parity.py re-exports them). numpy
only, so the ranks of the data-parallel tests (tests/torch_dp.py, which
import no JAX) hold their steps in-process."""

from __future__ import annotations

import numpy as np


def assert_step_matches(want: dict, got: dict, before: dict, pspec,
                        lr: float) -> None:
    """Hold the port's parameters and BatchNorm statistics after one train
    step (`got`, tensors) to JAX's (`want`, arrays), both from the same
    state (`before`); lr is the step's learning rate."""
    assert sorted(got) == sorted(want)
    cancelled = {"physique." + n for n in pspec.physique.bn_cancelled_biases()}
    diffs, moved = [], 0.0
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        if "running" in k:
            # fp32 batch statistics of the same activations; a mean that
            # follows a cancelled bias moves with that bias (below)
            atol = 2 * lr if "physique.bns" in k and "mean" in k else 1e-6
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol, err_msg=k)
            continue
        if k in cancelled:
            # zero gradient up to rounding (a train-mode BN follows), which
            # Adam turns into a step of up to about lr of either sign
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr, err_msg=k)
            continue
        d = np.abs(g - w)
        # every weight within Adam's step bound of lr (g / (|g| + eps) of a
        # gradient near eps = 1e-8 is decided by rounding) ...
        assert d.max() <= 2 * lr, k
        diffs.append(d.ravel())
        moved = max(moved, float(np.abs(w - np.asarray(before[k])).max()))
    # ... half of them within 1e-3 of a step and all but 1e-3 of them within
    # 0.1 of a step: Adam divides each gradient by the root of its running
    # square, so a weight whose gradient is small next to its history
    # carries the gradient's relative rounding into its step (measured at
    # the third fused step: median 1.5e-4, 99.9th percentile 1.9e-2 of a
    # step)
    d = np.concatenate(diffs)
    assert np.quantile(d, 0.5) <= 1e-3 * lr
    assert np.mean(d > 0.1 * lr) <= 1e-3
    assert moved > 0.5 * lr  # the step did move the weights
