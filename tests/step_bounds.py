"""The bounds a train step of the port is held to against a reference
step from the same state (tests/torch_parity.py re-exports them). numpy
only, so the ranks of the data-parallel tests (tests/torch_dp.py, which
import no JAX) hold their steps in-process."""

from __future__ import annotations

import numpy as np

BETAS = (0.5, 0.999)  # both optimizers' Adam (train/state.py)


def adam_step_bound(count: int, betas=BETAS) -> float:
    """S(t): the largest step of Adam's t-th update in units of lr, over
    every gradient history. The update is lr m_hat / (sqrt(v_hat) + eps)
    with m_hat = sum_i a_i g_i / (1 - b1^t), a_i = (1 - b1) b1^(t-i), and
    v_hat = sum_i b_i g_i^2 / (1 - b2^t), b_i = (1 - b2) b2^(t-i). By
    Cauchy-Schwarz, |sum_i a_i g_i| <= sqrt(sum_i a_i^2 / b_i)
    sqrt(sum_i b_i g_i^2), with equality for g_i proportional to a_i / b_i,
    so S(t) = sqrt(sum_i a_i^2 / b_i) sqrt(1 - b2^t) / (1 - b1^t) (eps
    taken as 0): 1 at t = 1, then 1.054, 1.134, 1.229 for (0.5, 0.999)."""
    b1, b2 = betas
    i = np.arange(1, count + 1)
    a = (1 - b1) * b1 ** (count - i)
    b = (1 - b2) * b2 ** (count - i)
    return float(np.sqrt(np.sum(a * a / b)) * np.sqrt(1 - b2**count)
                 / (1 - b1**count))


def assert_step_matches(want: dict, got: dict, before: dict, pspec,
                        lr: float) -> None:
    """Hold the port's parameters and BatchNorm statistics after one train
    step (`got`, tensors) to JAX's (`want`, arrays), both from the same
    state (`before`); lr is the step's learning rate. The step's Adam
    update count t is the reference's own where it carries it (``counts``
    {"det": t, "disc": t}: tests/torch_parity.py:jax_state_in_port_names),
    else 1, and at least 1."""
    assert sorted(got) == sorted(want)
    counts = getattr(want, "counts", {})

    def step_bound(k: str) -> float:
        # two steps of opposite sign, each up to S(t) lr (t = 0: an
        # optimizer the step did not run, its weights left as they were)
        t = counts.get("disc" if k.startswith("discriminator.") else "det",
                       1)
        return 2 * adam_step_bound(max(t, 1)) * lr

    cancelled = {"physique." + n for n in pspec.physique.bn_cancelled_biases()}
    diffs, moved = [], 0.0
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        if "running" in k:
            # fp32 batch statistics of the same activations; a mean that
            # follows a cancelled bias moves with that bias (below)
            atol = (step_bound(k) if "physique.bns" in k and "mean" in k
                    else 1e-6)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol, err_msg=k)
            continue
        if k in cancelled:
            # zero gradient up to rounding (a train-mode BN follows), which
            # Adam turns into a step of up to S(t) lr of either sign
            np.testing.assert_allclose(g, w, rtol=0, atol=step_bound(k),
                                       err_msg=k)
            continue
        d = np.abs(g - w)
        # every weight within Adam's step bound (g / (|g| + eps) of a
        # gradient near eps = 1e-8, or small next to its history, is decided
        # by rounding) ...
        assert d.max() <= step_bound(k), k
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
