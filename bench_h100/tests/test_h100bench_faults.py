"""The harness with its chip lookup skipped and the timed path broken
underneath: each fault the cell can have comes out not correct, and the
control (the reference with float8 GEMM operands in the program's place)
fails one of the cell's numbers. Tiny cells on the CPU, program in
float32, so that the sound run reads rounding alone."""

import numpy as np
import pytest
import torch

from harness import checks, train_cell
from run import measure
from tiny import SEED, tiny


def unchanged_state(state, batch, generator=None, **kw):
    """A step whose parameters come back as they went in."""
    params = state.gen_params + state.disc_params
    keep = [p.detach().clone() for p in params]
    out = train_cell_step()(state, batch, generator, **kw)
    with torch.no_grad():
        for p, k in zip(params, keep):
            p.copy_(k)
    return out


def half_batch(state, batch, generator=None, **kw):
    """The step on each camera's first half of the rows, the mean taken
    over them."""
    half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
    return train_cell_step()(state, half, generator, **kw)


def train_cell_step():
    from x_as_supervision_tpu_torch.train.state import train_step

    return train_step


def altered_answer(est, crops):
    """The answer with the left and right hips swapped where it is made."""
    out = est(crops)
    out.kps_patch[..., [1, 4], :] = out.kps_patch[..., [4, 1], :].copy()
    return out


def test_sound_runs_are_correct():
    for name in ("flagship.train_4x32", "hm36_surs2.serve_b128"):
        assert measure(tiny(name), SEED, 0.2, False, "cpu", 0.0,
                       None)["correct"]


@pytest.mark.parametrize("name", ["flagship.train_4x32",
                                  "hm36_surs2.train_4x32"])
@pytest.mark.parametrize("fault", [unchanged_state, half_batch])
def test_train_faults_are_not_correct(name, fault):
    run = measure(tiny(name), SEED, 0.2, False, "cpu", 0.0, None,
                  step_fn=fault)
    assert not run["correct"], run["checks"]


def test_altered_answer_is_not_correct():
    run = measure(tiny("hm36_surs2.serve_b128"), SEED, 0.2, False, "cpu",
                  0.0, None, call_fn=altered_answer)
    assert not run["correct"], run["checks"]


@pytest.mark.parametrize("name", ["flagship.train_4x32",
                                  "hm36_surs2.train_4x32"])
def test_train_control_fails(name):
    cell = tiny(name)
    out = train_cell.program(cell, SEED, 0.0, False, "cpu", 0.0)
    ref = train_cell.reference(cell, SEED, out["pool"], "cpu")
    got = train_cell.reference(cell, SEED, out["pool"], "cpu",
                               operands="fp8")
    ok, table = checks.judge(checks.train_numbers(got, ref)[0], cell.limits)
    assert not ok, table


def test_serve_control_fails():
    from harness import serve_cell

    cell = tiny("hm36_surs2.serve_b128")
    out = serve_cell.program(cell, SEED, 0.2, False, "cpu", 0.0)
    slots = sorted({s for s, _ in out["served"]})
    ref = serve_cell.reference(cell, out["pool"], out["state"], slots, "cpu")
    got = serve_cell.reference(cell, out["pool"], out["state"], slots, "cpu",
                               operands="fp8")
    ok, table = checks.judge(checks.serve_numbers(
        [(s, got[s]) for s in slots], ref), cell.limits)
    assert not ok, table
    assert np.isfinite(table["xy_gap_p99"]["value"])
