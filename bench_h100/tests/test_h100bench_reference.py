"""The plain reference against the program on the tiny cells on the CPU,
both in float32: the harness's own comparison reads rounding only."""

import pytest
import torch

from harness import train_cell
from reference import gan as R
from run import measure
from tiny import SEED, tiny


def test_state_dicts_name_the_same_tensors():
    from x_as_supervision_tpu_torch.train.factory import build_gan_spec

    cell = tiny("hm36_surs2.train_4x32")
    ref = R.Gan(cell.config)
    spec = build_gan_spec(train_cell.port_config(cell.config))
    for name in train_cell.MODULES:
        a = getattr(ref, name).state_dict()
        b = getattr(spec, name).state_dict()
        assert {k: v.shape for k, v in a.items()} == \
            {k: v.shape for k, v in b.items()}


# float32 on both sides: the first step reads rounding through 50 layers
# (the rm_bg images' one-pass BatchNorm variances cancel more, PERF.md);
# the later steps' change is left to the cell's own limit, since Adam's
# first steps turn rounding-level gradients into whole steps
@pytest.mark.parametrize("name,limits", [
    ("flagship.train_4x32", {"loss1_gap": 1e-3, "grad_gap_p90": 1e-3}),
    ("hm36_surs2.train_4x32", {"loss1_gap": 1e-2, "grad_gap_p90": 1e-2}),
    ("hm36_surs2.serve_b128", {"xy_gap_p99": 1e-5, "z_gap_med": 1e-5}),
])
def test_reference_follows_program_fp32(name, limits):
    torch.manual_seed(0)
    run = measure(tiny(name), SEED, 0.5, False, "cpu", 0.0, None)
    for k, lim in limits.items():
        assert run["values"][k] < lim, (k, run["values"], run["where"])
    assert run["correct"]
