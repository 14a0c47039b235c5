"""On the card, at each cell's own size: a sound run of the program is
correct, and the control (the reference with float8 GEMM operands in the
program's place) and the cell's planted faults are not. Marked ``cuda``;
skips without a card (``python -m pytest -m cuda bench_h100/tests``)."""

import pytest
import torch

import control
from harness import bench, checks
from tiny import SEED


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship.train_4x32",
                                  "hm36_surs2.train_4x32",
                                  "hm36_surs2.serve_b128"])
def test_control_and_faults_fail_at_full_size(card, name):
    cell = bench.load_cell(name)
    read = (control.train_readings if cell.kind == "train"
            else control.serve_readings)
    rows, _ = read(cell, SEED, card, True)
    ok = {what: checks.judge(values, cell.limits) for what, values, _ in rows}
    assert ok["program"][0], ok["program"][1]
    for what, (good, table) in ok.items():
        if what != "program":
            assert not good, (what, table)
