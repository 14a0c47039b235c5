"""The FLOP and byte arithmetic of harness/work.py against hand counts at
tiny shapes, and its convolutions against PyTorch's FLOP counter on the
reference's forward."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import work as W
from reference import gan as R
from tiny import SEED, tiny

PEAKS = {"bf16": 1e12, "fp32": 1e11, "hbm": 1e9}


def test_conv_counts():
    c = W.Conv(2, 3, 3, 1, 4, 4)
    assert c.out_hw() == (4, 4)
    assert c.flops() == 2 * 16 * 2 * 3 * 9
    s = W.Conv(2, 3, 3, 2, 5, 5)
    assert s.out_hw() == (3, 3) and s.flops() == 2 * 9 * 2 * 3 * 9
    t = W.Conv(4, 2, 4, 2, 3, 3, transposed=True)
    assert t.out_hw() == (6, 6) and t.flops() == 2 * 9 * 4 * 2 * 16


def test_link_call_bytes_and_flops():
    c = W.Conv(64, 64, 3, 1, 2, 2)
    flops = 5 * 2 * 4 * 64 * 64 * 9
    nbytes = 5 * 64 * 4 * 2 * 2 + 9 * 64 * 64 * 2 + 4 * 4 * 64
    assert W.link_call(c, 5, "bf16", PEAKS) == pytest.approx(
        max(flops / 1e12, nbytes / 1e9))
    thin = W.Conv(1, 32, 3, 1, 8, 8)
    nbytes = 7 * 64 * 2 + 9 * 32 * 2 + 4 * 32 + 7 * 32 * 64 * 2
    assert W.conv3x3_call(thin, 7, "bf16", PEAKS) == pytest.approx(
        max(7 * thin.flops() / 1e12, nbytes / 1e9))


def test_resnet50_link_and_physique_calls():
    convs, link = W.resnet_convs(50, 256)
    assert len(convs) == 1 + 16 * 3 + 4
    assert [(c.cin, c.h) for c in link] == [(256, 16)] * 5 + [(512, 8)] * 2
    calls = W.conv3x3_train_calls([32, 64, 128], 256)
    assert len(calls) == 18
    assert sum(1 for c in calls if 1 in (c.cin, c.cout)) == 4
    assert W.link_forwards_per_step(False) == 2
    assert W.link_forwards_per_step(True) == 4


def test_discriminator_flops_by_hand():
    p = {"num_node": 2, "disc_sup_dim": 1, "input_dim": 3, "hidden_dim": 3,
         "output_dim": 3, "num_layers": 1}
    stream = 2 * 2 * 2 * 3 + 3 * (2 * 2 * 3 * 3 * 2 + 2 * 2 * 2 * 3)
    assert W.discriminator_flops(p) == 2 * stream + 2 * 12 * 512 + 2 * 512


@pytest.mark.parametrize("name", ["flagship.train_4x32",
                                  "hm36_surs2.serve_b128"])
def test_detector_flops_match_flop_counter(name):
    cell = tiny(name)
    gan = R.Gan(cell.config).eval()
    side = cell.config["train_params"]["patch_width"]
    convs, _ = W.detector_convs(cell.config["model_params"]
                                ["detector_params"], side)
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            gan.detector(torch.zeros(2, 3, side, side))
    conv = sum(v for k, v in fc.get_flop_counts()["Global"].items()
               if "conv" in str(k))
    assert conv == 2 * sum(c.flops() for c in convs)


def test_train_step_work_counts_remat_links_twice():
    a = tiny("flagship.train_4x32")
    b = tiny("hm36_surs2.train_4x32")
    wa = W.train_step_work(a.config, 2, "bf16", PEAKS)
    wb = W.train_step_work(b.config, 2, "bf16", PEAKS)
    assert wb["link_least_s"] == pytest.approx(2 * wa["link_least_s"])
    assert wa["model_flops"] == pytest.approx(wb["model_flops"])
    assert SEED > 2 ** 31
