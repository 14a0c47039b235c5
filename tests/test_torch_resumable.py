"""The port's crash- and hang-resilient training driver
(x_as_supervision_tpu_torch/tools/train_resumable.py, run by
scripts/torch/train_resumable.sh) with a poll of 0.2 s and short windows, on
the CPU. Each attempt is the port's train CLI on the tiny flagship config
(32^2 patches, 2 epochs of 2 steps, a checkpoint each epoch, finetuned from
XAS_INIT_CKPT) under tests/torch_resumable_child.py, which injects one
fault an attempt:

  1. crash in the middle of the second save, leaving ``00001_ckpt`` with
     only ``state.pt.tmp``;
  2. the next attempt passes over it and resumes ``00000_ckpt`` (the run's
     own: XAS_INIT_CKPT bootstraps only until the run has saved); after
     saving ``00001_ckpt`` it stops itself (SIGSTOP), with one process in
     its group and one in a session of its own: the watchdog kills all
     three;
  3. the next attempt resumes ``00001_ckpt`` and ends.

The final state is bitwise equal to an unbroken run's.
"""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

from torch_launch import cpu_env, without_matplotlib
from x_as_supervision_tpu_torch.checks import bitwise_diffs, flat
from x_as_supervision_tpu_torch.tools import train_resumable as driver
from x_as_supervision_tpu_torch.train import checkpoint as ckpt
from x_as_supervision_tpu_torch.train.factory import (
    build_gan_spec,
    flagship_config,
)
from x_as_supervision_tpu_torch.train.state import TrainState
from x_as_supervision_tpu_torch import weights
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = [sys.executable, os.path.join(HERE, "torch_resumable_child.py")]
ARGS = ["--synthetic", "--seed", "0", "--device", "cpu", "--fp32",
        "--worker", "1"]
POLL = 0.2
GRACE_S = 30


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(config path, init checkpoint, stub dir)."""
    root = tmp_path_factory.mktemp("resumable")
    cfg = flagship_config(tiny=True)
    cfg["train_params"].update(batch_size=4, num_epochs=2, checkpoint_freq=1,
                               patch_width=32, patch_height=32)
    cfg["dataset_params"]["dataset"] = {"name": "hm36"}
    path = root / "tiny_resumable.json"
    path.write_text(json.dumps(cfg))
    spec = build_gan_spec(cfg, torch.float32)
    for i, module in enumerate((spec.detector, spec.physique,
                                spec.discriminator)):
        weights.init_weights(module, 7 + i)
    init = ckpt.save_checkpoint(str(root / "init"), 0,
                                TrainState(spec, cfg["train_params"], 2))
    return str(path), init, without_matplotlib(root / "stub")


def _drive(setup, log_dir, capfd, **env) -> tuple[int, list[str]]:
    config, init, stub = setup
    rc = driver.run(config, str(log_dir), ARGS, poll=POLL, pause=0.0,
                    python=CHILD,
                    env=cpu_env(stub, XAS_INIT_CKPT=init, **env))
    lines = [line for line in capfd.readouterr().out.splitlines()
             if line.startswith("[resumable]")]
    return rc, lines


def _final(log_dir) -> dict:
    run = driver.newest_run(str(log_dir))
    return flat(ckpt.load_raw(os.path.join(run, "00001_ckpt")))


@pytest.fixture(scope="module")
def unbroken(setup, tmp_path_factory):
    log = tmp_path_factory.mktemp("unbroken")
    rc = driver.run(setup[0], str(log), ARGS, poll=POLL, pause=0.0,
                    python=CHILD, env=cpu_env(setup[2],
                                              XAS_INIT_CKPT=setup[1]))
    assert rc == 0
    return _final(log)


def test_crash_then_wedge_resume_to_the_unbroken_state(setup, unbroken,
                                                       tmp_path, capfd):
    counter = tmp_path / "attempts"
    # the watchdog looks at an attempt once it is GRACE old: the attempts'
    # start-up (a process, torch, the model, the first step) under the
    # test run's other workers took longer than the 10 s stall window
    # before its first write, so a grace of 0 killed a healthy attempt
    rc, lines = _drive(setup, tmp_path / "log", capfd,
                       XAS_TEST_FAULTS="crash,stop",
                       XAS_TEST_ATTEMPTS=str(counter),
                       XAS_STALL_SECS="10", XAS_GRACE_SECS=str(GRACE_S))
    assert rc == 0 and counter.read_text() == "3", lines
    run = driver.newest_run(str(tmp_path / "log"))
    assert os.path.basename(run).startswith("tiny_resumable_FINETUNE_seed0_")
    assert lines[0].startswith(
        f"[resumable] attempt 1: finetune from {setup[1]} (pid ")
    assert lines[1] == "[resumable] train exited rc=3; retrying from checkpoint"
    # 00001_ckpt held only state.pt.tmp: passed over; the run's own
    # checkpoint, not the init
    assert lines[2].startswith(
        f"[resumable] attempt 2: resuming from {run}/00000_ckpt (pid ")
    assert lines[3].startswith("[resumable] no TB write for ")
    assert "killing hung pid" in lines[3]
    assert lines[4].startswith("[resumable] train exited rc=-15")
    assert lines[5].startswith(
        f"[resumable] attempt 3: resuming from {run}/00001_ckpt (pid ")
    assert lines[6:] == ["[resumable] finished after 3 attempt(s)"]
    # the wedged trainer's processes, in its group and in a session of
    # their own, are gone
    pids = [int(p) for p in open(str(counter) + ".pids").read().split()]
    assert len(pids) == 2
    assert not any(driver._alive(p) for p in pids)
    final = _final(tmp_path / "log")
    assert final["/epoch"] == 2 and final["/step"] == 4
    assert not bitwise_diffs(final, unbroken)


def test_newest_checkpoint_and_attempt_args(tmp_path):
    """The attempt's flags: resume the newest run's newest complete
    checkpoint, else finetune from the init, else a fresh start."""
    log = tmp_path / "log"
    assert driver.attempt_args(str(log), None) == ("fresh start", [])
    assert driver.attempt_args(str(log), "/init") == (
        "finetune from /init", ["--finetune", "--checkpoint", "/init"])
    old, new = log / "a_seed0_1", log / "b_seed0_2"
    for run in (old, new):
        os.makedirs(run / "00000_ckpt")
        (run / "00000_ckpt" / ckpt.STATE_FILE).write_bytes(b"")
    os.makedirs(new / "00001_ckpt")
    (new / "00001_ckpt" / (ckpt.STATE_FILE + ".tmp")).write_bytes(b"")
    os.utime(old, (1, 1))
    want = str(new / "00000_ckpt")
    assert driver.attempt_args(str(log), "/init") == (
        f"resuming from {want}", ["--checkpoint", want])
    assert driver.cli_module("cfg/TikTok_Multi_S1.json").endswith(
        ".train2d3d")
    assert driver.cli_module("cfg/MPII_2D.json").endswith(".train2d3d")
    assert driver.cli_module("cfg/HM36_Multi_SurS2.json").endswith(".train")
