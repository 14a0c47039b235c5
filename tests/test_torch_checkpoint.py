"""Checkpoints of the port (x_as_supervision_tpu_torch/train/checkpoint.py)
and the train -> checkpoint -> eval loop of its CLIs, on the CPU, on the tiny
flagship config in fp32.

A resumed run must take the same steps as one that was not interrupted, so
the resume test compares bitwise: any state the checkpoint forgot (an Adam
step count, a BatchNorm running statistic, the carried discriminator
gradient) would put the resumed run on another trajectory.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from x_as_supervision_tpu_torch.checks import bitwise_diffs, flat
from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu_torch.models.detector import build_detector
from x_as_supervision_tpu_torch.train import checkpoint as ckpt
from x_as_supervision_tpu_torch.train.factory import flagship_config
from x_as_supervision_tpu_torch.train.trainer import (
    Trainer,
    auto_checkpoint,
    create_run_dir,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 2
STEPS_PER_EPOCH = 2
# intra-op threads of this module's torch work (in process and in the CLI
# subprocess): the tests run beside other workers on a few cores, where
# torch's default of one thread per core oversubscribes them
THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(saved)


def _config(num_epochs: int, disc_dims: int = 16) -> dict:
    cfg = flagship_config(tiny=True)
    cfg["train_params"].update(batch_size=BATCH, num_epochs=num_epochs,
                               checkpoint_freq=1)
    cfg["model_params"]["smpl_disc_params"].update(
        input_dim=disc_dims, hidden_dim=disc_dims, output_dim=disc_dims)
    return cfg


def _trainer(num_epochs, save_dir=None, checkpoint_path=None, mode="train",
             disc_dims=16):
    ds = SyntheticPoseDataset(num_samples=BATCH * STEPS_PER_EPOCH,
                              cam_id_list=(0, 1), patch_size=64)
    return Trainer(_config(num_epochs, disc_dims), ds, seed=0,
                   dtype=torch.float32, device="cpu", save_dir=save_dir,
                   checkpoint_path=checkpoint_path, mode=mode)


def _flat(state) -> dict:
    """Every tensor and count of a train state, by name."""
    return flat(ckpt.state_dict(state))


@pytest.fixture(scope="module")
def first_epoch(tmp_path_factory):
    """One epoch (2 steps) with a checkpoint after it."""
    save_dir = str(tmp_path_factory.mktemp("run"))
    trainer = _trainer(1, save_dir)
    history = trainer.train(log=lambda _: None)
    assert len(history) == STEPS_PER_EPOCH
    return trainer, save_dir, os.path.join(save_dir, "00000_ckpt")


def test_round_trip_is_bitwise(first_epoch):
    trainer, _, path = first_epoch
    assert sorted(os.listdir(path)) == [ckpt.STATE_FILE]
    raw = torch.load(os.path.join(path, ckpt.STATE_FILE), weights_only=True)
    assert raw["epoch"] == 1 and raw["step"] == STEPS_PER_EPOCH
    assert raw["det_updates"] == raw["disc_updates"] == STEPS_PER_EPOCH
    restored = _trainer(1, checkpoint_path=path)
    assert restored.epochs_run == 1
    want = _flat(trainer.state)
    assert not bitwise_diffs(_flat(restored.state), want)
    # what a resume must carry: Adam moments and counts, the running
    # statistics, the carried discriminator gradient
    assert any("running_var" in k for k in want)
    assert any(k.startswith("/opt_det/state/") and k.endswith("/step")
               for k in want)
    assert any(k.startswith("/pending_disc_grads/")
               and want[k].abs().max() > 0 for k in want)


def test_resumed_run_equals_an_uninterrupted_one(first_epoch, tmp_path):
    """2 steps, checkpoint, restore into a fresh trainer, 2 more steps,
    against 4 straight steps: bitwise, losses and state."""
    _, _, path = first_epoch
    resumed = _trainer(2, str(tmp_path / "resumed"), checkpoint_path=path)
    got = resumed.train(log=lambda _: None)
    straight = _trainer(2, str(tmp_path / "straight"))
    want = straight.train(log=lambda _: None)
    assert len(got) == STEPS_PER_EPOCH and len(want) == 2 * STEPS_PER_EPOCH
    assert got == want[STEPS_PER_EPOCH:]
    assert not bitwise_diffs(_flat(resumed.state), _flat(straight.state))
    assert sorted(os.listdir(tmp_path / "resumed")) == ["00001_ckpt"]
    assert sorted(os.listdir(tmp_path / "straight")) == ["00000_ckpt",
                                                         "00001_ckpt"]


def test_finetune_takes_weights_only(first_epoch, capsys):
    trainer, _, path = first_epoch
    tuned = _trainer(1, checkpoint_path=path, mode="finetune")
    assert tuned.epochs_run == 0
    st = tuned.state
    assert (st.step, st.epoch, st.det_updates, st.disc_updates) == (0, 0,
                                                                     0, 0)
    assert not st.opt_det.state and not st.opt_disc.state
    assert all(not g.any() for g in st.pending_disc_grads)
    for name in ("detector", "physique", "discriminator"):
        want = getattr(trainer.spec, name).state_dict()
        got = getattr(tuned.spec, name).state_dict()
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    assert "Load new discriminator" not in capsys.readouterr().out


def test_finetune_keeps_a_fresh_discriminator_of_another_width(first_epoch,
                                                               capsys):
    trainer, _, path = first_epoch
    tuned = _trainer(1, checkpoint_path=path, mode="finetune", disc_dims=8)
    assert "Load new discriminator for ablation" in capsys.readouterr().out
    fresh = _trainer(1, disc_dims=8)
    for k, v in fresh.spec.discriminator.state_dict().items():
        assert torch.equal(tuned.spec.discriminator.state_dict()[k], v), k
    for k, v in trainer.spec.detector.state_dict().items():
        assert torch.equal(tuned.spec.detector.state_dict()[k], v), k


def test_restore_detector_for_eval(first_epoch):
    trainer, _, path = first_epoch
    sd = ckpt.restore_detector(path)
    det = build_detector(_config(1)["model_params"]["detector_params"])
    det.load_state_dict(sd)  # strict: every key, the running statistics too
    for k, v in trainer.spec.detector.state_dict().items():
        assert torch.equal(det.state_dict()[k], v), k
        assert sd[k].device.type == "cpu"


def test_bitwise_diffs_finds_every_kind_of_difference():
    """checks.flat / bitwise_diffs, which the round-trip and resume tests
    rest on: one bit, a dtype, a shape, a count and a missing or extra leaf
    each count; an equal copy has none."""
    w = torch.linspace(0, 1, 5)
    want = flat({"a": {"w": w, "n": 3}, "l": [torch.zeros(2, 2)]})
    assert sorted(want) == ["/a/n", "/a/w", "/l/0"]
    assert not bitwise_diffs({k: (v.clone() if torch.is_tensor(v) else v)
                              for k, v in want.items()}, want)
    bit = w.clone()
    bit[2] = torch.nextafter(bit[2], torch.tensor(2.0))
    cases = {"/a/w": [bit, w.double(), w[:4]], "/a/n": [4],
             "/l/0": [torch.zeros(4)]}
    for key, values in cases.items():
        for v in values:
            assert bitwise_diffs({**want, key: v}, want) == [key]
    assert bitwise_diffs({k: v for k, v in want.items() if k != "/a/n"},
                         want) == ["/a/n"]
    assert bitwise_diffs({**want, "/b": 1}, want) == ["/b"]


def test_latest_and_auto_pick_the_newest(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text("{}")
    log = tmp_path / "log"
    for run, epochs in (("cfg_seed0_01_01_26_00.00.00", (0, 1)),
                        ("cfg_seed0_02_01_26_00.00.00", (0, 2, 10))):
        for e in epochs:
            os.makedirs(log / run / f"{e:05d}_ckpt")
            (log / run / f"{e:05d}_ckpt" / ckpt.STATE_FILE).write_bytes(b"")
    newest = log / "cfg_seed0_02_01_26_00.00.00"
    os.makedirs(newest / "00003_other")
    # a save cut short: the directory is there, the file is not yet
    os.makedirs(newest / "00011_ckpt")
    (newest / "00011_ckpt" / (ckpt.STATE_FILE + ".tmp")).write_bytes(b"")
    assert ckpt.latest_checkpoint(str(newest)) == str(newest / "00010_ckpt")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    assert auto_checkpoint(str(log), str(cfg)) == str(newest / "00010_ckpt")
    assert auto_checkpoint(str(tmp_path / "empty"), str(cfg)) is None
    # resuming reuses the checkpoint's run directory; a finetune makes one
    path = str(newest / "00010_ckpt")
    assert create_run_dir(str(log), str(cfg), 0, checkpoint_path=path) == \
        str(newest)
    tuned = create_run_dir(str(log), str(cfg), 0, "tag_", finetune=True,
                           checkpoint_path=path)
    assert os.path.basename(tuned).startswith("cfg_FINETUNE_seed0_tag_")
    assert os.path.isfile(os.path.join(tuned, "cfg.json"))


def _run(args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS))
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_then_eval_cli_end_to_end(tmp_path, capsys):
    """The train CLI (python -m) writes 00000_ckpt, --checkpoint auto finds
    it, and the eval CLI (bf16, as eval.py) writes eval_result.txt with
    every line; the last two through their main(argv)."""
    from x_as_supervision_tpu_torch.eval.__main__ import main as eval_main
    from x_as_supervision_tpu_torch.train.__main__ import main as train_main

    cfg = _config(1)
    cfg["dataset_params"]["dataset"] = {"name": "hm36"}
    cfg["train_params"]["batch_size"] = 16  # 64 samples: 4 steps, 4 batches
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    log = tmp_path / "log"
    train = ["x_as_supervision_tpu_torch.train", "--config", str(path),
             "--synthetic", "--seed", "0", "--device", "cpu", "--fp32",
             "--log_dir", str(log)]
    res = _run(train, REPO)
    assert res.returncode == 0, res.stderr
    (run,) = os.listdir(log)
    assert run.startswith("tiny_seed0_")
    assert sorted(os.listdir(log / run)) == ["00000_ckpt", "tensorboard",
                                             "tiny.json"]
    assert sum(ln.startswith("step ") for ln in res.stdout.splitlines()) == 4

    capsys.readouterr()
    resumed = train_main(train[1:] + ["--checkpoint", "auto"])
    out = capsys.readouterr().out
    assert f"auto-resume from {log / run / '00000_ckpt'}" in out
    assert "Resuming training from epoch 1" in out
    assert not any(ln.startswith("step ") for ln in out.splitlines())
    assert resumed.state.epoch == 1 and resumed.state.step == 4

    ev = eval_main(["--config", str(path), "--checkpoint",
                    str(log / run / "00000_ckpt"), "--synthetic",
                    "--multi_hypo", "best", "--device", "cpu"])
    assert "Ambiguity Ratio:" in capsys.readouterr().out
    assert ev.result_path == str(log / run / "eval" / "eval_result.txt")
    lines = (log / run / "eval" / "eval_result.txt").read_text().splitlines()
    keys = ["2D MSE", "MPJPE", "N-MPJPE", "P-MPJPE", "TRI MPJPE",
            "TRI N-MPJPE", "TRI P-MPJPE"]
    assert [ln.split(":")[0] for ln in lines] == (
        keys + ["--------select---------"] + keys)
    for ln in lines:
        if ":" in ln:
            assert np.isfinite(float(ln.split(":")[1].rstrip(" %"))), ln


def test_eval_cli_needs_synthetic_and_a_checkpoint(first_epoch, tmp_path):
    """Without --synthetic the eval CLI reads the config's dataset from
    disk (here a dataset directory with no index files), and it needs a
    checkpoint."""
    _, _, ckpt_dir = first_epoch
    cfg = _config(1)
    cfg["dataset_params"].update(
        dataset={"name": "hm36", "path": str(tmp_path / "hm36"),
                 "train_image_set": "mini", "test_image_set": "mini"},
        dataiter={"mean": [0.0] * 3, "std": [255.0] * 3})
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    res = _run(["x_as_supervision_tpu_torch.eval", "--config", str(path),
                "--checkpoint", ckpt_dir, "--device", "cpu"], REPO)
    assert res.returncode != 0
    assert "FileNotFoundError" in res.stderr
    assert os.path.join("s_09_act_02_subact_01_ca_01",
                        "matlab_meta.txt") in res.stderr
    from x_as_supervision_tpu_torch.eval.__main__ import main as eval_main

    with pytest.raises(SystemExit, match="Must specify checkpoint path"):
        eval_main(["--config", str(path), "--synthetic", "--device", "cpu"])


def test_eval_cli_takes_log_dir_and_extra_tag(first_epoch, tmp_path):
    """eval.py's --log_dir and --extra_tag are accepted and unused: the
    result goes beside the checkpoint, as eval.py writes it."""
    from x_as_supervision_tpu_torch.eval.__main__ import main as eval_main

    _, save_dir, ckpt_dir = first_epoch
    cfg = _config(1)
    cfg["dataset_params"]["dataset"] = {"name": "hm36"}
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    log = tmp_path / "elsewhere"
    ev = eval_main(["--config", str(path), "--checkpoint", ckpt_dir,
                    "--synthetic", "--device", "cpu", "--batch_size", "16",
                    "--log_dir", str(log), "--extra_tag", "x"])
    assert ev.result_path == os.path.join(save_dir, "eval",
                                          "eval_result.txt")
    assert os.path.getsize(ev.result_path) > 0
    assert not log.exists()


def test_trainer_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_config(1), SyntheticPoseDataset(num_samples=4,
                                                 cam_id_list=(0, 1),
                                                 patch_size=64))


def test_port_and_chip_smoke_import_no_jax():
    """The sources themselves: no import of jax, flax or the JAX package in
    the port or in chip_smoke.py (the import test in test_torch_serve.py
    checks the modules that load)."""
    bad = []
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "x_as_supervision_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for f in files:
        for i, line in enumerate(open(f), 1):
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1 and \
                    words[1].split(".")[0] in ("jax", "jaxlib", "flax",
                                               "x_as_supervision_tpu"):
                bad.append(f"{f}:{i}: {line.strip()}")
    assert len(files) > 30
    for module in ("convert.py", os.path.join("tools", "train_resumable.py")):
        assert os.path.join(REPO, "x_as_supervision_tpu_torch",
                            module) in files
    assert not bad, bad
