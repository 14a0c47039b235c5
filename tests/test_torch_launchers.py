"""The port's launchers (scripts/torch/*.sh) on the CPU, as
tests/test_launcher_integration.py drives the JAX package's:

  * ``launch_train.sh local 2`` on a tiny JSON config with ``--device cpu``
    in XAS_EXTRA_ARGS: torchrun starts two ranks, which join one gloo group,
    train an epoch at the global batch in one agreed run directory, with
    TensorBoard in it, and rank 0 alone announces the save;
  * ``launch_eval.sh`` scores that checkpoint into ``eval_result.txt``;
  * ``train.sh`` and ``eval.sh`` route a TikTok or MPII config to
    ``train2d3d`` and ``eval2d`` (read from the command each prints);
  * a TPU pod target is refused with its reason;
  * the campaign driver before any S1 checkpoint;
  * every script parses, and none runs a JAX CLI or module.
"""

from __future__ import annotations

import glob
import json
import os
import re
import subprocess

import pytest

from torch_launch import cpu_env, free_port, without_matplotlib
from x_as_supervision_tpu_torch.checks import result_lines
from x_as_supervision_tpu_torch.train.factory import flagship_config
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts", "torch")
TIMEOUT = 600


def _bash(args, env, cwd, check=True):
    res = subprocess.run(["bash", *args], env=env, cwd=str(cwd),
                         capture_output=True, text=True, timeout=TIMEOUT)
    if check:
        assert res.returncode == 0, (
            f"{args} rc={res.returncode}\n{res.stdout[-3000:]}\n"
            f"{res.stderr[-3000:]}")
    return res


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    root = tmp_path_factory.mktemp("launch")
    cfg = flagship_config(tiny=True)
    cfg["train_params"].update(batch_size=16, num_epochs=1,
                               checkpoint_freq=1, patch_width=32,
                               patch_height=32)
    cfg["dataset_params"]["dataset"] = {"name": "hm36"}
    config = root / "Tiny_Launch.json"
    config.write_text(json.dumps(cfg))
    log = root / "log"
    env = cpu_env(without_matplotlib(root / "stub"),
                  XAS_COORD_PORT=str(free_port()),
                  XAS_EXTRA_ARGS=f"--synthetic --seed 0 --device cpu --fp32 "
                                 f"--worker 1 --log_dir {log}")
    res = _bash([os.path.join(SCRIPTS, "launch_train.sh"), "local", "2",
                 str(config)], env, root)
    return root, config, log, res.stdout + res.stderr


def test_local_two_ranks_train_one_run(launched):
    root, _, log, out = launched
    runs = glob.glob(str(log / "*"))
    assert len(runs) == 1, runs
    run = runs[0]
    assert os.path.basename(run).startswith("Tiny_Launch_seed0_")
    assert sorted(os.listdir(run)) == ["00000_ckpt", "Tiny_Launch.json",
                                       "tensorboard"]
    assert os.path.isfile(os.path.join(run, "00000_ckpt", "state.pt"))
    assert glob.glob(os.path.join(run, "tensorboard", "events*"))
    # both ranks ran train.sh; rank 0 alone prints step lines and the save
    assert out.count("Running command: python -m "
                     "x_as_supervision_tpu_torch.train ") == 2
    assert out.count("checkpoint saved:") == 1
    assert len(re.findall(r"^step \d+ ", out, re.M)) == 4  # 64 / 16
    # the launcher's own log of the run
    logs = glob.glob(str(root / "launch_output" / "log.out.*"))
    assert len(logs) == 1 and "checkpoint saved:" in open(logs[0]).read()


def test_launch_eval_scores_the_checkpoint(launched, tmp_path):
    root, config, log, _ = launched
    ckpt = glob.glob(str(log / "*" / "00000_ckpt"))[0]
    env = cpu_env(without_matplotlib(root / "stub"),
                  XAS_EXTRA_ARGS="--synthetic --device cpu")
    res = _bash([os.path.join(SCRIPTS, "launch_eval.sh"), "local", "1",
                 str(config), ckpt, "best"], env, tmp_path)
    assert "Running command: python -m x_as_supervision_tpu_torch.eval " \
        in res.stdout
    result = os.path.join(os.path.dirname(ckpt), "eval", "eval_result.txt")
    lines = result_lines(result)
    assert lines and all(v is None or v == v for _, v in lines)


@pytest.mark.parametrize("script,config,module,args", [
    ("train.sh", "TikTok_Multi_S1.json", "train2d3d", " --extra_tag tag"),
    ("train.sh", "HM36_Multi_SurS2.json", "train", " --extra_tag tag"),
    ("eval.sh", "MPII_2D.json", "eval2d",
     " --checkpoint ckpt --multi_hypo best"),
    ("eval.sh", "HM36_Multi_SurS2.json", "eval",
     " --checkpoint ckpt --multi_hypo best"),
    # as scripts/finetune.sh: the train CLI whatever the config
    ("finetune.sh", "HM36_Multi_SurS2.json", "train",
     " --checkpoint ckpt --finetune --extra_tag tag"),
])
def test_routing_by_config_name(script, config, module, args, tmp_path):
    """The command each script runs: a `python` first on PATH that prints
    its arguments stands in for the interpreter."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "python").write_text('#!/bin/sh\necho "argv: $*"\n')
    (bin_dir / "python").chmod(0o755)
    env = cpu_env(str(tmp_path), PATH=f"{bin_dir}:{os.environ['PATH']}",
                  XAS_EXTRA_ARGS="--seed 0")
    argv = ["1", config] + {"train.sh": ["tag"], "eval.sh": ["ckpt"],
                            "finetune.sh": ["ckpt", "tag"]}[script]
    res = _bash([os.path.join(SCRIPTS, script), *argv], env, tmp_path)
    want = f"-m x_as_supervision_tpu_torch.{module} --config {config}"
    assert f"Running command: python {want}" in res.stdout
    assert f"argv: {want}{args} --seed 0" in res.stdout


def test_tpu_pod_target_is_refused(tmp_path):
    res = _bash([os.path.join(SCRIPTS, "launch_train.sh"), "my-pod", "4",
                 "cfg.json"], cpu_env(str(tmp_path)), tmp_path, check=False)
    assert res.returncode == 2
    assert "no counterpart" in res.stderr


@pytest.mark.parametrize("stage,rc,said", [
    ("s2", 1, "no S1 checkpoint under"),
    ("eval", 0, "stage S2: no checkpoint yet, skipping eval"),
])
def test_campaign_driver_without_checkpoints(stage, rc, said, tmp_path):
    """run_campaign_xl.sh before any S1 run: a finetune stage refuses to
    start (it would train from scratch), the eval stage skips."""
    env = cpu_env(str(tmp_path), XAS_CAMPAIGN_LOG_ROOT=str(tmp_path / "log"),
                  XAS_CAMPAIGN_OUT=str(tmp_path / "out"))
    res = _bash([os.path.join(SCRIPTS, "run_campaign_xl.sh"), stage], env,
                tmp_path, check=False)
    assert res.returncode == rc
    assert said in res.stdout + res.stderr
    assert "S1 ckpt: <none>" in res.stdout


def test_scripts_parse_and_run_no_jax():
    scripts = sorted(glob.glob(os.path.join(SCRIPTS, "*.sh")))
    assert [os.path.basename(s) for s in scripts] == sorted(
        f"{n}.sh" for n in ("train", "eval", "finetune", "launch_train",
                            "launch_eval", "launch_finetune",
                            "train_resumable", "render_campaign_xl",
                            "run_campaign", "run_campaign_xl", "xl_chain"))
    jax_cli = re.compile(r"python3? (train|eval|train2d3d|eval2d)\.py|"
                         r"x_as_supervision_tpu\.|scripts/[a-z_]+\.sh|"
                         r"config/[A-Za-z_0-9]+\.yaml")
    for s in scripts:
        subprocess.run(["bash", "-n", s], check=True)
        text = "\n".join(line for line in open(s)
                         if not line.lstrip().startswith("#"))
        assert not jax_cli.search(text), (s, jax_cli.search(text).group())
