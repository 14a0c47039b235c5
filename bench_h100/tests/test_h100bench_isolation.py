"""What a run may load and where it may run: no JAX module by whole
top-level name, no result without a card, none in a tree that holds only
the benchmark."""

import json
import os
import shutil
import subprocess
import sys

from harness import bench
from tiny import HERE, ROOT

RUN = os.path.join(HERE, "run.py")
ARGS = ["--workload", "flagship.train_4x32", "--seed", "3000000000",
        "--seconds", "1", "--trace", "0"]


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    for name in ("x_as_supervision_tpu_torchx", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not {"x_as_supervision_tpu_torchx", "jaxtyping", "flaxen"} & \
        set(bench.forbidden_modules())
    monkeypatch.setitem(sys.modules, "x_as_supervision_tpu.serve", sys)
    assert "x_as_supervision_tpu" in bench.forbidden_modules()


def test_a_tiny_run_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r]\n"
        "from tiny import tiny, SEED\n"
        "from run import measure\n"
        "from harness import bench\n"
        "r = measure(tiny('hm36_surs2.train_4x32'), SEED, 0.2, False, "
        "'cpu', 0.0, None)\n"
        "r = measure(tiny('hm36_surs2.serve_b128'), SEED, 0.2, False, "
        "'cpu', 0.0, None)\n"
        "print(bench.forbidden_modules())\n"
        % os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, RUN, *ARGS], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench_h100/run.py", *ARGS],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode == 5 and out.stdout.strip() == ""
    json.load(open(tmp_path / "BENCHMARK.json"))
