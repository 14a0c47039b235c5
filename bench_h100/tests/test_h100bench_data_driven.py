"""A later change adds a cell and a metric by adding files and manifest
entries only: in a copy of the benchmark, a new traffic mix, its cell, its
limits and a new metric are picked up by the unedited harness."""

import json
import os
import shutil
import subprocess
import sys

from tiny import HERE, ROOT


def test_new_cell_and_metric_from_files_alone(tmp_path):
    bench = tmp_path / "bench_h100"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    m = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    t = json.load(open(bench / "traffic" / "train_4x32.json"))
    t["pool_batches"] = 3
    json.dump(t, open(bench / "traffic" / "train_dummy.json", "w"))
    shutil.copy(bench / "workloads" / "flagship.train_4x32.json",
                bench / "workloads" / "flagship.train_dummy.json")
    (bench / "metrics" / "dummy_steps.py").write_text(
        "def read(run):\n    return run['attempted']\n")
    m["workloads"].append({"name": "flagship.train_dummy",
                           "config": "flagship", "traffic": "train_dummy",
                           "chips": 1, "why": "a test"})
    m["end_to_end"].append({"name": "dummy_steps", "unit": "steps",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["flagship.train_dummy"]})
    json.dump(m, open(tmp_path / "BENCHMARK.json", "w"))
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "from tiny import tiny, SEED\n"
        "from run import measure\n"
        "cell = tiny('flagship.train_dummy', root=%r, here=%r)\n"
        "r = measure(cell, SEED, 0.2, False, 'cpu', 0.0, None)\n"
        "print(sorted(r['metrics']), r['correct'])\n"
        % (str(bench / "tests"), str(bench), ROOT, str(tmp_path),
           str(bench)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    # train_img_per_s lists its cells: the new one reports only its own
    assert last == "['dummy_steps', 'setup_s'] True"
