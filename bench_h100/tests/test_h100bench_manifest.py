"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files, bounds, and a reader and a data file for everything it names."""

import json
import os
import re

from tiny import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["bench_h100"]
    assert M["command"] == ["python3", "bench_h100/run.py"]
    assert 1 <= M["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_configs():
    names = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("bench_h100/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"] and "assumed" in cfg
        assert {"dataset_params", "model_params", "train_params",
                "dtype"} <= set(cfg)
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])


def test_workloads_have_their_files():
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json"))
        limits = json.load(open(os.path.join(HERE, "workloads",
                                             w["name"] + ".json")))["limits"]
        assert limits and all(v > 0 for v in limits.values())


def test_metrics():
    e2e = {e["name"]: e for e in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    seen = set()
    for e in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(e["name"]) and e["name"] not in seen
        seen.add(e["name"])
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           e["name"] + ".py"))
    for e in M["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    cells = {w["name"] for w in M["workloads"]}
    for e in M["per_layer"]:
        assert set(e) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(e["layer"]) and e["moves"] in e2e
        assert set(e["workloads"]) <= cells
        moved = e2e[e["moves"]]
        assert set(e["workloads"]) <= set(moved.get("workloads", cells))
        if "roofline" in e["name"] or "mfu" in e["name"]:
            assert e["unit"] == "%"
    for c in cells:
        got = [e for e in M["end_to_end"] if c in e.get("workloads", [c])]
        assert len(got) >= 2
        assert any(c in e["workloads"] for e in M["per_layer"])
