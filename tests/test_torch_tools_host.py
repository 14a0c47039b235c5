"""The port's host-side measurement tools on the CPU:
x_as_supervision_tpu_torch/tools/bench_loader.py on an on-disk H36M
fixture, trace_opclass.py on a synthetic Chrome trace and on a real CPU
trace of train/profiling.py, and scaling_projection.py on two gloo ranks
(tests/torch_dp.py) against the JAX tool's analytic sizes.
"""

import json
import os
import shutil

import jax.numpy as jnp
import pytest
import torch

from torch_dp import spawn
from x_as_supervision_tpu_torch import checks
from x_as_supervision_tpu_torch.tools import (
    bench_loader,
    scaling_projection,
    trace_opclass,
)
from x_as_supervision_tpu_torch.train.factory import flagship_config
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

# ---------------------------------------------------------------- loader


@pytest.fixture(scope="module")
def loader_config(tmp_path_factory):
    """The tiny flagship config on a miniature H36M (4 frames of 160^2, 2
    cameras) and its pseudo stream; the dataset holds 8 samples at batch
    4 (2 batches) and 32 at the config's batch 32 (1 batch)."""
    root = str(tmp_path_factory.mktemp("loader"))
    checks.write_mini_h36m(root, img_size=160, n_frames=4)
    checks.write_surreal_pseudo(os.path.join(root, "surreal_h36m_pose"), 8,
                                size=64)
    cfg = flagship_config(tiny=True)
    cfg["dataset_params"] = dict(checks.hm36_dataset_params(root),
                                 cam_id_list=[0, 1])
    cfg["train_params"].update(aug=dict(checks.NO_AUG))
    path = os.path.join(root, "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def test_loader_rows(loader_config):
    """One row per knob setting in the JAX tool's order, positive rates,
    one timed batch (2 in the epoch: one warm-up), the headroom over the
    given demand, and the summary."""
    rows = bench_loader.main(["--config", loader_config, "--batch-size", "4",
                              "--batches", "3", "--worker", "2", "--device",
                              "cpu", "--device-demand", "50"])
    knobs, summary = rows[:-1], rows[-1]
    assert [r["knob"] for r in knobs] == [k for k, _ in bench_loader.KNOBS]
    for r in knobs:
        assert r["batches"] == 1 and r["device"] == "cpu"
        assert r["samples_s"] > 0
        assert r["device_imgs_s"] == pytest.approx(2 * r["samples_s"])
        assert r["feed_headroom_vs_device"] == pytest.approx(
            r["device_imgs_s"] / 50)
    assert summary["shipped_feed_imgs_s"] == knobs[0]["device_imgs_s"]
    assert summary["feed_bound"] == (knobs[0]["device_imgs_s"] < 50)


def test_loader_without_demand_gives_no_headroom(loader_config):
    rows = bench_loader.main(["--config", loader_config, "--batch-size", "4",
                              "--batches", "1", "--worker", "1", "--device",
                              "cpu"])
    assert all("feed_headroom_vs_device" not in r for r in rows)
    assert "feed_bound" not in rows[-1]


def test_loader_geo_knob_computes_the_maps(loader_config):
    """The uint8+geo setting computes the geodesic maps (the shipped
    configs' losses read none, so the knob sets compute_geodesic itself);
    the other two do not."""
    import copy

    from x_as_supervision_tpu_torch.config import load_config
    from x_as_supervision_tpu_torch.data.factory import basic_data

    base = load_config(loader_config)
    for name, over in bench_loader.KNOBS:
        cfg = copy.deepcopy(base)
        cfg["dataset_params"].update(over)
        sample = basic_data(cfg).sample(0)
        assert ("cam_0_geodesic_dis" in sample) == (name == "uint8+geo")
        assert (sample["cam_0_img"].dtype.name == "uint8") == (
            name.startswith("uint8"))


@pytest.mark.parametrize("args,what", [
    (["--batch-size", "32"], "needs at least two"),
    (["--batches", "0"], "at least 1"),
])
def test_loader_refuses_too_few_batches(loader_config, args, what):
    """A loader of a single batch (4 frames padded to one batch of 32), or
    --batches 0, raises a clear ValueError (the JAX tool left `batch`
    unbound and divided by a near-zero time)."""
    with pytest.raises(ValueError, match=what):
        bench_loader.main(["--config", loader_config, "--worker", "1",
                           "--device", "cpu", *args])


# ---------------------------------------------------------------- traces

# (name, category, dur us): every class, each event twice (two steps);
# distinct durations, multiples of 125 us, so every ms sum is exact in
# binary
EVENTS = [
    ("void (anonymous namespace)::marginals_kernel<float, 1, 4, 2>(...)",
     "kernel", 1000.0),
    ("void marginals_bwd_kernel<__nv_bfloat16>(...)", "kernel", 2000.0),
    ("void (anonymous namespace)::link_wgmma_kernel<2, 256>(...)", "kernel",
     4000.0),
    ("(anonymous namespace)::stats_kernel(float const*, int, int, float*)",
     "kernel", 250.0),
    ("void conv3x3_tc_kernel<32, 1>(...)", "kernel", 500.0),
    ("void conv3x3_thin_kernel<__nv_bfloat16, 1, false>(...)", "kernel",
     125.0),
    ("void conv3x3_fma_kernel<float, 64, 2>(...)", "kernel", 1125.0),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "kernel", 8000.0),
    ("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NNT", "kernel", 375.0),
    ("void cudnn::bn_fw_tr_1C11_singleread_spec<__nv_bfloat16>(...)",
     "kernel", 625.0),
    ("void at::native::batch_norm_collect_statistics_kernel<float>(...)",
     "kernel", 750.0),
    ("void at::native::vectorized_elementwise_kernel<4, ...>(...)", "kernel",
     1500.0),
    ("void at::native::reduce_kernel<512, 1, ...>(...)", "kernel", 3000.0),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)",
     "kernel", 16000.0),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 6000.0),
    ("Memset (Device)", "gpu_memset", 875.0),
    ("void at::native::upsample_bilinear2d_out_frame<float>(...)", "kernel",
     12000.0),
]
WANT = {  # class: (us per step, launches per step)
    "integral_marginals": (1000.0, 1), "integral_marginals_bwd": (2000.0, 1),
    "conv_bn_link": (4250.0, 1), "conv3x3": (1750.0, 3),
    "conv_gemm": (8375.0, 2), "batchnorm": (1375.0, 2),
    "elementwise_reduce": (4500.0, 2), "nccl": (16000.0, 1),
    "memcpy_memset": (6875.0, 2), "other": (12000.0, 1),
}


def _write_trace(path, events, scale=1.0):
    trace = {"deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3"}],
             "traceEvents": [
                 {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
                  "args": {"name": "host"}},
                 # a host op: not counted
                 {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d",
                  "pid": 0, "tid": 7, "ts": 0, "dur": 999.0}]}
    ts = 1.0
    for _ in range(2):  # two steps
        for name, cat, dur in events:
            trace["traceEvents"].append(
                {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 7,
                 "ts": ts, "dur": dur * scale})
            ts += 1000.0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)


def test_trace_classes_exact(tmp_path):
    """Each event falls in its class; the sums per class over two steps,
    divided by --steps 2, come out exact (ms per step), the launches per
    step count the port kernels' main symbols once a call (the link's
    stats_kernel adds time only), and host ops are not counted."""
    _write_trace(str(tmp_path / "run" / "profile" / "trace_1_2.json"),
                 EVENTS)
    (row,) = trace_opclass.main([str(tmp_path / "run"), "--steps", "2"])
    assert row["device"] == "NVIDIA H100 80GB HBM3"
    assert set(row["classes"]) == set(trace_opclass.CLASSES)
    for cls, (us, n) in WANT.items():
        got = row["classes"][cls]
        assert got["ms_per_step"] == us / 1e3, cls
        assert got["count_per_step"] == n, cls
    assert row["total_ms_per_step"] == sum(d for _, _, d in EVENTS) / 1e3


def test_trace_diff_per_op_and_class(tmp_path):
    """Two traces (the second with every event 1.5 times as long): the
    diff per class and per op name is the second minus the first, largest
    first, the op lines at least the JAX tool's 0.05 ms."""
    a, b = str(tmp_path / "a" / "trace_0_1.json"), str(tmp_path / "b.json")
    _write_trace(a, EVENTS)
    _write_trace(b, EVENTS, scale=1.5)
    rows = trace_opclass.main([os.path.dirname(a), b, "--steps", "2"])
    diff = rows[-1]
    assert diff["diff"] == [a, b]
    for cls, (us, _) in WANT.items():
        assert diff["classes_ms_per_step"][cls] == pytest.approx(
            0.5 * us / 1e3)
    ops = diff["ops_ms_per_step"]
    want = {n: 0.5 * d / 1e3 for n, _, d in EVENTS if 0.5 * d / 1e3 >= 0.05}
    assert list(ops) == sorted(want, key=lambda n: -want[n])
    assert ops == pytest.approx(want)


def test_trace_without_kernels_raises(tmp_path):
    """A real trace of train/profiling.py's Profiler taken on the CPU has
    host ops only: the tool raises its clear error, it does not count
    them."""
    from x_as_supervision_tpu_torch.train.profiling import Profiler

    prof = Profiler(str(tmp_path), start_step=0, num_steps=1)
    for step in range(2):
        prof.maybe_start(step)
        torch.nn.functional.conv2d(torch.randn(1, 2, 8, 8),
                                   torch.randn(2, 2, 3, 3)).sum()
        prof.maybe_stop(step)
    assert os.listdir(tmp_path / "profile") == ["trace_0_1.json"]
    with pytest.raises(ValueError, match="no GPU kernel events"):
        trace_opclass.main([str(tmp_path), "--steps", "2"])


# ---------------------------------------------------------------- scaling


@pytest.fixture(scope="module")
def scaling(tmp_path_factory):
    """scaling_projection's CLI on two gloo ranks (the tiny flagship config,
    fp32, 2 samples of each camera a rank, projected at 100 GB/s)."""
    workdir = str(tmp_path_factory.mktemp("scaling"))
    try:
        ranks = spawn("scaling", 2, workdir, timeout=300)
        with open(os.path.join(workdir, "scaling.json")) as f:
            written = json.load(f)
        return ranks, written
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def test_scaling_ranks_and_report(scaling):
    ranks, written = scaling
    assert [(r["world"], r["rank"], r["backend"]) for r in ranks] == [
        (2, 0, "gloo"), (2, 1, "gloo")]
    assert written["analytic"] == ranks[0]["analytic"]
    assert written["measured"]["collectives_per_step"] == ranks[0][
        "measured"]["collectives_per_step"]


def test_scaling_gradient_bytes_equal_analytic(scaling):
    """The fused step's gradient all-reduce (one flat fp32 buffer) moves
    exactly the analytic bytes: every generator gradient and the
    discriminator's twice (its own and the carried one)."""
    for r in scaling[0]:
        grads = r["measured"]["grad_allreduce_per_step"]
        assert grads == {"calls": 1,
                         "bytes": r["analytic"]["grad_allreduce_bytes"]}
        ar = r["measured"]["collectives_per_step"]["all_reduce/data"]
        assert ar["bytes"] > grads["bytes"] and ar["calls"] > 1


def test_scaling_analytic_matches_jax():
    """The analytic sizes against the JAX tool's analytic(cfg, spec) at the
    tiny flagship config: the parameter counts by module and the synced
    BatchNorm channels; the gradient bytes are the JAX tool's fp32
    parameter bytes plus the carried discriminator gradient's."""
    from __graft_entry__ import _flagship_config
    from x_as_supervision_tpu.tools.scaling_projection import (
        analytic as jax_analytic)
    from x_as_supervision_tpu.train.factory import build_gan_spec

    cfg = _flagship_config(tiny=True)
    want = jax_analytic(cfg, build_gan_spec(cfg, dtype=jnp.bfloat16))
    spec, state = scaling_projection._build(
        flagship_config(tiny=True), torch.float32, "cpu", 0)
    got = scaling_projection.analytic(spec, state)
    assert got["param_counts"] == want["param_counts"]
    assert got["bn_channels"] == want["bn_channels"]
    assert got["grad_allreduce_bytes"] == (
        want["grad_bytes_fp32"] + 4 * want["param_counts"]["discriminator"])


def test_scaling_weak_scaling_equal(scaling):
    """At a fixed batch per rank the step in the group of two and with no
    group (one process) launches the same kernels and runs the same
    counted FLOPs."""
    for r in scaling[0]:
        assert r["weak_scaling"] == {"launches_equal": True,
                                     "counted_flops_ratio": 1.0}
        assert (r["measured"]["launches_per_step"]
                == r["one_process"]["launches_per_step"])
        assert r["measured"]["counted_flops_per_step"] > 0
        assert r["one_process"]["collectives_per_step"] == {}


def test_scaling_projection_arithmetic(scaling):
    """The projection at 100 GB/s: the ring formula on the measured
    all-reduce bytes, against the one-process step ms."""
    r = scaling[1]
    nbytes = r["measured"]["collectives_per_step"]["all_reduce/data"]["bytes"]
    step = r["one_process"]["step_ms"]
    images = 2 * r["cameras"]
    assert [p["cards"] for p in r["projection"]] == list(
        scaling_projection.PROJECT_CARDS)
    for p in r["projection"]:
        n = p["cards"]
        ar = 2.0 * nbytes * (n - 1) / n / 100e9 * 1e3
        assert p["allreduce_ms"] == pytest.approx(ar, rel=1e-12)
        assert p["dp_efficiency_no_overlap"] == pytest.approx(
            step / (step + ar), rel=1e-12)
        assert p["img_s_projected"] == pytest.approx(
            n * images / (step + ar) * 1e3, rel=1e-12)
    assert scaling_projection.ring_allreduce_ms(1e9, 1, 100.0) == 0.0
    assert scaling_projection.ring_allreduce_ms(1e9, 4, 100.0) == 15.0


def test_scaling_projection_needs_a_group():
    with pytest.raises(ValueError, match="process group"):
        scaling_projection.main(["--tiny", "--device", "cpu", "--link-gbps",
                                 "100"])
