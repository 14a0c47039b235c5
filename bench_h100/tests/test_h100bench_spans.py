"""The span reading (harness/spans.py) on a hand-made Chrome trace: two
threads of one process (the main thread and the autograd engine's), nested
``xas.*`` spans, launches with correlation ids, kernels, a copy, a kernel
with no launch, and idle gaps; every number below is reckoned by hand.

Main thread (tid 1):  bench.window 0-1000; xas.train.step 10-900;
  gen_forward 20-295 > xas.model.detector 30-200 > xas.op.conv_bn_link
  40-60; gen_backward 300-700; optimizer 700-850.
Autograd thread (tid 2): xas.remat.recompute 310-400 > xas.op.conv_bn_link
  320-330; xas.op.conv3x3.backward 450-470.

Launch (thread, ts) -> device event:
  1 (1, 45)  link_wgmma_kernel 100-150        conv_bn_link, detector, fwd
  2 (1, 250) vectorized_elementwise 260-300   gen_forward
  3 (2, 325) link_wgmma_kernel 330-360        link, recompute, gen_backward
  4 (2, 460) conv3x3_tc_kernel 470-500        conv3x3.backward, gen_backward
  5 (2, 600) reduce_kernel 600-650            gen_backward (main, by time)
  6 (1, 710) Memcpy HtoD 720-740              optimizer
  - (none)   vectorized_elementwise 800-810   no launch matched
Idle gaps (start: main span): 0-100 none, 150-260 detector, 300-330,
360-470, 500-600, 650-720 gen_backward, 740-800, 810-1000 optimizer.
"""

import json

import pytest

import spans_run
from harness import spans, trace

MAIN, AUTOGRAD, PID = 1, 2, 100


def _x(name, ts, dur, tid, cat="user_annotation", **args):
    e = {"ph": "X", "cat": cat, "name": name, "pid": PID, "tid": tid,
         "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def _launch(corr, ts, tid, cat="cuda_runtime"):
    return _x("cudaLaunchKernel", ts, 3, tid, cat, correlation=corr)


def _device(name, ts, dur, corr, cat="kernel"):
    e = _x(name, ts, dur, 7, cat, correlation=corr)
    e["pid"] = 0
    return e


EVENTS = [
    _x("bench.window", 0, 1000, MAIN),
    _x("xas.train.step", 10, 890, MAIN),
    _x("xas.train.gen_forward", 20, 275, MAIN),
    _x("xas.model.detector", 30, 170, MAIN),
    _x("xas.op.conv_bn_link", 40, 20, MAIN),
    _x("xas.train.gen_backward", 300, 400, MAIN),
    _x("xas.train.optimizer", 700, 150, MAIN),
    _x("xas.remat.recompute", 310, 90, AUTOGRAD),
    _x("xas.op.conv_bn_link", 320, 10, AUTOGRAD),
    _x("xas.op.conv3x3.backward", 450, 20, AUTOGRAD),
    _x("aten::mul", 240, 30, MAIN, cat="cpu_op"),
    _launch(1, 45, MAIN),
    _launch(2, 250, MAIN),
    _launch(3, 325, AUTOGRAD, cat="cuda_driver"),
    _launch(4, 460, AUTOGRAD),
    _launch(5, 600, AUTOGRAD),
    _launch(6, 710, MAIN),
    _device("void link_wgmma_kernel<2, 256>", 100, 50, 1),
    _device("void vectorized_elementwise_kernel<4>", 260, 40, 2),
    _device("void link_wgmma_kernel<2, 256>", 330, 30, 3),
    _device("void conv3x3_tc_kernel<1>", 470, 30, 4),
    _device("void reduce_kernel<512>", 600, 50, 5),
    _device("Memcpy HtoD (Pageable -> Device)", 720, 20, 6,
            cat="gpu_memcpy"),
    _device("void vectorized_elementwise_kernel<4>", 800, 10, 99),
    # the device's own copy of a range: not a host span
    _device("xas.train.step", 10, 890, None, cat="gpu_user_annotation"),
]


class FakeProfiler:
    """Exports its events once, as torch.profiler does."""

    def __init__(self, events):
        self.events = events
        self.saved = False

    def export_chrome_trace(self, path):
        if self.saved:
            raise RuntimeError("Trace is already saved.")
        self.saved = True
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


@pytest.fixture(scope="module")
def read():
    return spans.attribute(EVENTS)


def test_device_ms_under_each_span(read):
    want = {
        "xas.train.step": 0.220,          # every matched launch
        "xas.train.gen_forward": 0.090,   # launches 1, 2
        "xas.model.detector": 0.050,
        "xas.op.conv_bn_link": 0.080,     # forward 1 and recompute 3
        "xas.train.gen_backward": 0.110,  # 3, 4, 5 on the autograd thread
        "xas.remat.recompute": 0.030,
        "xas.op.conv3x3.backward": 0.030,
        "xas.train.optimizer": 0.020,
        spans.NO_LAUNCH: 0.010,
    }
    assert read["span_ms"] == pytest.approx(want)
    assert read["span_launches"] == {
        "xas.train.step": 6, "xas.train.gen_forward": 2,
        "xas.model.detector": 1, "xas.op.conv_bn_link": 2,
        "xas.train.gen_backward": 3, "xas.remat.recompute": 1,
        "xas.op.conv3x3.backward": 1, "xas.train.optimizer": 1,
        spans.NO_LAUNCH: 1}


def test_innermost_span_by_op_class(read):
    want = {
        "xas.op.conv_bn_link": {"conv_bn_link": 0.080},
        "xas.train.gen_forward": {"elementwise_reduce": 0.040},
        "xas.op.conv3x3.backward": {"conv3x3": 0.030},
        "xas.train.gen_backward": {"elementwise_reduce": 0.050},
        "xas.train.optimizer": {"memcpy_memset": 0.020},
        spans.NO_LAUNCH: {"elementwise_reduce": 0.010},
    }
    got = read["span_class_ms"]
    assert set(got) == set(want)
    for s, cls in want.items():
        assert got[s] == pytest.approx(cls), s
    # the rows add up to the traced device time
    assert sum(sum(c.values()) for c in got.values()) == pytest.approx(0.230)


def test_idle_gaps_by_main_thread_span(read):
    got = dict(read["idle_gaps_by_span"])
    assert got == pytest.approx({
        spans.NO_SPAN: 100e-6, "xas.model.detector": 110e-6,
        "xas.train.gen_backward": 310e-6, "xas.train.optimizer": 250e-6})
    assert [k for k, _ in read["idle_gaps_by_span"]][0] == \
        "xas.train.gen_backward"


def test_spans_entered(read):
    assert read["span_entered"] == {
        "xas.train.step": 1, "xas.train.gen_forward": 1,
        "xas.model.detector": 1, "xas.op.conv_bn_link": 2,
        "xas.train.gen_backward": 1, "xas.train.optimizer": 1,
        "xas.remat.recompute": 1, "xas.op.conv3x3.backward": 1}


def test_the_merge_keeps_every_key_of_summarize():
    before = trace.summarize(FakeProfiler(EVENTS), 1)
    merged = spans_run.summarize(FakeProfiler(EVENTS), 1)
    assert {k: merged[k] for k in before} == before
    assert set(merged) - set(before) == {
        "span_ms", "span_launches", "span_class_ms", "idle_gaps_by_span",
        "span_entered"}
    # the totals that the span readings divide by
    idle = sum(v for _, v in merged["idle_gaps_by_span"])
    assert idle == pytest.approx(merged["window_s"] - merged["busy_s"])
    assert sum(merged["class_ms"].values()) == pytest.approx(0.230)


def test_readings_a_step_and_none_where_nothing_was_traced(read):
    run = {"kind": "train", "trace": dict(read, units=2)}
    r = spans_run.reading
    assert r(run, "forward_ms_per_step.train") == pytest.approx(0.045)
    assert r(run, "backward_ms_per_step.train") == pytest.approx(0.055)
    assert r(run, "optimizer_ms_per_step.train") == pytest.approx(0.010)
    assert r(run, "recompute_ms_per_step.train") == pytest.approx(0.015)
    assert r(run, "kernel_ops_ms_per_step.train") == pytest.approx(0.055)
    # a serving reading of a train run, a run without a trace, and a trace
    # of a program without spans (the summary of an older tree)
    assert r(run, "preprocess_ms_per_request.serve") is None
    assert r({"kind": "train", "trace": None},
             "forward_ms_per_step.train") is None
    bare = {"kind": "train", "trace": {"units": 2, "class_ms": {}}}
    assert r(bare, "forward_ms_per_step.train") is None
    assert r(dict(run, trace=dict(read, units=2, span_ms={
        "xas.train.gen_forward": 0.1})), "recompute_ms_per_step.train") \
        is None


def test_a_trace_without_the_window_reads_the_device_extent():
    events = [e for e in EVENTS if e["name"] != "bench.window"]
    got = spans.attribute(events)
    # the main thread is the step's; the idle before the first kernel and
    # after the last one lies outside
    assert got["span_ms"]["xas.train.gen_backward"] == pytest.approx(0.110)
    assert dict(got["idle_gaps_by_span"]) == pytest.approx({
        "xas.model.detector": 110e-6, "xas.train.gen_backward": 310e-6,
        "xas.train.optimizer": 60e-6})


def test_the_span_run_reads_shares_a_step():
    got = spans_run.per_unit(spans_run.summarize(FakeProfiler(EVENTS), 2),
                             "train")
    assert got["device_ms_per_unit"] == pytest.approx(0.115)
    assert got["span_ms"]["xas.train.gen_backward"] == pytest.approx(0.055)
    # the phases hold every launch but the unmatched kernel's
    assert got["phase_share_of_device_ms"] == pytest.approx(0.220 / 0.230)
    assert got["idle_share_in_spans"] == pytest.approx(670 / 770)
    assert got["spans_entered_per_unit"] == 4.5
    assert got["readings"]["optimizer_ms_per_step.train"] == \
        pytest.approx(0.010)
