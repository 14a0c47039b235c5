"""The program's named spans (``xas.*``, the program's spans.py) in the
device trace: the device time, launches and idle gaps under each.

A device event (kernel, copy or fill) belongs to the launch that caused
it: the ``cuda_runtime`` or ``cuda_driver`` event with the same
``correlation``. Its spans are the ``xas.*`` ranges open at the launch on
the launch's own thread, inside those open at that moment on the main
thread (the thread of the benchmark's window, or of the first step or
request) where the launch is on another: the autograd engine launches the
backward on its own thread while the main thread waits inside
``xas.train.gen_backward``. So

  * ``span_ms``, ``span_launches``: device ms and events under each span,
    nested ones included (a kernel under ``xas.op.conv3x3.backward`` on
    the autograd thread counts there and to ``xas.train.gen_backward``);
  * ``span_class_ms``: {span: {op class: ms}} by the innermost span alone,
    so that its rows add up to the traced device time (``(no xas span)``:
    a launch inside none; ``(no launch)``: no launch matched);
  * ``idle_gaps_by_span``: each idle gap of the device under the innermost
    main-thread span open at its start, in seconds, largest first.

The names are the program's, copied here so that the yardstick stays put.
The totals of a traced window: ``trace.summarize``'s ``class_ms`` and its
``window_s`` less ``busy_s``.
"""

from __future__ import annotations

import collections

from . import trace

PREFIX = "xas."
UNITS = ("xas.train.step", "xas.serve.request")
TRAIN_PHASES = ("xas.train.preprocess", "xas.train.gen_forward",
                "xas.train.gen_backward", "xas.train.disc_forward",
                "xas.train.disc_backward", "xas.train.allreduce",
                "xas.train.optimizer", "xas.train.metrics")
SERVE_STAGES = ("xas.serve.copy", "xas.serve.preprocess",
                "xas.serve.forward", "xas.serve.fetch",
                "xas.serve.postprocess")
KERNEL_OPS = tuple(f"xas.op.{op}{side}"
                   for op in ("conv_bn_link", "conv3x3", "integral_marginals")
                   for side in ("", ".backward"))
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no xas span)"
NO_LAUNCH = "(no launch)"

def _thread(e) -> tuple:
    return (e.get("pid"), e.get("tid"))


def _open_at(ranges: list, times: list) -> list:
    """For each time of `times`, the names of the `ranges` ((start, end,
    name), nested as a thread's spans are) open at it, outermost first."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out = [()] * len(times)
    stack, j = [], 0
    for t, k in sorted((t, k) for k, t in enumerate(times)):
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] <= ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        # a child that outlasts its parent by the trace's rounding leaves
        # the parent below it
        out[k] = tuple(r[2] for r in stack if r[1] >= t)
    return out


def main_thread(events: list):
    """The thread of the benchmark's window, else of the first step or
    request; None without either."""
    for names in ((trace.WINDOW,), UNITS):
        hits = sorted((float(e["ts"]), _thread(e)) for e in events
                      if e.get("ph") == "X" and e.get("name") in names
                      and e.get("cat") == "user_annotation")
        if hits:
            return hits[0][1]
    return None


def _window(events: list) -> tuple:
    """The benchmark's window in microseconds, else the device events'
    first start and last end."""
    win = [e for e in events if e.get("name") == trace.WINDOW
           and e.get("cat") == "user_annotation"]
    if win:
        t0 = float(win[0]["ts"])
        return t0, t0 + float(win[0]["dur"])
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS]
    if not dev:
        return 0.0, 0.0
    return min(a for a, _ in dev), max(b for _, b in dev)


def attribute(events: list) -> dict:
    """The span readings (module docstring) of a Chrome trace's events
    over the benchmark's window (else the device events' extent), the
    device events clipped to it as ``trace.summarize`` clips them; and
    ``span_entered``, how many times each span opened in it."""
    t0, t1 = _window(events)
    main = main_thread(events)
    spans = collections.defaultdict(list)
    entered = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e.get("name", "").startswith(PREFIX):
            a = float(e["ts"])
            spans[_thread(e)].append((a, a + float(e.get("dur", 0)),
                                      e["name"]))
            entered[e["name"]] += t0 <= a <= t1
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launches[corr] = (float(e["ts"]), _thread(e))
    device = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        a, b = max(a, t0), min(b, t1)
        if b > a:
            device.append((a, b, e["name"], launches.get(
                (e.get("args") or {}).get("correlation"))))

    # the spans open at each launch, on its thread and on the main thread
    asks = collections.defaultdict(list)
    for k, (_, _, _, launch) in enumerate(device):
        if launch is not None:
            asks[launch[1]].append((launch[0], ("own", k)))
            if launch[1] != main:
                asks[main].append((launch[0], ("main", k)))
    busy = trace._union([(a, b) for a, b, _, _ in device])
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    for g, (a, _) in enumerate(gaps):
        asks[main].append((a, ("gap", g)))
    found = {}
    for thread, items in asks.items():
        opened = _open_at(spans.get(thread, []), [t for t, _ in items])
        for (_, key), names in zip(items, opened):
            found[key] = names

    span_ms, span_n = collections.Counter(), collections.Counter()
    span_cls = collections.defaultdict(collections.Counter)
    for k, (a, b, name, launch) in enumerate(device):
        ms = (b - a) / 1e3
        if launch is None:
            stack = (NO_LAUNCH,)
        else:
            stack = found.get(("main", k), ()) + found[("own", k)]
        for s in set(stack):
            span_ms[s] += ms
            span_n[s] += 1
        inner = stack[-1] if stack else NO_SPAN
        span_cls[inner][trace.classify(name)] += ms
    idle = collections.Counter()
    for g, (a, b) in enumerate(gaps):
        names = found[("gap", g)]
        idle[names[-1] if names else NO_SPAN] += (b - a) / 1e6
    return {
        "span_ms": dict(span_ms),
        "span_launches": dict(span_n),
        "span_class_ms": {s: dict(c) for s, c in span_cls.items()},
        "idle_gaps_by_span": [[k, v] for k, v in idle.most_common()],
        "span_entered": dict(entered),
    }
