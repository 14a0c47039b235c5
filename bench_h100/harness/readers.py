"""What the metric readers under ``metrics/`` share. Each takes the run's
record and returns a number, or None where the run has nothing to read:
a trace-based reader without a trace, or a kernel that the traced window
never launched. No share of a roofline or a peak is ever reported as 0 in
place of a missing reading.
"""

from __future__ import annotations


def traced(run: dict, kind: str):
    """The run's trace summary where it is a `kind` run with a trace."""
    if run.get("kind") != kind or not run.get("trace"):
        return None
    return run["trace"]


def per_unit_ms(run: dict, kind: str, cls: str):
    """Device ms a step or request in op class `cls`."""
    tr = traced(run, kind)
    if tr is None:
        return None
    return tr["class_ms"].get(cls, 0.0) / tr["units"]


def unit_s(run: dict):
    """Seconds a step or request took in the (untraced) window."""
    return run["window_s"] / run["attempted"] if run["attempted"] else None


def idle_share(run: dict, kind: str):
    """Percent of a step's or request's time in the window with no kernel,
    copy or fill running: one less the traced device-busy seconds a step
    (the union of device intervals) over the window's seconds a step. The
    profiler slows the host, not the device, so the traced window's own
    idle share reads high."""
    tr = traced(run, kind)
    if tr is None or not unit_s(run):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["units"] / unit_s(run))


def mfu(run: dict, kind: str):
    """Percent of the card's dense peak in the program's type that the
    model FLOPs of a step or request (harness/work.py) reach over the
    window's seconds a step or request."""
    tr = traced(run, kind)
    if tr is None or not run.get("work") or not unit_s(run):
        return None
    return 100.0 * run["work"]["model_flops"] / unit_s(run) \
        / run["peaks"][run["dtype"]]


def roofline(run: dict, kind: str, cls: str, least_key: str):
    """Percent: the least time a step's or request's calls of kernel class
    `cls` could take (harness/work.py, from shapes) over their traced
    device time."""
    tr = traced(run, kind)
    if tr is None or not run.get("work") or run["work"].get(least_key) is None:
        return None
    ms = tr["class_ms"].get(cls, 0.0) / tr["units"]
    if ms <= 0:
        return None
    return 100.0 * run["work"][least_key] / (ms / 1e3)
