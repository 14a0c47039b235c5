"""Device ms a request of host-to-device copies (the crops, from pageable
memory)."""

from harness.readers import traced


def read(run):
    tr = traced(run, "serve")
    return None if tr is None else tr["h2d_ms"] / tr["units"]
