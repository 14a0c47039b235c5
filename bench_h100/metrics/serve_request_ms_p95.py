"""The 95th percentile of every request's wall time in the window, from
the call to the returned PoseResult."""

import numpy as np


def read(run):
    if run["kind"] != "serve" or not run["request_ms"]:
        return None
    return float(np.percentile(run["request_ms"], 95))
