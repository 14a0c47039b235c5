"""Camera images trained in the window (each view once) over its seconds;
the window ends in a synchronize."""


def read(run):
    if run["kind"] != "train":
        return None
    return run["images"] / run["window_s"]
