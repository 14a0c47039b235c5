"""Images answered in the window over its seconds."""


def read(run):
    if run["kind"] != "serve":
        return None
    return run["images"] / run["window_s"]
