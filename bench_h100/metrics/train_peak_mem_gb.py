"""torch.cuda.max_memory_allocated() over the window, in GB (1e9)."""


def read(run):
    if run["kind"] != "train" or not run["peak_bytes"]:
        return None
    return run["peak_bytes"] / 1e9
