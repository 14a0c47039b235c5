"""Seconds from the process start to the end of warm-up."""


def read(run):
    return run["setup_s"]
