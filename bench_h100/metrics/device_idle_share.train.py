"""Percent of a step's time in the window with no device activity: the
traced busy seconds a step over the window's seconds a step."""

from harness.readers import idle_share


def read(run):
    return idle_share(run, "train")
