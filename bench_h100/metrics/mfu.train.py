"""Model FLOPs a step (harness/work.py) over the window's seconds a step,
percent of the card's dense peak."""

from harness.readers import mfu


def read(run):
    return mfu(run, "train")
