"""Model FLOPs a request (harness/work.py) over the window's seconds a request,
percent of the card's dense peak."""

from harness.readers import mfu


def read(run):
    return mfu(run, "serve")
