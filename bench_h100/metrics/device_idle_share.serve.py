"""Percent of a request's time in the window with no device activity: the
traced busy seconds a request over the window's seconds a request."""

from harness.readers import idle_share


def read(run):
    return idle_share(run, "serve")
