"""The physique conv kernels' least time a step over their traced time."""

from harness.readers import roofline


def read(run):
    return roofline(run, "train", "conv3x3", "conv3x3_least_s")
