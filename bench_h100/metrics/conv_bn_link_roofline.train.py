"""The link kernel's least time a step over its traced device time."""

from harness.readers import roofline


def read(run):
    return roofline(run, "train", "conv_bn_link", "link_least_s")
