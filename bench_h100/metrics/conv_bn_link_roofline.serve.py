"""The link kernel's least time a request over its traced device time."""

from harness.readers import roofline


def read(run):
    return roofline(run, "serve", "conv_bn_link", "link_least_s")
