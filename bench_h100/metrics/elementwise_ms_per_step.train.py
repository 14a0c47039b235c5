"""Device ms a step in elementwise and reduction kernels."""

from harness.readers import per_unit_ms


def read(run):
    return per_unit_ms(run, "train", "elementwise_reduce")
