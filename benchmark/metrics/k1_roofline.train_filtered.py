"""K1's share of its roofline in filtered training (`work/k1_newton.py` at
the trainer's budget, 2 + 15 Newton iterations, over the device time per
launch in the trace)."""

from benchmark.metrics.common import K1_KERNEL, k1_newton, kernel_roofline


def read(layer):
    return kernel_roofline(layer, K1_KERNEL, k1_newton.count)
