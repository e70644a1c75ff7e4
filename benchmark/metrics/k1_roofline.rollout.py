"""K1's share of its roofline on the rollout cell (`work/k1_newton.py`
over the device time per launch in the trace)."""

from benchmark.metrics.common import K1_KERNEL, k1_newton, kernel_roofline


def read(layer):
    return kernel_roofline(layer, K1_KERNEL, k1_newton.count)
