"""K2's share of its roofline on the rollout cell (`work/k2_stencil.py`
over the device time per launch in the trace)."""

from benchmark.metrics.common import K2_KERNEL, k2_stencil, kernel_roofline


def read(layer):
    return kernel_roofline(layer, K2_KERNEL, k2_stencil.count)
