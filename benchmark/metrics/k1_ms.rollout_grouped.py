"""K1's device time per launch in the traced steps, in ms: the grouped
filter's Newton solve, whose pairs carry 2 C^2 = 18 rows (a pair across
groups split into one row per side). None where the trace holds no
launch of K1."""

from benchmark.harness.trace import kernel_time
from benchmark.metrics.common import K1_KERNEL


def read(layer):
    hit = kernel_time(layer["trace"], K1_KERNEL)
    if hit is None or hit[0] == 0 or hit[1] <= 0:
        return None
    return hit[1] / hit[0] * 1e3
