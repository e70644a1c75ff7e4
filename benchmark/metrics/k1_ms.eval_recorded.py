"""K1's device time per launch in the traced chunk of the eval cell, in ms:
the Newton solve at 2+15 with two active CLF rows per agent, whose envs
that leave the fast division's ranges are solved again with IEEE
divisions (`k1_ieee_share.eval_recorded`); `work/k1_newton.py` does not
count active CLF rows. None where the trace holds no launch of K1."""

from benchmark.harness.trace import kernel_time
from benchmark.metrics.common import K1_KERNEL


def read(layer):
    hit = kernel_time(layer["trace"], K1_KERNEL)
    if hit is None or hit[0] == 0 or hit[1] <= 0:
        return None
    return hit[1] / hit[0] * 1e3
