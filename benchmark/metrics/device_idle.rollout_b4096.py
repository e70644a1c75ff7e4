"""The share of the untraced window's time in which no kernel, copy or
set ran on the card: the trace's busy time per traced 4096-step (every
sub-batch stepped once) over the window's time per 4096-step
(`metrics/common.py::idle_pct`)."""

from benchmark.metrics.common import idle_pct


def read(layer):
    return idle_pct(layer)
