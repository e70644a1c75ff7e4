"""The share of the untraced window's time in which no kernel, copy or
set ran on the card: the trace's busy time per traced step over the
window's time per step, the host's records included
(`metrics/common.py::idle_pct`)."""

from benchmark.metrics.common import idle_pct


def read(layer):
    return idle_pct(layer)
