"""The share of the untraced window's time in which no kernel, copy or
set ran on the card: the trace's busy time per traced unit over the
window's time per unit (`metrics/common.py::idle_pct`)."""

from benchmark.metrics.common import idle_pct


def read(layer):
    return idle_pct(layer)
