"""Host wall time per call of the filter (`CBFSafetyFilter.filter_actions`),
from the benchmark's span around it."""

from benchmark.metrics.common import span_ms


def read(layer):
    return span_ms(layer, "bench.filter")
