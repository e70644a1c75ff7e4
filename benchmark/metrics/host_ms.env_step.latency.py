"""Host wall time per call of the env step (`RoadTrafficEnv.step`), from
the benchmark's span around it."""

from benchmark.metrics.common import span_ms


def read(layer):
    return span_ms(layer, "bench.env_step")
