"""Host time per iteration in the program's span `filter` (its own tracing,
`sigmarl_tpu_torch/trace.py`), the filter (`CBFSafetyFilter.filter_actions`:
assembly with K2, the solve with K1, the finish): the span's total over the
profiled iteration, in s. Taken under the profiler, which about doubles the
host's time: for comparing two trees in one cell. None where the program has
no tracing or the span never ran."""


def read(layer):
    try:
        from sigmarl_tpu_torch import trace
    except ImportError:
        return None
    s = trace.snapshot()["spans"].get("filter")
    return s["total_ns"] * 1e-9 / layer["traced_units"] if s and s["calls"] else None
