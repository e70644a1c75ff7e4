"""Host time per step in the program's span `env_step.observe` (its own tracing,
`sigmarl_tpu_torch/trace.py`): the span's total over the profiled
stretch, per traced unit, in ms. Taken under the profiler, which about
doubles the host's time: for comparing two trees in one cell. None where
the program has no tracing or the span never ran."""


def read(layer):
    try:
        from sigmarl_tpu_torch import trace
    except ImportError:
        return None
    s = trace.snapshot()["spans"].get("env_step.observe")
    return s["total_ns"] * 1e-6 / layer["traced_units"] if s and s["calls"] else None
