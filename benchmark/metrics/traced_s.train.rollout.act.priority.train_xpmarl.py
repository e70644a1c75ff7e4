"""Host time per iteration in the program's span `train.rollout.act.priority`
(its own tracing, `sigmarl_tpu_torch/trace.py`), XP-MARL's rank
(`rl/priority.py::priority_rank`: the priority actor's forward, the score
sample and the stable sort): the span's total over the profiled iteration,
in s. Taken under the profiler, which about doubles the host's time: for
comparing two trees in one cell. None where the program has no tracing or
the span never ran."""


def read(layer):
    try:
        from sigmarl_tpu_torch import trace
    except ImportError:
        return None
    s = trace.snapshot()["spans"].get("train.rollout.act.priority")
    return s["total_ns"] * 1e-9 / layer["traced_units"] if s and s["calls"] else None
