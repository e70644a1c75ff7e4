"""Host time per iteration in the program's span `train.rollout.act.turns`
(its own tracing, `sigmarl_tpu_torch/trace.py`), XP-MARL's priority turns
(`rl/priority.py::prioritized_action_propagation`: per turn the gathers of
the acting agents' rows and their neighbours' actions, the policy on B
rows, the sample and the scatters): the span's total over the profiled
iteration, in s. Taken under the profiler, which about doubles the host's
time: for comparing two trees in one cell. None where the program has no
tracing or the span never ran."""


def read(layer):
    try:
        from sigmarl_tpu_torch import trace
    except ImportError:
        return None
    s = trace.snapshot()["spans"].get("train.rollout.act.turns")
    return s["total_ns"] * 1e-9 / layer["traced_units"] if s and s["calls"] else None
