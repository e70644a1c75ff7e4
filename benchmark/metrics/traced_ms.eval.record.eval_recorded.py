"""Host time per chunk in the program's span `eval.record` (its own tracing,
`sigmarl_tpu_torch/trace.py`): a chunk's stack of the 32 steps' records
on the card, their copies to the host and the synchronise before the host
reads them, which waits for the chunk's last steps. The span's total over
the traced chunk per call, in ms; under the profiler, which about doubles
the host's time: for comparing two trees in one cell. None where the
program has no such span or it never ran."""


def read(layer):
    try:
        from sigmarl_tpu_torch import trace
    except ImportError:
        return None
    s = trace.snapshot()["spans"].get("eval.record")
    return s["total_ns"] * 1e-6 / s["calls"] if s and s["calls"] else None
