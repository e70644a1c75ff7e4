"""Host syncs per step that the program counts (`trace.count_sync`): the
env step's read of the resetting envs, and one synchronise per recorded
chunk (`eval.record`), summed over its spans in the traced chunk. None
where the program has no tracing or no span ran."""


def read(layer):
    try:
        from sigmarl_tpu_torch import trace
    except ImportError:
        return None
    spans = trace.snapshot()["spans"]
    if not spans:
        return None
    return sum(s["counts"].get("syncs", 0) for s in spans.values()) / layer["traced_units"]
