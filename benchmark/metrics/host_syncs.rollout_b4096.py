"""Host syncs per 4096-step (every sub-batch stepped once) that the program
counts (`trace.count_sync`: one read of the resetting envs per sub-batch),
summed over its spans in the profiled stretch. None where the program has
no tracing or no span ran."""


def read(layer):
    try:
        from sigmarl_tpu_torch import trace
    except ImportError:
        return None
    spans = trace.snapshot()["spans"]
    if not spans:
        return None
    return sum(s["counts"].get("syncs", 0) for s in spans.values()) / layer["traced_units"]
