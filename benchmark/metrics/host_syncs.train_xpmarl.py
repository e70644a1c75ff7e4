"""Host syncs per XP-MARL iteration that the program counts
(`trace.count_sync`: reads of device values, copies from pageable host
memory, explicit synchronises), summed over its spans in the profiled
iteration. None where the program has no tracing or no span ran."""


def read(layer):
    try:
        from sigmarl_tpu_torch import trace
    except ImportError:
        return None
    spans = trace.snapshot()["spans"]
    if not spans:
        return None
    return sum(s["counts"].get("syncs", 0) for s in spans.values()) / layer["traced_units"]
