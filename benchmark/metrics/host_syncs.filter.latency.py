"""Host syncs per decision that the program counts inside its span
`filter` and the filter's phases (`filter.*`) in the profiled stretch.
None where the program has no tracing or the filter's span never ran."""


def read(layer):
    try:
        from sigmarl_tpu_torch import trace
    except ImportError:
        return None
    spans = {k: s for k, s in trace.snapshot()["spans"].items()
             if k == "filter" or k.startswith("filter.")}
    if not spans:
        return None
    return sum(s["counts"].get("syncs", 0) for s in spans.values()) / layer["traced_units"]
