"""Host spans the benchmark puts around calls into the program's layers
(by wrapping an instance's method, in traced runs only), and the host
syncs of a call."""

from __future__ import annotations

import time
import warnings

import torch


class Spans:
    """Host wall time and calls per span name. `wrap(obj, "method", name)`
    replaces the instance's method by one that times each call and opens a
    profiler range of the same name; `restore()` puts the methods back."""

    def __init__(self):
        self.totals = {}  # name -> [calls, seconds]
        self._wrapped = []

    def wrap(self, obj, attr: str, name: str) -> None:
        fn = getattr(obj, attr)
        totals = self.totals.setdefault(name, [0, 0.0])

        def timed(*args, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*args, **kw)
            totals[0] += 1
            totals[1] += time.perf_counter() - t0
            return out

        setattr(obj, attr, timed)
        self._wrapped.append((obj, attr))

    def restore(self) -> None:
        for obj, attr in self._wrapped:
            delattr(obj, attr)  # the class's method shows through again
        self._wrapped = []

    def ms_per_call(self, name: str):
        calls, seconds = self.totals.get(name, (0, 0.0))
        return seconds / calls * 1e3 if calls else None


def host_syncs(fn) -> list:
    """The host syncs while `fn` runs on a CUDA device, one entry per
    warning of PyTorch's sync debug mode ("file:line" of the code that
    waited). A copy of the port's `device.py::host_syncs`."""
    torch.cuda.synchronize()
    # The first switch of the mode in a process waits once itself.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
