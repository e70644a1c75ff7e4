"""The port's spans and counters: named ranges at its layers' boundaries
that share the device trace's timeline, and counts (host syncs, kernel
launches) attributed to the layer where they happen.

- `span(name)`, a context manager and a decorator, marks a layer. While
  tracing is on it opens a `torch.profiler.record_function(name)` (only
  while a profiler records, so the range sits on the profiler's timeline
  beside the device's work) and adds to the name's aggregate: calls, total
  host ns and self ns (the total less what its child spans cover). While
  tracing is off it is a shared no-op: one read of a flag.
- `count(name, n)` counts always; while a span is open it also adds to the
  innermost span's counts.
- `diverted()` sends the counts made inside it to a dict of its own: for a
  CUDA graph's capture, whose counts (the launches it holds) each replay
  adds instead.
- `snapshot()` returns the aggregates and the counts; `reset()` clears them.

Tracing is on while a `torch.profiler` session records, or after
`enable()`. Names are dotted by parent (`env_step.reset` inside
`env_step`); a name that begins with a dot is joined to the innermost
open span's (`.spawn` inside `env_step.reset` is `env_step.reset.spawn`;
with none open, `spawn`), for code that more than one layer calls. Spans
nest on one stack per process: the port's paths run on one thread. A
span in code that a CUDA graph captures is the no-op (a replay runs none
of the host's work): a graph is timed around its replay. Nothing is
written to disk.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

# The host waited for the card: a read of a device value, a copy from
# pageable host memory, an explicit synchronise (`count_sync`).
SYNCS = "syncs"

if hasattr(_profiler, "_is_profiler_enabled"):
    def _recording() -> bool:
        """Whether a `torch.profiler` session records (the module flag
        that `profile` sets while it runs)."""
        return _profiler._is_profiler_enabled
else:  # a PyTorch without the flag: ask the profiler itself
    _recording = torch._C._autograd._profiler_enabled


class _State:
    """The process's tracing state: the `enable()` switch, the open spans,
    the aggregates {name: [calls, total_ns, self_ns, counts]}, the counts
    {name: n} and the innermost `diverted()` sink (None outside one)."""

    def __init__(self):
        self.enabled = False
        self.stack = []
        self.spans = {}
        self.counts = {}
        self.sink = None


_state = _State()


class _Off:
    """A span while tracing is off: nothing on entry or exit. One per name,
    so that it also serves as the name's decorator."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorated(self.name, fn)


_off: dict = {}


class _Span:
    """An open span: the profiler's range (while one records), its start on
    the host's clock and the time its children have covered so far."""

    __slots__ = ("name", "agg", "rf", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if self.name[0] == ".":
            self.name = (_state.stack[-1].name + self.name if _state.stack
                         else self.name[1:])
        agg = _state.spans.get(self.name)
        if agg is None:
            agg = _state.spans[self.name] = [0, 0, 0, {}]
        self.agg, self.child_ns, self.rf = agg, 0, None
        if _recording():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        _state.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        _state.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        agg = self.agg
        agg[0] += 1
        agg[1] += dur
        agg[2] += dur - self.child_ns
        if _state.stack:
            _state.stack[-1].child_ns += dur
        return False

    def __call__(self, fn):
        return _decorated(self.name, fn)


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def span(name: str):
    """The span `name`: `with span(name): ...` or `@span(name)`."""
    if not (_state.enabled or _recording()) or _capturing():
        off = _off.get(name)
        if off is None:
            off = _off[name] = _Off(name)
        return off
    return _Span(name)


def _decorated(name: str, fn):
    @functools.wraps(fn)
    def traced(*args, **kw):
        with span(name):
            return fn(*args, **kw)

    return traced


def count(name: str, n: int = 1) -> None:
    """Add `n` to the count `name`, and to the innermost open span's;
    inside `diverted()`, to its dict alone."""
    if _state.sink is not None:
        _state.sink[name] = _state.sink.get(name, 0) + n
        return
    _state.counts[name] = _state.counts.get(name, 0) + n
    if _state.stack:
        counts = _state.stack[-1].agg[3]
        counts[name] = counts.get(name, 0) + n


def count_sync(device: torch.device, n: int = 1) -> None:
    """Count `n` host syncs (`SYNCS`) where `device` is a card; a CPU
    computation waits for nothing."""
    if device.type == "cuda":
        count(SYNCS, n)


@contextlib.contextmanager
def diverted():
    """Count inside into the dict this yields, and nowhere else."""
    sink, prev = {}, _state.sink
    _state.sink = sink
    try:
        yield sink
    finally:
        _state.sink = prev


def enable() -> None:
    """Trace without a profiler too (aggregates only: no ranges)."""
    _state.enabled = True


def disable() -> None:
    _state.enabled = False


def snapshot() -> dict:
    """{"spans": {name: {"calls", "total_ns", "self_ns", "counts"}},
    "counts": {name: n}}: copies of the aggregates and the counts."""
    return {
        "spans": {k: {"calls": a[0], "total_ns": a[1], "self_ns": a[2], "counts": dict(a[3])}
                  for k, a in _state.spans.items()},
        "counts": dict(_state.counts),
    }


def reset() -> None:
    """Clear the aggregates and the counts."""
    _state.spans.clear()
    _state.counts.clear()
