"""One profiled stretch of a run, reduced to what the per-layer metrics
and the result line read: the traced window, the device's busy time (the
union of kernel, copy and set intervals), each kernel's launches and
device time, the device operations that took most time, and the longest
idle gaps by what the host was doing."""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"
TOP = 10
# The device-side events that are work; the profiler also puts the host's
# ranges on the device's timeline ("gpu_user_annotation"), which are not.
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 120  # of a kernel's name in the breakdown (C++ signatures run long)


def traced(fn, dev: torch.device) -> dict:
    """Run `fn()` under the profiler inside a range named `WINDOW`, the
    card synchronised before the range closes, and reduce the trace."""
    cuda = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(dev)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize(dev)
    return reduce_events(prof.profiler.kineto_results.events())


def _is_work(e) -> bool:
    """Whether a device-side event is work (a kernel, copy or set) and not
    a host range the profiler mirrors onto the device's timeline. Older
    PyTorch builds lack `activity_type`; the benchmark's own ranges are
    then told by name."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_WORK
    annotation = getattr(e, "is_user_annotation", None)
    if annotation is not None and annotation():
        return False
    return not e.name().startswith("bench.")


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events) -> dict:
    """`window_s`, `busy_s`, `kernels` {name: [launches, seconds]},
    `device_ops` and `idle_gaps` ([[name, seconds]], the longest first)
    from the profiler's raw events. A gap is named by the benchmark's own
    range (`bench.*`) and the innermost host operation running at its
    middle."""
    window = None
    dev_iv, cpu = [], []
    kernels = defaultdict(lambda: [0, 0.0])
    for e in events:
        kind = e.device_type()
        start, dur = e.start_ns(), e.duration_ns()
        if kind == torch.autograd.DeviceType.CPU:
            if e.name() == WINDOW:
                window = (start, start + dur)
            cpu.append((start, start + dur, e.name()))
        elif kind == torch.autograd.DeviceType.CUDA and _is_work(e):
            dev_iv.append((start, start + dur))
            k = kernels[e.name()]
            k[0] += 1
            k[1] += dur * 1e-9
    if window is None:
        raise RuntimeError("the traced window's range is missing from the trace")
    w0, w1 = window
    busy = [[max(s, w0), min(e, w1)] for s, e in _union(dev_iv) if e > w0 and s < w1]
    busy_ns = sum(e - s for s, e in busy)

    cpu.sort()
    starts = [c[0] for c in cpu]
    spans = [c for c in cpu if c[2].startswith("bench.") and c[2] != WINDOW]
    span_starts = [c[0] for c in spans]

    def label(t):
        j = bisect.bisect_right(span_starts, t)
        span = next((c[2] for c in reversed(spans[max(0, j - 8):j]) if c[1] > t), "host")
        i = bisect.bisect_right(starts, t)
        op = None
        for c in reversed(cpu[max(0, i - 400):i]):
            if c[1] > t and not c[2].startswith("bench."):
                op = c[2]
                break
        return span if op is None else f"{span}/{op}"

    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            gaps[label((s + e) // 2)] += (e - s) * 1e-9
    device_ops = sorted(([k[:NAME_CHARS], v[1]] for k, v in kernels.items()),
                        key=lambda x: -x[1])[:TOP]
    idle = sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:TOP]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9,
            "kernels": {k: list(v) for k, v in kernels.items()},
            "device_ops": device_ops, "idle_gaps": idle}


def kernel_time(summary: dict, fragment: str):
    """(launches, device seconds) of the kernels whose name holds
    `fragment`, or None where the trace has none."""
    hits = [v for k, v in summary["kernels"].items() if fragment in k]
    if not hits:
        return None
    return sum(h[0] for h in hits), sum(h[1] for h in hits)
