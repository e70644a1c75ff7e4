"""The card's published peaks (`peaks.json`) and the least time a piece
of work can take on it."""

from __future__ import annotations

import json
import os

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def least_seconds(flops: float, nbytes: float):
    """(seconds, "operations" or "bytes"): the larger of the operations
    bound (float32 outside the tensor cores: the port keeps TF32 off) and
    the bytes bound."""
    t_ops = flops / PEAKS["fp32_flops_per_s"]
    t_bytes = nbytes / PEAKS["bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def roofline_pct(flops: float, nbytes: float, seconds: float) -> float:
    """The least time over the measured time, in percent."""
    return least_seconds(flops, nbytes)[0] / seconds * 100.0
