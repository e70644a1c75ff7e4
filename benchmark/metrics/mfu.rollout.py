"""The filtered step's counted work (policy forward, K1, K2) over the
card's float32 peak times the untraced window's wall time per step."""

from benchmark.metrics.common import mfu_pct, on_device, rollout_step_flops, unit_seconds


def read(layer):
    per_step = unit_seconds(layer)
    if per_step is None or not on_device(layer):
        return None
    return mfu_pct(rollout_step_flops(layer["shapes"]), per_step)
