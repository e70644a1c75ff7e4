"""What several readers share."""

from __future__ import annotations

from benchmark.harness.trace import kernel_time
from benchmark.work import k1_newton, k2_stencil, mlp
from benchmark.work.peaks import PEAKS, roofline_pct

K1_KERNEL = "qp_newton_kernel"
K2_KERNEL = "pd_stencil_kernel"


def unit_seconds(layer: dict):
    """The untraced window's wall time per unit of work (a step, a
    decision, an iteration), or None without one."""
    n, seconds = layer.get("window") or (0, 0.0)
    return seconds / n if n and seconds > 0 else None


def idle_pct(layer: dict):
    """The share of the untraced window's time per unit in which the
    device is not busy: the trace's busy time per traced unit over the
    window's time per unit. The traced stretch itself is not the
    denominator: the profiler slows the host, not the device."""
    tr, per_unit = layer.get("trace"), unit_seconds(layer)
    if not tr or tr["busy_s"] <= 0 or per_unit is None:
        return None
    return (1.0 - tr["busy_s"] / layer["traced_units"] / per_unit) * 100.0


def span_ms(layer: dict, name: str):
    return layer.get("spans_ms", {}).get(name)


def kernel_roofline(layer: dict, fragment: str, counter):
    """The kernel's least time by `counter(shapes)` over its device time
    per launch in the trace, in percent; None without launches."""
    hit = kernel_time(layer["trace"], fragment)
    if hit is None or hit[0] == 0 or hit[1] <= 0:
        return None
    flops, nbytes = counter(layer["shapes"])
    return roofline_pct(flops, nbytes, hit[1] / hit[0])


def rollout_step_flops(shapes: dict) -> float:
    """One filtered step: the policy's forward over B N rows, K1, K2."""
    widths = [shapes["obs_dim"], *shapes["hidden"], 4]
    return (mlp.forward_flops(widths, shapes["batch"] * shapes["n_agents"])
            + k1_newton.count(shapes)[0] + k2_stencil.count(shapes)[0])


def on_device(layer: dict) -> bool:
    """Whether the traced stretch found device work (a CPU run finds
    none, and reads no share of the card's peak)."""
    tr = layer.get("trace")
    return bool(tr) and tr["busy_s"] > 0


def mfu_pct(flops: float, seconds: float):
    if seconds <= 0:
        return None
    return flops / (PEAKS["fp32_flops_per_s"] * seconds) * 100.0
