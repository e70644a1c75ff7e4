"""The numbers that decide `correct`: gaps between what the program
produced and what the reference recomputes, each held to a limit."""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, NamedTuple

import torch


class Check(NamedTuple):
    """One compared number and its limit; it passes where it is finite and
    at most the limit."""

    name: str
    value: float
    limit: float

    @property
    def passes(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def rel_gap(prog: torch.Tensor, ref: torch.Tensor, floor: float = 1.0) -> float:
    """max |prog - ref| over max(max |ref|, floor), in float64; inf where
    the shapes differ or the program's value is not finite where the
    reference's is."""
    if prog.shape != ref.shape:
        return math.inf
    p, r = prog.detach().double(), ref.detach().double()
    if bool((torch.isfinite(r) & ~torch.isfinite(p)).any()):
        return math.inf
    if p.numel() == 0:
        return 0.0
    fin = torch.isfinite(r)
    diff = torch.where(fin, (p - r).abs(), torch.zeros_like(r))
    scale = float(torch.where(fin, r.abs(), torch.zeros_like(r)).max())
    return float(diff.max()) / max(scale, floor)


def state_gap(prog, ref, floor: float = 1e-3):
    """The worst `rel_gap` over the fields of two states (dataclasses of
    tensors with the same field names): (gap, field)."""
    worst = (0.0, "")
    for f in dataclasses.fields(ref):
        g = rel_gap(getattr(prog, f.name).to(torch.float64), getattr(ref, f.name).to(torch.float64),
                    floor)
        if g > worst[0] or not math.isfinite(g):
            worst = (g, f.name)
    return worst


def worst(checks: Iterable[Check]) -> list:
    """One Check per name: the largest value of each."""
    out = {}
    for c in checks:
        if c.name not in out or not (out[c.name].value >= c.value):
            out[c.name] = c
    return list(out.values())


def to_lower(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`x` rounded to `dtype` and back (the control's lower precision);
    integer and boolean tensors are returned as they are."""
    if not x.is_floating_point():
        return x
    return x.to(dtype).to(x.dtype)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32's 10-bit mantissa (to nearest, ties
    away), as the tensor cores read a TF32 operand."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def tf32_linear(x: torch.Tensor, layer) -> torch.Tensor:
    """A linear layer whose operands pass through TF32 rounding (the
    control's products); the rounding's gradient is taken as the
    identity."""
    rx = x + (round_tf32(x.detach()) - x).detach()
    rw = layer.weight + (round_tf32(layer.weight.detach()) - layer.weight).detach()
    return rx @ rw.T + layer.bias


def mlp_forward(layers, x: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """A Tanh MLP's forward over its linear `layers`, with `tf32` through
    `tf32_linear`."""
    for i, layer in enumerate(layers):
        x = tf32_linear(x, layer) if tf32 else layer(x)
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def policy_out(networks, layers, obs: torch.Tensor, tf32: bool = False):
    """(loc, scale) of the policy whose MLP is `layers`, as the reference's
    `networks.PolicyNet` computes them."""
    out = mlp_forward(layers, obs, tf32)
    scale = torch.clamp(torch.nn.functional.softplus(out[..., 2:] + networks._SOFTPLUS_BIAS_1),
                        min=networks._SCALE_LB)
    return out[..., :2], scale
