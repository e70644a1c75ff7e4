"""Network weights made from the run's seed on the device, in one draw
for all layers, handed alike to the program and to the reference."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

# flax's lecun truncated normal: std / 0.8796... is the std of a standard
# normal truncated at +-2.
_TRUNC_STD = 0.87962566103423978


def mlp_weights(widths: Sequence[int], gen: torch.Generator,
                device: torch.device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """[(weight [out, in], bias [out])] of a `widths[0] -> ... -> widths[-1]`
    MLP: lecun-scaled normals clipped at two deviations, drawn in one call
    on `gen`'s device; zero biases."""
    shapes = [(b, a) for a, b in zip(widths[:-1], widths[1:])]
    flat = torch.randn(sum(o * i for o, i in shapes), generator=gen, device=device)
    flat = torch.clamp(flat, -2.0, 2.0)
    out, at = [], 0
    for o, i in shapes:
        w = flat[at:at + o * i].view(o, i) * (1.0 / math.sqrt(i) / _TRUNC_STD)
        out.append((w, torch.zeros(o, device=device)))
        at += o * i
    return out


@torch.no_grad()
def load_mlp(layers, weights) -> None:
    """Copy `weights` into a ModuleList of `nn.Linear` in place (the
    parameters keep their addresses)."""
    if len(layers) != len(weights):
        raise ValueError(f"{len(layers)} layers, {len(weights)} weight pairs")
    for layer, (w, b) in zip(layers, weights):
        layer.weight.copy_(w)
        layer.bias.copy_(b)


def widths_of(layers) -> list:
    return [layers[0].in_features] + [layer.out_features for layer in layers]
