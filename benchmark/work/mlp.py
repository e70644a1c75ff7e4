"""Tanh MLPs (the policy and the critic): a forward pass needs, per row
and layer of `i` inputs and `o` outputs, 2 i o operations for the
product, o for the bias and o for the activation; a backward pass twice
the forward's products (the gradients of inputs and weights)."""

from __future__ import annotations


def forward_flops(widths, rows: int) -> float:
    return float(rows * sum(2 * i * o + 2 * o for i, o in zip(widths[:-1], widths[1:])))


def train_flops(widths, rows: int) -> float:
    """Forward and backward: three times the forward's products."""
    return float(rows * sum(6 * i * o + 2 * o for i, o in zip(widths[:-1], widths[1:])))
