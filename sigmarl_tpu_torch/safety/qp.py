"""Batched small-QP solver for the CBF safety filter.

Per env the filter solves a QP over (u, slacks, lambdas). Every variable
except u is separable given u,

  min_{s>=0}            w_s s^2   s.t.  s >= -(r + h*lam)
  min_{lam in [0,1]}    w_l lam^2 (+ the slack cost above)

so slacks and lambdas are eliminated in closed form, leaving a
box-constrained minimization of a convex C^1 piecewise-quadratic in u only
(dimension 2N per env):

  F(u) = (u - u_nom)^T W (u - u_nom) + sum_c phi_c(a_c . u + b_c)

solved by a damped projected Newton method with a fixed iteration budget.
The whole solve runs in the CUDA kernel of `ops/qp.py`; this module holds
the constraint set, the row normalization and the closed-form phi terms.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _phi_candidates(r: Tensor, h: Tensor, ws: Tensor, wl: Tensor):
    """(value, lambda*) of the (s, lambda) elimination: the objective in
    lambda is convex piecewise-quadratic with breakpoint -r/h, so its
    minimum over [0, 1] is at one of {0, 1, clip(-r/h), clip(lam_stat)}."""
    h_safe = torch.where(torch.abs(h) > 1e-12, h, torch.ones_like(h))
    lam0 = torch.clamp(-r / h_safe, 0.0, 1.0)
    lam_stat = torch.clamp(-ws * h * r / (wl + ws * h * h), 0.0, 1.0)

    def g(lam):
        pen = torch.clamp(-(r + h * lam), min=0.0)
        return wl * lam * lam + ws * pen * pen

    lam_best = torch.zeros_like(r)
    vals = g(lam_best)
    for cand in (torch.ones_like(r), lam0, lam_stat):
        vk = g(cand)
        take = vk < vals
        vals = torch.where(take, vk, vals)
        lam_best = torch.where(take, cand, lam_best)
    return vals, lam_best


def _phi_terms(r: Tensor, h: Tensor, ws: Tensor, wl: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Value, first and second derivative (in r) of

        phi(r) = min_{lam in [0,1], s >= 0, s >= -(r + h lam)}  wl lam^2 + ws s^2.
    """
    vals, lam_best = _phi_candidates(r, h, ws, wl)
    pen = torch.clamp(-(r + h * lam_best), min=0.0)
    active = pen > 0
    # Envelope theorem: dphi/dr = -2 ws s*.
    dphi = -2.0 * ws * pen
    # Curvature by case: lambda* interior with s* > 0 -> 2 wl ws / (wl + ws h^2);
    # lambda* at 0 or 1 with s* > 0 -> 2 ws; inactive -> 0.
    interior = active & (lam_best > 0) & (lam_best < 1) & (torch.abs(h) > 1e-12)
    ddphi_int = 2.0 * wl * ws / (wl + ws * h * h)
    zero = torch.zeros_like(r)
    ddphi = torch.where(active, torch.where(interior, ddphi_int, 2.0 * ws), zero)
    return vals, dphi, ddphi


@dataclass
class StructuredConstraintSet:
    """Block-sparse constraint set: every row touches at most two agents'
    controls.

    Single-agent rows (lane + CLF): a . u_n + b + h*lam >= -s, shapes
    [B, N, Ks, ...]. Pair rows: ai . u_i + aj . u_j + b + h*lam >= -s,
    shapes [B, P, Kp, ...] with static pair index vectors (numpy, [P]).
    """

    A_s: Tensor  # [B, N, Ks, 2]
    b_s: Tensor  # [B, N, Ks]
    h_s: Tensor  # [B, N, Ks]
    ws_s: Tensor  # [B, N, Ks]
    wl_s: Tensor  # [B, N, Ks]
    valid_s: Tensor  # [B, N, Ks] bool
    A_pi: Tensor  # [B, P, Kp, 2]
    A_pj: Tensor  # [B, P, Kp, 2]
    b_p: Tensor  # [B, P, Kp]
    h_p: Tensor  # [B, P, Kp]
    ws_p: Tensor  # [B, P, Kp]
    wl_p: Tensor  # [B, P, Kp]
    valid_p: Tensor  # [B, P, Kp] bool
    pair_i: np.ndarray  # [P]
    pair_j: np.ndarray  # [P]


def _normalize_structured(cons: StructuredConstraintSet, ws_cap: float) -> StructuredConstraintSet:
    """Divide each row by its coefficient norm (an exact reformulation: the
    slack weight scales by the squared norm), capping the slack stiffness
    at `ws_cap`."""
    ns = torch.sqrt((cons.A_s * cons.A_s).sum(-1))
    ss = torch.clamp(ns, min=1e-6)
    np_ = torch.sqrt((cons.A_pi**2).sum(-1) + (cons.A_pj**2).sum(-1))
    sp = torch.clamp(np_, min=1e-6)
    return replace(
        cons,
        A_s=cons.A_s / ss[..., None],
        b_s=cons.b_s / ss,
        h_s=cons.h_s / ss,
        ws_s=torch.clamp(cons.ws_s * ss * ss, max=ws_cap),
        A_pi=cons.A_pi / sp[..., None],
        A_pj=cons.A_pj / sp[..., None],
        b_p=cons.b_p / sp,
        h_p=cons.h_p / sp,
        ws_p=torch.clamp(cons.ws_p * sp * sp, max=ws_cap),
    )


def pack_constraints(cons: StructuredConstraintSet, ws_cap: float):
    """Normalize and pack a constraint set into the solve kernel's layout:
    singles [B, 6, N*Ks] = (a_x, a_y, b, h, ws, wl) with row n*Ks + k, and
    pairs [B, 8, P*Kp] = (a_xi, a_yi, a_xj, a_yj, b, h, ws, wl) with row
    p*Kp + k. Invalid rows are encoded as ws = 0, where phi and its
    derivatives vanish identically."""
    c = _normalize_structured(cons, ws_cap)
    B, N, Ks = c.b_s.shape
    P, Kp = c.b_p.shape[1:]
    zero = torch.zeros((), dtype=c.ws_s.dtype, device=c.ws_s.device)
    singles = torch.stack(
        [c.A_s[..., 0], c.A_s[..., 1], c.b_s, c.h_s,
         torch.where(c.valid_s, c.ws_s, zero), c.wl_s], dim=1,
    ).reshape(B, 6, N * Ks)
    pairs = torch.stack(
        [c.A_pi[..., 0], c.A_pi[..., 1], c.A_pj[..., 0], c.A_pj[..., 1], c.b_p, c.h_p,
         torch.where(c.valid_p, c.ws_p, zero), c.wl_p], dim=1,
    ).reshape(B, 8, P * Kp)
    return singles.contiguous(), pairs.contiguous()


def kernel_inputs(
    cons: StructuredConstraintSet,
    u_nom: Tensor,  # [B, N, 2]
    u_lo: Tuple[float, float],
    u_hi: Tuple[float, float],
    u_init: Tensor | None = None,
    ws_cap: float = 3e6,
):
    """The solve kernel's tensor inputs: (singles, pairs, u0, u_init,
    u_nom, pair_i, pair_j) with controls as [B, 2N] (x block, then y
    block), the starts clipped into the box and the pair lists int32 on
    the controls' device."""
    singles, pairs = pack_constraints(cons, ws_cap)
    dev = u_nom.device
    lo = torch.tensor(u_lo, dtype=u_nom.dtype, device=dev)
    hi = torch.tensor(u_hi, dtype=u_nom.dtype, device=dev)

    def blocks(u, clip=True):
        if clip:
            u = torch.minimum(torch.maximum(u, lo), hi)
        return torch.cat([u[..., 0], u[..., 1]], dim=1).contiguous()

    u0 = blocks(u_nom)
    ui = u0 if u_init is None else blocks(u_init)
    pair_i = torch.as_tensor(np.asarray(cons.pair_i), dtype=torch.int32, device=dev)
    pair_j = torch.as_tensor(np.asarray(cons.pair_j), dtype=torch.int32, device=dev)
    return singles, pairs, u0, ui, blocks(u_nom, clip=False), pair_i, pair_j


def solve_structured_qp(
    cons: StructuredConstraintSet,
    u_nom: Tensor,  # [B, N, 2]
    w_u: Tuple[float, float],
    u_lo: Tuple[float, float],
    u_hi: Tuple[float, float],
    n_iters: int = 12,
    ridge: float = 1e-8,
    u_init: Tensor | None = None,
    ws_cap: float = 3e6,
    soft_iters: int = 0,
    soft_cap: float = 10.0,
) -> Tuple[Tensor, Tensor]:
    """Projected damped Newton on the eliminated QP in block-sparse form.

    The start is the better (in F) of clip(u_nom) and clip(u_init); then
    `soft_iters` stiffness-continuation iterations with the slack stiffness
    capped geometrically from `soft_cap` up to `ws_cap` (kept only where
    they lower the full objective), then `n_iters` full-stiffness
    iterations. Weights and bounds are per control component (accel,
    steering rate). Returns (u_star [B, N, 2], F(u_star) [B]).
    """
    from sigmarl_tpu_torch.ops.qp import newton_solve

    N = u_nom.shape[1]
    u, F = newton_solve(
        *kernel_inputs(cons, u_nom, u_lo, u_hi, u_init, ws_cap), w_u, u_lo, u_hi,
        n_iters=n_iters, ridge=ridge, soft_iters=soft_iters, soft_cap=soft_cap, ws_cap=ws_cap,
    )
    return torch.stack([u[:, :N], u[:, N:]], dim=-1), F
