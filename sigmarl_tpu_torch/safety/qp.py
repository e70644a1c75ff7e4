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
the constraint set, the row normalization and the closed-form phi terms,
and a dense-form solve in plain PyTorch that the tests use as an oracle
(`ConstraintSet`, `solve_boxed_penalty_qp`, `eliminated_lambda`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

from sigmarl_tpu_torch.device import constant

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
class ConstraintSet:
    """M one-sided constraints per problem in dense form: a . u + b + h*lam
    >= -s. Shapes (leading batch dims allowed): A [..., M, d]; b, h,
    w_slack (slack penalty weight), w_lambda (lambda penalty weight; h = 0
    turns a row's lambda channel off) and valid (row mask) [..., M].
    The dense form is the oracle of the tests (`solve_boxed_penalty_qp`);
    the filter solves the structured form in the kernel."""

    A: Tensor
    b: Tensor
    h: Tensor
    w_slack: Tensor
    w_lambda: Tensor
    valid: Tensor


def solve_boxed_penalty_qp(
    cons: ConstraintSet,
    u_nom: Tensor,  # [..., d]
    w_u: Tensor,  # [d] diagonal tracking weights (cost: sum w_u (u - u_nom)^2)
    u_lo: Tensor,  # [d]
    u_hi: Tensor,  # [d]
    n_iters: int = 12,
    ridge: float = 1e-8,
) -> Tuple[Tensor, Tensor]:
    """Minimize F(u) over the box [u_lo, u_hi] by projected damped Newton on
    the dense form, from clip(u_nom). Each row is divided by its coefficient
    norm (the slack weight scaled by its square and capped at 3e6). Per
    iteration: the Gauss-Newton Hessian with the binding set pinned (a
    variable at a bound whose gradient points out), the outward components
    of the step removed, then a line search along the step (3 bisections
    on the sign of F' and 2 one-dimensional Newton steps, in [0, the first
    bound crossing capped at 4]), the clipped arc at 1 and 4 tried too, and
    the best candidate taken only where it lowers F. Returns (u_star
    [..., d], F(u_star) [...])."""
    d = u_nom.shape[-1]
    s = torch.clamp(torch.linalg.norm(cons.A, dim=-1), min=1e-6)
    A, b, h = cons.A / s[..., None], cons.b / s, cons.h / s
    ws = torch.clamp(cons.w_slack * s * s, max=3e6)
    wl, valid = cons.w_lambda, cons.valid
    zero = torch.zeros((), dtype=u_nom.dtype, device=u_nom.device)

    def residual(u):
        return torch.einsum("...md,...d->...m", A, u) + b

    def F_parts(u):
        val, dphi, ddphi = _phi_terms(residual(u), h, ws, wl)
        val, dphi, ddphi = (torch.where(valid, x, zero) for x in (val, dphi, ddphi))
        F = (w_u * (u - u_nom) ** 2).sum(-1) + val.sum(-1)
        grad = 2.0 * w_u * (u - u_nom) + torch.einsum("...md,...m->...d", A, dphi)
        return F, grad, ddphi

    eye = torch.eye(d, dtype=u_nom.dtype, device=u_nom.device)
    eps_b = 1e-6 * (u_hi - u_lo)

    def newton_step(u):
        F, grad, ddphi = F_parts(u)
        H = 2.0 * torch.diag(w_u) + torch.einsum("...md,...m,...me->...de", A, ddphi, A)
        H = H + ridge * eye
        at_lo, at_hi = u <= u_lo + eps_b, u >= u_hi - eps_b
        bind = (at_lo & (grad > 0)) | (at_hi & (grad < 0))
        free = (~bind).to(u.dtype)
        H = H * free[..., :, None] * free[..., None, :] + bind.to(u.dtype)[..., None] * eye
        step = torch.linalg.solve(H, -(grad * free)[..., None])[..., 0]
        step = torch.where((at_lo & (step < 0)) | (at_hi & (step > 0)), zero, step)

        big = torch.full((), 1e30, dtype=u.dtype, device=u.device)
        one = torch.ones((), dtype=u.dtype, device=u.device)
        pos, neg = step > 1e-30, step < -1e-30
        a_hi = torch.where(pos, (u_hi - u) / torch.where(pos, step, one), big)
        a_lo = torch.where(neg, (u_lo - u) / torch.where(neg, step, one), big)
        a_cap = torch.clamp(torch.clamp(torch.minimum(a_hi, a_lo).min(-1).values, max=4.0),
                            min=0.0)

        dr = torch.where(valid, torch.einsum("...md,...d->...m", A, step), zero)
        q1 = (2.0 * w_u * (u - u_nom) * step).sum(-1)
        q2 = (w_u * step * step).sum(-1)
        r0 = residual(u)

        def dF(alpha):
            _, dphi_a, ddphi_a = _phi_terms(r0 + alpha[..., None] * dr, h, ws, wl)
            dphi_a = torch.where(valid, dphi_a, zero)
            ddphi_a = torch.where(valid, ddphi_a, zero)
            return (q1 + 2.0 * q2 * alpha + (dphi_a * dr).sum(-1),
                    2.0 * q2 + (ddphi_a * dr * dr).sum(-1))

        g_cap = dF(a_cap)[0]
        lo_a, hi_a = torch.zeros_like(a_cap), a_cap
        for _ in range(3):
            mid = 0.5 * (lo_a + hi_a)
            up = dF(mid)[0] > 0
            hi_a = torch.where(up, mid, hi_a)
            lo_a = torch.where(up, lo_a, mid)
        alpha = 0.5 * (lo_a + hi_a)
        for _ in range(2):
            g1, g2d = dF(alpha)
            alpha = torch.minimum(torch.maximum(alpha - g1 / torch.clamp(g2d, min=1e-12), lo_a),
                                  hi_a)
        alpha = torch.where(g_cap <= 0, a_cap, alpha)

        best_u = torch.minimum(torch.maximum(u + alpha[..., None] * step, u_lo), u_hi)
        best_F = F_parts(best_u)[0]
        for a_arc in (1.0, 4.0):
            u_a = torch.minimum(torch.maximum(u + a_arc * step, u_lo), u_hi)
            F_a = F_parts(u_a)[0]
            take = F_a < best_F
            best_u = torch.where(take[..., None], u_a, best_u)
            best_F = torch.where(take, F_a, best_F)
        return torch.where((best_F < F)[..., None], best_u, u)

    u = torch.minimum(torch.maximum(u_nom, u_lo), u_hi)
    for _ in range(n_iters):
        u = newton_step(u)
    return u, F_parts(u)[0]


def eliminated_lambda(cons: ConstraintSet, u: Tensor) -> Tensor:
    """The optimal lambda of each constraint at u (diagnostics) [..., M]."""
    r = torch.einsum("...md,...d->...m", cons.A, u) + cons.b
    return _phi_candidates(r, cons.h, cons.w_slack, cons.w_lambda)[1]


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
    pair_idx: Tuple[Tensor, Tensor] | None = None,
):
    """The solve kernel's tensor inputs: (singles, pairs, u0, u_init,
    u_nom, pair_i, pair_j) with controls as [B, 2N] (x block, then y
    block), the starts clipped into the box and the pair lists int32 on
    the controls' device: `pair_idx` where the caller holds them there
    (the filter makes them once), else `device.constant`'s. Nothing here
    copies from host memory once those exist, so nothing waits for the
    card."""
    singles, pairs = pack_constraints(cons, ws_cap)

    def blocks(u, clip=True):
        x, y = u[..., 0], u[..., 1]
        if clip:
            x, y = torch.clamp(x, u_lo[0], u_hi[0]), torch.clamp(y, u_lo[1], u_hi[1])
        return torch.cat([x, y], dim=1).contiguous()

    u0 = blocks(u_nom)
    ui = u0 if u_init is None else blocks(u_init)
    if pair_idx is None:
        dev = u_nom.device
        pair_idx = tuple(constant(tuple(np.asarray(p).tolist()), torch.int32, dev)
                         for p in (cons.pair_i, cons.pair_j))
    return (singles, pairs, u0, ui, blocks(u_nom, clip=False)) + tuple(pair_idx)


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
    pair_idx: Tuple[Tensor, Tensor] | None = None,
) -> Tuple[Tensor, Tensor]:
    """Projected damped Newton on the eliminated QP in block-sparse form.

    The start is the better (in F) of clip(u_nom) and clip(u_init); then
    `soft_iters` stiffness-continuation iterations with the slack stiffness
    capped geometrically from `soft_cap` up to `ws_cap` (kept only where
    they lower the full objective), then `n_iters` full-stiffness
    iterations. Weights and bounds are per control component (accel,
    steering rate); `pair_idx` as in `kernel_inputs`. Returns (u_star
    [B, N, 2], F(u_star) [B]).
    """
    from sigmarl_tpu_torch.ops.qp import newton_solve

    N = u_nom.shape[1]
    u, F = newton_solve(
        *kernel_inputs(cons, u_nom, u_lo, u_hi, u_init, ws_cap, pair_idx), w_u, u_lo, u_hi,
        n_iters=n_iters, ridge=ridge, soft_iters=soft_iters, soft_cap=soft_cap, ws_cap=ws_cap,
    )
    return torch.stack([u[:, :N], u[:, N:]], dim=-1), F
