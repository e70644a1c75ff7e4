"""Truncated-Taylor CBF vs standard HOCBF experiments (LCSS'25).

A point-mass agent avoids a circular obstacle with its control input at
relative degree 1 (velocity), 2 (acceleration) or 3 (jerk); the cascaded
HOCBF conditions (gains lambda_1..lambda_3) are compared with the
single-gain truncated-Taylor condition (the Taylor expansion of h over
dt), as in the original SigmaRL's `hocbf_taylor.py`.

Each step's QP is two-dimensional with one affine CBF inequality, so it
has a closed-form KKT solution (`_solve_single_constraint_qp`, batched and
branch-free). A parameter sweep is one batched simulation over the
flattened (lambda_1, dt) grid: a Python loop over the time steps, each
step a batched tensor operation; `dt` is a per-cell tensor, so every cell
runs the same number of steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from sigmarl_tpu_torch.device import resolve_device

Tensor = torch.Tensor


@dataclass(frozen=True)
class HOCBFConfig:
    """Experiment configuration (the original `HOCBF.__init__`)."""

    relative_degree: int = 2
    approach: str = "taylor"  # {"taylor", "hocbf"}
    num_steps: int = 200
    dt: float = 0.01
    is_virtual_control: bool = False
    lambda_1: float = 0.5
    lambda_2: float = 1.0
    lambda_3: float = 1.0
    # Scenario constants
    p_x0: float = -10.0
    p_y0: float = 0.0
    v_x0: float = 10.0
    v_y0: float = 0.0
    x_obs: float = 0.0
    y_obs: float = -2.2
    ra: float = 1.0
    ro: float = 2.0
    u_x_nominal: float = 5.0
    u_y_nominal: float = 0.0

    @property
    def radii_sqr(self) -> float:
        return (self.ra + self.ro) ** 2


def check_initial_conditions(cfg: HOCBFConfig) -> bool:
    """Feasibility of the initial state."""
    h0 = (cfg.p_x0 - cfg.x_obs) ** 2 + (cfg.p_y0 - cfg.y_obs) ** 2 - cfg.radii_sqr
    dh0 = 2 * (cfg.p_x0 - cfg.x_obs) * cfg.v_x0 + 2 * (cfg.p_y0 - cfg.y_obs) * cfg.v_y0
    if cfg.approach == "taylor":
        return h0 >= 0
    if cfg.relative_degree == 1:
        return h0 >= 0
    psi1 = dh0 + cfg.lambda_1 * h0
    if cfg.relative_degree == 2:
        return h0 >= 0 and psi1 >= 0
    ddh0 = 2 * cfg.v_x0**2 + 2 * cfg.v_y0**2  # zero initial acceleration
    psi2 = (ddh0 + cfg.lambda_1 * dh0) + cfg.lambda_2 * psi1
    return h0 >= 0 and psi1 >= 0 and psi2 >= 0


def _solve_single_constraint_qp(Q: Tensor, q: Tensor, g: Tensor, c: Tensor) -> Tensor:
    """Closed-form solve of min 1/2 u'Qu + q'u  s.t.  g.u + c >= 0 in 2-D,
    batched: Q [..., 2, 2], q and g [..., 2], c [...]; returns u [..., 2].

    KKT: the unconstrained u* = -Q^-1 q, moved along Q^-1 g by the
    multiplier max(0, -(g.u* + c)) / (g Q^-1 g), which is zero where u*
    is feasible. The argmin is invariant to jointly scaling (Q, q), so both
    are normalized first: at relative degree 3 the raw entries are O(dt^6)
    and would underflow a float32 inverse.
    """
    s = 1.0 / torch.clamp(Q.abs().flatten(-2).amax(-1), min=1e-30)
    Q = Q * s[..., None, None]
    q = q * s[..., None]
    Qinv = _inv2(Q)
    # Two-term products written out (no matmul), so that every device
    # rounds them alike.
    u_free = -_mv(Qinv, q)
    r = _dot(g, u_free) + c
    gQ = _mv(Qinv.transpose(-1, -2), g)  # g^T Q^-1
    mu = torch.clamp(-r, min=0.0) / torch.clamp(_dot(gQ, g), min=1e-12)
    return u_free + mu[..., None] * _mv(Qinv, g)


def _dot(x: Tensor, y: Tensor) -> Tensor:
    return x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1]


def _mv(M: Tensor, v: Tensor) -> Tensor:
    return torch.stack([_dot(M[..., 0, :], v), _dot(M[..., 1, :], v)], -1)


def _inv2(Q: Tensor) -> Tensor:
    """Inverse of symmetric positive definite 2x2 matrices [..., 2, 2] by
    Gaussian elimination (an LU factorization; q_11 > 0, so no pivoting),
    as a linear-algebra library's inverse computes it: exactly 1 / q_ii on
    a diagonal matrix."""
    a, b, c, d = Q[..., 0, 0], Q[..., 0, 1], Q[..., 1, 0], Q[..., 1, 1]
    ell = c / a
    u22 = d - ell * b
    # The columns of Q^-1 from L U x = e_k.
    x2_1 = -ell / u22
    x2_2 = 1.0 / u22
    return torch.stack([torch.stack([(1.0 - b * x2_1) / a, (0.0 - b * x2_2) / a], -1),
                        torch.stack([x2_1, x2_2], -1)], -2)


def _pair(x: Tensor, y: Tensor) -> Tensor:
    return torch.stack([x, y], -1)


def _diag(q11: Tensor, q22: Tensor) -> Tensor:
    zero = torch.zeros_like(q11)
    return torch.stack([torch.stack([q11, zero], -1), torch.stack([zero, q22], -1)], -2)


def run_simulation(
    cfg: HOCBFConfig, lambda_1=None, lambda_2=None, dt=None, device=None
) -> Dict[str, Tensor]:
    """Simulate one run, or a batch of runs where `lambda_1`, `lambda_2`
    or `dt` is a tensor (cells of a sweep; they broadcast together), on
    `device` (`cuda` unless the caller passes `device="cpu"`).

    Returns the trajectory [num_steps, ...] of px, py, vx, vy, h, active
    and u ([..., 2]), with h_min, collided and activation_rate per run.
    """
    dev = resolve_device(device)

    def param(v, default):
        return torch.as_tensor(default if v is None else v, dtype=torch.float32, device=dev)

    lam1, lam2, dt_ = param(lambda_1, cfg.lambda_1), param(lambda_2, cfg.lambda_2), param(dt, cfg.dt)
    shape = torch.broadcast_shapes(lam1.shape, lam2.shape, dt_.shape)
    lam1, lam2, dt_ = (x.expand(shape) for x in (lam1, lam2, dt_))
    lam3 = cfg.lambda_3
    deg, appr = cfg.relative_degree, cfg.approach.lower()
    accel = deg == 2 or (deg == 1 and cfg.is_virtual_control)
    u_lim = {1: 20.0, 2: 1000.0, 3: 10.0}[deg]

    def full(v):
        return torch.full(shape, float(v), dtype=torch.float32, device=dev)

    px, py, vx, vy = full(cfg.p_x0), full(cfg.p_y0), full(cfg.v_x0), full(cfg.v_y0)
    ax, ay = full(0.0), full(0.0)
    traj = {k: [] for k in ("px", "py", "vx", "vy", "h", "active", "u")}
    for _ in range(cfg.num_steps):
        rx, ry = px - cfg.x_obs, py - cfg.y_obs
        h = rx * rx + ry * ry - cfg.radii_sqr
        # The CBF condition, affine in u: g . u + c >= 0.
        if deg == 1 and not cfg.is_virtual_control:
            # u is the velocity command.
            g = 2 * _pair(rx, ry)
            c = lam1 * h
            if appr != "hocbf":
                g = g * dt_[..., None]
            # Cost: (u_x - vxt)^2 + (u_y - vyt)^2 + 1000 (py + u_y dt - pyt)^2
            Q = 2 * _diag(full(1.0), 1.0 + 1000.0 * dt_ * dt_)
            q = _pair(full(-2 * cfg.v_x0), -2 * cfg.v_y0 + 2000.0 * dt_ * (py - 0.0))
        elif accel:
            # u is the (virtual) acceleration.
            dh = 2 * (rx * vx + ry * vy)
            g_dd = 2 * _pair(rx, ry)  # dd_h = 2(vx^2 + vy^2) + g_dd . u
            c_dd = 2 * (vx * vx + vy * vy)
            if appr == "hocbf":
                g = g_dd
                c = c_dd + (lam1 + lam2) * dh + lam1 * lam2 * h
            else:
                g = (0.5 * dt_ * dt_)[..., None] * g_dd
                c = lam1 * h + dh * dt_ + 0.5 * dt_ * dt_ * c_dd
            # Cost over the predicted next speed and y position:
            #   (vx + ux dt - vxt)^2 + (vy + uy dt - vyt)^2
            # + 1000 (py + vy dt + 1/2 uy dt^2 - pyt)^2
            a, b = dt_, 0.5 * dt_ * dt_
            Q = 2 * _diag(a * a, a * a + 1000.0 * b * b)
            q = _pair(2 * a * (vx - cfg.v_x0),
                      2 * a * (vy - cfg.v_y0) + 2000.0 * b * (py + vy * dt_))
        else:  # deg == 3: u is the jerk
            dh = 2 * (rx * vx + ry * vy)
            ddh = 2 * (vx * vx + rx * ax) + 2 * (vy * vy + ry * ay)
            g_ddd = 2 * _pair(rx, ry)
            c_ddd = 2 * (3 * vx * ax) + 2 * (3 * vy * ay)
            if appr == "hocbf":
                g = g_ddd
                c = (c_ddd + (lam1 + lam2 + lam3) * ddh
                     + (lam1 * lam2 + lam1 * lam3 + lam2 * lam3) * dh + lam1 * lam2 * lam3 * h)
            else:
                g = (dt_**3 / 6.0)[..., None] * g_ddd
                c = lam1 * h + dh * dt_ + 0.5 * dt_ * dt_ * ddh + (dt_**3 / 6.0) * c_ddd
            a, b = 0.5 * dt_ * dt_, 0.25 * dt_**3
            Q = 2 * _diag(a * a, a * a + 1000.0 * b * b)
            q = _pair(2 * a * (vx + ax * dt_ - cfg.v_x0),
                      2 * a * (vy + ay * dt_ - cfg.v_y0)
                      + 2000.0 * b * (py + vy * dt_ + 0.5 * ay * dt_ * dt_))

        u = _solve_single_constraint_qp(Q, q, g, c)
        # Actuator boxes, enforced after the QP (the original defines them
        # but leaves most out of its QP; without them the deadbeat cost gains
        # make the degree-3 closed loop blow up).
        u = torch.clamp(u, -u_lim, u_lim)
        active = torch.abs(_dot(g, u) + c) <= 1e-6
        for k, v in (("px", px), ("py", py), ("vx", vx), ("vy", vy), ("h", h),
                     ("active", active), ("u", u)):
            traj[k].append(v)

        # Explicit integration as in the original.
        if deg == 1 and not cfg.is_virtual_control:
            vx_n, vy_n = u[..., 0], u[..., 1]
            px, py = px + vx_n * dt_, py + vy_n * dt_
            ax, ay = full(0.0), full(0.0)
        elif accel:
            ax, ay = u[..., 0], u[..., 1]
            vx_n, vy_n = vx + ax * dt_, vy + ay * dt_
            px = px + (vx + vx_n) / 2 * dt_
            py = py + (vy + vy_n) / 2 * dt_
        else:
            ax_n, ay_n = ax + u[..., 0] * dt_, ay + u[..., 1] * dt_
            vx_n, vy_n = vx + (ax + ax_n) / 2 * dt_, vy + (ay + ay_n) / 2 * dt_
            px = px + (vx + vx_n) / 2 * dt_
            py = py + (vy + vy_n) / 2 * dt_
            ax, ay = ax_n, ay_n
        vx, vy = vx_n, vy_n

    out = {k: torch.stack(v) for k, v in traj.items()}
    out["h_min"] = out["h"].amin(0)
    out["collided"] = out["h_min"] < 0
    out["activation_rate"] = out["active"].to(torch.float32).mean(0)
    return out


def run_experiment_multi_parameters(
    cfg: HOCBFConfig, lambda_1_values, dt_values, device=None
) -> Dict[str, np.ndarray]:
    """Sweep the (lambda_1 x dt) grid as one batched simulation over its
    flattened cells. Returns [n_lambda, n_dt] arrays of lambda_1, dt, min h,
    the collision flag and the CBF activation rate."""
    dev = resolve_device(device)
    l1 = torch.as_tensor(np.asarray(lambda_1_values), dtype=torch.float32, device=dev)
    dts = torch.as_tensor(np.asarray(dt_values), dtype=torch.float32, device=dev)
    L1, DT = torch.meshgrid(l1, dts, indexing="ij")
    t = run_simulation(cfg, lambda_1=L1.reshape(-1), dt=DT.reshape(-1), device=dev)
    grid = lambda x: x.reshape(L1.shape).cpu().numpy()  # noqa: E731
    return {
        "lambda_1": grid(L1),
        "dt": grid(DT),
        "h_min": grid(t["h_min"]),
        "collided": grid(t["collided"]),
        "activation_rate": grid(t["activation_rate"]),
    }


def plot_heatmap(result: Dict[str, np.ndarray], save_path: str | None = None):
    """Safety heatmap (min h over the trajectory) over the (lambda, dt) grid."""
    from sigmarl_tpu_torch.render import pyplot

    plt = pyplot()
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.pcolormesh(
        result["dt"], result["lambda_1"], result["h_min"], shading="auto", cmap="RdYlGn"
    )
    fig.colorbar(im, label="min h over trajectory")
    ax.set_xlabel("dt [s]")
    ax.set_ylabel("lambda_1")
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig
