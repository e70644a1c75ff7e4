"""Standalone two-agent CBF-QP demo (ECC'25).

Two kinematic-bicycle agents overtake or bypass each other (the original
SigmaRL's `cbf.py`): agent i filters its nominal action through a degree-2
CBF-QP whose barrier is a safety margin between the vehicles, of one of
three kinds:

- "c2c": centre-to-centre distance squared minus a conservative radius
  sum squared;
- "mtv": the learned MTV safety-margin network (`sm_predictor.py`);
- "grid": the rectangle-outline distance, the least distance from the
  other vehicle's outline points (corners and side midpoints, in the ego
  frame) to the ego rectangle's outline, minus a buffer.

The CBF condition is psi2 = h'' + 2 alpha h' + alpha^2 h >= 0, affine in
the ego input u = (acceleration, steering rate). h', h'' and the
coefficient of u come from `torch.func`: first derivatives of h in both
states with `grad(argnums=(0, 1))`, the second through a `grad` of that,
and the input matrix with `jacfwd`. Each step's 2-D QP has the closed form
of `hocbf_taylor._solve_single_constraint_qp`. A run is a Python loop over
the time steps on one device, with one copy to the host at its end.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from sigmarl_tpu_torch.constants import AGENTS
from sigmarl_tpu_torch.core.dynamics import BicycleParams
from sigmarl_tpu_torch.core.dynamics import step as bicycle_step
from sigmarl_tpu_torch.core.geometry import angle_eliminate_two_pi
from sigmarl_tpu_torch.device import resolve_device
from sigmarl_tpu_torch.rl.networks import PolicyNet, policy_from_jax_params, tanh_normal_mode
from sigmarl_tpu_torch.rl.optim import Adam
from sigmarl_tpu_torch.safety.hocbf_taylor import _solve_single_constraint_qp
from sigmarl_tpu_torch.safety.sm_predictor import SafetyMarginEstimatorModule

Tensor = torch.Tensor


@dataclass(frozen=True)
class CBFDemoConfig:
    scenario: str = "overtaking"  # {"overtaking", "bypassing"}
    sm_type: str = "c2c"  # {"c2c", "mtv", "grid"}
    # Nominal controller: "scripted" (speed tracking + lane-centering PD) or
    # "rl", a PolicyNet on the demo's 9-feature observation; pass it to
    # `run_demo(rl_policy_params=...)`.
    nominal: str = "scripted"
    # Whether agent j is CBF-filtered too. None = True exactly for the RL
    # bypassing combination (the original's RL bypassing scenario drives j
    # by its own greedy policy with CBF verification; with j blind the
    # head-on scenario is infeasible for a bounded ego policy); scripted
    # runs keep j unfiltered at constant speed.
    filter_other: bool | None = None
    dt: float = 0.05
    num_steps: int = 200
    # Class-K gain; < 0 picks the scenario's default (2 for overtaking, 1
    # for the head-on bypassing, where only the ego is filtered).
    alpha: float = -1.0
    length: float = 0.16
    width: float = 0.08
    ego_speed: float = 0.7
    other_speed: float = 0.3
    # Strict-separation buffer of the "grid" margin (an outline distance is
    # >= 0 by construction, so the barrier holds h = d - buffer > 0).
    grid_safety_buffer: float = 0.01


_RL_N_POINTS_REF = 3  # points on the short-term reference path


def _initial_states(cfg: CBFDemoConfig, dev) -> tuple:
    """Ego behind (overtaking) or facing (bypassing) the other agent:
    states (x, y, psi, v, steering)."""
    ego = [0.0, 0.0, 0.0, cfg.ego_speed, 0.0]
    if cfg.scenario == "overtaking":
        other = [0.6, 0.0, 0.0, cfg.other_speed, 0.0]
    else:  # bypassing: the other drives toward the ego
        other = [2.0, 0.02, math.pi, cfg.other_speed, 0.0]
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    return f(ego), f(other)


def _action_box(dev):
    low = torch.tensor([AGENTS["min_speed"], AGENTS["min_steering"]], device=dev)
    high = torch.tensor([AGENTS["max_speed"], AGENTS["max_steering"]], device=dev)
    return low, high


def rl_observation(cfg: CBFDemoConfig, state: Tensor) -> Tensor:
    """The demo's 9-feature RL observation of states [..., 5]: [v / v_max,
    steering / steering_max, 3 ego-view reference points / (n_ref *
    spacing), d_ref / (2 width)]. The reference path is the lane centre
    (y = 0) sampled at `length` spacing ahead of the agent."""
    spacing = cfg.length
    k = torch.arange(1, _RL_N_POINTS_REF + 1, dtype=state.dtype, device=state.device)
    xs = state[..., 0:1] + k * spacing  # [..., 3]
    vx, vy = xs - state[..., 0:1], -state[..., 1:2]
    ang = torch.atan2(vy, vx) - state[..., 2:3]
    norm = torch.sqrt(vx * vx + vy * vy)
    ego_view = torch.stack([norm * torch.cos(ang), norm * torch.sin(ang)], dim=-1)
    norm_pos = spacing * _RL_N_POINTS_REF
    return torch.cat([
        state[..., 3:4] / AGENTS["max_speed"],
        state[..., 4:5] / AGENTS["max_steering"],
        (ego_view / norm_pos).flatten(-2),
        torch.abs(state[..., 1:2]) / (cfg.width * 2),
    ], dim=-1)


def sample_bc_states(generator: torch.Generator, n: int, dev) -> Tensor:
    """States [n, 5] covering the envelope the filter can push the ego
    into: x in [0, 3), y in [-0.3, 0.3), psi in [-pi, pi), v in [-0.5, 1),
    steering in [-2.5, 2.5)."""
    u = torch.rand((5, n), generator=generator, device=dev)
    lo = torch.tensor([0.0, -0.3, -math.pi, -0.5, -2.5], device=dev)[:, None]
    hi = torch.tensor([3.0, 0.3, math.pi, 1.0, 2.5], device=dev)[:, None]
    return (lo + u * (hi - lo)).T


def fit_rl_nominal(
    cfg: CBFDemoConfig,
    generator: Optional[torch.Generator] = None,
    n_steps: int = 400,
    device=None,
    init_policy: Optional[PolicyNet] = None,
    states: Optional[List[Tensor]] = None,
):
    """A PolicyNet for the demo's RL nominal controller, fitted to the
    scripted lane tracker's (speed, steering) targets over sampled demo
    states (the original loads a released goal-reaching checkpoint; nothing
    is downloaded here): Adam at 3e-3 on the pre-squash regression, 256
    states per step. The states of each step (`states`, [256, 5] each) and
    the initial weights may be given; otherwise they come from `generator`
    and `PolicyNet(seed=0)`. Returns (policy, last loss)."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    policy = init_policy.to(dev) if init_policy is not None else PolicyNet(9, 2, device=dev)
    low, high = _action_box(dev)
    mid, half = (high + low) / 2, (high - low) / 2
    params = list(policy.parameters())
    opt = Adam(3e-3)
    state = opt.init(params)
    loss = torch.tensor(float("inf"))
    for i in range(n_steps):
        s = states[i].to(dev) if states is not None else sample_bc_states(gen, 256, dev)
        obs = rl_observation(cfg, s)
        tgt = torch.stack([
            torch.full_like(s[:, 0], cfg.ego_speed),
            torch.clamp(-2.0 * s[:, 1] - 2.0 * s[:, 2], AGENTS["min_steering"],
                        AGENTS["max_steering"]),
        ], dim=-1)
        # Regress in pre-squash space: the MSE of squashed actions has a
        # vanishing gradient once tanh saturates; the target is the exact
        # inverse of `tanh_normal_mode`.
        z = torch.atanh(torch.clamp((tgt - mid) / half, -0.995, 0.995))
        loc, scale = policy(obs)
        loc_c = 5.0 * torch.tanh(loc / 5.0)
        loss = torch.mean((loc_c - z) ** 2) + torch.mean(scale**2) * 1e-3
        state = opt.step(params, torch.autograd.grad(loss, params), state)
    return policy, float(loss.detach())


def run_demo(
    cfg: CBFDemoConfig,
    sm_module: SafetyMarginEstimatorModule | None = None,
    rl_policy_params: PolicyNet | Mapping | None = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Simulate the two-agent scenario with the ego's CBF-QP filter on
    `device` (`cuda` unless the caller passes `device="cpu"`). The RL
    nominal controller takes a `PolicyNet` or a flax parameter tree.
    Returns the trajectory (ego and other states [T, 5], h [T], u and u_nom
    [T, 2]) as numpy, with h_min and collided."""
    dev = resolve_device(device)
    bp = BicycleParams(l_f=cfg.length / 2 * 0.5, l_r=cfg.length / 2 * 0.5)
    dt = cfg.dt
    alpha = cfg.alpha if cfg.alpha > 0 else (2.0 if cfg.scenario == "overtaking" else 1.0)
    r_sum = float(np.hypot(cfg.length, cfg.width))  # conservative c2c radius sum

    use_mtv = cfg.sm_type == "mtv" and sm_module is not None and sm_module.net is not None
    use_grid = cfg.sm_type == "grid"
    if cfg.nominal == "rl" and rl_policy_params is None:
        raise ValueError("nominal='rl' needs rl_policy_params (see fit_rl_nominal)")
    policy = None
    if cfg.nominal == "rl":
        policy = (rl_policy_params.to(dev) if isinstance(rl_policy_params, torch.nn.Module)
                  else policy_from_jax_params(rl_policy_params, device=dev))
    filter_other = cfg.filter_other
    if filter_other is None:
        filter_other = policy is not None and cfg.scenario == "bypassing"

    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    lh, wh = cfg.length / 2, cfg.width / 2
    # Outline sample points (4 corners + 1 midpoint per side) and the ego
    # outline as a closed polyline.
    outline = f32([[lh, wh], [lh, -wh], [-lh, -wh], [-lh, wh],
                   [lh, 0.0], [0.0, -wh], [-lh, 0.0], [0.0, wh]])  # [8, 2]
    ego_poly = f32([[lh, wh], [lh, -wh], [-lh, -wh], [-lh, wh], [lh, wh]])  # [5, 2]
    starts, vecs = ego_poly[:-1], ego_poly[1:] - ego_poly[:-1]
    len2 = (vecs * vecs).sum(-1)

    def outline_distance(x_rel, y_rel, psi_rel):
        c, s = torch.cos(psi_rel), torch.sin(psi_rel)
        pts = torch.stack([outline[:, 0] * c - outline[:, 1] * s + x_rel,
                           outline[:, 0] * s + outline[:, 1] * c + y_rel], dim=-1)  # [8, 2]
        rel = pts[:, None, :] - starts[None]  # [8, 4, 2]
        t = torch.clamp((rel * vecs[None]).sum(-1) / len2, 0.0, 1.0)
        closest = starts[None] + vecs[None] * t[..., None]
        diff = pts[:, None, :] - closest
        return torch.sqrt((diff * diff).sum(-1)).min()

    def h_of(ego, other):
        """Safety margin h(ego state, other state)."""
        rel = other[0:2] - ego[0:2]
        if use_mtv or use_grid:
            # Relative pose in the ego frame.
            c, s = torch.cos(ego[2]), torch.sin(ego[2])
            x_rel = c * rel[0] + s * rel[1]
            y_rel = -s * rel[0] + c * rel[1]
            psi_rel = angle_eliminate_two_pi(other[2] - ego[2])
            if use_grid:
                return outline_distance(x_rel, y_rel, psi_rel) - cfg.grid_safety_buffer
            return sm_module.predict(torch.stack([x_rel, y_rel, psi_rel]))
        return (rel * rel).sum() - r_sum * r_sum

    def dyn(state, u):
        beta = torch.atan(bp.l_r / bp.l_wb * torch.tan(state[4]))
        return torch.stack([
            state[3] * torch.cos(state[2] + beta),
            state[3] * torch.sin(state[2] + beta),
            state[3] / bp.l_wb * torch.tan(state[4]) * torch.cos(beta),
            u[0],
            u[1],
        ])

    u0 = torch.zeros(2, device=dev)
    grad_h = torch.func.grad(h_of, argnums=(0, 1))

    def h_dot_fn(ego, other):
        gh_e, gh_o = grad_h(ego, other)
        return gh_e @ dyn(ego, u0) + gh_o @ dyn(other, u0)

    grad_h_dot = torch.func.grad(h_dot_fn, argnums=(0, 1))
    low, high = _action_box(dev)
    u_lo, u_hi = f32([-4.0, -math.pi]), f32([4.0, math.pi])
    Q = 2 * torch.diag(f32([10.0, 1.0]))

    def rl_u_nom(state_vec):
        # The policy's deterministic (speed, steering) targets converted to
        # (acceleration, steering rate).
        with torch.no_grad():
            loc, _ = policy(rl_observation(cfg, state_vec)[None])
        tgt = tanh_normal_mode(loc, low, high)[0]
        return torch.stack([torch.clamp((tgt[0] - state_vec[3]) / dt, -4.0, 4.0),
                            torch.clamp((tgt[1] - state_vec[4]) / dt, -math.pi, math.pi)])

    def solve(u_nom, g, c):
        u = _solve_single_constraint_qp(Q, -Q @ u_nom, g, c)
        return torch.minimum(torch.maximum(u, u_lo), u_hi)

    ego, other = _initial_states(cfg, dev)
    traj = {k: [] for k in ("ego", "other", "h", "u", "u_nom")}
    for _ in range(cfg.num_steps):
        # h, h' and the affine decomposition of h'' in u (the other agent
        # holds its input at 0).
        gh_e, gh_o = grad_h(ego, other)
        f_e, f_o = dyn(ego, u0), dyn(other, u0)
        h = h_of(ego, other)
        h_dot = gh_e @ f_e + gh_o @ f_o
        # h'' = d(h')/d(ego) . dyn(ego, u) + d(h')/d(other) . f_o, and
        # dyn(ego, u) = f_e + B u, so h'' = c_ddh + (B^T hd_e) . u.
        hd_e, hd_o = grad_h_dot(ego, other)
        B = torch.func.jacfwd(lambda u: dyn(ego, u))(u0)  # [5, 2]
        g = B.T @ hd_e
        c = hd_e @ f_e + hd_o @ f_o + 2 * alpha * h_dot + alpha * alpha * h
        if policy is not None:
            u_nom = rl_u_nom(ego)
        else:
            # Track the target speed along x, steer to y = 0.
            u_nom = torch.stack([
                torch.clamp((cfg.ego_speed - ego[3]) / dt, -4.0, 4.0),
                torch.clamp((-2.0 * ego[1] - 2.0 * angle_eliminate_two_pi(ego[2]) - ego[4]) / dt,
                            -math.pi, math.pi),
            ])
        u = solve(u_nom, g, c)

        if filter_other:
            # Agent j: its nominal and its own CBF check. j's lane runs in
            # -x; the world rotated by pi maps it onto the policy's +x
            # convention (the dynamics and the lane task are equivariant
            # under the rotation; speed and steering targets are invariant).
            other_rot = torch.stack([-other[0], -other[1],
                                     angle_eliminate_two_pi(other[2] - math.pi),
                                     other[3], other[4]])
            if policy is not None:
                u_nom_j = rl_u_nom(other_rot)
            else:
                u_nom_j = torch.stack([
                    torch.clamp((cfg.other_speed - other[3]) / dt, -4.0, 4.0),
                    torch.clamp((-2.0 * other_rot[1] - 2.0 * other_rot[2] - other[4]) / dt,
                                -math.pi, math.pi),
                ])
            # j's one-sided psi2 condition: its control enters through dyn(other).
            B_j = torch.func.jacfwd(lambda uu: dyn(other, uu))(u0)
            u_j = solve(u_nom_j, B_j.T @ hd_o, c)
        else:
            u_j = u0

        for k, v in (("ego", ego), ("other", other), ("h", h), ("u", u), ("u_nom", u_nom)):
            traj[k].append(v.detach())
        ego = bicycle_step(bp, ego, u, dt)[0].detach()
        other = bicycle_step(bp, other, u_j, dt)[0].detach()

    out = {k: torch.stack(v).cpu().numpy() for k, v in traj.items()}
    out["h_min"] = float(out["h"].min())
    out["collided"] = bool(out["h"].min() < 0)
    return out


def animate_demo(traj: Dict[str, np.ndarray], cfg: CBFDemoConfig, out_file: str,
                 fps: int = 20) -> str:
    """mp4 animation of a demo run: both vehicle footprints, trails and a
    live h(t) readout (at most about 200 frames). Needs matplotlib and
    OpenCV."""
    from sigmarl_tpu_torch.render import _require, pyplot

    plt, cv2 = pyplot(), _require("cv2")
    ego, other, h = (np.asarray(traj[k]) for k in ("ego", "other", "h"))
    T = ego.shape[0]
    lh, wh = cfg.length / 2, cfg.width / 2
    local = np.array([[lh, wh], [lh, -wh], [-lh, -wh], [-lh, wh]])
    xs = np.concatenate([ego[:, 0], other[:, 0]])
    ys = np.concatenate([ego[:, 1], other[:, 1]])
    xlim, ylim = (xs.min() - 0.3, xs.max() + 0.3), (ys.min() - 0.3, ys.max() + 0.3)
    writer = None
    for k in range(0, T, max(1, T // 200)):
        fig, ax = plt.subplots(figsize=(6, 4), dpi=100)
        for state, color in ((ego[k], "tab:blue"), (other[k], "tab:red")):
            c, s = np.cos(state[2]), np.sin(state[2])
            R = np.array([[c, -s], [s, c]])
            ax.add_patch(plt.Polygon(local @ R.T + state[0:2], closed=True, facecolor=color,
                                     alpha=0.8, edgecolor="k", lw=0.5))
        ax.plot(ego[: k + 1, 0], ego[: k + 1, 1], "tab:blue", lw=0.8)
        ax.plot(other[: k + 1, 0], other[: k + 1, 1], "tab:red", lw=0.8)
        ax.set_xlim(*xlim)
        ax.set_ylim(*ylim)
        ax.set_aspect("equal")
        ax.set_title(f"{cfg.scenario}/{cfg.sm_type}  t={k * cfg.dt:.2f}s  h={h[k]:+.3f}",
                     fontsize=9)
        fig.tight_layout()
        fig.canvas.draw()
        frame = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        plt.close(fig)
        if writer is None:
            hgt, wdt = frame.shape[:2]
            writer = cv2.VideoWriter(out_file, cv2.VideoWriter_fourcc(*"mp4v"), fps, (wdt, hgt))
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    if writer is not None:
        writer.release()
    return out_file


def plot_demo(traj: Dict[str, np.ndarray], cfg: CBFDemoConfig, out_file: str) -> str:
    """Figure of one demo run: trajectory footprints, the barrier h(t), and
    the nominal against the filtered inputs. Needs matplotlib."""
    from sigmarl_tpu_torch.render import pyplot

    plt = pyplot()
    ego, other, h, u, u_nom = (np.asarray(traj[k]) for k in ("ego", "other", "h", "u", "u_nom"))
    T = ego.shape[0]
    t = np.arange(T) * cfg.dt
    fig, axes = plt.subplots(3, 1, figsize=(7, 8), dpi=120)
    ax = axes[0]
    lh, wh = cfg.length / 2, cfg.width / 2
    local = np.array([[lh, wh], [lh, -wh], [-lh, -wh], [-lh, wh]])
    for k in range(0, T, max(1, T // 20)):
        for state, color in ((ego[k], "tab:blue"), (other[k], "tab:red")):
            c, s = np.cos(state[2]), np.sin(state[2])
            R = np.array([[c, -s], [s, c]])
            ax.add_patch(plt.Polygon(local @ R.T + state[0:2], closed=True, facecolor=color,
                                     alpha=0.1 + 0.5 * k / T, edgecolor="none"))
    ax.plot(ego[:, 0], ego[:, 1], "tab:blue", lw=0.8, label="ego")
    ax.plot(other[:, 0], other[:, 1], "tab:red", lw=0.8, label="other")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=7)
    ax.set_title(f"{cfg.scenario} / {cfg.sm_type}")
    ax = axes[1]
    ax.plot(t, h, "k")
    ax.axhline(0.0, color="tab:red", lw=0.8, linestyle="--")
    ax.set_ylabel("h(t)")
    ax = axes[2]
    ax.plot(t, u_nom[:, 0], "tab:blue", linestyle="--", lw=0.8, label="a nominal")
    ax.plot(t, u[:, 0], "tab:blue", lw=1.0, label="a filtered")
    ax.plot(t, u_nom[:, 1], "tab:red", linestyle="--", lw=0.8, label="ddelta nominal")
    ax.plot(t, u[:, 1], "tab:red", lw=1.0, label="ddelta filtered")
    ax.legend(fontsize=7, ncol=2)
    ax.set_xlabel("t [s]")
    ax.set_ylabel("u")
    fig.tight_layout()
    fig.savefig(out_file)
    plt.close(fig)
    return out_file
