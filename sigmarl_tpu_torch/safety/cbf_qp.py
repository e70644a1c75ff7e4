"""Batched truncated-Taylor CBF-QP safety filter: centralized,
decentralized or grouped, or margins-only; RL or CLF nominal controller.

Per step, per env:
- vehicles are over-approximated by C circles (`circles.py`),
- lane barriers: h = pseudo-distance(circle center) - radius, with gradient
  (forward differences) and Hessian (central differences) from a 9-point
  stencil of the pseudo-distance field; the stencil's distances come from
  the CUDA kernel of `ops/boundary.py` over the top-k boundary chunks (or
  the chunks of a window around the closest boundary vertex, or every
  segment); `fp16_parity` runs the finite differences in float16,
- pairwise barriers: h = |p_i - p_j|^2 - (2r + buffer)^2 per circle pair,
- both turned into control-affine truncated-Taylor constraints over the
  horizon 2*dt via the closed-form circle-center kinematics,
- nominal controller: the RL action converted to (accel, steering rate),
  or a CLF P-controller on heading and speed with two relaxed CLF rows per
  agent in the QP,
- adaptive per-constraint class-K gain lambda in [0, 1] (a QP variable),
- solve (the CUDA kernel of `ops/qp.py`), fall back to the nominal action
  where the solution is not finite, and write the safe action back as
  (speed, steering) targets.

Decentralized filtering drops the other agent's control from every pair
row (each agent treats it as fixed). Grouped filtering (`max_group_size >
0`) keeps pair rows coupled inside a group and splits a cross-group pair
into an i-sided and a j-sided row. Margins-only mode (`is_solve_qp=False`)
folds the fixed gain into the constants and feeds the CBF-informed reward
(`nominal_margin_rewards`) without solving.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from sigmarl_tpu_torch.constants import AGENTS
from sigmarl_tpu_torch.core.geometry import angle_eliminate_two_pi
from sigmarl_tpu_torch.device import resolve_device, uniform
from sigmarl_tpu_torch.env.map_tables import MapTables
from sigmarl_tpu_torch.env.structs import EnvConfig, WorldState
from sigmarl_tpu_torch.ops.boundary import pseudo_distance_stencil
from sigmarl_tpu_torch.safety.circles import CircleApproximation, circle_centers_world
from sigmarl_tpu_torch.safety.grouping import group_agents_k_nearest, same_group_mask
from sigmarl_tpu_torch.safety.kinematics import CenterKinematics, center_kinematics
from sigmarl_tpu_torch.safety.pseudo_distance import PD_CHUNK, topk_chunks, window_chunks
from sigmarl_tpu_torch.safety.qp import ConstraintSet, StructuredConstraintSet, solve_structured_qp

Tensor = torch.Tensor


@dataclass(frozen=True)
class CBFConfig:
    """Static CBF-filter configuration (same fields and defaults as the JAX
    package's `CBFConfig`)."""

    n_agents: int
    n_circles: int = 3
    dt: float = 0.1
    taylor_order_steps: int = 2  # dt_taylor = r * dt
    dx: float = 0.02  # stencil step
    dy: float = 0.02
    lambda_ttcbf: float = 0.5
    safety_buffer: float = 0.0
    is_solve_qp: bool = True
    adaptive_lambda_cost: bool = False
    nom_controller_type: str = "rl"  # {"rl", "clf"}
    # CLF gains
    lam_clf: float = 2.0
    ref_speed: float = 1.0
    w_clf_relax: float = 1.0
    k_clf_heading: float = 1.0
    k_clf_speed: float = 1.0
    w_u_acc: float = 100.0
    w_u_steer: float = 1.0
    lane_slack_weight: float = 1e9
    pair_slack_weight: float = 1e9
    cross_slack_weight: float = 1e9
    rs: float = 0.5
    lambda_weight: float = 1e3
    h_nom: float = 0.2  # margin normalizer for CBF-informed rewards
    is_obs_noise: bool = False
    obs_noise_level: float = 0.0
    newton_iters: int = 15
    # Stiffness-continuation prefix: newton_soft_iters relaxed Newton
    # iterations, slack stiffness capped from newton_soft_cap upward, run
    # before the newton_iters full-stiffness iterations.
    newton_soft_iters: int = 2
    newton_soft_cap: float = 10.0
    # Slack-stiffness cap after row normalization; the ladder ramps to it.
    newton_ws_cap: float = 3e6
    # Constraint penetration above which a solve counts as infeasible.
    infeasibility_tol: float = 1e-3
    # Reference-parity mode: the pseudo distances rounded to float16 and the
    # stencil's finite differences in float16 arithmetic, as the original
    # SigmaRL filter computes them; the margin upcast before the radius is
    # subtracted.
    fp16_parity: bool = False
    # Lane stencil over the segments of a window of `pd_window` segment
    # indices around the closest boundary vertex; as in the JAX package it
    # takes effect only with pd_topk_chunks = 0.
    use_windowed_pseudo_distance: bool = False
    pd_window: int = 32
    # Lane stencil over the k boundary chunks of 16 segments with the
    # smallest bounding-circle lower bound (exact wherever the true
    # distance is below every unselected chunk's bound); 0 = full scan.
    pd_topk_chunks: int = 3

    @property
    def dt_taylor(self) -> float:
        return self.taylor_order_steps * self.dt


class CBFStepInfo(NamedTuple):
    safe_actions: Tensor  # [B, N, 2] (speed, steering) targets
    nominal_actions: Tensor  # [B, N, 2] clamped nominal targets
    solved: Tensor  # [B] bool — finite solution
    max_violation: Tensor  # [B] worst remaining constraint penetration
    rew_near_left_lane: Tensor  # [B, N]
    rew_near_right_lane: Tensor  # [B, N]
    rew_near_other_agents: Tensor  # [B, N]
    u_star: Tensor  # [B, N, 2] raw (accel, steering-rate) solution
    infeasible: Tensor  # [B] bool — penetration > infeasibility_tol


# Nine-point stencil: center, +x, +y, -x, -y, then the four diagonals.
_STENCIL = np.array(
    [[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1], [1, 1], [1, -1], [-1, 1], [-1, -1]],
    dtype=np.float32,
)


class CBFSafetyFilter:
    """Batched CBF-QP filter over all envs at once.

    Runs on `device` (`cuda` unless the caller passes another); the map
    tables must live there too.
    """

    def __init__(
        self,
        cfg: CBFConfig,
        env_cfg: EnvConfig,
        tables: MapTables,
        decentralized: bool = False,
        max_group_size: int = 0,
        device: str | torch.device | None = None,
    ):
        if cfg.nom_controller_type not in ("rl", "clf"):
            raise ValueError(f"unknown nominal controller {cfg.nom_controller_type!r}")
        self.device = resolve_device(device)
        if tables.long_term.device != self.device:
            raise ValueError(
                f"map tables live on {tables.long_term.device}, the filter on {self.device}"
            )
        self.cfg = cfg
        self.env_cfg = env_cfg
        self.tables = tables
        self.decentralized = decentralized
        self.max_group_size = max_group_size
        self.grouped = max_group_size > 0
        self.approx = CircleApproximation(AGENTS["length"], AGENTS["width"], cfg.n_circles)
        self.v_min, self.v_max = AGENTS["min_speed"], AGENTS["max_speed"]
        self.steer_min, self.steer_max = AGENTS["min_steering"], AGENTS["max_steering"]
        self.a_min, self.a_max = AGENTS["min_acc"], AGENTS["max_acc"]
        self.rate_min, self.rate_max = AGENTS["min_steering_rate"], AGENTS["max_steering_rate"]
        self.l_r, self.l_wb = AGENTS["l_r"], AGENTS["l_wb"]
        N = cfg.n_agents
        pairs = [(i, j) for i in range(N - 1) for j in range(i + 1, N)]
        self._pair_i = np.array([p[0] for p in pairs], np.int32)
        self._pair_j = np.array([p[1] for p in pairs], np.int32)
        self._pi = torch.as_tensor(self._pair_i, dtype=torch.long, device=self.device)
        self._pj = torch.as_tensor(self._pair_j, dtype=torch.long, device=self.device)
        self._centers_local = torch.as_tensor(self.approx.centers_local, device=self.device)
        self._offsets = torch.as_tensor(
            _STENCIL * np.array([cfg.dx, cfg.dy], np.float32), device=self.device
        )
        # The divisors of the float16 finite differences, rounded to float16
        # as the Python constants are in numpy's and JAX's float16 arithmetic
        # (a Python scalar would stay float32 in PyTorch's CUDA arithmetic).
        self._fd16 = torch.tensor(
            [cfg.dx, cfg.dy, cfg.dx**2, cfg.dy**2, 4 * cfg.dx * cfg.dy],
            dtype=torch.float16, device=self.device,
        )

    def _wl_value(self) -> float:
        """The lambda penalty weight of every row (grouped mode's cross
        rows take `lambda_weight` instead)."""
        cfg = self.cfg
        return cfg.lambda_weight if cfg.adaptive_lambda_cost else 1e-9

    def rl_action_to_u(self, rl_actions: Tensor, v: Tensor, steering: Tensor):
        """(speed, steering) targets -> clamped (accel, steering rate); the
        speed clamp is asymmetric, [min_speed, max_speed]."""
        cfg = self.cfg
        tgt_v = torch.clamp(rl_actions[..., 0], self.v_min, self.v_max)
        tgt_s = torch.clamp(rl_actions[..., 1], self.steer_min, self.steer_max)
        u_acc = torch.clamp((tgt_v - v) / cfg.dt, self.a_min, self.a_max)
        u_rate = torch.clamp((tgt_s - steering) / cfg.dt, self.rate_min, self.rate_max)
        return torch.stack([tgt_v, tgt_s], dim=-1), torch.stack([u_acc, u_rate], dim=-1)

    def u_to_rl_action(self, u: Tensor, v: Tensor, steering: Tensor) -> Tensor:
        """(accel, steering rate) -> next-step (speed, steering) targets."""
        cfg = self.cfg
        v_new = torch.clamp(v + u[..., 0] * cfg.dt, self.v_min, self.v_max)
        s_new = torch.remainder(steering + u[..., 1] * cfg.dt + math.pi, 2 * math.pi) - math.pi
        s_new = torch.clamp(s_new, self.steer_min, self.steer_max)
        return torch.stack([v_new, s_new], dim=-1)

    def stencil_inputs(
        self,
        centers: Tensor,
        path_id: Tensor,
        idx_left: Tensor | None = None,
        idx_right: Tensor | None = None,
    ):
        """The lane stencil's kernel inputs: the 9-point queries around
        every circle center q [B*N, C*9, 2], the path ids [B*N] int32, and
        per side the boundary chunks to sweep [B*N, k] int32: the k chunks
        with the smallest distance bound, or with `pd_topk_chunks` = 0 and
        the windowed flag the chunks of each row's window around its
        closest boundary vertex (`idx_left` / `idx_right` [B, N]), else None
        (every segment)."""
        cfg = self.cfg
        t = self.tables
        B, N, C = centers.shape[:3]
        q = (centers[..., None, :] + self._offsets).reshape(B * N, C * 9, 2).contiguous()
        pid = path_id.reshape(B * N).to(torch.int32).contiguous()
        if cfg.pd_topk_chunks == 0:
            if not (cfg.use_windowed_pseudo_distance and idx_left is not None):
                return q, pid, None, None
            S = t.left_seg.shape[1]

            def window(idx, n_points):
                return window_chunks(pid, idx.reshape(B * N), cfg.pd_window, n_points - 1,
                                     t.is_loop, S).contiguous()

            return q, pid, window(idx_left, t.n_points_left_b), window(idx_right, t.n_points_right_b)
        k_sel = min(cfg.pd_topk_chunks, t.left_seg.shape[1] // PD_CHUNK)
        # Agent reference point and a static reach covering every stencil
        # query: the largest circle offset from the centers' mean plus the
        # stencil diagonal.
        c_loc = np.asarray(self.approx.centers_local, np.float64)
        reach = float(np.abs(c_loc - c_loc.mean()).max() + np.hypot(cfg.dx, cfg.dy))
        p_ref = centers.mean(dim=2).reshape(B * N, 2)
        chunks_l = topk_chunks(t.left_chunk_cc, t.left_chunk_cr, pid, p_ref, reach, k_sel)
        chunks_r = topk_chunks(t.right_chunk_cc, t.right_chunk_cr, pid, p_ref, reach, k_sel)
        return q, pid, chunks_l, chunks_r

    def _lane_terms(self, centers: Tensor, path_id: Tensor, idx_left=None, idx_right=None):
        """Safety margin, gradient and Hessian of the pseudo-distance field
        at each circle center. centers [B, N, C, 2]; path_id and the closest
        boundary vertices [B, N]; returns per side (sm [B,N,C], grad
        [B,N,C,2], hess [B,N,C,2,2])."""
        cfg = self.cfg
        B, N, C = centers.shape[:3]
        q, pid, chunks_l, chunks_r = self.stencil_inputs(centers, path_id, idx_left, idx_right)
        d_left, d_right = pseudo_distance_stencil(
            q, pid, self.tables.left_seg, self.tables.right_seg, chunks_l, chunks_r
        )

        def grads(d):
            d = d.reshape(B, N, C, 9)
            dx, dy, dx2, dy2, dxy4 = (cfg.dx, cfg.dy, cfg.dx**2, cfg.dy**2, 4 * cfg.dx * cfg.dy)
            if cfg.fp16_parity:
                d = d.to(torch.float16)
                dx, dy, dx2, dy2, dxy4 = self._fd16.unbind(0)
            d0 = d[..., 0]
            # Forward differences for the gradient, central for the Hessian.
            gx = (d[..., 1] - d0) / dx
            gy = (d[..., 2] - d0) / dy
            hxx = (d[..., 1] - 2 * d0 + d[..., 3]) / dx2
            hyy = (d[..., 2] - 2 * d0 + d[..., 4]) / dy2
            hxy = (d[..., 5] - d[..., 6] - d[..., 7] + d[..., 8]) / dxy4
            grad = torch.stack([gx, gy], dim=-1)
            hess = torch.stack(
                [torch.stack([hxx, hxy], -1), torch.stack([hxy, hyy], -1)], dim=-2
            )
            if cfg.fp16_parity:
                # Upcast, then subtract the radius in float32: no second
                # rounding to float16.
                f = centers.dtype
                return d0.to(f) - self.approx.radius, grad.to(f), hess.to(f)
            return d0 - self.approx.radius, grad, hess

        return grads(d_left), grads(d_right)

    def _lane_coeffs(self, kins: CenterKinematics, sm, grad, hess):
        """Affine TTCBF lane coefficients. sm [B,N,C], grad [B,N,C,2],
        hess [B,N,C,2,2] -> A [B,N,C,2], b0, h [B,N,C]."""
        dt = self.cfg.dt_taylor
        gx, gy = grad[..., 0], grad[..., 1]
        A = 0.5 * dt * dt * (gx[..., None] * kins.a_ddx + gy[..., None] * kins.a_ddy)
        dot_h = gx * kins.dx + gy * kins.dy
        vel = torch.stack([kins.dx, kins.dy], dim=-1)
        vHv = torch.einsum("...i,...ij,...j->...", vel, hess, vel)
        const_dd = gx * kins.c_ddx + gy * kins.c_ddy + vHv
        b0 = dot_h * dt + 0.5 * dt * dt * const_dd
        h = sm - self.cfg.safety_buffer
        return A, b0, h

    def _pair_coeffs(self, centers: Tensor, kins: CenterKinematics):
        """Affine TTCBF pairwise coefficients for all (i<j, ci, cj).
        Returns A_i, A_j [B,P,C,C,2], b0, h [B,P,C,C]."""
        cfg = self.cfg
        dt = cfg.dt_taylor
        pi, pj = self._pi, self._pj
        delta = centers[:, pi][:, :, :, None, :] - centers[:, pj][:, :, None, :, :]
        ddx, ddy = delta[..., 0], delta[..., 1]
        vrel_x = kins.dx[:, pi][:, :, :, None] - kins.dx[:, pj][:, :, None, :]
        vrel_y = kins.dy[:, pi][:, :, :, None] - kins.dy[:, pj][:, :, None, :]
        aix = kins.a_ddx[:, pi][:, :, :, None, :]
        aiy = kins.a_ddy[:, pi][:, :, :, None, :]
        ajx = kins.a_ddx[:, pj][:, :, None, :, :]
        ajy = kins.a_ddy[:, pj][:, :, None, :, :]
        cix = kins.c_ddx[:, pi][:, :, :, None]
        ciy = kins.c_ddy[:, pi][:, :, :, None]
        cjx = kins.c_ddx[:, pj][:, :, None, :]
        cjy = kins.c_ddy[:, pj][:, :, None, :]

        d_safe = 2.0 * self.approx.radius + cfg.safety_buffer
        h = ddx * ddx + ddy * ddy - d_safe * d_safe
        dh = 2.0 * (ddx * vrel_x + ddy * vrel_y)
        A_i = 0.5 * dt * dt * 2.0 * (ddx[..., None] * aix + ddy[..., None] * aiy)
        A_j = 0.5 * dt * dt * -2.0 * (ddx[..., None] * ajx + ddy[..., None] * ajy)
        const_ddh = 2.0 * (vrel_x**2 + vrel_y**2) + 2.0 * (
            ddx * (cix - cjx) + ddy * (ciy - cjy)
        )
        b0 = dh * dt + 0.5 * dt * dt * const_ddh
        return A_i, A_j, b0, h

    def assemble(
        self,
        state: WorldState,
        rl_actions: Tensor,
        group_id: Tensor | None = None,
        noise: Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> Tuple[StructuredConstraintSet, Tensor, Tensor, Dict[str, Tensor]]:
        """Build the batched constraint set (block-sparse form) and the
        nominal input. Returns (constraints, u_nom [B,N,2], rl_clamped
        [B,N,2], aux dict for the margins). Rows per agent: 2C lane rows
        (circle x side) + 2 CLF rows (invalid under the RL nominal); per
        pair: C^2 coupled rows, and in grouped mode (with `group_id`
        [B, N]) C^2 more j-sided rows. With `is_obs_noise` the RL actions
        are perturbed by `obs_noise_level` times uniforms [B, N, 2] first
        (`noise`, else drawn from `generator`), in every filter mode."""
        cfg = self.cfg
        B, N = state.pos.shape[:2]
        C = cfg.n_circles
        dev, f32 = state.pos.device, state.pos.dtype
        v, psi = state.speed, state.rot
        if cfg.is_obs_noise:
            if noise is None:
                noise = uniform(rl_actions.shape, generator, dev)
            rl_actions = rl_actions + noise * cfg.obs_noise_level
        use_clf = cfg.nom_controller_type == "clf"
        if use_clf:
            # CLF nominal controller: P-control on heading and speed toward
            # the third short-term reference point.
            target = state.short_term[:, :, 2, :]
            desired = torch.atan2(target[..., 1] - state.pos[..., 1],
                                  target[..., 0] - state.pos[..., 0])
            e_head = angle_eliminate_two_pi(desired - psi)
            e_speed = cfg.ref_speed - v
            u_nom = torch.stack([
                torch.clamp(cfg.k_clf_speed * e_speed, self.a_min, self.a_max),
                torch.clamp(cfg.k_clf_heading * e_head, self.rate_min, self.rate_max),
            ], dim=-1)
            rl_clamped = torch.stack([v + e_speed, e_head], dim=-1)
        else:
            rl_clamped, u_nom = self.rl_action_to_u(rl_actions, v, state.steering)

        centers = circle_centers_world(self.approx, state.pos, psi)  # [B,N,C,2]
        kins = center_kinematics(psi, v, state.steering, self._centers_local, self.l_r, self.l_wb)
        (smL, gL, HL), (smR, gR, HR) = self._lane_terms(
            centers, state.path_id, state.idx_left, state.idx_right
        )
        A_L, b0_L, h_L = self._lane_coeffs(kins, smL, gL, HL)
        A_R, b0_R, h_R = self._lane_coeffs(kins, smR, gR, HR)
        A_pi, A_pj, b0_p, h_p = self._pair_coeffs(centers, kins)

        lane_A = torch.stack([A_L, A_R], dim=3).reshape(B, N, 2 * C, 2)
        lane_b0 = torch.stack([b0_L, b0_R], dim=3).reshape(B, N, 2 * C)
        lane_h = torch.stack([h_L, h_R], dim=3).reshape(B, N, 2 * C)

        # CLF rows, residual e * u - lam_clf / 2 * e^2: the heading row acts
        # on the steering rate, the speed row on the acceleration. Valid
        # (with slack weight w_clf_relax) only under the CLF controller;
        # zeros (and invalid) under the RL one.
        if use_clf:
            zeros_bn = torch.zeros((B, N), dtype=f32, device=dev)
            clf_A = torch.stack([torch.stack([zeros_bn, e_head], dim=-1),
                                 torch.stack([e_speed, zeros_bn], dim=-1)], dim=2)  # [B,N,2,2]
            clf_b = torch.stack([-cfg.lam_clf * 0.5 * e_head**2,
                                 -cfg.lam_clf * 0.5 * e_speed**2], dim=-1)
        else:
            clf_A = torch.zeros((B, N, 2, 2), dtype=f32, device=dev)
            clf_b = torch.zeros((B, N, 2), dtype=f32, device=dev)
        Ks = 2 * C + 2
        A_s = torch.cat([lane_A, clf_A], dim=2)
        b0_s = torch.cat([lane_b0, clf_b], dim=2)
        h_s = torch.cat([lane_h, torch.zeros((B, N, 2), dtype=f32, device=dev)], dim=2)
        ws_s = torch.cat(
            [torch.full((B, N, 2 * C), cfg.lane_slack_weight, dtype=f32, device=dev),
             torch.full((B, N, 2), cfg.w_clf_relax, dtype=f32, device=dev)], dim=2,
        )
        valid_s = torch.cat(
            [torch.ones((B, N, 2 * C), dtype=torch.bool, device=dev),
             torch.full((B, N, 2), use_clf, dtype=torch.bool, device=dev)], dim=2,
        )

        P = self._pair_i.shape[0]
        Kp = C * C
        if self.decentralized:
            # Each agent treats the other's control as fixed.
            A_pj = torch.zeros_like(A_pj)
        A_pi_f, A_pj_f = A_pi.reshape(B, P, Kp, 2), A_pj.reshape(B, P, Kp, 2)
        b0_pf, h_pf = b0_p.reshape(B, P, Kp), h_p.reshape(B, P, Kp)
        wl = self._wl_value()
        ws_pf = torch.full((B, P, Kp), cfg.pair_slack_weight, dtype=f32, device=dev)
        wl_pf = torch.full((B, P, Kp), wl, dtype=f32, device=dev)
        valid_p = torch.ones((B, P, Kp), dtype=torch.bool, device=dev)
        if self.grouped and group_id is not None:
            A_pi_f, A_pj_f, b0_pf, h_pf, ws_pf, wl_pf, valid_p = self._split_cross_pairs(
                group_id, A_pi_f, A_pj_f, b0_pf, h_pf
            )
        if not cfg.is_solve_qp:
            # Non-adaptive gain: fold lambda_ttcbf * h into the constants
            # (the CLF rows carry h = 0).
            b0_s = b0_s + cfg.lambda_ttcbf * h_s
            b0_pf = b0_pf + cfg.lambda_ttcbf * h_pf
            h_s = torch.zeros_like(h_s)
            h_pf = torch.zeros_like(h_pf)
        cons = StructuredConstraintSet(
            A_s=A_s,
            b_s=b0_s,
            h_s=h_s,
            ws_s=ws_s,
            wl_s=torch.full((B, N, Ks), wl, dtype=f32, device=dev),
            valid_s=valid_s,
            A_pi=A_pi_f,
            A_pj=A_pj_f,
            b_p=b0_pf,
            h_p=h_pf,
            ws_p=ws_pf,
            wl_p=wl_pf,
            valid_p=valid_p,
            pair_i=self._pair_i,
            pair_j=self._pair_j,
        )
        aux = {
            "lane_margin_L": smL.min(-1).values,
            "lane_margin_R": smR.min(-1).values,
            "rl_clamped": rl_clamped,
            "lane_A": lane_A,
            "lane_b0": lane_b0,
            "lane_h": lane_h,
            "pair_Ai": A_pi.reshape(B, P, Kp, 2),
            "pair_Aj": A_pj.reshape(B, P, Kp, 2),
            "pair_b0": b0_p.reshape(B, P, Kp),
            "pair_h": h_p.reshape(B, P, Kp),
        }
        return cons, u_nom, rl_clamped, aux

    def _split_cross_pairs(self, group_id: Tensor, A_pi, A_pj, b0, h):
        """Grouped mode's pair block [B, P, 2*C^2]: same-group rows stay
        coupled; a cross-group pair becomes an i-sided row (in the first
        C^2) and a j-sided row (in the second C^2, invalid for same-group
        pairs). Each side carries half the drift constant and an `rs`
        share of the relaxation with its own lambda, so the two together
        give back the coupled row; cross rows take `cross_slack_weight`
        and are always `lambda_weight`-regularised. In margins-only mode
        the cross rows are the full inactive row with lambda fixed at 1
        (pre-compensated for the fold of lambda_ttcbf * h that follows)."""
        cfg = self.cfg
        B, P, Kp = b0.shape
        same = same_group_mask(group_id, self._pi, self._pj)[..., None].expand(B, P, Kp)
        if cfg.is_solve_qp:
            b0_cross, h_cross = 0.5 * b0, cfg.rs * h
        else:
            b0_cross, h_cross = b0 + (1.0 - cfg.lambda_ttcbf) * h, h
        cross_ws = b0.new_full((B, P, Kp), cfg.cross_slack_weight)
        cross_wl = b0.new_full((B, P, Kp), cfg.lambda_weight)
        return (
            torch.cat([A_pi, torch.zeros_like(A_pi)], dim=2),
            torch.cat([torch.where(same[..., None], A_pj, 0.0),
                       torch.where(same[..., None], 0.0, A_pj)], dim=2),
            torch.cat([torch.where(same, b0, b0_cross), b0_cross], dim=2),
            torch.cat([torch.where(same, h, h_cross), h_cross], dim=2),
            torch.cat([torch.where(same, cfg.pair_slack_weight, cross_ws), cross_ws], dim=2),
            torch.cat([torch.where(same, self._wl_value(), cross_wl), cross_wl], dim=2),
            torch.cat([torch.ones_like(same), ~same], dim=2),
        )

    def to_dense(self, cons: StructuredConstraintSet) -> ConstraintSet:
        """The dense [B, M, 2N] form of a structured set: single-agent rows
        (n, k) first, then pair rows (p, k); controls ordered (agent,
        component). For tests and oracle checks only."""
        B, N, Ks = cons.A_s.shape[:3]
        P, Kp = cons.A_pi.shape[1:3]
        dev, dt = cons.A_s.device, cons.A_s.dtype
        eye = torch.eye(N, dtype=dt, device=dev)
        ei = eye[torch.as_tensor(np.asarray(cons.pair_i), dtype=torch.long, device=dev)]
        ej = eye[torch.as_tensor(np.asarray(cons.pair_j), dtype=torch.long, device=dev)]
        A_single = torch.einsum("bnkc,nm->bnkmc", cons.A_s, eye).reshape(B, N * Ks, 2 * N)
        A_pair = (torch.einsum("bpkc,pn->bpknc", cons.A_pi, ei)
                  + torch.einsum("bpkc,pn->bpknc", cons.A_pj, ej)).reshape(B, P * Kp, 2 * N)

        def cat(single, pair):
            return torch.cat([single.reshape(B, N * Ks), pair.reshape(B, P * Kp)], dim=1)

        return ConstraintSet(
            A=torch.cat([A_single, A_pair], dim=1),
            b=cat(cons.b_s, cons.b_p),
            h=cat(cons.h_s, cons.h_p),
            w_slack=cat(cons.ws_s, cons.ws_p),
            w_lambda=cat(cons.wl_s, cons.wl_p),
            valid=cat(cons.valid_s, cons.valid_p),
        )

    def filter_actions(
        self,
        state: WorldState,
        rl_actions: Tensor,
        u_init: Tensor | None = None,
        noise: Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> CBFStepInfo:
        """Solve the batched CBF-QP and return safe (speed, steering)
        targets. `u_init` (the previous step's solution) warm-starts the
        Newton iteration. Grouped mode groups the agents of every env by
        position first. `noise` and `generator` as in `assemble`."""
        cfg = self.cfg
        group_id = None
        if self.grouped:
            group_id = group_agents_k_nearest(state.pos, self.max_group_size)
        cons, u_nom, rl_clamped, aux = self.assemble(state, rl_actions, group_id, noise, generator)
        u_star, F = solve_structured_qp(
            cons, u_nom,
            (cfg.w_u_acc, cfg.w_u_steer), (self.a_min, self.rate_min),
            (self.a_max, self.rate_max),
            n_iters=cfg.newton_iters, u_init=u_init, ws_cap=cfg.newton_ws_cap,
            soft_iters=cfg.newton_soft_iters, soft_cap=cfg.newton_soft_cap,
        )
        solved = torch.isfinite(F) & torch.isfinite(u_star).all(-1).all(-1)
        u_star = torch.where(solved[:, None, None], u_star, u_nom)

        # Residual penetration at the solution: best-case lambda is 1 where
        # h relaxes the row (h > 0), else 0.
        r_s = (
            torch.einsum("bnkc,bnc->bnk", cons.A_s, u_star) + cons.b_s
            + torch.clamp(cons.h_s, min=0.0)
        )
        r_p = (
            torch.einsum("bpkc,bpc->bpk", cons.A_pi, u_star[:, self._pi])
            + torch.einsum("bpkc,bpc->bpk", cons.A_pj, u_star[:, self._pj])
            + cons.b_p + torch.clamp(cons.h_p, min=0.0)
        )
        zero = torch.zeros((), dtype=r_s.dtype, device=r_s.device)
        viol_s = torch.where(cons.valid_s, torch.clamp(-r_s, min=0.0), zero).amax((-1, -2))
        viol_p = torch.where(cons.valid_p, torch.clamp(-r_p, min=0.0), zero).reshape(
            r_p.shape[0], -1)
        # One agent has no pair rows: no pair penetration.
        viol_p = viol_p.amax(-1) if viol_p.shape[-1] else torch.zeros_like(viol_s)
        viol = torch.maximum(viol_s, viol_p)

        safe_actions = self.u_to_rl_action(u_star, state.speed, state.steering)
        margins = self._margins_from_aux(u_nom, aux)
        return CBFStepInfo(
            safe_actions=safe_actions,
            nominal_actions=rl_clamped,
            solved=solved,
            max_violation=viol,
            infeasible=~solved | (viol > cfg.infeasibility_tol),
            u_star=u_star,
            **margins,
        )

    def nominal_margin_rewards(
        self,
        state: WorldState,
        rl_actions: Tensor,
        noise: Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> Dict[str, Tensor]:
        """Margins-only mode: the CBF-informed shaping rewards at the
        nominal action, from the assembled rows without a solve. `noise`
        and `generator` as in `assemble`."""
        _, u_nom, _, aux = self.assemble(state, rl_actions, None, noise, generator)
        return self._margins_from_aux(u_nom, aux)

    def _margins_from_aux(self, u_nom: Tensor, aux: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Per-agent shaping rewards from the constraint margins at u_nom
        with lambda = lambda_ttcbf."""
        cfg = self.cfg
        C = cfg.n_circles
        B, N = u_nom.shape[:2]
        lam = cfg.lambda_ttcbf
        g_lane = (
            torch.einsum("bnkc,bnc->bnk", aux["lane_A"], u_nom)
            + aux["lane_b0"] + aux["lane_h"] * lam
        ).reshape(B, N, C, 2)
        g_left = g_lane[..., 0].min(-1).values
        g_right = g_lane[..., 1].min(-1).values

        g_pair = (
            torch.einsum("bpkc,bpc->bpk", aux["pair_Ai"], u_nom[:, self._pi])
            + torch.einsum("bpkc,bpc->bpk", aux["pair_Aj"], u_nom[:, self._pj])
            + aux["pair_b0"] + aux["pair_h"] * lam
        ).min(-1).values  # [B, P]
        g_pair_neg = torch.clamp(g_pair, max=0.0)
        # Worst (most negative) pair margin touching each agent.
        big = torch.full((B, N), 1e9, dtype=g_pair.dtype, device=g_pair.device)
        g_i = big.scatter_reduce(1, self._pi.expand(B, -1), g_pair_neg, "amin")
        g_j = big.scatter_reduce(1, self._pj.expand(B, -1), g_pair_neg, "amin")
        v_pair = torch.clamp(torch.minimum(g_i, g_j), max=0.0)

        def to_reward(v):
            return torch.clamp(v / cfg.h_nom, -1.0, 0.0)

        return {
            "rew_near_left_lane": to_reward(g_left),
            "rew_near_right_lane": to_reward(g_right),
            "rew_near_other_agents": to_reward(v_pair),
        }
