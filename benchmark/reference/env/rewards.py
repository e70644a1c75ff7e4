"""Reward computation, vectorized over `[B, N]`: the "distance", "ttc" and
"cbf" methods (each optionally with "_sparse") and "sparse"."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.reference.core.geometry import decreasing_fcn
from benchmark.reference.env.structs import EnvConfig, WorldState

Tensor = torch.Tensor


def _ttc_penalty(cfg: EnvConfig, state: WorldState) -> Tensor:
    """2-D time-to-collision penalty."""
    eps = 1e-6
    pos, vel = state.pos, state.vel
    p_rel = pos[:, None, :, :] - pos[:, :, None, :]  # [B, i, j, 2]
    v_rel = vel[:, None, :, :] - vel[:, :, None, :]
    d_safe = cfg.threshold_near_other_agents_low
    d_gate = cfg.threshold_near_other_agents_high

    a = (v_rel * v_rel).sum(-1)
    b = 2.0 * (p_rel * v_rel).sum(-1)
    pp = (p_rel * p_rel).sum(-1)
    c = pp - d_safe * d_safe
    disc = b * b - 4.0 * a * c
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    dist = torch.sqrt(torch.clamp(pp, min=0.0))

    valid = (a > eps) & (disc > 0.0) & (b < 0.0)
    ttc_candidate = (-b - sqrt_disc) / (2.0 * a + eps)
    inf = torch.full_like(a, math.inf)
    ttc = torch.where(valid & (ttc_candidate > 0.0), ttc_candidate, inf)
    ttc = torch.where(dist <= d_safe, torch.zeros_like(ttc), ttc)
    eye = torch.eye(cfg.n_agents, dtype=torch.bool, device=pos.device)
    ttc = torch.where(eye, inf, ttc)
    ttc = torch.where(dist <= d_gate, ttc, inf)

    risk = decreasing_fcn(torch.clamp(ttc, max=cfg.ttc_high), cfg.ttc_low, cfg.ttc_high)
    risk = risk.sum(-1) / max(1, cfg.n_agents - 1)
    return risk * cfg.penalty_near_other_agents


def compute_rewards(
    cfg: EnvConfig,
    state: WorldState,
    prev_pos: Tensor,
    prev_short_term: Tensor,
    weighting_ref: Tensor,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Per-agent rewards for the step just taken.

    state: post-dynamics, post-`update_geometry`; prev_pos [B, N, 2] and
    prev_short_term [B, N, S, 2] from the end of the previous step;
    weighting_ref [S]. Returns (reward [B, N] clamped to [-1, 1], info).
    """
    # Forward-movement reward: the step displacement projected onto the
    # vectors toward the previous short-term reference points.
    move_vec = (state.pos - prev_pos)[:, :, None, :]
    ref_vecs = prev_short_term - prev_pos[:, :, None, :]
    move_projected = (move_vec * ref_vecs).sum(-1)  # [B, N, S]
    move_weighted = (move_projected * weighting_ref).sum(-1)
    rew_progress = move_weighted / (cfg.max_speed * cfg.dt) * cfg.reward_progress

    f32 = rew_progress.dtype
    rew_goal = state.coll_exit.to(f32) * cfg.reward_reach_goal
    pen_coll_agents = state.coll_agents.any(-1).to(f32) * cfg.penalty_collide_with_agents
    pen_coll_lanelets = state.coll_lanelets.to(f32) * cfg.penalty_collide_with_boundaries
    pen_boundary = (
        decreasing_fcn(
            state.d_boundary, cfg.threshold_near_boundary_low, cfg.threshold_near_boundary_high
        )
        * cfg.penalty_near_boundary
    )
    pen_near_agents = torch.zeros_like(rew_progress)

    # Testing mode adds the goal reward and the collision penalties; the
    # training reward methods leave the goal reward out.
    method = cfg.rew_method
    if cfg.is_testing_mode:
        rew = rew_progress + rew_goal + pen_coll_agents + pen_coll_lanelets
    else:
        rew = rew_progress
        if method == "sparse":
            rew = rew + pen_coll_agents + pen_coll_lanelets
        if "ttc" in method:
            pen_near_agents = _ttc_penalty(cfg, state)
            rew = rew + pen_near_agents + pen_boundary
            rew = rew + pen_coll_agents + pen_coll_lanelets
            if "sparse" in method:
                rew = rew + pen_coll_agents + pen_coll_lanelets
        if "distance" in method:
            ramp = decreasing_fcn(
                state.d_agents,
                cfg.threshold_near_other_agents_low,
                cfg.threshold_near_other_agents_high,
            )
            pen_near_agents = ramp.sum(-1) * cfg.penalty_near_other_agents
            rew = rew + pen_near_agents + pen_boundary
            if "sparse" in method:
                rew = rew + pen_coll_agents + pen_coll_lanelets
        if "cbf" in method:
            if cfg.is_using_cbf and cfg.is_solve_qp:
                # Penalize the deviation of the applied (filtered) action from
                # the nominal RL action.
                dev_v = (
                    torch.abs(state.applied_action[..., 0] - state.nominal_action[..., 0])
                    / cfg.max_speed
                )
                dev_s = (
                    torch.abs(state.applied_action[..., 1] - state.nominal_action[..., 1])
                    / cfg.max_steering
                )
                rew = (
                    rew
                    + cfg.penalty_deviate_from_cbf_vel * dev_v
                    + cfg.penalty_deviate_from_cbf_steer * dev_s
                )
            else:
                # CBF-informed shaping from the constraint margins that the
                # safety layer wrote into the state (`cbf_margin_step`).
                cbf_rew = (
                    state.rew_near_left_lane
                    + state.rew_near_right_lane
                    + state.rew_near_other_agents_cbf
                ) / 3
                rew = rew + cbf_rew
            if "sparse" in method:
                rew = rew + pen_coll_agents + pen_coll_lanelets

    rew = torch.clamp(rew, -1.0, 1.0)
    info = {
        "rew_progress": rew_progress,
        "rew_reach_goal": rew_goal,
        "rew_near_other_agents": pen_near_agents,
        "rew_collide_other_agents": pen_coll_agents,
        "rew_collide_lane": pen_coll_lanelets,
        "rew_near_boundary": pen_boundary,
        "rew_total": rew,
    }
    return rew, info
