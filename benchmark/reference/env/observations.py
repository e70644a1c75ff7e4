"""Observation pipeline, vectorized over `[B, N(ego), k(neighbor)]`.

Neighbors are selected first (top-k over the distance matrix) and only the
k selected neighbors' features are gathered (index gathers) and
transformed into the ego frame. The observation is the newest
`n_observed_steps` feature blocks of the history, then the
opponent-modeling pad and the sensor noise.
"""

from __future__ import annotations

import torch

from benchmark.reference.core import geometry as G
from benchmark.reference.device import constant, uniform
from benchmark.reference.env.map_tables import MapTables
from benchmark.reference.env.structs import EnvConfig, WorldState, replace_state

Tensor = torch.Tensor


def _current_lanelets(tables: MapTables, pos: Tensor) -> Tensor:
    """Nearest lanelet index per agent by min point distance. pos [B, N, 2]."""
    centers = tables.lanelet_centers  # [L, Pc, 2]
    L, Pc = centers.shape[:2]
    diff = pos[:, :, None, None, :] - centers
    d2 = (diff * diff).sum(-1)  # [B, N, L, Pc]
    pt_idx = torch.arange(Pc, device=pos.device)
    n_pts = tables.n_lanelet_center_points
    d2 = torch.where(pt_idx < n_pts[:, None], d2, torch.full_like(d2, float("inf")))
    return torch.argmin(d2.min(-1).values, dim=-1)


def observe_core(cfg: EnvConfig, tables: MapTables, state: WorldState) -> Tensor:
    """Single-step per-agent feature vector. Returns [B, N, obs_core_dim]."""
    B, N = state.pos.shape[:2]
    pos, rot, vel = state.pos, state.rot, state.vel

    d_ref_n = state.d_ref / cfg.norm_distance_lanelet
    d_left_n = state.d_left.min(-1).values / cfg.norm_distance_lanelet
    d_right_n = state.d_right.min(-1).values / cfg.norm_distance_lanelet
    steering_n = G.angle_eliminate_two_pi(state.steering) / cfg.norm_rot

    # --- neighbor selection (before any pairwise feature work)
    k = cfg.n_observed_agents
    if cfg.is_partial_observation:
        nearing_idx = G.nearest_indices(state.d_agents, k)  # [B, N, k]
        nearing_dist = torch.gather(state.d_agents, -1, nearing_idx)
        if cfg.is_apply_mask:
            masked = nearing_dist >= cfg.distance_mask_agents
            if cfg.has_lanelet_neighbors:
                lane_idx = _current_lanelets(tables, pos)  # [B, N]
                nb_lane = torch.gather(lane_idx[:, None, :].expand(B, N, N), 2, nearing_idx)
                ok = tables.neighboring_lanelets[lane_idx[:, :, None], nb_lane]
                masked = masked | ~ok
        else:
            masked = torch.zeros((B, N, k), dtype=torch.bool, device=pos.device)
    else:
        nearing_idx = torch.arange(N, device=pos.device).expand(B, N, N)
        nearing_dist = state.d_agents
        masked = torch.zeros((B, N, N), dtype=torch.bool, device=pos.device)

    b_idx = torch.arange(B, device=pos.device)[:, None, None]

    def gather(feat: Tensor) -> Tensor:
        """feat [B, N(j), F...] -> selected [B, N(i), k, F...]."""
        return feat[b_idx, nearing_idx]

    pos_j = gather(pos)  # [B, N, k, 2]
    rot_j = gather(rot)  # [B, N, k]
    vabs = torch.sqrt((vel * vel).sum(-1))  # [B, N]
    vabs_j = gather(vabs)
    steer_j = gather(steering_n)
    vert_j = gather(state.vertices[..., 0:4, :])  # [B, N, k, 4, 2]
    ref_j = gather(state.short_term)  # [B, N, k, S, 2]

    rel_rot = G.angle_eliminate_two_pi(rot_j - rot[:, :, None])
    rel_vel = torch.stack([vabs_j * torch.cos(rel_rot), vabs_j * torch.sin(rel_rot)], dim=-1)

    if cfg.is_ego_view:
        def ego_local(points: Tensor) -> Tensor:
            """points [B, N, k, M, 2] -> ego-i frame [B, N, k, M, 2]."""
            p_i = pos[:, :, None, :].expand(B, N, points.shape[2], 2)
            r_i = rot[:, :, None].expand(B, N, points.shape[2])
            return G.global_to_local(p_i, points, r_i)

        pos_feat = ego_local(pos_j[:, :, :, None, :])[..., 0, :] / cfg.norm_pos
        rot_feat = rel_rot / cfg.norm_rot
        vel_feat = rel_vel / cfg.norm_v
        vert_feat = ego_local(vert_j) / cfg.norm_pos
        ref_feat = ego_local(ref_j) / cfg.norm_pos
        self_ref = G.global_to_local(pos, state.short_term, rot) / cfg.norm_pos
        if not cfg.is_observe_distance_to_boundaries:
            self_lb = G.global_to_local(pos, state.nearing_left, rot) / cfg.norm_pos
            self_rb = G.global_to_local(pos, state.nearing_right, rot) / cfg.norm_pos
    else:
        norm_pos_world = constant((cfg.world_x_dim, cfg.world_y_dim), torch.float32, pos.device)
        pos_feat = pos_j / norm_pos_world
        rot_feat = G.angle_eliminate_two_pi(rot_j) / cfg.norm_rot
        vel_feat = gather(vel) / cfg.norm_v
        vert_feat = vert_j / norm_pos_world
        ref_feat = ref_j / norm_pos_world
        self_ref = state.short_term / norm_pos_world
        if not cfg.is_observe_distance_to_boundaries:
            self_lb = state.nearing_left / norm_pos_world
            self_rb = state.nearing_right / norm_pos_world

    lengths_n = cfg.agent_length / cfg.norm_distance_agent
    widths_n = cfg.agent_width / cfg.norm_distance_agent

    def apply_mask(feat: Tensor, fill: float) -> Tensor:
        m = masked.reshape(B, N, k, *([1] * (feat.ndim - 3)))
        return torch.where(m, torch.full_like(feat, fill), feat)

    obs_pos_o = apply_mask(pos_feat, 1.0)
    obs_rot_o = apply_mask(rot_feat, 0.0)
    obs_vel_o = apply_mask(vel_feat, 0.0)
    obs_ref_o = apply_mask(ref_feat, 1.0)
    obs_vert_o = apply_mask(vert_feat, 1.0)
    obs_steer_o = apply_mask(steer_j, 0.0)
    obs_dist_o = apply_mask(nearing_dist / cfg.norm_distance_lanelet, 1.0)

    # --- per-neighbor feature block
    if k == 0:
        obs_others = torch.zeros((B, N, 0), device=pos.device)
    else:
        feats = []
        if cfg.is_observe_vertices:
            feats.append(obs_vert_o.reshape(B, N, k, -1))
        else:
            feats.extend([
                obs_pos_o.reshape(B, N, k, -1),
                obs_rot_o[..., None],
                torch.full((B, N, k, 1), lengths_n, device=pos.device),
                torch.full((B, N, k, 1), widths_n, device=pos.device),
            ])
        feats.append(obs_vel_o.reshape(B, N, k, -1))
        if cfg.is_obs_steering:
            feats.append(obs_steer_o[..., None])
        if cfg.is_observe_distance_to_agents:
            feats.append(obs_dist_o[..., None])
        if cfg.is_observe_ref_path_other_agents:
            feats.append(obs_ref_o.reshape(B, N, k, -1))
        obs_others = torch.cat(feats, dim=-1).reshape(B, N, -1)

    # --- self observation
    self_feats = []
    if not cfg.is_ego_view:
        norm_pos_world = constant((cfg.world_x_dim, cfg.world_y_dim), torch.float32, pos.device)
        self_feats.append(pos / norm_pos_world)
        self_feats.append((G.angle_eliminate_two_pi(rot) / cfg.norm_rot)[..., None])
        self_feats.append(vel / cfg.norm_v)
    else:
        # Own ego-frame velocity: the longitudinal component only.
        self_feats.append((vabs / cfg.norm_v)[..., None])
    if cfg.is_obs_steering:
        self_feats.append(steering_n[..., None])
    self_feats.append(self_ref.reshape(B, N, -1))
    if cfg.is_observe_distance_to_center_line:
        self_feats.append(d_ref_n[..., None])
    if cfg.is_observe_distance_to_boundaries:
        self_feats.append(d_left_n[..., None])
        self_feats.append(d_right_n[..., None])
    else:
        self_feats.append(self_lb.reshape(B, N, -1))
        self_feats.append(self_rb.reshape(B, N, -1))
    obs_self = torch.cat(self_feats, dim=-1)
    return torch.cat([obs_self, obs_others], dim=-1)


def _finalize(
    cfg: EnvConfig, obs: Tensor, noise: Tensor | None = None,
    generator: torch.Generator | None = None,
) -> Tensor:
    """The opponent-modeling zero pad of k * 2 columns, then uniform [0,
    level) sensor noise over the whole padded observation (the pad too):
    `noise` is the [B, N, obs_dim] uniform draw, from `generator` when not
    given."""
    B, N = obs.shape[:2]
    if cfg.is_using_opponent_modeling:
        pad = torch.zeros((B, N, cfg.n_nearing_agents_observed * cfg.n_actions),
                          dtype=obs.dtype, device=obs.device)
        obs = torch.cat([obs, pad], dim=-1)
    if cfg.is_obs_noise:
        if noise is None:
            noise = uniform(obs.shape, generator, obs.device)
        obs = obs + cfg.obs_noise_level * noise
    return obs


def observe(
    cfg: EnvConfig, tables: MapTables, state: WorldState, noise: Tensor | None = None,
    generator: torch.Generator | None = None,
) -> Tensor:
    """Single-shot observation at history depth 1. A deeper window needs
    the history that `observe_with_history` threads through the state."""
    if cfg.n_observed_steps > 1:
        raise ValueError(
            f"observe() cannot produce n_observed_steps={cfg.n_observed_steps} observations "
            "without a threaded history; use observe_with_history()."
        )
    return _finalize(cfg, observe_core(cfg, tables, state), noise, generator)


def observe_with_history(
    cfg: EnvConfig,
    tables: MapTables,
    state: WorldState,
    reset_mask: Tensor | None = None,
    full_reset: bool = False,
    noise: Tensor | None = None,
    generator: torch.Generator | None = None,
):
    """Observation with feature history. `state.obs_history` [H, B, N, F]
    holds the last H single-step feature blocks, newest first; the
    observation concatenates the newest `n_observed_steps` of them. Each
    call rolls the history by one slot; `full_reset` fills every slot with
    the current features, and `reset_mask` [B, N] refills the slots of the
    agents that were just reset, so no window mixes two episodes. Noise as
    in `_finalize`. Returns (obs [B, N, obs_dim], state with the rolled
    history)."""
    core = observe_core(cfg, tables, state)  # [B, N, F]
    H = cfg.n_stored_steps
    if cfg.n_observed_steps > H:
        raise ValueError(
            f"n_observed_steps={cfg.n_observed_steps} exceeds n_stored_steps={H}"
        )
    if H <= 1:
        return _finalize(cfg, core, noise, generator), state
    if full_reset:
        hist = core[None].expand(H, *core.shape)
    else:
        hist = torch.cat([core[None], state.obs_history[:-1]], dim=0)
        if reset_mask is not None:
            hist = torch.where(reset_mask[None, :, :, None], core[None], hist)
    window = hist[: cfg.n_observed_steps]  # [n_obs, B, N, F], newest first
    obs = window.permute(1, 2, 0, 3).reshape(*core.shape[:2], -1)
    state = replace_state(state, obs_history=hist.contiguous())
    return _finalize(cfg, obs, noise, generator), state
