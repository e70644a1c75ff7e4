"""Fixed-shape reset / spawn logic.

Each respawning agent draws a fixed budget of `max_spawn_tries` candidate
(path, point) poses at once and takes the first one far enough from the
agents already placed (the last candidate when none is). Agents are placed
in order, vectorized over envs. The reset runs at full width over all envs
(masked).

Every random number the reset consumes arrives in a `ResetDraws`, so tests
can feed it the JAX package's draws; `ResetDraws.sample` draws them from a
`torch.Generator`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sigmarl_tpu_torch.env.map_tables import MapTables
from sigmarl_tpu_torch.env.structs import EnvConfig, WorldState, replace_state, zero_state
from sigmarl_tpu_torch.env.updates import (
    push_state_buffer,
    refresh_geometry_after_reset,
    update_short_term_paths,
)

Tensor = torch.Tensor


@dataclass
class ResetDraws:
    """Random numbers of one reset.

    scenario_gumbel: [B, 3] Gumbel noise of the per-env scenario-group draw
        (cpm_mixed only; None elsewhere).
    path_u: [B, N, T] uniforms choosing each candidate's path.
    point_u: [B, N, T] uniforms choosing each candidate's spawn point.
    speed_u: [B, N] uniforms scaling the spawn speed.
    """

    scenario_gumbel: Tensor | None
    path_u: Tensor
    point_u: Tensor
    speed_u: Tensor

    @classmethod
    def sample(cls, cfg: EnvConfig, generator: torch.Generator, device) -> "ResetDraws":
        B, N, T = cfg.batch_dim, cfg.n_agents, cfg.max_spawn_tries

        def u(*shape):
            return torch.rand(shape, generator=generator, device=device)

        gumbel = None
        if cfg.scenario_type == "cpm_mixed":
            gumbel = -torch.log(-torch.log(u(B, 3).clamp(min=1e-20)))
        return cls(gumbel, u(B, N, T), u(B, N, T), u(B, N))


def _sample_scenario_ids(cfg: EnvConfig, draws: ResetDraws, B: int, device) -> Tensor:
    """Per-env scenario-group id: {1, 2, 3} for cpm_mixed (categorical by
    the Gumbel-max trick), else 0."""
    if cfg.scenario_type != "cpm_mixed":
        return torch.zeros((B,), dtype=torch.int32, device=device)
    probs = torch.tensor(cfg.cpm_scenario_probabilities, dtype=torch.float32, device=device)
    logits = torch.log(torch.clamp(probs, min=1e-30))
    return (torch.argmax(draws.scenario_gumbel + logits, dim=-1) + 1).to(torch.int32)


def _sample_candidate_paths(tables: MapTables, path_u: Tensor, scenario_id: Tensor) -> Tensor:
    """Uniform candidate path ids among the scenario group's paths by
    inverse CDF: the uniform indexes the group's sorted valid-path list.
    path_u [B, N, T]; scenario_id [B]. Returns [B, N, T] int32."""
    mask = tables.group_mask  # [G, K]
    rank = torch.cumsum(mask.to(torch.int32), dim=-1) - 1  # [G, K]
    n_valid = mask.sum(-1).to(torch.float32)  # [G]
    sid = scenario_id.long()
    nv = n_valid[sid][:, None, None]
    idx = torch.minimum((path_u * nv).to(torch.int32), (nv - 1).to(torch.int32))
    rank_env = rank[sid][:, None, None, :]  # [B, 1, 1, K]
    mask_env = mask[sid][:, None, None, :]
    hit = (rank_env == idx[..., None]) & mask_env
    ks = torch.arange(mask.shape[1], dtype=torch.int32, device=path_u.device)
    return torch.where(hit, ks, torch.zeros_like(ks)).sum(-1, dtype=torch.int32)


def _candidate_point_ids(cfg: EnvConfig, point_u: Tensor, n_points: Tensor) -> Tensor:
    """Spawn-point index per candidate [B, N, T]: uniform in [3, n_points //
    2) in training; in testing mode in a window that grows with the retry
    index k, [3, 3 + (k+1)(k+2)/2), capped at n_points // 2."""
    start = 3
    end = torch.div(n_points, 2, rounding_mode="floor")
    if cfg.is_testing_mode:
        k = torch.arange(n_points.shape[-1], dtype=n_points.dtype, device=n_points.device)
        end = torch.minimum(start + torch.div((k + 1) * (k + 2), 2, rounding_mode="floor"), end)
    end = torch.clamp(end, min=start + 1)
    return (start + (point_u * (end - start)).to(torch.int32)).to(torch.int32)


def spawn_positions(
    cfg: EnvConfig,
    tables: MapTables,
    draws: ResetDraws,
    scenario_id: Tensor,
    prev_pos: Tensor,
    reset_mask: Tensor,
):
    """Sample feasible spawn poses for the masked agents of each env.

    scenario_id [B]; prev_pos [B, N, 2] (non-reset agents keep these and
    constrain the reset agents); reset_mask [B, N]. Returns (pos, rot,
    path_id, point_id), each [B, N, ...].
    """
    B, N = prev_pos.shape[:2]
    T = cfg.max_spawn_tries
    cand_path = _sample_candidate_paths(tables, draws.path_u, scenario_id)  # [B, N, T]
    cp = cand_path.long()
    n_pts = tables.n_points_long_term[cp]
    cand_point = _candidate_point_ids(cfg, draws.point_u, n_pts)  # [B, N, T]
    cand_pos = tables.long_term[cp, cand_point.long()]  # [B, N, T, 2]

    placed_pos = prev_pos.clone()
    placed_mask = ~reset_mask
    min_d2 = cfg.reset_agent_min_distance**2
    b_idx = torch.arange(B, device=prev_pos.device)
    choices = []
    for n in range(N):
        c_pos = cand_pos[:, n]  # [B, T, 2]
        diff = c_pos[:, :, None, :] - placed_pos[:, None, :, :]  # [B, T, N, 2]
        dist2 = (diff * diff).sum(-1)
        dist2 = torch.where(placed_mask[:, None, :], dist2, torch.full_like(dist2, float("inf")))
        feasible = dist2.min(-1).values >= min_d2  # [B, T]
        # First feasible candidate (argmax of the first True), else the last.
        first = torch.argmax(feasible.to(torch.int32), dim=-1)
        choice = torch.where(feasible.any(-1), first, torch.full_like(first, T - 1))
        pos_n = c_pos[b_idx, choice]
        pos_n = torch.where(reset_mask[:, n, None], pos_n, prev_pos[:, n])
        placed_pos[:, n] = pos_n
        placed_mask[:, n] = True
        choices.append(choice)
    choice = torch.stack(choices, dim=1)[..., None]  # [B, N, 1]
    path_id = torch.gather(cand_path, 2, choice)[..., 0]
    point_id = torch.gather(cand_point, 2, choice)[..., 0]
    rot = tables.center_line_yaw[path_id.long(), point_id.long()]
    return placed_pos, rot, path_id, point_id


def apply_reset(
    cfg: EnvConfig, tables: MapTables, state: WorldState, reset_mask: Tensor, draws: ResetDraws
) -> WorldState:
    """(Re)spawn the masked agents and refresh all derived state."""
    B, N = state.pos.shape[:2]
    dev = state.pos.device
    full_env_reset = reset_mask.all(-1)
    new_scenario = _sample_scenario_ids(cfg, draws, B, dev)
    # Full resets draw a fresh scenario group; partial resets keep it.
    scenario_id_env = torch.where(full_env_reset, new_scenario, state.scenario_id[:, 0])
    pos, rot, path_id, point_id = spawn_positions(
        cfg, tables, draws, scenario_id_env, state.pos, reset_mask
    )
    speed_new = draws.speed_u * cfg.max_speed
    vel_new = torch.stack([speed_new * torch.cos(rot), speed_new * torch.sin(rot)], dim=-1)

    m = reset_mask
    m2 = m[..., None]
    zero = torch.zeros((), dtype=state.rot.dtype, device=dev)
    state = replace_state(
        state,
        pos=torch.where(m2, pos, state.pos),
        rot=torch.where(m, rot, state.rot),
        speed=torch.where(m, speed_new, state.speed),
        steering=torch.where(m, zero, state.steering),
        sideslip=torch.where(m, zero, state.sideslip),
        vel=torch.where(m2, vel_new, state.vel),
        path_id=torch.where(m, path_id, state.path_id),
        point_id=torch.where(m, point_id, state.point_id),
        scenario_id=torch.where(m, scenario_id_env[:, None], state.scenario_id),
        step=torch.where(full_env_reset, torch.zeros_like(state.step), state.step),
    )
    # Spawned poses are spawn-table entries: derived geometry is a gather.
    state = refresh_geometry_after_reset(cfg, tables, state, reset_mask)
    state = update_short_term_paths(cfg, tables, state, at_reset=True)
    # Envs with any reset clear their collision flags.
    env_any = m.any(-1)
    state = replace_state(
        state,
        coll_agents=state.coll_agents & ~env_any[:, None, None],
        coll_lanelets=state.coll_lanelets & ~env_any[:, None],
        coll_entry=state.coll_entry & ~env_any[:, None],
        coll_exit=state.coll_exit & ~env_any[:, None],
    )
    return push_state_buffer(state)


def initial_state(
    cfg: EnvConfig, tables: MapTables, draws: ResetDraws, device
) -> WorldState:
    """Fresh world state with all envs spawned."""
    state = zero_state(cfg, device)
    mask = torch.ones((cfg.batch_dim, cfg.n_agents), dtype=torch.bool, device=device)
    return apply_reset(cfg, tables, state, mask, draws)
