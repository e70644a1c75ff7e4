"""Fixed-shape reset / spawn logic.

Each respawning agent draws a fixed budget of `max_spawn_tries` candidate
(path, point) poses at once and takes the first one far enough from the
agents already placed (the last candidate when none is). Agents are placed
in order, vectorized over envs. The reset runs at full width over all envs
(masked), except for the spawn at a global batch of at least 1024 envs
with the challenge buffer off: when no more than 3B/8 envs reset, only
those envs' rows are gathered, spawned and scattered back (the JAX
package's static-size compaction). Their candidates come from the first
rows of [3B/8, N, T] draws, the s-th resetting env (in env order) taking
row s, so that both packages spawn alike from the same draws. On the card
the spawn, compacted or not, is one launch of a kernel
(`ops/spawn.py::spawn_place`); `spawn_positions` is its plain version.

With the challenging initial-state buffer on, a full-env reset replays a
recorded state instead, with probability `probability_use_recording`, and
the derived geometry is recomputed from the poses.

Every random number the reset consumes arrives in a `ResetDraws`, so tests
can feed it the JAX package's draws; `ResetDraws.sample` draws them from a
`torch.Generator`.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.device import constant, uniform
from sigmarl_tpu_torch.env.map_tables import MapTables
from sigmarl_tpu_torch.env.structs import EnvConfig, WorldState, replace_state, zero_state
from sigmarl_tpu_torch.env.updates import (
    push_state_buffer,
    refresh_geometry_after_reset,
    update_geometry,
    update_short_term_paths,
)
from sigmarl_tpu_torch.ops.spawn import spawn_place

Tensor = torch.Tensor


@dataclass
class ResetDraws:
    """Random numbers of one reset.

    scenario_gumbel: [B, 3] Gumbel noise of the per-env scenario-group draw
        (cpm_mixed only; None elsewhere).
    path_u: [B, N, T] uniforms choosing each candidate's path (full-width
        spawn; None where only the compacted spawn was drawn).
    point_u: [B, N, T] uniforms choosing each candidate's spawn point.
    speed_u: [B, N] uniforms scaling the spawn speed.

    With the challenging initial-state buffer on (None otherwise):
    use_u: [B] uniforms deciding which full-env resets replay a record.
    pick: [B] int, the buffer slot each env replays; or [CB, B], whose row
        v - 1 holds the picks for v valid records (a test passes the JAX
        package's `randint` draws for every count so).
    record_u: [] the step's uniform compared with `probability_record`
        (drawn every step, reset or not; `RoadTrafficEnv.step` reads it).

    The compacted spawn's (None where it was not drawn):
    path_u_c, point_u_c: [S, N, T], S = 3B/8 of the global batch; row s
        serves the s-th resetting env of the whole batch, on every rank
        (`for_envs` leaves them whole).
    """

    scenario_gumbel: Tensor | None
    path_u: Tensor | None
    point_u: Tensor | None
    speed_u: Tensor
    use_u: Tensor | None = None
    pick: Tensor | None = None
    record_u: Tensor | None = None
    path_u_c: Tensor | None = None
    point_u_c: Tensor | None = None

    @classmethod
    def sample(
        cls, cfg: EnvConfig, generator: torch.Generator, device, cb_valid: Tensor | None = None,
        compact_slots: int = 0, full: bool = True,
    ) -> "ResetDraws":
        """Draw a reset's random numbers: the full-width spawn's uniforms
        when `full`, the compacted spawn's [compact_slots, N, T] when
        `compact_slots` > 0 (a caller that draws before it knows the
        branch asks for both). `cb_valid` (the state's count of valid
        records, on the device) bounds the replay pick, which is drawn as
        floor(u * max(cb_valid, 1)) without a host sync. The uniforms are
        drawn on the generator's device and moved to `device`, so a host
        generator gives the same draws on every device."""
        B, N, T = cfg.batch_dim, cfg.n_agents, cfg.max_spawn_tries

        def u(*shape):
            return uniform(shape, generator, device)

        gumbel = None
        if cfg.scenario_type == "cpm_mixed":
            gumbel = -torch.log(-torch.log(u(B, 3).clamp(min=1e-20)))
        path_u, point_u = (u(B, N, T), u(B, N, T)) if full else (None, None)
        compact = (u(compact_slots, N, T), u(compact_slots, N, T)) if compact_slots > 0 else ()
        draws = cls(gumbel, path_u, point_u, u(B, N), None, None, None, *compact)
        if cfg.is_challenging_initial_state_buffer:
            n = torch.clamp(cb_valid if cb_valid is not None
                            else torch.zeros((), dtype=torch.int32, device=device), min=1)
            draws.use_u = u(B)
            draws.pick = torch.minimum((u(B) * n).to(torch.int64), (n - 1).to(torch.int64))
        return draws


    def to(self, device) -> "ResetDraws":
        return ResetDraws(**{f.name: None if getattr(self, f.name) is None
                             else getattr(self, f.name).to(device) for f in fields(self)})

    def for_envs(self, envs: slice) -> "ResetDraws":
        """The draws of the envs `envs` (a rank's share of a sharded batch):
        the record's uniform and the compacted spawn's rows are global, a
        [CB, B] pick table is cut on its env axis."""

        def cut(x):
            return None if x is None else x[envs]

        pick = self.pick
        if pick is not None:
            pick = pick[envs] if pick.dim() == 1 else pick[:, envs]
        return ResetDraws(cut(self.scenario_gumbel), cut(self.path_u), cut(self.point_u),
                          cut(self.speed_u), cut(self.use_u), pick, self.record_u,
                          self.path_u_c, self.point_u_c)


def compact_slots(global_batch: int, challenge_buffer: bool) -> int:
    """Slots of the compacted spawn at `global_batch` envs: 3B/8 from 1024
    envs up with the challenge buffer off (its replay works at full
    width), else 0 (no compaction). A reset step with more resetting envs
    than slots spawns at full width."""
    if global_batch >= 1024 and not challenge_buffer:
        return (3 * global_batch) // 8
    return 0


def _sample_scenario_ids(cfg: EnvConfig, draws: ResetDraws, B: int, device) -> Tensor:
    """Per-env scenario-group id: {1, 2, 3} for cpm_mixed (categorical by
    the Gumbel-max trick), else 0."""
    if cfg.scenario_type != "cpm_mixed":
        return torch.zeros((B,), dtype=torch.int32, device=device)
    probs = constant(tuple(cfg.cpm_scenario_probabilities), torch.float32, torch.device(device))
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
    path_u: Tensor,
    point_u: Tensor,
    scenario_id: Tensor,
    prev_pos: Tensor,
    reset_mask: Tensor,
):
    """Sample feasible spawn poses for the masked agents of each env.

    path_u, point_u [B, N, T] the candidates' uniforms; scenario_id [B];
    prev_pos [B, N, 2] (non-reset agents keep these and constrain the
    reset agents); reset_mask [B, N]. Returns (pos, rot, path_id,
    point_id), each [B, N, ...].
    """
    B, N = prev_pos.shape[:2]
    T = cfg.max_spawn_tries
    cand_path = _sample_candidate_paths(tables, path_u, scenario_id)  # [B, N, T]
    cp = cand_path.long()
    n_pts = tables.n_points_long_term[cp]
    cand_point = _candidate_point_ids(cfg, point_u, n_pts)  # [B, N, T]
    cand_pos = tables.long_term[cp, cand_point.long()]  # [B, N, T, 2]

    placed_pos = prev_pos.clone()
    placed_mask = ~reset_mask
    min_d2 = cfg.reset_agent_min_distance**2
    b_idx = torch.arange(B, device=prev_pos.device)
    choices = []
    for n in range(N):
        with trace.span(".agent"):  # one agent placed; agents go in turn
            c_pos = cand_pos[:, n]  # [B, T, 2]
            diff = c_pos[:, :, None, :] - placed_pos[:, None, :, :]  # [B, T, N, 2]
            dist2 = (diff * diff).sum(-1)
            dist2 = torch.where(placed_mask[:, None, :], dist2,
                                torch.full_like(dist2, float("inf")))
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


def _spawn_positions_compact(
    cfg: EnvConfig,
    tables: MapTables,
    path_u_c: Tensor,
    point_u_c: Tensor,
    scenario_id: Tensor,
    prev_pos: Tensor,
    reset_mask: Tensor,
    first: int,
    count: int,
):
    """`spawn_positions` over only the `count` envs with a reset (their
    number, known on the host), with rows [first, first + count) of the
    compacted draws `path_u_c`, `point_u_c` [S, N, T]: the resetting envs
    are gathered in env order, spawned and scattered back. Returns what
    `spawn_positions` returns over all envs (the envs without a reset pass
    `prev_pos` through, zeros elsewhere)."""
    B, N = prev_pos.shape[:2]
    rot = torch.zeros((B, N), dtype=prev_pos.dtype, device=prev_pos.device)
    path_id = torch.zeros((B, N), dtype=torch.int32, device=prev_pos.device)
    point_id = torch.zeros_like(path_id)
    if count == 0:  # a rank without a resetting env
        return prev_pos, rot, path_id, point_id
    # envs[s] = the s-th resetting env, without a host sync: every other
    # env writes to a spare slot `count`, which is dropped.
    env_any = reset_mask.any(-1)
    slot = torch.where(env_any, torch.cumsum(env_any, 0) - 1, count)
    envs = torch.zeros(count + 1, dtype=torch.int64, device=prev_pos.device)
    envs = envs.scatter(0, slot, torch.arange(B, device=prev_pos.device))[:count]
    rows = slice(first, first + count)
    pos_s, rot_s, path_s, point_s = spawn_positions(
        cfg, tables, path_u_c[rows], point_u_c[rows], scenario_id[envs],
        prev_pos[envs], reset_mask[envs],
    )
    return (prev_pos.index_copy(0, envs, pos_s), rot.index_copy(0, envs, rot_s),
            path_id.index_copy(0, envs, path_s), point_id.index_copy(0, envs, point_s))


def apply_reset(
    cfg: EnvConfig, tables: MapTables, state: WorldState, reset_mask: Tensor, draws: ResetDraws,
    replay_count: Tensor | None = None, compact: tuple[int, int] | None = None,
) -> WorldState:
    """(Re)spawn the masked agents and refresh all derived state. With the
    challenge buffer on, `replay_count` (a one-element int64 tensor on the
    device), when given, is raised in place by the number of envs that
    replayed a record. `compact` = (first, count) spawns only the `count`
    envs with a reset, from rows [first, first + count) of the compacted
    draws (the JAX package's `apply_reset(..., compact_budget=)`; first is
    the number of resetting envs on the lower ranks of a sharded batch, 0
    in one process); the rest of the reset stays at full width."""
    B, N = state.pos.shape[:2]
    dev = state.pos.device
    with trace.span(".spawn"):
        full_env_reset = reset_mask.all(-1)
        new_scenario = _sample_scenario_ids(cfg, draws, B, dev)
        # Full resets draw a fresh scenario group; partial resets keep it.
        scenario_id_env = torch.where(full_env_reset, new_scenario, state.scenario_id[:, 0])
        if compact is not None:
            path_u, point_u = draws.path_u_c, draws.point_u_c
            if path_u is None or point_u is None:
                raise ValueError("a compacted reset needs ResetDraws.path_u_c and .point_u_c")
        else:
            path_u, point_u = draws.path_u, draws.point_u
            if path_u is None or point_u is None:
                raise ValueError("a full-width reset needs ResetDraws.path_u and .point_u")
        pos, rot, path_id, point_id = spawn_place(
            cfg, tables, path_u, point_u, scenario_id_env, state.pos, reset_mask, compact
        )
        speed_new = draws.speed_u * cfg.max_speed
        vel_new = torch.stack([speed_new * torch.cos(rot), speed_new * torch.sin(rot)], dim=-1)
        if cfg.is_challenging_initial_state_buffer:
            use, replayed = _replay_records(
                cfg, state, draws, full_env_reset, reset_mask,
                pos, rot, speed_new, vel_new, path_id, point_id, scenario_id_env,
            )
            pos, rot, speed_new, vel_new, path_id, point_id, scenario_id_env = replayed
            if replay_count is not None:
                replay_count += use.sum()

    with trace.span(".geometry"):
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
        if cfg.is_challenging_initial_state_buffer:
            # Replayed poses are arbitrary: recompute the derived geometry
            # (the collision flags are cleared below for the envs that reset).
            state = update_geometry(cfg, tables, state, skip_collisions=True)
        else:
            # Spawned poses are spawn-table entries: derived geometry is a
            # gather.
            state = refresh_geometry_after_reset(cfg, tables, state, reset_mask)
    with trace.span(".paths"):
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


def _replay_records(cfg, state, draws, full_env_reset, reset_mask,
                    pos, rot, speed, vel, path_id, point_id, scenario_id_env):
    """Replace the spawned poses of the full-env resets that replay a
    recorded state (record rows [x, y, rot, vx, vy, scenario, path, point]).
    The speed is the recorded velocity's norm (the reference leaves it
    stale; a documented divergence the JAX package makes too). Returns
    (which envs replay [B], the replaced fields)."""
    if draws.use_u is None or draws.pick is None:
        raise ValueError("the challenge buffer's reset needs ResetDraws.use_u and .pick")
    valid = state.cb_valid
    use = (draws.use_u < cfg.probability_use_recording) & full_env_reset & (valid >= 1)
    pick = draws.pick
    if pick.dim() == 2:
        pick = pick[torch.clamp(valid.long() - 1, min=0)]
    rec = state.challenge_buffer[pick.long()]  # [B, N, 8]
    m = use[:, None] & reset_mask
    m2 = m[..., None]
    vel_rec = rec[..., 3:5]
    return use, (
        torch.where(m2, rec[..., 0:2], pos),
        torch.where(m, rec[..., 2], rot),
        torch.where(m, torch.sqrt((vel_rec * vel_rec).sum(-1)), speed),
        torch.where(m2, vel_rec, vel),
        torch.where(m, rec[..., 6].to(torch.int32), path_id),
        torch.where(m, rec[..., 7].to(torch.int32), point_id),
        torch.where(use, rec[:, 0, 5].to(torch.int32), scenario_id_env),
    )


def initial_state(
    cfg: EnvConfig, tables: MapTables, draws: ResetDraws, device
) -> WorldState:
    """Fresh world state with all envs spawned."""
    state = zero_state(cfg, device)
    mask = torch.ones((cfg.batch_dim, cfg.n_agents), dtype=torch.bool, device=device)
    return apply_reset(cfg, tables, state, mask, draws)
