"""RoadTrafficEnv — the vectorized road-traffic MARL environment on tensors.

`step(state, actions)` -> (state', obs, reward, done, info) over
struct-of-tensors state `[B, N, ...]`, with auto-reset folded in:

1. dynamics (`command_step`) from (speed, steering) targets
2. `update_geometry`: vertices, distances, collisions
3. rewards (use the previous step's recorded pose and short-term window;
   under `debug_numerics` a non-finite reward raises)
4. state-buffer push, short-term path refresh
5. done logic (in testing mode an agent that collides or reaches its
   entry or exit is reset alone); with the challenging initial-state
   buffer on, the record of envs with an agent-agent collision; masked
   auto-reset, its spawn compacted to the resetting envs where at least
   1024 envs run and at most 3/8 of them reset
6. observation of the post-reset state

On the card, 1 to 5 (up to the host's read of the number of resetting
envs) and 6 replay CUDA graphs (`env/step_graphs.py`); the reset is eager.

`reset_predefined` and `reset_from_poses` start every env from given
poses instead of random spawns.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.core import geometry as G
from sigmarl_tpu_torch.core.dynamics import BicycleParams, command_step
from sigmarl_tpu_torch.device import constant, resolve_device, uniform
from sigmarl_tpu_torch.env.map_tables import MapTables, build_map_tables
from sigmarl_tpu_torch.env.observations import observe_with_history
from sigmarl_tpu_torch.env.reset import ResetDraws, apply_reset, compact_slots, initial_state
from sigmarl_tpu_torch.env.rewards import compute_rewards
from sigmarl_tpu_torch.env.step_graphs import step_graphed
from sigmarl_tpu_torch.env.structs import EnvConfig, WorldState, replace_state, zero_state
from sigmarl_tpu_torch.env.updates import (
    latest_state_record,
    push_state_buffer,
    update_geometry,
    update_short_term_paths,
)
from sigmarl_tpu_torch.maps.manager import load_map
from sigmarl_tpu_torch.utils.debug import assert_finite, enable_debug_numerics

Tensor = torch.Tensor


class RoadTrafficEnv:
    """Environment facade: the static config and the map tables on one
    device; `reset` and `step` are functions of the state."""

    def __init__(self, cfg: EnvConfig, tables: MapTables, device: torch.device, shard=None):
        self.cfg = cfg
        self.tables = tables
        self.device = device
        # With a `parallel.mesh.Shard`, this env holds one rank's envs of a
        # sharded batch, and the steps decided over every env (whether any
        # env resets, the challenge buffer's record) take a collective.
        self.shard = shard
        self.bicycle = BicycleParams()
        S = cfg.n_points_short_term
        w = np.linspace(1.0, 0.2, S, dtype=np.float32)
        self.weighting_ref = torch.as_tensor(w / w.sum(), device=device)
        # Steps in which the masked reset ran, and of those the steps whose
        # spawn was compacted and those at full width (counted on the host).
        self.reset_steps = self.compact_reset_steps = self.full_reset_steps = 0
        # With the challenge buffer on: states recorded and full-env resets
        # that replayed a record, accumulated on the device (no host sync).
        # The card's step graphs add into this tensor: zero it in place,
        # never rebind it.
        self.challenge_counts = torch.zeros(2, dtype=torch.int64, device=device)
        self._graphs = {}  # the card's step graphs, by input key (`env/step_graphs.py`)

    @property
    def global_batch(self) -> int:
        """Envs of the whole batch: every rank's when sharded."""
        return self.cfg.batch_dim * (1 if self.shard is None else self.shard.world)

    @property
    def obs_dim(self) -> int:
        return self.cfg.obs_dim

    @property
    def n_agents(self) -> int:
        return self.cfg.n_agents

    @property
    def batch_dim(self) -> int:
        return self.cfg.batch_dim

    @property
    def action_limits(self) -> Tensor:
        """Per-dimension action bounds [2]: (max_speed, max_steering)."""
        return constant((self.cfg.max_speed, self.cfg.max_steering), torch.float32, self.device)

    def reset(
        self,
        generator: torch.Generator | None = None,
        draws: ResetDraws | None = None,
        obs_noise: Tensor | None = None,
    ) -> Tuple[WorldState, Tensor]:
        """Fresh episode state and initial observation. Random numbers come
        from `draws` and `obs_noise` (the observation noise's uniforms,
        [B, N, obs_dim]) or else from `generator`."""
        if draws is None:
            draws = ResetDraws.sample(self.cfg, generator, self.device)
        state = initial_state(self.cfg, self.tables, draws, self.device)
        obs, state = observe_with_history(
            self.cfg, self.tables, state, full_reset=True, noise=obs_noise, generator=generator
        )
        return state, obs

    @trace.span("env_step")
    def step(
        self,
        state: WorldState,
        actions: Tensor,
        generator: torch.Generator | None = None,
        reset_draws: ResetDraws | None = None,
        obs_noise: Tensor | None = None,
    ) -> Tuple[WorldState, Tensor, Tensor, Tensor, Dict[str, Tensor]]:
        """Advance one control period. actions [B, N, 2] (speed target,
        steering target). The reset's random numbers come from
        `reset_draws` or else from `generator`, and are drawn only when an
        env resets, in the shape of the spawn the step takes (compacted or
        full width; given draws that lack that spawn's uniforms raise a
        ValueError); the observation noise's uniforms [B, N, obs_dim] from
        `obs_noise` or else from `generator`. With the challenge buffer on,
        the record's uniform is `reset_draws.record_u` or else drawn from
        `generator` every step. Returns (state', obs [B,N,obs_dim], reward
        [B,N], done [B], info).

        CPU tensors, a sharded batch (its phases hold collectives) and
        `debug_numerics` (which reads the host) run the phases op by op.
        Otherwise the phases before the read of the resetting envs, and the
        observation after the reset, replay CUDA graphs captured at the
        first call of each input key (`env/step_graphs.py`); the read and
        the reset stay eager. Either way the returned tensors are the
        call's own, with the same numbers."""
        if not state.pos.is_cuda or self.shard is not None or self.cfg.debug_numerics:
            return self._step_eager(state, actions, generator, reset_draws, obs_noise)
        return step_graphed(self, state, actions, generator, reset_draws, obs_noise)

    def _step_eager(self, state, actions, generator, reset_draws, obs_noise):
        """The step's phases op by op (`step`'s arguments and result)."""
        with trace.span("env_step.dynamics"):
            state, prev_pos, prev_short_term = self._dynamics(state, actions)
        with trace.span("env_step.geometry"):
            state = update_geometry(self.cfg, self.tables, state)
        with trace.span("env_step.rewards"):
            reward, rew_info = compute_rewards(self.cfg, state, prev_pos, prev_short_term,
                                               self.weighting_ref)
            if self.cfg.debug_numerics:
                assert_finite(reward, "reward")
        with trace.span("env_step.paths"):
            state = self._paths(state)
        with trace.span("env_step.done"):
            record_u = self._record_u(reset_draws, generator)
            state, done, reset_mask, info, n_reset, n_recorded = self._done(
                state, rew_info, record_u)
            if n_recorded is not None:
                self.challenge_counts[0] += n_recorded
            counts = self._read_resets(n_reset)
        if sum(counts) > 0:
            with trace.span("env_step.reset"):
                state = self._reset(state, reset_mask, counts, reset_draws, generator)
        # The observation of the (possibly reset) state; the history slots
        # of the agents just reset are refilled with the new episode's
        # features.
        with trace.span("env_step.observe"):
            obs, state = observe_with_history(
                self.cfg, self.tables, state, reset_mask=reset_mask, noise=obs_noise,
                generator=generator)
        return state, obs, reward, done, info

    # The phases before the read of the resetting envs. The card's graphs
    # capture them (and `observe_with_history`): they read no host value,
    # make no tensor from one (constants come from `device.constant`) and
    # change nothing but what they return.

    def _dynamics(self, state: WorldState, actions: Tensor):
        """The bicycle step from the actions. Returns (state, the previous
        position and short-term window, which the rewards read)."""
        cfg = self.cfg
        prev_pos = latest_state_record(state)[..., 0:2]
        pos, rot, speed, steering, sideslip, vel = command_step(
            self.bicycle, state.pos, state.rot, state.speed, state.steering, actions, cfg.dt
        )
        prev_short_term = state.short_term
        state = replace_state(
            state,
            pos=pos, rot=rot, speed=speed, steering=steering, sideslip=sideslip, vel=vel,
            step=state.step + 1,
            nominal_action=actions if not cfg.is_using_cbf else state.nominal_action,
            applied_action=actions,
        )
        return state, prev_pos, prev_short_term

    def _paths(self, state: WorldState) -> WorldState:
        """State-buffer push, then the short-term windows' refresh."""
        return update_short_term_paths(self.cfg, self.tables, push_state_buffer(state))

    def _done(self, state: WorldState, rew_info: Dict[str, Tensor], record_u: Tensor | None):
        """Done flags and the reset mask, the step's info, the challenge
        buffer's record. Returns (state, done [B], reset_mask [B, N], info,
        the number of resetting envs [1], the number of envs recorded []
        or None without the buffer); the caller adds the last to
        `challenge_counts`."""
        done, reset_mask = self._done_and_reset_mask(state)
        info = dict(rew_info)
        info.update(
            pos=state.pos,
            rot=state.rot,
            vel=state.vel,
            distance_ref=state.d_ref,
            distance_left_b=state.d_left.min(-1).values,
            distance_right_b=state.d_right.min(-1).values,
            is_collision_with_agents=state.coll_agents.any(-1),
            is_collision_with_lanelets=state.coll_lanelets,
            is_reach_goal=state.coll_exit,
            path_id=state.path_id,
            nominal_action=state.nominal_action,
            applied_action=state.applied_action,
            terminal_step=state.step,
        )
        n_recorded = None
        if self.cfg.is_challenging_initial_state_buffer:
            state, n_recorded = record_challenging_states(self.cfg, state, record_u, self.shard)
        return state, done, reset_mask, info, reset_mask.any(-1).sum().reshape(1), n_recorded

    def _record_u(self, reset_draws: ResetDraws | None, generator) -> Tensor | None:
        """The challenge buffer's uniform of this step (None with the
        buffer off): `reset_draws.record_u`, else drawn from `generator`."""
        if not self.cfg.is_challenging_initial_state_buffer:
            return None
        record_u = None if reset_draws is None else reset_draws.record_u
        return uniform((), generator, self.device) if record_u is None else record_u

    def _read_resets(self, n_reset: Tensor) -> list:
        """The host reads how many envs reset (one device sync per step) and
        counts this rank's (`env_step.reset.envs`). Sharded, every rank's
        count, in rank order."""
        if self.shard is None:
            counts = [int(n_reset)]
        else:
            counts = self.shard.all_gather(n_reset).tolist()
        trace.count_sync(n_reset.device)
        trace.count("env_step.reset.envs", counts[0 if self.shard is None else self.shard.rank])
        return counts

    def _reset(self, state, reset_mask, counts: list, reset_draws, generator) -> WorldState:
        """The masked reset of a step in which `sum(counts)` envs reset:
        compacted where they fit the slots, else at full width. Sharded,
        the count is over every rank's envs (the reset also pushes every
        env's state buffer once more), and this rank's envs take the
        compacted draws' rows after the lower ranks' resetting envs."""
        cfg = self.cfg
        n_total = sum(counts)
        self.reset_steps += 1
        slots = compact_slots(self.global_batch, cfg.is_challenging_initial_state_buffer)
        compact = None
        if n_total <= slots:
            rank = 0 if self.shard is None else self.shard.rank
            compact = (sum(counts[:rank]), counts[rank])
            self.compact_reset_steps += 1
        else:
            self.full_reset_steps += 1
        if reset_draws is None:
            reset_draws = ResetDraws.sample(
                cfg, generator, self.device, state.cb_valid,
                compact_slots=slots if compact else 0, full=compact is None)
        return apply_reset(cfg, self.tables, state, reset_mask, reset_draws,
                           replay_count=self.challenge_counts[1:], compact=compact)

    def reset_predefined(
        self,
        init_state: Tensor,
        path_idx: Tensor,
        generator: torch.Generator | None = None,
        obs_noise: Tensor | None = None,
    ) -> Tuple[WorldState, Tensor]:
        """Reset every env from predefined poses and reference paths (the
        `predefined_ref_path_idx` / `init_state` parameters): init_state
        [N, 3] rows (x, y, rot) and path_idx [N], the same in every env;
        speed and steering zero. Observation noise as in `reset`."""
        cfg, tables = self.cfg, self.tables
        B, N = cfg.batch_dim, cfg.n_agents
        init_state = torch.as_tensor(init_state, dtype=torch.float32, device=self.device)
        pid = torch.as_tensor(path_idx, device=self.device).to(torch.int32).expand(B, N)
        state = replace_state(
            zero_state(cfg, self.device),
            pos=init_state[None, :, 0:2].expand(B, N, 2).contiguous(),
            rot=init_state[None, :, 2].expand(B, N).contiguous(),
            path_id=pid.contiguous(),
            scenario_id=tables.group_id[pid[0, 0].long()].expand(B, N).contiguous(),
        )
        return self._start_from_poses(state, generator, obs_noise)

    def reset_from_poses(
        self,
        pos: Tensor,
        rot: Tensor,
        generator: torch.Generator | None = None,
        obs_noise: Tensor | None = None,
    ) -> Tuple[WorldState, Tensor]:
        """Reset from externally measured poses (experiment_type "lab"):
        pos [B, N, 2], rot [B, N]. Each agent takes the reference path that
        minimizes (100 * perpendicular distance)^2 + |relative yaw at the
        closest point| (the first such path on a tie), speed and steering
        zero. Observation noise as in `reset`."""
        cfg, tables = self.cfg, self.tables
        B, N = cfg.batch_dim, cfg.n_agents
        K, L = tables.center_line_yaw.shape
        # Every agent against every candidate path: [B, N, 1, 2] vs [K, P, 2].
        d, idx = G.perpendicular_distances(
            pos[:, :, None, :], tables.long_term[None, None],
            tables.n_points_long_term[None, None].expand(B, N, K),
        )  # [B, N, K]
        yaw_at = torch.gather(
            tables.center_line_yaw[None, None].expand(B, N, K, L), -1,
            torch.clamp(idx.long() - 1, min=0)[..., None],
        )[..., 0]
        rel_yaw = torch.abs(torch.remainder(yaw_at - rot[..., None] + math.pi, 2 * math.pi) - math.pi)
        pid = torch.argmin((d * 100.0) ** 2 + rel_yaw, dim=-1)  # first index on ties
        state = replace_state(
            zero_state(cfg, self.device),
            pos=pos,
            rot=rot,
            path_id=pid.to(torch.int32),
            point_id=torch.gather(idx, -1, pid[..., None])[..., 0].to(torch.int32),
            scenario_id=torch.zeros((B, N), dtype=torch.int32, device=self.device),
        )
        return self._start_from_poses(state, generator, obs_noise)

    def _start_from_poses(self, state: WorldState, generator, obs_noise):
        """Derived state and the first observation of a state whose poses
        and paths are set."""
        cfg, tables = self.cfg, self.tables
        state = update_geometry(cfg, tables, state)
        state = update_short_term_paths(cfg, tables, state, at_reset=True)
        state = push_state_buffer(state)
        obs, state = observe_with_history(
            cfg, tables, state, full_reset=True, noise=obs_noise, generator=generator
        )
        return state, obs

    def _done_and_reset_mask(self, state: WorldState) -> Tuple[Tensor, Tensor]:
        """Per-env done flag and the agent reset mask."""
        cfg = self.cfg
        B, N = cfg.batch_dim, cfg.n_agents
        if cfg.reset_agent_fixed_duration > 0:
            t = state.step.to(torch.float32) * cfg.dt
            fixed = (torch.remainder(t, float(cfg.reset_agent_fixed_duration)) == 0) & (t != 0)
        else:
            fixed = torch.zeros((B,), dtype=torch.bool, device=state.step.device)
        coll_ag = state.coll_agents.reshape(B, -1).any(-1)
        coll_ll = state.coll_lanelets.any(-1)
        max_steps = state.step == (cfg.max_steps - 1)
        if cfg.is_testing_mode:
            # An agent that collides or reaches its entry or exit is reset
            # alone; the episode ends only at max_steps or the fixed period.
            done = max_steps | fixed
            single = (
                state.coll_agents.any(-1) | state.coll_lanelets | state.coll_entry | state.coll_exit
            )
            reset_mask = (single & ~done[:, None]) | done[:, None]
            return done, reset_mask
        done = max_steps | coll_ag | coll_ll | fixed
        if cfg.scenario_type != "cpm_entire":
            # Recycle agents that crossed their entry or exit segment (non-loop
            # paths) without ending the episode.
            recycle = state.coll_entry | state.coll_exit
            reset_mask = (recycle & ~done[:, None]) | done[:, None]
        else:
            reset_mask = done[:, None].expand(B, N)
        return done, reset_mask


def record_challenging_states(
    cfg: EnvConfig, state: WorldState, record_u: Tensor, shard=None
) -> Tuple[WorldState, Tensor]:
    """Write the state from `n_steps_stored` steps back of every env with an
    agent-agent collision into the ring of `challenge_buffer_size` records,
    in env order, when `record_u <= probability_record` (the JAX package's
    sequential scan over envs). Where more envs record than the ring has
    slots, the later env wins: only the last `challenge_buffer_size`
    recording envs write, so no two writes share a slot. No host sync.

    With a `shard` the ring is global: every rank's collision flags and
    oldest records are gathered in rank order, which is env order, and
    rank 0's `record_u` decides for all, so every rank writes the same ring
    (one all-gather per step, on every rank whether its envs reset or not).
    Returns (state, number of this rank's envs that recorded [] on the
    device)."""
    B_local, C = cfg.batch_dim, cfg.challenge_buffer_size
    dev = state.pos.device
    collided = state.coll_agents.reshape(B_local, -1).any(-1)
    slot_old = (state.sb_pointer.long() % cfg.n_steps_stored).reshape(1)
    oldest = state.state_buffer.index_select(0, slot_old)[0]  # [B, N, 8]
    if shard is not None:
        packed = torch.cat([collided.to(oldest.dtype)[:, None], oldest.reshape(B_local, -1),
                            record_u.to(oldest).reshape(1, 1).expand(B_local, 1)], 1)
        packed = shard.all_gather(packed)
        collided, record_u = packed[:, 0] > 0, packed[0, -1]
        oldest = packed[:, 1:-1].reshape((-1,) + oldest.shape[1:])
    B = collided.shape[0]
    do = collided & (record_u <= cfg.probability_record)
    count = torch.cumsum(do.to(torch.int64), 0)
    total = count[-1]
    rank = count - 1
    keep = do & (rank >= total - C)
    slot = (state.cb_pointer.long() + rank) % C
    hit = keep[:, None] & (slot[:, None] == torch.arange(C, device=dev)[None])  # [B, C]
    env_idx = torch.arange(B, device=dev)[:, None].expand(B, C)
    writer = torch.where(hit, env_idx, torch.full_like(env_idx, -1)).amax(0)  # [C]
    buf = torch.where((writer >= 0)[:, None, None], oldest[torch.clamp(writer, min=0)],
                      state.challenge_buffer)
    return replace_state(
        state,
        challenge_buffer=buf,
        cb_pointer=((state.cb_pointer.long() + total) % C).to(torch.int32),
        cb_valid=torch.clamp(state.cb_valid.long() + total, max=C).to(torch.int32),
    ), total if shard is None else do[shard.env_slice(B)].sum()


REWARD_METHODS = (
    "distance", "ttc", "cbf", "sparse", "distance_sparse", "ttc_sparse", "cbf_sparse"
)


def _check_ported(p: Parameters) -> None:
    if p.rew_method not in REWARD_METHODS:
        raise NotImplementedError(
            f"the {p.rew_method!r} reward method is not ported to the PyTorch environment")


def make_env(
    parameters: Parameters, device: str | torch.device | None = None, shard=None
) -> RoadTrafficEnv:
    """Build an environment from run `Parameters` (map parse + table build)
    on `device`, by default `parameters.device` ("cuda"). With a
    `parallel.mesh.Shard` it holds that rank's B/W of the
    `num_vmas_envs` envs."""
    _check_ported(parameters)
    dev = resolve_device(device if device is not None else parameters.device)
    if parameters.debug_numerics:
        enable_debug_numerics()
    cfg = EnvConfig.from_parameters(parameters)
    map_data = load_map(parameters.scenario_type, lane_width=parameters.lane_width)
    if parameters.scenario_type == "cpm_mixed":
        table_paths = (
            map_data.reference_paths_intersection
            + map_data.reference_paths_merge_in
            + map_data.reference_paths_merge_out
        )
    else:
        table_paths = map_data.reference_paths
    if shard is not None:
        sl = shard.env_slice(cfg.batch_dim)
        cfg = dataclasses.replace(cfg, batch_dim=sl.stop - sl.start)
    cfg = dataclasses.replace(
        cfg,
        has_lanelet_neighbors=len(map_data.neighboring_lanelets_idx) > 0,
        all_paths_loop=all(p.is_loop for p in table_paths),
    )
    tables = build_map_tables(
        map_data, parameters.scenario_type, cfg.n_points_short_term,
        cfg.sample_interval_ref_path, device=dev,
    )
    return RoadTrafficEnv(cfg, tables, dev, shard)
