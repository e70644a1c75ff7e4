"""Environment static configuration and dynamic state (dataclass of tensors)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Tuple

import torch

from benchmark.reference.config import Parameters
from benchmark.reference.constants import AGENTS, SCENARIOS

Array = torch.Tensor


@dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration.

    Derived from `Parameters` + scenario constants; everything the step
    function branches on in Python. Mirrors the reward/penalty/
    threshold/normalizer constants of the original SigmaRL
    `road_traffic.py:112-768`.
    """

    scenario_type: str
    n_agents: int
    batch_dim: int
    dt: float
    max_steps: int
    # Geometry constants
    agent_width: float = AGENTS["width"]
    agent_length: float = AGENTS["length"]
    lane_width: float = 0.15
    world_x_dim: float = 4.5
    world_y_dim: float = 4.0
    # Reference path sampling
    n_points_short_term: int = 3
    sample_interval_ref_path: int = 2
    n_points_nearing_boundary: int = 5
    # Distance type
    distance_type: str = "c2c"  # {"c2c", "mtv"}
    # Rewards (already normalized by r_p_normalizer=100 where applicable)
    reward_progress: float = 0.10
    reward_vel: float = 0.05
    reward_reach_goal: float = 1.0
    penalty_deviate_from_ref_path: float = -0.02
    penalty_near_boundary: float = -0.2
    penalty_near_other_agents: float = -0.2
    penalty_collide_with_agents: float = -1.0
    penalty_collide_with_boundaries: float = -1.0
    penalty_change_steering: float = -0.02
    penalty_time: float = 0.05
    penalty_deviate_from_cbf_vel: float = -0.05
    penalty_deviate_from_cbf_steer: float = -0.05
    # Thresholds
    threshold_reach_goal: float = AGENTS["width"] / 2
    threshold_deviate_from_ref_path: float = (0.15 - AGENTS["width"]) / 2
    threshold_near_boundary_low: float = 0.0
    threshold_near_boundary_high: float = 0.02
    threshold_near_other_agents_low: float = 0.0
    threshold_near_other_agents_high: float = 0.3
    ttc_low: float = 0.0
    ttc_high: float = 3.75
    threshold_no_reward_if_too_close_to_boundaries: float = AGENTS["width"] / 10
    threshold_no_reward_if_too_close_to_other_agents: float = AGENTS["width"] / 6
    distance_mask_agents: float = AGENTS["length"] * 5
    reset_agent_min_distance: float = (
        (AGENTS["length"] ** 2 + AGENTS["width"] ** 2) ** 0.5 * 1.5
    )
    # Normalizers (reference `road_traffic.py:587-608`)
    norm_pos: float = AGENTS["length"] * 10
    norm_v: float = AGENTS["max_speed"]
    norm_rot: float = 6.283185307179586  # 2*pi
    norm_steering: float = AGENTS["max_steering"]
    norm_distance_lanelet: float = 0.45  # lane_width * 3
    norm_distance_ref: float = 0.45
    norm_distance_agent: float = AGENTS["length"] * 10
    # Action bounds
    max_speed: float = AGENTS["max_speed"]
    max_steering: float = AGENTS["max_steering"]
    # Flags (observation design & modes)
    is_testing_mode: bool = False
    is_partial_observation: bool = True
    n_nearing_agents_observed: int = 2
    is_ego_view: bool = True
    is_apply_mask: bool = False
    is_observe_vertices: bool = True
    is_observe_distance_to_agents: bool = True
    is_observe_distance_to_boundaries: bool = True
    is_observe_distance_to_center_line: bool = True
    is_observe_ref_path_other_agents: bool = False
    is_obs_steering: bool = False
    # Observation feature history (reference `n_stored_steps` /
    # `n_observed_steps` CircularBuffers, `observation_provider_rt.py:100-339`;
    # the reference defaults both to 1 and only ever reads depth 1).
    n_stored_steps: int = 1
    n_observed_steps: int = 1
    is_obs_noise: bool = True
    obs_noise_level: float = 0.2 * AGENTS["width"]
    is_using_opponent_modeling: bool = False
    is_using_prioritized_marl: bool = False
    rew_method: str = "distance"
    reset_agent_fixed_duration: int = 0
    cpm_scenario_probabilities: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    n_steps_stored: int = 10
    # Spawn sampling: candidates drawn per respawning agent. The chosen
    # candidate distribution is budget-independent (first feasible of an
    # iid stream); the budget only bounds the all-infeasible fallback.
    # Testing mode uses 20 (set in from_parameters).
    max_spawn_tries: int = 12
    # Challenging initial-state buffer (reference `InitialStateBuffer`)
    is_challenging_initial_state_buffer: bool = False
    challenge_buffer_size: int = 100
    probability_record: float = 1.0
    probability_use_recording: float = 0.2
    # Whether the loaded map defines lanelet adjacency (set by make_env;
    # enables lanelet-based masking under is_apply_mask)
    has_lanelet_neighbors: bool = False
    # Static map property (set by make_env): every reference path is a loop,
    # so the entry/exit crossing sweeps are skipped (cpm_entire).
    all_paths_loop: bool = False
    # Top-k chunk pruning of the boundary CORNER sweeps in update_geometry
    # (same per-chunk bounding-circle bound as CBFConfig.pd_topk_chunks;
    # the gathered pseudo-distance segment rows double as (start, vec)
    # segment data). Exact wherever the true corner distance is below
    # every unselected chunk's bound — i.e. everywhere the boundary
    # rewards/observations actually resolve; collision predicates stay
    # full-scan (a top-k bound cannot guarantee hit coverage at crowded
    # intersections). 0 = full scan.
    geom_topk_chunks: int = 3
    debug_numerics: bool = False
    # CBF coupling (reward-from-margins written by the safety layer)
    is_using_cbf: bool = False
    is_solve_qp: bool = True

    def __post_init__(self):
        # History invariant: the rolled buffer must be at least as deep as
        # the observation window, or `observe_with_history` would have to
        # fabricate missing slots by duplicating the current features (the
        # silent-duplication trap; reference semantics store >= observe,
        # `observation_provider_rt.py:100-339`). `from_parameters` takes the
        # max; a direct construction must satisfy it explicitly.
        if self.n_observed_steps > self.n_stored_steps:
            raise ValueError(
                f"n_observed_steps={self.n_observed_steps} exceeds "
                f"n_stored_steps={self.n_stored_steps}: the observation "
                "window cannot be deeper than the stored history "
                "(set n_stored_steps >= n_observed_steps)."
            )

    @property
    def n_actions(self) -> int:
        return 2

    @property
    def world_semidiag(self) -> float:
        return (self.world_x_dim**2 + self.world_y_dim**2) ** 0.5

    @property
    def obs_others_dim(self) -> int:
        """Per-neighbor feature width (reference `_observe_other_agents`)."""
        d = 0
        d += 8 if self.is_observe_vertices else 5  # vertices vs pos/rot/len/width
        d += 2  # velocity
        if self.is_obs_steering:
            d += 1
        if self.is_observe_distance_to_agents:
            d += 1
        if self.is_observe_ref_path_other_agents:
            d += 2 * self.n_points_short_term
        return d

    @property
    def n_observed_agents(self) -> int:
        return (
            self.n_nearing_agents_observed
            if self.is_partial_observation
            else self.n_agents
        )

    @property
    def obs_self_dim(self) -> int:
        d = 0
        if not self.is_ego_view:
            d += 3  # own position + rotation (bird view only)
        d += 1 if self.is_ego_view else 2  # velocity (local x) vs global 2d
        if self.is_obs_steering:
            d += 1
        d += 2 * self.n_points_short_term  # short-term reference path
        if self.is_observe_distance_to_center_line:
            d += 1
        if self.is_observe_distance_to_boundaries:
            d += 2
        else:
            d += 2 * 2 * self.n_points_nearing_boundary
        return d

    @property
    def obs_core_dim(self) -> int:
        """Single-step feature width (one history slot)."""
        return self.obs_self_dim + self.n_observed_agents * self.obs_others_dim

    @property
    def obs_dim(self) -> int:
        d = self.obs_core_dim * self.n_observed_steps
        if self.is_using_opponent_modeling:
            d += self.n_nearing_agents_observed * self.n_actions
        return d

    @classmethod
    def from_parameters(cls, p: Parameters) -> "EnvConfig":
        scen = SCENARIOS[p.scenario_type]
        lane_width = scen.get("lane_width", p.lane_width)
        agent_width, agent_length = AGENTS["width"], AGENTS["length"]
        r_p = 100.0
        n_nearing = min(p.n_nearing_agents_observed, p.n_agents - 1)
        return cls(
            scenario_type=p.scenario_type,
            n_agents=p.n_agents,
            batch_dim=p.num_vmas_envs,
            dt=p.dt,
            max_steps=p.max_steps,
            lane_width=lane_width,
            world_x_dim=scen.get("world_x_dim", scen["x_dim_min"] + scen["x_dim_max"])
            if "x_dim_min" in scen
            else 4.5,
            world_y_dim=scen.get("world_y_dim", scen["y_dim_min"] + scen["y_dim_max"])
            if "y_dim_min" in scen
            else 4.0,
            n_points_short_term=p.n_points_short_term,
            distance_type="mtv" if p.is_use_mtv_distance else "c2c",
            reward_progress=p.reward_progress if p.reward_progress is not None else 0.1,
            reward_vel=5 / r_p,
            reward_reach_goal=100 / r_p,
            penalty_deviate_from_ref_path=-2 / r_p,
            penalty_near_boundary=p.penalty_near_boundary,
            penalty_near_other_agents=p.penalty_near_other_agents,
            penalty_collide_with_agents=-100 / r_p,
            penalty_collide_with_boundaries=-100 / r_p,
            penalty_change_steering=-2 / r_p,
            penalty_time=5 / r_p,
            threshold_deviate_from_ref_path=(lane_width - agent_width) / 2,
            threshold_near_boundary_low=p.threshold_near_boundary_low,
            threshold_near_boundary_high=p.threshold_near_boundary_high
            if p.threshold_near_boundary_high is not None
            else (lane_width - agent_width) / 2 * 0.9,
            threshold_near_other_agents_low=(
                p.threshold_near_other_agents_c2c_low
                if not p.is_use_mtv_distance
                else 0.0
            ),
            threshold_near_other_agents_high=(
                p.threshold_near_other_agents_c2c_high
                if not p.is_use_mtv_distance
                else agent_length
            ),
            ttc_low=p.ttc_low,
            ttc_high=p.ttc_high,
            norm_distance_lanelet=lane_width * 3,
            norm_distance_ref=lane_width * 3,
            is_testing_mode=p.is_testing_mode,
            max_spawn_tries=20 if p.is_testing_mode else 12,
            is_partial_observation=p.is_partial_observation,
            n_nearing_agents_observed=n_nearing,
            is_ego_view=p.is_ego_view,
            is_apply_mask=p.is_apply_mask,
            is_observe_vertices=p.is_observe_vertices,
            is_observe_distance_to_agents=p.is_observe_distance_to_agents,
            is_observe_distance_to_boundaries=p.is_observe_distance_to_boundaries,
            is_observe_distance_to_center_line=p.is_observe_distance_to_center_line,
            is_observe_ref_path_other_agents=p.is_observe_ref_path_other_agents,
            is_obs_steering=p.is_obs_steering,
            n_stored_steps=max(p.n_stored_steps, p.n_observed_steps),
            n_observed_steps=p.n_observed_steps,
            debug_numerics=p.debug_numerics,
            is_obs_noise=p.is_obs_noise,
            obs_noise_level=p.obs_noise_level
            if p.obs_noise_level is not None
            else 0.2 * agent_width,
            is_using_opponent_modeling=p.is_using_opponent_modeling,
            is_using_prioritized_marl=p.is_using_prioritized_marl,
            rew_method=p.rew_method,
            reset_agent_fixed_duration=p.reset_agent_fixed_duration,
            is_challenging_initial_state_buffer=p.is_challenging_initial_state_buffer,
            cpm_scenario_probabilities=tuple(p.cpm_scenario_probabilities),
            n_steps_stored=p.n_steps_stored,
            is_using_cbf=p.is_using_cbf_training or p.is_using_cbf_testing,
            is_solve_qp=p.is_solve_qp,
        )


@dataclass
class WorldState:
    """Dynamic environment state, struct-of-tensors over `[B, N, ...]`.

    Same fields, shapes and dtypes as the JAX package's `WorldState`
    (int32 indices, bool flags, float32 otherwise).
    """

    # Kinematic state
    pos: Array  # [B, N, 2]
    rot: Array  # [B, N]
    speed: Array  # [B, N]
    steering: Array  # [B, N]
    sideslip: Array  # [B, N]
    vel: Array  # [B, N, 2]
    # Reference-path assignment
    path_id: Array  # [B, N] int32 (index into MapTables)
    point_id: Array  # [B, N] int32 (spawn point index)
    scenario_id: Array  # [B, N] int32 (0 all / 1 intersection / 2 in / 3 out)
    # Derived caches carried across steps
    short_term: Array  # [B, N, S, 2]
    nearing_left: Array  # [B, N, NB, 2]
    nearing_right: Array  # [B, N, NB, 2]
    vertices: Array  # [B, N, 5, 2]
    d_ref: Array  # [B, N]
    idx_ref: Array  # [B, N] int32
    idx_left: Array  # [B, N] int32
    idx_right: Array  # [B, N] int32
    d_left: Array  # [B, N, 5]
    d_right: Array  # [B, N, 5]
    d_boundary: Array  # [B, N]
    d_agents: Array  # [B, N, N]
    coll_agents: Array  # [B, N, N] bool
    coll_lanelets: Array  # [B, N] bool
    coll_entry: Array  # [B, N] bool
    coll_exit: Array  # [B, N] bool
    # Step bookkeeping
    step: Array  # [B] int32
    # Observation feature history, newest slot first ([0, ...] when
    # n_stored_steps == 1: depth 1 carries no history).
    obs_history: Array  # [n_stored_steps or 0, B, N, obs_core_dim]
    state_buffer: Array  # [n_stored, B, N, 8] circular ([x,y,rot,vx,vy,scn,path,pt])
    sb_pointer: Array  # [] int32
    # Challenging initial-state buffer (not ported: stays empty)
    challenge_buffer: Array  # [CB, N, 8]
    cb_pointer: Array  # [] int32
    cb_valid: Array  # [] int32
    # Actions (nominal = policy output, applied = post-CBF)
    nominal_action: Array  # [B, N, 2]
    applied_action: Array  # [B, N, 2]
    # Previous CBF-QP solution (accel, steering rate): warm-starts the next
    # step's Newton solve.
    cbf_u_prev: Array  # [B, N, 2]
    # CBF-informed reward hooks (written by the safety layer when active)
    rew_near_left_lane: Array  # [B, N]
    rew_near_right_lane: Array  # [B, N]
    rew_near_other_agents_cbf: Array  # [B, N]


def replace_state(state: WorldState, **kw) -> WorldState:
    return replace(state, **kw)


def state_to(state: WorldState, device: torch.device) -> WorldState:
    """Move every tensor of a state to `device`."""
    return WorldState(
        **{f.name: getattr(state, f.name).to(device) for f in dataclasses.fields(state)}
    )


def zero_state(cfg: EnvConfig, device: torch.device | str) -> WorldState:
    """Allocate an all-zeros state with the correct shapes on `device`."""
    B, N = cfg.batch_dim, cfg.n_agents
    S, NB = cfg.n_points_short_term, cfg.n_points_nearing_boundary

    def f(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32 = torch.int32
    return WorldState(
        pos=f((B, N, 2)),
        rot=f((B, N)),
        speed=f((B, N)),
        steering=f((B, N)),
        sideslip=f((B, N)),
        vel=f((B, N, 2)),
        path_id=f((B, N), i32),
        point_id=f((B, N), i32),
        scenario_id=f((B, N), i32),
        short_term=f((B, N, S, 2)),
        nearing_left=f((B, N, NB, 2)),
        nearing_right=f((B, N, NB, 2)),
        vertices=f((B, N, 5, 2)),
        d_ref=f((B, N)),
        idx_ref=f((B, N), i32),
        idx_left=f((B, N), i32),
        idx_right=f((B, N), i32),
        d_left=f((B, N, 5)),
        d_right=f((B, N, 5)),
        d_boundary=f((B, N)),
        d_agents=f((B, N, N)),
        coll_agents=f((B, N, N), torch.bool),
        coll_lanelets=f((B, N), torch.bool),
        coll_entry=f((B, N), torch.bool),
        coll_exit=f((B, N), torch.bool),
        step=f((B,), i32),
        state_buffer=f((cfg.n_steps_stored, B, N, 8)),
        sb_pointer=f((), i32),
        challenge_buffer=f((cfg.challenge_buffer_size, N, 8)),
        cb_pointer=f((), i32),
        cb_valid=f((), i32),
        obs_history=f((cfg.n_stored_steps if cfg.n_stored_steps > 1 else 0,
                       B, N, cfg.obs_core_dim)),
        nominal_action=f((B, N, 2)),
        applied_action=f((B, N, 2)),
        cbf_u_prev=f((B, N, 2)),
        rew_near_left_lane=f((B, N)),
        rew_near_right_lane=f((B, N)),
        rew_near_other_agents_cbf=f((B, N)),
    )
