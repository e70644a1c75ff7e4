"""Typed run configuration.

The port's copy of the JAX package's `Parameters`: same field names and
defaults (apart from `device`), JSON round-trip (`from_json` / `from_dict`
/ `to_dict`) and the derived `frames_per_batch` / `total_frames`
properties, so a configuration file serves both packages.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional


def get_model_name(parameters: "Parameters") -> str:
    """Default model-directory name (reference `helper_common.py` get_model_name)."""
    return f"nags{parameters.n_agents}_it{parameters.n_iters}_mbs{parameters.minibatch_size}_seed{parameters.random_seed}"


@dataclass
class Parameters:
    # General
    n_agents: int = 4
    dt: float = 0.05  # [s] sample time
    # Torch device the entry points use when the caller passes none
    # ("cuda" or "cpu"); "cuda" without a card raises.
    device: str = "cuda"
    scenario_name: str = "road_traffic"

    # Training
    n_iters: int = 250
    num_epochs: int = 30
    minibatch_size: int = 512
    lr: float = 2e-4
    lr_min: float = 1e-5
    max_grad_norm: float = 1.0
    clip_epsilon: float = 0.2
    gamma: float = 0.99
    lmbda: float = 0.9
    entropy_eps: float = 1e-4
    max_steps: int = 128
    num_vmas_envs: int = 32  # number of vectorized environments (batch dim)
    scenario_type: str = "intersection_1"

    episode_reward_mean_current: float = 0.00
    episode_reward_intermediate: float = -1e3
    is_prb: bool = False
    is_challenging_initial_state_buffer: bool = False
    cpm_scenario_probabilities: List[float] = field(default_factory=lambda: [1.0, 0.0, 0.0])
    n_steps_stored: int = 10

    # Observation
    n_points_short_term: int = 3
    is_partial_observation: bool = True
    n_nearing_agents_observed: int = 2
    # Observation feature history (reference `n_stored_steps` /
    # `n_observed_steps`, both defaulting to 1)
    n_stored_steps: int = 1
    n_observed_steps: int = 1
    # Debug-mode numerics guards (finiteness checks on rewards and losses).
    debug_numerics: bool = False

    # Ablation switches
    is_ego_view: bool = True
    is_apply_mask: bool = True
    is_observe_distance_to_agents: bool = True
    is_observe_distance_to_boundaries: bool = True
    is_observe_distance_to_center_line: bool = True
    is_observe_vertices: bool = True
    is_obs_noise: bool = True
    obs_noise_level: float = 0.05
    is_observe_ref_path_other_agents: bool = False
    is_use_mtv_distance: bool = True

    # Visualization
    is_visualize_short_term_path: bool = True
    is_visualize_lane_boundary: bool = False
    is_real_time_rendering: bool = False
    is_visualize_extra_info: bool = True
    render_title: str = ""

    # Save / load
    is_save_intermediate_model: bool = True
    is_load_model: bool = False
    is_load_final_model: bool = False
    model_name: Optional[str] = None
    where_to_save: str = "outputs/"
    is_continue_train: bool = False
    is_save_eval_results: bool = True
    is_load_out_td: bool = False
    is_testing_mode: bool = False
    is_save_simulation_video: bool = False

    # Extensions
    is_using_opponent_modeling: bool = False
    is_using_prioritized_marl: bool = False
    prioritization_method: str = "marl"  # {"marl", "random"}
    is_communication_noise: bool = False
    communication_noise_level: float = 0.1
    is_using_cbf_testing: bool = False
    is_using_cbf_training: bool = False
    is_using_centralized_cbf: bool = False
    is_apply_cbf_action: bool = False
    is_solve_qp: bool = True
    experiment_type: str = "simulation"  # {"simulation", "lab"}
    is_obs_steering: bool = False
    predefined_ref_path_idx: Optional[List[int]] = None
    init_state: Optional[List[float]] = None
    random_seed: int = 0
    is_using_pseudo_distance: bool = False
    n_circles_approximate_vehicle: int = 3
    lane_width: float = 0.25  # custom scenarios only
    reset_agent_fixed_duration: int = 0
    is_grouping_agents: bool = False
    max_group_size: int = 2
    observation_range: float = 0.5
    nom_controller_type: str = "rl"  # {"rl", "clf"}
    adaptive_lambda: bool = False
    rs: float = 0.5  # responsibility share in (0, 1) for cross-group CBF constraints
    h_nom: float = 0.2
    rew_method: str = "distance"  # {"distance","cbf","ttc","sparse","*_sparse"}
    reward_progress: float = 0.10
    threshold_near_boundary_high: float = 0.02
    threshold_near_boundary_low: float = 0.0
    threshold_near_other_agents_c2c_high: float = 0.3
    threshold_near_other_agents_c2c_low: float = 0.0
    ttc_low: float = 0.0
    ttc_high: float = 3.75
    penalty_near_boundary: float = -0.2
    penalty_near_other_agents: float = -0.2

    def __post_init__(self):
        if self.model_name is None and self.scenario_name is not None:
            self.model_name = get_model_name(self)

    @property
    def frames_per_batch(self) -> int:
        """Team frames collected per training iteration."""
        return self.num_vmas_envs * self.max_steps

    @property
    def total_frames(self) -> int:
        return self.frames_per_batch * self.n_iters

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, dict_data: dict) -> "Parameters":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dict_data.items() if k in known})

    @classmethod
    def from_json(cls, config_file: str) -> "Parameters":
        with open(config_file, "r") as f:
            return cls.from_dict(json.load(f))

    def to_json(self, config_file: str) -> None:
        with open(config_file, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
