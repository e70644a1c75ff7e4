"""CBF-constrained environment steps: the filter runs between the policy
and the env step (`cbf_filtered_step`), or only its margins feed the
reward (`cbf_margin_step`)."""

from __future__ import annotations

import torch

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.env.env import RoadTrafficEnv
from sigmarl_tpu_torch.env.reset import ResetDraws
from sigmarl_tpu_torch.env.structs import WorldState, replace_state
from sigmarl_tpu_torch.safety.cbf_qp import CBFSafetyFilter


@trace.span("rollout_step")
def cbf_filtered_step(
    env: RoadTrafficEnv,
    cbf: CBFSafetyFilter,
    state: WorldState,
    rl_actions: torch.Tensor,
    generator: torch.Generator | None = None,
    apply_cbf_action: bool = True,
    reset_draws: ResetDraws | None = None,
    cbf_noise: torch.Tensor | None = None,
    obs_noise: torch.Tensor | None = None,
):
    """One env step through the CBF-QP safety filter, warm-started from the
    previous step's solution.

    With `apply_cbf_action` the filtered action is applied and the RL
    action recorded as nominal; otherwise the nominal action is applied and
    the would-be safe action recorded. `cbf_noise` is the filter's
    observation-noise draw (`CBFSafetyFilter.assemble`), `reset_draws` and
    `obs_noise` the env step's; what is not given comes from `generator`.
    Returns (state', obs, reward, done, info) with the filter's diagnostics
    merged into info."""
    finfo = cbf.filter_actions(
        state, rl_actions, u_init=state.cbf_u_prev, noise=cbf_noise, generator=generator
    )
    if apply_cbf_action:
        applied, nominal = finfo.safe_actions, finfo.nominal_actions
    else:
        applied, nominal = finfo.nominal_actions, finfo.safe_actions
    state = replace_state(
        state, nominal_action=nominal, applied_action=applied, cbf_u_prev=finfo.u_star
    )
    state, obs, reward, done, info = env.step(
        state, applied, generator=generator, reset_draws=reset_draws, obs_noise=obs_noise
    )
    info = dict(info)
    info.update(
        cbf_solved=finfo.solved,
        cbf_infeasible=finfo.infeasible,
        cbf_max_violation=finfo.max_violation,
        cbf_action_deviation=torch.abs(finfo.safe_actions - finfo.nominal_actions),
    )
    return state, obs, reward, done, info


def cbf_margin_step(
    env: RoadTrafficEnv,
    cbf: CBFSafetyFilter,
    state: WorldState,
    rl_actions: torch.Tensor,
    generator: torch.Generator | None = None,
    reset_draws: ResetDraws | None = None,
    cbf_noise: torch.Tensor | None = None,
    obs_noise: torch.Tensor | None = None,
):
    """One env step in margins-only mode (CBF-informed training,
    `is_solve_qp=False`): the shaping rewards from the constraint margins
    at the nominal action are written into the state for the "cbf" reward
    method, then the env steps with the unfiltered action. Draws as in
    `cbf_filtered_step`. Returns (state', obs, reward, done, info)."""
    rews = cbf.nominal_margin_rewards(state, rl_actions, noise=cbf_noise, generator=generator)
    state = replace_state(
        state,
        rew_near_left_lane=rews["rew_near_left_lane"],
        rew_near_right_lane=rews["rew_near_right_lane"],
        rew_near_other_agents_cbf=rews["rew_near_other_agents"],
    )
    return env.step(
        state, rl_actions, generator=generator, reset_draws=reset_draws, obs_noise=obs_noise
    )
