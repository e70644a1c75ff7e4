"""Recorded evaluation rollouts.

A host loop over steps collecting the per-step info record (positions,
rotations, velocities, nominal and applied actions, distances, collision
flags, reward breakdown, the filter's diagnostics), with the CBF filter
between the policy and the env step when one is given. The records stay on
the device and are copied to the host once per chunk of steps: one
synchronisation per chunk.

Spans: `eval.rollout` around a rollout, `eval.record` around a chunk's
stack, copies and synchronisation (counted as a sync); the count
`eval.record.bytes` adds the bytes a chunk copies.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.env.env import RoadTrafficEnv
from sigmarl_tpu_torch.env.reset import ResetDraws
from sigmarl_tpu_torch.rl.networks import (
    policy_from_jax_params, tanh_normal_mode, tanh_normal_sample,
)
from sigmarl_tpu_torch.safety.cbf_qp import CBFSafetyFilter
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step

Tensor = torch.Tensor

_RECORD_KEYS = [
    "pos", "rot", "vel", "distance_ref", "distance_left_b", "distance_right_b",
    "is_collision_with_agents", "is_collision_with_lanelets", "is_reach_goal",
    "path_id", "nominal_action", "applied_action",
    "rew_progress", "rew_total",
    "cbf_solved", "cbf_infeasible", "cbf_max_violation",
]

# policy_fn(obs [B, N, obs_dim], generator, noise) -> actions [B, N, 2];
# `noise` is the step's action noise when the caller gives it, else None.
PolicyFn = Callable[[Tensor, Optional[torch.Generator], Optional[Tensor]], Tensor]


@dataclass
class StepDraws:
    """Random numbers of one rollout step (any left None come from the
    generator): the policy's action noise, the filter's observation-noise
    uniforms, the env step's reset draws and observation-noise uniforms."""

    action_noise: Tensor | None = None
    cbf_noise: Tensor | None = None
    reset: ResetDraws | None = None
    obs_noise: Tensor | None = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    trace.count_sync(device)


@trace.span("eval.rollout")
def rollout(
    env: RoadTrafficEnv,
    policy_fn: PolicyFn,
    max_steps: int,
    generator: torch.Generator | None = None,
    cbf: Optional[CBFSafetyFilter] = None,
    state: Optional[Tuple] = None,
    chunk: int = 32,
    draws: Sequence[StepDraws] | None = None,
    reset_draws: ResetDraws | None = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """Run a recorded rollout of `max_steps` steps from `state` (a (state,
    obs) pair) or from `env.reset` (with `reset_draws` when given).

    Returns (record dict of [T, B, N, ...] numpy arrays: `_RECORD_KEYS`
    present in the step's info, `reward` and `done`; timing dict:
    env-steps/s, wall seconds and ms per step, each chunk timed from its
    first step to its records on the host)."""
    dev = env.device
    if state is None:
        state, obs = env.reset(generator=generator, draws=reset_draws)
    else:
        state, obs = state
    records = []
    t_total = 0.0
    for c0 in range(0, max_steps, chunk):
        n = min(chunk, max_steps - c0)
        t0 = time.perf_counter()
        steps = []
        for t in range(c0, c0 + n):
            d = draws[t] if draws is not None else StepDraws()
            actions = policy_fn(obs, generator, d.action_noise)
            if cbf is not None:
                state, obs, reward, done, info = cbf_filtered_step(
                    env, cbf, state, actions, generator=generator, reset_draws=d.reset,
                    cbf_noise=d.cbf_noise, obs_noise=d.obs_noise,
                )
            else:
                state, obs, reward, done, info = env.step(
                    state, actions, generator=generator, reset_draws=d.reset,
                    obs_noise=d.obs_noise,
                )
            rec = {k: info[k] for k in _RECORD_KEYS if k in info}
            rec["reward"] = reward
            rec["done"] = done
            steps.append(rec)
        # One copy per key, all queued behind the chunk's steps, and one
        # synchronisation before the host reads them.
        with trace.span("eval.record"):
            stacked = {k: torch.stack([r[k] for r in steps]) for k in steps[0]}
            host = {k: v.to("cpu", non_blocking=dev.type == "cuda") for k, v in stacked.items()}
            trace.count("eval.record.bytes",
                        sum(v.numel() * v.element_size() for v in stacked.values()))
            _sync(dev)
        t_total += time.perf_counter() - t0
        records.append({k: v.numpy() for k, v in host.items()})
    out = {k: np.concatenate([r[k] for r in records], axis=0) for k in records[0]}
    timings = {
        "steps_per_s": max_steps * env.batch_dim / max(t_total, 1e-9),
        "wall_time_s": t_total,
        "time_per_step_ms": t_total / max_steps * 1e3,
    }
    return out, timings


def checkpoint_policy(policy_params, env: RoadTrafficEnv, deterministic: bool = False) -> PolicyFn:
    """The policy of a checkpoint's flax parameter tree (numpy, as
    `rl/checkpoint.py::load_best` gives it) on the env's device: a
    TanhNormal sample, or its mode when `deterministic`."""
    policy = policy_from_jax_params(policy_params, device=env.device)
    high = env.action_limits
    low = -high

    @torch.no_grad()
    def policy_fn(obs, generator, noise):
        loc, scale = policy(obs)
        if deterministic:
            return tanh_normal_mode(loc, low, high)
        return tanh_normal_sample(loc, scale, low, high, generator=generator, noise=noise)[0]

    return policy_fn


def constant_speed_policy(env: RoadTrafficEnv, speed: float = 0.5) -> PolicyFn:
    """(speed, 0) for every agent: the scripted nominal action of the runs
    without a model (the CLF controller replaces it inside the filter)."""
    act = torch.zeros((env.batch_dim, env.n_agents, 2), device=env.device)
    act[..., 0] = speed
    return lambda obs, generator, noise: act
