"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: matching environments, state conversion and the JAX package's
random draws for the port's reset."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import sigmarl_tpu.config as jcfg
import sigmarl_tpu_torch.config as tcfg
from sigmarl_tpu.env import make_env as jax_make_env
from sigmarl_tpu.env.env import RoadTrafficEnv as JEnv
from sigmarl_tpu_torch.core import geometry as G
from sigmarl_tpu_torch.env.env import RoadTrafficEnv as TEnv
from sigmarl_tpu_torch.env.env import make_env as torch_make_env
from sigmarl_tpu_torch.env.reset import ResetDraws
from sigmarl_tpu_torch.env.structs import WorldState


def params(scenario_type: str, n_agents: int, batch: int, **kw) -> dict:
    """Parameters of the filtered rollout (the port's supported options)."""
    base = dict(
        scenario_type=scenario_type, n_agents=n_agents, num_vmas_envs=batch, dt=0.1,
        max_steps=1_000_000, is_use_mtv_distance=False, is_obs_noise=False,
        is_using_cbf_testing=True, is_using_centralized_cbf=True,
    )
    base.update(kw)
    return base


def envs(**kw):
    """(JAX env, port env on the CPU) built from the same parameters."""
    jenv = jax_make_env(jcfg.Parameters(**kw))
    tenv = torch_make_env(tcfg.Parameters(**kw), device="cpu")
    return jenv, tenv


def env_variant(jenv, tenv, **changes):
    """Both envs with their configs changed (reward method, flags) and
    the same map tables, without building the tables again."""
    return (JEnv(dataclasses.replace(jenv.cfg, **changes), jenv.tables),
            TEnv(dataclasses.replace(tenv.cfg, **changes), tenv.tables, tenv.device))


def to_torch_state(state) -> WorldState:
    return WorldState(
        **{f.name: torch.from_numpy(np.array(getattr(state, f.name)))
           for f in dataclasses.fields(WorldState)}
    )


def to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def reset_draw_arrays(key, cfg):
    """The random numbers the JAX package's `apply_reset(..., key)` draws,
    as JAX arrays (scenario Gumbel noise or None, path, point and speed
    uniforms; with the challenge buffer on also the replay's uniforms, its
    picks for every count of valid records [CB, B], and the record's
    uniform, which the JAX step draws from the same key); traceable, so it
    maps over a batch of keys with `jax.vmap`."""
    B, N, T = cfg.batch_dim, cfg.n_agents, cfg.max_spawn_tries
    k_scen, k_spawn, k_speed = jax.random.split(key, 3)
    k_path, k_point = jax.random.split(k_spawn)
    gumbel = None
    if cfg.scenario_type == "cpm_mixed":
        gumbel = jax.random.gumbel(k_scen, (B, 3))
    out = (gumbel, jax.random.uniform(k_path, (B, N, T)),
           jax.random.uniform(k_point, (B, N, T)), jax.random.uniform(k_speed, (B, N)))
    if not cfg.is_challenging_initial_state_buffer:
        return out
    k_use, k_pick = jax.random.split(jax.random.fold_in(key, 7))
    counts = jnp.arange(1, cfg.challenge_buffer_size + 1)
    picks = jax.vmap(lambda v: jax.random.randint(k_pick, (B,), 0, v))(counts)
    return out + (jax.random.uniform(k_use, (B,)), picks, jax.random.uniform(key, ()))


def as_reset_draws(arrays) -> ResetDraws:
    return ResetDraws(*(None if a is None else torch.from_numpy(np.array(a)) for a in arrays))


# One compiled function per env config: eager JAX compiles each operation.
_reset_draw_arrays_jit = jax.jit(reset_draw_arrays, static_argnums=1)


def reset_draws(key, cfg) -> ResetDraws:
    """The random numbers the JAX package's `apply_reset(..., key)` draws."""
    return as_reset_draws(_reset_draw_arrays_jit(key, cfg))


def step_reset_draws(key, cfg) -> ResetDraws:
    """Draws of the reset inside the JAX package's `env.step(..., key)`."""
    k_reset, _ = jax.random.split(key)
    return reset_draws(k_reset, cfg)


def env_reset_draws(key, cfg) -> ResetDraws:
    """Draws of the JAX package's `env.reset(key)`."""
    k_state, _ = jax.random.split(key)
    return reset_draws(k_state, cfg)


def obs_noise_array(key, cfg):
    """The observation noise's uniforms [B, N, obs_dim] that the JAX
    package's `env.reset(key)` and `env.step(..., key)` draw (from the
    second half of their key split), as a JAX array; traceable."""
    _, k_obs = jax.random.split(key)
    return jax.random.uniform(k_obs, (cfg.batch_dim, cfg.n_agents, cfg.obs_dim))


def obs_noise_draws(key, cfg) -> torch.Tensor:
    return torch.from_numpy(np.array(obs_noise_array(key, cfg)))


# The boundary indices, which `assert_idx_close` compares.
IDX = ("idx_left", "idx_right")


def assert_idx_close(ts, js, tables):
    """Boundary indices equal, but where they differ both indices'
    segments lie at the same distance from the agent (to 1e-6): a pose on
    a spawn point can lie at one float32 distance from two segments."""
    for side in ("left", "right"):
        a = getattr(ts, f"idx_{side}")
        b = torch.from_numpy(np.array(getattr(js, f"idx_{side}")))
        bnd = getattr(tables, f"{side}_boundary")  # [K, PB, 2]
        for e, n in (a != b).nonzero().tolist():
            poly = bnd[int(ts.path_id[e, n])]
            d = [float(G.min_perpendicular_distance(ts.pos[e, n], poly[int(i) - 1:int(i) + 1]))
                 for i in (a[e, n], b[e, n])]
            assert abs(d[0] - d[1]) <= 1e-6, (side, e, n, d)
