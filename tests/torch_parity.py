"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: matching environments, state conversion and the JAX package's
random draws for the port's reset."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import sigmarl_tpu.config as jcfg
import sigmarl_tpu_torch.config as tcfg
from sigmarl_tpu.env import make_env as jax_make_env
from sigmarl_tpu.env.env import RoadTrafficEnv as JEnv
from sigmarl_tpu.env.structs import EnvConfig as JEnvConfig
from sigmarl_tpu_torch.constants import SCENARIOS
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


@dataclasses.dataclass(frozen=True)
class DrawShape:
    """The settings of an env config that `reset_draw_arrays` reads: one
    compiled draw function serves every config of the same shapes."""

    batch_dim: int
    n_agents: int
    max_spawn_tries: int
    scenario_type: str  # "cpm_mixed" or "other": only the former draws Gumbel noise
    is_challenging_initial_state_buffer: bool
    challenge_buffer_size: int

    @classmethod
    def of(cls, cfg) -> "DrawShape":
        return cls(cfg.batch_dim, cfg.n_agents, cfg.max_spawn_tries,
                   "cpm_mixed" if cfg.scenario_type == "cpm_mixed" else "other",
                   cfg.is_challenging_initial_state_buffer, cfg.challenge_buffer_size)


# One compiled function per draw shape: eager JAX compiles each operation.
_reset_draw_arrays_jit = jax.jit(reset_draw_arrays, static_argnums=1)


def compact_spawn_arrays(key, cfg, budget: int):
    """The candidates' path and point uniforms that the JAX package's
    `apply_reset(..., key, compact_budget=budget)` draws: `spawn_positions`
    splits the spawn key as at full width, but draws at the compacted
    call's [budget, N, T] shape; traceable."""
    _, k_spawn, _ = jax.random.split(key, 3)
    k_path, k_point = jax.random.split(k_spawn)
    shape = (budget, cfg.n_agents, cfg.max_spawn_tries)
    return jax.random.uniform(k_path, shape), jax.random.uniform(k_point, shape)


_compact_spawn_arrays_jit = jax.jit(compact_spawn_arrays, static_argnums=(1, 2))


def reset_draws(key, cfg, compact_budget: int = 0) -> ResetDraws:
    """The random numbers the JAX package's `apply_reset(..., key)` draws;
    with `compact_budget` > 0 also those of its compacted spawn at that
    budget (`path_u_c`, `point_u_c`), so that the draws serve either
    branch."""
    draws = as_reset_draws(_reset_draw_arrays_jit(key, DrawShape.of(cfg)))
    if compact_budget > 0:
        draws.path_u_c, draws.point_u_c = (
            torch.from_numpy(np.array(a))
            for a in _compact_spawn_arrays_jit(key, DrawShape.of(cfg), compact_budget))
    return draws


def step_reset_draws(key, cfg, compact_budget: int = 0) -> ResetDraws:
    """Draws of the reset inside the JAX package's `env.step(..., key)`
    (with `compact_budget`, of either branch, as `reset_draws`)."""
    k_reset, _ = jax.random.split(key)
    return reset_draws(k_reset, cfg, compact_budget)


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


@functools.lru_cache(maxsize=None)
def _jax_scenario_env(scenario: str, n_agents: int, batch: int):
    """The JAX package's env of `scenario` in training mode (building its
    map tables compiles a hundred small operations: built once per
    scenario)."""
    return jax_make_env(jcfg.Parameters(**params(scenario, n_agents, batch,
                                                 is_using_cbf_testing=False)))


def scenario_envs(scenario: str, n_agents: int, batch: int, testing: bool):
    """(JAX env, port env on the CPU) of `scenario` in training or testing
    mode, the JAX env on the map tables of `_jax_scenario_env`."""
    kw = params(scenario, n_agents, batch, is_using_cbf_testing=False, is_testing_mode=testing)
    base = _jax_scenario_env(scenario, n_agents, batch)
    cfg = dataclasses.replace(JEnvConfig.from_parameters(jcfg.Parameters(**kw)),
                              has_lanelet_neighbors=base.cfg.has_lanelet_neighbors,
                              all_paths_loop=base.cfg.all_paths_loop)
    return JEnv(cfg, base.tables), torch_make_env(tcfg.Parameters(**kw), device="cpu")


def assert_scenario_matches_jax(scenario: str, testing: bool, batch: int = 4, steps: int = 3):
    """A reset and `steps` steps of `scenario` at N = min(4, its agents)
    and B = `batch` in both packages, with fast random actions (agents
    leave their lanes, collide and reset, alone in testing mode and in
    the recycling scenarios), each step from the same state and JAX's
    draws: states within 1e-4 (the boundary indices up to a float32 tie,
    `assert_idx_close`), rewards within 2e-5, observations within 1e-4,
    done flags and integer fields equal. Returns the number of envs that
    reset an agent over the steps."""
    from tests.test_torch_env import assert_state_close

    n = min(4, SCENARIOS[scenario].get("n_agents", 4))
    jenv, tenv = scenario_envs(scenario, n, batch, testing)
    key = jax.random.PRNGKey(sorted(SCENARIOS).index(scenario))
    k_reset, key = jax.random.split(key)
    state, jobs = jax.jit(jenv.reset)(k_reset)
    ts, tobs = tenv.reset(draws=env_reset_draws(k_reset, jenv.cfg))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    assert_state_close(ts, state, atol=1e-4, skip=IDX)
    assert_idx_close(ts, state, tenv.tables)
    jstep = jax.jit(jenv.step)
    for t in range(steps):
        k_act, k_step = jax.random.split(jax.random.fold_in(key, t))
        act = jax.random.uniform(k_act, (batch, n, 2), minval=-0.4, maxval=1.0)
        js, jobs, jrew, jdone, _ = jstep(state, act, k_step)
        ts, tobs, trew, tdone, _ = tenv.step(
            to_torch_state(state), torch.from_numpy(np.array(act)),
            reset_draws=step_reset_draws(k_step, jenv.cfg),
        )
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), err_msg=f"step {t}")
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=2e-5, rtol=1e-5,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5,
                                   err_msg=f"step {t}")
        assert_state_close(ts, js, atol=1e-4, skip=IDX)
        assert_idx_close(ts, js, tenv.tables)
        state = js
    return tenv.reset_steps


def scenario_group(i: int, n_groups: int = 5) -> list:
    """Every n_groups-th scenario of the registry from the i-th (the
    scenario tests spread over n_groups files, so that each runs in about
    a minute)."""
    return sorted(SCENARIOS)[i::n_groups]
