"""The environment and filter modes the port added for XP-MARL and the
papers' defaults, against the JAX package: the MTV distance, observation
noise (on the observation, the opponent-modeling pad included, and on the
filter's nominal input), observation history deeper than 1, and the
`debug_numerics` guard of the env step.

Tolerances: the MTV distance to atol 2e-5 (products and square roots of
float32 vertices); states and a step's rewards as in `test_torch_env.py`
(atol 2e-5), observations and the history to atol 1e-4, both from JAX's
uniform draws; constraint rows as in `test_torch_slice.py`."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sigmarl_tpu.core import geometry as JG
from sigmarl_tpu.env import observations as JO
from sigmarl_tpu.env.updates import update_geometry as jax_update_geometry
from sigmarl_tpu.safety import CBFConfig as JCBFConfig
from sigmarl_tpu.safety import CBFSafetyFilter as JCBFSafetyFilter
from sigmarl_tpu_torch.core import geometry as G
from sigmarl_tpu_torch.env import observations as O
from sigmarl_tpu_torch.env.structs import WorldState
from sigmarl_tpu_torch.env.updates import update_geometry
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter
from tests.torch_parity import (
    env_reset_draws, env_variant, envs, obs_noise_draws, params, step_reset_draws, to_numpy,
    to_torch_state,
)

torch.set_num_threads(1)
B, N = 4, 4
NOISE = dict(is_obs_noise=True, obs_noise_level=0.05)


def t(x):
    return torch.from_numpy(np.array(x))


def assert_state_close(ts: WorldState, js, atol=2e-5):
    for f in dataclasses.fields(WorldState):
        a, b = to_numpy(getattr(ts, f.name)), np.asarray(getattr(js, f.name))
        assert a.shape == b.shape, f.name
        if np.issubdtype(b.dtype, np.floating):
            tol = 1e-4 if f.name == "obs_history" else atol
            np.testing.assert_allclose(a, b, atol=tol, rtol=1e-5, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def live_state(jenv, n_steps=3, seed=7):
    """A JAX state after a reset and `n_steps` steps with random actions."""
    key = jax.random.PRNGKey(seed)
    state, _ = jax.jit(jenv.reset)(key)
    jstep = jax.jit(jenv.step)
    for s in range(n_steps):
        k_act, k_step = jax.random.split(jax.random.fold_in(key, s))
        state, *_ = jstep(state, actions(k_act), k_step)
    return state


def actions(key):
    return jax.random.uniform(key, (B, N, 2), minval=-0.2, maxval=0.8)


@pytest.fixture(scope="module")
def base():
    """Both envs on cpm_mixed (centre distances, no noise) and a live JAX
    state of theirs."""
    jenv, tenv = envs(**params("cpm_mixed", N, B))
    return jenv, tenv, live_state(jenv)


@pytest.mark.parametrize("layout", ["separated", "touching", "overlapping"])
def test_mtv_distances_match_jax(layout):
    """Rectangles far apart, sharing an edge or a corner, and overlapping
    (the penetration branch), from seeded poses."""
    rng = np.random.default_rng(0)
    L, W = 0.16, 0.08
    if layout == "separated":
        pos = rng.uniform(0, 4, size=(16, 6, 2))
        rot = rng.uniform(-np.pi, np.pi, size=(16, 6))
    elif layout == "touching":
        pos = np.array([[[0, 0], [L, 0], [0, W], [L, W], [-L, 0], [0, -W]]], float)
        rot = np.zeros((1, 6))
    else:
        pos = rng.uniform(0, 0.1, size=(16, 6, 2))
        rot = rng.uniform(-np.pi, np.pi, size=(16, 6))
    verts = np.asarray(jax.jit(lambda p, r: JG.rectangle_vertices(p, r, W, L, True))(
        pos.astype(np.float32), rot.astype(np.float32)))
    want = np.asarray(jax.jit(lambda v: JG.mtv_distances(v, set_diagonal_to=6.0))(verts))
    got = G.mtv_distances(t(verts), set_diagonal_to=6.0).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    off = ~np.eye(6, dtype=bool)
    if layout == "overlapping":
        assert (want[:, off] < 0).mean() > 0.5  # the penetration branch is exercised
    if layout == "touching":
        assert np.abs(want[0, 0, 1:4]).max() < 1e-6


def test_update_geometry_with_mtv_matches_jax(base):
    """Mutual distances and collisions from the MTV distance on a live
    state (one agent moved onto another, so that rectangles overlap)."""
    jenv, tenv = envs(**params("cpm_mixed", N, B, is_use_mtv_distance=True))
    pos = np.array(base[2].pos)
    pos[:, 1] = pos[:, 0] + np.float32(0.05)
    state = dataclasses.replace(base[2], pos=jax.numpy.asarray(pos))
    js = jax.jit(lambda s: jax_update_geometry(jenv.cfg, jenv.tables, s))(state)
    ts = update_geometry(tenv.cfg, tenv.tables, to_torch_state(state))
    assert np.asarray(js.coll_agents).any() and (np.asarray(js.d_agents) < 0).any()
    assert_state_close(ts, js)


@pytest.mark.parametrize(
    "flags",
    [{}, dict(**NOISE, n_observed_steps=2)],
    ids=["mtv", "mtv-noise-history2"],
)
def test_reset_and_step_match_jax(base, flags):
    """Reset, then one step from a live state, with the MTV distance (and
    observation noise with a history of 2), from JAX's draws. Two envs are
    set to end at this step, so their agents reset and their history slots
    are refilled."""
    kw = params("cpm_mixed", N, B, is_use_mtv_distance=True, max_steps=10, **flags)
    jenv, tenv = envs(**kw)
    key = jax.random.PRNGKey(3)
    js, jobs = jax.jit(jenv.reset)(key)
    ts, tobs = tenv.reset(draws=env_reset_draws(key, jenv.cfg),
                          obs_noise=obs_noise_draws(key, jenv.cfg))
    assert_state_close(ts, js)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)

    state = dataclasses.replace(base[2], step=jax.numpy.asarray([1, 8, 2, 8], np.int32))
    _, state = jax.jit(lambda s: JO.observe_with_history(
        jenv.cfg, jenv.tables, s, key, full_reset=True))(state)  # the history's shape
    k_step = jax.random.PRNGKey(12)
    act = actions(jax.random.PRNGKey(11))
    js, jobs, jrew, jdone, _ = jax.jit(jenv.step)(state, act, k_step)
    ts, tobs, trew, tdone, _ = tenv.step(
        to_torch_state(state), t(act), reset_draws=step_reset_draws(k_step, jenv.cfg),
        obs_noise=obs_noise_draws(k_step, jenv.cfg),
    )
    assert bool(np.asarray(jdone).any()) and not bool(np.asarray(jdone).all())
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    assert_state_close(ts, js)


def test_finalize_pads_then_adds_noise_like_jax(base):
    """The opponent-modeling pad gets noise too: its columns are the level
    times the uniforms."""
    jenv, tenv = env_variant(*base[:2], is_using_opponent_modeling=True, **NOISE)
    cfg = tenv.cfg
    core = np.random.default_rng(1).normal(size=(B, N, cfg.obs_core_dim)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.jit(lambda o: JO._finalize(jenv.cfg, o, key))(core))
    u = t(jax.random.uniform(key, (B, N, cfg.obs_dim)))
    got = O._finalize(cfg, t(core), noise=u)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    pad = cfg.n_nearing_agents_observed * 2
    np.testing.assert_allclose(got[..., -pad:].numpy(), (0.05 * u[..., -pad:]).numpy(), atol=1e-7)


@pytest.mark.parametrize("reset", ["partial", "full"])
@pytest.mark.parametrize("history", [2, 3])
def test_observe_with_history_matches_jax(base, history, reset):
    """A seeded history rolled by one step with a partial reset (the reset
    agents' slots refilled with the current features), or filled at a full
    reset, with the opponent-modeling pad and the noise from JAX's
    uniforms."""
    jenv, tenv = env_variant(*base[:2], n_stored_steps=history, n_observed_steps=history,
                             is_using_opponent_modeling=True, **NOISE)
    rng = np.random.default_rng(history)
    hist = rng.normal(size=(history, B, N, tenv.cfg.obs_core_dim)).astype(np.float32)
    state = dataclasses.replace(base[2], obs_history=jax.numpy.asarray(hist))
    key = jax.random.PRNGKey(9)
    mask = rng.random((B, N)) < 0.4
    kw = dict(full_reset=True) if reset == "full" else dict(reset_mask=mask)
    jobs, js = jax.jit(lambda s: JO.observe_with_history(jenv.cfg, jenv.tables, s, key, **kw))(
        state)
    if reset == "partial":
        kw["reset_mask"] = t(mask)
    tobs, ts = O.observe_with_history(
        tenv.cfg, tenv.tables, to_torch_state(state),
        noise=t(jax.random.uniform(key, (B, N, tenv.cfg.obs_dim))), **kw)
    assert tobs.shape == (B, N, tenv.cfg.obs_dim) and ts.obs_history.shape[0] == history
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4)
    np.testing.assert_allclose(ts.obs_history.numpy(), np.asarray(js.obs_history), atol=1e-4)
    with pytest.raises(ValueError):
        O.observe(tenv.cfg, tenv.tables, ts)


@pytest.mark.parametrize("mode", ["centralized", "margins"])
def test_noisy_assembly_matches_jax(base, mode):
    """The filter perturbs the RL actions by the level times uniforms
    before the nominal mapping, in the centralized and the margins-only
    mode; rows, the nominal input and the margin rewards from JAX's draw."""
    jenv, tenv, state = base
    kw = dict(n_agents=N, **NOISE, **({} if mode == "centralized" else dict(is_solve_qp=False)))
    jcbf = JCBFSafetyFilter(JCBFConfig(**kw), jenv.cfg, jenv.tables)
    tcbf = CBFSafetyFilter(CBFConfig(**kw), tenv.cfg, tenv.tables, device="cpu")
    act = jax.random.uniform(jax.random.PRNGKey(8), (B, N, 2), minval=-0.3, maxval=0.9)
    key = jax.random.PRNGKey(6)
    u = t(jax.random.uniform(key, (B, N, 2)))
    jcons, ju, jrl, _ = jax.jit(jcbf.assemble)(state, act, key)
    ts = to_torch_state(state)
    tcons, tu, trl, _ = tcbf.assemble(ts, t(act), noise=u)
    np.testing.assert_allclose(trl.numpy(), np.asarray(jrl), atol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-4, rtol=1e-5)
    _, quiet_u, _, _ = tcbf.assemble(ts, t(act), noise=torch.zeros_like(u))
    assert not torch.equal(quiet_u, tu)  # the noise moved the nominal input
    for f, atol, rtol in (
        ("A_s", 1e-3, 1e-3), ("b_s", 1e-3, 1e-3), ("h_s", 2e-5, 1e-5),
        ("A_pi", 1e-4, 1e-5), ("A_pj", 1e-4, 1e-5), ("b_p", 1e-4, 1e-5), ("h_p", 1e-4, 1e-5),
    ):
        np.testing.assert_allclose(getattr(tcons, f).numpy(), np.asarray(getattr(jcons, f)),
                                   atol=atol, rtol=rtol, err_msg=f)
    if mode == "margins":
        jm = jax.jit(jcbf.nominal_margin_rewards)(state, act, key)
        tm = tcbf.nominal_margin_rewards(ts, t(act), noise=u)
        for k in jm:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), atol=1e-4, err_msg=k)


def test_debug_numerics_guards_the_env_step():
    """With `debug_numerics` a NaN action makes the reward non-finite and
    `env.step` raises; a healthy step is silent. `make_env` turns on
    autograd's anomaly detection (turned off again here)."""
    from sigmarl_tpu_torch import make_env
    from sigmarl_tpu_torch.config import Parameters

    try:
        env = make_env(Parameters(**params("cpm_mixed", N, B, debug_numerics=True)),
                       device="cpu")
        assert torch.is_anomaly_enabled()
        g = torch.Generator().manual_seed(0)
        state, _ = env.reset(generator=g)
        state, obs, rew, _, _ = env.step(state, torch.zeros((B, N, 2)), generator=g)
        assert bool(torch.isfinite(rew).all())
        bad = torch.zeros((B, N, 2))
        bad[1, 2, 0] = float("nan")
        # The NaN speed target reaches the position, and so the reward, one
        # step later (Euler integration moves by the old speed).
        state, *_ = env.step(state, bad, generator=g)
        assert bool(torch.isnan(state.speed[1, 2]))
        with pytest.raises(FloatingPointError, match="reward"):
            env.step(state, torch.zeros((B, N, 2)), generator=g)
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_make_env_with_the_defaults_builds_and_steps():
    """`Parameters` defaults have the MTV distance and observation noise on;
    the port builds and steps with them."""
    from sigmarl_tpu_torch import make_env
    from sigmarl_tpu_torch.config import Parameters

    p = Parameters(scenario_type="cpm_mixed", n_agents=N, num_vmas_envs=B)
    assert p.is_use_mtv_distance and p.is_obs_noise
    env = make_env(p, device="cpu")
    assert env.cfg.distance_type == "mtv"
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(generator=g)
    state, obs, rew, _, _ = env.step(state, torch.zeros((B, N, 2)), generator=g)
    assert obs.shape == (B, N, env.obs_dim)
    assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(rew).all())
