"""Testing mode in the port against the JAX package: the step with its
single-agent resets and goal reward, the growing spawn window, the
predefined and measured-pose resets, and `make_env` on every registered
scenario.

Tolerances as in `test_torch_env.py`: float32 state fields to atol 2e-5,
rewards to 2e-5, observations to 1e-4; integer fields, flags, done and
path ids exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigmarl_tpu_torch.config as tcfg
from sigmarl_tpu.env.reset import _candidate_point_ids as jax_point_ids
from sigmarl_tpu_torch.constants import SCENARIOS
from sigmarl_tpu_torch.env.env import make_env
from sigmarl_tpu_torch.env.reset import _candidate_point_ids
from tests.test_torch_env import assert_state_close
from tests.torch_parity import envs, params, step_reset_draws, to_torch_state

torch.set_num_threads(1)
TESTING = dict(is_testing_mode=True)


@pytest.mark.parametrize("scenario, N, B, steps", [("cpm_mixed", 4, 8, 12), ("cpm_entire", 15, 4, 8)])
def test_testing_mode_steps_match_jax(scenario, N, B, steps):
    """Several testing-mode steps with fast random actions, so that agents
    leave their lanes and collide: the port resets them alone (20 spawn
    candidates in a growing window) as the JAX package does, and done stays
    false until max_steps. Every step is compared from the same state."""
    jenv, tenv = envs(**params(scenario, N, B, is_using_cbf_testing=False, **TESTING))
    assert tenv.cfg.max_spawn_tries == jenv.cfg.max_spawn_tries == 20
    B_, N_ = jenv.cfg.batch_dim, jenv.cfg.n_agents
    key = jax.random.PRNGKey(21)
    state, _ = jax.jit(jenv.reset)(key)
    jstep = jax.jit(jenv.step)
    jmask = jax.jit(lambda s, a: jenv._done_and_reset_mask(_pre_reset(jenv, s, a))[1])
    partial_resets = 0
    for t in range(steps):
        k_act, k_step = jax.random.split(jax.random.fold_in(key, t))
        act = jax.random.uniform(k_act, (B_, N_, 2), minval=-0.4, maxval=1.0)
        js, jobs, jrew, jdone, _ = jstep(state, act, k_step)
        ts, tobs, trew, tdone, _ = tenv.step(
            to_torch_state(state), torch.from_numpy(np.asarray(act)),
            reset_draws=step_reset_draws(k_step, jenv.cfg),
        )
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), err_msg=f"step {t}")
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=2e-5, rtol=1e-5,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5,
                                   err_msg=f"step {t}")
        assert_state_close(ts, js)
        # The agents the step reset alone: flagged before the reset, in envs
        # that did not end.
        single = np.asarray(jmask(state, act))
        partial_resets += int((single.any(-1) & ~single.all(-1)).sum())
        state = js
    assert not bool(np.asarray(jdone).any())
    assert partial_resets > 0


def _pre_reset(jenv, state, act):
    """The JAX state of a step just before its reset (dynamics, geometry,
    buffers and short-term paths), for its reset mask."""
    from sigmarl_tpu.core.dynamics import command_step
    from sigmarl_tpu.env.structs import replace_state
    from sigmarl_tpu.env.updates import push_state_buffer, update_geometry, update_short_term_paths

    cfg, tables = jenv.cfg, jenv.tables
    pos, rot, speed, steering, sideslip, vel = command_step(
        jenv.bicycle, state.pos, state.rot, state.speed, state.steering, act, cfg.dt)
    s = replace_state(state, pos=pos, rot=rot, speed=speed, steering=steering,
                      sideslip=sideslip, vel=vel, step=state.step + 1)
    s = update_geometry(cfg, tables, s)
    return update_short_term_paths(cfg, tables, push_state_buffer(s))


def test_testing_mode_ends_episodes_at_max_steps():
    """With max_steps reached every agent of every env resets and done is
    true; the step counter starts again."""
    jenv, tenv = envs(**params("cpm_mixed", 4, 4, max_steps=3, **TESTING))
    key = jax.random.PRNGKey(4)
    state, _ = jax.jit(jenv.reset)(key)
    act = jnp.full((4, 4, 2), 0.2)
    jstep = jax.jit(jenv.step)
    for t in range(2):
        k = jax.random.fold_in(key, t)
        js, _, jrew, jdone, _ = jstep(state, act, k)
        ts, _, trew, tdone, _ = tenv.step(to_torch_state(state), torch.from_numpy(np.asarray(act)),
                                          reset_draws=step_reset_draws(k, jenv.cfg))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=2e-5, rtol=1e-5)
        assert_state_close(ts, js)
        state = js
    assert bool(tdone.all()) and int(ts.step.max()) == 0


def test_testing_mode_goal_reward_matches_jax():
    """The testing-mode reward (progress, the goal reward, the collision
    penalties) from a state with exits reached and collisions set on
    purpose, and the training reward of the same state without the goal
    reward."""
    from sigmarl_tpu.env.rewards import compute_rewards as jax_rewards
    from sigmarl_tpu.env.structs import replace_state as jax_replace
    from sigmarl_tpu_torch.env.rewards import compute_rewards

    rng = np.random.default_rng(3)
    for testing in (True, False):
        jenv, tenv = envs(**params("cpm_mixed", 4, 4, is_testing_mode=testing))
        state, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(2))
        state = jax_replace(
            state, pos=state.pos + 0.01,
            coll_exit=jnp.asarray(rng.random((4, 4)) < 0.5),
            coll_lanelets=jnp.asarray(rng.random((4, 4)) < 0.3),
            coll_agents=jnp.asarray(rng.random((4, 4, 4)) < 0.2),
        )
        prev_pos = state.pos - 0.01
        jrew, jinfo = jax_rewards(jenv.cfg, state, prev_pos, state.short_term, jenv.weighting_ref)
        trew, tinfo = compute_rewards(tenv.cfg, to_torch_state(state), torch.from_numpy(
            np.asarray(prev_pos)), to_torch_state(state).short_term, tenv.weighting_ref)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=2e-5, rtol=1e-5)
        for k in jinfo:
            np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]), atol=2e-5, err_msg=k)
        assert bool((tinfo["rew_reach_goal"] > 0).any())


def test_testing_spawn_window_matches_jax():
    """The candidate spawn points of testing mode: window 3 + (k+1)(k+2)/2
    for retry k, capped at half the path, from the same uniforms."""
    cfg = envs(**params("cpm_mixed", 4, 2, **TESTING))[0].cfg
    n_points = np.random.default_rng(0).integers(5, 400, size=(2, 4, 20)).astype(np.int32)
    # The JAX function draws its own uniforms from the key: rebuild them.
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax_point_ids(cfg, key, jnp.asarray(n_points), 20))
    u = np.asarray(jax.random.uniform(key, n_points.shape))
    got = _candidate_point_ids(cfg, torch.from_numpy(u), torch.from_numpy(n_points))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() < np.maximum(n_points // 2, 4)).all()


def test_reset_predefined_matches_jax():
    jenv, tenv = envs(**params("cpm_entire", 6, 3, **TESTING))
    from sigmarl_tpu_torch.eval.at25 import default_poses

    poses, paths = default_poses(6)
    js, jobs = jax.jit(jenv.reset_predefined)(jax.random.PRNGKey(0), jnp.asarray(poses),
                                              jnp.asarray(paths))
    ts, tobs = tenv.reset_predefined(torch.from_numpy(poses), torch.from_numpy(paths))
    np.testing.assert_array_equal(ts.path_id.numpy(), np.asarray(js.path_id))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    assert_state_close(ts, js)


@pytest.mark.parametrize("scenario", ["cpm_entire", "cpm_mixed"])
def test_reset_from_poses_matches_jax(scenario):
    """Measured poses near reference paths (center-line points moved by up
    to 3 cm and turned by up to 0.3 rad): each agent's path and the whole
    state as the JAX package picks them."""
    jenv, tenv = envs(**params(scenario, 5, 4, experiment_type="lab", **TESTING))
    rng = np.random.default_rng(1)
    lt = np.asarray(jenv.tables.long_term)
    yaw = np.asarray(jenv.tables.center_line_yaw)
    k = rng.integers(0, lt.shape[0], size=(4, 5))
    p = rng.integers(5, 30, size=(4, 5))
    pos = (lt[k, p] + rng.uniform(-0.03, 0.03, size=(4, 5, 2))).astype(np.float32)
    rot = (yaw[k, p] + rng.uniform(-0.3, 0.3, size=(4, 5))).astype(np.float32)
    js, jobs = jax.jit(jenv.reset_from_poses)(jax.random.PRNGKey(0), pos, rot)
    ts, tobs = tenv.reset_from_poses(torch.from_numpy(pos), torch.from_numpy(rot))
    np.testing.assert_array_equal(ts.path_id.numpy(), np.asarray(js.path_id))
    np.testing.assert_array_equal(ts.point_id.numpy(), np.asarray(js.point_id))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    assert_state_close(ts, js)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_every_scenario_builds_and_steps(scenario):
    """`make_env` on every scenario of the registry, in testing mode with
    the lab and predefined-path options set (accepted and not acted on, as
    in the JAX package): a reset and two steps give finite values."""
    n = min(4, SCENARIOS[scenario].get("n_agents", 4))
    p = tcfg.Parameters(**params(scenario, n, 2, predefined_ref_path_idx=[0] * n,
                                 init_state=[0.0, 0.0, 0.0], experiment_type="lab", **TESTING))
    env = make_env(p, device="cpu")
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(generator=g)
    for _ in range(2):
        state, obs, rew, done, _ = env.step(state, torch.full((2, n, 2), 0.3), generator=g)
    assert obs.shape == (2, n, env.obs_dim)
    assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(rew).all())
