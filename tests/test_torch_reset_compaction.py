"""The reset's compacted spawn in the port against the JAX package.

From 1024 envs up, with the challenge buffer off, the JAX package's step
spawns only the envs with a reset when they number at most 3B/8 (384 at
B=1024), drawing their candidates at the compacted [3B/8, N, T] shape;
with more, with the buffer on, or below 1024 envs it spawns at full
width. Given JAX's draws the port takes the same branch and spawns alike:

- `apply_reset` with the compacted spawn on a mask of about 23 % of the
  envs (a third of them partial): ids, scenario and step counter equal,
  poses within 1e-6;
- one step where JAX compacts, one with more than 384 resetting envs,
  one at B=512 and one with the challenge buffer on: done flags equal,
  states within 2e-5 (boundary indices up to a float32 tie), rewards
  within 2e-5, observations within 1e-4, and the port's counters name
  the branch;
- two gloo ranks over B=1024 equal one process given the same global
  draws, across compacted steps (one where only rank 1 resets) and a
  full-width one: integer fields and flags exactly, float fields within
  1e-6, with one collective per step;
- draws without the branch's uniforms raise.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigmarl_tpu.env.reset import apply_reset as jax_apply_reset
from sigmarl_tpu.env.structs import replace_state as jreplace
from sigmarl_tpu_torch.env.reset import ResetDraws, apply_reset, compact_slots
from sigmarl_tpu_torch.env.structs import WorldState, replace_state
from sigmarl_tpu_torch.parallel.dryrun import spawn_ranks
from tests.test_torch_env import assert_state_close
from tests.torch_parallel_worker import collide, env_steps_rank
from tests.torch_parity import (
    IDX, assert_idx_close, env_variant, envs, params, reset_draws, step_reset_draws, to_numpy,
    to_torch_state,
)

torch.set_num_threads(1)
B, N, BUDGET = 1024, 4, 384
SHARDED = params("cpm_entire", 2, B)


def _colliding_envs(rng, B_, share):
    """A share of the envs, in env order."""
    return np.flatnonzero(rng.random(B_) < share)


def _jax_collide(state, envs_):
    """`collide` on a JAX state."""
    pos = np.array(state.pos)
    pos[envs_, 1] = pos[envs_, 0] + np.array([0.02, 0.0], np.float32)
    return jreplace(state, pos=jnp.asarray(pos))


@pytest.fixture(scope="module")
def setup():
    """JAX's and the port's cpm_entire envs at B=1024, N=4, a JAX state
    after the reset, and the two-rank run of the sharded test (its
    processes overlap the JAX work of the other tests)."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    sharded = pool.submit(_sharded_runs)
    pool.shutdown(wait=False)
    jenv, tenv = envs(**params("cpm_entire", N, B))
    state, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    return dict(jenv=jenv, tenv=tenv, state=state, sharded=sharded)


def test_compact_slots_follow_the_jax_rule():
    assert compact_slots(1024, False) == 384
    assert compact_slots(2048, False) == 768
    assert compact_slots(512, False) == 0
    assert compact_slots(1024, True) == 0


def test_compacted_apply_reset_matches_jax(setup):
    """JAX's `apply_reset(..., compact_budget=384)` and the port's
    compacted spawn on the same mask and JAX's draws."""
    jenv, tenv, state = setup["jenv"], setup["tenv"], setup["state"]
    rng = np.random.default_rng(1)
    env_any = rng.random(B) < 0.23
    mask = np.repeat(env_any[:, None], N, 1)
    partial = env_any & (rng.random(B) < 1 / 3)
    agents = rng.random((B, N)) < 0.5
    agents[np.arange(B), rng.integers(0, N, B)] = True  # at least one agent
    mask[partial] = agents[partial]
    k = int(env_any.sum())
    assert 0 < k <= BUDGET and 0 < int(partial.sum()) < k
    key = jax.random.PRNGKey(7)
    js = jax.jit(lambda s, m, kk: jax_apply_reset(jenv.cfg, jenv.tables, s, m, kk,
                                                  compact_budget=BUDGET))(
        state, jnp.asarray(mask), key)
    ts = apply_reset(tenv.cfg, tenv.tables, to_torch_state(state), torch.from_numpy(mask),
                     reset_draws(key, jenv.cfg, BUDGET), compact=(0, k))
    for f in ("path_id", "point_id", "scenario_id", "step"):
        np.testing.assert_array_equal(to_numpy(getattr(ts, f)), np.asarray(getattr(js, f)),
                                      err_msg=f)
    for f in ("pos", "rot", "vel", "speed"):
        np.testing.assert_allclose(to_numpy(getattr(ts, f)), np.asarray(getattr(js, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    assert_state_close(ts, js, skip=IDX)
    assert_idx_close(ts, js, tenv.tables)
    # The compacted layout is not the full-width one: the same key spawns
    # elsewhere at full width.
    full = apply_reset(tenv.cfg, tenv.tables, to_torch_state(state), torch.from_numpy(mask),
                       reset_draws(key, jenv.cfg))
    assert not torch.equal(full.pos, ts.pos)


def test_compacted_spawn_is_the_full_width_spawn_on_the_same_rows(setup):
    """The compacted spawn is a gather and a scatter around the per-env
    spawn: full-width draws that carry the compacted rows in the
    resetting envs' rows give the same state, bit for bit (on the card:
    `test_torch_gpu.py::test_compacted_reset_is_the_full_width_reset_on_the_card`)."""
    tenv = setup["tenv"]
    state = to_torch_state(setup["state"])
    g = torch.Generator().manual_seed(10)
    env_any = torch.rand((B,), generator=g) < 0.23
    mask = env_any[:, None].expand(B, N).contiguous()
    k = int(env_any.sum())
    draws = ResetDraws.sample(tenv.cfg, g, "cpu", compact_slots=BUDGET)
    draws.path_u[env_any] = draws.path_u_c[:k]
    draws.point_u[env_any] = draws.point_u_c[:k]
    a = apply_reset(tenv.cfg, tenv.tables, state, mask, draws, compact=(0, k))
    b = apply_reset(tenv.cfg, tenv.tables, state, mask, draws)
    for f in dataclasses.fields(WorldState):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def _step_both(jenv, tenv, state, act, key, budget):
    """One step of each package from the same state and key; the port's
    counters before and after."""
    before = (tenv.compact_reset_steps, tenv.full_reset_steps)
    js, jobs, jrew, jdone, _ = jax.jit(jenv.step)(state, act, key)
    ts, tobs, trew, tdone, _ = tenv.step(to_torch_state(state), torch.from_numpy(np.array(act)),
                                         reset_draws=step_reset_draws(key, jenv.cfg, budget))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    assert_state_close(ts, js, skip=IDX)
    assert_idx_close(ts, js, tenv.tables)
    after = (tenv.compact_reset_steps, tenv.full_reset_steps)
    return int(np.asarray(jdone).sum()), (after[0] - before[0], after[1] - before[1])


@pytest.mark.parametrize("share, branch", [(0.23, "compact"), (0.5, "full")])
def test_step_takes_the_jax_branch(setup, share, branch):
    """A step at B=1024 whose resetting envs (the colliding ones: in
    training on cpm_entire a collision resets the whole env) fit the 384
    slots spawns compacted, and one with more spawns at full width, as in
    JAX."""
    jenv, tenv = setup["jenv"], setup["tenv"]
    state = _jax_collide(setup["state"], _colliding_envs(np.random.default_rng(2), B, share))
    act = jnp.full((B, N, 2), 0.3)
    n, (compacted, full) = _step_both(jenv, tenv, state, act, jax.random.PRNGKey(3), BUDGET)
    if branch == "compact":
        assert 0 < n <= BUDGET and (compacted, full) == (1, 0)
    else:
        assert n > BUDGET and (compacted, full) == (0, 1)


@pytest.mark.parametrize("variant", ["B=512", "challenge buffer"])
def test_full_width_where_jax_does_not_compact(setup, variant):
    """At B=512, and at B=1024 with the challenge buffer on, JAX spawns at
    full width whatever the count; so does the port (given draws that
    carry both branches' uniforms, it still takes the full-width ones)."""
    jenv, tenv, state = setup["jenv"], setup["tenv"], setup["state"]
    if variant == "B=512":
        jenv, tenv = env_variant(jenv, tenv, batch_dim=512)
        state = jax.tree_util.tree_map(
            lambda x: x[:, :512] if x.ndim > 1 and x.shape[1] == B and x.shape[0] != B
            else (x[:512] if x.ndim and x.shape[0] == B else x), state)
    else:
        jenv, tenv = env_variant(jenv, tenv, is_challenging_initial_state_buffer=True)
    B_ = jenv.cfg.batch_dim
    state = _jax_collide(state, _colliding_envs(np.random.default_rng(4), B_, 0.2))
    act = jnp.full((B_, N, 2), 0.3)
    n, counts = _step_both(jenv, tenv, state, act, jax.random.PRNGKey(5), BUDGET)
    assert 0 < n <= 3 * B_ // 8 and counts == (0, 1)


def _sharded_runs():
    """Three steps of two gloo ranks and of one process over B=1024, N=2,
    from one state and the same global draws: before step 1 about 23 %
    of the envs collide on both ranks (compacted), before step 2 half of
    them (full width), before step 3 a fifth of rank 1's envs only
    (compacted, rank 0 without a resetting env)."""
    from sigmarl_tpu_torch.config import Parameters
    from sigmarl_tpu_torch.env.env import make_env

    env = make_env(Parameters(**SHARDED), device="cpu")
    g = torch.Generator().manual_seed(6)
    state, _ = env.reset(generator=g)
    rng = np.random.default_rng(7)
    colliding = [_colliding_envs(rng, B, 0.23).tolist(), _colliding_envs(rng, B, 0.5).tolist(),
                 (B // 2 + _colliding_envs(rng, B // 2, 0.2)).tolist()]
    draws = [ResetDraws.sample(env.cfg, g, "cpu", compact_slots=BUDGET) for _ in colliding]
    # Every agent stands (spawned at speed 0, speed target 0), so that no
    # env collides on its own: only the envs put in collision reset.
    state = replace_state(state, speed=torch.zeros_like(state.speed),
                          vel=torch.zeros_like(state.vel))
    for d in draws:
        d.speed_u.zero_()
    actions = [torch.zeros((B, 2, 2)) for _ in colliding]
    ranks = spawn_ranks(env_steps_rank, 2, SHARDED, state, actions, draws, colliding,
                        device="cpu", timeout=300)
    one, s = [], state
    for act, rd, envs_ in zip(actions, draws, colliding):
        s, obs, rew, done, _ = env.step(collide(s, envs_), act, reset_draws=rd)
        one.append(dict(state=s, obs=obs, reward=rew, done=done))
    counts = (env.reset_steps, env.compact_reset_steps, env.full_reset_steps)
    return ranks, one, counts


def test_two_ranks_equal_one_process_across_compacted_resets(setup):
    ranks, one, counts = setup["sharded"].result()
    assert counts == (3, 2, 1)
    for r in ranks:
        assert r["counts"] == counts
        # The reset decision is one all-gather of the ranks' counts per
        # step, as the all-reduce before it was.
        assert r["collectives"] == [["all_gather"]] * 3
    for t, (got, want) in enumerate(zip(ranks[0]["steps"], one)):
        for f in dataclasses.fields(WorldState):
            a, b = getattr(got["state"], f.name), getattr(want["state"], f.name)
            if b.is_floating_point():
                torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=f"step {t}: {f.name}")
            else:
                assert torch.equal(a, b), f"step {t}: {f.name}"
        torch.testing.assert_close(got["obs"], want["obs"], rtol=0, atol=1e-6)
        torch.testing.assert_close(got["reward"], want["reward"], rtol=0, atol=1e-6)
        assert torch.equal(got["done"], want["done"])
    assert int(one[2]["done"][: B // 2].sum()) == 0 < int(one[2]["done"].sum())


@pytest.mark.parametrize("missing", ["compact", "full"])
def test_draws_without_the_branch_uniforms_raise(setup, missing):
    """A compacted step given only full-width draws raises, and a
    full-width step given only compacted ones: neither takes the other
    shape."""
    tenv = setup["tenv"]
    g = torch.Generator().manual_seed(8)
    share = 0.23 if missing == "compact" else 0.5
    envs_ = _colliding_envs(np.random.default_rng(9), B, share).tolist()
    state = collide(to_torch_state(setup["state"]), envs_)
    if missing == "compact":
        draws = ResetDraws.sample(tenv.cfg, g, "cpu")
    else:
        draws = ResetDraws.sample(tenv.cfg, g, "cpu", compact_slots=BUDGET, full=False)
    with pytest.raises(ValueError, match="path_u"):
        tenv.step(state, torch.full((B, N, 2), 0.3), reset_draws=draws)
