"""Data parallelism over ranks (`sigmarl_tpu_torch/parallel/`) on the CPU:
ranks spawned as processes in one gloo group, the kernels' plain versions.

- Four ranks, B=8 (2 envs each), N=4, cpm_entire, the CBF-filtered
  iteration (centralized filter) with the challenging initial-state
  buffer on, from a state where agents of envs on every rank collide
  (more recording envs than the ring's 3 slots, so the later env must win
  across ranks) and every full-env reset may replay: first one sharded
  `cbf_filtered_step`, which equals the unsharded step; then the
  iteration, which equals the port's one-process iteration on the same
  draws (the rollout exactly; the parameters at least 99 % within 1e-6
  and all within 2 lr per update, as `test_torch_training.py` holds them
  against JAX) and JAX's unsharded iteration on JAX's draws (at the
  tolerances of `test_torch_filtered_training.py`, which hold a filtered
  rollout against JAX: float32 Newton solves part in flat directions).
- Two ranks, XP-MARL with learned priority and the prioritized replay
  buffer: equals one process, as above.
- `shard_world_state` / `gather_world_state` round trip; `env_shard`
  refuses a batch that does not divide.
- `dryrun_multichip(2, device="cpu")`.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigmarl_tpu.config as jcfg
from sigmarl_tpu.env import make_env as jax_make_env
from sigmarl_tpu.env.env import RoadTrafficEnv as JEnv
from sigmarl_tpu.env.structs import replace_state as jreplace
from sigmarl_tpu.rl import MAPPOCAVs as JMAPPOCAVs
from sigmarl_tpu.rl.mappo_cavs import TrainState as JTrainState
from sigmarl_tpu_torch.env.reset import ResetDraws
from sigmarl_tpu_torch.env.structs import WorldState
from sigmarl_tpu_torch.parallel import mesh
from sigmarl_tpu_torch.parallel.dryrun import dryrun_multichip, spawn_ranks
from sigmarl_tpu_torch.rl.mappo_cavs import IterationDraws
from tests.test_torch_training import iteration_draws
from tests.torch_parallel_worker import flat_parameters, iteration_rank, make_trainer, start_state
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step
from tests.torch_parity import IDX, assert_idx_close, step_reset_draws, to_numpy, to_torch_state

torch.set_num_threads(1)
B, N, T, C = 8, 4, 8, 3
FILTERED = dict(
    scenario_type="cpm_entire", n_agents=N, num_vmas_envs=B, dt=0.1, max_steps=T, n_iters=3,
    num_epochs=1, minibatch_size=B * T // 2, is_use_mtv_distance=False, is_obs_noise=False,
    random_seed=0, rew_method="cbf", is_using_cbf_training=True, is_solve_qp=True,
    is_apply_cbf_action=True, is_using_centralized_cbf=True,
    is_challenging_initial_state_buffer=True, is_save_intermediate_model=False,
    where_to_save="unused/",
)
BUFFER = dict(challenge_buffer_size=C, probability_use_recording=0.5)
COLLIDING_ENVS = [1, 3, 4, 6]  # on ranks 0, 1, 2, 3


def _collide(state):
    """Agent 1 put on agent 0 in `COLLIDING_ENVS` (a JAX state)."""
    pos = np.array(state.pos)
    pos[COLLIDING_ENVS, 1] = pos[COLLIDING_ENVS, 0] + np.array([0.02, 0.0], np.float32)
    return jreplace(state, pos=jnp.asarray(pos))


def _assert_states_close(a: WorldState, b: WorldState, atol: float):
    """Flags and integer fields equal; float fields within `atol`, u* (the
    QP solution, `cbf_u_prev`) within 10 atol."""
    for f in dataclasses.fields(WorldState):
        x, y = to_numpy(getattr(a, f.name)), to_numpy(getattr(b, f.name))
        if np.issubdtype(y.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=0, atol=atol * (10 if f.name == "cbf_u_prev"
                                                                  else 1), err_msg=f.name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f.name)


def _assert_parameters_close(a, b, lr, n_updates):
    diffs = (a - b).abs().numpy()
    assert (diffs <= 1e-6).mean() >= 0.99, (diffs <= 1e-6).mean()
    assert diffs.max() <= 2 * lr * n_updates


XPMARL_PRB = dict(
    scenario_type="cpm_mixed", n_agents=N, num_vmas_envs=4, dt=0.1, max_steps=T, n_iters=3,
    num_epochs=2, minibatch_size=16, is_use_mtv_distance=False, is_obs_noise=False,
    random_seed=0, is_using_prioritized_marl=True, prioritization_method="marl", is_prb=True,
    where_to_save="unused/",
)


@pytest.fixture(scope="module")
def runs():
    """Every run of the file: the two-rank XP-MARL + PRB run and its
    one-process counterpart; the dry run; JAX's unsharded filtered
    iteration, the port's one-process one and the four-rank run (step,
    then iteration) from one start and the same draws."""
    tr_x = make_trainer(XPMARL_PRB, {})
    cfg, Bx, k = tr_x.env.cfg, XPMARL_PRB["num_vmas_envs"], tr_x.k_nearing
    g = torch.Generator().manual_seed(1)
    draws_x = IterationDraws(
        action_noise=torch.randn((T, N, Bx, 2), generator=g),
        reset_draws=[ResetDraws.sample(cfg, g, "cpu") for _ in range(T)],
        permutations=None,
        entropy_noise=torch.randn((2, 2, 16, N, 2), generator=g),
        priority_noise=torch.randn((T, Bx, N, 1), generator=g),
        communication_noise=torch.randn((T, N, Bx, 2 * k), generator=g),
        priority_entropy_noise=torch.randn((2, 2, 16, N, 1), generator=g),
    )
    start_x = ("reset", ResetDraws.sample(cfg, g, "cpu"))
    # The ranks' processes overlap the JAX work below (each spawn waits in
    # a thread of its own).
    pool = concurrent.futures.ThreadPoolExecutor(2)
    dryrun = pool.submit(dryrun_multichip, 2, device="cpu")
    one_x, m1_x = tr_x.train_iteration(start_state(tr_x, start_x), draws_x)

    jp = jcfg.Parameters(**FILTERED)
    jenv = jax_make_env(jp)
    jenv = JEnv(dataclasses.replace(jenv.cfg, **BUFFER), jenv.tables)
    env_state, obs = jax.jit(jenv.reset)(jax.random.PRNGKey(3))
    # The reset's poses fill the state buffer, so the records are poses.
    latest = env_state.state_buffer[(int(env_state.sb_pointer) - 1) % jenv.cfg.n_steps_stored]
    env_state = _collide(jreplace(
        env_state, state_buffer=jnp.broadcast_to(latest, env_state.state_buffer.shape)))
    jtr = JMAPPOCAVs(jp, env=jenv)
    key = jax.random.PRNGKey(11)
    tr = make_trainer(FILTERED, BUFFER)
    np_tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    start = ("state", to_torch_state(env_state), torch.from_numpy(np.array(obs)),
             np_tree(jtr.policy_params), np_tree(jtr.critic_params))
    draws = iteration_draws(key, tr, jenv.cfg, True)
    act = torch.full((B, N, 2), 0.4)
    step_draws = step_reset_draws(jax.random.PRNGKey(5), jenv.cfg)
    # Four ranks: the step and the filtered iteration, then ranks 0 and 1
    # the XP-MARL one in a group of their own.
    ranks = pool.submit(spawn_ranks, iteration_rank, 4, FILTERED, BUFFER, start, draws,
                        (start[1], act, step_draws), (XPMARL_PRB, start_x, draws_x),
                        device="cpu", timeout=300)
    pool.shutdown(wait=False)

    jnew, jm = jtr._train_iteration(JTrainState(
        policy_params=jtr.policy_params, critic_params=jtr.critic_params,
        opt_state=jtr.opt_state, env_state=env_state, obs=obs,
        ep_reward_accum=jnp.zeros((B, N)), key=key, iteration=jnp.zeros((), jnp.int32)))
    s1, o1, r1, d1, info = cbf_filtered_step(tr.env, tr.cbf_filter, start[1], act,
                                             reset_draws=step_draws)
    one_step = dict(state=s1, obs=o1, reward=r1, done=d1, solved=info["cbf_solved"])
    one, m1 = tr.train_iteration(start_state(tr, start), draws)
    ranks = ranks.result()
    return dict(jax=(jnew, jm), one=(one, m1, tr), ranks=ranks, one_step=one_step,
                xpmarl=(one_x, m1_x, tr_x, [r["xpmarl"] for r in ranks[:2]]),
                dryrun=dryrun.result())


def test_sharded_filtered_step_equals_the_unsharded_one(runs):
    """`cbf_filtered_step` on four ranks' shards, gathered, equals the
    step over all eight envs (the JAX package's
    `test_parallel.py::test_sharded_cbf_filtered_step_matches_unsharded`),
    bit for bit: every computation of the step is per env."""
    one, sharded = runs["one_step"], runs["ranks"][0]["step"]
    _assert_states_close(sharded["state"], one["state"], 0.0)
    for k in ("obs", "reward", "done", "solved"):
        torch.testing.assert_close(sharded[k], one[k], rtol=0, atol=0, msg=k)
    assert bool(one["done"][COLLIDING_ENVS].all())


def test_four_ranks_equal_one_process(runs):
    """The gathered rollout against the one-process rollout: flags,
    integer fields, the ring's pointers and its records exactly (the
    records of every rank's colliding envs went to the ring in global env
    order, the later env winning), float fields within 1e-3 (u* 1e-2:
    the policy's layers round differently at 8 rows per rank than at 32,
    by up to 6e-7, and the QP carries that to 1e-3 in u*), obs within
    1e-3; the metrics equal (the losses to a relative 1e-5); every rank
    holds the same parameters, within the parameter rule of the
    one-process ones."""
    one, m1, tr = runs["one"]
    ranks = runs["ranks"]
    r0 = ranks[0]
    _assert_states_close(r0["env_state"], one.env_state, 1e-3)
    torch.testing.assert_close(r0["env_state"].challenge_buffer, one.env_state.challenge_buffer,
                               rtol=0, atol=0)
    torch.testing.assert_close(r0["obs"], one.obs, rtol=0, atol=1e-3)
    counts = r0["challenge_counts"].tolist()
    assert counts == tr.challenge_counts().tolist() and counts[0] >= len(COLLIDING_ENVS) > C
    assert int(r0["env_state"].cb_valid) == C
    assert r0["metrics"]["n_done"] == float(m1["n_done"])
    for k in ("episode_reward_mean", "reward_mean", "cbf_solved_share", "loss_objective",
              "loss_critic", "loss_entropy", "entropy", "ratio_mean"):
        np.testing.assert_allclose(r0["metrics"][k], float(m1[k]), rtol=1e-5, err_msg=k)
    for r in ranks[1:]:
        torch.testing.assert_close(r["params"], r0["params"], rtol=0, atol=0)
        assert r["metrics"] == r0["metrics"]
    _assert_parameters_close(r0["params"], flat_parameters(one), tr.parameters.lr,
                             tr.updates_per_iter)


def test_four_ranks_equal_jax_unsharded(runs):
    """The four-rank iteration against JAX's unsharded one on JAX's draws:
    flags, integer fields and the ring's pointers exactly (boundary
    indices as `assert_idx_close` allows at float32 ties), float state
    fields within 1e-2 and u* within 1e-1, obs within 2e-2, the episode
    reward to 2e-3, the losses to a relative 1e-3, `n_done` exactly.
    `test_torch_filtered_training.py` holds a filtered rollout at 2e-3;
    here the envs that start with one agent on another solve QPs whose
    float32 Newton iterates part in flat directions (applied actions
    4.2e-3 and recorded velocities 4.9e-3 apart, measured)."""
    jnew, jm = runs["jax"]
    r0 = runs["ranks"][0]
    ts = r0["env_state"]
    assert_idx_close(ts, jnew.env_state, runs["one"][2].env.tables)
    for f in dataclasses.fields(WorldState):
        if f.name in IDX:
            continue
        a, b = to_numpy(getattr(ts, f.name)), np.asarray(getattr(jnew.env_state, f.name))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-2 if f.name != "cbf_u_prev" else 1e-1,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_allclose(r0["obs"].numpy(), np.asarray(jnew.obs), atol=2e-2)
    assert r0["metrics"]["n_done"] == float(jm["n_done"])
    np.testing.assert_allclose(r0["metrics"]["episode_reward_mean"],
                               float(jm["episode_reward_mean"]), atol=2e-3)
    for k in ("loss_objective", "loss_critic", "loss_entropy"):
        np.testing.assert_allclose(r0["metrics"][k], float(jm[k]), rtol=1e-3, err_msg=k)


def test_two_ranks_xpmarl_prb_equal_one_process(runs):
    """XP-MARL with learned priority and the prioritized replay buffer on
    two ranks, from the same reset and rollout draws as one process: the
    rollout and the parameters (all four networks) as in the four-rank
    test; the PRB samples come from the generator both ranks share (no
    `prb_indices` given), over the priorities gathered from both ranks."""
    one, m1, tr, (r0, r1) = runs["xpmarl"]
    _assert_states_close(r0["env_state"], one.env_state, 1e-3)
    torch.testing.assert_close(r0["obs"], one.obs, rtol=0, atol=1e-3)
    torch.testing.assert_close(r1["params"], r0["params"], rtol=0, atol=0)
    for k in ("loss_objective", "loss_critic", "loss_priority"):
        np.testing.assert_allclose(r0["metrics"][k], float(m1[k]), rtol=1e-5, err_msg=k)
    _assert_parameters_close(r0["params"], flat_parameters(one), tr.parameters.lr,
                             tr.updates_per_iter)


def test_shard_and_gather_round_trip():
    """`shard_world_state` cuts every per-env field (the state buffer and
    the observation history on axis 1) and keeps the replicated ones
    whole, the global challenge buffer included even where its slot count
    equals B; concatenating the shards rebuilds the state, as
    `gather_world_state` does over ranks."""
    tr = make_trainer({**FILTERED, "num_vmas_envs": C}, BUFFER)
    state, _ = tr.env.reset(generator=torch.Generator().manual_seed(0))
    shards = [mesh.shard_world_state(state, r, 3) for r in range(3)]
    assert shards[1].pos.shape[0] == 1 and shards[1].state_buffer.shape[1] == 1
    assert shards[1].challenge_buffer.shape[0] == C
    for f in dataclasses.fields(WorldState):
        whole = getattr(state, f.name)
        parts = [getattr(s, f.name) for s in shards]
        axis = mesh._env_axis(f.name, whole, C)
        rebuilt = parts[0] if axis is None else torch.cat(parts, axis)
        torch.testing.assert_close(rebuilt, whole, rtol=0, atol=0, msg=f.name)
    with pytest.raises(ValueError):
        mesh.env_shard(10, 0, 4)


def test_dryrun_multichip_on_the_cpu(runs):
    """`dryrun_multichip(2, device="cpu")`: both ranks finish the filtered
    iteration with one finite loss."""
    assert np.isfinite(runs["dryrun"])
