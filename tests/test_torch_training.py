"""The port's MAPPO trainer against the JAX package's, and its entry points.

The slice as a whole: one training iteration of `MAPPOCAVs` against JAX's
`_train_iteration` from the same weights, the same env state and the JAX
package's random draws (rebuilt from its key schedule), on cpm_mixed with
N=4, B=4, T=8, one epoch of two minibatches of 16 frames, once with plain
env steps and once in margins-only (CBF-informed) mode; and one with the
challenging initial-state buffer on. Tolerances: the final env state,
observations and the episode-reward metric to atol 1e-4
(eight steps of float32 dynamics); the loss statistics to a relative 1e-4;
at least 99 % of the parameter entries within 1e-6 of JAX's and all of
them within 2 * lr * (number of updates): Adam's first steps move every
entry by about lr times the sign of its gradient, so an entry whose
gradient is ~0 in both may move either way."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigmarl_tpu.config as jcfg
import sigmarl_tpu_torch.config as tcfg
from sigmarl_tpu.env.structs import replace_state as jreplace
from sigmarl_tpu.rl import MAPPOCAVs as JMAPPOCAVs
from sigmarl_tpu.rl.mappo_cavs import TrainState as JTrainState
from sigmarl_tpu_torch.env.reset import ResetDraws
from sigmarl_tpu_torch.env.structs import WorldState
from sigmarl_tpu_torch.rl.mappo_cavs import IterationDraws, MAPPOCAVs, TrainState, mappo_cavs
from sigmarl_tpu_torch.rl.networks import critic_from_jax_params, policy_from_jax_params, to_jax_params
from tests.torch_parity import (
    IDX, as_reset_draws, assert_idx_close, env_variant, envs, reset_draw_arrays, to_numpy,
    to_torch_state,
)

torch.set_num_threads(1)
B, N, T = 4, 4, 8
BASE = dict(
    scenario_type="cpm_mixed", n_agents=N, num_vmas_envs=B, dt=0.1, max_steps=T, n_iters=3,
    num_epochs=1, minibatch_size=16, is_use_mtv_distance=False, is_obs_noise=False,
    random_seed=0,
)
MODES = {
    "plain": {},
    "margins": dict(rew_method="cbf", is_using_cbf_training=True, is_solve_qp=False),
}


def iteration_draws(key, trainer, jenv_cfg, filtered_or_margins: bool) -> IterationDraws:
    """The random numbers JAX's `_train_iteration(state)` draws from
    `state.key` (rollout keys, per-step action and env keys, per-epoch
    permutation and entropy keys), as the port's draws."""
    p = trainer.parameters
    n_mb = trainer.n_minibatches
    M = p.max_steps * p.num_vmas_envs
    mb = M // n_mb

    @jax.jit
    def arrays(key):
        split = jax.vmap(jax.random.split)
        _, k_roll, _, k_ent = jax.random.split(key, 4)
        k_act_env = split(jax.random.split(k_roll, p.max_steps))
        k_act, k_env = k_act_env[:, 0], k_act_env[:, 1]
        if filtered_or_margins:
            k_env = split(k_env)[:, 1]
        noise = jax.vmap(lambda k: jax.random.normal(k, (p.num_vmas_envs, p.n_agents, 2)))(k_act)
        resets = jax.vmap(lambda k: reset_draw_arrays(k, jenv_cfg))(split(k_env)[:, 0])
        k_pe = split(jax.random.split(k_ent, p.num_epochs))
        perms = jax.vmap(lambda k: jax.random.permutation(k, M))(k_pe[:, 0])
        ent = jax.vmap(lambda k: jax.vmap(lambda kk: jax.random.normal(kk, (mb, p.n_agents, 2)))(
            jax.random.split(k, n_mb)))(k_pe[:, 1])
        return noise, resets, perms, ent

    # One compiled function: eager JAX would compile each operation apart.
    noise, resets, perms, ent = arrays(key)
    return IterationDraws(
        action_noise=torch.from_numpy(np.asarray(noise)),
        reset_draws=[as_reset_draws([None if a is None else a[i] for a in resets])
                     for i in range(p.max_steps)],
        permutations=torch.from_numpy(np.asarray(perms)).long(),
        entropy_noise=torch.from_numpy(np.asarray(ent)),
    )


@pytest.fixture(scope="module")
def start():
    """Both envs with the plain configuration, and a JAX reset state."""
    jenv, tenv = envs(**{**BASE, "where_to_save": "unused/"})
    env_state, obs = jax.jit(jenv.reset)(jax.random.PRNGKey(3))
    return jenv, tenv, env_state, obs


@pytest.fixture(scope="module", params=list(MODES))
def iteration(request, start, tmp_path_factory):
    """One iteration in both packages from the same start; returns (JAX
    state, JAX metrics, port state, port metrics, port trainer)."""
    kw = {**BASE, **MODES[request.param],
          "where_to_save": str(tmp_path_factory.mktemp("ckpt")) + "/"}
    jp = jcfg.Parameters(**kw)
    jenv, tenv, env_state, obs = start
    jenv, tenv = env_variant(jenv, tenv, rew_method=jp.rew_method, is_solve_qp=jp.is_solve_qp,
                             is_using_cbf=jp.is_using_cbf_training)
    jtr = JMAPPOCAVs(jp, env=jenv)
    ttr = MAPPOCAVs(tcfg.Parameters(**kw), env=tenv)
    key = jax.random.PRNGKey(11)
    jstate = JTrainState(
        policy_params=jtr.policy_params, critic_params=jtr.critic_params,
        opt_state=jtr.opt_state, env_state=env_state, obs=obs,
        ep_reward_accum=jnp.zeros((B, N)), key=key, iteration=jnp.zeros((), jnp.int32),
    )
    jnew, jmetrics = jtr._train_iteration(jstate)

    np_tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    policy = policy_from_jax_params(np_tree(jtr.policy_params), device="cpu")
    critic = critic_from_jax_params(np_tree(jtr.critic_params), N, device="cpu")
    tstate = TrainState(
        policy=policy, critic=critic,
        opt_state=ttr.optimizer.init(list(policy.parameters()) + list(critic.parameters())),
        env_state=to_torch_state(env_state), obs=torch.from_numpy(np.array(obs)),
        ep_reward_accum=torch.zeros((B, N)), iteration=0,
    )
    draws = iteration_draws(key, ttr, jenv.cfg, request.param != "plain")
    tnew, tmetrics = ttr.train_iteration(tstate, draws)
    return jnew, jmetrics, tnew, tmetrics, ttr


def test_iteration_env_state_and_metric_match_jax(iteration):
    jnew, jm, tnew, tmetrics, _ = iteration
    for f in dataclasses.fields(WorldState):
        a, b = to_numpy(getattr(tnew.env_state, f.name)), np.asarray(getattr(jnew.env_state, f.name))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-5, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_allclose(tnew.obs.numpy(), np.asarray(jnew.obs), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tnew.ep_reward_accum.numpy(), np.asarray(jnew.ep_reward_accum),
                               atol=1e-4)
    np.testing.assert_allclose(float(tmetrics["episode_reward_mean"]),
                               float(jm["episode_reward_mean"]), atol=1e-4)
    assert float(tmetrics["n_done"]) == float(jm["n_done"])


def test_iteration_losses_and_parameters_match_jax(iteration):
    jnew, jm, tnew, tmetrics, ttr = iteration
    for k in ("loss_objective", "loss_critic", "loss_entropy", "entropy", "ratio_mean"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    p = ttr.parameters
    n_updates = ttr.updates_per_iter
    diffs = []
    for net, jparams in ((tnew.policy, jnew.policy_params), (tnew.critic, jnew.critic_params)):
        for a, b in zip(jax.tree_util.tree_leaves(to_jax_params(net)),
                        jax.tree_util.tree_leaves(jparams)):
            diffs.append(np.abs(a - np.asarray(b)).ravel())
    diffs = np.concatenate(diffs)
    assert (diffs <= 1e-6).mean() >= 0.99, (diffs <= 1e-6).mean()
    assert diffs.max() <= 2 * p.lr * n_updates
    assert tnew.opt_state.count == n_updates == 2


def _small_params(tmp_path, **kw):
    return tcfg.Parameters(**{**BASE, "where_to_save": str(tmp_path) + "/", "device": "cpu",
                              "n_iters": 1, **kw})


def test_prb_iteration_runs_and_refreshes_priorities(tmp_path):
    """With the prioritized replay buffer the minibatches are sampled
    frames (given indices here), and the loss stays finite."""
    p = _small_params(tmp_path, is_prb=True)
    tr = MAPPOCAVs(p)
    state = tr.initial_state()
    M = T * B
    g = torch.Generator().manual_seed(0)
    draws = IterationDraws(
        action_noise=torch.randn((T, B, N, 2), generator=g),
        reset_draws=[ResetDraws.sample(tr.env.cfg, g, "cpu") for _ in range(T)],
        permutations=None,
        entropy_noise=torch.randn((1, 2, M // 2, N, 2), generator=g),
        prb_indices=torch.randint(0, M, (1, 2, M // 2), generator=g),
    )
    new, m = tr.train_iteration(state, draws)
    assert np.isfinite(float(m["loss_objective"])) and new.opt_state.count == 2
    new, m = tr.train_iteration(new)  # sampled from the generator
    assert np.isfinite(float(m["loss_critic"])) and new.iteration == 2


@pytest.mark.parametrize(
    "flag",
    [dict(is_using_prioritized_marl=True), dict(is_using_opponent_modeling=True),
     dict(debug_numerics=True)],
    ids=["xp-marl", "opponent-modeling", "debug-numerics"],
)
def test_unported_trainer_options_raise(tmp_path, flag):
    """The trainer options that once raised (XP-MARL, opponent modeling,
    debug_numerics) are ported: each builds and runs one iteration with
    finite losses and observations."""
    try:
        tr = MAPPOCAVs(_small_params(tmp_path, **flag))
        state, m = tr.train_iteration(tr.initial_state())
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert np.isfinite(float(m["loss_objective"])) and np.isfinite(float(m["loss_critic"]))
    assert bool(torch.isfinite(state.obs).all()) and state.opt_state.count == 2
    if tr.use_prio:
        assert np.isfinite(float(m["loss_priority"]))


def test_train_continue_and_load_only(tmp_path):
    """`mappo_cavs` trains and writes checkpoints; continue-training
    restores the best weights with fresh Adam moments and the sidecar's
    history; the load-only path returns the saved networks untrained."""
    p = _small_params(tmp_path, max_steps=4, n_iters=2)
    env, dm, om, prio, cbfs, _ = mappo_cavs(p)
    assert prio is None and cbfs is None and om.opt_state.count == 2
    d = os.path.join(p.where_to_save, p.model_name)
    assert {"final_policy.pkl", "final_critic.pkl", "final_data.json"} <= set(os.listdir(d))

    p2 = _small_params(tmp_path, max_steps=4, n_iters=2, is_load_model=True,
                       is_load_final_model=True)
    p2.is_continue_train = True
    tr = MAPPOCAVs(p2)
    for a, b in zip(tr.policy_net.parameters(), dm.net.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tr.opt_state.count == 0 and len(tr._restored_history) == 2

    p3 = _small_params(tmp_path, max_steps=4, n_iters=2, is_load_model=True,
                       is_load_final_model=True)
    env, dm3, om3, *_ = mappo_cavs(p3)
    for a, b in zip(om3.critic.parameters(), om.critic.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    obs = torch.zeros((B, N, env.obs_dim))
    act, logp = dm3.act(obs, generator=torch.Generator().manual_seed(0))
    assert act.shape == (B, N, 2) and bool(torch.isfinite(logp).all())
    assert bool((act.abs() <= env.action_limits + 1e-6).all())


def test_main_training_cli_on_cpu(tmp_path, capsys):
    from sigmarl_tpu_torch import main_training

    main_training.main(["--device", "cpu", "--n_iters", "1", "--num_vmas_envs", "4",
                        "--max_steps", "8", "--where_to_save", str(tmp_path) + "/"])
    (d,) = os.listdir(tmp_path)
    files = os.listdir(os.path.join(tmp_path, d))
    assert {"info.txt", "final_policy.pkl", "final_critic.pkl"} <= set(files)
    assert "iter 1/1" in capsys.readouterr().out


def test_training_iteration_with_the_buffer_matches_jax(start, tmp_path):
    """One iteration with the challenging initial-state buffer on, from a
    state whose eight-slot buffer holds four records and with every
    full-env reset replaying one (every env ends at least once, at
    max_steps): the env state (boundary indices as
    `torch_parity.assert_idx_close` allows at float32 ties, which replays
    meet), observations, episode reward and losses to the tolerances
    above."""
    kw = {**BASE, "is_challenging_initial_state_buffer": True, "where_to_save": str(tmp_path) + "/"}
    Bt, Nt = B, N
    jenv, tenv, env_state, obs = start
    jenv, tenv = env_variant(jenv, tenv, is_challenging_initial_state_buffer=True,
                             probability_use_recording=1.0, challenge_buffer_size=8)
    rec = np.array(env_state.state_buffer)[(int(env_state.sb_pointer) - 1) % 10]  # [B, N, 8]
    cbuf = np.zeros((8, Nt, 8), np.float32)
    cbuf[:Bt] = rec[::-1]
    env_state = jreplace(env_state, challenge_buffer=jnp.asarray(cbuf),
                         cb_valid=jnp.asarray(Bt, jnp.int32), cb_pointer=jnp.asarray(Bt, jnp.int32))
    jtr = JMAPPOCAVs(jcfg.Parameters(**kw), env=jenv)
    ttr = MAPPOCAVs(tcfg.Parameters(**kw), env=tenv)
    key = jax.random.PRNGKey(11)
    jstate = JTrainState(
        policy_params=jtr.policy_params, critic_params=jtr.critic_params,
        opt_state=jtr.opt_state, env_state=env_state, obs=obs,
        ep_reward_accum=jnp.zeros((Bt, Nt)), key=key, iteration=jnp.zeros((), jnp.int32),
    )
    jnew, jm = jtr._train_iteration(jstate)
    np_tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    policy = policy_from_jax_params(np_tree(jtr.policy_params), device="cpu")
    critic = critic_from_jax_params(np_tree(jtr.critic_params), Nt, device="cpu")
    tstate = TrainState(
        policy=policy, critic=critic,
        opt_state=ttr.optimizer.init(list(policy.parameters()) + list(critic.parameters())),
        env_state=to_torch_state(env_state), obs=torch.from_numpy(np.array(obs)),
        ep_reward_accum=torch.zeros((Bt, Nt)), iteration=0,
    )
    tnew, tm = ttr.train_iteration(tstate, iteration_draws(key, ttr, jenv.cfg, False))
    assert_idx_close(tnew.env_state, jnew.env_state, tenv.tables)
    for f in dataclasses.fields(WorldState):
        if f.name in IDX:
            continue
        a, b = to_numpy(getattr(tnew.env_state, f.name)), np.asarray(getattr(jnew.env_state, f.name))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-5, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_allclose(tnew.obs.numpy(), np.asarray(jnew.obs), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(float(tm["episode_reward_mean"]), float(jm["episode_reward_mean"]),
                               atol=1e-4)
    assert float(tm["n_done"]) == float(jm["n_done"]) > 0
    for k in ("loss_objective", "loss_critic", "loss_entropy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
