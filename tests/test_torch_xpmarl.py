"""XP-MARL, opponent modeling and the learned-CBF module of the port against
the JAX package, from JAX's parameters and JAX's random draws.

The modules: `priority_rank` (learned and random), `nearing_agent_indices`
on tied distances, `prioritized_action_propagation` (with and without
communication noise), `opponent_modeling_policy`, the score networks and
`CBFModule.train_step`. The slice as a whole: one `MAPPOCAVs` iteration
against JAX's `_train_iteration` on cpm_mixed with N=4, B=4, T=8, one
epoch of two minibatches of 16 frames, with the MTV distance and
observation noise on, once with learned priority and communication noise
and once with opponent modeling; random priority runs a port-only
iteration.

Tolerances: actions, scores, their log-probabilities and the observations
the agents acted on to atol 1e-5 (float32 products of width 256); ranks
and neighbour indices exactly; the learned-CBF update's losses to a
relative 1e-4 and its parameters to 1e-6; the whole iteration as in
`test_torch_training.py`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigmarl_tpu.config as jcfg
import sigmarl_tpu_torch.config as tcfg
from sigmarl_tpu.rl import MAPPOCAVs as JMAPPOCAVs
from sigmarl_tpu.rl import cbf_module as jcbfm
from sigmarl_tpu.rl import networks as jnet
from sigmarl_tpu.rl import opponent as jopp
from sigmarl_tpu.rl import priority as jprio
from sigmarl_tpu.rl.mappo_cavs import TrainState as JTrainState
from sigmarl_tpu_torch.env.structs import WorldState
from sigmarl_tpu_torch.rl.cbf_module import CBFModule, make_cbf_observation
from sigmarl_tpu_torch.rl.mappo_cavs import IterationDraws, MAPPOCAVs, TrainState
from sigmarl_tpu_torch.rl.networks import (
    critic_from_jax_params, policy_from_jax_params, score_critic, score_policy, to_jax_params,
)
from sigmarl_tpu_torch.rl.opponent import opponent_modeling_policy
from sigmarl_tpu_torch.rl.priority import (
    nearing_agent_indices, prioritized_action_propagation, priority_rank,
)
from tests.torch_parity import (
    as_reset_draws, envs, obs_noise_array, reset_draw_arrays, to_numpy, to_torch_state,
)

torch.set_num_threads(1)
B, N, D, K = 8, 4, 20, 2
LIM = np.array([1.0, 0.4], np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    """Observations, mutual distances and a rank per env (numpy, seeded)."""
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(B, N, D)).astype(np.float32)
    d = rng.uniform(0.1, 2.0, size=(B, N, N)).astype(np.float32)
    d[:, np.arange(N), np.arange(N)] = 9.0
    rank = np.stack([rng.permutation(N) for _ in range(B)]).astype(np.int32)
    return obs, d, rank


def j(x):
    return jnp.asarray(x)


def test_score_networks_carried_across(inputs):
    """The priority policy and critic (2x256) from JAX parameters, and
    fresh ones of the port with the same shapes as JAX's."""
    obs = inputs[0]
    net, crit = jprio.PriorityNet(), jprio.PriorityCritic()
    pp = net.init(jax.random.PRNGKey(0), obs)
    cp = crit.init(jax.random.PRNGKey(1), obs)
    pol, tcrit = policy_from_jax_params(numpy_tree(pp), "cpu"), critic_from_jax_params(
        numpy_tree(cp), N, "cpu")
    jloc, jscale = net.apply(pp, obs)
    with torch.no_grad():
        loc, scale = pol(t(obs))
        v = tcrit(t(obs))
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), atol=1e-5)
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(crit.apply(cp, obs)), atol=1e-5)
    for fresh, jtree in ((score_policy(D, "cpu"), pp), (score_critic(D, N, "cpu"), cp),
                         (score_critic(D, None, "cpu"), jcbfm.CBFCritic(centralised=False).init(
                             jax.random.PRNGKey(2), obs))):
        shapes = [a.shape for a in jax.tree_util.tree_leaves(to_jax_params(fresh))]
        assert shapes == [a.shape for a in jax.tree_util.tree_leaves(jtree)]


@pytest.mark.parametrize("method", ["marl", "random"])
def test_priority_rank_matches_jax(inputs, method):
    obs = inputs[0]
    net = jprio.PriorityNet()
    params = net.init(jax.random.PRNGKey(0), obs)
    key = jax.random.PRNGKey(5)
    want = jprio.priority_rank(method, net, params, obs, key)
    if method == "marl":
        got = priority_rank("marl", policy_from_jax_params(numpy_tree(params), "cpu"), t(obs),
                            noise=t(jax.random.normal(key, (B, N, 1))))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5)
        np.testing.assert_allclose(got.log_prob.numpy(), np.asarray(want.log_prob), atol=1e-5)
    else:
        perms = jax.vmap(lambda k: jax.random.permutation(k, N))(jax.random.split(key, B))
        got = priority_rank("random", None, t(obs), perms=t(perms))
        fresh = priority_rank("random", None, t(obs), generator=torch.Generator().manual_seed(0))
        assert (np.sort(fresh.rank.numpy(), -1) == np.arange(N)).all()
    np.testing.assert_array_equal(got.rank.numpy(), np.asarray(want.rank))


def test_nearing_indices_on_ties_match_jax():
    """Integer distances with many ties: the lower index comes first, as
    in JAX's `top_k`."""
    d = np.random.default_rng(1).integers(0, 3, size=(16, 6, 6)).astype(np.float32)
    for k in (1, 2, 4):
        want = np.asarray(jprio.nearing_agent_indices(d, k))
        np.testing.assert_array_equal(nearing_agent_indices(t(d), k).numpy(), want)


def _policy(dim):
    net = jnet.PolicyNet()
    params = net.init(jax.random.PRNGKey(3), jnp.zeros((1, N, dim)))
    return net, params, policy_from_jax_params(numpy_tree(params), "cpu")


@pytest.mark.parametrize("comm", [0.0, 0.1])
def test_prioritized_action_propagation_matches_jax(inputs, comm):
    """Four priority turns from the same rank and neighbours; JAX's per-turn
    keys give the action noise and, with a level, the communication
    noise."""
    obs, d, rank = inputs
    base = np.pad(obs, ((0, 0), (0, 0), (0, 2 * K)))
    net, params, pol = _policy(D + 2 * K)
    nearing = np.asarray(jprio.nearing_agent_indices(d, K))
    key = jax.random.PRNGKey(8)
    want = jprio.prioritized_action_propagation(
        net, params, j(base), j(rank), j(nearing), j(-LIM), j(LIM), key,
        communication_noise_level=comm)
    keys = jax.random.split(key, N)
    comm_noise = None
    if comm > 0:
        pairs = jax.vmap(jax.random.split)(keys)
        keys = pairs[:, 1]
        comm_noise = t(jax.vmap(lambda k: jax.random.normal(k, (B, 2 * K)))(pairs[:, 0]))
    noise = t(jax.vmap(lambda k: jax.random.normal(k, (B, 2)))(keys))
    with torch.no_grad():
        got = prioritized_action_propagation(
            pol, t(base), t(rank), t(nearing), t(-LIM), t(LIM), action_noise=noise,
            communication_noise_level=comm, communication_noise=comm_noise)
    np.testing.assert_allclose(got.actions.numpy(), np.asarray(want.actions), atol=1e-5)
    np.testing.assert_allclose(got.log_prob.numpy(), np.asarray(want.log_prob), atol=1e-5)
    np.testing.assert_allclose(got.obs_used.numpy(), np.asarray(want.obs_used), atol=1e-5)
    # The agent acting first sees no decided action (plus noise), the last
    # sees its neighbours' decided actions.
    first = got.obs_used[np.arange(B), rank[:, 0], -2 * K:]
    assert (first == 0).all() if comm == 0 else not (first == 0).any()


def test_opponent_modeling_matches_jax(inputs):
    obs, d, _ = inputs
    padded = np.pad(obs, ((0, 0), (0, 0), (0, 2 * K)))
    net, params, pol = _policy(D + 2 * K)
    nearing = np.asarray(jprio.nearing_agent_indices(d, K))
    key = jax.random.PRNGKey(2)
    want = jopp.opponent_modeling_policy(net, params, j(padded), j(nearing), j(-LIM), j(LIM), key)
    k1, _, k3 = jax.random.split(key, 3)
    noise = t(jnp.stack([jax.random.normal(k1, (B, N, 2)), jax.random.normal(k3, (B, N, 2))]))
    with torch.no_grad():
        got = opponent_modeling_policy(pol, t(padded), t(nearing), t(-LIM), t(LIM),
                                       action_noise=noise)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_cbf_module_train_step_matches_jax():
    """One full-batch Clip-PPO update under constant-rate Adam from the
    same parameters and entropy noise; scores sampled from the same
    normals."""
    T_, B_ = 4, 4
    rng = np.random.default_rng(3)
    raw = rng.normal(size=(T_, B_, N, D)).astype(np.float32)
    obs = np.asarray(jcbfm.make_cbf_observation(raw, K))
    np.testing.assert_array_equal(make_cbf_observation(t(raw), K).numpy(), obs)
    next_obs = np.roll(obs, -1, axis=0)
    rewards = rng.normal(size=(T_, B_, N)).astype(np.float32)
    dones = rng.random((T_, B_)) < 0.2
    jmod = jcbfm.CBFModule(D + 2 * K, N)
    jstate = jmod.init(jax.random.PRNGKey(0))
    k_s, k_e = jax.random.split(jax.random.PRNGKey(1))
    scores, old_lp = jax.jit(jmod.sample_scores)(jstate, obs, k_s)
    jnew, jstats = jax.jit(jmod.train_step)(jstate, obs, next_obs, scores, old_lp, rewards,
                                            dones, k_e)

    mod = CBFModule(D + 2 * K, N, device="cpu")
    fresh = mod.init(seed=1)
    assert [a.shape for a in jax.tree_util.tree_leaves(to_jax_params(fresh.critic))] == [
        a.shape for a in jax.tree_util.tree_leaves(jstate.critic_params)]
    state = mod.state(policy_from_jax_params(numpy_tree(jstate.policy_params), "cpu"),
                      critic_from_jax_params(numpy_tree(jstate.critic_params), N, "cpu"))
    s2, lp2 = mod.sample_scores(state, t(obs), noise=t(jax.random.normal(k_s, (T_, B_, N, 1))))
    np.testing.assert_allclose(s2.numpy(), np.asarray(scores), atol=1e-5)
    np.testing.assert_allclose(lp2.numpy(), np.asarray(old_lp), atol=1e-4, rtol=1e-5)
    new, stats = mod.train_step(
        state, t(obs), t(next_obs), t(scores), t(old_lp), t(rewards), t(dones),
        entropy_noise=t(jax.random.normal(k_e, (T_ * B_, N, 1))))
    for k in ("loss_objective", "loss_critic", "loss_entropy"):
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-4, err_msg=k)
    for net, jparams in ((new.policy, jnew.policy_params), (new.critic, jnew.critic_params)):
        for a, b in zip(jax.tree_util.tree_leaves(to_jax_params(net)),
                        jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    assert new.opt_state.count == 1


# ------------------------------------------------------ the whole iteration
IT_B, IT_T = 4, 8
BASE = dict(
    scenario_type="cpm_mixed", n_agents=N, num_vmas_envs=IT_B, dt=0.1, max_steps=IT_T,
    n_iters=3, num_epochs=1, minibatch_size=16, is_use_mtv_distance=True, is_obs_noise=True,
    random_seed=0,
)
MODES = {
    "learned-priority": dict(is_using_prioritized_marl=True, prioritization_method="marl",
                             is_communication_noise=True),
    "opponent-modeling": dict(is_using_opponent_modeling=True),
}


def iteration_draws(key, trainer, jenv_cfg) -> IterationDraws:
    """The random numbers JAX's `_train_iteration(state)` draws from
    `state.key` (`rl/mappo_cavs.py`, `rl/priority.py`, `rl/opponent.py`):
    per step the action keys (priority sample, one key per turn and its
    communication-noise split, or the two opponent-modeling passes) and the
    env keys (reset and observation noise); per epoch the permutation and
    per minibatch one entropy key for both losses."""
    p = trainer.parameters
    T, Bn, n_mb = p.max_steps, p.num_vmas_envs, trainer.n_minibatches
    M = T * Bn
    mb = M // n_mb
    @jax.jit
    def arrays(key):
        split, vmap = jax.vmap(jax.random.split), jax.vmap
        _, k_roll, _, k_ent = jax.random.split(key, 4)
        k_act_env = split(jax.random.split(k_roll, T))
        k_act, k_env = k_act_env[:, 0], k_act_env[:, 1]
        extra = {}
        if trainer.use_prio:
            k_pa = split(k_act)
            extra["priority_noise"] = vmap(lambda k: jax.random.normal(k, (Bn, N, 1)))(k_pa[:, 0])
            turns = vmap(lambda k: jax.random.split(k, N))(k_pa[:, 1])  # [T, N, 2]
            if trainer.communication_noise_level > 0:
                pairs = vmap(split)(turns)
                turns = pairs[:, :, 1]
                extra["communication_noise"] = vmap(vmap(
                    lambda k: jax.random.normal(k, (Bn, 2 * trainer.k_nearing))))(pairs[:, :, 0])
            noise = vmap(vmap(lambda k: jax.random.normal(k, (Bn, 2))))(turns)
        else:
            k3 = vmap(lambda k: jax.random.split(k, 3))(k_act)
            normal = vmap(lambda k: jax.random.normal(k, (Bn, N, 2)))
            noise = jnp.stack([normal(k3[:, 0]), normal(k3[:, 2])], axis=1)
        resets = vmap(lambda k: reset_draw_arrays(k, jenv_cfg))(split(k_env)[:, 0])
        k_pe = split(jax.random.split(k_ent, p.num_epochs))
        ent_keys = vmap(lambda k: jax.random.split(k, n_mb))(k_pe[:, 1])
        ent = vmap(vmap(lambda k: jax.random.normal(k, (mb, N, 2))))(ent_keys)
        extra["priority_entropy_noise"] = vmap(vmap(
            lambda k: jax.random.normal(k, (mb, N, 1))))(ent_keys)
        perms = vmap(lambda k: jax.random.permutation(k, M))(k_pe[:, 0])
        obs_noise = vmap(lambda k: obs_noise_array(k, jenv_cfg))(k_env)
        return noise, resets, perms, ent, obs_noise, extra

    # One compiled function: eager JAX would compile each operation apart.
    noise, resets, perms, ent, obs_noise, extra = arrays(key)
    return IterationDraws(
        action_noise=t(noise),
        reset_draws=[as_reset_draws([None if a is None else a[i] for a in resets])
                     for i in range(T)],
        permutations=t(perms).long(),
        entropy_noise=t(ent),
        obs_noise=t(obs_noise),
        **{k: t(v) for k, v in extra.items()},
    )


@pytest.fixture(scope="module", params=list(MODES))
def iteration(request, tmp_path_factory):
    """One iteration in both packages from the same JAX reset state and
    weights; returns (JAX state, JAX metrics, port state, port metrics,
    port trainer)."""
    kw = {**BASE, **MODES[request.param],
          "where_to_save": str(tmp_path_factory.mktemp("ckpt")) + "/"}
    jenv, tenv = envs(**kw)
    env_state, obs = jax.jit(jenv.reset)(jax.random.PRNGKey(3))
    jtr = JMAPPOCAVs(jcfg.Parameters(**kw), env=jenv)
    ttr = MAPPOCAVs(tcfg.Parameters(**kw), env=tenv)
    key = jax.random.PRNGKey(11)
    jstate = JTrainState(
        policy_params=jtr.policy_params, critic_params=jtr.critic_params,
        opt_state=jtr.opt_state, env_state=env_state, obs=obs,
        ep_reward_accum=jnp.zeros((IT_B, N)), key=key, iteration=jnp.zeros((), jnp.int32),
        prio_policy_params=jtr.prio_policy_params, prio_critic_params=jtr.prio_critic_params,
    )
    jnew, jmetrics = jtr._train_iteration(jstate)

    nets = [policy_from_jax_params(numpy_tree(jtr.policy_params), "cpu"),
            critic_from_jax_params(numpy_tree(jtr.critic_params), N, "cpu")]
    if jtr.prio_policy_params is not None:
        nets += [policy_from_jax_params(numpy_tree(jtr.prio_policy_params), "cpu"),
                 critic_from_jax_params(numpy_tree(jtr.prio_critic_params), N, "cpu")]
    tstate = TrainState(
        nets[0], nets[1], ttr.optimizer.init(ttr.parameter_list(*nets)),
        to_torch_state(env_state), t(obs), torch.zeros((IT_B, N)), 0, *nets[2:],
    )
    tnew, tmetrics = ttr.train_iteration(tstate, iteration_draws(key, ttr, jenv.cfg))
    return jnew, jmetrics, tnew, tmetrics, ttr


def test_iteration_env_state_and_metric_match_jax(iteration):
    jnew, jm, tnew, tmetrics, _ = iteration
    for f in dataclasses.fields(WorldState):
        a = to_numpy(getattr(tnew.env_state, f.name))
        b = np.asarray(getattr(jnew.env_state, f.name))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-5, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_allclose(tnew.obs.numpy(), np.asarray(jnew.obs), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics["episode_reward_mean"]),
                               float(jm["episode_reward_mean"]), atol=1e-4)
    assert float(tmetrics["n_done"]) == float(jm["n_done"])


def test_iteration_losses_and_parameters_match_jax(iteration):
    jnew, jm, tnew, tmetrics, ttr = iteration
    keys = ["loss_objective", "loss_critic", "loss_entropy", "entropy", "ratio_mean"]
    if ttr.use_prio:
        keys.append("loss_priority")
    assert set(keys) <= set(tmetrics) and set(jm) - {"episode_reward_mean", "n_done"} <= set(keys)
    for k in keys:
        np.testing.assert_allclose(float(tmetrics[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    pairs = [(tnew.policy, jnew.policy_params), (tnew.critic, jnew.critic_params)]
    if ttr.use_prio:
        pairs += [(tnew.prio_policy, jnew.prio_policy_params),
                  (tnew.prio_critic, jnew.prio_critic_params)]
    diffs = np.concatenate([
        np.abs(a - np.asarray(b)).ravel() for net, jparams in pairs
        for a, b in zip(jax.tree_util.tree_leaves(to_jax_params(net)),
                        jax.tree_util.tree_leaves(jparams))])
    assert (diffs <= 1e-6).mean() >= 0.99, (diffs <= 1e-6).mean()
    assert diffs.max() <= 2 * ttr.parameters.lr * ttr.updates_per_iter
    assert tnew.opt_state.count == ttr.updates_per_iter == 2


def test_random_priority_iteration_runs(tmp_path):
    """Random priority: no priority networks, the policy's observation
    padded for the propagated actions, finite losses."""
    p = tcfg.Parameters(**{**BASE, "is_using_prioritized_marl": True,
                           "prioritization_method": "random", "device": "cpu",
                           "where_to_save": str(tmp_path) + "/"})
    tr = MAPPOCAVs(p)
    assert tr.prio_policy_net is None and tr.policy_obs_dim == tr.env.obs_dim + 2 * tr.k_nearing
    state, m = tr.train_iteration(tr.initial_state())
    assert "loss_priority" not in m and np.isfinite(float(m["loss_objective"]))
    assert bool(torch.isfinite(state.obs).all()) and state.opt_state.count == 2


def test_debug_numerics_guards_the_loss(tmp_path):
    """With `debug_numerics` a minibatch whose advantages hold a NaN raises
    before the optimizer step; a healthy minibatch is silent."""
    p = tcfg.Parameters(**{**BASE, "debug_numerics": True, "device": "cpu",
                           "where_to_save": str(tmp_path) + "/"})
    try:
        tr = MAPPOCAVs(p)
        g = torch.Generator().manual_seed(0)
        mb = {"obs": torch.randn((16, N, tr.env.obs_dim), generator=g),
              "action": torch.zeros((16, N, 2)), "log_prob": torch.zeros((16, N)),
              "adv": torch.randn((16, N), generator=g), "vt": torch.zeros((16, N))}
        noise = torch.randn((16, N, 2), generator=g)
        opt = tr.minibatch_update(tr.networks(), tr.opt_state, mb, noise)[0]
        assert opt.count == 1
        mb["adv"][3, 1] = float("nan")
        before = [x.clone() for x in tr.parameter_list()]
        with pytest.raises(FloatingPointError, match="ppo_loss"):
            tr.minibatch_update(tr.networks(), opt, mb, noise)
        assert all(torch.equal(a, b) for a, b in zip(before, tr.parameter_list()))
    finally:
        torch.autograd.set_detect_anomaly(False)
