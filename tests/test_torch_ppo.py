"""The port's networks, PPO losses, optimizer and checkpoints against the
JAX package, from the same weights and inputs (made with numpy from a
seed).

Tolerances: float32 network outputs and loss values agree to atol 1e-5
(matrix products of width 256 summed in other orders); gradients to atol
1e-5 and relative 1e-4; the optimizer is held in float64 to 1e-12."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sigmarl_tpu.config as jcfg
import sigmarl_tpu_torch.config as tcfg
from sigmarl_tpu.rl import checkpoint as jckpt
from sigmarl_tpu.rl import networks as jnet
from sigmarl_tpu.rl import ppo as jppo
from sigmarl_tpu_torch.rl import checkpoint as tckpt
from sigmarl_tpu_torch.rl import networks as tnet
from sigmarl_tpu_torch.rl import ppo as tppo
from sigmarl_tpu_torch.rl.optim import ClippedAdam

torch.set_num_threads(1)
M, N, D = 6, 4, 12
LOW, HIGH = np.array([-1.0, -0.5], np.float32), np.array([1.0, 0.5], np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def nets():
    """JAX policy and centralized critic with their parameters, and the
    port's networks carrying the same weights."""
    obs = np.random.default_rng(0).normal(size=(M, N, D)).astype(np.float32)
    jpol, jcrit = jnet.PolicyNet(), jnet.CentralizedCritic()
    pp = jpol.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    cp = jcrit.init(jax.random.PRNGKey(1), jnp.asarray(obs))
    pol = tnet.policy_from_jax_params(numpy_tree(pp), device="cpu")
    crit = tnet.critic_from_jax_params(numpy_tree(cp), N, device="cpu")
    return obs, jpol, jcrit, pp, cp, pol, crit


@pytest.mark.parametrize("kind", ["centralized", "decentralized"])
def test_critics_carried_across(nets, kind):
    obs = nets[0]
    if kind == "centralized":
        jcrit, cp, crit = nets[2], nets[4], nets[6]
    else:
        jcrit = jnet.DecentralizedCritic()
        cp = jcrit.init(jax.random.PRNGKey(2), jnp.asarray(obs))
        crit = tnet.critic_from_jax_params(numpy_tree(cp), None, device="cpu")
        assert isinstance(crit, tnet.DecentralizedCritic)
    jv = np.asarray(jcrit.apply(cp, jnp.asarray(obs)))
    with torch.no_grad():
        tv = crit(t(obs)).numpy()
    assert tv.shape == jv.shape == (M, N, 1)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    # The inverse gives back the flax tree exactly.
    back = tnet.to_jax_params(crit)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(numpy_tree(cp))):
        np.testing.assert_array_equal(a, b)


def test_tanh_normal_log_prob_and_mode():
    rng = np.random.default_rng(1)
    loc = rng.normal(size=(M, N, 2)).astype(np.float32) * 3
    scale = rng.uniform(0.1, 2.0, size=(M, N, 2)).astype(np.float32)
    act = rng.uniform(-1.2, 1.2, size=(M, N, 2)).astype(np.float32) * HIGH  # some outside the box
    act[0, 0] = HIGH  # on the edge: clipped before atanh
    jlp = jnet.tanh_normal_log_prob(act, loc, scale, LOW, HIGH)
    tlp = tnet.tanh_normal_log_prob(t(act), t(loc), t(scale), t(LOW), t(HIGH))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5, rtol=1e-6)
    jm = jnet.tanh_normal_mode(loc, LOW, HIGH)
    tm = tnet.tanh_normal_mode(t(loc), t(LOW), t(HIGH))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)


def test_gae_matches_jax():
    rng = np.random.default_rng(2)
    T, B = 9, 3
    rew = rng.normal(size=(T, B, N)).astype(np.float32)
    val = rng.normal(size=(T, B, N)).astype(np.float32)
    nval = rng.normal(size=(T, B, N)).astype(np.float32)
    done = rng.uniform(size=(T, B)) < 0.3
    ja, jt = jppo.gae(rew, val, nval, done, 0.99, 0.9)
    ta, tt = tppo.gae(t(rew), t(val), t(nval), t(done), 0.99, 0.9)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


def test_ppo_losses_and_gradients_match_jax(nets):
    """Loss values and the gradients with respect to every network
    parameter, from the same minibatch and entropy noise."""
    obs, jpol, jcrit, pp, cp, pol, crit = nets
    rng = np.random.default_rng(3)
    act = (rng.uniform(-0.9, 0.9, size=(M, N, 2)) * HIGH).astype(np.float32)
    old_lp = rng.normal(size=(M, N)).astype(np.float32) - 1.0
    adv = rng.normal(size=(M, N)).astype(np.float32)
    vt = rng.normal(size=(M, N)).astype(np.float32) * 2
    cfg = jppo.PPOConfig(entropy_eps=1e-2)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, (M, N, 2)))

    def jloss(params):
        loc, scale = jpol.apply(params["policy"], obs)
        v = jcrit.apply(params["critic"], obs)[..., 0]
        return jppo.ppo_losses(loc, scale, v, act, old_lp, adv, vt, LOW, HIGH, cfg, key)

    (jtotal, jstats), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {"policy": pp, "critic": cp})
    loc, scale = pol(t(obs))
    v = crit(t(obs))[..., 0]
    total, stats = tppo.ppo_losses(
        loc, scale, v, t(act), t(old_lp), t(adv), t(vt), t(LOW), t(HIGH),
        tppo.PPOConfig(*cfg), t(noise),
    )
    np.testing.assert_allclose(float(total.detach()), float(jtotal), atol=1e-5, rtol=1e-5)
    for k in jstats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    total.backward()
    for name, net in (("policy", pol), ("critic", crit)):
        g = {"params": {"MLP_0": {
            f"Dense_{k}": {"kernel": layer.weight.grad.numpy().T, "bias": layer.bias.grad.numpy()}
            for k, layer in enumerate(net.mlp.layers)}}}
        for a, b in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(jgrads[name])):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-4, err_msg=name)


def test_optimizer_matches_optax_chain():
    """Three updates, the first two clipped (global norm over policy and
    critic together above max_grad_norm) and the third not, with two
    updates per iteration so that the third crosses an iteration boundary
    of the learning-rate schedule; float64 under `jax.enable_x64`, 1e-12."""
    rng = np.random.default_rng(5)
    shapes = {"critic": [(3, 2), (2,)], "policy": [(4, 3), (3,), (3, 1)]}
    params = {k: [rng.normal(size=s) for s in v] for k, v in shapes.items()}
    grads = [{k: [rng.normal(size=s) * scale for s in v] for k, v in shapes.items()}
             for scale in (3.0, 1.0, 0.05)]
    # Rates and fractions exact in float32: optax's schedule divides the
    # int32 update count in float32 even under x64.
    lr, lr_min, max_norm, upi, n_iters = 2.0**-8, 2.0**-11, 1.0, 2, 4

    def lr_schedule(count):
        it = count // upi
        return lr_min + (lr - lr_min) * (1.0 - it / n_iters)

    with jax.enable_x64(True):
        opt = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(learning_rate=lr_schedule))
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        st = opt.init(jp)
        update = jax.jit(opt.update)
        jhist = []
        for g in grads:
            norm = np.sqrt(sum(float(np.sum(x * x)) for v in g.values() for x in v))
            jhist.append(norm)
            upd, st = update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
            jp = optax.apply_updates(jp, upd)
            jhist.append(jax.tree_util.tree_map(np.asarray, jp))
    assert jhist[0] > max_norm and jhist[2] > max_norm and jhist[4] < max_norm

    order = [(k, i) for k in ("policy", "critic") for i in range(len(shapes[k]))]
    tp = [torch.tensor(params[k][i]) for k, i in order]
    adam = ClippedAdam(max_norm, lr, lr_min, upi, n_iters)
    state = adam.init(tp)
    for step, g in enumerate(grads):
        state = adam.step(tp, [torch.tensor(g[k][i]) for k, i in order], state)
        want = jhist[2 * step + 1]
        for (k, i), p in zip(order, tp):
            np.testing.assert_allclose(p.numpy(), want[k][i], atol=1e-12, rtol=0)
    assert state.count == 3
    assert adam.learning_rate(2) == pytest.approx(lr_schedule(2))


def _param_sets(tmp_path):
    jp = jcfg.Parameters(where_to_save=str(tmp_path) + "/", model_name="m")
    tp = tcfg.Parameters(where_to_save=str(tmp_path) + "/", model_name="m", device="cpu")
    return jp, tp


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_interoperate(nets, tmp_path, writer):
    """A checkpoint written by one package loads in the other: the port's
    files read by JAX's `load_best` drive flax `apply`, JAX's files read by
    the port's `load_best` build the port's networks, with equal outputs."""
    obs, jpol, jcrit, pp, cp, pol, crit = nets
    jp, tp = _param_sets(tmp_path)
    if writer == "port":
        saver = tckpt.RewardKeyedCheckpointer(tp)
        saver.maybe_save(1.5, {"policy": tnet.to_jax_params(pol),
                               "critic": tnet.to_jax_params(crit)}, [1.5])
        loaded = jckpt.load_best(jp)
        jloc, jscale = jpol.apply(loaded["policy"], obs)
        jv = jcrit.apply(loaded["critic"], obs)
        with torch.no_grad():
            loc, scale = pol(t(obs))
            v = crit(t(obs))
    else:
        saver = jckpt.RewardKeyedCheckpointer(jp)
        saver.maybe_save(1.5, {"policy": pp, "critic": cp}, [1.5])
        loaded = tckpt.load_best(tp)
        jloc, jscale = jpol.apply(pp, obs)
        jv = jcrit.apply(cp, obs)
        with torch.no_grad():
            loc, scale = tnet.policy_from_jax_params(loaded["policy"], "cpu")(t(obs))
            v = tnet.critic_from_jax_params(loaded["critic"], N, "cpu")(t(obs))
    for a, b in ((loc, jloc), (scale, jscale), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_checkpoint_retention_and_sidecar(tmp_path):
    """Lower rewards are deleted, a worse reward writes no model, the
    sidecars of both packages have the same keys, and `final_*` loads."""
    jp, tp = _param_sets(tmp_path / "port")
    tree = {"policy": {"w": np.ones(2, np.float32)}, "critic": {"w": np.zeros(2, np.float32)}}
    saver = tckpt.RewardKeyedCheckpointer(tp)
    assert saver.maybe_save(1.0, tree, [1.0])
    assert saver.maybe_save(2.0, tree, [1.0, 2.0])
    assert not saver.maybe_save(0.5, tree, [1.0, 2.0, 0.5])
    assert not saver.maybe_save(float("nan"), tree, [1.0, 2.0, 0.5, float("nan")])
    saver.save_final(tree, [1.0, 2.0, 0.5])
    d = tckpt.model_dir(tp)
    assert sorted(os.listdir(d)) == [
        "final_critic.pkl", "final_data.json", "final_policy.pkl",
        "reward2.00_critic.pkl", "reward2.00_data.json", "reward2.00_policy.pkl",
    ]
    assert tckpt.find_highest_reward(d) == 2.0
    tside = tckpt.load_sidecar(tp)
    assert tside["parameters"]["episode_reward_intermediate"] == 2.0

    jp2, _ = _param_sets(tmp_path / "jax")
    jsaver = jckpt.RewardKeyedCheckpointer(jp2)
    jsaver.maybe_save(2.0, tree, [2.0])
    jside = jckpt.load_sidecar(jp2)
    assert set(jside) == set(tside)
    assert set(jside["parameters"]) == set(tside["parameters"])

    tp.is_load_final_model = True
    np.testing.assert_array_equal(tckpt.load_best(tp)["policy"]["w"], tree["policy"]["w"])
