"""The CBF-filtered trainer iteration (`is_solve_qp`, `is_apply_cbf_action`;
cpm_mixed, N=4, B=4, T=8) in the port against the JAX package's, from the
same weights, state and draws, held as `test_torch_slice.py` holds the
one-step slice:

- every rollout step's solution within a relative 1e-3 of a converged
  (30-iteration) solve's objective on that step's constraint set;
- the last step's JAX solution by the same objective; where JAX's budget
  converged (every env here) the final state and the applied actions to
  atol 2e-3 (converged float32 solutions part in near-flat directions:
  a steering-rate difference of 1e-2 moves the steering target by 1e-3),
  the solution itself to 1e-1, observations to 2e-2, flags and integer
  fields exactly;
- the episode reward to atol 2e-3 (as the slice test holds rewards), the
  losses to a relative 1e-3 (they follow the rewards and actions, which
  part at that level), `n_done` exactly."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import sigmarl_tpu.config as jcfg
import sigmarl_tpu.rl as jrl
import sigmarl_tpu_torch.config as tcfg
from sigmarl_tpu.env.env import RoadTrafficEnv as JEnv
from sigmarl_tpu.rl.mappo_cavs import TrainState as JTrainState
from sigmarl_tpu_torch.env.env import RoadTrafficEnv as TEnv
from sigmarl_tpu_torch.ops.qp import newton_solve_reference
from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs, TrainState
from sigmarl_tpu_torch.rl.networks import critic_from_jax_params, policy_from_jax_params
from sigmarl_tpu_torch.safety.qp import kernel_inputs, solve_structured_qp
from tests.test_torch_training import BASE, iteration_draws
from tests.torch_parity import envs, to_numpy, to_torch_state

torch.set_num_threads(1)
# The module, not the function that `sigmarl_tpu_torch.rl` exports under its name.
tmappo = importlib.import_module("sigmarl_tpu_torch.rl.mappo_cavs")

FILTERED = dict(is_using_cbf_training=True, is_solve_qp=True, is_apply_cbf_action=True)


def test_cbf_filtered_training_iteration_matches_jax(tmp_path, monkeypatch):
    kw = {**BASE, **FILTERED, "where_to_save": str(tmp_path) + "/"}
    jenv, tenv = envs(**kw)
    jenv = JEnv(dataclasses.replace(jenv.cfg, is_using_cbf=True), jenv.tables)
    tenv = TEnv(dataclasses.replace(tenv.cfg, is_using_cbf=True), tenv.tables, tenv.device)
    B, N = BASE["num_vmas_envs"], BASE["n_agents"]
    env_state, obs = jax.jit(jenv.reset)(jax.random.PRNGKey(3))
    jtr = jrl.MAPPOCAVs(jcfg.Parameters(**kw), env=jenv)
    ttr = MAPPOCAVs(tcfg.Parameters(**kw), env=tenv)
    key = jax.random.PRNGKey(11)
    jnew, jm = jtr._train_iteration(JTrainState(
        policy_params=jtr.policy_params, critic_params=jtr.critic_params,
        opt_state=jtr.opt_state, env_state=env_state, obs=obs,
        ep_reward_accum=jnp.zeros((B, N)), key=key, iteration=jnp.zeros((), jnp.int32)))

    # The port's rollout steps, recorded: (state before the step, RL action,
    # state after it).
    steps, real_step = [], tmappo.cbf_filtered_step

    def recording_step(env, cbf, state, action, **k):
        out = real_step(env, cbf, state, action, **k)
        steps.append((state, action, out[0]))
        return out

    monkeypatch.setattr(tmappo, "cbf_filtered_step", recording_step)
    np_tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    policy = policy_from_jax_params(np_tree(jtr.policy_params), device="cpu")
    critic = critic_from_jax_params(np_tree(jtr.critic_params), N, device="cpu")
    tnew, tm = ttr.train_iteration(TrainState(
        policy=policy, critic=critic,
        opt_state=ttr.optimizer.init(list(policy.parameters()) + list(critic.parameters())),
        env_state=to_torch_state(env_state), obs=torch.from_numpy(np.array(obs)),
        ep_reward_accum=torch.zeros((B, N)), iteration=0), iteration_draws(key, ttr, jenv.cfg, True))
    assert len(steps) == BASE["max_steps"]

    cbf = ttr.cbf_filter
    c = cbf.cfg
    w_u, lo, hi = (c.w_u_acc, c.w_u_steer), (cbf.a_min, cbf.rate_min), (cbf.a_max, cbf.rate_max)
    gap = lambda a, b: (a - b) / (1.0 + np.abs(b))  # noqa: E731
    for t, (before, action, after) in enumerate(steps):
        cons, u_nom, _, _ = cbf.assemble(before, action)

        def F(u):  # objective of u on this step's constraint set
            a = kernel_inputs(cons, u_nom, lo, hi, u, c.newton_ws_cap)
            _, f = newton_solve_reference(a[0], a[1], a[3], a[3], *a[4:], w_u, lo, hi, 0)
            return f.numpy().astype(np.float64)

        _, F_opt = solve_structured_qp(cons, u_nom, w_u, lo, hi, n_iters=30, soft_iters=3,
                                       u_init=before.cbf_u_prev)
        F_opt = F_opt.numpy().astype(np.float64)
        assert gap(F(after.cbf_u_prev), F_opt).max() < 1e-3, t
    F_jax = F(torch.from_numpy(np.asarray(jnew.env_state.cbf_u_prev)))
    ok = gap(F_jax, F_opt) < 1e-3  # envs where JAX's budget converged
    assert ok.all()

    for f in dataclasses.fields(type(tnew.env_state)):
        a, b = to_numpy(getattr(tnew.env_state, f.name)), np.asarray(getattr(jnew.env_state, f.name))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=2e-3 if f.name != "cbf_u_prev" else 1e-1,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_allclose(tnew.obs.numpy(), np.asarray(jnew.obs), atol=2e-2)
    assert float(tm["n_done"]) == float(jm["n_done"])
    np.testing.assert_allclose(float(tm["episode_reward_mean"]), float(jm["episode_reward_mean"]),
                               atol=2e-3)
    for k in ("loss_objective", "loss_critic", "loss_entropy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3, err_msg=k)
