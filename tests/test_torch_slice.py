"""The slice as a whole against the JAX package on cpm_entire, N=15, B=4:
the CBF filter's constraint assembly, the policy with carried weights, and
one `cbf_filtered_step` from an identical state with identical draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigmarl_tpu.rl.networks import PolicyNet as JPolicyNet
from sigmarl_tpu.rl.networks import tanh_normal_sample as jax_sample
from sigmarl_tpu.safety import CBFConfig as JCBFConfig
from sigmarl_tpu.safety import CBFSafetyFilter as JCBFSafetyFilter
from sigmarl_tpu.safety.wrappers import cbf_filtered_step as jax_filtered_step
from sigmarl_tpu_torch.ops.qp import newton_solve_reference
from sigmarl_tpu_torch.rl.networks import policy_from_jax_params, tanh_normal_sample
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter
from sigmarl_tpu_torch.safety.qp import kernel_inputs, solve_structured_qp
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step
from tests.torch_parity import envs, params, step_reset_draws, to_torch_state

torch.set_num_threads(1)
B, N = 4, 15
BUDGET = dict(n_agents=N, n_circles=3, newton_iters=5, newton_soft_iters=3)


@pytest.fixture(scope="module")
def live():
    """A live state after 3 JAX filtered steps from a reset, the JAX step
    function, and both filters."""
    jenv, tenv = envs(**params("cpm_entire", N, B))
    jcbf = JCBFSafetyFilter(JCBFConfig(**BUDGET), jenv.cfg, jenv.tables)
    tcbf = CBFSafetyFilter(CBFConfig(**BUDGET), tenv.cfg, tenv.tables, device="cpu")
    jstep = jax.jit(lambda s, a, k: jax_filtered_step(jenv, jcbf, s, a, k))
    key = jax.random.PRNGKey(21)
    state, _ = jax.jit(jenv.reset)(key)
    for t in range(3):
        k_act, k_step = jax.random.split(jax.random.fold_in(key, t))
        state, *_ = jstep(state, actions(k_act), k_step)
    return jenv, tenv, jcbf, tcbf, jstep, state


@pytest.fixture(scope="module")
def jax_assemble(live):
    """The JAX filter's assembly (without the static pair lists), jitted
    once for the module (op by op, JAX compiles every operation apart)."""
    jcbf = live[2]

    def assemble(state, act):
        cons, u_nom, rl, _ = jcbf.assemble(state, act)
        return cons._replace(pair_i=None, pair_j=None), u_nom, rl

    return jax.jit(assemble)


def actions(key):
    return jax.random.uniform(key, (B, N, 2), minval=-0.3, maxval=0.9)


def test_assembly_matches_jax(live, jax_assemble):
    """Constraint rows from the same state and RL actions. The lane rows
    come from finite differences of the pseudo-distance field (step 0.02:
    gradients divide distance rounding by 0.02, Hessians by 4e-4), so lane
    coefficients agree to atol 1e-3 and relative 1e-3; pair rows and the
    nominal input, plain products of the state, to atol 1e-4 and relative
    1e-5; weights and validity exactly."""
    _, _, jcbf, tcbf, _, state = live
    act = actions(jax.random.PRNGKey(5))
    jcons, ju_nom, jrl = jax_assemble(state, act)
    tcons, tu_nom, trl, _ = tcbf.assemble(to_torch_state(state), torch.from_numpy(np.asarray(act)))
    np.testing.assert_allclose(tu_nom.numpy(), np.asarray(ju_nom), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(trl.numpy(), np.asarray(jrl), atol=1e-6)
    for f, atol, rtol in (
        ("A_s", 1e-3, 1e-3), ("b_s", 1e-3, 1e-3), ("h_s", 2e-5, 1e-5),
        ("A_pi", 1e-4, 1e-5), ("A_pj", 1e-4, 1e-5), ("b_p", 1e-4, 1e-5), ("h_p", 1e-4, 1e-5),
        ("ws_s", 0, 0), ("wl_s", 0, 0), ("ws_p", 0, 0), ("wl_p", 0, 0),
    ):
        np.testing.assert_allclose(
            getattr(tcons, f).numpy(), np.asarray(getattr(jcons, f)), atol=atol, rtol=rtol,
            err_msg=f)
    for f in ("valid_s", "valid_p"):
        np.testing.assert_array_equal(np.asarray(getattr(tcons, f)), np.asarray(getattr(jcons, f)))
    for f in ("pair_i", "pair_j"):  # static lists, not outputs of the jitted assembly
        np.testing.assert_array_equal(np.asarray(getattr(tcons, f)), getattr(jcbf, "_" + f))


def test_policy_with_carried_weights_matches_jax():
    """loc and scale to atol 1e-5 (float32 matmuls of width 256, summed in
    other orders); the sampled action and its log-probability from the same
    normal noise to the same tolerance."""
    obs_dim = 32
    net = JPolicyNet()
    obs = np.random.default_rng(0).normal(size=(B, N, obs_dim)).astype(np.float32)
    jparams = net.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    policy = policy_from_jax_params(params_np, device="cpu")
    jloc, jscale = net.apply(jparams, jnp.asarray(obs))
    with torch.no_grad():
        loc, scale = policy(torch.from_numpy(obs))
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), atol=1e-5)
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), atol=1e-5)

    low, high = jnp.asarray([-1.0, -0.5]), jnp.asarray([1.0, 0.5])
    key = jax.random.PRNGKey(3)
    ja, jlp = jax_sample(key, jloc, jscale, low, high)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, jloc.shape)))
    a, lp = tanh_normal_sample(loc, scale, torch.tensor([-1.0, -0.5]), torch.tensor([1.0, 0.5]),
                               noise=noise)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-4, rtol=1e-5)


def test_filtered_step_matches_jax(live):
    """One CBF-filtered step at the production 3+5 budget, warm-started from
    the state's previous solution, with the same RL actions and reset
    draws.

    The solutions are held by their objective on the port's constraint set,
    against the optimum of a 30-iteration solve: the port's is within a
    relative 1e-3 of it in every env. JAX's fixed budget leaves a known
    share of hard instances unconverged (env 0 of this fixture stops far
    above the optimum that both solvers reach at 30 iterations); in the envs
    where JAX's solve did converge, the two objectives agree to 1e-3 and
    the applied actions, next state and rewards to atol 2e-3 (converged
    float32 solutions may part in near-flat directions: a steering-rate
    difference of 1e-2 moves the steering target by 1e-3), flags exactly."""
    jenv, tenv, jcbf, tcbf, jstep, state = live
    key = jax.random.PRNGKey(99)
    act = actions(jax.random.PRNGKey(8))
    js, jobs, jrew, jdone, jinfo = jstep(state, act, key)
    _, k_env = jax.random.split(key)
    ts0 = to_torch_state(state)
    t_act = torch.from_numpy(np.asarray(act))
    ts, tobs, trew, tdone, tinfo = cbf_filtered_step(
        tenv, tcbf, ts0, t_act, reset_draws=step_reset_draws(k_env, jenv.cfg)
    )
    assert tinfo["cbf_solved"].all() and bool(np.asarray(jinfo["cbf_solved"]).all())

    cfg = tcbf.cfg
    w_u, lo, hi = (cfg.w_u_acc, cfg.w_u_steer), (tcbf.a_min, tcbf.rate_min), (tcbf.a_max, tcbf.rate_max)
    cons, u_nom, _, _ = tcbf.assemble(ts0, t_act)

    def F(u):  # objective of u on the port's constraint set
        a = kernel_inputs(cons, u_nom, lo, hi, u, cfg.newton_ws_cap)
        _, f = newton_solve_reference(a[0], a[1], a[3], a[3], *a[4:], w_u, lo, hi, 0)
        return f.numpy().astype(np.float64)

    _, F_opt = solve_structured_qp(cons, u_nom, w_u, lo, hi, n_iters=30, soft_iters=3,
                                   u_init=ts0.cbf_u_prev)
    F_opt = F_opt.numpy().astype(np.float64)
    F_port, F_jax = F(ts.cbf_u_prev), F(torch.from_numpy(np.asarray(js.cbf_u_prev)))
    gap = lambda a, b: (a - b) / (1.0 + np.abs(b))  # noqa: E731
    assert gap(F_port, F_opt).max() < 1e-3
    ok = gap(F_jax, F_opt) < 1e-3  # envs where JAX's budget converged
    assert ok.sum() >= B - 1
    assert np.abs(gap(F_port, F_jax))[ok].max() < 1e-3

    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(trew.numpy()[ok], np.asarray(jrew)[ok], atol=2e-3)
    np.testing.assert_allclose(
        ts.applied_action.numpy()[ok], np.asarray(js.applied_action)[ok], atol=2e-3)
    for f in ("pos", "rot", "speed", "steering", "vel"):
        np.testing.assert_allclose(getattr(ts, f).numpy()[ok], np.asarray(getattr(js, f))[ok],
                                   atol=2e-3, err_msg=f)
    for f in ("path_id", "point_id", "step", "coll_agents", "coll_lanelets"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tobs.numpy()[ok], np.asarray(jobs)[ok], atol=2e-2)
