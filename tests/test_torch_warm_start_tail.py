"""The tail of the warm-start certificate at a middle size is the
algorithm's, not the port's: on the JAX package's own stress-rollout
state (cpm_entire, N=15, B=64, the production 3+5 solve against the cold
2+30 oracle, as `scripts/check_warm_start_tpu.py --batch 64 --n_agents 15
--warm-iters 5 --soft-iters 3` computes it), the instances where the
port's warm solve ends above 1e-3 of the oracle are instances where
JAX's does too, by the same gap, and the float64 dense oracle confirms
that the cold oracle is the optimum there."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import sigmarl_tpu.config as jcfg
from sigmarl_tpu.env import make_env as jax_make_env
from sigmarl_tpu.safety import CBFConfig as JCBFConfig
from sigmarl_tpu.safety import CBFSafetyFilter as JCBFSafetyFilter
from sigmarl_tpu.safety.qp import solve_structured_qp as jax_solve
from sigmarl_tpu.safety.wrappers import cbf_filtered_step as jax_filtered_step
from sigmarl_tpu_torch import check_warm_start as cws
from sigmarl_tpu_torch.utils.certificate_tail import explain_step
from tests.torch_parity import to_torch_state

torch.set_num_threads(1)
B, N, WARM, SOFT, COLD = 64, 15, 5, 3, 30
# The stress rollout's step whose state the test certifies (3 JAX steps
# from JAX's reset with keys 0, 1, 2).
STEP = 3


def test_port_tail_is_jax_tail_on_jax_states():
    p = jcfg.Parameters(
        scenario_type="cpm_entire", n_agents=N, num_vmas_envs=B, dt=0.1,
        max_steps=1000, is_obs_noise=False,
        is_using_cbf_testing=True, is_using_centralized_cbf=True,
    )
    jenv = jax_make_env(p)
    jwarm = JCBFSafetyFilter(JCBFConfig(n_agents=N, dt=0.1, newton_iters=WARM,
                                        newton_soft_iters=SOFT), jenv.cfg, jenv.tables)
    jcold = JCBFSafetyFilter(JCBFConfig(n_agents=N, dt=0.1, newton_iters=COLD,
                                        newton_soft_iters=2, newton_soft_cap=10.0),
                             jenv.cfg, jenv.tables)
    _, warm, cold, _, act, _ = cws.stress_setup(B, N, WARM, SOFT, 10.0, COLD, device="cpu")
    jact = jnp.asarray(act.numpy())
    w_u = jnp.asarray([jwarm.cfg.w_u_acc, jwarm.cfg.w_u_steer])
    lo, hi = jnp.asarray([jwarm.a_min, jwarm.rate_min]), jnp.asarray([jwarm.a_max, jwarm.rate_max])

    def jax_solve_as_filter(cons, u_nom, cfg, u_init=None):
        """`filter_actions`'s solve on the CPU (its XLA branch): u* at the
        filter's budget, u_nom where the solve is not finite."""
        u, F = jax_solve(cons, u_nom, w_u, lo, hi, n_iters=cfg.newton_iters, u_init=u_init,
                         soft_iters=cfg.newton_soft_iters, soft_cap=cfg.newton_soft_cap)
        solved = jnp.isfinite(F) & jnp.isfinite(u).all((-1, -2))
        return jnp.where(solved[:, None, None], u, u_nom)

    @jax.jit
    def jax_gap_and_step(state, key):
        """`gap_all` of scripts/check_warm_start_tpu.py at `state`, and the
        stress rollout's next state, in one program (JAX compiles it once).
        Both filters assemble the same rows (they differ in their solve
        budgets only), so the rows are assembled once."""
        cons, u_nom, _, _ = jwarm.assemble(state, jact)
        u_c = jax_solve_as_filter(cons, u_nom, jcold.cfg)
        u_w = jax_solve_as_filter(cons, u_nom, jwarm.cfg, state.cbf_u_prev)
        F_w = jax_solve(cons, u_nom, w_u, lo, hi, n_iters=0, u_init=u_w)[1]
        F_c = jax_solve(cons, u_nom, w_u, lo, hi, n_iters=0, u_init=u_c)[1]
        return (F_w - F_c) / (1.0 + jnp.abs(F_c)), jax_filtered_step(jenv, jwarm, state, jact,
                                                                     key)[0]

    state, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    for i in range(STEP + 1):
        g_jax, next_state = jax_gap_and_step(state, jax.random.PRNGKey(i))
        if i < STEP:
            state = next_state
    g_jax = np.asarray(g_jax, np.float64)
    ts = to_torch_state(state)
    gap, rows = explain_step(warm, cold, ts, act)
    g_port = gap.double().numpy()

    port_tail = set(np.nonzero(g_port > cws.GAP_LIMIT)[0].tolist())
    jax_tail = set(np.nonzero(g_jax > cws.GAP_LIMIT)[0].tolist())
    assert port_tail and port_tail <= jax_tail, (port_tail, jax_tail)
    for e in port_tail:
        assert abs(g_port[e] - g_jax[e]) <= 1e-3 * (1.0 + g_jax[e]), (e, g_port[e], g_jax[e])
    # The oracle is the optimum on these instances: the float64 dense
    # solve ends within 1e-3 of it, the warm solve far above.
    assert {r["env"] for r in rows} == port_tail
    for r in rows:
        assert r["gap_dense64"] < cws.GAP_LIMIT and r["gap"] > cws.GAP_LIMIT, r
