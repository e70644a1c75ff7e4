#!/usr/bin/env python3
"""Two float32 properties of the CBF-QP Newton solver, shared by the JAX
package and its PyTorch port. Runs on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/qp_conditioning_probe.py

1. Conditioning: on the N=4 cpm_mixed fixture of tests/test_pallas_kernels.py,
   the controls after one Newton iteration of JAX's XLA solver under
   `jax.jit` and under `jax.disable_jit`, and the port's plain solver
   against JAX in float64 after one iteration.
2. A non-optimal fixed point: on a B=8 cpm_entire input built by the port
   (seed 3, three filtered steps with uniform random actions, as the card
   test `test_main_path_step_at_b8_on_the_card_matches_the_cpu` builds
   it), the objective the 3+5 solve reaches per env, what 60 more stiff
   iterations reach from there in float32 and float64 (port and JAX), and
   the optimum of a plain 60-iteration solve.

Prints one JSON line at the end.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from sigmarl_tpu.config import Parameters as JParameters  # noqa: E402
from sigmarl_tpu.env import make_env as jax_make_env  # noqa: E402
from sigmarl_tpu.safety import CBFConfig as JCBFConfig  # noqa: E402
from sigmarl_tpu.safety import CBFSafetyFilter as JCBFSafetyFilter  # noqa: E402
from sigmarl_tpu.safety import qp as jqp  # noqa: E402
from sigmarl_tpu_torch import (  # noqa: E402
    CBFConfig, CBFSafetyFilter, Parameters, cbf_filtered_step, make_env,
)
from sigmarl_tpu_torch.safety import qp as tqp  # noqa: E402

W_U, LO, HI = (100.0, 1.0), (-5.0, -np.pi / 2), (5.0, np.pi / 2)
FIELDS = jqp.StructuredConstraintSet._fields


def jax_cons(arrays, dtype):
    return jqp.StructuredConstraintSet(**{
        f: (arrays[f] if f in ("pair_i", "pair_j") else
            jnp.asarray(arrays[f], dtype if arrays[f].dtype == np.float32 else arrays[f].dtype))
        for f in FIELDS})


def port_cons(arrays, dtype):
    def tensor(a):
        t = torch.from_numpy(np.array(a))
        return t.to(dtype) if t.is_floating_point() else t

    return tqp.StructuredConstraintSet(**{
        f: (arrays[f] if f in ("pair_i", "pair_j") else tensor(arrays[f])) for f in FIELDS})


def jax_solve(arrays, u_nom, dtype, **kw):
    f = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    return jqp.solve_structured_qp(jax_cons(arrays, dtype), f(u_nom), f(W_U), f(LO), f(HI), **kw)


def port_solve(arrays, u_nom, dtype, u_init=None, **kw):
    ui = None if u_init is None else torch.from_numpy(np.asarray(u_init)).to(dtype)
    u, F = tqp.solve_structured_qp(port_cons(arrays, dtype), torch.from_numpy(np.array(u_nom)).to(dtype),
                                   W_U, LO, HI, u_init=ui, **kw)
    return u.numpy(), F.numpy()


def conditioning() -> dict:
    B, N = 8, 4
    p = JParameters(scenario_type="cpm_mixed", n_agents=N, num_vmas_envs=B, dt=0.1,
                    max_steps=100, is_use_mtv_distance=False, is_obs_noise=False)
    env = jax_make_env(p)
    cbf = JCBFSafetyFilter(JCBFConfig(n_agents=N, dt=0.1), env.cfg, env.tables)
    state, _ = jax.jit(env.reset)(jax.random.PRNGKey(0))
    act = jax.random.uniform(jax.random.PRNGKey(5), (B, N, 2), minval=-0.3, maxval=0.9)
    cons, u_nom, _, _ = cbf.assemble(state, act)
    arrays = {f: np.asarray(getattr(cons, f)) for f in FIELDS}
    un = np.asarray(u_nom)
    u_jit, _ = jax_solve(arrays, un, jnp.float32, n_iters=1)
    with jax.disable_jit():
        u_eager, _ = jax_solve(arrays, un, jnp.float32, n_iters=1)
    with jax.enable_x64(True):
        u_j64, _ = jax_solve(arrays, un, jnp.float64, n_iters=1)
    u_p64, _ = port_solve(arrays, un, torch.float64, n_iters=1)
    return dict(
        jax_jit_vs_eager_1iter_max_du=float(np.abs(np.asarray(u_jit) - np.asarray(u_eager)).max()),
        port_vs_jax_float64_1iter_max_du=float(np.abs(u_p64 - np.asarray(u_j64)).max()),
    )


def fixed_point() -> dict:
    B, N = 8, 15
    p = Parameters(scenario_type="cpm_entire", n_agents=N, num_vmas_envs=B, dt=0.1,
                   max_steps=1_000_000, is_use_mtv_distance=False, is_obs_noise=False,
                   is_using_cbf_testing=True, is_using_centralized_cbf=True)
    env = make_env(p, device="cpu")
    cfg = CBFConfig(n_agents=N, n_circles=3, dt=0.1, newton_iters=5, newton_soft_iters=3)
    cbf = CBFSafetyFilter(cfg, env.cfg, env.tables, device="cpu")
    gen = torch.Generator().manual_seed(3)
    lim = env.action_limits
    state, _ = env.reset(generator=gen)
    for _ in range(3):
        act = (2 * torch.rand((B, N, 2), generator=gen) - 1) * lim
        state, *_ = cbf_filtered_step(env, cbf, state, act, generator=gen)
    act = (2 * torch.rand((B, N, 2), generator=gen) - 1) * lim
    cons, u_nom, _, _ = cbf.assemble(state, act)
    arrays = {f: (np.asarray(getattr(cons, f)) if f in ("pair_i", "pair_j")
                  else getattr(cons, f).numpy()) for f in FIELDS}
    un, u_prev = u_nom.numpy(), state.cbf_u_prev.numpy()
    u35, F35 = port_solve(arrays, un, torch.float32, u_init=u_prev, n_iters=5, soft_iters=3)
    _, F_p32 = port_solve(arrays, un, torch.float32, u_init=u35, n_iters=60)
    _, F_p64 = port_solve(arrays, un, torch.float64, u_init=u35, n_iters=60)
    _, F_opt = port_solve(arrays, un, torch.float64, n_iters=60)
    _, F_j32 = jax_solve(arrays, un, jnp.float32, n_iters=60, u_init=jnp.asarray(u35))
    with jax.enable_x64(True):
        _, F_j64 = jax_solve(arrays, un, jnp.float64, n_iters=60,
                             u_init=jnp.asarray(u35, jnp.float64))
    r = lambda x: [float(v) for v in np.asarray(x)]  # noqa: E731
    return dict(F_port32_3plus5=r(F35), F_port32_plus60=r(F_p32), F_port64_plus60=r(F_p64),
                F_jax32_plus60=r(F_j32), F_jax64_plus60=r(F_j64), F_opt_60=r(F_opt))


def main() -> int:
    out = dict(conditioning(), **fixed_point())
    for k, v in out.items():
        print(f"{k}: {v}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
