"""K1, the whole QP solve: the port's plain version vs the JAX solvers
(`solve_structured_qp` through XLA and the Pallas kernel in interpret
mode).

Tolerances. Controls after 0 iterations (the start choice) to atol 2e-5.
After 1 iteration the float32 controls of these stiff instances (slack
stiffness up to 3e6 against a steering weight of 2) are ill-conditioned:
JAX's own XLA solver gives controls 1.6e-2 apart on this fixture when run
under `jax.jit` and under `jax.disable_jit`. So the 1-iteration step is held
in float64, where the port and JAX agree to 1e-9, to atol 2e-5, and in
float32 by its objective to a relative 1e-3. Converged objectives (30
iterations) to a relative 1e-4; the production 3+5 budget, whose float32
trajectories legitimately part in near-flat directions, to 1e-3
(tests/test_qp_creep.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigmarl_tpu.safety import CBFConfig as JCBFConfig
from sigmarl_tpu.safety import CBFSafetyFilter as JCBFSafetyFilter
from sigmarl_tpu.safety import qp as jqp
from sigmarl_tpu_torch.ops import launch_counts
from sigmarl_tpu_torch.ops.qp import newton_solve, newton_solve_reference
from sigmarl_tpu_torch.safety import qp as tqp
from tests.torch_parity import envs, params

torch.set_num_threads(1)

W_U, LO, HI = (100.0, 1.0), (-5.0, -np.pi / 2), (5.0, np.pi / 2)
FIX = os.path.join(os.path.dirname(__file__), "golden", "qp_creep_n15.npz")


def to_port(cons, dtype=torch.float32) -> tqp.StructuredConstraintSet:
    kw = {}
    for f in jqp.StructuredConstraintSet._fields:
        v = getattr(cons, f)
        if f in ("pair_i", "pair_j"):
            kw[f] = np.asarray(v)
        else:
            t = torch.from_numpy(np.array(v))
            kw[f] = t.to(dtype) if t.is_floating_point() else t
    return tqp.StructuredConstraintSet(**kw)


def rel_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / (1.0 + np.abs(b))


@pytest.fixture(scope="module")
def mixed():
    """`cbf.assemble` output on cpm_mixed, N=4, B=8 (as in
    tests/test_pallas_kernels.py)."""
    B, N = 8, 4
    jenv, _ = envs(**params("cpm_mixed", N, B))
    cbf = JCBFSafetyFilter(JCBFConfig(n_agents=N, dt=0.1), jenv.cfg, jenv.tables)
    state, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    act = jax.random.uniform(jax.random.PRNGKey(5), (B, N, 2), minval=-0.3, maxval=0.9)
    cons, u_nom, _, _ = cbf.assemble(state, act)
    return cons, u_nom


@pytest.fixture(scope="module")
def jax_refs(mixed):
    """Every JAX solve of `mixed` that the tests below compare with,
    computed once for the module, each budget jitted (op by op, JAX
    compiles every operation apart): XLA at 0, 1 and 30 iterations, the
    Pallas kernel in interpret mode at the same, the 3+5 ladder from a
    perturbed warm start, and 3+30 at ws_cap 1e5. Returns {name: (u, F)}
    and the warm start."""
    cons, u_nom = mixed
    arrays = {f: getattr(cons, f) for f in jqp.StructuredConstraintSet._fields
              if f not in ("pair_i", "pair_j")}
    u_init = np.array(u_nom) + np.random.default_rng(0).normal(0, 0.5, u_nom.shape)
    u_init = u_init.astype(np.float32)
    bounds = (jnp.asarray(W_U), jnp.asarray(LO), jnp.asarray(HI))
    runs = {
        **{f"xla{it}": (jqp.solve_structured_qp, dict(n_iters=it)) for it in (0, 1, 30)},
        **{f"pallas{it}": (jqp.solve_structured_qp_pallas, dict(n_iters=it, interpret=True))
           for it in (0, 1, 30)},
        "ladder": (jqp.solve_structured_qp, dict(n_iters=5, soft_iters=3,
                                                 u_init=jnp.asarray(u_init))),
        "ws_cap": (jqp.solve_structured_qp, dict(n_iters=30, soft_iters=3, ws_cap=1e5)),
    }
    out = {}
    for name, (solve, kw) in runs.items():
        fn = jax.jit(lambda a, u, solve=solve, kw=kw: solve(cons._replace(**a), u, *bounds, **kw))
        out[name] = tuple(np.asarray(x) for x in fn(arrays, u_nom))
    return out, u_init


def _port_solve(cons, u_nom, dtype=torch.float32, **kw):
    u, F = tqp.solve_structured_qp(
        to_port(cons, dtype), torch.from_numpy(np.array(u_nom)).to(dtype), W_U, LO, HI, **kw)
    return u.numpy(), F.numpy()


def test_plain_solver_matches_jax(mixed, jax_refs):
    cons, u_nom = mixed
    refs, _ = jax_refs
    for it in (0, 1):
        u, F = _port_solve(cons, u_nom, n_iters=it)
        ux, Fx = refs[f"xla{it}"]
        up, Fp = refs[f"pallas{it}"]
        if it == 0:
            np.testing.assert_allclose(u, np.asarray(ux), atol=2e-5, rtol=1e-5)
            np.testing.assert_allclose(u, np.asarray(up), atol=2e-5, rtol=1e-5)
        assert rel_gap(F, Fx).max() < 1e-3
        assert rel_gap(F, Fp).max() < 1e-3
    _, F = _port_solve(cons, u_nom, n_iters=30)
    _, Fx = refs["xla30"]
    _, Fp = refs["pallas30"]
    assert rel_gap(F, Fx).max() < 1e-4
    assert rel_gap(F, Fp).max() < 1e-4


def test_plain_solver_step_matches_jax_in_float64(mixed):
    """One Newton iteration is the same algorithm: in float64 the port's
    plain version and JAX's XLA solver give the same controls."""
    cons, u_nom = mixed
    with jax.enable_x64(True):
        c64 = jqp.StructuredConstraintSet(**{
            f: (np.asarray(getattr(cons, f)) if f in ("pair_i", "pair_j")
                else jnp.asarray(np.asarray(getattr(cons, f)), dtype=_f64(getattr(cons, f))))
            for f in jqp.StructuredConstraintSet._fields
        })
        f64 = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
        for it in (1, 2):
            ux, Fx = jqp.solve_structured_qp(
                c64, f64(u_nom), f64(W_U), f64(LO), f64(HI), n_iters=it)
            u, F = _port_solve(cons, u_nom, n_iters=it, dtype=torch.float64)
            np.testing.assert_allclose(u, np.asarray(ux), atol=2e-5, rtol=1e-5)
            assert rel_gap(F, Fx).max() < 1e-9


def _f64(x):
    return jnp.float64 if np.asarray(x).dtype == np.float32 else np.asarray(x).dtype


def test_plain_solver_warm_start_and_ladder_match_jax(mixed, jax_refs):
    """The warm-start choice and the stiffness ladder (3 soft + 5 stiff),
    from a perturbed warm start."""
    cons, u_nom = mixed
    refs, u_init = jax_refs
    _, F = _port_solve(cons, u_nom, n_iters=5, soft_iters=3,
                       u_init=torch.from_numpy(u_init))
    _, Fx = refs["ladder"]
    assert rel_gap(F, Fx).max() < 1e-3


def test_ws_cap_reaches_the_ladder(mixed, jax_refs):
    """At ws_cap=1e5 the port's solver passes the cap on to its ladder and
    matches JAX `solve_structured_qp` (the Pallas branch drops the cap)."""
    cons, u_nom = mixed
    _, F = _port_solve(cons, u_nom, n_iters=30, soft_iters=3, ws_cap=1e5)
    _, Fx = jax_refs[0]["ws_cap"]
    assert rel_gap(F, Fx).max() < 1e-4


def test_plain_solver_on_creep_fixture():
    """tests/golden/qp_creep_n15.npz, a real N=15 pile-up instance, at the
    production (3, 5) budget: F within 1e-3 of the JAX XLA solver (which
    tests/test_qp_creep.py holds against the Pallas kernel) and of the
    30-iteration optimum."""
    z = np.load(FIX)
    cons = jqp.StructuredConstraintSet(
        **{f: (np.asarray(z[f]) if f in ("pair_i", "pair_j") else jnp.asarray(z[f]))
           for f in jqp.StructuredConstraintSet._fields}
    )
    u_nom = jnp.asarray(z["u_nom"])
    w_u, lo, hi = (tuple(float(x) for x in z[k]) for k in ("w_u", "u_lo", "u_hi"))
    u, F = tqp.solve_structured_qp(
        to_port(cons), torch.from_numpy(np.array(u_nom)), w_u, lo, hi,
        n_iters=5, soft_iters=3,
    )
    _, Fx = jqp.solve_structured_qp(
        cons, u_nom, jnp.asarray(z["w_u"]), jnp.asarray(z["u_lo"]), jnp.asarray(z["u_hi"]),
        n_iters=5, soft_iters=3,
    )
    _, F_ref = jqp.solve_structured_qp(
        cons, u_nom, jnp.asarray(z["w_u"]), jnp.asarray(z["u_lo"]), jnp.asarray(z["u_hi"]),
        n_iters=30, soft_iters=2,
    )
    assert rel_gap(F.numpy(), Fx).max() < 1e-3
    assert (F.numpy() - np.asarray(F_ref)).max() / (1.0 + abs(float(F_ref[0]))) < 1e-3


def test_cpu_tensors_take_the_plain_version(mixed):
    cons, u_nom = mixed
    singles, pairs = tqp.pack_constraints(to_port(cons), 3e6)
    un = torch.from_numpy(np.array(u_nom))
    u0 = torch.cat([torch.clamp(un[..., 0], LO[0], HI[0]), torch.clamp(un[..., 1], LO[1], HI[1])], 1)
    unf = torch.cat([un[..., 0], un[..., 1]], 1)
    pi = torch.as_tensor(cons.pair_i, dtype=torch.int32)
    pj = torch.as_tensor(cons.pair_j, dtype=torch.int32)
    args = (singles, pairs, u0, u0, unf, pi, pj, W_U, LO, HI, 2)
    before = launch_counts()["qp_newton"]
    u, F = newton_solve(*args)
    u_ref, F_ref = newton_solve_reference(*args)
    assert launch_counts()["qp_newton"] == before
    assert torch.equal(u, u_ref) and torch.equal(F, F_ref)
