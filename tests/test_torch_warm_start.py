"""The warm-start certificate of the port (`sigmarl_tpu_torch/
check_warm_start.py`) against the JAX package's (`scripts/
check_warm_start_tpu.py`, `tests/test_warm_start.py`): the stress rollout
from the same states with the same draws, the objective evaluation both
certificates rest on, and the program's result line."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigmarl_tpu.config as jcfg
from sigmarl_tpu.env import make_env as jax_make_env
from sigmarl_tpu.safety import CBFConfig as JCBFConfig
from sigmarl_tpu.safety import CBFSafetyFilter as JCBFSafetyFilter
from sigmarl_tpu.safety import qp as jqp
from sigmarl_tpu.safety.wrappers import cbf_filtered_step as jax_filtered_step
from sigmarl_tpu_torch import check_warm_start as cws
from sigmarl_tpu_torch.safety import qp as tqp
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step
from tests.torch_parity import step_reset_draws, to_numpy, to_torch_state

torch.set_num_threads(1)
# The fixture of tests/test_warm_start.py and the program's defaults.
B, N, WARM_ITERS, STEPS = 4, 4, 6, 10
# JAX's bounds on the CPU (`tests/test_warm_start.py`): the gap, and the
# control difference in near-flat directions.
GAP_LIMIT, U_DEV_CPU = 1e-3, 8e-2
INT_FIELDS = ("path_id", "point_id", "step", "coll_agents", "coll_lanelets")


@pytest.fixture(scope="module")
def fixture():
    """JAX's env and warm filter, the port's stress setup on the CPU, and
    JAX's reset state of the fixture."""
    p = jcfg.Parameters(
        scenario_type="cpm_entire", n_agents=N, num_vmas_envs=B, dt=0.1,
        max_steps=1000, is_obs_noise=False,
        is_using_cbf_testing=True, is_using_centralized_cbf=True,
    )
    jenv = jax_make_env(p)
    jwarm = JCBFSafetyFilter(JCBFConfig(n_agents=N, dt=0.1, newton_iters=WARM_ITERS,
                                        newton_soft_iters=0), jenv.cfg, jenv.tables)
    env, warm, cold, _, act, _ = cws.stress_setup(B, N, WARM_ITERS, 0, 10.0, 30, device="cpu")
    jstate, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    return jenv, jwarm, env, warm, cold, act, jstate


def test_stress_rollout_matches_jax_and_certifies(fixture):
    """10 steps of JAX's stress rollout from its reset state with its reset
    draws of every step; the port steps from each of JAX's states.

    At every state the port's warm solve is within a relative 1e-3 of its
    cold oracle in objective, with controls within JAX's CPU bound of
    8e-2. The port's step gives JAX's next state: positions, headings and
    speeds within 1e-4, integer fields equal, and a solution no worse in
    objective (on the port's constraint set) than JAX's by a relative
    1e-6. The steering is held to dt x 8e-2: on this fixture JAX's
    6-iteration solve stops up to 1.8e-4 above the optimum in the flat
    steering direction (steering rates up to 2.7e-2 from the port's, which
    reaches the optimum of a 3+60 solve to 2e-9), so the two solutions
    part there by what JAX's own bound allows between solves."""
    jenv, jwarm, env, warm, cold, act, jstate = fixture
    jact = jnp.asarray(act.numpy())
    jstep = jax.jit(lambda s, k: jax_filtered_step(jenv, jwarm, s, jact, k))
    w_u = (warm.cfg.w_u_acc, warm.cfg.w_u_steer)
    lo, hi = (warm.a_min, warm.rate_min), (warm.a_max, warm.rate_max)
    for i in range(STEPS):
        ts = to_torch_state(jstate)
        gap, err = cws.objective_gap(warm, cold, ts, act)
        assert float(gap.max()) < GAP_LIMIT, (i, gap)
        assert float(err) < U_DEV_CPU, (i, float(err))
        key = jax.random.PRNGKey(i)
        jstate = jstep(jstate, key)[0]
        _, k_env = jax.random.split(key)
        tn = cbf_filtered_step(env, warm, ts, act,
                               reset_draws=step_reset_draws(k_env, jenv.cfg))[0]
        ju = torch.from_numpy(np.array(jstate.cbf_u_prev))
        assert float((tn.cbf_u_prev - ju).abs().max()) < U_DEV_CPU
        cons, u_nom, _, _ = warm.assemble(ts, act)
        F_port, F_jax = (tqp.solve_structured_qp(cons, u_nom, w_u, lo, hi, n_iters=0,
                                                 u_init=u)[1].double()
                         for u in (tn.cbf_u_prev, ju))
        assert float(((F_port - F_jax) / (1.0 + F_jax.abs())).max()) < 1e-6, i
        for f, atol in (("pos", 1e-4), ("rot", 1e-4), ("speed", 1e-4),
                        ("steering", warm.cfg.dt * U_DEV_CPU)):
            np.testing.assert_allclose(to_numpy(getattr(tn, f)), np.asarray(getattr(jstate, f)),
                                       atol=atol, rtol=1e-5, err_msg=f"step {i}: {f}")
        for f in INT_FIELDS:
            np.testing.assert_array_equal(to_numpy(getattr(tn, f)),
                                          np.asarray(getattr(jstate, f)), err_msg=f)


def _port_cons(cons, dtype):
    kw = {}
    for f in jqp.StructuredConstraintSet._fields:
        v = getattr(cons, f)
        if f in ("pair_i", "pair_j"):
            kw[f] = np.asarray(v)
        else:
            t = torch.from_numpy(np.array(v))
            kw[f] = t.to(dtype) if t.is_floating_point() else t
    return tqp.StructuredConstraintSet(**kw)


@pytest.mark.parametrize("dtype, rtol", [(torch.float32, 1e-6), (torch.float64, 1e-9)])
def test_objective_at_no_iteration_matches_jax(fixture, dtype, rtol):
    """The evaluation both certificates make, `solve_structured_qp` with
    n_iters=0 (F of the better of clip(u_nom) and clip(u)), on JAX's
    constraint set at the fixture's reset state: the port's F equals
    JAX's to a relative 1e-6 in float32 and 1e-9 in float64, at JAX's
    warm solution and at controls perturbed from it (some of which lose
    to the nominal start)."""
    jenv, jwarm, _, warm, _, act, jstate = fixture
    jact = jnp.asarray(act.numpy())
    cons, u_nom, _, _ = jwarm.assemble(jstate, jact)
    u_star = np.asarray(jwarm.filter_actions(jstate, jact, u_init=jstate.cbf_u_prev).u_star)
    rng = np.random.default_rng(0)
    candidates = [u_star, u_star + rng.normal(0, 0.3, u_star.shape),
                  u_star + rng.normal(0, 3.0, u_star.shape)]
    w_u = (warm.cfg.w_u_acc, warm.cfg.w_u_steer)
    lo, hi = (warm.a_min, warm.rate_min), (warm.a_max, warm.rate_max)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        jcons = jqp.StructuredConstraintSet(**{
            f: (np.asarray(getattr(cons, f)) if f in ("pair_i", "pair_j")
                else jnp.asarray(np.asarray(getattr(cons, f)),
                                 dtype=jdt if np.asarray(getattr(cons, f)).dtype == np.float32
                                 else np.asarray(getattr(cons, f)).dtype))
            for f in jqp.StructuredConstraintSet._fields
        })
        a = lambda x: jnp.asarray(np.asarray(x), jdt)  # noqa: E731
        for u in candidates:
            _, jF = jqp.solve_structured_qp(jcons, a(u_nom), a(w_u), a(lo), a(hi), n_iters=0,
                                            u_init=a(u))
            _, tF = tqp.solve_structured_qp(
                _port_cons(cons, dtype), torch.from_numpy(np.array(u_nom)).to(dtype), w_u,
                lo, hi, n_iters=0, u_init=torch.from_numpy(np.array(u)).to(dtype))
            jF = np.asarray(jF, np.float64)
            rel = np.abs(tF.double().numpy() - jF) / (1.0 + np.abs(jF))
            assert rel.max() < rtol, rel


def test_program_at_the_fixture_prints_jax_keys(capsys):
    """`python -m sigmarl_tpu_torch.check_warm_start --device cpu` at its
    default fixture: one JSON line with JAX's keys, ok, exit code 0."""
    rc = cws.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_keys = {"check", "backend", "batch", "n_agents", "newton_iters", "soft_iters",
                "soft_cap", "cold_iters", "steps", "max_objective_gap", "gap_quantiles",
                "n_instances", "max_u_dev", "ok"}
    assert jax_keys <= set(line)
    assert set(line["gap_quantiles"]) == {"p50", "p99", "p999", "frac_above_1e3"}
    assert line["check"] == "warm_start_certificate" and line["backend"] == "cpu"
    assert line["n_instances"] == B * STEPS and line["ok"] and rc == 0
    assert line["max_objective_gap"] < GAP_LIMIT and line["max_u_dev"] < 2e-2


def test_stress_rollout_draws_only_from_a_host_generator(monkeypatch):
    """The stress rollout's random numbers come from one CPU generator
    seeded 0, so a card certifies the CPU's instances: `stress_setup`'s
    reset state is `env.reset` on the draws of `torch.Generator()` seeded
    0, field for field; along the rollout every uniform is drawn from the
    returned generator (on the host), none from a device's default
    generator (whose state stays as it was), and the resets do draw."""
    from sigmarl_tpu_torch.env.reset import ResetDraws

    env, warm, cold, state, act, gen = cws.stress_setup(B, N, WARM_ITERS, 0, 10.0, 30,
                                                        device="cpu")
    ref, _ = env.reset(draws=ResetDraws.sample(env.cfg, torch.Generator().manual_seed(0), "cpu"))
    for f in dataclasses.fields(state):
        assert torch.equal(getattr(state, f.name), getattr(ref, f.name)), f.name
    assert gen.device.type == "cpu"

    used, rand = [], torch.rand

    def recording_rand(*args, generator=None, **kw):
        used.append(generator)
        return rand(*args, generator=generator, **kw)

    monkeypatch.setattr(torch, "rand", recording_rand)
    default, before = torch.get_rng_state(), gen.get_state()
    cws.run(env, warm, cold, state, act, gen, STEPS)
    assert env.reset_steps > 0 and used
    assert all(g is gen for g in used)
    assert torch.equal(torch.get_rng_state(), default)
    assert not torch.equal(gen.get_state(), before)
