"""The filter modes the port added (grouped, decentralized, margins-only),
the agent grouping, `cbf_margin_step` and the "sparse" and "cbf" rewards
against the JAX package, on cpm_mixed with N=4, B=4 from a live state.

Tolerances: group ids exactly (ties included); constraint rows as in
`test_torch_slice.py` (lane rows come from finite differences of the
pseudo-distance field, step 0.02: atol 1e-3 and relative 1e-3; pair rows
and the nominal input atol 1e-4 and relative 1e-5; h of the lane rows
2e-5; weights and validity exactly); margin rewards to atol 1e-4 (lane
margins divided by h_nom = 0.2); rewards, state and observations of a
step to atol 2e-5 and 1e-4, as in `test_torch_env.py`."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sigmarl_tpu.env.rewards import compute_rewards as jax_rewards
from sigmarl_tpu.safety import CBFConfig as JCBFConfig
from sigmarl_tpu.safety import CBFSafetyFilter as JCBFSafetyFilter
from sigmarl_tpu.safety.grouping import group_agents_k_nearest as jax_grouping
from sigmarl_tpu.safety.wrappers import cbf_margin_step as jax_margin_step
from sigmarl_tpu_torch.env.rewards import compute_rewards as torch_rewards
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter
from sigmarl_tpu_torch.safety.grouping import group_agents_k_nearest, same_group_mask
from sigmarl_tpu_torch.safety.wrappers import cbf_margin_step
from tests.torch_parity import (
    env_variant, envs, params, step_reset_draws, to_numpy, to_torch_state,
)

torch.set_num_threads(1)
B, N = 4, 4
MARGINS = dict(rew_method="cbf", is_using_cbf_training=True, is_solve_qp=False)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def live():
    """Both envs in margins-only CBF training mode, the JAX margins-only
    step (jitted once), and a live JAX state after a reset and 3 such
    steps with random actions."""
    jenv, tenv = envs(**params("cpm_mixed", N, B, **MARGINS))
    jcbf = JCBFSafetyFilter(JCBFConfig(n_agents=N, is_solve_qp=False), jenv.cfg, jenv.tables,
                            decentralized=True)
    jstep = jax.jit(lambda s, a, k: jax_margin_step(jenv, jcbf, s, a, k))
    key = jax.random.PRNGKey(5)
    state, _ = jax.jit(jenv.reset)(key)
    for s in range(3):
        k_act, k_step = jax.random.split(jax.random.fold_in(key, s))
        state, *_ = jstep(state, actions(k_act), k_step)
    return jenv, tenv, state, jstep


def actions(key):
    return jax.random.uniform(key, (B, N, 2), minval=-0.3, maxval=0.9)


@pytest.mark.parametrize("positions", ["random", "tied"])
def test_grouping_matches_jax(positions):
    """Group ids at N=15 for capacities 2, 3 and 4 and at N=7 for 3, from
    random positions and from positions on a 3x3 grid, where many
    distances tie and the first argmax / argmin decides."""
    rng = np.random.default_rng(0)
    for n, m in ((7, 3), (15, 2), (15, 3), (15, 4)):
        if positions == "random":
            pos = rng.uniform(0, 4, size=(32, n, 2)).astype(np.float32)
        else:
            pos = rng.integers(0, 3, size=(32, n, 2)).astype(np.float32)
        want = np.asarray(jax.jit(jax_grouping, static_argnums=1)(pos, m))
        got = group_agents_k_nearest(t(pos), m)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"n={n} m={m}")
        counts = np.stack([np.bincount(g, minlength=want.max() + 1) for g in want])
        assert counts.max() <= m


def _check_rows(tcons, jcons):
    for f, atol, rtol in (
        ("A_s", 1e-3, 1e-3), ("b_s", 1e-3, 1e-3), ("h_s", 2e-5, 1e-5),
        ("A_pi", 1e-4, 1e-5), ("A_pj", 1e-4, 1e-5), ("b_p", 1e-4, 1e-5), ("h_p", 1e-4, 1e-5),
        ("ws_s", 0, 0), ("wl_s", 0, 0), ("ws_p", 0, 0), ("wl_p", 0, 0),
    ):
        np.testing.assert_allclose(
            getattr(tcons, f).numpy(), np.asarray(getattr(jcons, f)), atol=atol, rtol=rtol,
            err_msg=f)
    for f in ("valid_s", "valid_p", "pair_i", "pair_j"):
        np.testing.assert_array_equal(np.asarray(getattr(tcons, f)), np.asarray(getattr(jcons, f)))


@pytest.mark.parametrize(
    "mode, cbf_kw, filter_kw",
    [
        ("grouped", {}, dict(max_group_size=2)),
        ("decentralized", {}, dict(decentralized=True)),
        ("margins", dict(is_solve_qp=False), dict(decentralized=True)),
        ("grouped-margins", dict(is_solve_qp=False), dict(max_group_size=2)),
    ],
)
def test_assembly_modes_match_jax(live, mode, cbf_kw, filter_kw):
    """Constraint rows of each mode from the same state and actions. The
    grouped rows use the port's group ids, which equal JAX's; the state's
    cross-group pairs are checked to exist, so the split rows are exercised."""
    jenv, tenv, state, _ = live
    jcbf = JCBFSafetyFilter(JCBFConfig(n_agents=N, **cbf_kw), jenv.cfg, jenv.tables, **filter_kw)
    tcbf = CBFSafetyFilter(CBFConfig(n_agents=N, **cbf_kw), tenv.cfg, tenv.tables, device="cpu",
                           **filter_kw)
    act = actions(jax.random.PRNGKey(8))
    ts = to_torch_state(state)
    gid = None
    if tcbf.grouped:
        gid = group_agents_k_nearest(ts.pos, 2)
        np.testing.assert_array_equal(gid.numpy(), np.asarray(jax.jit(jax_grouping, static_argnums=1)(state.pos, 2)))
        same = same_group_mask(gid, tcbf._pi, tcbf._pj)
        assert bool(same.any()) and not bool(same.all())
    jcons, ju, _, jaux = jax.jit(lambda s, a, g: jcbf.assemble(s, a, None, g))(
        state, act, None if gid is None else gid.numpy())
    tcons, tu, _, taux = tcbf.assemble(ts, t(act), gid)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-4, rtol=1e-5)
    _check_rows(tcons, jcons)
    assert tcons.b_p.shape[-1] == (18 if tcbf.grouped else 9)
    np.testing.assert_allclose(taux["pair_Aj"].numpy(), np.asarray(jaux["pair_Aj"]),
                               atol=1e-4, rtol=1e-5)
    if filter_kw.get("decentralized"):
        assert not bool(tcons.A_pj.any())
    if not tcbf.cfg.is_solve_qp:
        assert not bool(tcons.h_s.any()) and not bool(tcons.h_p.any())
        jm = jax.jit(jcbf.nominal_margin_rewards)(state, act)
        tmr = tcbf.nominal_margin_rewards(ts, t(act))
        for k in jm:
            np.testing.assert_allclose(tmr[k].numpy(), np.asarray(jm[k]), atol=1e-4, err_msg=k)


def test_cbf_margin_step_matches_jax(live):
    """One margins-only step with the "cbf" reward: the margin rewards the
    filter writes into the state, the reward built from them, the next
    state and observations."""
    jenv, tenv, state, jstep = live
    tcbf = CBFSafetyFilter(CBFConfig(n_agents=N, is_solve_qp=False), tenv.cfg, tenv.tables,
                           decentralized=True, device="cpu")
    act = actions(jax.random.PRNGKey(9))
    key = jax.random.PRNGKey(10)
    js, jobs, jrew, jdone, _ = jstep(state, act, key)
    _, k_env = jax.random.split(key)
    ts, tobs, trew, tdone, _ = cbf_margin_step(
        tenv, tcbf, to_torch_state(state), t(act), reset_draws=step_reset_draws(k_env, jenv.cfg))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5)
    for f in ("rew_near_left_lane", "rew_near_right_lane", "rew_near_other_agents_cbf"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   atol=1e-4, err_msg=f)
    for f in ("pos", "rot", "speed", "vel"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   atol=2e-5, rtol=1e-5, err_msg=f)


@pytest.mark.parametrize(
    "rew_method, solve_qp",
    [("sparse", True), ("cbf", True), ("cbf", False), ("cbf_sparse", False),
     ("distance_sparse", True)],
)
def test_rewards_match_jax(live, rew_method, solve_qp):
    """`compute_rewards` of both packages on the same post-step state: the
    "cbf" method penalises the deviation of the applied from the nominal
    action when the filter solves, and otherwise averages the margin
    rewards in the state; "sparse" adds the collision penalties. The
    state's collision flags are set in some agents so that they count."""
    jenv, tenv, state, _ = live
    rng = np.random.default_rng(7)
    f32 = lambda *s: rng.uniform(-1, 1, size=s).astype(np.float32)  # noqa: E731
    state = dataclasses.replace(
        state,
        applied_action=f32(B, N, 2), nominal_action=f32(B, N, 2),
        rew_near_left_lane=-abs(f32(B, N)), rew_near_right_lane=-abs(f32(B, N)),
        rew_near_other_agents_cbf=-abs(f32(B, N)),
        coll_lanelets=rng.uniform(size=(B, N)) < 0.3,
    )
    jv, tv = env_variant(jenv, tenv, rew_method=rew_method, is_using_cbf=True,
                         is_solve_qp=solve_qp)
    prev_pos, prev_st = f32(B, N, 2) * 0.05 + np.asarray(state.pos), np.asarray(state.short_term)
    jr, jinfo = jax_rewards(jv.cfg, state, prev_pos, prev_st, jv.weighting_ref)
    tr, tinfo = torch_rewards(tv.cfg, to_torch_state(state), t(prev_pos), t(prev_st),
                              tv.weighting_ref)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-5, rtol=1e-5)
    for k in jinfo:
        np.testing.assert_allclose(to_numpy(tinfo[k]), np.asarray(jinfo[k]), atol=2e-5,
                                   rtol=1e-5, err_msg=k)
