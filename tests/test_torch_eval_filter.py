"""The filter modes of CBF evaluation in the port against the JAX package:
the CLF nominal controller's rows at N=1 and N=4, the fp16-parity lane
terms, the windowed lane stencil and one agent's solve (no pair rows).

Tolerances: the CLF rows and the nominal input to atol 1e-5 (products of
the state and the short-term path); the other rows as in
`test_torch_slice.py`; the fp16-parity chain exactly from the same
distances; the windowed lane terms to the stencil's tolerances (margins
2e-5, gradients 1e-3, Hessians 5e-2: distance rounding divided by 0.02
and 4e-4)."""

import functools

import jax
import numpy as np
import pytest
import torch

import sigmarl_tpu.safety.pseudo_distance as jax_pd
import sigmarl_tpu_torch.safety.cbf_qp as torch_cbf_module
from sigmarl_tpu.safety import CBFConfig as JCBFConfig
from sigmarl_tpu.safety import CBFSafetyFilter as JCBFSafetyFilter
from sigmarl_tpu.safety.circles import circle_centers_world as jax_centers
from sigmarl_tpu.safety.wrappers import cbf_filtered_step as jax_filtered_step
from sigmarl_tpu_torch.env.structs import replace_state
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter
from sigmarl_tpu_torch.safety.qp import solve_structured_qp
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step
from tests.torch_parity import envs, params, step_reset_draws, to_torch_state

torch.set_num_threads(1)
B = 4
CLF = dict(nom_controller_type="clf")


@functools.lru_cache(maxsize=None)
def _live(N):
    """Both testing-mode envs on cpm_mixed, both CLF filters, the JAX
    CLF-filtered step (jitted once per N) and a JAX state after a reset and
    3 such steps with random actions."""
    jenv, tenv = envs(**params("cpm_mixed", N, B, is_testing_mode=True))
    jcbf, tcbf = _filters(jenv, tenv, N, **CLF)
    jstep = jax.jit(lambda s, a, k: jax_filtered_step(jenv, jcbf, s, a, k))
    key = jax.random.PRNGKey(N)
    state, _ = jax.jit(jenv.reset)(key)
    for t in range(3):
        k_act, k_step = jax.random.split(jax.random.fold_in(key, t))
        state, *_ = jstep(state, _actions(k_act, N), k_step)
    return jenv, tenv, jcbf, tcbf, jstep, state


@functools.lru_cache(maxsize=None)
def _jax_reference(N):
    """The JAX filter's assembly (without the static pair lists) and
    `filter_actions` of `_live(N)`, each jitted once per N and shared by
    the tests below (op by op, JAX compiles every operation apart)."""
    jcbf = _live(N)[2]

    def assemble(state, act):
        cons, u_nom, rl, _ = jcbf.assemble(state, act)
        return cons._replace(pair_i=None, pair_j=None), u_nom, rl

    def filter_actions(state, act, key, u_init):
        return jcbf.filter_actions(state, act, key, u_init=u_init)

    return jax.jit(assemble), jax.jit(filter_actions)


def _filters(jenv, tenv, N, **cbf_kw):
    return (JCBFSafetyFilter(JCBFConfig(n_agents=N, **cbf_kw), jenv.cfg, jenv.tables),
            CBFSafetyFilter(CBFConfig(n_agents=N, **cbf_kw), tenv.cfg, tenv.tables, device="cpu"))


def _actions(key, N):
    return jax.random.uniform(key, (B, N, 2), minval=-0.3, maxval=0.9)


@pytest.mark.parametrize("N", [1, 4])
def test_clf_assembly_matches_jax(N):
    """The CLF nominal input and rows from the same state: the two CLF rows
    of every agent valid with slack weight w_clf_relax, A = [[0, e_head],
    [e_speed, 0]] and b = -lam_clf / 2 e^2."""
    _, _, jcbf, tcbf, _, state = _live(N)
    act = _actions(jax.random.PRNGKey(5), N)
    jcons, ju, jrl = _jax_reference(N)[0](state, act)
    tcons, tu, trl, _ = tcbf.assemble(to_torch_state(state), torch.from_numpy(np.asarray(act)))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-5)
    np.testing.assert_allclose(trl.numpy(), np.asarray(jrl), atol=1e-5)
    clf = slice(-2, None)
    for f in ("A_s", "b_s", "h_s"):
        np.testing.assert_allclose(getattr(tcons, f)[:, :, clf].numpy(),
                                   np.asarray(getattr(jcons, f))[:, :, clf], atol=1e-5, err_msg=f)
    assert bool(tcons.valid_s[:, :, clf].all())
    assert (tcons.ws_s[:, :, clf] == 1.0).all()
    for f, atol, rtol in (("A_s", 1e-3, 1e-3), ("b_s", 1e-3, 1e-3), ("h_s", 2e-5, 1e-5),
                          ("A_pi", 1e-4, 1e-5), ("A_pj", 1e-4, 1e-5), ("b_p", 1e-4, 1e-5),
                          ("ws_s", 0, 0), ("wl_s", 0, 0), ("ws_p", 0, 0), ("wl_p", 0, 0)):
        np.testing.assert_allclose(getattr(tcons, f).numpy(), np.asarray(getattr(jcons, f)),
                                   atol=atol, rtol=rtol, err_msg=f)
    for f in ("valid_s", "valid_p"):
        np.testing.assert_array_equal(getattr(tcons, f).numpy(), np.asarray(getattr(jcons, f)))
    assert tcons.A_pi.shape[1] == N * (N - 1) // 2


@pytest.mark.parametrize("N", [1, 4])
def test_clf_filtered_step_matches_jax(N):
    """One CLF-filtered testing-mode step with the same draws: the filter's
    solution by its objective (within a relative 1e-3 of JAX's on the
    port's constraint set, JAX's XLA solve on one agent included), the
    step's done flags exactly, and in every env the port's env step from
    JAX's filtered actions: rewards to atol 2e-5, positions to 2e-5, done
    flags equal."""
    jenv, tenv, jcbf, tcbf, jstep, state = _live(N)
    key = jax.random.PRNGKey(31)
    act = _actions(jax.random.PRNGKey(6), N)
    js, _, jrew, jdone, jinfo = jstep(state, act, key)
    _, k_env = jax.random.split(key)
    ts0 = to_torch_state(state)
    ts, _, trew, tdone, tinfo = cbf_filtered_step(
        tenv, tcbf, ts0, torch.from_numpy(np.asarray(act)),
        reset_draws=step_reset_draws(k_env, jenv.cfg))
    assert bool(tinfo["cbf_solved"].all())
    cfg = tcbf.cfg
    cons, u_nom, _, _ = tcbf.assemble(ts0, torch.from_numpy(np.asarray(act)))
    w_u, lo, hi = (cfg.w_u_acc, cfg.w_u_steer), (tcbf.a_min, tcbf.rate_min), (tcbf.a_max, tcbf.rate_max)

    def F(u):
        return solve_structured_qp(cons, u_nom, w_u, lo, hi, n_iters=0, u_init=u)[1].double()

    F_port, F_jax = F(ts.cbf_u_prev), F(torch.from_numpy(np.asarray(js.cbf_u_prev)))
    assert float(((F_port - F_jax) / (1 + F_jax.abs())).max()) < 1e-3
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(tinfo["cbf_infeasible"].numpy(),
                                  np.asarray(jinfo["cbf_infeasible"]))
    # The env step from JAX's filter output, so that every env's reward is
    # held to JAX's, also where the two solves part within their tolerance.
    k_cbf, _ = jax.random.split(key)
    jf = _jax_reference(N)[1](state, act, k_cbf, state.cbf_u_prev)
    applied = torch.from_numpy(np.array(jf.safe_actions))
    ts_in = replace_state(ts0, nominal_action=torch.from_numpy(np.array(jf.nominal_actions)),
                          applied_action=applied, cbf_u_prev=torch.from_numpy(np.array(jf.u_star)))
    ts2, _, trew2, tdone2, _ = tenv.step(ts_in, applied,
                                         reset_draws=step_reset_draws(k_env, jenv.cfg))
    np.testing.assert_allclose(trew2.numpy(), np.asarray(jrew), atol=2e-5)
    np.testing.assert_allclose(ts2.pos.numpy(), np.asarray(js.pos), atol=2e-5)
    np.testing.assert_array_equal(tdone2.numpy(), np.asarray(jdone))


def _lane_terms_both(jcbf, tcbf, state):
    """Both filters' lane terms at the same circle centers (JAX's)."""
    ts = to_torch_state(state)
    jc = jax_centers(jcbf.approx, state.pos, state.rot)
    tc = torch.from_numpy(np.array(jc))
    jl, jr = jcbf._lane_terms(jc, state.path_id, state.idx_left, state.idx_right)
    tl, tr = tcbf._lane_terms(tc, ts.path_id, ts.idx_left, ts.idx_right)
    return (jl, jr), (tl, tr), tc


def test_fp16_parity_chain_is_exact(monkeypatch):
    """The float16 finite-difference chain from the same float32 distances
    (the JAX package's own, fed to both filters): margins, gradients and
    Hessians equal bit for bit, the divisors rounded to float16 as JAX
    rounds the Python constants."""
    jenv, tenv, _, _, _, state = _live(4)
    jcbf, tcbf = _filters(jenv, tenv, 4, fp16_parity=True, pd_topk_chunks=0)
    seen = {}
    plain = jax_pd.pseudo_distance_seg

    def recording(q, rows):
        d = plain(q, rows)
        seen.setdefault("d", []).append(np.asarray(d))
        return d

    monkeypatch.setattr(jax_pd, "pseudo_distance_seg", recording)
    feed = iter(())

    def replay(q, pid, lseg, rseg, cl, cr):
        return next(feed)

    (jl, jr), _, _ = _lane_terms_both(jcbf, tcbf, state)
    R = seen["d"][0].shape[0] * seen["d"][0].shape[1]
    feed = iter([tuple(torch.from_numpy(d.reshape(R, -1).copy()) for d in seen["d"][:2])])
    monkeypatch.setattr(torch_cbf_module, "pseudo_distance_stencil", replay)
    _, (tl, tr), _ = _lane_terms_both(jcbf, tcbf, state)
    for j, t in ((jl, tl), (jr, tr)):
        for a, b in zip(t, j):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fp16_parity_lane_terms_match_jax():
    """The whole fp16-parity lane stencil (distances from each package's
    own sweep): margins to 2e-5; gradients and Hessians agree wherever the
    float16 distances do, which is all but a few rounding-boundary cases."""
    jenv, tenv, _, _, _, state = _live(4)
    jcbf, tcbf = _filters(jenv, tenv, 4, fp16_parity=True)
    (jl, jr), (tl, tr), _ = _lane_terms_both(jcbf, tcbf, state)
    for j, t in ((jl, tl), (jr, tr)):
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=2e-5)
        for a, b in zip(t[1:], j[1:]):
            same = np.isclose(a.numpy(), np.asarray(b), atol=1e-6)
            assert same.mean() > 0.95


def test_windowed_lane_terms_match_jax():
    """pd_topk_chunks=0 with the windowed flag: the port sweeps the chunks
    covering each row's window in K2, JAX its window's segments; the two
    agree (the chunks hold the window, and the JAX package pins the
    windowed minimum equal to the full scan's)."""
    jenv, tenv, _, _, _, state = _live(4)
    jcbf, tcbf = _filters(jenv, tenv, 4, use_windowed_pseudo_distance=True, pd_topk_chunks=0)
    (jl, jr), (tl, tr), tc = _lane_terms_both(jcbf, tcbf, state)
    for j, t in ((jl, tl), (jr, tr)):
        for a, b, atol in zip(t, j, (2e-5, 1e-3, 5e-2)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)
    ts = to_torch_state(state)
    q, _, cl, cr = tcbf.stencil_inputs(tc, ts.path_id, ts.idx_left, ts.idx_right)
    assert cl.shape == (q.shape[0], 6) and cr.shape == cl.shape


def test_default_topk_ignores_the_windowed_flag():
    """As in the JAX package, the windowed flag does nothing while
    pd_topk_chunks > 0: the top-k stencil inputs are unchanged."""
    _, tenv = envs(**params("cpm_mixed", 4, B))
    g = torch.Generator().manual_seed(0)
    state, _ = tenv.reset(generator=g)
    c = torch.rand((B, 4, 3, 2), generator=g) * 4
    a = CBFSafetyFilter(CBFConfig(n_agents=4), tenv.cfg, tenv.tables, device="cpu")
    b = CBFSafetyFilter(CBFConfig(n_agents=4, use_windowed_pseudo_distance=True), tenv.cfg,
                        tenv.tables, device="cpu")
    for x, y in zip(a.stencil_inputs(c, state.path_id, state.idx_left, state.idx_right),
                    b.stencil_inputs(c, state.path_id, state.idx_left, state.idx_right)):
        assert torch.equal(x, y)
