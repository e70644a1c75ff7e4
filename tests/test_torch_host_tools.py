"""The port's last host-side modules against the JAX package's: the dense
QP oracle (`safety/qp.py::ConstraintSet`, `solve_boxed_penalty_qp`,
`eliminated_lambda`; `CBFSafetyFilter.to_dense`), the pseudo-distance
field (`safety/pseudo_distance.py::pseudo_distance_to_polyline`,
`safety/pseudo_distance_example.py`), lanelet IDs
(`core/geometry.py::current_lanelet_id` and its map tables), the
interactive session and the debug demo (`env/interactive.py`,
`env/debug_demo.py`) and the lab export (`export_for_lab.py`).

Tolerances: the dense solve in float64 to 1e-9 (the same algorithm, so
only rounding parts them); the dense form and lanelet IDs exactly (one-hot
copies, an argmin over the same float32 distances); the pseudo distance
and its field to 1e-5 (float32 with one sqrt); policy outputs to 1e-6.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sigmarl_tpu.config as jcfg
import sigmarl_tpu_torch.config as tcfg
from sigmarl_tpu.core import geometry as jgeom
from sigmarl_tpu.env import make_env as jax_make_env
from sigmarl_tpu.env.interactive import InteractiveSession as JSession
from sigmarl_tpu.maps.manager import load_map as jload_map
from sigmarl_tpu.rl.networks import PolicyNet as JPolicyNet
from sigmarl_tpu.safety import CBFConfig as JCBFConfig
from sigmarl_tpu.safety import CBFSafetyFilter as JCBFSafetyFilter
from sigmarl_tpu.safety import pseudo_distance as jpd
from sigmarl_tpu.safety import pseudo_distance_example as jpde
from sigmarl_tpu.safety import qp as jqp
from sigmarl_tpu_torch.core import geometry as tgeom
from sigmarl_tpu_torch.env import debug_demo
from sigmarl_tpu_torch.env.env import make_env as torch_make_env
from sigmarl_tpu_torch.env.interactive import InteractiveSession, render_interactively
from sigmarl_tpu_torch.export_for_lab import export_for_lab
from sigmarl_tpu_torch.rl import checkpoint as ckpt
from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs
from sigmarl_tpu_torch.rl.networks import policy_from_jax_params, to_jax_params
from sigmarl_tpu_torch.safety import pseudo_distance_example as tpde
from sigmarl_tpu_torch.safety import qp as tqp
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter
from sigmarl_tpu_torch.safety.pseudo_distance import pseudo_distance_to_polyline
from tests.torch_parity import to_numpy, to_torch_state

torch.set_num_threads(1)
B, N = 8, 4
W_U, LO, HI = (100.0, 1.0), (-5.0, -np.pi / 2), (5.0, np.pi / 2)


@pytest.fixture(scope="module")
def entire():
    """cpm_entire (N=4, B=8) in both packages, and JAX's constraint set of
    a filtered step from a reset, as JAX arrays and as the port's."""
    kw = dict(scenario_type="cpm_entire", n_agents=N, num_vmas_envs=B, dt=0.1,
              is_use_mtv_distance=False, is_obs_noise=False)
    jenv = jax_make_env(jcfg.Parameters(**kw))
    tenv = torch_make_env(tcfg.Parameters(**kw), device="cpu")
    jcbf = JCBFSafetyFilter(JCBFConfig(n_agents=N, dt=0.1), jenv.cfg, jenv.tables)
    tcbf = CBFSafetyFilter(CBFConfig(n_agents=N, dt=0.1), tenv.cfg, tenv.tables, device="cpu")
    state, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(3))
    act = jax.random.uniform(jax.random.PRNGKey(11), (B, N, 2), minval=-0.3, maxval=0.8)
    cons, u_nom, _, _ = jax.jit(jcbf.assemble)(state, act)
    return dict(jenv=jenv, tenv=tenv, jcbf=jcbf, tcbf=tcbf, state=state, cons=cons,
                u_nom=u_nom)


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


def test_to_dense_matches_jax(entire):
    """`to_dense`: every field of the dense set equal to JAX's."""
    dense_j = entire["jcbf"].to_dense(entire["cons"])
    dense_t = entire["tcbf"].to_dense(_port_cons(entire["cons"], torch.float32))
    for f in jqp.ConstraintSet._fields:
        np.testing.assert_array_equal(to_numpy(getattr(dense_t, f)),
                                      np.asarray(getattr(dense_j, f)), err_msg=f)


def test_dense_solve_matches_jax_in_float64(entire):
    """`solve_boxed_penalty_qp` and `eliminated_lambda` against JAX's in
    float64 on the dense set: controls, objective and lambdas to 1e-9."""
    u_nom = np.asarray(entire["u_nom"], np.float64).reshape(B, 2 * N)
    w_u, lo, hi = (np.tile(np.asarray(x, np.float64), N) for x in (W_U, LO, HI))
    dense_t = entire["tcbf"].to_dense(_port_cons(entire["cons"], torch.float64))
    with jax.enable_x64(True):
        dense_j = jqp.ConstraintSet(**{
            f: jnp.asarray(to_numpy(getattr(dense_t, f))) for f in jqp.ConstraintSet._fields})
        uj, Fj = jax.jit(lambda c, u: jqp.solve_boxed_penalty_qp(
            c, u, jnp.asarray(w_u), jnp.asarray(lo), jnp.asarray(hi), n_iters=12))(
                dense_j, jnp.asarray(u_nom))
        lam_j = np.asarray(jqp.eliminated_lambda(dense_j, uj))
    t = torch.from_numpy
    ut, Ft = tqp.solve_boxed_penalty_qp(dense_t, t(u_nom), t(w_u), t(lo), t(hi), n_iters=12)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(Ft.numpy(), np.asarray(Fj), rtol=1e-9, atol=0)
    np.testing.assert_allclose(tqp.eliminated_lambda(dense_t, ut).numpy(), lam_j, rtol=0,
                               atol=1e-9)


def test_dense_solve_agrees_with_the_structured_solve(entire):
    """The port's dense solve on `to_dense` of a set against its structured
    solve (the kernel's plain version) on the set itself, 25 iterations in
    float32, as the JAX package holds its two solvers
    (`test_safety.py::test_structured_solver_matches_dense`): objectives
    to a relative 1e-4, minimizers to 3e-3 where F < 1 (on crash states
    float32 cannot resolve the flat directions)."""
    cons = _port_cons(entire["cons"], torch.float32)
    u_nom = torch.from_numpy(np.array(entire["u_nom"]))
    u_s, F_s = tqp.solve_structured_qp(cons, u_nom, W_U, LO, HI, n_iters=25)
    dense = entire["tcbf"].to_dense(cons)
    w_u, lo, hi = (torch.tensor(x, dtype=torch.float32).repeat(N) for x in (W_U, LO, HI))
    u_d, F_d = tqp.solve_boxed_penalty_qp(dense, u_nom.reshape(B, 2 * N), w_u, lo, hi,
                                          n_iters=25)
    np.testing.assert_allclose(F_s.numpy(), F_d.numpy(), rtol=1e-4, atol=1e-6)
    feasible = F_s.numpy() < 1.0
    assert feasible.any()
    np.testing.assert_allclose(u_s.reshape(B, 2 * N).numpy()[feasible],
                               u_d.numpy()[feasible], atol=3e-3)


def _example_path():
    return jload_map("pseudo_distance_example").reference_paths[0]


def test_pseudo_distance_to_polyline_matches_jax(entire):
    """On the example map's left boundary and on a padded cpm_entire
    boundary (with its valid count): seeded points around the polyline,
    its vertices (the segment joints) and points off its ends, to 1e-5."""
    path = _example_path()
    bnd, tan = path.left_boundary_shared, path.left_boundary_shared_pseudo_vector
    rng = np.random.default_rng(0)
    lo, hi = bnd.min(0) - 0.3, bnd.max(0) + 0.3
    pts = np.concatenate([rng.uniform(lo, hi, (400, 2)), bnd, bnd + 1e-4]).astype(np.float32)
    fn = jax.jit(jpd.pseudo_distance_to_polyline)
    dj = np.asarray(fn(jnp.asarray(pts), jnp.asarray(bnd), jnp.asarray(tan)))
    dt = pseudo_distance_to_polyline(*(torch.from_numpy(np.asarray(a, np.float32))
                                       for a in (pts, bnd, tan)))
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-5)
    tables = entire["jenv"].tables
    k = 3
    args = [np.asarray(x) for x in (tables.left_boundary[k], tables.left_boundary_pseudo_vec[k])]
    n = np.asarray(tables.n_points_left_b[k])
    pts = (args[0][:n] + rng.normal(0, 0.05, (n, 2))).astype(np.float32)
    dj = np.asarray(jax.jit(jpd.pseudo_distance_to_polyline)(pts, *args, n))
    dt = pseudo_distance_to_polyline(torch.from_numpy(pts), *map(torch.from_numpy, args),
                                     torch.tensor(n))
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-5)
    assert (dj < 999.0).all()


def test_compute_field_matches_jax_and_figures(tmp_path):
    """`compute_field` on a 40 x 40 grid against JAX's (1e-5, the _BIG
    cells equal), and `make_figures` writes both PNGs."""
    path = _example_path()
    bnd, tan = path.left_boundary_shared, path.left_boundary_shared_pseudo_vector
    xlim = (bnd[:, 0].min() - 0.15, bnd[:, 0].max() + 0.15)
    ylim = (bnd[:, 1].min() - 0.15, bnd[:, 1].max() + 0.15)
    Xj, Yj, Dj = jpde.compute_field(bnd, tan, xlim, ylim, resolution=40)
    Xt, Yt, Dt = tpde.compute_field(bnd, tan, xlim, ylim, resolution=40, device="cpu")
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(Yt, Yj)
    np.testing.assert_allclose(Dt, Dj, rtol=0, atol=1e-5)
    assert ((Dt >= 999.0) == (Dj >= 999.0)).all()
    out = tpde.make_figures(str(tmp_path), device="cpu")
    assert [os.path.basename(p) for p in out] == ["pseudo_distance_left.png",
                                                  "pseudo_distance_right.png"]
    assert all(os.path.getsize(p) > 0 for p in out)


def test_current_lanelet_id_matches_jax(entire):
    """The lanelet-ID tables equal JAX's, and `current_lanelet_id` of every
    agent of a reset (and of points scattered around them) equals JAX's."""
    jt, tt = entire["jenv"].tables, entire["tenv"].tables
    for f in ("ref_lanelet_ids", "n_ref_lanelet_ids", "ref_lanelet_segment_points"):
        np.testing.assert_array_equal(to_numpy(getattr(tt, f)), np.asarray(getattr(jt, f)),
                                      err_msg=f)
    state = entire["state"]
    pid = np.asarray(state.path_id)
    rng = np.random.default_rng(1)
    pos = np.asarray(state.pos)
    pts = np.stack([pos, pos + rng.normal(0, 0.3, pos.shape).astype(np.float32)])  # [2, B, N, 2]
    args_j = [np.asarray(getattr(jt, f))[pid] for f in
              ("ref_lanelet_segment_points", "n_ref_lanelet_ids", "ref_lanelet_ids")]
    ids_j = np.asarray(jax.jit(jgeom.current_lanelet_id)(pts, *(a[None] for a in args_j)))
    args_t = [getattr(tt, f)[torch.from_numpy(pid).long()] for f in
              ("ref_lanelet_segment_points", "n_ref_lanelet_ids", "ref_lanelet_ids")]
    ids_t = tgeom.current_lanelet_id(torch.from_numpy(pts),
                                     *(a[None].expand((2,) + a.shape) for a in args_t))
    np.testing.assert_array_equal(ids_t.numpy(), ids_j)


def test_interactive_session_matches_jax():
    """Keys, clipping and actions of the port's session against JAX's from
    the same state (every key, the speed pushed past its limit, the second
    agent's keys with `control_two_agents`); R resets from the session's
    generator; then 5 steps with finite rewards. `render_interactively`
    refuses the Agg backend."""
    kw = dict(scenario_type="cpm_entire", n_agents=N, control_two_agents=True)
    js = JSession(**kw)
    ts = InteractiveSession(**kw, device="cpu")
    ts.state = to_torch_state(js.state)
    keys = ["up"] * 12 + ["left", "left", "right", "down", "w", "w", "a", "d", "d", "s", "x"]
    for k in keys:
        js.key(k)
        ts.key(k)
        np.testing.assert_array_equal(ts.targets, js.targets, err_msg=k)
    assert ts.targets[0, 0] == js.targets[0, 0] <= ts.env.cfg.max_speed
    np.testing.assert_allclose(ts.actions().numpy(), np.asarray(js.actions()), rtol=0, atol=1e-6)
    before = ts.state.pos.clone()
    ts.key("r")
    assert ts.t == 0 and not (ts.targets != 0).any() and not torch.equal(ts.state.pos, before)
    for _ in range(5):
        rew, done = ts.step()
        assert rew.shape == (N,) and np.isfinite(rew).all()
    assert ts.t == 5
    ts.key("q")
    assert ts.quit
    import matplotlib

    matplotlib.use("Agg")
    with pytest.raises(RuntimeError, match="interactive matplotlib backend"):
        render_interactively(device="cpu")


def test_debug_demo_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the demo draws to debug_demo.png
    traj = debug_demo.main(["--device", "cpu", "--steps", "5", "--render"])
    assert traj.shape == (5, 2, 2) and np.isfinite(traj).all()
    assert os.path.getsize(tmp_path / "debug_demo.png") > 0
    assert "step 0: pos" in capsys.readouterr().out


def test_export_for_lab_round_trip(tmp_path):
    """A checkpoint written by the port's trainer, exported: `policy.pkl`
    in JAX's `PolicyNet` gives the port policy's outputs (1e-6), and
    `parameters.json` holds the run's parameters."""
    p = tcfg.Parameters(scenario_type="cpm_mixed", n_agents=N, num_vmas_envs=2, max_steps=4,
                        n_iters=1, device="cpu", where_to_save=str(tmp_path) + "/")
    tr = MAPPOCAVs(p)
    saver = ckpt.RewardKeyedCheckpointer(p)
    assert saver.maybe_save(-0.5, tr.checkpoint_params(tr.initial_state()), [-0.5])
    out = export_for_lab(saver.dir, str(tmp_path / "lab"))
    with open(os.path.join(out, "policy.pkl"), "rb") as f:
        params = pickle.load(f)
    with open(os.path.join(out, "parameters.json")) as f:
        assert json.load(f)["n_agents"] == N
    obs = np.random.default_rng(2).normal(size=(3, N, tr.env.obs_dim)).astype(np.float32)
    loc_j, scale_j = JPolicyNet(act_dim=2).apply(params, jnp.asarray(obs))
    loc_t, scale_t = tr.policy_net(torch.from_numpy(obs))
    np.testing.assert_allclose(loc_t.detach().numpy(), np.asarray(loc_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(scale_t.detach().numpy(), np.asarray(scale_j), rtol=0, atol=1e-6)
    again = policy_from_jax_params(params, device="cpu")
    for a, b in zip(to_jax_params(again).values(), to_jax_params(tr.policy_net).values()):
        assert a.keys() == b.keys()
