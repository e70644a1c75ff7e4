"""Port core (dynamics, geometry) vs the reference goldens and the JAX
package, at the tolerances of tests/test_dynamics.py and
tests/test_geometry.py."""

import jax.numpy as jnp
import numpy as np
import torch

from sigmarl_tpu.core import dynamics as jdyn
from sigmarl_tpu.core import geometry as jgeo
from sigmarl_tpu_torch.core import geometry as G
from sigmarl_tpu_torch.core.dynamics import BicycleParams, command_step, step

torch.set_num_threads(1)
T = torch.from_numpy


def test_bicycle_trajectory_matches_golden(golden):
    g = golden("dynamics")
    params = BicycleParams()
    x, u = T(g["x0"]), T(g["u"])
    for k in range(g["xs"].shape[0]):
        x, beta, vel = step(params, x, u, dt=0.05)
        np.testing.assert_allclose(x.numpy(), g["xs"][k], atol=2e-5)
        np.testing.assert_allclose(beta.numpy(), g["betas"][k], atol=2e-5)
        np.testing.assert_allclose(vel.numpy(), g["vels"][k], atol=2e-5)


def test_command_step_matches_jax():
    rng = np.random.default_rng(0)
    n = 64
    pos = rng.uniform(0, 4, (n, 2)).astype(np.float32)
    rot = rng.uniform(-3, 3, n).astype(np.float32)
    speed = rng.uniform(-0.5, 1, n).astype(np.float32)
    steer = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    act = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    ours = command_step(BicycleParams(), T(pos), T(rot), T(speed), T(steer), T(act), 0.1)
    ref = jdyn.command_step(
        jdyn.BicycleParams(), *(jnp.asarray(a) for a in (pos, rot, speed, steer, act)), 0.1
    )
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)


def test_geometry_matches_golden(golden):
    g = golden("geometry")
    d, idx = G.perpendicular_distances(T(g["pd_pts"]), T(g["pd_poly"]), T(g["pd_n"]))
    np.testing.assert_allclose(d.numpy(), g["pd_d"], atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), g["pd_i"])

    path, sidx = G.short_term_reference_path(
        T(g["pd_poly"]), idx, 3, T(g["st_loop"]), T(g["pd_n"]), 2, 1
    )
    np.testing.assert_array_equal(sidx.numpy(), g["st_idx"])
    np.testing.assert_allclose(path.numpy(), g["st_path"], atol=1e-6)

    verts = G.rectangle_vertices(T(g["rv_center"]), T(g["rv_yaw"][:, 0]), 0.107, 0.22, True)
    np.testing.assert_allclose(verts.numpy(), g["rv_verts"], atol=1e-5)

    diag = float(np.sqrt(4.5**2 + 4.0**2))
    c2c = G.c2c_distances(T(g["c2c_centers"]), set_diagonal_to=diag)
    np.testing.assert_allclose(c2c.numpy(), g["c2c_d"], atol=1e-5)

    hit = G.interx(T(g["mtv_verts"][:, 0]), T(g["ix_L2"]))
    np.testing.assert_array_equal(hit.numpy(), g["ix_hit"])
    hit_pair = G.interx(T(g["mtv_verts"][:, 0]), T(g["mtv_verts"][:, 1]))
    np.testing.assert_array_equal(hit_pair.numpy(), g["ix_hit_pair"])

    rel = G.global_to_local(T(g["tf_pos_i"]), T(g["tf_pos_j"]), T(g["tf_rot_i"][:, 0]))
    np.testing.assert_allclose(rel.numpy(), g["tf_rel"], atol=1e-5)


def test_geometry_matches_jax():
    """Collision, corner-sweep and angle functions the step uses, against
    the JAX package on random rectangles and wandering polylines."""
    rng = np.random.default_rng(1)
    B = 64
    pos = rng.uniform(0, 2, (B, 2)).astype(np.float32)
    rot = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    poly = (pos[:, None] + rng.normal(0, 0.08, (B, 40, 2)).cumsum(1)).astype(np.float32)
    poly[:, -5:] = poly[:, -6:-5]  # padding tail
    np.testing.assert_array_equal(
        G.rect_polyline_hit(T(pos), T(rot), 0.107, 0.22, T(poly)).numpy(),
        np.asarray(jgeo.rect_polyline_hit(jnp.asarray(pos), jnp.asarray(rot), 0.107, 0.22,
                                          jnp.asarray(poly))),
    )
    q = rng.uniform(0, 2, (B, 4, 2)).astype(np.float32)
    np.testing.assert_allclose(
        G.min_perpendicular_distance(T(q), T(poly)[:, None]).numpy(),
        np.asarray(jgeo.min_perpendicular_distance(jnp.asarray(q), jnp.asarray(poly)[:, None])),
        atol=1e-6,
    )
    a = np.linspace(-10, 10, 101, dtype=np.float32)
    np.testing.assert_allclose(
        G.angle_eliminate_two_pi(T(a)).numpy(),
        np.asarray(jgeo.angle_eliminate_two_pi(jnp.asarray(a))), atol=1e-6,
    )
    x = rng.uniform(-0.1, 0.5, 50).astype(np.float32)
    np.testing.assert_allclose(
        G.decreasing_fcn(T(x), 0.0, 0.3).numpy(),
        np.asarray(jgeo.decreasing_fcn(jnp.asarray(x), 0.0, 0.3)), atol=1e-6,
    )
