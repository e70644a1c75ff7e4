"""K2, the pseudo-distance stencil: the port's plain version vs the JAX
Pallas kernel (interpret mode) and the JAX sweeps it stands in for."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigmarl_tpu.env.map_tables import lookup, path_onehot
from sigmarl_tpu.ops.boundary_pallas import pseudo_distance_stencil as jax_stencil
from sigmarl_tpu.safety import pseudo_distance as jpd
from sigmarl_tpu_torch.ops import launch_counts
from sigmarl_tpu_torch.ops.boundary import (
    pseudo_distance_stencil,
    pseudo_distance_stencil_reference,
)
from sigmarl_tpu_torch.safety.pseudo_distance import (
    PD_CHUNK,
    counting_segments,
    pseudo_distance_seg,
    topk_chunks,
)
from tests.torch_parity import envs, params

torch.set_num_threads(1)
B, N, Q = 8, 15, 27


@pytest.fixture(scope="module")
def setup():
    jenv, tenv = envs(**params("cpm_entire", N, B))
    state, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    offs = jax.random.uniform(jax.random.PRNGKey(1), (B, N, Q, 2), minval=-0.05, maxval=0.05)
    q = state.pos[:, :, None, :] + offs
    return jenv, tenv, state, q


def test_full_scan_matches_pallas_and_seg(setup):
    """atol 2e-5: float32 reassociation of the same per-segment formula."""
    jenv, tenv, state, q = setup
    t = tenv.tables
    pid = torch.from_numpy(np.array(state.path_id)).reshape(-1)
    qt = torch.from_numpy(np.array(q)).reshape(B * N, Q, 2)
    dl, dr = pseudo_distance_stencil(qt, pid, t.left_seg, t.right_seg)

    jl, jr = jax_stencil(
        q.reshape(B * N, Q, 2), state.path_id.reshape(-1),
        jenv.tables.left_seg, jenv.tables.right_seg, interpret=True,
    )
    np.testing.assert_allclose(dl.numpy(), np.asarray(jl), atol=2e-5)
    np.testing.assert_allclose(dr.numpy(), np.asarray(jr), atol=2e-5)

    oh = path_onehot(state.path_id, jenv.tables.left_seg.shape[0])
    for ours, seg in ((dl, jenv.tables.left_seg), (dr, jenv.tables.right_seg)):
        ref = jpd.pseudo_distance_seg(q, lookup(oh, seg)).reshape(B * N, Q)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)


def test_chunked_matches_topk_chunk_rows(setup):
    """The chunked form on the CBF lane stencil's own queries (circle
    centers + 9-point offsets) vs JAX `topk_chunk_rows` +
    `pseudo_distance_seg`: the same chunks are selected and the distances
    agree to atol 2e-5."""
    from sigmarl_tpu.safety.circles import CircleApproximation, circle_centers_world

    jenv, tenv, state, _ = setup
    jt, t = jenv.tables, tenv.tables
    approx = CircleApproximation(0.22, 0.107, 3)
    centers = circle_centers_world(approx, state.pos, state.rot)  # [B, N, 3, 2]
    stencil = np.array([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1], [1, 1], [1, -1],
                        [-1, 1], [-1, -1]], np.float32) * 0.02
    q = (centers[..., None, :] + stencil).reshape(B, N, 27, 2)
    c_loc = approx.centers_local.astype(np.float64)
    reach = float(np.abs(c_loc - c_loc.mean()).max() + np.hypot(0.02, 0.02))
    p_ref = centers.mean(axis=2)
    oh = path_onehot(state.path_id, jt.left_seg.shape[0])

    pid = torch.from_numpy(np.array(state.path_id)).reshape(-1)
    pref = torch.from_numpy(np.array(p_ref)).reshape(-1, 2)
    sel = {}
    for side in ("left", "right"):
        sel[side] = topk_chunks(getattr(t, f"{side}_chunk_cc"), getattr(t, f"{side}_chunk_cr"),
                                pid, pref, reach, 3)
        lb = (jnp.linalg.norm(p_ref[..., None, :] - lookup(oh, getattr(jt, f"{side}_chunk_cc")),
                              axis=-1) - lookup(oh, getattr(jt, f"{side}_chunk_cr")) - reach)
        jsel = np.sort(np.asarray(jax.lax.top_k(-lb, 3)[1]).reshape(-1, 3), axis=-1)
        np.testing.assert_array_equal(np.sort(sel[side].numpy(), axis=-1), jsel)

    qt = torch.from_numpy(np.array(q)).reshape(B * N, 27, 2)
    dl, dr = pseudo_distance_stencil(qt, pid, t.left_seg, t.right_seg, sel["left"], sel["right"])
    for ours, side in ((dl, "left"), (dr, "right")):
        rows = jpd.topk_chunk_rows(
            getattr(jt, f"{side}_seg"), getattr(jt, f"{side}_chunk_cc"),
            getattr(jt, f"{side}_chunk_cr"), oh, state.path_id, p_ref, reach, 3,
        )
        ref = jpd.pseudo_distance_seg(q, rows).reshape(B * N, 27)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)


def test_cpu_tensors_take_the_plain_version(setup):
    _, tenv, state, q = setup
    t = tenv.tables
    pid = torch.from_numpy(np.array(state.path_id)).reshape(-1)
    qt = torch.from_numpy(np.array(q)).reshape(B * N, Q, 2)
    before = launch_counts()["boundary_stencil"]
    out = pseudo_distance_stencil(qt, pid, t.left_seg, t.right_seg)
    ref = pseudo_distance_stencil_reference(qt, pid, t.left_seg, t.right_seg)
    assert launch_counts()["boundary_stencil"] == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert t.left_seg.shape[1] % PD_CHUNK == 0


@pytest.mark.parametrize("spread", [0.05, 1.0])
def test_counting_segments_carry_the_minimum(setup, spread):
    """Marking every segment that counts for none of a row's queries invalid
    leaves each query's pseudo distance exactly as it was (what the kernel's
    segment test relies on), and the count is a small share of the path
    when the queries are close together."""
    _, tenv, state, _ = setup
    t = tenv.tables
    rng = np.random.default_rng(7)
    pos = torch.from_numpy(np.array(state.pos)).reshape(B * N, 1, 2)
    q = pos + torch.tensor(rng.uniform(-spread, spread, (B * N, Q, 2)), dtype=torch.float32)
    pid = torch.from_numpy(np.array(state.path_id)).reshape(-1).long()
    for table in (t.left_seg, t.right_seg):
        rows = table[pid]
        keep = counting_segments(q, rows)
        assert keep.shape == rows.shape[:2]
        pruned = rows.clone()
        pruned[..., 7] = torch.where(keep, rows[..., 7], torch.zeros_like(rows[..., 7]))
        assert torch.equal(pseudo_distance_seg(q, pruned), pseudo_distance_seg(q, rows))
        if spread < 0.1:
            assert float(keep.float().mean()) < 0.1
