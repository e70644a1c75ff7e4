"""Pieces of K1's plain version on the CPU: the Newton system's solve in
the kernel's order, and the per-agent pair lists that its assembly walks;
and the filter's host side, which makes K1's inputs without copying from
host values (what lets the card capture it as a graph)."""

import numpy as np
import pytest
import torch

from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.env.env import make_env
from sigmarl_tpu_torch.env.structs import zero_state
from sigmarl_tpu_torch.ops.qp import agent_pair_slots, chol_solve
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter
from sigmarl_tpu_torch.safety.circles import circle_centers_world
from sigmarl_tpu_torch.safety.qp import kernel_inputs, pack_constraints
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step

torch.set_num_threads(1)


@pytest.mark.parametrize("d", [8, 30])
def test_chol_solve_matches_linalg_solve(d):
    """Right-looking Cholesky, forward and column-wise backward
    substitution: on random SPD systems in float64 the solution is
    `torch.linalg.solve`'s to 1e-10."""
    rng = np.random.default_rng(d)
    B = 16
    M = rng.normal(size=(B, d, d))
    H = torch.tensor(M @ np.swapaxes(M, 1, 2) + d * np.eye(d), dtype=torch.float64)
    g = torch.tensor(rng.normal(size=(B, d)), dtype=torch.float64)
    x = chol_solve(H, g)
    ref = torch.linalg.solve(H, g)
    torch.testing.assert_close(x, ref, atol=1e-10, rtol=0)


def test_chol_solve_keeps_identity_rows():
    """A bound variable's identity row (the free-set restriction) gives
    x = g there and decouples it from the rest."""
    rng = np.random.default_rng(1)
    d = 8
    M = rng.normal(size=(d, d))
    H = torch.tensor(M @ M.T + d * np.eye(d), dtype=torch.float64)[None]
    free = torch.ones(d, dtype=torch.float64)
    free[[2, 5]] = 0.0
    Hr = H * free[None, :, None] * free[None, None, :] + torch.diag(1.0 - free)[None]
    g = torch.tensor(rng.normal(size=(1, d)), dtype=torch.float64)
    x = chol_solve(Hr, g)
    torch.testing.assert_close(x[0, [2, 5]], g[0, [2, 5]], atol=1e-12, rtol=0)
    torch.testing.assert_close(x, torch.linalg.solve(Hr, g), atol=1e-10, rtol=0)


@pytest.mark.parametrize("case", ["all_pairs", "grouped"])
def test_agent_pair_slots(case):
    """Every pair appears exactly once per role, in its agent's row, in
    pair order, the rest padded with P: the runs the kernel builds."""
    N = 15 if case == "all_pairs" else 6
    if case == "all_pairs":
        pi, pj = np.triu_indices(N, 1)
    else:  # an uneven pair list, as a grouped filter may have
        rng = np.random.default_rng(0)
        pairs = [(i, j) for i in range(N) for j in range(i + 1, N) if rng.random() < 0.6]
        pi, pj = np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs])
    P = len(pi)
    for owner in (pi, pj):
        slots = agent_pair_slots(owner, N).numpy()
        assert slots.shape[0] == N
        seen = slots[slots < P]
        assert sorted(seen.tolist()) == list(range(P))  # each pair once
        for n in range(N):
            row = slots[n]
            mine = row[row < P]
            np.testing.assert_array_equal(mine, np.flatnonzero(owner == n))  # pair order
            assert (row[len(mine):] == P).all()  # padding after the run


@pytest.fixture(scope="module")
def live():
    """cpm_entire, N=4, B=3 on the CPU, a filter at the trainer's budget
    and a live state after two filtered steps from the all-zero state."""
    p = Parameters(
        scenario_type="cpm_entire", n_agents=4, num_vmas_envs=3, dt=0.1, max_steps=50,
        is_use_mtv_distance=False, is_obs_noise=False, is_using_cbf_testing=True,
        is_using_centralized_cbf=True,
    )
    env = make_env(p, device="cpu")
    cbf = CBFSafetyFilter(CBFConfig(n_agents=4), env.cfg, env.tables, device="cpu")
    g = torch.Generator().manual_seed(3)
    state = zero_state(env.cfg, "cpu")
    for _ in range(2):
        act = (torch.rand((3, 4, 2), generator=g) - 0.3) * env.action_limits
        state, *_ = cbf_filtered_step(env, cbf, state, act, generator=g)
    act = (torch.rand((3, 4, 2), generator=g) - 0.3) * env.action_limits
    return env, cbf, state, act


def _host_copied_kernel_inputs(cons, u_nom, u_lo, u_hi, u_init, ws_cap):
    """`kernel_inputs` as it was: the box and the pair lists copied from
    host values on every call."""
    singles, pairs = pack_constraints(cons, ws_cap)
    lo = torch.tensor(u_lo, dtype=u_nom.dtype)
    hi = torch.tensor(u_hi, dtype=u_nom.dtype)

    def blocks(u, clip=True):
        if clip:
            u = torch.minimum(torch.maximum(u, lo), hi)
        return torch.cat([u[..., 0], u[..., 1]], dim=1).contiguous()

    u0 = blocks(u_nom)
    ui = u0 if u_init is None else blocks(u_init)
    pair_i = torch.as_tensor(np.asarray(cons.pair_i), dtype=torch.int32)
    pair_j = torch.as_tensor(np.asarray(cons.pair_j), dtype=torch.int32)
    return singles, pairs, u0, ui, blocks(u_nom, clip=False), pair_i, pair_j


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("pairs_from", ["filter", "constant"])
def test_sync_free_kernel_inputs_equal_the_host_copied_ones(live, warm, pairs_from):
    """The box clip by scalars and the pair lists the filter holds (or
    `device.constant`'s) give K1 the same tensors as copies made from host
    values each call, bit for bit, from a start inside and outside the
    box."""
    _, cbf, state, act = live
    cons, u_nom, _, _ = cbf.assemble(state, act)
    lo, hi = (cbf.a_min, cbf.rate_min), (cbf.a_max, cbf.rate_max)
    u_init = None
    if warm:  # the previous solution, pushed past the box in places
        u_init = state.cbf_u_prev * torch.tensor([1.0, 40.0]) + torch.tensor([0.0, 1e-7])
    pair_idx = cbf._pair_idx if pairs_from == "filter" else None
    got = kernel_inputs(cons, u_nom, lo, hi, u_init, cbf.cfg.newton_ws_cap, pair_idx)
    want = _host_copied_kernel_inputs(cons, u_nom, lo, hi, u_init, cbf.cfg.newton_ws_cap)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.is_contiguous()
        assert torch.equal(a, b)
    if warm:
        assert not torch.equal(got[3], got[2])  # the warm start is its own


def test_circle_centers_world_from_the_filters_local_centers(live):
    """The world-frame circle centers from the filter's local centers (made
    once, on its device) are those from the approximation's numpy
    centers copied each call."""
    _, cbf, state, _ = live
    local = torch.as_tensor(cbf.approx.centers_local)
    c, s = torch.cos(state.rot)[..., None], torch.sin(state.rot)[..., None]
    want = torch.stack([local[:, 0] * c - local[:, 1] * s, local[:, 0] * s + local[:, 1] * c],
                       dim=-1) + state.pos[..., None, :]
    got = circle_centers_world(cbf.centers_local, state.pos, state.rot)
    assert cbf.centers_local.device == state.pos.device
    assert torch.equal(got, want)


def _refuse_host_values(*args, **kw):
    raise AssertionError("the filter made a tensor from host values")


@pytest.mark.parametrize("mode", ["main", "grouped", "clf", "obs_noise"])
def test_the_filter_makes_no_tensor_from_host_values(live, monkeypatch, mode):
    """After its construction the filter makes no tensor from host values
    (on the card such a tensor is a copy from pageable memory, which waits
    for the card and cannot be captured): `torch.tensor` and
    `torch.as_tensor` raise during the call. K1's plain version, which
    stands in for the kernel here, may make its own."""
    from sigmarl_tpu_torch.ops import qp as ops_qp

    env, _, state, act = live
    kw = {"grouped": dict(max_group_size=2)}.get(mode, {})
    cfg = CBFConfig(n_agents=4, newton_iters=3, newton_soft_iters=1,
                    nom_controller_type="clf" if mode == "clf" else "rl",
                    is_obs_noise=mode == "obs_noise", obs_noise_level=0.1)
    cbf = CBFSafetyFilter(cfg, env.cfg, env.tables, device="cpu", **kw)
    want = cbf.filter_actions(state, act, u_init=state.cbf_u_prev,
                              generator=torch.Generator().manual_seed(7))
    plain_solve = ops_qp.newton_solve_reference
    tensor, as_tensor = torch.tensor, torch.as_tensor

    def solve_with_host_values(*args, **kw):
        with monkeypatch.context() as m:
            m.setattr(torch, "tensor", tensor)
            m.setattr(torch, "as_tensor", as_tensor)
            return plain_solve(*args, **kw)

    monkeypatch.setattr(ops_qp, "newton_solve_reference", solve_with_host_values)
    monkeypatch.setattr(torch, "tensor", _refuse_host_values)
    monkeypatch.setattr(torch, "as_tensor", _refuse_host_values)
    got = cbf.filter_actions(state, act, u_init=state.cbf_u_prev,
                             generator=torch.Generator().manual_seed(7))
    monkeypatch.undo()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
