"""Pieces of K1's plain version on the CPU: the Newton system's solve in
the kernel's order, and the per-agent pair lists that its assembly walks."""

import numpy as np
import pytest
import torch

from sigmarl_tpu_torch.ops.qp import agent_pair_slots, chol_solve

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
