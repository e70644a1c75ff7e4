"""The port's CUDA kernels against their plain versions on the card, at
rollout-like sizes. Every test here needs a CUDA device (marker `gpu`) and
skips without one. The file imports no JAX, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.env.env import make_env
from sigmarl_tpu_torch.env.structs import zero_state
from sigmarl_tpu_torch.ops.boundary import (
    pseudo_distance_stencil,
    pseudo_distance_stencil_reference,
)
from sigmarl_tpu_torch.ops.qp import newton_solve, newton_solve_reference
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter
from sigmarl_tpu_torch.safety.pseudo_distance import topk_chunks
from sigmarl_tpu_torch.safety.qp import kernel_inputs
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step

pytestmark = pytest.mark.gpu
B, N, Q = 64, 15, 27


@pytest.fixture(scope="module")
def rollout():
    """An env, its filter and a live state after a few filtered steps on
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    p = Parameters(
        scenario_type="cpm_entire", n_agents=N, num_vmas_envs=B, dt=0.1, max_steps=1_000_000,
        is_use_mtv_distance=False, is_obs_noise=False, is_using_cbf_testing=True,
        is_using_centralized_cbf=True,
    )
    env = make_env(p, device="cuda")
    cbf = CBFSafetyFilter(CBFConfig(n_agents=N, newton_iters=5, newton_soft_iters=3),
                          env.cfg, env.tables, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    state = zero_state(env.cfg, "cuda")
    for _ in range(4):
        act = (torch.rand((B, N, 2), generator=g, device="cuda") - 0.3) * env.action_limits
        state, *_ = cbf_filtered_step(env, cbf, state, act, generator=g)
    return env, cbf, state, g


def test_stencil_kernel_matches_plain(rollout):
    """Chunked and full scan, both sides, atol 2e-5."""
    env, _, state, g = rollout
    R = B * N
    q = (state.pos.reshape(R, 1, 2)
         + 0.05 * (2 * torch.rand((R, Q, 2), generator=g, device="cuda") - 1)).contiguous()
    pid = state.path_id.reshape(R).contiguous()
    t = env.tables
    p_ref = state.pos.reshape(R, 2)
    sel_l = topk_chunks(t.left_chunk_cc, t.left_chunk_cr, pid, p_ref, 0.1, 3)
    sel_r = topk_chunks(t.right_chunk_cc, t.right_chunk_cr, pid, p_ref, 0.1, 3)
    for chunks in ((None, None), (sel_l, sel_r)):
        before = pseudo_distance_stencil.launches
        out = pseudo_distance_stencil(q, pid, t.left_seg, t.right_seg, *chunks)
        ref = pseudo_distance_stencil_reference(q, pid, t.left_seg, t.right_seg, *chunks)
        torch.cuda.synchronize()
        assert pseudo_distance_stencil.launches == before + 1
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, atol=2e-5, rtol=0)


def test_solve_kernel_matches_plain(rollout):
    """Controls after 0 and 1 iterations to atol 2e-5, F after 30
    iterations to a relative 1e-4 and at the production 3+5 budget to
    1e-3. The plain version sums in the kernel's order, so the two differ
    by rounding only (both build without fused multiply-adds)."""
    env, cbf, state, g = rollout
    act = (torch.rand((B, N, 2), generator=g, device="cuda") - 0.3) * env.action_limits
    cons, u_nom, _, _ = cbf.assemble(state, act)
    lo = (cbf.a_min, cbf.rate_min)
    hi = (cbf.a_max, cbf.rate_max)
    w_u = (cbf.cfg.w_u_acc, cbf.cfg.w_u_steer)
    args = (*kernel_inputs(cons, u_nom, lo, hi, state.cbf_u_prev, cbf.cfg.newton_ws_cap),
            w_u, lo, hi)
    for it, soft, tol in ((0, 0, None), (1, 0, None), (30, 0, 1e-4), (5, 3, 1e-3)):
        before = newton_solve.launches
        u_k, F_k = newton_solve(*args, it, soft_iters=soft)
        u_p, F_p = newton_solve_reference(*args, it, soft_iters=soft)
        torch.cuda.synchronize()
        assert newton_solve.launches == before + 1
        if tol is None:
            torch.testing.assert_close(u_k, u_p, atol=2e-5, rtol=1e-5)
        else:
            gap = ((F_k.double() - F_p.double()).abs() / (1 + F_p.double().abs())).max()
            assert gap < tol, (it, soft, float(gap))


def test_filtered_step_launches_each_kernel_once(rollout):
    env, cbf, state, g = rollout
    act = (torch.rand((B, N, 2), generator=g, device="cuda") - 0.3) * env.action_limits
    k1, k2 = newton_solve.launches, pseudo_distance_stencil.launches
    state, obs, rew, done, info = cbf_filtered_step(env, cbf, state, act, generator=g)
    torch.cuda.synchronize()
    assert newton_solve.launches == k1 + 1
    assert pseudo_distance_stencil.launches == k2 + 1
    assert torch.isfinite(obs).all() and torch.isfinite(rew).all()
    assert obs.shape == (B, N, env.obs_dim) and np.isfinite(info["cbf_max_violation"].cpu()).all()
