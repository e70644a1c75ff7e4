"""The port's CUDA kernels against their plain versions on the card, at
rollout-like sizes and on the evaluation path's inputs (one agent, active
CLF rows, one to five circles, window selections), the kernels' launches
in training iterations, the training entry point, and steps on the card
against the CPU (the challenge buffer's record and replay included). Every test here needs a CUDA
device (marker `gpu`) and skips without one. The file imports no JAX, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import os

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
from sigmarl_tpu_torch.safety.pseudo_distance import PD_CHUNK, topk_chunks
from sigmarl_tpu_torch.safety.qp import StructuredConstraintSet, kernel_inputs
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step
from sigmarl_tpu_torch.utils.card_checks import (
    challenge_buffer_steps_card_vs_cpu,
    clf_step_card_vs_cpu,
    compact_reset_card_vs_cpu,
    near_zero_clf_rows,
)

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


@pytest.mark.parametrize("spread", [0.5, 3.0])
@pytest.mark.parametrize("nq", [Q, 36, 128])
def test_stencil_kernel_matches_plain_on_spread_queries(rollout, spread, nq):
    """Queries spread over a square of half-width 0.5 m and 3 m around each
    row's centre: the kernel's disk test keeps far more segments there
    (and segments whose lambda denominator changes sign), and the result
    still equals the plain full sweep, chunked and full scan. Rows of 36
    and 128 queries take the kernel's four-queries-per-lane branch."""
    env, _, state, g = rollout
    R = B * N
    q = (state.pos.reshape(R, 1, 2)
         + spread * (2 * torch.rand((R, nq, 2), generator=g, device="cuda") - 1)).contiguous()
    pid = state.path_id.reshape(R).contiguous()
    t = env.tables
    p_ref = state.pos.reshape(R, 2)
    sel_l = topk_chunks(t.left_chunk_cc, t.left_chunk_cr, pid, p_ref, spread * 1.5, 3)
    sel_r = topk_chunks(t.right_chunk_cc, t.right_chunk_cr, pid, p_ref, spread * 1.5, 3)
    for chunks in ((None, None), (sel_l, sel_r)):
        out = pseudo_distance_stencil(q, pid, t.left_seg, t.right_seg, *chunks)
        ref = pseudo_distance_stencil_reference(q, pid, t.left_seg, t.right_seg, *chunks)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, atol=2e-5, rtol=0)


def test_stencil_kernel_refuses_rows_beyond_its_limits(rollout):
    """More than 128 queries per row, or more than 16 chunks per row and
    side, raise before a launch."""
    env, _, state, g = rollout
    R = B * N
    t = env.tables
    pid = state.path_id.reshape(R).contiguous()
    q = state.pos.reshape(R, 1, 2).expand(R, 129, 2).contiguous()
    before = pseudo_distance_stencil.launches
    with pytest.raises(ValueError, match="128 queries"):
        pseudo_distance_stencil(q, pid, t.left_seg, t.right_seg)
    chunks = torch.zeros((R, 17), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16 chunks"):
        pseudo_distance_stencil(q[:, :Q].contiguous(), pid, t.left_seg, t.right_seg, chunks, chunks)
    assert pseudo_distance_stencil.launches == before


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


def _solve_matches_plain(args, budgets=((0, 0, None), (1, 0, None), (30, 0, 1e-4), (5, 3, 1e-3))):
    """The kernel against its plain version: controls to atol 2e-5 where no
    tolerance is given, else F by a relative gap (the plain version sums in
    the kernel's order, so the two differ by rounding only)."""
    for it, soft, tol in budgets:
        before = newton_solve.launches
        u_k, F_k = newton_solve(*args, it, soft_iters=soft)
        u_p, F_p = newton_solve_reference(*args, it, soft_iters=soft)
        torch.cuda.synchronize()
        assert newton_solve.launches == before + 1
        assert torch.isfinite(u_k).all() and torch.isfinite(F_k).all()
        if tol is None:
            torch.testing.assert_close(u_k, u_p, atol=2e-5, rtol=1e-5)
        else:
            gap = ((F_k.double() - F_p.double()).abs() / (1 + F_p.double().abs())).max()
            assert gap < tol, (it, soft, float(gap))


W_U, LO, HI = (100.0, 1.0), (-5.0, -np.pi / 2), (5.0, np.pi / 2)


def _synthetic_qp(B, N, Ks, Kp, seed):
    """A constraint set made from a numpy seed, shaped like `assemble`'s:
    three quarters of the single rows and two thirds of the pair rows
    valid, slack weights from 1e2 to 1e6 before the row normalization of
    `pack_constraints` (capped at 3e6 there), pairs over all i < j."""
    rng = np.random.default_rng(seed)
    pi, pj = np.triu_indices(N, 1)
    P = len(pi)
    f = lambda *shape, scale=1.0: torch.tensor(  # noqa: E731
        rng.normal(0.0, scale, shape), dtype=torch.float32, device="cuda")
    cons = StructuredConstraintSet(
        A_s=f(B, N, Ks, 2), b_s=f(B, N, Ks, scale=2.0) + 1.0, h_s=f(B, N, Ks),
        ws_s=torch.tensor(10 ** rng.uniform(2, 6, (B, N, Ks)), dtype=torch.float32, device="cuda"),
        wl_s=torch.ones((B, N, Ks), device="cuda"),
        valid_s=torch.tensor(rng.random((B, N, Ks)) < 0.75, device="cuda"),
        A_pi=f(B, P, Kp, 2), A_pj=f(B, P, Kp, 2), b_p=f(B, P, Kp, scale=2.0) + 1.0,
        h_p=f(B, P, Kp),
        ws_p=torch.tensor(10 ** rng.uniform(2, 6, (B, P, Kp)), dtype=torch.float32, device="cuda"),
        wl_p=torch.ones((B, P, Kp), device="cuda"),
        valid_p=torch.tensor(rng.random((B, P, Kp)) < 2 / 3, device="cuda"),
        pair_i=pi, pair_j=pj,
    )
    u_nom = torch.tensor(rng.uniform(-1, 1, (B, N, 2)) * np.array([6.0, 2.0]),
                         dtype=torch.float32, device="cuda")
    u_init = torch.tensor(rng.uniform(-1, 1, (B, N, 2)) * np.array([4.0, 1.0]),
                          dtype=torch.float32, device="cuda")
    return (*kernel_inputs(cons, u_nom, LO, HI, u_init, 3e6), W_U, LO, HI)


@pytest.mark.parametrize("N, Kp", [(4, 9), (15, 18), (20, 9)])
def test_solve_kernel_matches_plain_on_synthetic_sizes(N, Kp):
    """N=4 (the cpm_mixed size), N=15 with Kp=18 (the grouped filter's pair
    rows) and N=20, whose 40 x 40 system takes the shared-memory solve
    instead of the register one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    _solve_matches_plain(_synthetic_qp(64, N, 8, Kp, seed=N + Kp))


def test_solve_kernel_matches_plain_on_tiny_residuals():
    """Rows whose residuals and lambda quotients are subnormal or close to
    it, which the kernel's fast row division does not take: their envs are
    solved again with IEEE divisions. A third of the single and pair rows
    get zero coefficients and an offset b from 1e-45 to 1e-30, with h from
    1 to 1e9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    singles, pairs, *rest = _synthetic_qp(64, 15, 8, 9, seed=7)
    rng = np.random.default_rng(8)
    for rows, coeffs, b_at, h_at in ((singles, 2, 2, 3), (pairs, 4, 4, 5)):
        tiny = torch.tensor(rng.random(rows.shape[::2]) < 1 / 3, device="cuda")
        size = rng.choice([1e-45, 1e-42, 1e-39, 1e-38, 1e-36, 1e-30], rows.shape[::2])
        b = torch.tensor(size * rng.choice([-1.0, 1.0], rows.shape[::2]) * rng.random(rows.shape[::2]),
                         dtype=torch.float32, device="cuda")
        h = torch.tensor(10.0 ** rng.integers(0, 10, rows.shape[::2]), dtype=torch.float32,
                         device="cuda")
        for c in range(coeffs):
            rows[:, c] = torch.where(tiny, torch.zeros_like(b), rows[:, c])
        rows[:, b_at] = torch.where(tiny, b, rows[:, b_at])
        rows[:, h_at] = torch.where(tiny, h, rows[:, h_at])
    assert (singles[:, 2].abs() < 1.1754944e-38).logical_and(singles[:, 2] != 0).any()
    _solve_matches_plain((singles, pairs, *rest))


_DIV_PROBE = r"""
#include "{csrc}/qp_newton.cu"
namespace {{
// form 0: the fast division and whether its range tests pass; 1: whether
// a fast c1 (a) times a fast residual (b), and minus the residual, are
// fast dividends (1 where the premise fails).
__global__ void div_probe_kernel(const float* a, const float* b, float* out, unsigned char* ok,
                                 long long n, int form) {{
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float inv = 1.0f / b[i];
    if (form == 0) {{
        out[i] = fast_div(a[i], b[i], inv);
        ok[i] = fast_divisor(b[i]) && fast_dividend(a[i]);
    }} else {{
        out[i] = 0.0f;
        ok[i] = !(fast_c1(a[i]) && fast_residual(b[i])) ||
                (fast_dividend(a[i] * b[i]) && fast_dividend(-b[i]));
    }}
}}
}}  // namespace
extern "C" int div_probe(const float* a, const float* b, float* out, unsigned char* ok,
                         long long n, int form) {{
    div_probe_kernel<<<(unsigned)((n + 255) / 256), 256>>>(a, b, out, ok, n, form);
    return (int)cudaDeviceSynchronize();
}}
"""


def test_fast_division_is_the_ieee_quotient_in_its_ranges():
    """The kernel's fast division (a multiply by the reciprocal and one
    correction) against numpy's float32 division, bit for bit, wherever its
    range tests let it stand (elsewhere the kernel divides by IEEE
    division): float32 bit patterns drawn uniformly (every exponent,
    subnormals, infinities and NaN) and operands at the edges of the
    ranges. Operands within 2^-30 to 2^30 always stand, subnormal
    numerators never do. And a fast residual r times a fast c1, and -r,
    are always fast dividends."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    import ctypes

    from sigmarl_tpu_torch.ops import build

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.BUILD_DIR, "div_probe.cu")
    with open(src, "w") as f:
        f.write(_DIV_PROBE.format(csrc=build.CSRC))
    lib = build.build_sources({"div_probe": src})["div_probe"]
    lib.div_probe.restype = ctypes.c_int
    lib.div_probe.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]

    rng = np.random.default_rng(0)
    n = 1 << 22

    def log_uniform(lo, hi):  # magnitudes 2^lo .. 2^hi, random sign
        mag = np.exp2(rng.uniform(lo, hi, n)) * rng.choice([-1.0, 1.0], n)
        return mag.astype(np.float32)

    def probe(a, b, form):
        ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        out = torch.empty_like(ta)
        ok = torch.empty(n, dtype=torch.uint8, device="cuda")
        err = lib.div_probe(ta.data_ptr(), tb.data_ptr(), out.data_ptr(), ok.data_ptr(), n, form)
        assert err == 0, f"CUDA error {err}"
        return out.cpu().numpy(), ok.cpu().numpy().astype(bool)

    bits = lambda: rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)  # noqa: E731
    cases = {
        "ordinary": (log_uniform(-30, 30), log_uniform(-30, 30)),
        "any bits": (bits(), bits()),
        "subnormal numerators": (log_uniform(-149, -126), log_uniform(-30, -3)),
        "numerators near 2^-84": (log_uniform(-88, -80), log_uniform(-42, 42)),
        "numerators near 2^85": (log_uniform(81, 89), log_uniform(-42, 42)),
        "divisors near 2^-40": (log_uniform(-86, 86), log_uniform(-44, -36)),
        "divisors near 2^40": (log_uniform(-86, 86), log_uniform(36, 44)),
        "quotients near 2^-125": (log_uniform(-90, -80), log_uniform(36, 44)),
        "large quotients": (log_uniform(20, 30), log_uniform(-44, -36)),
    }
    with np.errstate(all="ignore"):
        for name, (a, b) in cases.items():
            want = a / b
            got, fast = probe(a, b, 0)
            same = ((got.view(np.uint32) == want.view(np.uint32))
                    | (np.isnan(got) & np.isnan(want)))
            bad = np.flatnonzero(fast & ~same)
            assert bad.size == 0, (name, bad.size, [
                (float(a[i]), float(b[i]), float(got[i]), float(want[i])) for i in bad[:5]])
            if name == "ordinary":
                assert fast.all(), (name, int((~fast).sum()))
            elif name == "subnormal numerators":
                assert not fast[a != 0].any(), name
            else:
                assert fast.any(), name
            _, ok = probe(a, b, 1)
            assert ok.all(), (name, int((~ok).sum()))
        c1, r = log_uniform(-31, 41), log_uniform(-55, 45)
        _, ok = probe(c1, r, 1)
        assert ok.all(), ("products", int((~ok).sum()))


def test_solve_kernel_matches_plain_at_full_batch():
    """The main path's input at B=1024 (cpm_entire, N=15, after a warm-up
    of filtered steps): controls after 0 and 1 iterations to atol 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    Bf = 1024
    p = Parameters(
        scenario_type="cpm_entire", n_agents=N, num_vmas_envs=Bf, dt=0.1, max_steps=1_000_000,
        is_use_mtv_distance=False, is_obs_noise=False, is_using_cbf_testing=True,
        is_using_centralized_cbf=True,
    )
    env = make_env(p, device="cuda")
    cbf = CBFSafetyFilter(CBFConfig(n_agents=N, newton_iters=5, newton_soft_iters=3),
                          env.cfg, env.tables, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    state = zero_state(env.cfg, "cuda")
    for _ in range(6):
        act = (torch.rand((Bf, N, 2), generator=g, device="cuda") - 0.3) * env.action_limits
        state, *_ = cbf_filtered_step(env, cbf, state, act, generator=g)
    act = (torch.rand((Bf, N, 2), generator=g, device="cuda") - 0.3) * env.action_limits
    cons, u_nom, _, _ = cbf.assemble(state, act)
    lo, hi = (cbf.a_min, cbf.rate_min), (cbf.a_max, cbf.rate_max)
    args = (*kernel_inputs(cons, u_nom, lo, hi, state.cbf_u_prev, cbf.cfg.newton_ws_cap),
            (cbf.cfg.w_u_acc, cbf.cfg.w_u_steer), lo, hi)
    _solve_matches_plain(args, budgets=((0, 0, None), (1, 0, None)))


def test_stencil_kernel_gives_nan_for_a_bad_chunk(rollout):
    """A row whose chunk index is out of range gets NaN on that side; every
    other row matches the plain version."""
    env, _, state, g = rollout
    R = B * N
    q = (state.pos.reshape(R, 1, 2)
         + 0.05 * (2 * torch.rand((R, Q, 2), generator=g, device="cuda") - 1)).contiguous()
    pid = state.path_id.reshape(R).contiguous()
    t = env.tables
    p_ref = state.pos.reshape(R, 2)
    sel_l = topk_chunks(t.left_chunk_cc, t.left_chunk_cr, pid, p_ref, 0.1, 3).clone()
    sel_r = topk_chunks(t.right_chunk_cc, t.right_chunk_cr, pid, p_ref, 0.1, 3)
    bad = 5
    n_chunks = t.left_seg.shape[1] // PD_CHUNK
    sel_l[bad, 1] = n_chunks
    dl, dr = pseudo_distance_stencil(q, pid, t.left_seg, t.right_seg, sel_l, sel_r)
    torch.cuda.synchronize()
    assert torch.isnan(dl[bad]).all()
    keep = torch.arange(R, device="cuda") != bad
    ok_l = sel_l.clone()
    ok_l[bad, 1] = 0
    rl, rr = pseudo_distance_stencil_reference(q, pid, t.left_seg, t.right_seg, ok_l, sel_r)
    torch.testing.assert_close(dl[keep], rl[keep], atol=2e-5, rtol=0)
    torch.testing.assert_close(dr, rr, atol=2e-5, rtol=0)


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


@pytest.mark.parametrize("mode", ["grouped", "decentralized"])
def test_solve_kernel_matches_plain_on_filter_modes(rollout, mode):
    """K1 on a real grouped input (groups of at most 4: 2 * 9 pair rows,
    row-varying slack and lambda weights) and a real decentralized input
    (every j-sided coefficient zero), at the trainer's 2+15 budget and
    after 0, 1 and 30 iterations."""
    from sigmarl_tpu_torch.safety.grouping import group_agents_k_nearest

    env, _, state, g = rollout
    kw = dict(max_group_size=4) if mode == "grouped" else dict(decentralized=True)
    cbf = CBFSafetyFilter(CBFConfig(n_agents=N), env.cfg, env.tables, device="cuda", **kw)
    act = (torch.rand((B, N, 2), generator=g, device="cuda") - 0.3) * env.action_limits
    gid = group_agents_k_nearest(state.pos, 4) if mode == "grouped" else None
    cons, u_nom, _, _ = cbf.assemble(state, act, gid)
    if mode == "grouped":
        assert cons.b_p.shape[-1] == 18 and bool(cons.valid_p[..., 9:].any())
        assert cons.wl_p.unique().numel() > 1  # cross rows: lambda_weight
    else:
        assert not bool(cons.A_pj.any())
    lo, hi = (cbf.a_min, cbf.rate_min), (cbf.a_max, cbf.rate_max)
    args = (*kernel_inputs(cons, u_nom, lo, hi, state.cbf_u_prev, cbf.cfg.newton_ws_cap),
            (cbf.cfg.w_u_acc, cbf.cfg.w_u_steer), lo, hi)
    _solve_matches_plain(args, budgets=((0, 0, None), (1, 0, None), (30, 0, 1e-4), (15, 2, 1e-3)))


@pytest.mark.parametrize("mode", ["filtered", "informed", "decentralized"])
def test_training_iteration_launches_on_the_card(tmp_path, mode):
    """One MAPPO iteration on the card (N=4, B=8, T=8): CBF-filtered
    training launches K1 and K2 once per rollout step, CBF-informed
    (margins-only) training K2 once per step and K1 never; losses and the
    next observations are finite."""
    from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    T = 8
    flags = {
        "filtered": dict(is_solve_qp=True, is_apply_cbf_action=True, is_using_centralized_cbf=True),
        "decentralized": dict(is_solve_qp=True, is_apply_cbf_action=True),
        "informed": dict(is_solve_qp=False),
    }[mode]
    p = Parameters(
        scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=8, dt=0.1, max_steps=T, n_iters=2,
        num_epochs=2, minibatch_size=32, is_use_mtv_distance=False, is_obs_noise=False,
        rew_method="cbf", is_using_cbf_training=True, where_to_save=str(tmp_path) + "/",
        device="cuda", **flags,
    )
    tr = MAPPOCAVs(p)
    state = tr.initial_state()
    k1, k2 = newton_solve.launches, pseudo_distance_stencil.launches
    state, m = tr.train_iteration(state)
    torch.cuda.synchronize()
    assert newton_solve.launches - k1 == (0 if mode == "informed" else T)
    assert pseudo_distance_stencil.launches - k2 == T
    assert np.isfinite(float(m["loss_objective"])) and np.isfinite(float(m["loss_critic"]))
    assert bool(torch.isfinite(state.obs).all()) and state.opt_state.count == 4


def test_main_training_on_the_card(tmp_path, capsys):
    from sigmarl_tpu_torch import main_training

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    main_training.main(["--device", "cuda", "--n_iters", "1", "--num_vmas_envs", "4",
                        "--max_steps", "8", "--where_to_save", str(tmp_path) + "/"])
    (d,) = os.listdir(tmp_path)
    assert {"info.txt", "final_policy.pkl", "final_critic.pkl"} <= set(os.listdir(tmp_path / d))
    assert "iter 1/1" in capsys.readouterr().out


def test_xpmarl_propagation_on_the_card_matches_the_cpu():
    """One XP-MARL propagation step (N=4, B=8, communication noise on) on
    the card against the CPU from the same weights and draws: actions,
    log-probabilities and the observations acted on to atol 1e-5."""
    from sigmarl_tpu_torch.rl.networks import PolicyNet
    from sigmarl_tpu_torch.rl.priority import prioritized_action_propagation

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    Bs, Ns, D, K = 8, 4, 30, 2
    g = torch.Generator().manual_seed(5)
    obs = torch.nn.functional.pad(torch.randn((Bs, Ns, D), generator=g), (0, 2 * K))
    rank = torch.stack([torch.randperm(Ns, generator=g) for _ in range(Bs)])
    nearing = torch.randint(0, Ns, (Bs, Ns, K), generator=g)
    noise, comm = torch.randn((Ns, Bs, 2), generator=g), torch.randn((Ns, Bs, 2 * K), generator=g)
    lim = torch.tensor([1.0, 0.54])
    outs = [prioritized_action_propagation(
        PolicyNet(D + 2 * K, device=d, seed=3), *(x.to(d) for x in (obs, rank, nearing, -lim, lim)),
        action_noise=noise.to(d), communication_noise_level=0.1, communication_noise=comm.to(d))
        for d in ("cpu", "cuda")]
    for a, b in zip(outs[1], outs[0]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)


def test_env_step_with_mtv_noise_and_history_on_the_card_matches_the_cpu():
    """One env step with the MTV distance, observation noise and a history
    of 2 (cpm_mixed, N=4, B=8) from the same state, actions and draws:
    rewards and positions to atol 2e-5, observations and history to 1e-4,
    done flags equal."""
    from sigmarl_tpu_torch.env.reset import ResetDraws
    from sigmarl_tpu_torch.env.structs import state_to

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    p = Parameters(scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=8, dt=0.1,
                   max_steps=6, n_observed_steps=2)
    assert p.is_use_mtv_distance and p.is_obs_noise
    env_c, env_g = make_env(p, device="cpu"), make_env(p, device="cuda")
    g = torch.Generator().manual_seed(2)
    state, _ = env_c.reset(generator=g)
    for _ in range(4):
        act = (2 * torch.rand((8, 4, 2), generator=g) - 1) * env_c.action_limits
        state, *_ = env_c.step(state, act, generator=g)
    draws = ResetDraws.sample(env_c.cfg, g, "cpu")
    draws_g = ResetDraws(*(None if x is None else x.cuda() for x in (
        draws.scenario_gumbel, draws.path_u, draws.point_u, draws.speed_u)))
    u = torch.rand((8, 4, env_c.obs_dim), generator=g)
    sc, oc, rc, dc, _ = env_c.step(state, act, reset_draws=draws, obs_noise=u)
    sg, og, rg, dg, _ = env_g.step(state_to(state, torch.device("cuda")), act.cuda(),
                                   reset_draws=draws_g, obs_noise=u.cuda())
    assert bool(dc.any())  # the step resets envs (max_steps), refilling their history
    torch.testing.assert_close(rg.cpu(), rc, atol=2e-5, rtol=0)
    torch.testing.assert_close(sg.pos.cpu(), sc.pos, atol=2e-5, rtol=0)
    torch.testing.assert_close(og.cpu(), oc, atol=1e-4, rtol=0)
    torch.testing.assert_close(sg.obs_history.cpu(), sc.obs_history, atol=1e-4, rtol=0)
    assert torch.equal(dg.cpu(), dc)


def test_xpmarl_iteration_on_the_card(tmp_path):
    """One learned-priority XP-MARL iteration on the card (cpm_mixed, N=4,
    B=8, T=8, communication noise, the defaults' MTV distance and noise):
    finite losses, the priority loss included, no kernel launched."""
    from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    p = Parameters(scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=8, dt=0.1, max_steps=8,
                   n_iters=2, num_epochs=2, minibatch_size=32, is_using_prioritized_marl=True,
                   is_communication_noise=True, where_to_save=str(tmp_path) + "/", device="cuda")
    tr = MAPPOCAVs(p)
    state = tr.initial_state()
    k1, k2 = newton_solve.launches, pseudo_distance_stencil.launches
    state, m = tr.train_iteration(state)
    torch.cuda.synchronize()
    assert (newton_solve.launches, pseudo_distance_stencil.launches) == (k1, k2)
    for k in ("loss_objective", "loss_critic", "loss_priority"):
        assert np.isfinite(float(m[k])), k
    assert bool(torch.isfinite(state.obs).all()) and state.opt_state.count == 4


def _clf_live(N, Bc, C=3, scenario="cpm_mixed", **cbf_kw):
    """A testing-mode env (CLF nominal controller, C circles) and its filter
    on the card, and a live state after 4 filtered steps from a reset."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    p = Parameters(
        scenario_type=scenario, n_agents=N, num_vmas_envs=Bc, dt=0.1, max_steps=1_000_000,
        is_testing_mode=True, is_use_mtv_distance=False, is_obs_noise=False,
        is_using_cbf_testing=True, nom_controller_type="clf", n_circles_approximate_vehicle=C,
    )
    env = make_env(p, device="cuda")
    cbf = CBFSafetyFilter(CBFConfig(n_agents=N, n_circles=C, nom_controller_type="clf", **cbf_kw),
                          env.cfg, env.tables, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(N + C)
    state, _ = env.reset(generator=g)
    act = torch.zeros((Bc, N, 2), device="cuda")
    for _ in range(4):
        state, *_ = cbf_filtered_step(env, cbf, state, act, generator=g)
    return env, cbf, state, g


def _kernel_args(cbf, cons, u_nom, state):
    lo, hi = (cbf.a_min, cbf.rate_min), (cbf.a_max, cbf.rate_max)
    return (*kernel_inputs(cons, u_nom, lo, hi, state.cbf_u_prev, cbf.cfg.newton_ws_cap),
            (cbf.cfg.w_u_acc, cbf.cfg.w_u_steer), lo, hi)


def _solve_matches_plain_exactly(args):
    """Controls after 0 and 1 iterations bit for bit; F at 30 iterations
    to a relative 1e-4 and at the 3+5 budget to 1e-3, with controls
    finite."""
    for it in (0, 1):
        u_k, _ = newton_solve(*args, it)
        u_p, _ = newton_solve_reference(*args, it)
        torch.cuda.synchronize()
        assert torch.equal(u_k, u_p), (it, float((u_k - u_p).abs().max()))
    _solve_matches_plain(args, budgets=((30, 0, 1e-4), (5, 3, 1e-3)))


@pytest.mark.parametrize("C", [1, 2, 3, 4, 5])
def test_solve_kernel_at_one_agent(C):
    """The ITSC'25 sweep's input: one agent (no pair rows, P = 0, 2x2
    systems) with 2C lane rows and 2 active CLF rows, near-zero CLF rows
    included."""
    env, cbf, state, g = _clf_live(1, 32, C)
    cons, u_nom, _, _ = cbf.assemble(state, torch.zeros((32, 1, 2), device="cuda"))
    assert cons.b_p.shape[1] == 0 and cons.b_s.shape[-1] == 2 * C + 2
    args = _kernel_args(cbf, near_zero_clf_rows(cons, cbf.cfg.lam_clf, C), u_nom, state)
    assert args[1].shape == (32, 8, 0)
    _solve_matches_plain_exactly(args)


@pytest.mark.parametrize("N, scenario", [(4, "cpm_mixed"), (15, "cpm_entire")])
def test_solve_kernel_with_active_clf_rows(N, scenario):
    """CLF rows valid with slack weight 1 (after normalization from ~1e-12
    to 3e6), a third of them near zero on purpose."""
    env, cbf, state, g = _clf_live(N, 32, 3, scenario)
    cons, u_nom, _, _ = cbf.assemble(state, torch.zeros((32, N, 2), device="cuda"))
    assert bool(cons.valid_s[:, :, -2:].all())
    cons = near_zero_clf_rows(cons, cbf.cfg.lam_clf, N)
    _solve_matches_plain_exactly(_kernel_args(cbf, cons, u_nom, state))


def test_solve_kernel_refuses_more_shared_memory_than_a_block_has():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    with pytest.raises(ValueError, match="shared memory"):
        newton_solve(*_synthetic_qp(2, 40, 12, 25, seed=1), 1)


@pytest.mark.parametrize("C, window", [(1, False), (5, False), (3, True)])
def test_stencil_kernel_at_one_and_five_circles_and_windows(C, window):
    """K2 bit for bit against its plain version at C*9 = 9 and 45 queries
    per row, and with the chunks of each row's window around its closest
    boundary vertex as the selection (pd_topk_chunks = 0)."""
    kw = dict(use_windowed_pseudo_distance=True, pd_topk_chunks=0) if window else {}
    env, cbf, state, g = _clf_live(4, 32, C, **kw)
    from sigmarl_tpu_torch.safety.circles import circle_centers_world

    centers = circle_centers_world(cbf.approx, state.pos, state.rot)
    q, pid, cl, cr = cbf.stencil_inputs(centers, state.path_id, state.idx_left, state.idx_right)
    assert q.shape[1] == 9 * C and cl.shape[1] == (6 if window else 3)
    before = pseudo_distance_stencil.launches
    out = pseudo_distance_stencil(q, pid, env.tables.left_seg, env.tables.right_seg, cl, cr)
    ref = pseudo_distance_stencil_reference(q, pid, env.tables.left_seg, env.tables.right_seg, cl, cr)
    torch.cuda.synchronize()
    assert pseudo_distance_stencil.launches == before + 1
    for a, b in zip(out, ref):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())


def test_testing_clf_fp16_step_on_the_card_matches_the_cpu():
    """One testing-mode, CLF-filtered, fp16-parity step (cpm_mixed, N=4,
    B=8) from the same state and draws on the card and the CPU, to the
    tolerances of `utils/card_checks.py::clf_step_card_vs_cpu`: CLF rows
    and nominal input 1e-5; lane rows 1e-4 except where the two devices'
    float16 distances differ (at most 1 % of entries); the card's F within a
    relative 1e-3 of the CPU's; the env step 2e-5 / 1e-4, done equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    checks = clf_step_card_vs_cpu("cuda")
    assert all(c.ok for c in checks), [c for c in checks if not c.ok]


def test_challenge_buffer_record_and_replay_on_the_card_match_the_cpu():
    """Two steps with the challenge buffer on (cpm_mixed, N=4, B=8, a ring
    of 3 slots, every env recording in the first and replaying) from the
    same state and draws on the card and the CPU, to the tolerances of
    `utils/card_checks.py::challenge_buffer_steps_card_vs_cpu`: the buffer,
    its pointers, the record and replay counts and the done flags equal;
    positions and rewards 2e-5, observations 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    checks = challenge_buffer_steps_card_vs_cpu("cuda")
    assert all(c.ok for c in checks), [c for c in checks if not c.ok]


def test_compacted_reset_on_the_card_matches_the_cpu():
    """Steps at B=1024 (cpm_entire, N=4) from the same state and draws on
    the card and the CPU, two whose spawn is compacted (about 23 % of the
    envs reset) and one at full width (half of them), to the tolerances
    of `utils/card_checks.py::compact_reset_card_vs_cpu`: the same branch,
    done flags and ids equal, positions and rewards 2e-5, observations
    1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    checks = compact_reset_card_vs_cpu("cuda")
    assert all(c.ok for c in checks), [c for c in checks if not c.ok]


def test_one_rank_nccl_iteration_matches_the_unsharded_one():
    """The CBF-filtered iteration with the challenge buffer on (cpm_entire,
    N=15, B=64, T=8) on a 1-rank nccl group (`parallel/mesh.py`) against the
    same iteration in this process from the same start and draws, drawn
    once on the card: the checks of
    `utils/card_checks.py::sharded_vs_unsharded` (integer fields and flags
    equal, floats within 1e-3, the parameter rule, K1 and K2 once per
    rollout step), as `chip_smoke.py` holds them at full width."""
    from sigmarl_tpu_torch.parallel.dryrun import spawn_ranks
    from sigmarl_tpu_torch.utils.card_checks import (
        sharded_iteration_rank,
        sharded_vs_unsharded,
        unsharded_iteration,
    )

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    kw = dict(scenario_type="cpm_entire", n_agents=15, num_vmas_envs=64, dt=0.1, max_steps=8,
              num_epochs=1, minibatch_size=256, is_use_mtv_distance=False, is_obs_noise=False,
              rew_method="cbf", is_using_cbf_training=True, is_solve_qp=True,
              is_apply_cbf_action=True, is_using_centralized_cbf=True,
              is_challenging_initial_state_buffer=True, where_to_save="unused/")
    ref = unsharded_iteration(kw, seed=3)
    ranks = spawn_ranks(sharded_iteration_rank, 1, kw, ref["start"], ref["draws"],
                        backend="nccl", device="cuda:0")
    bad = [c for c in sharded_vs_unsharded(ref, ranks, "1-rank nccl") if not c.ok]
    assert not bad, bad


def test_warm_start_certificate_at_the_fixture():
    """`check_warm_start`'s certificate at its N=4, B=4 fixture (6 warm
    iterations, the cold 2+30 oracle, 10 stress steps) on the card: the
    stress rollout draws on the host, so the card's reset state is the
    CPU's bit for bit and the card's default generator stays untouched;
    JAX's keys, 40 instances, and ok (max gap below 1e-3). Also every
    instance whose warm solve ends above 1e-3 of the oracle (none when
    ok) is the warm budget's, not the kernel's: K1 ends where its plain
    version ends on the same rows, and more iterations from the same
    start, or the float64 dense oracle, reach the oracle's objective."""
    import dataclasses

    from sigmarl_tpu_torch import check_warm_start
    from sigmarl_tpu_torch.utils.certificate_tail import explain, plain_agrees

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    args = (4, 4, 6, 0, 10.0, 30)
    card = check_warm_start.stress_setup(*args, device="cuda")[3]
    host = check_warm_start.stress_setup(*args, device="cpu")[3]
    for f in dataclasses.fields(card):
        assert torch.equal(getattr(card, f.name).cpu(), getattr(host, f.name)), f.name
    rng = torch.cuda.get_rng_state()
    line, _ = check_warm_start.certificate(device="cuda")
    assert torch.equal(rng, torch.cuda.get_rng_state())
    assert {"check", "backend", "max_objective_gap", "gap_quantiles", "n_instances",
            "max_u_dev", "ok"} <= set(line)
    assert line["backend"] == torch.cuda.get_device_name(0) and line["n_instances"] == 40
    assert line["ok"], line
    rows = explain(device="cuda")
    assert len(rows) == round(line["gap_quantiles"]["frac_above_1e3"] * 40)
    for r in rows:
        assert plain_agrees(r), r
        assert min(r["gap_long"], r["gap_dense64"]) <= check_warm_start.GAP_LIMIT, r


def test_bench_scaling_on_one_card():
    """`python -m sigmarl_tpu_torch.bench_scaling` at a small size (16 envs
    per rank, N=15, T=4, one timed chunk): 1 rank over nccl, 2 ranks
    sharing `cuda:0` over gloo. Each rank launches each kernel once per
    step, 2 collectives per step, a finite reward; the 2-rank row and the
    summary measure mechanics on one card, with the card's name in each
    row."""
    import math

    from sigmarl_tpu_torch import bench_scaling

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    lines = bench_scaling.launch(bench_scaling.parse_args(
        ["--per_device_batch", "16", "--steps", "4", "--chunks", "1"]))
    rows, summary = lines[:-1], lines[-1]
    cards = torch.cuda.device_count()
    assert [r["global_devices"] for r in rows] == summary["sizes"] == [1, 2]
    for r in rows:
        W = r["global_devices"]
        assert (r["backend"], r["cards"], r["mechanics"]) == (
            ("nccl", W, False) if W <= cards else ("gloo", 1, True))
        assert r["launches"] == [{"qp_newton": 8, "boundary_stencil": 8}] * W
        assert r["collectives_per_step"] == 2 and math.isfinite(r["reward"])
        assert r["batch"] == 16 * W and torch.cuda.get_device_name(0) in r["device"]
    assert summary["efficiency_vs_1dev"][0] == 1.0 and summary["mechanics"] == (cards < 2)
