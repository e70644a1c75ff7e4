"""The port's CUDA kernels against their plain versions on the card, at
rollout-like sizes and on the evaluation path's inputs (one agent, active
CLF rows, one to five circles, window selections), the kernels' launches
in training iterations, the training entry point, and steps, a PPO
update and the host tools on the card against the CPU (the challenge
buffer's record and replay included). Every test here needs a CUDA
device (marker `gpu`) and skips without one. The file imports no JAX, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.env.env import make_env
from sigmarl_tpu_torch.env.structs import zero_state
from sigmarl_tpu_torch.ops import launch_counts
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


def k1_launches() -> int:
    return launch_counts()["qp_newton"]


def k2_launches() -> int:
    return launch_counts()["boundary_stencil"]


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
        before = k2_launches()
        out = pseudo_distance_stencil(q, pid, t.left_seg, t.right_seg, *chunks)
        ref = pseudo_distance_stencil_reference(q, pid, t.left_seg, t.right_seg, *chunks)
        torch.cuda.synchronize()
        assert k2_launches() == before + 1
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
    before = k2_launches()
    with pytest.raises(ValueError, match="128 queries"):
        pseudo_distance_stencil(q, pid, t.left_seg, t.right_seg)
    chunks = torch.zeros((R, 17), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16 chunks"):
        pseudo_distance_stencil(q[:, :Q].contiguous(), pid, t.left_seg, t.right_seg, chunks, chunks)
    assert k2_launches() == before


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
        before = k1_launches()
        u_k, F_k = newton_solve(*args, it, soft_iters=soft)
        u_p, F_p = newton_solve_reference(*args, it, soft_iters=soft)
        torch.cuda.synchronize()
        assert k1_launches() == before + 1
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
        before = k1_launches()
        u_k, F_k = newton_solve(*args, it, soft_iters=soft)
        u_p, F_p = newton_solve_reference(*args, it, soft_iters=soft)
        torch.cuda.synchronize()
        assert k1_launches() == before + 1
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


def test_the_ieee_resolve_count_changes_no_output_bit(monkeypatch):
    """K1 counts on the card the envs it solves again with IEEE divisions
    (`ops/qp.py::collect_ieee_resolves`), and the count changes none of its
    outputs: an input inside the fast division's ranges counts 0 a launch;
    the same input with one env's divisor planted out of range (a valid
    row's h of 1e13, past 2^40) counts exactly 1 a launch, at every budget;
    a launch given no counter buffer gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    from sigmarl_tpu_torch.ops import qp
    from sigmarl_tpu_torch.ops.qp import collect_ieee_resolves

    singles, pairs, *rest = _synthetic_qp(64, 15, 8, 9, seed=11)
    planted = singles.clone()
    row = int(torch.nonzero(planted[5, 4] > 0)[0])
    planted[5, 3, row] = 1e13
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    collect_ieee_resolves()
    for rows, want in ((singles, 0), (planted, 1)):
        args = (rows, pairs, *rest)
        for it, soft in ((0, 0), (15, 2), (5, 3)):
            u_c, F_c = newton_solve(*args, it, soft_iters=soft)
            assert collect_ieee_resolves() == want, (want, it, soft)
            with monkeypatch.context() as m:
                m.setattr(qp, "_ieee_buffer", lambda device: None)
                u_n, F_n = newton_solve(*args, it, soft_iters=soft)
            assert collect_ieee_resolves() == 0
            assert torch.equal(bits(u_c), bits(u_n)) and torch.equal(bits(F_c), bits(F_n))
            assert torch.isfinite(u_c).all() and torch.isfinite(F_c).all()


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
    k1, k2 = k1_launches(), k2_launches()
    state, obs, rew, done, info = cbf_filtered_step(env, cbf, state, act, generator=g)
    torch.cuda.synchronize()
    assert k1_launches() == k1 + 1
    assert k2_launches() == k2 + 1
    assert torch.isfinite(obs).all() and torch.isfinite(rew).all()
    assert obs.shape == (B, N, env.obs_dim) and np.isfinite(info["cbf_max_violation"].cpu()).all()


def test_main_path_step_at_b8_on_the_card_matches_the_cpu():
    """The main path (cpm_entire, N=15, centralized filter at 3+5) at B=8
    on the card against the CPU path (the kernels' plain versions), from
    the same state with the same draws:

    - the assembled constraint rows to atol 1e-4, relative 1e-5 (the two
      devices round sines and square roots apart);
    - the card's solution no worse than the CPU's: its objective on the
      CPU's rows within a relative 1e-3 above the CPU's. Not symmetric: the
      solver has non-optimal fixed points, which rounding can enter on one
      device and miss on the other (this input: on the CPU one env stops
      at F = 26.286 against an optimum of 12.259, see
      `scripts/qp_conditioning_probe.py`);
    - the env step from the same applied actions: rewards and positions to
      atol 2e-5, observations to 1e-4, done flags equal."""
    from sigmarl_tpu_torch.env.reset import ResetDraws
    from sigmarl_tpu_torch.env.structs import state_to

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    Bs = 8
    p = Parameters(
        scenario_type="cpm_entire", n_agents=N, num_vmas_envs=Bs, dt=0.1, max_steps=1_000_000,
        is_use_mtv_distance=False, is_obs_noise=False, is_using_cbf_testing=True,
        is_using_centralized_cbf=True,
    )
    ccfg = CBFConfig(n_agents=N, n_circles=3, dt=0.1, newton_iters=5, newton_soft_iters=3)
    env_c, env_g = make_env(p, device="cpu"), make_env(p, device="cuda")
    cbf_c = CBFSafetyFilter(ccfg, env_c.cfg, env_c.tables, device="cpu")
    cbf_g = CBFSafetyFilter(ccfg, env_g.cfg, env_g.tables, device="cuda")
    gen = torch.Generator().manual_seed(3)
    lim = env_c.action_limits
    state, _ = env_c.reset(generator=gen)
    for _ in range(3):
        act = (2 * torch.rand((Bs, N, 2), generator=gen) - 1) * lim
        state, *_ = cbf_filtered_step(env_c, cbf_c, state, act, generator=gen)
    act = (2 * torch.rand((Bs, N, 2), generator=gen) - 1) * lim
    draws = ResetDraws.sample(env_c.cfg, gen, "cpu")
    draws_g = ResetDraws(None, draws.path_u.cuda(), draws.point_u.cuda(), draws.speed_u.cuda())
    sg, act_g = state_to(state, torch.device("cuda")), act.cuda()

    cons, u_nom, _, _ = cbf_c.assemble(state, act)
    cons_g, _, _, _ = cbf_g.assemble(sg, act_g)
    for f in ("A_s", "b_s", "h_s", "A_pi", "A_pj", "b_p", "h_p", "ws_s", "ws_p"):
        torch.testing.assert_close(getattr(cons_g, f).cpu(), getattr(cons, f), atol=1e-4,
                                   rtol=1e-5, msg=f)

    lo, hi = (cbf_c.a_min, cbf_c.rate_min), (cbf_c.a_max, cbf_c.rate_max)
    w_u = (ccfg.w_u_acc, ccfg.w_u_steer)

    def F(u):
        a = kernel_inputs(cons, u_nom, lo, hi, u, ccfg.newton_ws_cap)
        return newton_solve_reference(a[0], a[1], a[3], a[3], *a[4:], w_u, lo, hi, 0)[1].double()

    fc = cbf_c.filter_actions(state, act, u_init=state.cbf_u_prev)
    fg = cbf_g.filter_actions(sg, act_g, u_init=sg.cbf_u_prev)
    F_c, F_g = F(fc.u_star), F(fg.u_star.cpu())
    worse = float(((F_g - F_c) / (1.0 + F_c.abs())).max())
    assert worse < 1e-3, worse

    sc, obs_c, rew_c, done_c, _ = env_c.step(state, fc.safe_actions, reset_draws=draws)
    sg2, obs_g, rew_g, done_g, _ = env_g.step(sg, fc.safe_actions.cuda(), reset_draws=draws_g)
    torch.testing.assert_close(rew_g.cpu(), rew_c, atol=2e-5, rtol=0)
    torch.testing.assert_close(sg2.pos.cpu(), sc.pos, atol=2e-5, rtol=0)
    torch.testing.assert_close(obs_g.cpu(), obs_c, atol=1e-4, rtol=0)
    assert torch.equal(done_g.cpu(), done_c)
    assert obs_g.shape == (Bs, N, env_g.obs_dim)


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
    k1, k2 = k1_launches(), k2_launches()
    state, m = tr.train_iteration(state)
    torch.cuda.synchronize()
    assert k1_launches() - k1 == (0 if mode == "informed" else T)
    assert k2_launches() - k2 == T
    assert np.isfinite(float(m["loss_objective"])) and np.isfinite(float(m["loss_critic"]))
    assert bool(torch.isfinite(state.obs).all()) and state.opt_state.count == 4


@pytest.mark.parametrize("config", ["learning_curve", "learned_priority", "learning_curve_full"])
def test_update_graph_replays_equal_the_eager_update(tmp_path, config):
    """The learning curve's configuration (cpm_mixed, N=4, B=128, 30
    epochs of minibatch 512, observation noise on, entropy_eps 4e-3) at
    T=8 for two iterations, the same with learned priority (four
    networks), and at its full T=128 (960 minibatch updates) for one
    iteration: each iteration rolled out once and updated twice from the
    same frames and draws, by the trainer's CUDA graph and by the same
    program run eagerly (`update_graph=False`). Parameters, moments and
    loss statistics equal bit for bit, the replays run under
    `torch.cuda.set_sync_debug_mode("error")` (no host sync), and no
    kernel of the filter is launched."""
    from sigmarl_tpu_torch import learning_curve
    from sigmarl_tpu_torch.ops import launch_counts
    from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs
    from sigmarl_tpu_torch.utils.card_checks import update_graph_vs_eager

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    extra = dict(is_using_prioritized_marl=True, prioritization_method="marl")
    T, iters = (128, 1) if config == "learning_curve_full" else (8, 2)
    p = learning_curve.parameters(2, 0, "cuda", str(tmp_path) + "/", max_steps=T,
                                  **(extra if config == "learned_priority" else {}))
    graph_tr, eager_tr = MAPPOCAVs(p), MAPPOCAVs(p, update_graph=False)
    assert graph_tr.update_graph and not eager_tr.update_graph
    assert graph_tr.n_minibatches == T // 4 and graph_tr.updates_per_iter == 30 * T // 4
    state = graph_tr.initial_state()
    gen = torch.Generator(device="cuda").manual_seed(4)
    before = launch_counts()
    for i in range(iters):
        r = update_graph_vs_eager(graph_tr, eager_tr, state, gen, sync_mode="error")
        assert r["equal"], (i, r["max_abs_diff"])
        assert all(np.isfinite(v) for v in r["stats"].values())
        state = r["state"]
    launched = launch_counts(since=before)
    assert launched["qp_newton"] == 0 and launched["boundary_stencil"] == 0, launched
    assert state.opt_state.count == iters * graph_tr.updates_per_iter
    assert graph_tr.program.graph is not None


def test_census_on_the_card_counts_the_cpus_rollout():
    """`bench.py --census` at a small size (B=16, N=15, one warm-up step
    from the all-zero state, 4 counted steps): the census draws from a
    host generator, so the card starts from the CPU's instances. The first
    step resets every env: the spawns' integer fields (paths, points,
    flags) equal bit for bit; the resetting envs of every counted step
    equal, and the card repeats its own census. Past this the two part:
    after 4 warm-up steps at the 8th step, where one agent's lanelet test
    differs with positions 1.55 mm apart, as the filter's float32 solve
    turns rounding differences into millimetres; two CPU builds of
    PyTorch part at the 4th (`utils/census_parity.py`)."""
    from sigmarl_tpu_torch import bench

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    first = {}
    for d in ("cuda", "cpu"):
        env, cbf, policy, gen, state, obs = bench.main_path(16, 15, d, draws_on="cpu")
        (s,), *_ = bench.rollout_chunk(env, cbf, policy, [state], [obs], [gen], 1)
        first[d] = {f.name: getattr(s, f.name).cpu() for f in dataclasses.fields(s)
                    if not getattr(s, f.name).is_floating_point()}
    for k, v in first["cpu"].items():
        assert torch.equal(first["cuda"][k], v), k
    card, again, host = (bench.census(16, steps=4, T=1, device=d) for d in ("cuda", "cuda", "cpu"))
    assert card["counts"] == again["counts"] == host["counts"] and sum(host["counts"]) > 0


def test_main_training_on_the_card(tmp_path, capsys):
    from sigmarl_tpu_torch import main_training

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    main_training.main(["--device", "cuda", "--n_iters", "1", "--num_vmas_envs", "4",
                        "--max_steps", "8", "--where_to_save", str(tmp_path) + "/"])
    (d,) = os.listdir(tmp_path)
    assert {"info.txt", "final_policy.pkl", "final_critic.pkl"} <= set(os.listdir(tmp_path / d))
    assert "iter 1/1" in capsys.readouterr().out


def test_ppo_minibatch_update_on_the_card_matches_the_cpu():
    """One PPO minibatch update on the card against the CPU at a small
    size (cpm_mixed, N=4, the 3x256 networks, 64 frames), from the same
    weights, minibatch and entropy noise: the loss to a relative 1e-5, the
    gradients to atol 1e-5 and relative 1e-4, and the updated parameters to
    atol 1e-6 wherever both gradients exceed 1e-6 in magnitude (elsewhere
    Adam's first step is +-lr by the gradient's sign, which may part)."""
    from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs
    from sigmarl_tpu_torch.rl.networks import tanh_normal_sample

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=4, dt=0.1, max_steps=16,
              n_iters=2, num_epochs=1, minibatch_size=64, is_use_mtv_distance=False,
              is_obs_noise=False)
    trs = {d: MAPPOCAVs(Parameters(**kw, device=d)) for d in ("cpu", "cuda")}
    g = torch.Generator().manual_seed(7)
    D = trs["cpu"].env.obs_dim
    mb = {"obs": torch.randn((64, 4, D), generator=g)}
    with torch.no_grad():
        loc, scale = trs["cpu"].policy_net(mb["obs"])
        mb["action"], mb["log_prob"] = tanh_normal_sample(
            loc, scale, trs["cpu"].low, trs["cpu"].high, generator=g)
    mb["log_prob"] = mb["log_prob"] + 0.1 * torch.randn((64, 4), generator=g)
    mb["adv"], mb["vt"] = torch.randn((64, 4), generator=g), torch.randn((64, 4), generator=g)
    noise = torch.randn((64, 4, 2), generator=g)
    res = {}
    for d, tr in trs.items():
        params = tr.parameter_list()
        total, _ = tr.loss(tr.networks(), {k: v.to(d) for k, v in mb.items()}, noise.to(d))
        grads = torch.autograd.grad(total, params)
        before = [t.detach().clone() for t in params]
        tr.optimizer.step(params, grads, tr.optimizer.init(params))
        res[d] = (float(total.detach()), [x.cpu() for x in grads],
                  [t.detach().cpu() for t in params], [t.cpu() for t in before])
    (lc, gc, pc, bc), (lg, gg, pg, bg) = res["cpu"], res["cuda"]
    assert all(torch.equal(a, b) for a, b in zip(bc, bg)), "the two trainers start apart"
    assert abs(lg - lc) / abs(lc) < 1e-5, (lg, lc)
    for a, b in zip(gg, gc):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    p_err = max(float(torch.where((a.abs() > 1e-6) & (b.abs() > 1e-6), (x - y).abs(), 0.0).max())
                for a, b, x, y in zip(gg, gc, pg, pc))
    assert p_err <= 1e-6, p_err


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


@pytest.mark.parametrize("N, scenario", [(4, "cpm_mixed"), (15, "cpm_entire")])
def test_env_step_with_mtv_noise_and_history_on_the_card_matches_the_cpu(N, scenario):
    """One env step with the MTV distance, observation noise and a history
    of 2 (cpm_mixed at N=4, cpm_entire at N=15; B=8) from the same state,
    actions and draws: rewards and positions to atol 2e-5, observations
    and history to 1e-4, done flags equal."""
    from sigmarl_tpu_torch.env.reset import ResetDraws
    from sigmarl_tpu_torch.env.structs import state_to

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    p = Parameters(scenario_type=scenario, n_agents=N, num_vmas_envs=8, dt=0.1,
                   max_steps=6, n_observed_steps=2)
    assert p.is_use_mtv_distance and p.is_obs_noise
    env_c, env_g = make_env(p, device="cpu"), make_env(p, device="cuda")
    g = torch.Generator().manual_seed(2)
    state, _ = env_c.reset(generator=g)
    for _ in range(4):
        act = (2 * torch.rand((8, N, 2), generator=g) - 1) * env_c.action_limits
        state, *_ = env_c.step(state, act, generator=g)
    draws = ResetDraws.sample(env_c.cfg, g, "cpu")
    draws_g = ResetDraws(*(None if x is None else x.cuda() for x in (
        draws.scenario_gumbel, draws.path_u, draws.point_u, draws.speed_u)))
    u = torch.rand((8, N, env_c.obs_dim), generator=g)
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
    k1, k2 = k1_launches(), k2_launches()
    state, m = tr.train_iteration(state)
    torch.cuda.synchronize()
    assert (k1_launches(), k2_launches()) == (k1, k2)
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

    centers = circle_centers_world(cbf.centers_local, state.pos, state.rot)
    q, pid, cl, cr = cbf.stencil_inputs(centers, state.path_id, state.idx_left, state.idx_right)
    assert q.shape[1] == 9 * C and cl.shape[1] == (6 if window else 3)
    before = k2_launches()
    out = pseudo_distance_stencil(q, pid, env.tables.left_seg, env.tables.right_seg, cl, cr)
    ref = pseudo_distance_stencil_reference(q, pid, env.tables.left_seg, env.tables.right_seg, cl, cr)
    torch.cuda.synchronize()
    assert k2_launches() == before + 1
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


def test_compacted_reset_is_the_full_width_reset_on_the_card():
    """`apply_reset` on the main path's env and a live state (cpm_entire,
    N=15, B=1024, after 8 filtered steps) with one seeded mask of about
    23 % of the envs, whole envs as the main path resets them: the
    compacted spawn gives the state that the full-width spawn gives from
    draws carrying the compacted rows in the resetting envs' rows, every
    field bit for bit."""
    from sigmarl_tpu_torch.bench import filtered_step, main_path
    from sigmarl_tpu_torch.env.reset import ResetDraws, apply_reset, compact_slots

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    Bf = 1024
    env, cbf, policy, gen, state, obs = main_path(Bf, N, "cuda")
    for _ in range(8):
        state, obs, *_ = filtered_step(env, cbf, policy, state, obs, gen)
    g = torch.Generator(device="cuda").manual_seed(23)
    env_any = torch.rand((Bf,), generator=g, device="cuda") < 0.23
    mask = env_any[:, None].expand(Bf, N).contiguous()
    k, slots = int(env_any.sum()), compact_slots(Bf, False)
    assert 0 < k <= slots
    draws = ResetDraws.sample(env.cfg, g, "cuda", compact_slots=slots)
    rows = env_any.nonzero()[:, 0]
    draws.path_u[rows] = draws.path_u_c[:k]
    draws.point_u[rows] = draws.point_u_c[:k]
    compacted = apply_reset(env.cfg, env.tables, state, mask, draws, compact=(0, k))
    full = apply_reset(env.cfg, env.tables, state, mask, draws)
    differ = [f.name for f in dataclasses.fields(full)
              if not torch.equal(getattr(compacted, f.name), getattr(full, f.name))]
    assert not differ, differ


def _spawn_case(case: str, seed: int = 0):
    """(cfg, tables, path_u, point_u, scenario_id, prev_pos, reset_mask,
    compact) on the card for one case of the spawn kernel: the previous
    positions of a reset from the seed, then the case's mask and draws."""
    scenario, n, b, testing = {
        "mixed_partial": ("cpm_mixed", 4, 128, False),
        "testing": ("cpm_entire", 15, 256, True),
        "infeasible": ("cpm_entire", 15, 64, False),
        "threshold": ("cpm_entire", 2, 512, False),
    }.get(case, ("cpm_entire", N, 1024, False))
    p = Parameters(scenario_type=scenario, n_agents=n, num_vmas_envs=b, dt=0.1,
                   max_steps=1_000_000, is_use_mtv_distance=False, is_obs_noise=False,
                   is_testing_mode=testing)
    env = make_env(p, device="cuda")
    cfg, tables = env.cfg, env.tables
    g = torch.Generator(device="cuda").manual_seed(seed)
    state, _ = env.reset(generator=g)
    T = cfg.max_spawn_tries
    pos, sid = state.pos, state.scenario_id[:, 0].contiguous()
    compact = None
    if case.startswith("entire"):
        # Whole envs reset, about 16 % of them, as the main path's mask.
        # (None in one case: a rank whose envs do not reset.)
        share = 0.0 if case == "entire_none" else 0.16
        env_any = torch.rand((b,), generator=g, device="cuda") < share
        mask = env_any[:, None].expand(b, n)
        k = int(env_any.sum())
        if case != "entire_full":
            first = {"entire_compact": 0, "entire_none": 10}.get(case, 384 - k - 7)
            compact = (first, k)
        rows = 384 if compact else b
    else:
        mask = torch.rand((b, n), generator=g, device="cuda") < 0.3
        mask[: b // 4] = True  # whole-env resets too
        rows = b
    if case == "mixed_partial":
        sid = torch.randint(1, 4, (b,), generator=g, device="cuda", dtype=torch.int32)
    if case == "infeasible":
        cfg = dataclasses.replace(cfg, reset_agent_min_distance=50.0)
    path_u = torch.rand((rows, n, T), generator=g, device="cuda")
    point_u = torch.rand((rows, n, T), generator=g, device="cuda")
    if case == "threshold":
        pos, mask = _near_threshold(cfg, tables, path_u, point_u, sid, pos)
    if case == "entire_compact_first":  # positions sliced from a wider tensor
        pos = torch.cat([pos.flip(-1), pos], -1)[..., 2:]
    return cfg, tables, path_u, point_u, sid, pos, mask, compact


def _near_threshold(cfg, tables, path_u, point_u, sid, pos):
    """Agent 0 resets and agent 1 keeps a position at which agent 0's first
    candidate lies at a squared distance, as float32 rounds it, of one ulp
    below the threshold, the threshold, or one ulp above (by env)."""
    c = _candidates(cfg, tables, path_u, point_u, sid)[2][:, 0, 0].cpu().numpy()  # [B, 2]
    thr = np.float32(cfg.reset_agent_min_distance ** 2)
    targets = [np.nextafter(thr, np.float32(0)), thr, np.nextafter(thr, np.float32(1))]
    k = np.arange(-60, 61, dtype=np.float32)
    out = pos.cpu().numpy().copy()
    hit = np.zeros(len(c), bool)
    for b, (cx, cy) in enumerate(c):
        # Offsets (dx, 0.3 m) with dx^2 + 0.09 about the threshold, then
        # steps of one ulp of each coordinate of the kept position.
        px0 = np.float32(cx - np.sqrt(np.float64(thr) - 0.09))
        py0 = np.float32(cy - 0.3)
        px = px0 + k * np.spacing(px0)
        py = py0 + k * np.spacing(py0)
        dx = (np.float32(cx) - px)[:, None]
        dy = (np.float32(cy) - py)[None, :]
        d2 = (dx * dx) + (dy * dy)
        i, j = np.nonzero(d2 == targets[b % 3])
        if len(i):
            out[b, 1] = (px[i[0]], py[j[0]])
            hit[b] = True
    assert hit.mean() > 0.9, hit.mean()
    mask = torch.zeros(pos.shape[:2], dtype=torch.bool, device="cuda")
    mask[:, 0] = True
    return torch.from_numpy(out).cuda(), mask


SPAWN_CASES = ["entire_compact", "entire_compact_first", "entire_none", "entire_full",
               "mixed_partial", "testing", "infeasible", "threshold"]


@pytest.mark.parametrize("case", SPAWN_CASES)
def test_spawn_kernel_matches_plain_bit_for_bit(case):
    """K3 against the plain spawn on the card, every output equal: cpm_entire
    N=15 whole-env resets compacted from row 0 and from a later row (with
    positions sliced from a wider tensor), none (a rank whose envs do not
    reset), and at full width; cpm_mixed N=4
    with partial masks and scenario groups 1 to 3; testing mode's 20 tries
    in a growing window; a minimum distance that no candidate meets (each
    agent takes its last candidate); and squared distances one ulp below,
    at and above the threshold. One launch each."""
    from sigmarl_tpu_torch.ops.spawn import spawn_place, spawn_place_reference

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    args = _spawn_case(case)
    before = launch_counts()["spawn_place"]
    got = spawn_place(*args)
    want = spawn_place_reference(*args)
    torch.cuda.synchronize()
    assert launch_counts()["spawn_place"] == before + 1
    for name, a, b in zip(("pos", "rot", "path_id", "point_id"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (case, name, int((a != b).sum()))
    if case in ("infeasible", "threshold"):
        cp, cq, cpos = _candidates(*args[:5])
    if case == "infeasible":  # every agent after the first takes its last try
        assert torch.equal(got[2][:, 1:], cp[:, 1:, -1])
        assert torch.equal(got[3][:, 1:], cq[:, 1:, -1])
    if case == "threshold":  # both outcomes occur: first candidate kept or not
        kept = (got[0][:, 0] == cpos[:, 0, 0]).all(-1)
        assert 0 < int(kept.sum()) < kept.numel()


def _candidates(cfg, tables, path_u, point_u, sid):
    """The plain version's candidate paths, point ids [B, N, T] and
    positions [B, N, T, 2]."""
    from sigmarl_tpu_torch.env.reset import _candidate_point_ids, _sample_candidate_paths

    cp = _sample_candidate_paths(tables, path_u, sid)
    cq = _candidate_point_ids(cfg, point_u, tables.n_points_long_term[cp.long()])
    return cp, cq, tables.long_term[cp.long(), cq.long()]


@pytest.mark.parametrize("case", ["entire_compact", "entire_full", "mixed_partial", "testing"])
def test_apply_reset_with_the_spawn_kernel_equals_the_plain_spawn(case, monkeypatch):
    """`apply_reset` on the card gives the same `WorldState`, every field
    bit for bit, with K3 as with the plain spawn in its place."""
    from sigmarl_tpu_torch.env import reset as reset_mod
    from sigmarl_tpu_torch.env.reset import ResetDraws, apply_reset
    from sigmarl_tpu_torch.ops.spawn import spawn_place_reference

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    cfg, tables, path_u, point_u, sid, pos, mask, compact = _spawn_case(case, seed=1)
    B, Nn = mask.shape
    state = zero_state(cfg, "cuda")
    state = dataclasses.replace(state, pos=pos, scenario_id=sid[:, None].expand(B, Nn).contiguous())
    g = torch.Generator(device="cuda").manual_seed(2)
    draws = ResetDraws.sample(cfg, g, "cuda", full=compact is None,
                              compact_slots=path_u.shape[0] if compact else 0)
    if compact:
        draws.path_u_c, draws.point_u_c = path_u, point_u
    else:
        draws.path_u, draws.point_u = path_u, point_u
    kernel = apply_reset(cfg, tables, state, mask, draws, compact=compact)
    monkeypatch.setattr(reset_mod, "spawn_place", spawn_place_reference)
    plain = apply_reset(cfg, tables, state, mask, draws, compact=compact)
    differ = [f.name for f in dataclasses.fields(kernel)
              if not torch.equal(getattr(kernel, f.name), getattr(plain, f.name))]
    assert not differ, differ


def test_the_spawn_kernel_launches_once_per_reset_step():
    """Over 32 filtered main-path steps at B=1024 (N=15), K3's launches
    equal the env's reset steps, compacted steps among them."""
    from sigmarl_tpu_torch.bench import filtered_step, main_path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    env, cbf, policy, gen, state, obs = main_path(1024, N, "cuda")
    before, resets, compacted = launch_counts(), env.reset_steps, env.compact_reset_steps
    for _ in range(32):
        state, obs, *_ = filtered_step(env, cbf, policy, state, obs, gen)
    torch.cuda.synchronize()
    launches = launch_counts(since=before)
    assert launches["spawn_place"] == env.reset_steps - resets > 0
    assert env.compact_reset_steps - compacted > 0
    assert launches["qp_newton"] == launches["boundary_stencil"] == 32


def test_one_rank_nccl_iteration_matches_the_unsharded_one():
    """The CBF-filtered iteration with the challenge buffer on (cpm_entire,
    N=15, B=64, T=8) on a 1-rank nccl group (`parallel/mesh.py`) against the
    same iteration in this process from the same start and draws, drawn
    once on the card: the checks of
    `utils/card_checks.py::sharded_vs_unsharded` (integer fields and flags
    equal, floats within 1e-3, the parameter rule, K1 and K2 once per
    rollout step); `chip_smoke.py` holds 2 gloo ranks sharing the card to
    them at full width."""
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
    JAX's keys, 40 instances, and ok (max gap below 1e-3); K1 launched 5
    times a stress step (the cold and the warm solve, two evaluations, the
    step's) and K2 4 times. The card's own reset from the same host draws
    spawns alike: positions, headings, speeds and ids bit for bit. Also
    every instance whose warm solve ends above 1e-3 of the oracle (none
    when ok) is the warm budget's, not the kernel's: K1 ends where its
    plain version ends on the same rows, and more iterations from the same
    start, or the float64 dense oracle, reach the oracle's objective."""
    import dataclasses

    from sigmarl_tpu_torch import check_warm_start
    from sigmarl_tpu_torch.env.reset import ResetDraws
    from sigmarl_tpu_torch.utils.certificate_tail import explain, plain_agrees

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    args = (4, 4, 6, 0, 10.0, 30)
    env, _, _, card, _, _ = check_warm_start.stress_setup(*args, device="cuda")
    host = check_warm_start.stress_setup(*args, device="cpu")[3]
    for f in dataclasses.fields(card):
        assert torch.equal(getattr(card, f.name).cpu(), getattr(host, f.name)), f.name
    own, _ = env.reset(draws=ResetDraws.sample(env.cfg, torch.Generator().manual_seed(0),
                                               "cpu").to("cuda"))
    for f in ("pos", "rot", "speed", "path_id", "point_id", "scenario_id"):
        assert torch.equal(getattr(own, f).cpu(), getattr(host, f)), f
    rng = torch.cuda.get_rng_state()
    before = launch_counts()
    line, _ = check_warm_start.certificate(device="cuda")
    launches = launch_counts(since=before)
    assert (launches["qp_newton"], launches["boundary_stencil"]) == (50, 40), launches
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
        # The spawn kernel once per step with a reset (every rank spawns at
        # full width below 1024 envs).
        assert r["launches"] == [{"qp_newton": 8, "boundary_stencil": 8,
                                  "spawn_place": r["reset_steps"]}] * W
        assert r["collectives_per_step"] == 2 and math.isfinite(r["reward"])
        assert r["batch"] == 16 * W and torch.cuda.get_device_name(0) in r["device"]
    assert summary["efficiency_vs_1dev"][0] == 1.0 and summary["mechanics"] == (cards < 2)


# The port's files whose host syncs fall in each layer's spans.
SYNC_LAYERS = {"sigmarl_tpu_torch/safety/": "filter", "sigmarl_tpu_torch/env/": "env_step"}


@pytest.mark.parametrize("batch", [1, 1024])
def test_the_program_counts_each_host_sync_in_its_layer(batch):
    """One main-path filtered step (a decision at B=1, a rollout step at
    B=1024) under `trace.enable()`: the `syncs` the program counts per span
    are the waits sync debug mode reports, each in the layer whose file the
    warning names: one, the env step's read of the resetting envs, in its
    span `env_step.done`; the filter, a replay of its graph, has none, and
    each kernel's launch falls in its span `filter.replay`; the env step's
    six graphs replay, each in its phase's span."""
    from collections import Counter

    from sigmarl_tpu_torch import trace
    from sigmarl_tpu_torch.bench import filtered_step, main_path
    from sigmarl_tpu_torch.device import host_syncs

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    env, cbf, policy, gen, state, obs = main_path(batch, N, "cuda")
    for _ in range(3):
        state, obs, *_ = filtered_step(env, cbf, policy, state, obs, gen)
    trace.reset()
    trace.enable()
    try:
        sites = host_syncs(lambda: filtered_step(env, cbf, policy, state, obs, gen))
    finally:
        trace.disable()
    spans = trace.snapshot()["spans"]
    trace.reset()
    counted = Counter()
    for name, s in spans.items():
        counted[name.split(".")[0]] += s["counts"].get("syncs", 0)
    warned = Counter(next((layer for d, layer in SYNC_LAYERS.items() if site.startswith(d)), site)
                     for site in sites)
    assert +counted == warned, (sites, spans)
    assert warned == {"env_step": 1} and counted["filter"] == 0, sites

    def launches(phase, kernel):  # in the phase and its sub-spans
        return sum(s["counts"].get(kernel, 0) for name, s in spans.items()
                   if name == phase or name.startswith(phase + "."))

    assert launches("filter.replay", "k1.launches") == 1
    assert launches("filter.replay", "k2.launches") == 1
    assert launches("filter", "k1.launches") == launches("filter", "k2.launches") == 1
    assert spans["filter.replay"]["counts"]["filter.graph.replays"] == 1
    assert spans["env_step.done"]["counts"]["syncs"] == 1
    for phase in ("dynamics", "geometry", "rewards", "paths", "done", "observe"):
        assert spans[f"env_step.{phase}"]["counts"]["env_step.graph.replays"] == 1, phase
    assert sum(s["counts"].get("env_step.graph.captures", 0) for s in spans.values()) == 0


def test_a_span_under_graph_capture_records_nothing():
    """A span inside captured code is the no-op (a replay runs no host
    work), even while tracing is on; the graph still replays."""
    from sigmarl_tpu_torch import trace

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.zeros(4, device="cuda")
    trace.reset()
    trace.enable()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            with trace.span("captured"):
                x.add_(1)
        with trace.span("replay"):
            graph.replay()
        torch.cuda.synchronize()
    finally:
        trace.disable()
    spans = trace.snapshot()["spans"]
    trace.reset()
    assert "captured" not in spans and spans["replay"]["calls"] == 1
    assert torch.equal(x.cpu(), torch.ones(4))


# The filter's graph at the main path's budget (3+5) and batches (the
# latency path's 1, 16, the rollout's 1024) and at the trainer's (2+15).
GRAPH_CASES = [(1, 5, 3), (16, 5, 3), (1024, 5, 3), (1024, 15, 2)]


@pytest.fixture(scope="module")
def live_inputs():
    """`get(batch)`: the main path's env at `batch` and the (state, action)
    of four of its filtered steps (the third to the sixth from the all-zero
    state), built on first use."""
    from sigmarl_tpu_torch.bench import main_path, policy_actions

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU build")
    built = {}

    def get(batch):
        if batch not in built:
            env, cbf, policy, gen, state, obs = main_path(batch, N, "cuda")
            steps = []
            for i in range(6):
                act = policy_actions(env, policy, obs, gen)
                if i >= 2:
                    steps.append((state, act))
                state, obs, *_ = cbf_filtered_step(env, cbf, state, act, generator=gen)
            built[batch] = env, steps
        return built[batch]

    return get


def _filter_call(fn, steps, i, warm):
    """`fn` (the filter or its eager body) at step i's state and action,
    with its warm start if `warm`, drawing from a generator seeded i."""
    state, act = steps[i]
    g = torch.Generator(device="cuda").manual_seed(i)
    return fn(state, act, u_init=state.cbf_u_prev if warm else None, generator=g)


def _equal_bit_for_bit(got, want):
    from sigmarl_tpu_torch.safety.cbf_qp import CBFStepInfo

    for name, a, b in zip(CBFStepInfo._fields, got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=name)


@pytest.mark.parametrize("inputs", ["cold", "warm", "obs_noise"])
@pytest.mark.parametrize("batch, iters, soft", GRAPH_CASES)
def test_the_filters_graph_replays_its_eager_body(live_inputs, batch, iters, soft, inputs):
    """Three calls of one shape: one capture (the first call's result is
    its warm-up's) and two replays; K1 and K2 launch once a call; every
    returned `CBFStepInfo` equals the eager body's at its inputs bit for
    bit, after the later replays too, and no two calls' tensors share
    memory; a fourth call, a replay, waits for nothing (sync debug mode
    "error")."""
    from sigmarl_tpu_torch import trace

    env, steps = live_inputs(batch)
    noise = inputs == "obs_noise"
    cbf = CBFSafetyFilter(CBFConfig(n_agents=N, newton_iters=iters, newton_soft_iters=soft,
                                    is_obs_noise=noise, obs_noise_level=0.1 if noise else 0.0),
                          env.cfg, env.tables, device="cuda")
    warm = inputs != "cold"
    trace.reset()
    before = launch_counts()
    outs = [_filter_call(cbf.filter_actions, steps, i, warm) for i in range(3)]
    torch.cuda.synchronize()
    assert launch_counts(before) == {"qp_newton": 3, "boundary_stencil": 3, "spawn_place": 0}
    counts = trace.snapshot()["counts"]
    trace.reset()
    assert counts.get("filter.graph.captures") == 1 and counts.get("filter.graph.replays") == 2
    assert len(cbf._graphs) == 1
    memory = [{t.untyped_storage().data_ptr() for t in out} for out in outs]
    assert all(not (memory[a] & memory[b]) for a, b in ((0, 1), (1, 2), (0, 2)))
    for i, out in enumerate(outs):
        _equal_bit_for_bit(out, _filter_call(cbf._filter_eager, steps, i, warm))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _filter_call(cbf.filter_actions, steps, 3, warm)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _equal_bit_for_bit(out, _filter_call(cbf._filter_eager, steps, 3, warm))
    assert trace.snapshot()["counts"].get("filter.graph.replays") == 1
    trace.reset()


@pytest.mark.parametrize("mode", ["grouped", "decentralized", "clf", "windowed", "fp16_parity"])
def test_every_filter_mode_is_captured(live_inputs, mode):
    """Each filter mode is one graph on the card (none stays eager): two
    calls, one capture and one replay, each equal to the eager body bit
    for bit, with K1 and K2 once a call."""
    from sigmarl_tpu_torch import trace

    env, steps = live_inputs(16)
    cfg = dict(clf=dict(nom_controller_type="clf"),
               windowed=dict(pd_topk_chunks=0, use_windowed_pseudo_distance=True),
               fp16_parity=dict(fp16_parity=True)).get(mode, {})
    kw = dict(grouped=dict(max_group_size=4), decentralized=dict(decentralized=True)).get(mode, {})
    cbf = CBFSafetyFilter(CBFConfig(n_agents=N, **cfg), env.cfg, env.tables, device="cuda", **kw)
    trace.reset()
    before = launch_counts()
    outs = [_filter_call(cbf.filter_actions, steps, i, True) for i in range(2)]
    torch.cuda.synchronize()
    assert launch_counts(before) == {"qp_newton": 2, "boundary_stencil": 2, "spawn_place": 0}
    counts = trace.snapshot()["counts"]
    trace.reset()
    assert counts.get("filter.graph.captures") == 1 and counts.get("filter.graph.replays") == 1
    for i, out in enumerate(outs):
        _equal_bit_for_bit(out, _filter_call(cbf._filter_eager, steps, i, True))


def test_host_tools_on_the_card_match_the_cpu():
    """The host-side modules on the card against the CPU: the dense QP
    oracle on `to_dense` of an assembled set (cpm_entire, N=4, B=8; F to a
    relative 1e-4), `pseudo_distance_to_polyline` on the example map's
    boundary (atol 1e-5), `current_lanelet_id` of every agent (equal);
    then an `InteractiveSession` (keys, 5 steps) and `debug_demo` (5 steps)
    on the card, finite."""
    from sigmarl_tpu_torch.core.geometry import current_lanelet_id
    from sigmarl_tpu_torch.env import debug_demo
    from sigmarl_tpu_torch.env.interactive import InteractiveSession
    from sigmarl_tpu_torch.env.structs import state_to
    from sigmarl_tpu_torch.maps.manager import load_map
    from sigmarl_tpu_torch.safety.pseudo_distance import pseudo_distance_to_polyline
    from sigmarl_tpu_torch.safety.qp import solve_boxed_penalty_qp

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = Parameters(scenario_type="cpm_entire", n_agents=4, num_vmas_envs=8, dt=0.1,
                   is_use_mtv_distance=False, is_obs_noise=False)
    out = {}
    for d in ("cpu", "cuda"):
        env = make_env(p, device=d)
        cbf = CBFSafetyFilter(CBFConfig(n_agents=4, dt=0.1), env.cfg, env.tables, device=d)
        state, _ = env.reset(generator=torch.Generator().manual_seed(3)) if d == "cpu" else (
            state_to(out["cpu"]["state"], d), None)
        act = torch.full((8, 4, 2), 0.4, device=d)
        cons, u_nom, _, _ = cbf.assemble(state, act)
        dense = cbf.to_dense(cons)
        w_u, lo, hi = (torch.tensor(x, device=d).repeat(4) for x in (
            (cbf.cfg.w_u_acc, cbf.cfg.w_u_steer), (cbf.a_min, cbf.rate_min),
            (cbf.a_max, cbf.rate_max)))
        _, F = solve_boxed_penalty_qp(dense, u_nom.reshape(8, 8), w_u, lo, hi, n_iters=12)
        t = env.tables
        pid = state.path_id.long()
        ids = current_lanelet_id(state.pos, t.ref_lanelet_segment_points[pid],
                                 t.n_ref_lanelet_ids[pid], t.ref_lanelet_ids[pid])
        path = load_map("pseudo_distance_example").reference_paths[0]
        bnd = torch.as_tensor(path.left_boundary_shared, device=d)
        pts = bnd[None] + torch.linspace(-0.2, 0.2, 9, device=d)[:, None, None]
        pd = pseudo_distance_to_polyline(pts.reshape(-1, 2), bnd, torch.as_tensor(
            path.left_boundary_shared_pseudo_vector, device=d))
        out[d] = dict(state=state_to(state, "cpu"), F=F.cpu(), ids=ids.cpu(), pd=pd.cpu())
    gap = float(((out["cuda"]["F"] - out["cpu"]["F"]).abs() / (1 + out["cpu"]["F"].abs())).max())
    assert gap <= 1e-4, gap
    torch.testing.assert_close(out["cuda"]["pd"], out["cpu"]["pd"], atol=1e-5, rtol=0)
    assert torch.equal(out["cuda"]["ids"], out["cpu"]["ids"])
    sess = InteractiveSession(device="cuda")
    for k in ("up", "up", "left", "r", "up"):
        sess.key(k)
    rews = [sess.step()[0] for _ in range(5)]
    traj = debug_demo.main(["--steps", "5", "--device", "cuda"])
    assert sess.t == 5 and all(np.isfinite(r).all() for r in rews) and np.isfinite(traj).all()


# The env step's graphs (`env/step_graphs.py`): the main path at B=1024
# (from the all-zero state: a full-width reset, then compacted ones) and at
# B=1 (from `env.reset`: steps without a reset), the train cell's cpm_mixed
# N=4 B=128 with observation noise (given on even steps, drawn on odd ones,
# as the reset's draws), testing mode and the challenge buffer (given
# noise on even steps, which the step ignores with the noise off, as the
# trainer passes it).
ENV_GRAPH_CASES = {
    "entire_b1024": dict(scenario_type="cpm_entire", n_agents=15, num_vmas_envs=1024,
                         is_obs_noise=False),
    "entire_b1": dict(scenario_type="cpm_entire", n_agents=15, num_vmas_envs=1,
                      is_obs_noise=False),
    "mixed_noise": dict(scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=128, max_steps=128,
                        is_obs_noise=True),
    "testing": dict(scenario_type="cpm_entire", n_agents=15, num_vmas_envs=64,
                    is_obs_noise=False, is_testing_mode=True),
    "challenge": dict(scenario_type="cpm_entire", n_agents=15, num_vmas_envs=64,
                      is_obs_noise=False, is_challenging_initial_state_buffer=True),
}
ENV_GRAPH_STEPS = 32


def _env_outputs(out) -> dict:
    """A step's returned tensors by name."""
    state, obs, reward, done, info = out
    named = {f"state.{f.name}": getattr(state, f.name) for f in dataclasses.fields(state)}
    named.update(obs=obs, reward=reward, done=done, **{f"info.{k}": v for k, v in info.items()})
    return named


@pytest.mark.parametrize("case", list(ENV_GRAPH_CASES))
def test_the_env_steps_graphs_replay_its_eager_body(case):
    """32 steps of the env step on the card (its graphs) against its eager
    body on the same inputs, with twin generators for the draws: every
    returned tensor (state, obs, reward, done, info) bit for bit, checked
    after the last step, so no later replay overwrote an earlier step's
    output, and no two steps' outputs share memory; the challenge buffer's
    counts alike; one capture, then six graph replays a step; the main
    path meets steps with no reset, a compacted and a full-width reset;
    then a step under sync debug mode "error" but for the read of the
    resetting envs."""
    import copy

    from sigmarl_tpu_torch import trace
    from sigmarl_tpu_torch.env.reset import ResetDraws
    from sigmarl_tpu_torch.utils.card_checks import env_graph_counts

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the spawn kernel has no CPU build")
    kw = ENV_GRAPH_CASES[case]
    p = Parameters(**{"dt": 0.1, "max_steps": 1_000_000, "is_use_mtv_distance": False, **kw})
    env = make_env(p, device="cuda")
    eager = copy.copy(env)
    eager.challenge_counts = torch.zeros_like(env.challenge_counts)
    g_act = torch.Generator(device="cuda").manual_seed(1)
    g_graph, g_eager = (torch.Generator(device="cuda").manual_seed(2) for _ in range(2))
    B, N = env.batch_dim, env.n_agents
    if case == "entire_b1024":
        state = zero_state(env.cfg, "cuda")
    else:
        state, _ = env.reset(generator=torch.Generator(device="cuda").manual_seed(3))
    trace.reset()
    outs, branches = [], {"none": 0, "compacted": 0, "full": 0}
    for i in range(ENV_GRAPH_STEPS):
        act = (torch.rand((B, N, 2), generator=g_act, device="cuda") - 0.3) * env.action_limits
        kw = {}
        if case == "mixed_noise" and i % 2 == 0:
            kw = dict(reset_draws=ResetDraws.sample(env.cfg, g_act, "cuda"),
                      obs_noise=torch.rand((B, N, env.obs_dim), generator=g_act, device="cuda"))
        if case in ("testing", "challenge") and i % 2 == 0:
            kw = dict(obs_noise=torch.rand((B, N, env.obs_dim), generator=g_act, device="cuda"))
        before = (env.compact_reset_steps, env.full_reset_steps)
        got = env.step(state, act, generator=g_graph, **kw)
        want = eager._step_eager(state, act, g_eager, kw.get("reset_draws"), kw.get("obs_noise"))
        compacted, full = env.compact_reset_steps - before[0], env.full_reset_steps - before[1]
        branches["compacted" if compacted else "full" if full else "none"] += 1
        outs.append((_env_outputs(got), _env_outputs(want)))
        state = got[0]
    torch.cuda.synchronize()
    assert env_graph_counts() == {"captures": 1, "replays": 6 * ENV_GRAPH_STEPS}
    assert len(env._graphs) == 1
    for i, (got, want) in enumerate(outs):
        assert got.keys() == want.keys()
        for name, a in got.items():
            b = want[name]
            assert a.dtype == b.dtype and a.shape == b.shape, (i, name)
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                       msg=f"step {i}: {name}")
    memory = [{t.untyped_storage().data_ptr() for t in got.values()} for got, _ in outs]
    assert all(not (memory[a] & memory[b]) for a in range(len(memory)) for b in range(a))
    assert torch.equal(env.challenge_counts, eager.challenge_counts)
    if case == "challenge":
        assert int(env.challenge_counts[0]) > 0  # records were written
    if case == "entire_b1024":
        assert branches["compacted"] > 0 and branches["full"] > 0, branches
    if case == "entire_b1":
        assert branches["none"] > 0, branches

    read = env._read_resets

    def read_allowed(n_reset):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return read(n_reset)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    env._read_resets = read_allowed
    act = (torch.rand((B, N, 2), generator=g_act, device="cuda") - 0.3) * env.action_limits
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = env.step(state, act, generator=g_graph)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        del env._read_resets
    want = eager._step_eager(state, act, g_eager, None, None)
    for name, a in _env_outputs(got).items():
        torch.testing.assert_close(a, _env_outputs(want)[name], rtol=0, atol=0, equal_nan=True,
                                   msg=name)
    trace.reset()
