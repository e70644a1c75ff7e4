"""The whole batched CBF-QP Newton solve: the CUDA kernel K1 and its plain
version.

`newton_solve` minimizes, per env,

  F(u) = sum_a w_a (u_a - u_nom_a)^2 + sum_rows phi(a . u + b)

over the box u_lo <= u <= u_hi (phi: `safety.qp._phi_terms`), from the
better of two starts, through an optional stiffness ladder and `n_iters`
projected-Newton iterations (`csrc/qp_newton.cu`). Controls are [B, 2N]
with the x block (acceleration) before the y block (steering rate); rows
come packed by `safety.qp.pack_constraints`, invalid rows as ws = 0; one
agent has no pair rows (P = 0, pairs [B, 8, 0]). CUDA
tensors launch the kernel; CPU tensors run `newton_solve_reference`, which
follows the kernel's algorithm step for step.

The kernel solves an env again with IEEE divisions where its operands
leave the fast division's ranges, and counts those envs on the card, in a
buffer of this module (one per card, so a CUDA graph's replays count
too); `collect_ieee_resolves` reads it into the trace's count
`k1.ieee_resolves`, outside any timed stretch (the read waits for the
card).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.safety.qp import _phi_candidates, _phi_terms

Tensor = torch.Tensor

_MAX_ALPHA = 4.0  # line-search cap on the Newton step length
_ARC_ALPHAS = (1.0, 4.0)  # projected-arc candidates past the first bound
THREADS = 128  # the kernel's block size (`kThreads` in csrc/qp_newton.cu)
_WARP = 32


def ladder_caps(soft_iters: int, soft_cap: float, ws_cap: float) -> list:
    """Slack-stiffness cap of each continuation stage: geometric from
    soft_cap toward ws_cap (stage k of S: soft_cap^(1-k/S) * ws_cap^(k/S))."""
    return [
        float(soft_cap ** (1.0 - k / soft_iters) * ws_cap ** (k / soft_iters))
        for k in range(soft_iters)
    ]


# The plain version adds in the kernel's order, term for term. One Newton
# step amplifies rounding in the Hessian and gradient by the condition
# number of the system (slack stiffness up to 3e6 against a steering weight
# of 2), so two summation orders can part by 1e-2 in near-flat control
# directions after a single iteration; summed alike, the kernel and its
# plain version agree to rounding.


def _seq_sum(x: Tensor) -> Tensor:
    """Sum over the last axis in index order (one thread's loop)."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _pad_to(x: Tensor, multiple: int) -> Tensor:
    """Zero-pad the last axis up to a multiple of `multiple`."""
    extra = -x.shape[-1] % multiple
    if extra == 0:
        return x
    return torch.cat([x, x.new_zeros((*x.shape[:-1], extra))], dim=-1)


def _by_thread(vals: Tensor) -> Tensor:
    """[B, M] -> [B, S, THREADS]: entry (s, t) is value t + THREADS*s, the
    s-th value thread t adds in a block-strided loop."""
    v = _pad_to(vals, THREADS)
    return v.reshape(v.shape[0], -1, THREADS)


def _warp_tree(x: Tensor) -> Tensor:
    """[..., 32k] -> [..., k]: each warp's xor-butterfly sum, which is a
    halving tree (lane l + lane l+16, then +8, +4, +2, +1)."""
    x = x.reshape(*x.shape[:-1], -1, _WARP)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _block_sum(*parts: Tensor) -> Tensor:
    """The kernel's block reduction. Each part is [B, S, THREADS], a run of
    addends per thread; every thread adds its addends in order, each warp
    sums its threads by the butterfly, and the warp sums add in order."""
    acc = _seq_sum(torch.cat(parts, dim=1).transpose(1, 2))  # [B, THREADS]
    return _seq_sum(_warp_tree(acc))


def agent_pair_slots(owner: np.ndarray, N: int, device=None) -> Tensor:
    """[N, L] indices of the pairs that agent n owns in one role (`owner`
    is pair_i or pair_j), in pair order, padded with P (a zero column): the
    per-agent lists the kernel walks (it builds the same runs in shared
    memory)."""
    P = len(owner)
    lists = [np.flatnonzero(owner == n) for n in range(N)]
    L = max([len(x) for x in lists] + [1])
    out = np.full((N, L), P, np.int64)
    for n, x in enumerate(lists):
        out[n, : len(x)] = x
    return torch.as_tensor(out, device=device)


def chol_solve(H: Tensor, g: Tensor) -> Tensor:
    """Solve H x = g for a batch of SPD matrices [B, d, d] as the kernel
    does: right-looking Cholesky with the pivot clamped at 1e-12, forward
    substitution L y = g, then backward substitution L^T x = y column by
    column (x_j = r_j / L_jj, then r_i -= L_ji x_j for i < j), every entry
    updated in that order."""
    d = H.shape[-1]
    A = H.clone()
    L = torch.zeros_like(H)
    for j in range(d):
        piv = 1.0 / torch.sqrt(torch.clamp(A[:, j, j], min=1e-12))
        col = A[:, j:, j] * piv[:, None]
        L[:, j:, j] = col
        if j < d - 1:
            A[:, j + 1:, j + 1:] -= col[:, 1:, None] * col[:, None, 1:]
    r = g.clone()
    y = torch.zeros_like(g)
    for j in range(d):
        y[:, j] = r[:, j] / L[:, j, j]
        r[:, j + 1:] -= L[:, j + 1:, j] * y[:, j:j + 1]
    x = torch.zeros_like(g)
    for j in range(d - 1, -1, -1):
        x[:, j] = y[:, j] / L[:, j, j]
        y[:, :j] -= L[:, j, :j] * x[:, j:j + 1]
    return x


def newton_solve_reference(
    singles: Tensor,  # [B, 6, N*Ks]: a_x, a_y, b, h, ws, wl
    pairs: Tensor,  # [B, 8, P*Kp]: a_xi, a_yi, a_xj, a_yj, b, h, ws, wl
    u0: Tensor,  # [B, 2N] clipped nominal start
    u_init: Tensor,  # [B, 2N] clipped warm start (u0 when absent)
    u_nom: Tensor,  # [B, 2N]
    pair_i: Tensor,  # [P] int32
    pair_j: Tensor,  # [P] int32
    w_u: Tuple[float, float],
    u_lo: Tuple[float, float],
    u_hi: Tuple[float, float],
    n_iters: int,
    ridge: float = 1e-8,
    soft_iters: int = 0,
    soft_cap: float = 10.0,
    ws_cap: float = 3e6,
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the solve kernel, with the kernel's
    arithmetic in the kernel's order. Returns (u [B, 2N], F [B])."""
    B, d = u0.shape
    N = d // 2
    P = pair_i.shape[0]
    Ms, Mp = singles.shape[-1], pairs.shape[-1]
    Ks, Kp = Ms // N, (Mp // P if P else 0)
    dev, dt = u0.device, u0.dtype
    asx, asy, bs, hs, wss, wls = singles.unbind(1)
    apxi, apyi, apxj, apyj, bp, hp, wsp, wlp = pairs.unbind(1)
    pi_np, pj_np = pair_i.cpu().numpy(), pair_j.cpu().numpy()
    pi, pj = pair_i.long(), pair_j.long()
    row_n = torch.arange(N, device=dev).repeat_interleave(Ks)  # [Ms]
    row_i, row_j = pi.repeat_interleave(Kp), pj.repeat_interleave(Kp)  # [Mp]

    slots_i, slots_j = agent_pair_slots(pi_np, N, dev), agent_pair_slots(pj_np, N, dev)

    def to_agents(per_pair, slot):  # [B, P] -> [B, N], summed in pair order
        padded = torch.cat([per_pair, per_pair.new_zeros((B, 1))], dim=1)
        return _seq_sum(padded[:, slot])

    def per_comp(vals):
        x, y = vals
        return torch.tensor([x] * N + [y] * N, dtype=dt, device=dev)

    w, lo, hi = per_comp(w_u), per_comp(u_lo), per_comp(u_hi)
    eps_b = 1e-6 * (hi - lo)
    at_lo = lambda u: u <= lo + eps_b  # noqa: E731
    at_hi = lambda u: u >= hi - eps_b  # noqa: E731
    clip = lambda u: torch.minimum(torch.maximum(u, lo), hi)  # noqa: E731

    def rows(u):  # row-wise gathers of a [B, 2N] control vector
        x, y = u[:, :N], u[:, N:]
        return x[:, row_n], y[:, row_n], x[:, row_i], y[:, row_i], x[:, row_j], y[:, row_j]

    def residual(u):
        xs, ys, xi, yi, xj, yj = rows(u)
        r_s = asx * xs + asy * ys + bs
        r_p = apxi * xi + apyi * yi + apxj * xj + apyj * yj + bp
        return r_s, r_p

    def track(u):  # per-variable tracking terms [B, 2N]
        du = u - u_nom
        return w * du * du

    def capped(cap):
        if cap is None:
            return wss, wsp
        return torch.clamp(wss, max=cap), torch.clamp(wsp, max=cap)

    def F_value(u, cap=None):
        ws_s, ws_p = capped(cap)
        r_s, r_p = residual(u)
        vs, _ = _phi_candidates(r_s, hs, ws_s, wls)
        vp, _ = _phi_candidates(r_p, hp, ws_p, wlp)
        return _block_sum(_by_thread(track(u)), _by_thread(torch.cat([vs, vp], dim=1)))

    def item_sums(val_s, val_p):
        """Sweep A's per-thread addends: thread t adds agent t's Ks row
        values (t < N) or pair t-N's Kp row values, for items t, t+THREADS,
        ... [B, S, THREADS]."""
        K = max(Ks, Kp)
        pair_items = _pad_to(val_p.reshape(B, P, Kp), K) if P else val_p.new_zeros((B, 0, K))
        items = torch.cat(
            [_pad_to(val_s.reshape(B, N, Ks), K), pair_items], dim=1
        )  # [B, N+P, K], each item's values then zeros
        items = _pad_to(items.transpose(1, 2), THREADS)  # [B, K, R*THREADS]
        R = items.shape[-1] // THREADS
        items = items.reshape(B, K, R, THREADS).transpose(1, 2)  # [B, R, K, T]
        return items.reshape(B, R * K, THREADS)

    def newton_step(u, cap=None):
        ws_s, ws_p = capped(cap)
        r_s, r_p = residual(u)
        val_s, dphi_s, ddphi_s = _phi_terms(r_s, hs, ws_s, wls)
        val_p, dphi_p, ddphi_p = _phi_terms(r_p, hp, ws_p, wlp)
        F = _block_sum(_by_thread(track(u)), item_sums(val_s, val_p))

        def agent_sum(x):  # [B, Ms] -> [B, N], each agent's rows in order
            return _seq_sum(x.reshape(B, N, Ks))

        def pair_sum(x):  # [B, Mp] -> [B, P]
            return _seq_sum(x.reshape(B, P, Kp)) if P else x.new_zeros((B, 0))

        # Gradient and the 2x2 agent blocks: the agent's own rows, then its
        # pairs as i, then its pairs as j.
        gx = (2.0 * w[:N] * (u[:, :N] - u_nom[:, :N]) + agent_sum(dphi_s * asx)
              + to_agents(pair_sum(dphi_p * apxi), slots_i)
              + to_agents(pair_sum(dphi_p * apxj), slots_j))
        gy = (2.0 * w[N:] * (u[:, N:] - u_nom[:, N:]) + agent_sum(dphi_s * asy)
              + to_agents(pair_sum(dphi_p * apyi), slots_i)
              + to_agents(pair_sum(dphi_p * apyj), slots_j))
        grad = torch.cat([gx, gy], dim=1)
        bind = (at_lo(u) & (grad > 0)) | (at_hi(u) & (grad < 0))
        free = (~bind).to(dt)
        grad = grad * free

        def block(ci, cj, cs):  # one 2x2-block entry per agent
            return (agent_sum(ddphi_s * cs[0] * cs[1])
                    + to_agents(pair_sum(ddphi_p * ci[0] * ci[1]), slots_i)
                    + to_agents(pair_sum(ddphi_p * cj[0] * cj[1]), slots_j))

        dxx = block((apxi, apxi), (apxj, apxj), (asx, asx))
        dyy = block((apyi, apyi), (apyj, apyj), (asy, asy))
        dxy = block((apxi, apyi), (apxj, apyj), (asx, asy))
        iN = torch.arange(N, device=dev)
        H = torch.zeros((B, d, d), dtype=dt, device=dev)
        if P:
            sxx = pair_sum(ddphi_p * apxi * apxj)
            sxy = pair_sum(ddphi_p * apxi * apyj)
            syx = pair_sum(ddphi_p * apyi * apxj)
            syy = pair_sum(ddphi_p * apyi * apyj)
            # Cross blocks: pair (i, j) couples x/y of agent i with x/y of j.
            for ra, ca, v in (
                (pi, pj, sxx), (pj, pi, sxx),
                (pi, N + pj, sxy), (N + pj, pi, sxy),
                (N + pi, pj, syx), (pj, N + pi, syx),
                (N + pi, N + pj, syy), (N + pj, N + pi, syy),
            ):
                H[:, ra, ca] = v
        H[:, iN, iN] = dxx + 2.0 * w[:N] + ridge
        H[:, N + iN, N + iN] = dyy + 2.0 * w[N:] + ridge
        H[:, iN, N + iN] = dxy
        H[:, N + iN, iN] = dxy
        # Restrict to the free set (bound variables get identity rows).
        H = H * free[:, :, None] * free[:, None, :]
        iD = torch.arange(d, device=dev)
        H[:, iD, iD] += 1.0 - free
        step = chol_solve(H, -grad)

        outward = (at_lo(u) & (step < 0)) | (at_hi(u) & (step > 0))
        step = torch.where(outward, torch.zeros_like(step), step)
        big = torch.full_like(step, 1e30)
        one = torch.ones_like(step)
        a_hi = torch.where(step > 1e-30, (hi - u) / torch.where(step > 1e-30, step, one), big)
        a_lo = torch.where(step < -1e-30, (lo - u) / torch.where(step < -1e-30, step, one), big)
        a_cap = torch.clamp(torch.minimum(a_hi, a_lo).min(-1).values, 0.0, _MAX_ALPHA)

        ss, sy, si, syi, sj, syj = rows(step)
        dr = torch.cat([asx * ss + asy * sy,
                        apxi * si + apyi * syi + apxj * sj + apyj * syj], dim=1)
        r = torch.cat([r_s, r_p], dim=1)
        h_all, wl_all = torch.cat([hs, hp], dim=1), torch.cat([wls, wlp], dim=1)
        ws_all = torch.cat([ws_s, ws_p], dim=1)
        du = u - u_nom
        q1 = _block_sum(_by_thread(2.0 * w * du * step))
        q2 = _block_sum(_by_thread(w * step * step))

        def dF(alpha, second):
            _, g, gg = _phi_terms(r + alpha[:, None] * dr, h_all, ws_all, wl_all)
            g1 = q1 + 2.0 * q2 * alpha + _block_sum(_by_thread(g * dr))
            if not second:
                return g1, None
            return g1, 2.0 * q2 + _block_sum(_by_thread(gg * dr * dr))

        # Along the direction F(alpha) is convex piecewise-quadratic: 3
        # bisections on the sign of dF, then 2 Newton polish steps.
        g_cap, _ = dF(a_cap, False)
        lo_a = torch.zeros_like(a_cap)
        hi_a = a_cap
        for _ in range(3):
            mid = 0.5 * (lo_a + hi_a)
            pos = dF(mid, False)[0] > 0
            hi_a = torch.where(pos, mid, hi_a)
            lo_a = torch.where(pos, lo_a, mid)
        alpha = 0.5 * (lo_a + hi_a)
        for _ in range(2):
            g1, g2d = dF(alpha, True)
            alpha = torch.minimum(
                torch.maximum(alpha - g1 / torch.clamp(g2d, min=1e-12), lo_a), hi_a)
        alpha = torch.where(g_cap <= 0, a_cap, alpha)

        best_u = clip(u + alpha[:, None] * step)
        best_F = F_value(best_u, cap)
        for a_arc in _ARC_ALPHAS:
            cand = clip(u + a_arc * step)
            F_a = F_value(cand, cap)
            take = F_a < best_F
            best_u = torch.where(take[:, None], cand, best_u)
            best_F = torch.where(take, F_a, best_F)
        return torch.where((best_F < F)[:, None], best_u, u)

    u = torch.where((F_value(u_init) < F_value(u0))[:, None], u_init, u0)
    if soft_iters > 0:
        u_soft = u
        for cap in ladder_caps(soft_iters, soft_cap, ws_cap):
            u_soft = newton_step(u_soft, cap)
        keep = F_value(u_soft) < F_value(u)
        u = torch.where(keep[:, None], u_soft, u)
    for _ in range(n_iters):
        u = newton_step(u)
    return u, F_value(u)


def _check(t: Tensor, name: str, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# Per card index: the int64 [1] count of envs that K1 solved with IEEE
# divisions. Allocated at the first launch outside a graph's capture and
# never freed or rebound: captured launches hold its address.
_IEEE_RESOLVES: dict = {}


def _ieee_buffer(device: torch.device):
    buf = _IEEE_RESOLVES.get(device.index)
    if buf is None and not torch.cuda.is_current_stream_capturing():
        buf = _IEEE_RESOLVES[device.index] = torch.zeros(1, dtype=torch.int64, device=device)
    return buf


def collect_ieee_resolves(device: torch.device | str | None = None) -> int:
    """The envs K1 solved with IEEE divisions on `device` (the current
    card by default) since the last collection: read from the card (one
    sync), added to the trace's count `k1.ieee_resolves` and zeroed."""
    if not _IEEE_RESOLVES:
        return 0
    device = torch.device("cuda" if device is None else device)
    buf = _IEEE_RESOLVES.get(
        torch.cuda.current_device() if device.index is None else device.index)
    if buf is None:
        return 0
    n = int(buf)
    trace.count_sync(buf.device)
    buf.zero_()
    trace.count("k1.ieee_resolves", n)
    return n


def newton_solve(
    singles: Tensor,
    pairs: Tensor,
    u0: Tensor,
    u_init: Tensor,
    u_nom: Tensor,
    pair_i: Tensor,
    pair_j: Tensor,
    w_u: Tuple[float, float],
    u_lo: Tuple[float, float],
    u_hi: Tuple[float, float],
    n_iters: int,
    ridge: float = 1e-8,
    soft_iters: int = 0,
    soft_cap: float = 10.0,
    ws_cap: float = 3e6,
) -> Tuple[Tensor, Tensor]:
    """The whole solve, one CUDA block per env (see `newton_solve_reference`
    for the arguments). CPU tensors take the plain version."""
    args = (singles, pairs, u0, u_init, u_nom, pair_i, pair_j, w_u, u_lo, u_hi, n_iters)
    kw = dict(ridge=ridge, soft_iters=soft_iters, soft_cap=soft_cap, ws_cap=ws_cap)
    if not singles.is_cuda:
        return newton_solve_reference(*args, **kw)
    B, d = u0.shape
    N = d // 2
    P = pair_i.shape[0]
    if d != 2 * N or N == 0:
        raise ValueError(f"controls of width {d} are not two per agent")
    Ms, Mp = singles.shape[-1], pairs.shape[-1]
    if Ms % N or (Mp % P if P else Mp):
        raise ValueError(f"row counts {Ms}, {Mp} do not split over {N} agents, {P} pairs")
    Ks, Kp = Ms // N, (Mp // P if P else 0)  # one agent: no pair rows
    f32 = torch.float32
    _check(singles, "singles", f32, (B, 6, Ms))
    _check(pairs, "pairs", f32, (B, 8, Mp))
    for name, t in (("u0", u0), ("u_init", u_init), ("u_nom", u_nom)):
        _check(t, name, f32, (B, d))
    _check(pair_i, "pair_i", torch.int32, (P,))
    _check(pair_j, "pair_j", torch.int32, (P,))
    if n_iters < 0 or soft_iters < 0:
        raise ValueError("iteration counts must be non-negative")
    from sigmarl_tpu_torch.ops.build import library

    lib = library("qp_newton")
    _check_smem(lib, u0.device.index, N, Ks, Kp, P)
    u = torch.empty((B, d), dtype=f32, device=u0.device)
    F = torch.empty((B,), dtype=f32, device=u0.device)
    fn = lib.qp_newton_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 7
        + [ctypes.c_float] * 7
        + [ctypes.c_double] * 2
        + [ctypes.c_void_p] * 2
    )
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream(u0.device).cuda_stream)
    counter = _ieee_buffer(u0.device)
    err = fn(
        p(singles), p(pairs), p(u0), p(u_init), p(u_nom), p(pair_i), p(pair_j), p(u), p(F),
        B, N, Ks, Kp, P, n_iters, soft_iters,
        w_u[0], w_u[1], u_lo[0], u_lo[1], u_hi[0], u_hi[1], ridge,
        soft_cap, ws_cap, stream, None if counter is None else p(counter),
    )
    if err != 0:
        raise RuntimeError(f"QP solve kernel launch failed: CUDA error {err}")
    trace.count("k1.launches")
    return u, F


@functools.lru_cache(maxsize=None)
def _check_smem(lib, device_index: int, N: int, Ks: int, Kp: int, P: int) -> None:
    """Raise ValueError where one env's rows need more shared memory than a
    block on this card can have (checked once per library, card and
    sizes)."""
    smem = _smem_bytes(lib, N, Ks, Kp, P)
    limit = ctypes.c_int(0)
    lib.qp_newton_smem_limit.restype = ctypes.c_int
    lib.qp_newton_smem_limit.argtypes = [ctypes.c_void_p]
    with torch.cuda.device(device_index):
        err = lib.qp_newton_smem_limit(ctypes.byref(limit))
    if err != 0:
        raise RuntimeError(f"shared-memory limit query failed: CUDA error {err}")
    if smem > limit.value:
        raise ValueError(
            f"one env's rows need {smem} B of shared memory (N={N}, Ks={Ks}, Kp={Kp}), "
            f"more than the {limit.value} B a block can have")


def _smem_bytes(lib, N: int, Ks: int, Kp: int, P: int) -> int:
    lib.qp_newton_smem_bytes.restype = ctypes.c_size_t
    lib.qp_newton_smem_bytes.argtypes = [ctypes.c_int] * 4
    return int(lib.qp_newton_smem_bytes(N, Ks, Kp, P))


def solve_occupancy(N: int, Ks: int, Kp: int, P: int, B: int) -> dict:
    """The solve kernel's footprint on the current card at these sizes:
    shared memory per block (one block per env), blocks per SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), and the waves that B
    envs take."""
    from sigmarl_tpu_torch.ops.build import library

    lib = library("qp_newton")
    lib.qp_newton_blocks_per_sm.restype = ctypes.c_int
    lib.qp_newton_blocks_per_sm.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    blocks = ctypes.c_int(0)
    err = lib.qp_newton_blocks_per_sm(N, Ks, Kp, P, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    resident = blocks.value * sms
    return dict(smem_bytes=_smem_bytes(lib, N, Ks, Kp, P),
                blocks_per_sm=blocks.value, sms=sms,
                waves=(B / resident) if resident else float("inf"))
