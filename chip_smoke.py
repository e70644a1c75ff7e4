#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. the device: `torch.cuda.get_device_name(0)` and nvidia-smi's name and
   power limit (no CUDA device: exit 1);
2. build both CUDA kernels from `sigmarl_tpu_torch/csrc/` (one nvcc each,
   in parallel) and print the build seconds and ptxas' resource report;
3. the main path, set up as `bench.py` sets up the JAX one: `make_env` on
   cpm_entire with N=15 agents and B=1024 envs, the 3x256 policy with
   seeded weights, the centralized CBF-QP filter at the production budget
   (3 ladder + 5 Newton iterations), and a warm-up of filtered steps from
   `zero_state`;
4. each kernel against its plain PyTorch version on inputs captured from
   that rollout: K1 (the QP solve) controls after 0 and 1 iterations to
   atol 2e-5, F after 30 iterations to a relative 1e-4 and at the 3+5
   budget to 1e-3; K2 (the pseudo-distance stencil) both sides, chunked
   and full scan, to atol 2e-5;
5. 16 timed filtered steps with the launch counts set to 0 just before
   and read just after: K1 must launch once per step and K2 once per step
   (one launch serves both boundary sides); obs, rewards and u* must be
   finite. Prints env-steps/s beside the card's name and power limit;
6. a small-input check at B=8: the card's constraint assembly, solve and
   environment step against the CPU path (the kernels' plain versions)
   from the same state with the same draws;
7. kernel times beside each kernel's bound and its plain version's time,
   and K1's shared memory, blocks per SM and waves, as one JSON line; then
   the result line. `ms` (with `ms_min`, `ms_max`) is the median, least
   and largest of 7 CUDA-event windows queued behind a spin on the card,
   warmed up: the card's time alone. `back_to_back_ms` is the median of 7
   windows of calls as the host issues them, which for a kernel shorter
   than its wrapper's host cost (K2) times the host's launch rate.
   K2's bound counts the work this input needs: every selected segment
   tested once per row, and the exact evaluation only on the segments that
   count for some query of the row (the bound for every segment evaluated
   for every query is printed beside it).

The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_AGENTS, BATCH, WARMUP_STEPS, TIMED_STEPS = 15, 1024, 8, 16
# Published peaks of one H100 SXM (NVIDIA data sheet, 700 W): float32
# outside the tensor cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 1, queued: bool = False) -> float:
    """Mean milliseconds per call of `fn` over `reps` back-to-back calls on
    the card (CUDA events). A call that runs shorter on the card than it
    costs the host to launch (a wrapper call costs tens of microseconds)
    is then timed at the host's launch rate. With `queued`, a spin of ~50
    ms on the card goes first, so the host queues the calls while the card
    is busy and the window times the card's work alone."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_windows(fn, reps: int, windows: int = 7, queued: bool = False) -> dict:
    """Median, least and largest of `windows` CUDA-event windows of `reps`
    calls each (milliseconds per call)."""
    times = sorted(cuda_ms(fn, reps, queued=queued) for _ in range(windows))
    return dict(ms=times[len(times) // 2], ms_min=times[0], ms_max=times[-1])


def rel_gap(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


# ---------------------------------------------------------------- bounds
# Float operations per row of the solve kernel, counted from
# csrc/qp_newton.cu (adds, multiplies, divides, min/max, compares): phi_best
# (lambda candidates and four penalty evaluations), its two derivatives,
# and the residual, accumulation and line-search work around it.
_PHI, _DPHI, _DDPHI = 62, 2, 11


def qp_flops(N: int, Ks: int, Kp: int, P: int, n_iters: int, soft_iters: int) -> float:
    """Float operations of one env's solve (fixed iteration counts: the
    kernel does the same work for every env)."""
    d, Ms, Mp = 2 * N, N * Ks, P * Kp
    f_value = 4 * d + Ms * (4 + 1 + _PHI + 1) + Mp * (8 + 1 + _PHI + 1)
    sweep_a = Ms * (4 + 1 + _PHI + _DPHI + _DDPHI + 14) + Mp * (8 + 1 + _PHI + _DPHI + _DDPHI + 39)
    assembly = 18 * P + 20 * N + 3 * d * d
    chol = sum(2 + (d - j) + (d - j - 1) * (d - j) for j in range(d))
    subst = sum(1 + 2 * (d - j - 1) for j in range(d)) + sum(2 + 2 * (d - j - 1) for j in range(d))
    dF1 = Ms * 69 + Mp * 69
    dF2 = Ms * 83 + Mp * 83
    step = (sweep_a + assembly + chol + subst + 16 * d + 3 * Ms + 7 * Mp
            + 4 * dF1 + 2 * dF2 + 3 * (3 * d + f_value))
    return 2 * f_value + soft_iters * step + (2 * f_value if soft_iters else 0) + n_iters * step + f_value


# Float operations in csrc/boundary_stencil.cu: the exact evaluation of one
# (query, segment) pair, and the disk test of one (row, side, segment).
_SEG_OPS, _TEST_OPS = 25, 43


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------- phases
def import_port():
    """Import the port from this checkout, and only from it."""
    sys.path.insert(0, HERE)
    try:
        import sigmarl_tpu_torch
    except ImportError as e:
        raise SmokeFailure(f"the port is not beside this script ({e})") from e
    pkg = os.path.dirname(os.path.abspath(sigmarl_tpu_torch.__file__))
    check(pkg == os.path.join(HERE, "sigmarl_tpu_torch"), f"imported the port from {pkg}")
    return sigmarl_tpu_torch


def setup_main_path(dev):
    import torch

    from sigmarl_tpu_torch import (
        CBFConfig, CBFSafetyFilter, Parameters, PolicyNet, make_env, zero_state,
    )

    p = Parameters(
        scenario_type="cpm_entire", n_agents=N_AGENTS, num_vmas_envs=BATCH, dt=0.1,
        max_steps=1_000_000, is_use_mtv_distance=False, is_obs_noise=False,
        is_using_cbf_testing=True, is_using_centralized_cbf=True,
    )
    env = make_env(p, device=dev)
    cbf = CBFSafetyFilter(
        CBFConfig(n_agents=N_AGENTS, n_circles=3, dt=0.1, newton_iters=5, newton_soft_iters=3),
        env.cfg, env.tables, device=dev,
    )
    policy = PolicyNet(env.obs_dim, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = zero_state(env.cfg, dev)
    obs = torch.zeros((BATCH, N_AGENTS, env.obs_dim), device=dev)
    return env, cbf, policy, gen, state, obs


def policy_actions(env, policy, obs, gen):
    import torch

    from sigmarl_tpu_torch import tanh_normal_sample

    lim = env.action_limits
    with torch.no_grad():
        loc, scale = policy(obs)
        act, _ = tanh_normal_sample(loc, scale, -lim, lim, generator=gen)
    return act


def rollout(env, cbf, policy, gen, state, obs, steps):
    """`steps` filtered steps; returns the final state and obs, whether
    obs, rewards and u* stayed finite, and the mean solved share."""
    import torch

    from sigmarl_tpu_torch import cbf_filtered_step

    finite = torch.ones((), dtype=torch.bool, device=obs.device)
    solved = torch.zeros((), device=obs.device)
    for _ in range(steps):
        act = policy_actions(env, policy, obs, gen)
        state, obs, rew, done, info = cbf_filtered_step(env, cbf, state, act, generator=gen)
        finite &= torch.isfinite(obs).all() & torch.isfinite(rew).all()
        finite &= torch.isfinite(state.cbf_u_prev).all()
        solved += info["cbf_solved"].float().mean()
    return state, obs, bool(finite), float(solved) / steps


def capture_kernel_inputs(env, cbf, policy, gen, state, obs):
    """The inputs the main path gives both kernels at this state."""
    from sigmarl_tpu_torch.safety.circles import circle_centers_world
    from sigmarl_tpu_torch.safety.qp import kernel_inputs

    act = policy_actions(env, policy, obs, gen)
    cons, u_nom, _, _ = cbf.assemble(state, act)
    cfg = cbf.cfg
    qp_args = kernel_inputs(cons, u_nom, (cbf.a_min, cbf.rate_min), (cbf.a_max, cbf.rate_max),
                            state.cbf_u_prev, cfg.newton_ws_cap)
    qp_static = ((cfg.w_u_acc, cfg.w_u_steer), (cbf.a_min, cbf.rate_min),
                 (cbf.a_max, cbf.rate_max))
    centers = circle_centers_world(cbf.approx, state.pos, state.rot)
    q, pid, chunks_l, chunks_r = cbf.stencil_inputs(centers, state.path_id)
    pd_args = (q, pid, env.tables.left_seg, env.tables.right_seg, chunks_l, chunks_r)
    return qp_args, qp_static, pd_args


def check_kernels(qp_args, qp_static, pd_args) -> dict:
    import torch

    from sigmarl_tpu_torch.ops.boundary import (
        pseudo_distance_stencil, pseudo_distance_stencil_reference,
    )
    from sigmarl_tpu_torch.ops.qp import newton_solve, newton_solve_reference

    errs = {"qp_newton": 0.0, "boundary_stencil": 0.0}
    for it in (0, 1):
        u_k, _ = newton_solve(*qp_args, *qp_static, it)
        u_p, _ = newton_solve_reference(*qp_args, *qp_static, it)
        torch.cuda.synchronize()
        err = float((u_k - u_p).abs().max())
        print(f"K1 {it} iterations: max |u_kernel - u_plain| = {err:.3e} (atol 2e-5)")
        check(err <= 2e-5, f"K1 controls after {it} iterations differ by {err}")
        errs["qp_newton"] = max(errs["qp_newton"], err)
    for it, soft, tol in ((30, 0, 1e-4), (5, 3, 1e-3)):
        _, F_k = newton_solve(*qp_args, *qp_static, it, soft_iters=soft)
        _, F_p = newton_solve_reference(*qp_args, *qp_static, it, soft_iters=soft)
        torch.cuda.synchronize()
        gap = rel_gap(F_k, F_p)
        print(f"K1 {soft}+{it} iterations: max F gap (relative to 1+|F|) = {gap:.3e} (< {tol})")
        check(gap < tol and bool(torch.isfinite(F_k).all()), f"K1 F gap {gap} at {soft}+{it}")
    q, pid, lseg, rseg, cl, cr = pd_args
    for name, chunks in (("chunked", (cl, cr)), ("full scan", (None, None))):
        out = pseudo_distance_stencil(q, pid, lseg, rseg, *chunks)
        ref = pseudo_distance_stencil_reference(q, pid, lseg, rseg, *chunks)
        torch.cuda.synchronize()
        for side, a, b in (("left", out[0], ref[0]), ("right", out[1], ref[1])):
            err = float((a - b).abs().max())
            print(f"K2 {name} {side}: max |d_kernel - d_plain| = {err:.3e} (atol 2e-5)")
            check(err <= 2e-5 and bool(torch.isfinite(a).all()), f"K2 {name} {side} differs by {err}")
            if name == "chunked":
                errs["boundary_stencil"] = max(errs["boundary_stencil"], err)
    return errs


def small_input_check(dev) -> None:
    """The main path on the card against the CPU path (the kernels' plain
    versions) at B=8, from the same state with the same draws:

    - the assembled constraint sets agree to atol 1e-4, relative 1e-5
      (the two devices round sines and square roots apart);
    - the card's solution is no worse than the CPU's: its objective on the
      CPU constraint set is within a relative 1e-3 above the CPU's. Not
      symmetric: the solver has non-optimal fixed points, which rounding
      can enter on one device and miss on the other (this input: on the
      CPU one env stops at F = 26.286 against an optimum of 12.259, see
      scripts/qp_conditioning_probe.py);
    - the environment step from the same applied actions gives the same
      rewards and positions to atol 2e-5, observations to 1e-4 and the
      same done flags.
    """
    import torch

    from sigmarl_tpu_torch import (
        CBFConfig, CBFSafetyFilter, Parameters, cbf_filtered_step, make_env,
    )
    from sigmarl_tpu_torch.env.reset import ResetDraws
    from sigmarl_tpu_torch.env.structs import state_to
    from sigmarl_tpu_torch.ops.qp import newton_solve_reference
    from sigmarl_tpu_torch.safety.qp import kernel_inputs

    B = 8
    p = Parameters(
        scenario_type="cpm_entire", n_agents=N_AGENTS, num_vmas_envs=B, dt=0.1,
        max_steps=1_000_000, is_use_mtv_distance=False, is_obs_noise=False,
        is_using_cbf_testing=True, is_using_centralized_cbf=True,
    )
    ccfg = CBFConfig(n_agents=N_AGENTS, n_circles=3, dt=0.1, newton_iters=5, newton_soft_iters=3)
    env_c, env_g = make_env(p, device="cpu"), make_env(p, device=dev)
    cbf_c = CBFSafetyFilter(ccfg, env_c.cfg, env_c.tables, device="cpu")
    cbf_g = CBFSafetyFilter(ccfg, env_g.cfg, env_g.tables, device=dev)
    gen = torch.Generator().manual_seed(3)
    lim = env_c.action_limits
    state, _ = env_c.reset(generator=gen)
    for _ in range(3):
        act = (2 * torch.rand((B, N_AGENTS, 2), generator=gen) - 1) * lim
        state, *_ = cbf_filtered_step(env_c, cbf_c, state, act, generator=gen)
    act = (2 * torch.rand((B, N_AGENTS, 2), generator=gen) - 1) * lim
    draws = ResetDraws.sample(env_c.cfg, gen, "cpu")
    draws_g = ResetDraws(None, draws.path_u.to(dev), draws.point_u.to(dev), draws.speed_u.to(dev))
    sg, act_g = state_to(state, torch.device(dev)), act.to(dev)

    cons, u_nom, _, _ = cbf_c.assemble(state, act)
    cons_g, u_nom_g, _, _ = cbf_g.assemble(sg, act_g)
    cons_err = 0.0
    for f in ("A_s", "b_s", "h_s", "A_pi", "A_pj", "b_p", "h_p", "ws_s", "ws_p"):
        a, b = getattr(cons_g, f).cpu(), getattr(cons, f)
        check(torch.allclose(a, b, atol=1e-4, rtol=1e-5), f"constraint rows {f} differ")
        cons_err = max(cons_err, float((a - b).abs().max()))

    lo, hi = (cbf_c.a_min, cbf_c.rate_min), (cbf_c.a_max, cbf_c.rate_max)
    w_u = (ccfg.w_u_acc, ccfg.w_u_steer)

    def F(u):
        a = kernel_inputs(cons, u_nom, lo, hi, u, ccfg.newton_ws_cap)
        return newton_solve_reference(a[0], a[1], a[3], a[3], *a[4:], w_u, lo, hi, 0)[1].double()

    fc = cbf_c.filter_actions(state, act, u_init=state.cbf_u_prev)
    fg = cbf_g.filter_actions(sg, act_g, u_init=sg.cbf_u_prev)
    F_c, F_g = F(fc.u_star), F(fg.u_star.cpu())
    worse = float(((F_g - F_c) / (1.0 + F_c.abs())).max())

    applied = fc.safe_actions
    sc, obs_c, rew_c, done_c, _ = env_c.step(state, applied, reset_draws=draws)
    sg2, obs_g, rew_g, done_g, _ = env_g.step(sg, applied.to(dev), reset_draws=draws_g)
    rew_err = float((rew_g.cpu() - rew_c).abs().max())
    pos_err = float((sg2.pos.cpu() - sc.pos).abs().max())
    obs_err = float((obs_g.cpu() - obs_c).abs().max())
    print(f"small input (B={B}), card vs CPU: constraint rows {cons_err:.3e} (atol 1e-4); "
          f"card F above CPU F by at most {worse:.3e} (< 1e-3); env step: reward {rew_err:.3e}, "
          f"pos {pos_err:.3e} (atol 2e-5), obs {obs_err:.3e} (atol 1e-4)")
    check(worse < 1e-3, f"the card's solution is worse than the CPU's by {worse}")
    check(rew_err <= 2e-5 and pos_err <= 2e-5 and obs_err <= 1e-4, "card and CPU steps differ")
    check(torch.equal(done_g.cpu(), done_c), "done flags differ")
    check(obs_g.shape == (B, N_AGENTS, env_g.obs_dim), f"obs shape {tuple(obs_g.shape)}")


def kernel_report(qp_args, qp_static, pd_args, launches, errs) -> list:
    import torch

    from sigmarl_tpu_torch.ops.boundary import (
        pseudo_distance_stencil, pseudo_distance_stencil_reference,
    )
    from sigmarl_tpu_torch.ops.qp import newton_solve, newton_solve_reference, solve_occupancy
    from sigmarl_tpu_torch.safety.pseudo_distance import PD_CHUNK, chunk_rows, counting_segments

    singles, pairs, u0 = qp_args[:3]
    B, d = u0.shape
    N, P = d // 2, qp_args[5].shape[0]
    Ks, Kp = singles.shape[-1] // N, pairs.shape[-1] // P
    budget = dict(soft_iters=3)
    k1 = lambda: newton_solve(*qp_args, *qp_static, 5, **budget)  # noqa: E731
    k1_plain = lambda: newton_solve_reference(*qp_args, *qp_static, 5, **budget)  # noqa: E731
    k1_bytes = sum(t.numel() * t.element_size() for t in qp_args) + (d + 1) * 4 * B
    k1_bound, k1_by = bound_ms(B * qp_flops(N, Ks, Kp, P, 5, 3), k1_bytes)

    q, pid, lseg, rseg, cl, cr = pd_args
    R, Q = q.shape[:2]
    k2 = lambda: pseudo_distance_stencil(*pd_args)  # noqa: E731
    k2_plain = lambda: pseudo_distance_stencil_reference(*pd_args)  # noqa: E731
    # What this input needs: every selected segment tested once per row and
    # side, and the exact evaluation for all queries of a row only on the
    # segments that count for at least one of them.
    n_seg = cl.shape[1] * PD_CHUNK
    counting = sum(int(counting_segments(q, chunk_rows(seg, pid, ch)).sum())
                   for seg, ch in ((lseg, cl), (rseg, cr)))
    k2_flops = 2 * R * n_seg * _TEST_OPS + counting * Q * _SEG_OPS + 2 * R * Q
    k2_bytes = sum(t.numel() * t.element_size() for t in (q, pid, lseg, rseg, cl, cr)) + 2 * R * Q * 4
    k2_bound, k2_by = bound_ms(k2_flops, k2_bytes)
    k2_bound_all, k2_by_all = bound_ms(2 * R * Q * (n_seg * _SEG_OPS + 1), k2_bytes)

    rows = [
        dict(name="qp_newton", route="cuda", source="sigmarl_tpu_torch/csrc/qp_newton.cu",
             replaces="sigmarl_tpu/ops/qp_pallas.py:370", launches=launches["qp_newton"],
             max_abs_err=errs["qp_newton"], **cuda_ms_windows(k1, reps=20, queued=True),
             back_to_back_ms=cuda_ms_windows(k1, reps=20)["ms"],
             plain_ms=cuda_ms(k1_plain, reps=2), bound_ms=k1_bound, bound_by=k1_by,
             library_ms=None),
        dict(name="boundary_stencil", route="cuda",
             source="sigmarl_tpu_torch/csrc/boundary_stencil.cu",
             replaces="sigmarl_tpu/ops/boundary_pallas.py:89",
             launches=launches["boundary_stencil"], max_abs_err=errs["boundary_stencil"],
             **cuda_ms_windows(k2, reps=200, queued=True),
             back_to_back_ms=cuda_ms_windows(k2, reps=200)["ms"],
             plain_ms=cuda_ms(k2_plain, reps=20), bound_ms=k2_bound, bound_by=k2_by,
             library_ms=None),
    ]
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms queued behind a spin, the card's time alone "
              f"(median of 7 windows, {r['ms_min']:.4f} to {r['ms_max']:.4f}), "
              f"{r['back_to_back_ms']:.4f} ms back to back; bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, plain {r['plain_ms']:.3f} ms, no single PyTorch call computes it")
    print(f"K2 work: {counting} of {2 * R * n_seg} (row, side, segment) triples count for "
          f"some query ({counting / (2 * R * n_seg):.4f}); bound if every selected segment "
          f"were evaluated for every query: {k2_bound_all:.4f} ms by {k2_by_all}")
    occ = solve_occupancy(N, Ks, Kp, P, B)
    print(f"K1 footprint: {occ['smem_bytes']} B of shared memory per block (one env), "
          f"{occ['blocks_per_sm']} blocks per SM on {occ['sms']} SMs, "
          f"{occ['waves']:.2f} waves at B={B}")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    port = import_port()
    from sigmarl_tpu_torch.ops import build
    from sigmarl_tpu_torch.ops.boundary import pseudo_distance_stencil
    from sigmarl_tpu_torch.ops.qp import newton_solve

    dev = "cuda"
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"port {port.__version__})")
    print(smi)

    t0 = time.perf_counter()
    report = build.build_all(force=True)
    print(f"build: both kernels in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for lib, (sec, log) in report.items():
        info = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        print(f"  {lib}: {sec:.1f} s; " + " | ".join(info))

    t0 = time.perf_counter()
    env, cbf, policy, gen, state, obs = setup_main_path(dev)
    state, obs, finite, _ = rollout(env, cbf, policy, gen, state, obs, WARMUP_STEPS)
    torch.cuda.synchronize()
    check(finite, "non-finite values during the warm-up")
    print(f"main path set up and warmed up ({WARMUP_STEPS} steps from zero_state) "
          f"in {time.perf_counter() - t0:.1f} s")

    qp_args, qp_static, pd_args = capture_kernel_inputs(env, cbf, policy, gen, state, obs)
    errs = check_kernels(qp_args, qp_static, pd_args)

    newton_solve.launches = 0
    pseudo_distance_stencil.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, obs, finite, solved = rollout(env, cbf, policy, gen, state, obs, TIMED_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"qp_newton": newton_solve.launches,
                "boundary_stencil": pseudo_distance_stencil.launches}
    print(f"main path: {TIMED_STEPS} steps, launches {launches}, solved share {solved:.6f}")
    check(finite, "non-finite obs, reward or u* on the main path")
    check(obs.shape == (BATCH, N_AGENTS, env.obs_dim), f"obs shape {tuple(obs.shape)}")
    for k, n in launches.items():
        check(n == TIMED_STEPS, f"{k} launched {n} times in {TIMED_STEPS} steps")
    print(f"env-steps/s: {TIMED_STEPS * BATCH / elapsed:.1f} at B={BATCH}, N={N_AGENTS} "
          f"({elapsed / TIMED_STEPS * 1e3:.2f} ms/step) on {smi}")

    small_input_check(dev)
    rows = kernel_report(qp_args, qp_static, pd_args, launches, errs)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
