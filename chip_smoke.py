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
   finite. Prints env-steps/s beside the card's name and power limit, and
   the steps that ran the reset, compacted (at most 3B/8 = 384 envs
   reset: only those are spawned) and at full width: at least one
   compacted step in the timed window; one env step syncs the host once
   (PyTorch's sync debug mode counts the waits);
6. a small-input check at B=8: the card's constraint assembly, solve and
   environment step against the CPU path (the kernels' plain versions)
   from the same state with the same draws;
6a. the reset on the main path's env and state with one seeded mask of
   about 23 % of the envs: the compacted spawn against full width (whose
   draws carry the compacted rows in the resetting envs' rows) bit for
   bit, and both timed (medians of 7 windows, queued and back to back);
   then steps at B=1024 (N=4) with the spawn compacted and at full width
   on the card against the CPU (`utils/card_checks.py`, shared with the
   card test);
7. grouped filtering (`scripts/bench_grouped.py`'s setup: groups of at most
   4, Kp = 18 pair rows): K1 against its plain version on a grouped input
   with the tolerances of phase 4, 16 timed steps with one launch of each
   kernel per step, K1's time, bound and footprint;
7a. the main path's measuring and certifying programs through their
   functions, at full size, each printing its JSON lines, the kernels'
   launches counted around each: `sigmarl_tpu_torch.bench` at B=1024
   and as 4 x 1024 sub-batches (one launch of each kernel per sub-batch
   per step: 192 and 768), `--grouped` (plain and grouped, B=1024) and
   `--census` (the resetting envs per step over 64 steps);
   `bench_latency` at B=1 and B=16 (300 timed steps each, a wait for the
   card after each); `check_warm_start` at B=1024, N=15, 3+5, 20 steps of
   the (0.5, 0) stress rollout against the cold 2+30 oracle, which must
   be ok (p99 of the relative objective gap below 1e-3); then K1 and K2
   against their plain versions, as in phase 4, on the latency path's
   inputs (B=1 and B=16 at 3+5; K2 at 15 and 240 rows) and K1 on the
   cold oracle's input (B=1024, also at 2+30);
7b. `check_warm_start` at its default N=4, B=4 fixture (0+6, 10 steps):
   the stress rollout draws on the host, so the card's reset state must
   equal the CPU's bit for bit, the card's default generator stays
   untouched, and the certificate must be ok (max gap below 1e-3);
7c. weak scaling over ranks (`sigmarl_tpu_torch.bench_scaling` at JAX's
   defaults: 128 envs per rank, N=15, T=32, 3 timed chunks after one
   warm-up, the filter at 2+10): K1 and K2 against their plain versions
   on the bench's input captured in this process at B=128 (K1's controls
   also bit for bit at 2+10), then the launcher with 1 rank over nccl and
   2 ranks sharing the card over gloo, each printing its row and the
   summary: each rank launches each kernel (chunks + 1) x T = 128 times,
   runs 2 collectives per timed step (the ranks' reset counts and the
   reward's all-reduce), a finite reward, the card's name and power limit
   in each row, the 2-rank row marked as mechanics;
8. CBF-informed training at the paper's configuration (cpm_mixed, N=4,
   B=32, T=128, 30 epochs of minibatch 512, "cbf" reward from the
   margins-only filter, observation noise on): 2 iterations of
   `MAPPOCAVs.train`, K2 launched 128 times and K1 never per iteration,
   finite losses, moved weights, the checkpoint reloaded equal; seconds per
   iteration split into rollout, GAE and update, and rollout frames/s;
9. CBF-filtered training, one iteration at the main path's width (N=15,
   B=1024, T=16, centralized filter at its 2+15 budget, minibatch 4096) and
   one decentralized at N=4, B=32: K1 and K2 launched 16 times each, the
   solved share, finite obs, rewards and losses; K1 against its plain
   version and timed on the centralized input at 2+15; the centralized
   run's weights saved as a reward-keyed checkpoint for phase 14; the
   reset steps, compacted and at full width;
10. one PPO minibatch update on the card against the CPU at a small size
    (loss, gradients, updated parameters);
11. XP-MARL as the ICRA'25 priority comparison runs it (cpm_mixed, N=4,
    B=32, T=128, 30 epochs of minibatch 512, observation noise on, no MTV
    distance): one iteration with learned and one with random priority,
    then one with opponent modeling in the same setting. Finite losses (the
    priority loss under learned priority), every network moved (all four
    under learned priority), every env's rank a permutation of 0..N-1, N
    policy calls per rollout step in the propagation loop (2 with opponent
    modeling), no kernel launched; the split of each iteration;
12. wide XP-MARL with a CBF-filtered rollout on the `Parameters` defaults
    (MTV distance and observation noise on): cpm_entire, N=15, B=1024,
    T=16, learned priority with communication noise, the centralized
    filter at its 2+15 budget, one epoch of minibatch 4096: K1 and K2
    launched 16 times each, 15 policy calls per step, the solved share,
    finite obs, rewards and losses, the reset steps (compacted and full
    width);
13. card against CPU at a small size, the same weights and draws: one
    XP-MARL propagation step (N=4, B=8; actions to atol 1e-5) and one env
    step with the MTV distance, observation noise and a history of 2 (the
    tolerances of phase 6);
14. testing (`main_testing`'s function) on phase 9's centralized model
    directory (cpm_entire, N=15, the 3x256 policy), deterministic, B=32,
    128 recorded steps: finite records, single-agent resets counted, the
    JAX function's metric keys, no kernel launched; env-steps/s and the
    share of steps that ran the reset;
14a. the challenge buffer on phase 9's centralized configuration at its
    defaults (record 1.0, replay 0.2, 100 slots, records from 10 steps
    back), 2 iterations: K1 and K2 once per rollout step, solved share 1.0,
    finite losses, the records and replays of each iteration, a record in
    the buffer and a replay by the end (else the plain MAPPO iteration at
    the same width carries that check, and the phase says so), and no
    compacted reset step (the buffer's replay works at full width); then its
    record and replay steps on the card against the CPU (N=4, B=8;
    `utils/card_checks.py`, shared with the card test);
15. CBF evaluation (`main_eval`'s function at its defaults: cpm_mixed,
    N=4, B=32, CLF nominal, windowed flag set), 128 steps centralized and
    then decentralized: K1 and K2 once per step, solved share 1.0, a
    finite QP infeasibility rate; then 32 steps of the same env and filter
    with pd_topk_chunks = 0, the one setting that takes the windowed
    stencil, through the eval layer's `rollout`, with the same checks;
16. the ITSC'25 filter sweep through its driver
    (`eval/papers.py::itsc25_safety_filter`, one agent, B=32, CLF at 0.6
    m/s) for 1 to 5 circles, 32 steps each: K1 at P = 0 and K2 once per
    step, the checks of phase 15 on the record the driver wrote;
17. CLF-filtered testing at the main path's width (N=15, B=1024, 3+5, 16
    steps; the reset steps, compacted and at full width), and AT25
    (`eval/at25.py::run_model`, scripted, N=15, B=1, 256 steps from
    `default_poses`): the event counts;
17a. the standalone CBF studies: the ECC'25 MTV predictor trained 3 epochs
    on the card and on the CPU from the same weights and permutations; the
    ECC'25 grid (`eval/papers.py::ecc25_cbf_grid`, figures off: 60-epoch
    predictor, RL nominal fit, all eight two-agent runs) on the card, one
    run against the CPU; the full LCSS'25 sweep
    (`eval/papers.py::lcss25_ttcbf`, 15 x 15 x 400 steps per grid) on the
    card against the CPU (collided maps equal); no kernel (plain PyTorch:
    no TPU kernel computes these); seconds per run;
18. the kernels on those inputs against their plain versions: K1 with
    active CLF rows (near-zero ones injected) at N=4 and N=15 and at P = 0
    for C = 1, 3 and 5, controls after 0 and 1 iterations bit for bit and
    F as in phase 4; K2 at C = 1 and 5 and with a window's chunks as the
    selection, bit for bit; then one testing-mode, CLF-filtered,
    fp16-parity step on the card against the CPU (N=4, B=8;
    `sigmarl_tpu_torch/utils/card_checks.py`, shared with the card test);
18a. data parallelism over ranks (`parallel/mesh.py`): the CBF-filtered
    iteration at the main path's width with the challenge buffer on
    (N=15, B=1024, T=16, 2+15) from one start and draws drawn once on the
    card, in this process and then (a) on 2 ranks sharing the card over
    gloo (512 envs each) and (b) on a 1-rank nccl group, each held
    against this process's iteration (`utils/card_checks.py::
    sharded_vs_unsharded`: the rollout bit for bit or within 1e-3 with
    integer fields and flags equal, the parameter rule, K1 and K2 once
    per rollout step on every rank, counts set to 0 before each
    iteration, every rank's reset steps those of this process, none
    compacted with the buffer on); a second iteration from the
    generators timed in each;
18b. the host tools on the card against the CPU: the dense QP oracle on
    `to_dense` of a filtered step's set, `pseudo_distance_to_polyline`,
    `current_lanelet_id`; an `InteractiveSession` and `debug_demo`
    stepping on the card;
19. kernel times beside each kernel's bound and its plain version's time,
    K1's shared memory, blocks per SM and waves, the launches on every
    path above, K1's grouped, training-budget, CLF, one-agent, latency
    (B=1, B=16) and cold-oracle (2+30) timings and K2's at 1 and 5
    circles, with the window and at the latency path's 15 and 240 rows
    (each with its plain
    version's time, its launches on its path and its largest difference
    from its plain version in phase 18), K1 at 2+10 and K2 on the
    scaling bench's input (phase 7c), as one JSON line; then
    the result line. `ms`
    (with `ms_min`, `ms_max`) is the median, least and largest of 7
    CUDA-event windows queued behind a spin on the card, warmed up: the
    card's time alone. `back_to_back_ms` is the median of 7 windows of
    calls as the host issues them, which for a kernel shorter than its
    wrapper's host cost (K2) times the host's launch rate. K2's bound counts the work this input needs: every
    selected segment tested once per row, and the exact evaluation only on
    the segments that count for some query of the row (the bound for every
    segment evaluated for every query is printed beside it).

The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_AGENTS, BATCH, WARMUP_STEPS, TIMED_STEPS = 15, 1024, 8, 16
# Published peaks of one H100 SXM (NVIDIA data sheet, 700 W): float32
# outside the tensor cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# The training configurations, as phases 8, 9, 11 and 12 run them and
# `scripts/profile_torch_training.py` profiles them. The informed one is the
# paper's reward sweep (`sigmarl_tpu/eval/papers.py:278-285`), observation
# noise on as `Parameters` has it; the XP-MARL one the ICRA'25 priority
# comparison (`papers.py:105-111`), learned priority (phase 11 also runs
# "random"); opponent modeling the same setting with its pad instead.
INFORMED_TRAINING = dict(
    scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=32, dt=0.1, max_steps=128,
    num_epochs=30, minibatch_size=512, is_use_mtv_distance=False,
    rew_method="cbf", h_nom=0.2, is_using_cbf_training=True, is_solve_qp=False,
)
XPMARL_TRAINING = dict(
    scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=32, dt=0.1, max_steps=128,
    num_epochs=30, minibatch_size=512, is_use_mtv_distance=False,
    is_using_prioritized_marl=True, prioritization_method="marl",
)
OPPONENT_TRAINING = {**XPMARL_TRAINING, "is_using_prioritized_marl": False,
                     "is_using_opponent_modeling": True}
# Learned priority with a CBF-filtered rollout at the main path's width, on
# the `Parameters` defaults (MTV distance and observation noise on).
WIDE_XPMARL_TRAINING = dict(
    scenario_type="cpm_entire", n_agents=N_AGENTS, num_vmas_envs=BATCH, dt=0.1, max_steps=16,
    num_epochs=1, minibatch_size=4096, is_using_prioritized_marl=True,
    prioritization_method="marl", is_communication_noise=True, is_using_cbf_training=True,
    is_solve_qp=True, is_apply_cbf_action=True, is_using_centralized_cbf=True,
)
FILTERED_TRAINING = dict(
    scenario_type="cpm_entire", n_agents=N_AGENTS, num_vmas_envs=BATCH, dt=0.1, max_steps=16,
    num_epochs=1, minibatch_size=4096, is_use_mtv_distance=False, is_obs_noise=False,
    rew_method="cbf", is_using_cbf_training=True, is_solve_qp=True, is_apply_cbf_action=True,
    is_using_centralized_cbf=True,
)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    from sigmarl_tpu_torch.device import nvidia_smi_line

    return nvidia_smi_line()


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


def host_syncs(fn) -> list:
    """The host syncs while `fn` runs, as "file:line" of the code that
    waited (`sigmarl_tpu_torch.device.host_syncs`)."""
    from sigmarl_tpu_torch.device import host_syncs

    return host_syncs(fn)


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
    """The main path at its full width (`sigmarl_tpu_torch.bench.main_path`):
    (env, filter, policy, generator, the all-zero state, zero obs)."""
    from sigmarl_tpu_torch.bench import main_path

    return main_path(BATCH, N_AGENTS, dev)


def policy_actions(env, policy, obs, gen):
    from sigmarl_tpu_torch.bench import policy_actions

    return policy_actions(env, policy, obs, gen)


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


def qp_capture(cbf, state, act, group_id=None):
    """K1's inputs and static arguments at this state and action."""
    from sigmarl_tpu_torch.safety.qp import kernel_inputs

    cfg = cbf.cfg
    cons, u_nom, _, _ = cbf.assemble(state, act, group_id)
    args = kernel_inputs(cons, u_nom, (cbf.a_min, cbf.rate_min), (cbf.a_max, cbf.rate_max),
                         state.cbf_u_prev, cfg.newton_ws_cap)
    static = ((cfg.w_u_acc, cfg.w_u_steer), (cbf.a_min, cbf.rate_min),
              (cbf.a_max, cbf.rate_max))
    return args, static


def capture_kernel_inputs(env, cbf, policy, gen, state, obs):
    """The inputs the main path gives both kernels at this state."""
    from sigmarl_tpu_torch.safety.circles import circle_centers_world

    qp_args, qp_static = qp_capture(cbf, state, policy_actions(env, policy, obs, gen))
    centers = circle_centers_world(cbf.approx, state.pos, state.rot)
    q, pid, chunks_l, chunks_r = cbf.stencil_inputs(centers, state.path_id)
    pd_args = (q, pid, env.tables.left_seg, env.tables.right_seg, chunks_l, chunks_r)
    return qp_args, qp_static, pd_args


def check_qp(qp_args, qp_static, label: str = "", budgets=((30, 0), (5, 3)),
             atol: float = 2e-5) -> float:
    """K1 against its plain version on one input: controls after 0 and 1
    iterations to `atol` (0: bit for bit), F after 30 iterations to a
    relative 1e-4 and at each other (stiff, soft) budget to 1e-3. Returns
    the largest control difference."""
    import torch

    from sigmarl_tpu_torch.ops.qp import newton_solve, newton_solve_reference

    worst = 0.0
    for it in (0, 1):
        u_k, _ = newton_solve(*qp_args, *qp_static, it)
        u_p, _ = newton_solve_reference(*qp_args, *qp_static, it)
        torch.cuda.synchronize()
        err = float((u_k - u_p).abs().max())
        print(f"K1{label} {it} iterations: max |u_kernel - u_plain| = {err:.3e} (atol {atol:g})")
        check(err <= atol and bool(torch.isfinite(u_k).all()),
              f"K1{label} controls after {it} iterations differ by {err}")
        worst = max(worst, err)
    for it, soft in budgets:
        tol = 1e-4 if (it, soft) == (30, 0) else 1e-3
        _, F_k = newton_solve(*qp_args, *qp_static, it, soft_iters=soft)
        _, F_p = newton_solve_reference(*qp_args, *qp_static, it, soft_iters=soft)
        torch.cuda.synchronize()
        gap = rel_gap(F_k, F_p)
        print(f"K1{label} {soft}+{it} iterations: max F gap (relative to 1+|F|) = {gap:.3e} "
              f"(< {tol})")
        check(gap < tol and bool(torch.isfinite(F_k).all()),
              f"K1{label} F gap {gap} at {soft}+{it}")
    return worst


def check_kernels(qp_args, qp_static, pd_args) -> dict:
    import torch

    from sigmarl_tpu_torch.ops.boundary import (
        pseudo_distance_stencil, pseudo_distance_stencil_reference,
    )

    errs = {"qp_newton": check_qp(qp_args, qp_static), "boundary_stencil": 0.0}
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


def qp_sizes(qp_args):
    """(N, Ks, Kp, P, B) of K1's inputs; Kp = 0 for one agent (no pairs)."""
    singles, pairs, u0 = qp_args[:3]
    B, d = u0.shape
    N, P = d // 2, qp_args[5].shape[0]
    return N, singles.shape[-1] // N, (pairs.shape[-1] // P if P else 0), P, B


def k1_timing(qp_args, qp_static, n_iters: int, soft_iters: int) -> dict:
    """K1 queued behind a spin at one budget, with its bound, footprint and
    its plain version's time on the same input."""
    from sigmarl_tpu_torch.ops.qp import newton_solve, newton_solve_reference, solve_occupancy

    N, Ks, Kp, P, B = qp_sizes(qp_args)
    d = 2 * N
    nbytes = sum(t.numel() * t.element_size() for t in qp_args) + (d + 1) * 4 * B
    bound, by = bound_ms(B * qp_flops(N, Ks, Kp, P, n_iters, soft_iters), nbytes)
    win = cuda_ms_windows(lambda: newton_solve(*qp_args, *qp_static, n_iters,
                                               soft_iters=soft_iters), reps=10, queued=True)
    plain = cuda_ms(lambda: newton_solve_reference(*qp_args, *qp_static, n_iters,
                                                   soft_iters=soft_iters), reps=1)
    occ = solve_occupancy(N, Ks, Kp, P, B)
    return dict(N=N, B=B, Kp=Kp, budget=f"{soft_iters}+{n_iters}", **win, bound_ms=bound,
                bound_by=by, plain_ms=plain, smem_bytes=occ["smem_bytes"],
                blocks_per_sm=occ["blocks_per_sm"], waves=occ["waves"])


def k2_timing(pd_args) -> dict:
    """K2 queued behind a spin on one input, with its bound and its plain
    version's time. The bound counts what this input needs: every selected
    segment tested once per row and side, and the exact evaluation for all
    queries of a row only on the segments that count for at least one of
    them (`bound_all`: every selected segment evaluated for every query)."""
    from sigmarl_tpu_torch.ops.boundary import (
        pseudo_distance_stencil, pseudo_distance_stencil_reference,
    )
    from sigmarl_tpu_torch.safety.pseudo_distance import PD_CHUNK, chunk_rows, counting_segments

    q, pid, lseg, rseg, cl, cr = pd_args
    R, Q = q.shape[:2]
    n_seg = cl.shape[1] * PD_CHUNK
    counting = sum(int(counting_segments(q, chunk_rows(seg, pid, ch)).sum())
                   for seg, ch in ((lseg, cl), (rseg, cr)))
    flops = 2 * R * n_seg * _TEST_OPS + counting * Q * _SEG_OPS + 2 * R * Q
    nbytes = sum(t.numel() * t.element_size() for t in (q, pid, lseg, rseg, cl, cr)) + 2 * R * Q * 4
    bound, by = bound_ms(flops, nbytes)
    win = cuda_ms_windows(lambda: pseudo_distance_stencil(*pd_args), reps=200, queued=True)
    plain = cuda_ms(lambda: pseudo_distance_stencil_reference(*pd_args), reps=20)
    return dict(rows=R, queries=Q, chunks=cl.shape[1], **win, bound_ms=bound, bound_by=by,
                plain_ms=plain, segments=n_seg, counting=counting,
                bound_all=bound_ms(2 * R * Q * (n_seg * _SEG_OPS + 1), nbytes))


def print_k1_timing(what: str, r: dict, smi: str) -> None:
    print(f"K1 {what} (N={r['N']}, B={r['B']}, Kp={r['Kp']}, {r['budget']}): {r['ms']:.4f} ms "
          f"queued ({r['ms_min']:.4f} to {r['ms_max']:.4f}), bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}, plain {r['plain_ms']:.3f} ms; {r['smem_bytes']} B of shared memory, "
          f"{r['blocks_per_sm']} blocks per SM, {r['waves']:.2f} waves; on {smi}")


# The reset's timing: the share of envs that reset in one step of the
# main path (the JAX package's measure, `scripts/measure_resets.py`), and
# calls per CUDA-event window.
RESET_SHARE, RESET_REPS = 0.23, 5


def reset_timing_phase(env, state, smi) -> None:
    """`apply_reset` on the main path's env and live state (cpm_entire,
    N=15, B=1024) with one seeded mask of about 23 % of the envs (whole
    envs, as the main path resets them): the compacted spawn against full
    width, medians of 7 CUDA-event windows of 5 calls, queued behind a
    spin (the card's time) and back to back (as the host issues them).
    The full-width draws carry the compacted rows in the resetting envs'
    rows, so both give the same state: checked bit for bit."""
    import torch

    from sigmarl_tpu_torch.env.reset import ResetDraws, apply_reset, compact_slots

    dev = env.device
    g = torch.Generator(device=dev).manual_seed(23)
    env_any = torch.rand((BATCH,), generator=g, device=dev) < RESET_SHARE
    mask = env_any[:, None].expand(BATCH, N_AGENTS).contiguous()
    k = int(env_any.sum())
    slots = compact_slots(BATCH, False)
    check(0 < k <= slots, f"{k} resetting envs for {slots} slots")
    draws = ResetDraws.sample(env.cfg, g, dev, compact_slots=slots)
    rows = env_any.nonzero()[:, 0]
    draws.path_u[rows] = draws.path_u_c[:k]
    draws.point_u[rows] = draws.point_u_c[:k]
    fns = {"compacted": lambda: apply_reset(env.cfg, env.tables, state, mask, draws,
                                            compact=(0, k)),
           "full width": lambda: apply_reset(env.cfg, env.tables, state, mask, draws)}
    a, b = fns["compacted"](), fns["full width"]()
    differ = [f for f in a.__dataclass_fields__ if not torch.equal(getattr(a, f), getattr(b, f))]
    check(not differ, f"the compacted reset differs from full width in {differ}")
    for name, fn in fns.items():
        q = cuda_ms_windows(fn, RESET_REPS, queued=True)
        bb = cuda_ms_windows(fn, RESET_REPS)
        print(f"reset ({name}, {k} of {BATCH} envs, N={N_AGENTS}): {q['ms']:.4f} ms queued "
              f"({q['ms_min']:.4f} to {q['ms_max']:.4f}), {bb['ms']:.4f} ms back to back "
              f"({bb['ms_min']:.4f} to {bb['ms_max']:.4f}); on {smi}")
    print("reset: the compacted and full-width resets give the same state bit for bit")


def compact_small_check(dev) -> None:
    """Steps at B=1024 (cpm_entire, N=4) with the spawn compacted and at
    full width on the card against the CPU from the same state and draws,
    to the tolerances of `utils/card_checks.py::compact_reset_card_vs_cpu`
    (which the card test shares)."""
    from sigmarl_tpu_torch.utils.card_checks import compact_reset_card_vs_cpu

    checks = compact_reset_card_vs_cpu(dev)
    print("compacted reset steps (N=4, B=1024), card vs CPU: " + "; ".join(
        f"{c.what} {c.value:.3g} (<= {c.limit:g})" for c in checks))
    for c in checks:
        check(c.ok, f"card vs CPU: {c.what} {c.value} above {c.limit}")


def grouped_phase(env, policy, gen, smi) -> dict:
    """Grouped filtering as `scripts/bench_grouped.py` sets it up (cpm_entire,
    N=15, B=1024, groups of at most 4, 3+5 budget): K1 against its plain
    version on a grouped input (Kp = 18), then 16 timed steps with one
    launch of each kernel per step, and K1's time and footprint."""
    import torch

    from sigmarl_tpu_torch import CBFConfig, CBFSafetyFilter, zero_state
    from sigmarl_tpu_torch.ops.boundary import pseudo_distance_stencil
    from sigmarl_tpu_torch.ops.qp import newton_solve
    from sigmarl_tpu_torch.safety.grouping import group_agents_k_nearest, same_group_mask

    cbf = CBFSafetyFilter(
        CBFConfig(n_agents=N_AGENTS, n_circles=3, dt=0.1, newton_iters=5, newton_soft_iters=3),
        env.cfg, env.tables, max_group_size=4, device=env.device,
    )
    state = zero_state(env.cfg, env.device)
    obs = torch.zeros((BATCH, N_AGENTS, env.obs_dim), device=env.device)
    state, obs, finite, _ = rollout(env, cbf, policy, gen, state, obs, WARMUP_STEPS)
    check(finite, "non-finite values during the grouped warm-up")
    gid = group_agents_k_nearest(state.pos, 4)
    cross = float((~same_group_mask(gid, cbf._pi, cbf._pj)).float().mean())
    qp_args, qp_static = qp_capture(cbf, state, policy_actions(env, policy, obs, gen), gid)
    check(qp_args[1].shape[-1] == 18 * qp_args[5].shape[0], "grouped rows are not Kp = 18")
    print(f"grouped input: {cross:.4f} of the pairs cross groups")
    err = check_qp(qp_args, qp_static, " grouped")

    newton_solve.launches = 0
    pseudo_distance_stencil.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, obs, finite, solved = rollout(env, cbf, policy, gen, state, obs, TIMED_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"qp_newton": newton_solve.launches,
                "boundary_stencil": pseudo_distance_stencil.launches}
    print(f"grouped path: {TIMED_STEPS} steps, launches {launches}, solved share {solved:.6f}, "
          f"{TIMED_STEPS * BATCH / elapsed:.1f} env-steps/s on {smi}")
    check(finite, "non-finite obs, reward or u* on the grouped path")
    for k, n in launches.items():
        check(n == TIMED_STEPS, f"{k} launched {n} times in {TIMED_STEPS} grouped steps")
    timing = k1_timing(qp_args, qp_static, 5, 3)
    print_k1_timing("grouped", timing, smi)
    return dict(launches=launches, max_abs_err=err, k1=timing)


def run_counted(fn):
    """(fn's result, the kernels' launches while it ran), the counts set
    to 0 just before."""
    zero_launch_counts()
    out = fn()
    return out, launch_counts()


def check_launches(launches: dict, want: dict, what: str) -> None:
    for k, n in launches.items():
        check(n == want[k], f"{what}: {k} launched {n} times, want {want[k]}")


def programs_phase(smi) -> dict:
    """The main path's measuring and certifying programs, through their
    functions, at full size: the bench at B=1024 and as 4 x 1024 sub-batches
    (`python -m sigmarl_tpu_torch.bench --batch ...`), `--grouped`,
    `--census`, the latency at B=1 and B=16 (`bench_latency`) and the
    warm-start certificate at B=1024, N=15, 3+5, 20 steps
    (`check_warm_start`), each printing its lines, with the kernels'
    launches counted around each; then K1 and K2 against their plain
    versions on the new inputs: the latency path's at B=1 and B=16 (3+5;
    K2 at 15 and 240 rows) and the certificate's cold oracle (2+30 at
    B=1024, from the stress rollout's last state)."""
    from sigmarl_tpu_torch import bench, bench_latency, check_warm_start
    from sigmarl_tpu_torch.safety.qp import kernel_inputs

    per_chunk = (bench.N_CHUNKS + 1) * bench.T_STEPS  # the warm-up chunk and the timed ones
    out = {}
    for batch, n_sub in ((BATCH, 1), (bench.SUB_BATCHES * BATCH, bench.SUB_BATCHES)):
        rc, launches = run_counted(lambda: bench.main(["--batch", str(batch)]))
        check(rc == 0, f"bench --batch {batch} exited {rc}")
        n = per_chunk * n_sub
        check_launches(launches, {"qp_newton": n, "boundary_stencil": n}, f"bench B={batch}")
        print(f"bench B={batch}: launches {launches} ({n_sub} of each kernel per step)")
        out[f"bench_b{batch}"] = launches
    for flag, n in (("--grouped", 2 * per_chunk),
                    ("--census", bench.T_STEPS + bench.CENSUS_STEPS)):
        rc, launches = run_counted(lambda: bench.main([flag]))
        check(rc == 0, f"bench {flag} exited {rc}")
        check_launches(launches, {"qp_newton": n, "boundary_stencil": n}, f"bench {flag}")
        print(f"bench {flag}: launches {launches}")
        out["bench" + flag.replace("--", "_")] = launches

    # One more step than timed: the one whose host syncs are counted.
    n = bench_latency.WARMUP_STEPS + 1 + bench_latency.STEPS
    for batch in bench_latency.BATCHES:
        r, launches = run_counted(lambda: bench_latency.measure(batch, N_AGENTS))
        print(json.dumps(r))
        check_launches(launches, {"qp_newton": n, "boundary_stencil": n}, f"latency B={batch}")
        check(math.isfinite(r["p99"]), f"latency B={batch}: p99 {r['p99']}")
        out[f"latency_b{batch}"] = launches
        env, cbf, policy, gen, _, _ = bench.main_path(batch, N_AGENTS, "cuda")
        state, obs = env.reset(generator=gen)
        state, obs, finite, _ = rollout(env, cbf, policy, gen, state, obs,
                                        bench_latency.WARMUP_STEPS)
        check(finite, f"non-finite values on the latency path at B={batch}")
        qp_args, qp_static, pd_args = capture_kernel_inputs(env, cbf, policy, gen, state, obs)
        out[f"latency_b{batch}_inputs"] = (qp_args, qp_static, pd_args,
                                           check_kernels(qp_args, qp_static, pd_args))

    (line, (env, warm, cold, state, act)), launches = run_counted(
        lambda: check_warm_start.certificate(BATCH, N_AGENTS, 5, 3, 10.0, 30, CERT_STEPS,
                                             device="cuda"))
    print(json.dumps(line))
    # Per step: the cold and the warm solve, the two evaluations and the
    # step's own solve (K1); the three assemblies and the step's (K2).
    check_launches(launches, {"qp_newton": 5 * CERT_STEPS, "boundary_stencil": 4 * CERT_STEPS},
                   "certificate")
    check(line["n_instances"] == BATCH * CERT_STEPS and line["ok"],
          f"the warm-start certificate is not ok: {line['gap_quantiles']}")
    out["certificate"] = launches
    cons, u_nom, _, _ = cold.assemble(state, act)
    cfg = cold.cfg
    cold_args = kernel_inputs(cons, u_nom, (cold.a_min, cold.rate_min),
                              (cold.a_max, cold.rate_max), None, cfg.newton_ws_cap)
    cold_static = ((cfg.w_u_acc, cfg.w_u_steer), (cold.a_min, cold.rate_min),
                   (cold.a_max, cold.rate_max))
    err = check_qp(cold_args, cold_static, " cold", budgets=((30, 0), (5, 3), (30, 2)))
    out["cold"] = (cold_args, cold_static, err)
    return out


def fixture_certificate_phase(smi) -> dict:
    """`check_warm_start` at its default N=4, B=4 fixture (0+6 warm
    iterations, the cold 2+30 oracle, 10 stress steps) on the card: the
    stress rollout draws on the host and resets there (`stress_setup`), so
    the card's reset state must be the CPU's bit for bit, the card's
    default generator must stay untouched, and the line must be ok (max
    gap below 1e-3). Also the card's own reset from the same host draws:
    the same spawn (integer fields, positions, headings, speeds) bit for
    bit, and how far the geometry derived from it lies from the CPU's.
    Returns the kernels' launches."""
    import dataclasses

    import torch

    from sigmarl_tpu_torch import check_warm_start
    from sigmarl_tpu_torch.env.reset import ResetDraws

    args = (4, 4, 6, 0, 10.0, 30)
    env, _, _, card, _, _ = check_warm_start.stress_setup(*args, device="cuda")
    host = check_warm_start.stress_setup(*args, device="cpu")[3]
    fields = [f.name for f in dataclasses.fields(host)]
    differ = [f for f in fields if not torch.equal(getattr(card, f).cpu(), getattr(host, f))]
    print(f"fixture certificate: reset state on the card against the CPU: "
          f"{'bit for bit' if not differ else 'fields differ: ' + ', '.join(differ)}")
    check(not differ, f"the fixture's reset on the card differs from the CPU's in {differ}")
    own, _ = env.reset(draws=ResetDraws.sample(env.cfg, torch.Generator().manual_seed(0),
                                               "cpu").to("cuda"))
    apart = {f: float((getattr(own, f).cpu().double() - getattr(host, f).double()).abs().max())
             for f in fields if not torch.equal(getattr(own, f).cpu(), getattr(host, f))}
    print(f"fixture certificate: the card's own reset from the host draws against the CPU's: "
          f"fields apart (largest difference) {apart}")
    spawn = {"pos", "rot", "speed", "path_id", "point_id", "scenario_id"}
    check(not spawn & set(apart), f"the card's spawn from the host draws differs in {apart}")
    rng = torch.cuda.get_rng_state()
    (line, _), launches = run_counted(lambda: check_warm_start.certificate(device="cuda"))
    print(json.dumps(line))
    check(torch.equal(rng, torch.cuda.get_rng_state()),
          "the certificate drew from the card's default generator")
    check_launches(launches, {"qp_newton": 50, "boundary_stencil": 40}, "fixture certificate")
    check(line["n_instances"] == 40 and line["ok"],
          f"the fixture's certificate is not ok: max gap {line['max_objective_gap']}, "
          f"max u dev {line['max_u_dev']}")
    return launches


def scaling_phase(smi) -> dict:
    """Weak scaling over ranks (`python -m sigmarl_tpu_torch.bench_scaling`)
    at JAX's defaults: 128 envs per rank, N=15, T=32, one warm-up and 3
    timed chunks, the filter at 2+10; first K1 and K2 against their plain
    versions on the input the bench's workload gives them, captured in this
    process at B=128 after 4 steps from the all-zero state (K1's controls
    bit for bit after 0 and 1 iterations and at 2+10), then the launcher:
    1 rank over nccl and 2 ranks sharing the card over gloo. Each rank
    launches each kernel (chunks + 1) x T times, runs 2 collectives per
    timed step, a finite reward; the 2-rank row measures mechanics."""
    import torch

    from sigmarl_tpu_torch import bench_scaling, zero_state
    from sigmarl_tpu_torch.ops.qp import newton_solve, newton_solve_reference

    args = bench_scaling.parse_args([])
    cfg = bench_scaling.config(args)
    env, cbf, policy = bench_scaling.workload(cfg, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = zero_state(env.cfg, env.device)
    obs = torch.zeros((args.per_device_batch, args.n_agents, env.obs_dim), device="cuda")
    state, obs, finite, _ = rollout(env, cbf, policy, gen, state, obs, 4)
    check(finite, "non-finite values on the scaling bench's workload")
    qp_args, qp_static, pd_args = capture_kernel_inputs(env, cbf, policy, gen, state, obs)
    errs = check_kernels(qp_args, qp_static, pd_args)
    budget = (args.newton_iters, cbf.cfg.newton_soft_iters)
    u_k, F_k = newton_solve(*qp_args, *qp_static, budget[0], soft_iters=budget[1])
    u_p, F_p = newton_solve_reference(*qp_args, *qp_static, budget[0], soft_iters=budget[1])
    torch.cuda.synchronize()
    err = float((u_k - u_p).abs().max())
    print(f"K1 scaling input (N={args.n_agents}, B={args.per_device_batch}, {budget[1]}+"
          f"{budget[0]}): max |u_kernel - u_plain| = {err:.3e}, max |F_kernel - F_plain| = "
          f"{float((F_k - F_p).abs().max()):.3e}")
    check(err == 0.0, f"K1 at {budget[1]}+{budget[0]} differs from its plain version by {err}")
    errs["qp_newton"] = max(errs["qp_newton"], err)

    lines = bench_scaling.launch(args)
    rows, summary = lines[:-1], lines[-1]
    per_rank = (args.chunks + 1) * args.steps
    check([r["global_devices"] for r in rows] == [1, 2], f"scaling rows {rows}")
    for r in rows:
        what = f"scaling, {r['global_devices']} ranks over {r['backend']}"
        for launches in r["launches"]:
            check_launches(launches, {"qp_newton": per_rank, "boundary_stencil": per_rank}, what)
        check(math.isfinite(r["reward"]), f"{what}: reward {r['reward']}")
        check(r["collectives_per_step"] == 2,
              f"{what}: {r['collectives_per_step']} collectives per step, want 2")
        check(r["device"] == smi, f"{what}: device line {r['device']!r}")
    check(rows[0]["backend"] == "nccl" and not rows[0]["mechanics"],
          f"1 rank: backend {rows[0]['backend']}, mechanics {rows[0]['mechanics']}")
    check(rows[1]["backend"] == "gloo" and rows[1]["mechanics"] and rows[1]["cards"] == 1,
          f"2 ranks on one card: {rows[1]}")
    check(summary["mechanics"] and summary["efficiency_vs_1dev"][0] == 1.0,
          f"scaling summary {summary}")
    return dict(rows=rows, inputs=(qp_args, qp_static, pd_args, errs), budget=budget)


def _finite_losses(m) -> bool:
    import math

    keys = ("loss_objective", "loss_critic", "loss_entropy", "reward_mean")
    return all(math.isfinite(float(m[k])) for k in keys)


def print_iteration(what: str, i: int, m, frames: int, smi: str) -> None:
    r, g, u = m["seconds_rollout"], m["seconds_gae"], m["seconds_update"]
    print(f"{what} iteration {i + 1}: {r + g + u:.3f} s (rollout {r:.3f}, GAE {g:.4f}, "
          f"update {u:.3f}), {frames / r:.1f} rollout frames/s, loss {float(m['loss_objective']):.5f}"
          f" / {float(m['loss_critic']):.5f}; on {smi}")


def informed_training_phase(dev, smi, workdir) -> list:
    """CBF-informed training as the paper's reward sweep runs it
    (`sigmarl_tpu/eval/papers.py:278-285`: cpm_mixed, N=4, B=32, T=128, 30
    epochs of minibatch 512, the "cbf" reward with h_nom 0.2 from the
    margins-only filter, observation noise on the observations and on the
    filter's nominal input). 2 iterations of `MAPPOCAVs.train`. K2 launches
    once per rollout step (128 per iteration) and K1 never; losses are
    finite, the weights move, and the checkpoint reloads equal."""
    import numpy as np
    import torch

    from sigmarl_tpu_torch import MAPPOCAVs, Parameters
    from sigmarl_tpu_torch.ops.boundary import pseudo_distance_stencil
    from sigmarl_tpu_torch.ops.qp import newton_solve
    from sigmarl_tpu_torch.rl import checkpoint as ckpt
    from sigmarl_tpu_torch.rl.networks import to_jax_params

    p = Parameters(**INFORMED_TRAINING, n_iters=2, device=dev,
                   where_to_save=os.path.join(workdir, "informed") + "/")
    tr = MAPPOCAVs(p)
    before = [t.detach().clone() for t in tr.parameter_list()]
    seen = []

    def progress(i, m):
        seen.append((m, newton_solve.launches, pseudo_distance_stencil.launches))

    newton_solve.launches = 0
    pseudo_distance_stencil.launches = 0
    _, decision, optim, *_ = tr.train(progress_callback=progress)
    torch.cuda.synchronize()
    per_iter, k1_prev, k2_prev = [], 0, 0
    for i, (m, k1, k2) in enumerate(seen):
        per_iter.append({"qp_newton": k1 - k1_prev, "boundary_stencil": k2 - k2_prev})
        k1_prev, k2_prev = k1, k2
        print_iteration("CBF-informed training", i, m, p.frames_per_batch, smi)
        check(_finite_losses(m), f"non-finite loss or reward in CBF-informed iteration {i + 1}")
    print(f"CBF-informed training: launches per iteration {per_iter}")
    for n in per_iter:
        check(n == {"qp_newton": 0, "boundary_stencil": p.max_steps},
              f"CBF-informed iteration launched {n}, want 0 and {p.max_steps}")
    after = tr.parameter_list(decision.net, optim.critic)
    check(all(not torch.equal(a, b) for a, b in zip(before, after)),
          "a parameter tensor did not move in training")
    p.is_load_final_model = True
    loaded = ckpt.load_best(p)
    for name, net in (("policy", decision.net), ("critic", optim.critic)):
        flat = lambda t: [t["params"]["MLP_0"][k][w] for k in sorted(t["params"]["MLP_0"])  # noqa: E731
                          for w in ("kernel", "bias")]
        check(all(np.array_equal(a, b) for a, b in zip(flat(loaded[name]), flat(to_jax_params(net)))),
              f"the reloaded {name} checkpoint differs")
    print(f"CBF-informed training: checkpoints {sorted(os.listdir(ckpt.model_dir(p)))} reload equal")
    return per_iter


def filtered_training_phase(dev, smi, workdir) -> dict:
    """CBF-filtered training at the main path's width (cpm_entire, N=15,
    B=1024, T=16, centralized filter at its default 2+15 budget, one epoch
    of minibatch 4096), then the same trainer decentralized at N=4, B=32:
    one iteration each, K1 and K2 launched once per rollout step. Returns
    the launches, K1's timing on the centralized input at 2+15, and the
    model directory of the centralized run's checkpoint."""
    import math

    import torch

    from sigmarl_tpu_torch import MAPPOCAVs, Parameters, tanh_normal_sample
    from sigmarl_tpu_torch.ops.boundary import pseudo_distance_stencil
    from sigmarl_tpu_torch.ops.qp import newton_solve

    out = {}
    for name, kw in (
        ("centralized", {}),
        ("decentralized", dict(n_agents=4, num_vmas_envs=32, is_using_centralized_cbf=False)),
    ):
        p = Parameters(**{**FILTERED_TRAINING, **kw}, n_iters=1, device=dev,
                       where_to_save=os.path.join(workdir, "filtered") + "/")
        tr = MAPPOCAVs(p)
        state = tr.initial_state()
        newton_solve.launches = 0
        pseudo_distance_stencil.launches = 0
        state, m = tr.train_iteration(state)
        torch.cuda.synchronize()
        launches = {"qp_newton": newton_solve.launches,
                    "boundary_stencil": pseudo_distance_stencil.launches}
        solved = float(m["cbf_solved_share"])
        print_iteration(f"CBF-filtered training ({name}, N={p.n_agents}, B={p.num_vmas_envs})", 0,
                        m, p.frames_per_batch, smi)
        resets = reset_branches(tr.env)
        print(f"CBF-filtered training ({name}): launches {launches}, solved share {solved:.6f}, "
              f"reset steps {fmt_branches(resets, p.max_steps)}")
        check(_finite_losses(m) and bool(torch.isfinite(state.obs).all()),
              f"non-finite obs, reward or loss in {name} filtered training")
        check(math.isfinite(solved), f"no solved share in {name} filtered training")
        for k, n in launches.items():
            check(n == p.max_steps, f"{k} launched {n} times in {p.max_steps} {name} steps")
        out[name] = launches
        if name == "centralized":
            # The model directory the testing phase loads: this iteration's
            # weights under a reward key (episodes rarely end in 16 steps).
            from sigmarl_tpu_torch.rl import checkpoint as ckpt

            rew = float(m["episode_reward_mean"])
            rew = round(rew, 2) if math.isfinite(rew) else 0.0
            saver = ckpt.RewardKeyedCheckpointer(p)
            check(saver.maybe_save(rew, tr.checkpoint_params(state), [rew]),
                  "the filtered-training checkpoint was not written")
            out["model_dir"] = saver.dir
            with torch.no_grad():
                loc, scale = state.policy(state.obs)
                act, _ = tanh_normal_sample(loc, scale, tr.low, tr.high, generator=tr.generator)
            qp_args, qp_static = qp_capture(tr.cbf_filter, state.env_state, act)
            check_qp(qp_args, qp_static, " 2+15 input", budgets=((30, 0), (15, 2)))
            out["k1"] = k1_timing(qp_args, qp_static, 15, 2)
            print_k1_timing("at the training budget", out["k1"], smi)
    return out


# The challenge-buffer phase: the filtered training iteration at the main
# path's width with the challenging initial-state buffer on at its
# defaults (record probability 1.0, replay probability 0.2, 100 slots,
# records from 10 steps back), over this many iterations.
CHALLENGE_ITERS = 2


def challenge_buffer_phase(dev, smi, workdir) -> dict:
    """`FILTERED_TRAINING` with `is_challenging_initial_state_buffer` (cpm_entire,
    N=15, B=1024, T=16, 2+15), 2 iterations from one state, the launch counts
    set to 0 before each: K1 and K2 launched once per rollout step, solved
    share 1.0, finite losses and observations; the records and replays of
    each iteration (the env's device-side counts). After both, at least one
    record in the buffer (cb_valid > 0) and at least one env that replayed.
    Should the filter keep every agent apart at this width (nothing
    recorded), the plain MAPPO iteration at the same width with the buffer
    on carries the record and replay check, and the phase says so. Returns
    per iteration its launches, seconds, frames/s, records and replays."""
    import torch

    from sigmarl_tpu_torch import MAPPOCAVs, Parameters

    def run(kw, what, filtered):
        p = Parameters(**kw, is_challenging_initial_state_buffer=True, n_iters=CHALLENGE_ITERS,
                       device=dev, where_to_save=os.path.join(workdir, "challenge") + "/")
        tr = MAPPOCAVs(p)
        state = tr.initial_state()
        iters = []
        for i in range(CHALLENGE_ITERS):
            before = tr.env.challenge_counts.clone()
            zero_launch_counts()
            state, m = tr.train_iteration(state)
            torch.cuda.synchronize()
            launches = launch_counts()
            records, replays = (tr.env.challenge_counts - before).tolist()
            print_iteration(what, i, m, p.frames_per_batch, smi)
            check(_finite_losses(m) and bool(torch.isfinite(state.obs).all()),
                  f"non-finite obs, reward or loss in {what}")
            want = p.max_steps if filtered else 0
            check(all(n == want for n in launches.values()),
                  f"{what} launched {launches} in {p.max_steps} steps")
            if filtered:
                solved = float(m["cbf_solved_share"])
                check(solved == 1.0, f"{what} solved share {solved}")
            r = m["seconds_rollout"]
            iters.append(dict(launches=launches, records=records, replays=replays,
                              seconds=m["seconds_rollout"] + m["seconds_gae"] + m["seconds_update"],
                              rollout_frames_per_s=p.frames_per_batch / r))
            resets = reset_branches(tr.env)
            print(f"{what} iteration {i + 1}: launches {launches}, {records} states recorded, "
                  f"{replays} env resets replayed a record, cb_valid "
                  f"{int(state.env_state.cb_valid)}, reset steps so far "
                  f"{fmt_branches(resets, (i + 1) * p.max_steps)}")
            check(resets[1] == 0,
                  f"{what}: a compacted reset step with the challenge buffer on")
        return iters, int(state.env_state.cb_valid)

    out = {}
    out["filtered"], valid = run(FILTERED_TRAINING, "challenge buffer, CBF-filtered (N=15, "
                                 "B=1024)", True)
    replays = sum(it["replays"] for it in out["filtered"])
    out["carried_by"] = "filtered"
    if valid == 0 or replays == 0:
        print(f"challenge buffer: the filtered iterations recorded {valid} states and replayed "
              f"{replays}; the plain MAPPO iteration at the same width carries the check")
        plain = {**FILTERED_TRAINING, "rew_method": "distance", "is_using_cbf_training": False,
                 "is_solve_qp": False, "is_apply_cbf_action": False}
        out["plain"], valid = run(plain, "challenge buffer, plain MAPPO (N=15, B=1024)", False)
        replays = sum(it["replays"] for it in out["plain"])
        out["carried_by"] = "plain"
    check(valid > 0, "the challenge buffer holds no record after the phase")
    check(replays > 0, "no env replayed a record in the challenge-buffer phase")
    return out


def ppo_update_check(dev) -> None:
    """One PPO minibatch update on the card against the CPU at a small
    size (cpm_mixed, N=4, the 3x256 networks, 64 frames), from the same
    weights, minibatch and entropy noise: the loss to a relative 1e-5, the
    gradients to atol 1e-5 and relative 1e-4, and the updated parameters to
    atol 1e-6 wherever both gradients exceed 1e-6 in magnitude (elsewhere
    Adam's first step is +-lr by the gradient's sign, which may part)."""
    import torch

    from sigmarl_tpu_torch import MAPPOCAVs, Parameters, tanh_normal_sample

    kw = dict(scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=4, dt=0.1, max_steps=16,
              n_iters=2, num_epochs=1, minibatch_size=64, is_use_mtv_distance=False,
              is_obs_noise=False)
    trs = {d: MAPPOCAVs(Parameters(**kw, device=d)) for d in ("cpu", dev)}
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
        res[d] = (float(total.detach()), [x.cpu() for x in grads], [t.detach().cpu() for t in params],
                  [t.cpu() for t in before])
    (lc, gc, pc, bc), (lg, gg, pg, bg) = res["cpu"], res[dev]
    check(all(torch.equal(a, b) for a, b in zip(bc, bg)), "the two trainers start apart")
    loss_gap = abs(lg - lc) / abs(lc)
    g_err = max(float(((a - b).abs() - 1e-4 * b.abs()).max()) for a, b in zip(gg, gc))
    p_err = max(float(torch.where((a.abs() > 1e-6) & (b.abs() > 1e-6), (x - y).abs(), 0.0).max())
                for a, b, x, y in zip(gg, gc, pg, pc))
    print(f"PPO minibatch update, card vs CPU: loss relative gap {loss_gap:.3e} (< 1e-5), "
          f"gradients max |d| - 1e-4 |g| = {g_err:.3e} (<= 1e-5), updated parameters "
          f"{p_err:.3e} (atol 1e-6 where both |g| > 1e-6)")
    check(loss_gap < 1e-5, f"PPO loss differs by a relative {loss_gap}")
    check(g_err <= 1e-5, f"PPO gradients differ by {g_err}")
    check(p_err <= 1e-6, f"updated parameters differ by {p_err}")


def rollout_policy_calls(net):
    """Counts the calls of `net` made without autograd, which are the
    rollout's (the update's loss runs with it). Returns (counter, hook
    handle)."""
    import torch

    calls = [0]

    def hook(module, inputs, output):
        if not torch.is_grad_enabled():
            calls[0] += 1

    return calls, net.register_forward_hook(hook)


def recording_ranks():
    """Wraps the trainer's `priority_rank` so that each call records, on the
    card, whether every env's rank is a permutation of 0..N-1. Returns (the
    list of those flags, a function that removes the wrapper)."""
    import importlib

    import torch

    # By path: the package's `rl.mappo_cavs` attribute is the function.
    trainer_module = importlib.import_module("sigmarl_tpu_torch.rl.mappo_cavs")
    plain = trainer_module.priority_rank
    flags = []

    def recording(*args, **kwargs):
        out = plain(*args, **kwargs)
        n = out.rank.shape[-1]
        flags.append((out.rank.sort(dim=-1).values
                      == torch.arange(n, device=out.rank.device)).all())
        return out

    trainer_module.priority_rank = recording
    return flags, lambda: setattr(trainer_module, "priority_rank", plain)


def one_iteration(p, smi, what: str):
    """One `train_iteration` of a fresh trainer with the launch counts set
    to 0 just before it; returns (trainer, state, metrics, launches, the
    rollout's policy calls, the per-call rank flags)."""
    import torch

    from sigmarl_tpu_torch import MAPPOCAVs
    from sigmarl_tpu_torch.ops.boundary import pseudo_distance_stencil
    from sigmarl_tpu_torch.ops.qp import newton_solve

    tr = MAPPOCAVs(p)
    state = tr.initial_state()
    before = [t.detach().clone() for t in tr.parameter_list()]
    calls, handle = rollout_policy_calls(tr.policy_net)
    flags, unwrap = recording_ranks()
    try:
        newton_solve.launches = 0
        pseudo_distance_stencil.launches = 0
        torch.cuda.synchronize()
        state, m = tr.train_iteration(state)
        torch.cuda.synchronize()
        launches = {"qp_newton": newton_solve.launches,
                    "boundary_stencil": pseudo_distance_stencil.launches}
    finally:
        handle.remove()
        unwrap()
    print_iteration(what, 0, m, p.frames_per_batch, smi)
    moved = all(not torch.equal(a, b) for a, b in zip(before, tr.parameter_list()))
    check(moved, f"a parameter tensor did not move in the {what} iteration")
    check(_finite_losses(m) and bool(torch.isfinite(state.obs).all()),
          f"non-finite obs, reward or loss in the {what} iteration")
    if tr.prio_policy_net is not None:
        check(math.isfinite(float(m["loss_priority"])), f"non-finite priority loss ({what})")
    ranks_ok = bool(torch.stack(flags).all()) if flags else True
    check(ranks_ok, f"a priority rank is not a permutation ({what})")
    return tr, state, m, launches, calls[0], len(flags)


def xpmarl_training_phase(dev, smi, workdir) -> dict:
    """XP-MARL as the ICRA'25 priority comparison runs it
    (`sigmarl_tpu/eval/papers.py:105-111`: cpm_mixed, N=4, B=32, T=128, 30
    epochs of minibatch 512, observation noise on): one iteration with
    learned and one with random priority, then one with opponent modeling
    in the same setting. Neither path runs a kernel. Returns each path's
    launches."""
    from sigmarl_tpu_torch import Parameters

    out = {}
    for name, kw in (
        ("learned priority", XPMARL_TRAINING),
        ("random priority", {**XPMARL_TRAINING, "prioritization_method": "random"}),
        ("opponent modeling", OPPONENT_TRAINING),
    ):
        p = Parameters(**kw, n_iters=1, device=dev,
                       where_to_save=os.path.join(workdir, "xpmarl") + "/")
        tr, _, m, launches, calls, n_ranks = one_iteration(p, smi, f"XP-MARL, {name},")
        per_step = p.n_agents if tr.use_prio else 2
        print(f"XP-MARL, {name}: launches {launches}, {calls} rollout policy calls in "
              f"{p.max_steps} steps, {n_ranks} ranks checked"
              + (f", priority loss {float(m['loss_priority']):.5f}" if tr.prio_policy_net else ""))
        check(calls == per_step * p.max_steps,
              f"{calls} policy calls in {p.max_steps} {name} steps, want {per_step} per step")
        check(n_ranks == (p.max_steps if tr.use_prio else 0), f"{n_ranks} ranks in {name}")
        check(launches == {"qp_newton": 0, "boundary_stencil": 0},
              f"the {name} iteration launched {launches}, want none")
        out[name] = launches
    return out


def wide_xpmarl_phase(dev, smi, workdir) -> dict:
    """Learned-priority XP-MARL with a CBF-filtered rollout at the main
    path's width on the `Parameters` defaults (MTV distance and observation
    noise on): cpm_entire, N=15, B=1024, T=16, communication noise, the
    centralized filter at its 2+15 budget, one epoch of minibatch 4096.
    One iteration: K1 and K2 launched once per rollout step, 15 policy
    calls per step, finite obs, rewards and losses."""
    from sigmarl_tpu_torch import Parameters

    p = Parameters(**WIDE_XPMARL_TRAINING, n_iters=1, device=dev,
                   where_to_save=os.path.join(workdir, "wide") + "/")
    check(p.is_use_mtv_distance and p.is_obs_noise, "the wide run is not on the defaults")
    tr, _, m, launches, calls, _ = one_iteration(p, smi, "wide XP-MARL, CBF-filtered,")
    solved = float(m["cbf_solved_share"])
    print(f"wide XP-MARL, CBF-filtered: launches {launches}, solved share {solved:.6f}, "
          f"{calls} rollout policy calls in {p.max_steps} steps, priority loss "
          f"{float(m['loss_priority']):.5f}, reset steps "
          f"{fmt_branches(reset_branches(tr.env), p.max_steps)}")
    check(math.isfinite(solved), "no solved share in the wide XP-MARL iteration")
    check(calls == p.n_agents * p.max_steps, f"{calls} policy calls, want {p.n_agents} per step")
    for k, n in launches.items():
        check(n == p.max_steps, f"{k} launched {n} times in {p.max_steps} wide XP-MARL steps")
    return launches


def xpmarl_small_check(dev) -> None:
    """Card against CPU at a small size from the same weights and draws:
    one XP-MARL propagation step (N=4, B=8, communication noise on; actions
    to atol 1e-5), and one env step with the MTV distance, observation
    noise and a history of 2 from the same state, actions, reset draws and
    noise (rewards and positions to atol 2e-5, observations and the history
    to 1e-4, done flags equal)."""
    import torch

    from sigmarl_tpu_torch import Parameters, PolicyNet, make_env
    from sigmarl_tpu_torch.env.reset import ResetDraws
    from sigmarl_tpu_torch.env.structs import state_to
    from sigmarl_tpu_torch.rl.priority import prioritized_action_propagation

    B, N, D, K = 8, 4, 30, 2
    g = torch.Generator().manual_seed(11)
    obs = torch.nn.functional.pad(torch.randn((B, N, D), generator=g), (0, 2 * K))
    rank = torch.stack([torch.randperm(N, generator=g) for _ in range(B)])
    nearing = torch.stack([torch.stack([torch.randperm(N - 1, generator=g)[:K] for _ in range(N)])
                           for _ in range(B)])
    noise, comm = torch.randn((N, B, 2), generator=g), torch.randn((N, B, 2 * K), generator=g)
    lim = torch.tensor([1.0, 0.54])
    pol_c = PolicyNet(D + 2 * K, device="cpu", seed=3)
    pol_g = PolicyNet(D + 2 * K, device=dev, seed=3)
    outs = [prioritized_action_propagation(
        pol, *(x.to(d) for x in (obs, rank, nearing, -lim, lim)), action_noise=noise.to(d),
        communication_noise_level=0.1, communication_noise=comm.to(d))
        for pol, d in ((pol_c, "cpu"), (pol_g, dev))]
    act_err = float((outs[1].actions.cpu() - outs[0].actions).abs().max())

    p = Parameters(scenario_type="cpm_entire", n_agents=N_AGENTS, num_vmas_envs=B, dt=0.1,
                   max_steps=1_000_000, n_observed_steps=2)
    check(p.is_use_mtv_distance and p.is_obs_noise, "the env check is not on the defaults")
    env_c, env_g = make_env(p, device="cpu"), make_env(p, device=dev)
    state, _ = env_c.reset(generator=g)
    for _ in range(3):
        act = (2 * torch.rand((B, N_AGENTS, 2), generator=g) - 1) * env_c.action_limits
        state, *_ = env_c.step(state, act, generator=g)
    draws = ResetDraws.sample(env_c.cfg, g, "cpu")
    draws_g = ResetDraws(None, draws.path_u.to(dev), draws.point_u.to(dev), draws.speed_u.to(dev))
    u = torch.rand((B, N_AGENTS, env_c.obs_dim), generator=g)
    sc, obs_c, rew_c, done_c, _ = env_c.step(state, act, reset_draws=draws, obs_noise=u)
    sg, obs_g, rew_g, done_g, _ = env_g.step(state_to(state, torch.device(dev)), act.to(dev),
                                             reset_draws=draws_g, obs_noise=u.to(dev))
    errs = {k: float((a.cpu() - b).abs().max()) for k, a, b in (
        ("reward", rew_g, rew_c), ("pos", sg.pos, sc.pos), ("obs", obs_g, obs_c),
        ("history", sg.obs_history, sc.obs_history))}
    print(f"XP-MARL propagation (N={N}, B={B}), card vs CPU: actions {act_err:.3e} (atol 1e-5); "
          f"env step with MTV, noise and history 2 (B={B}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (atol 2e-5, 2e-5, 1e-4, 1e-4)")
    check(act_err <= 1e-5, f"XP-MARL propagation differs by {act_err}")
    check(errs["reward"] <= 2e-5 and errs["pos"] <= 2e-5 and errs["obs"] <= 1e-4
          and errs["history"] <= 1e-4, "card and CPU steps with MTV, noise and history differ")
    check(torch.equal(done_g.cpu(), done_c), "done flags differ")
    check(obs_g.shape == (B, N_AGENTS, env_g.obs_dim) and sg.obs_history.shape[0] == 2,
          "wrong observation or history shape")


# CBF evaluation as `python -m sigmarl_tpu_torch.main_eval` runs it at its
# defaults (cpm_mixed, N=4, B=32, CLF nominal, windowed flag set), cut to
# 128 of its 600 steps; the ITSC'25 filter sweep (`sigmarl_tpu/eval/
# papers.py:215-262`: one agent, the CLF controller, 0.6 m/s) cut to 32 of
# 600 steps per circle count; the testing rollout cut to 128 of 1200 steps;
# AT25 to 256 of 18,000.
EVAL_STEPS, ITSC_STEPS, TESTING_STEPS, AT25_STEPS, WIDE_CLF_STEPS = 128, 32, 128, 256, 16
# The windowed stencil's run (pd_topk_chunks = 0), which no paper's run sets.
WINDOW_STEPS = 32
# The warm-start certificate's stress rollout at the bench's scale
# (`scripts/check_warm_start_tpu.py --steps 20`).
CERT_STEPS = 20


def launch_counts() -> dict:
    from sigmarl_tpu_torch.ops.boundary import pseudo_distance_stencil
    from sigmarl_tpu_torch.ops.qp import newton_solve

    return {"qp_newton": newton_solve.launches, "boundary_stencil": pseudo_distance_stencil.launches}


def zero_launch_counts() -> None:
    import torch

    from sigmarl_tpu_torch.ops.boundary import pseudo_distance_stencil
    from sigmarl_tpu_torch.ops.qp import newton_solve

    torch.cuda.synchronize()
    newton_solve.launches = 0
    pseudo_distance_stencil.launches = 0


def reset_branches(env) -> tuple:
    """The env's reset-step counts: (steps that ran the reset, of those
    the compacted ones, the full-width ones)."""
    from sigmarl_tpu_torch.utils.card_checks import reset_counts

    return reset_counts(env)


def zero_reset_branches(env) -> None:
    env.reset_steps = env.compact_reset_steps = env.full_reset_steps = 0


def fmt_branches(counts: tuple, steps: int) -> str:
    return f"{counts[0]} reset ({counts[1]} compacted, {counts[2]} full width) in {steps}"


def check_record(record: dict, what: str) -> None:
    import numpy as np

    for k, v in record.items():
        check(v.dtype.kind in "biu" or bool(np.isfinite(v).all()), f"non-finite {k} in {what}")


def single_agent_resets(record: dict) -> int:
    """Agents that the testing-mode done logic reset alone: flagged
    (collision or goal) in an env that did not end."""
    import numpy as np

    flagged = (record["is_collision_with_agents"] | record["is_collision_with_lanelets"]
               | record["is_reach_goal"])
    return int((flagged & ~np.asarray(record["done"], bool)[..., None]).sum())


def expected_metric_keys(record: dict) -> set:
    """The keys `main_testing` / `main_eval` of the JAX package give: the
    basic metrics (with the QP rates where the record has the filter's),
    collisions per 100 m and the three timings."""
    from sigmarl_tpu_torch.eval import metrics as M

    return set(M.basic_metrics(record)) | {"collisions_per_100m", "timing_steps_per_s",
                                          "timing_wall_time_s", "timing_time_per_step_ms"}


def testing_phase(model_dir: str, smi: str) -> dict:
    """`main_testing`'s function on the filtered-training phase's model
    directory (cpm_entire, N=15, the 3x256 policy), deterministic, B=32 (its
    `--num_envs` default), 128 recorded steps: finite records, single-agent
    resets counted, the JAX function's metric keys, no kernel launched."""
    from sigmarl_tpu_torch import main_testing

    zero_launch_counts()
    result, record, env = main_testing.test_model(model_dir, TESTING_STEPS, 32, 0, True, "cuda")
    launches = launch_counts()
    check_record(record, "the testing rollout")
    check(record["pos"].shape == (TESTING_STEPS, 32, 15, 2), f"record shape {record['pos'].shape}")
    check(set(result) == expected_metric_keys(record), f"testing metrics {sorted(result)}")
    singles = single_agent_resets(record)
    check(singles > 0 and env.reset_steps > 0, "no single-agent reset in the testing rollout")
    check(launches == {"qp_newton": 0, "boundary_stencil": 0}, f"testing launched {launches}")
    share = env.reset_steps / TESTING_STEPS
    print(f"testing (main_testing, cpm_entire, N=15, B=32, deterministic): {TESTING_STEPS} steps, "
          f"{result['timing_steps_per_s']:.1f} env-steps/s, the reset ran in {env.reset_steps} "
          f"steps ({share:.3f}), {singles} single-agent resets, collision rate "
          f"{result['collision_rate_total']:.4f}, launches {launches}; on {smi}")
    return dict(launches=launches, steps_per_s=result["timing_steps_per_s"], reset_share=share,
                single_agent_resets=singles)


def clf_qp_capture(cbf, state):
    """K1's inputs at a CLF-filtered state (the nominal action does not
    depend on the RL action)."""
    import torch

    B, N = state.pos.shape[:2]
    return qp_capture(cbf, state, torch.zeros((B, N, 2), device=state.pos.device))


def near_zero_clf_rows(qp_args, qp_static, cbf, state, seed: int):
    """K1's inputs at `state` with a third of the agents' CLF errors set
    near zero (`utils/card_checks.py::near_zero_clf_rows`: rows of norm at
    most 1e-6, where K1's fast division leaves its ranges)."""
    import torch

    from sigmarl_tpu_torch.safety.qp import kernel_inputs
    from sigmarl_tpu_torch.utils import card_checks

    B, N = state.pos.shape[:2]
    cons, u_nom, _, _ = cbf.assemble(state, torch.zeros((B, N, 2), device=state.pos.device))
    cons = card_checks.near_zero_clf_rows(cons, cbf.cfg.lam_clf, seed)
    return kernel_inputs(cons, u_nom, (cbf.a_min, cbf.rate_min), (cbf.a_max, cbf.rate_max),
                         state.cbf_u_prev, cbf.cfg.newton_ws_cap), qp_static


def check_eval_run(result: dict, record: dict, env, launches: dict, steps: int, what: str,
                   smi: str) -> dict:
    """The checks of a CBF-filtered evaluation rollout: finite records, the
    JAX function's metric keys, K1 and K2 once per step, every solve finite
    (solved share 1.0), a finite QP infeasibility rate. Returns its
    numbers."""
    check_record(record, what)
    solved = float(record["cbf_solved"].mean())
    check(set(result) == expected_metric_keys(record), f"{what} metrics {sorted(result)}")
    check(launches == {"qp_newton": steps, "boundary_stencil": steps},
          f"{what} launched {launches} in {steps} steps")
    check(solved == 1.0, f"{what} solved share {solved}")
    check(math.isfinite(result["qp_infeasibility_rate"]), f"{what} infeasibility rate")
    share = env.reset_steps / steps
    print(f"{what}: {steps} steps, {result['timing_steps_per_s']:.1f} env-steps/s, launches "
          f"{launches}, solved share {solved:.6f}, QP infeasibility rate "
          f"{result['qp_infeasibility_rate']:.4f}, the reset ran in {env.reset_steps} steps "
          f"({share:.3f}; {env.compact_reset_steps} compacted, {env.full_reset_steps} full "
          f"width), {single_agent_resets(record)} single-agent resets; on {smi}")
    return dict(launches=launches, steps_per_s=result["timing_steps_per_s"], reset_share=share,
                solved_share=solved, qp_infeasibility_rate=result["qp_infeasibility_rate"])


def eval_rollout(env, cbf, steps: int, speed: float, what: str, smi: str) -> dict:
    """A recorded rollout through `cbf` with (speed, 0) nominal actions (the
    eval layer's `rollout`, as `main_eval` and the ITSC'25 sweep drive it),
    the launch counts set to 0 just before it; checked by
    `check_eval_run`."""
    import torch

    from sigmarl_tpu_torch.eval import metrics as M
    from sigmarl_tpu_torch.eval.rollout import constant_speed_policy, rollout

    gen = torch.Generator(device=env.device).manual_seed(0)
    zero_launch_counts()
    record, timings = rollout(env, constant_speed_policy(env, speed), steps, gen, cbf=cbf)
    launches = launch_counts()
    result = M.basic_metrics(record)
    result["collisions_per_100m"] = M.collisions_per_100m(record)
    result.update({f"timing_{k}": v for k, v in timings.items()})
    return check_eval_run(result, record, env, launches, steps, what, smi)


def filtered_state(env, cbf, steps: int = 4):
    """A live state of `env` after a reset and `steps` filtered steps with
    (0.5, 0) nominal actions, for capturing the kernels' inputs."""
    import torch

    from sigmarl_tpu_torch import cbf_filtered_step

    gen = torch.Generator(device=env.device).manual_seed(1)
    act = torch.zeros((env.batch_dim, env.n_agents, 2), device=env.device)
    act[..., 0] = 0.5
    state, _ = env.reset(generator=gen)
    for _ in range(steps):
        state, *_ = cbf_filtered_step(env, cbf, state, act, generator=gen)
    return state


def cbf_eval_phase(smi: str) -> dict:
    """`main_eval`'s function at its defaults (cpm_mixed, N=4, B=32, CLF
    nominal, windowed flag set, default 2+15 budget), 128 of its 600 steps,
    centralized and then `--decentralized`; then the windowed stencil
    (`windowed_eval_run`). Returns each run's numbers, K1's CLF input
    (near-zero rows injected for the check, as captured for the timing),
    and the window-selection K2 input."""
    from sigmarl_tpu_torch import main_eval

    out = {}
    for name, flags in (("centralized", []), ("decentralized", ["--decentralized"])):
        args = main_eval.parse_args(["--max_steps", str(EVAL_STEPS), "--device", "cuda"] + flags)
        zero_launch_counts()
        result, record, env, cbf = main_eval.evaluate(args)
        launches = launch_counts()
        check(cbf.cfg.nom_controller_type == "clf" and cbf.cfg.use_windowed_pseudo_distance
              and env.cfg.is_testing_mode and cbf.decentralized == (name == "decentralized"),
              "not main_eval's defaults")
        out[name] = check_eval_run(result, record, env, launches, EVAL_STEPS,
                                   f"CBF evaluation ({name}, main_eval defaults)", smi)
        if name == "centralized":
            state = filtered_state(env, cbf)
            out["qp"] = clf_qp_capture(cbf, state)
            out["qp_near_zero"] = near_zero_clf_rows(*out["qp"], cbf, state, seed=4)
    out["windowed"] = windowed_eval_run(smi)
    return out


def windowed_eval_run(smi: str) -> dict:
    """The windowed stencil, which JAX and the port take only with
    pd_topk_chunks = 0 (no CLI sets it): `main_eval`'s env and filter with
    that count, through the eval layer's `rollout`, 32 steps, K1 and K2 once
    per step. Returns the numbers and K2's window-selection input at a
    state of this env."""
    from sigmarl_tpu_torch import CBFConfig, CBFSafetyFilter, Parameters, make_env
    from sigmarl_tpu_torch.safety.circles import circle_centers_world

    p = Parameters(scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=32, dt=0.1,
                   max_steps=WINDOW_STEPS, is_testing_mode=True, is_obs_noise=False,
                   is_use_mtv_distance=False, nom_controller_type="clf", device="cuda")
    env = make_env(p)
    cbf = CBFSafetyFilter(CBFConfig(n_agents=4, dt=0.1, nom_controller_type="clf", pd_topk_chunks=0,
                                    use_windowed_pseudo_distance=True),
                          env.cfg, env.tables, device=env.device)
    res = eval_rollout(env, cbf, WINDOW_STEPS, 0.5,
                       "windowed CBF evaluation (cpm_mixed, N=4, B=32, pd_topk_chunks=0)", smi)
    state = filtered_state(env, cbf)
    centers = circle_centers_world(cbf.approx, state.pos, state.rot)
    q, pid, cl, cr = cbf.stencil_inputs(centers, state.path_id, state.idx_left, state.idx_right)
    check(cl is not None and cl.shape[1] == 6, "no window selection")
    return dict(res, pd=(q, pid, env.tables.left_seg, env.tables.right_seg, cl, cr))


def itsc25_phase(smi: str, workdir: str) -> dict:
    """The ITSC'25 filter sweep through its driver
    (`sigmarl_tpu_torch/eval/papers.py::itsc25_safety_filter`: cpm_mixed, one
    agent, B=32, testing mode, the CLF controller, 0.6 m/s), one circle count
    at a time for C = 1..5, 32 of the paper's 600 steps each, the launch
    counts set to 0 before each: K1 at P = 0 and K2 once per step, the
    checks of `check_eval_run` on the record the driver wrote. Then the
    kernels' inputs of a live state of the same env and filter. Returns per
    C the numbers and those inputs."""
    import numpy as np

    from sigmarl_tpu_torch import CBFConfig, CBFSafetyFilter, Parameters, make_env
    from sigmarl_tpu_torch.eval import metrics as M
    from sigmarl_tpu_torch.eval import papers
    from sigmarl_tpu_torch.safety.circles import circle_centers_world

    out = {}
    for C in (1, 2, 3, 4, 5):
        d = os.path.join(workdir, "itsc25")
        zero_launch_counts()
        res = papers.itsc25_safety_filter(out_dir=d, device="cuda", max_steps=ITSC_STEPS,
                                          circles=(C,))[f"n_circles={C}"]
        launches = launch_counts()
        record = dict(np.load(os.path.join(d, f"out_td_c{C}.npz")))
        what = f"ITSC'25 sweep (papers.itsc25_safety_filter), C={C}"
        check(set(res) == set(M.basic_metrics(record)) | {
            "timing_steps_per_s", "timing_wall_time_s", "timing_time_per_step_ms", "reset_share"},
            f"{what} results {sorted(res)}")
        check_record(record, what)
        solved = float(record["cbf_solved"].mean())
        check(launches == {"qp_newton": ITSC_STEPS, "boundary_stencil": ITSC_STEPS},
              f"{what} launched {launches} in {ITSC_STEPS} steps")
        check(solved == 1.0, f"{what} solved share {solved}")
        check(math.isfinite(res["qp_infeasibility_rate"]), f"{what} infeasibility rate")
        print(f"{what}: {ITSC_STEPS} steps, {res['timing_steps_per_s']:.1f} env-steps/s, launches "
              f"{launches}, solved share {solved:.6f}, QP infeasibility rate "
              f"{res['qp_infeasibility_rate']:.4f}, the reset ran in a share "
              f"{res['reset_share']:.3f} of the steps, {single_agent_resets(record)} single-agent "
              f"resets; on {smi}")
        p = Parameters(scenario_type="cpm_mixed", n_agents=1, num_vmas_envs=32, dt=0.1,
                       max_steps=ITSC_STEPS, is_use_mtv_distance=False, is_obs_noise=False,
                       is_testing_mode=True, n_circles_approximate_vehicle=C, device="cuda")
        env = make_env(p)
        cbf = CBFSafetyFilter(CBFConfig(n_agents=1, n_circles=C, dt=0.1, nom_controller_type="clf"),
                              env.cfg, env.tables, device=env.device)
        state = filtered_state(env, cbf)
        qp = clf_qp_capture(cbf, state)
        check(qp[0][1].shape[-1] == 0 and qp[0][0].shape[-1] == 2 * C + 2,
              f"C={C}: K1's input is not one agent with 2C+2 rows")
        centers = circle_centers_world(cbf.approx, state.pos, state.rot)
        q, pid, cl, cr = cbf.stencil_inputs(centers, state.path_id)
        out[C] = dict(launches=launches, steps_per_s=res["timing_steps_per_s"],
                      reset_share=res["reset_share"], solved_share=solved,
                      qp_infeasibility_rate=res["qp_infeasibility_rate"], qp=qp,
                      qp_near_zero=near_zero_clf_rows(*qp, cbf, state, seed=C),
                      pd=(q, pid, env.tables.left_seg, env.tables.right_seg, cl, cr))
    return out


def wide_clf_setup():
    """The env and filter of the wide CLF evaluation: cpm_entire, N=15,
    B=1024, testing mode, the CLF controller, centralized, 3+5 budget."""
    from sigmarl_tpu_torch import CBFConfig, CBFSafetyFilter, Parameters, make_env

    p = Parameters(scenario_type="cpm_entire", n_agents=N_AGENTS, num_vmas_envs=BATCH, dt=0.1,
                   max_steps=1_000_000, is_use_mtv_distance=False, is_obs_noise=False,
                   is_testing_mode=True, is_using_cbf_testing=True, nom_controller_type="clf",
                   device="cuda")
    env = make_env(p)
    cbf = CBFSafetyFilter(CBFConfig(n_agents=N_AGENTS, nom_controller_type="clf", newton_iters=5,
                                    newton_soft_iters=3), env.cfg, env.tables, device=env.device)
    return env, cbf


def wide_clf_phase(smi: str) -> dict:
    """CLF-filtered testing at the main path's width (`wide_clf_setup`), 16
    steps. Returns the numbers and K1's input."""
    env, cbf = wide_clf_setup()
    res = eval_rollout(env, cbf, WIDE_CLF_STEPS, 0.5,
                       "wide CLF evaluation (cpm_entire, N=15, B=1024, 3+5)", smi)
    state = filtered_state(env, cbf)
    qp = clf_qp_capture(cbf, state)
    return dict(res, qp=qp, qp_near_zero=near_zero_clf_rows(*qp, cbf, state, seed=15))


def at25_phase(smi: str) -> dict:
    """The scripted AT25 run (`eval/at25.py::run_model(None, n_agents=15)`)
    from `default_poses` through `reset_predefined`, B=1, 256 of its 18,000
    steps: the event counts per 100 m and the distance driven, finite."""
    from sigmarl_tpu_torch.eval import at25

    zero_launch_counts()
    res = at25.run_model(None, n_agents=N_AGENTS, max_steps=AT25_STEPS, device="cuda")
    launches = launch_counts()
    keys = ("agent_collision_events_per_100m", "boundary_collision_events_per_100m",
            "distance_driven_m")
    check(all(math.isfinite(res[k]) and res[k] >= 0 for k in keys) and res["distance_driven_m"] > 0,
          f"AT25 events {[res.get(k) for k in keys]}")
    print(f"AT25 (scripted, N=15, B=1, {AT25_STEPS} steps): agent events "
          f"{res['agent_collision_events_per_100m']:.4f} and boundary events "
          f"{res['boundary_collision_events_per_100m']:.4f} per 100 m over "
          f"{res['distance_driven_m']:.2f} m, {res['timing_steps_per_s']:.1f} env-steps/s, "
          f"launches {launches}; on {smi}")
    return dict(res, launches=launches)


# The ECC'25 predictor's card-vs-CPU training check: a few epochs from the
# same initial weights and permutations on the full 41^3 grid.
SM_CHECK_EPOCHS = 3


def ecc_lcss_phase(smi: str, workdir: str) -> dict:
    """The standalone CBF studies on the card.

    - ECC'25 (`safety/sm_predictor.py`): the MTV predictor trained for 3
      epochs on the card and on the CPU from the same initial weights and
      permutations: train and validation losses to a relative 1e-4, weights
      to 1e-4 (float32 sums of 4096-row batches in other orders);
    - ECC'25 (`eval/papers.py::ecc25_cbf_grid`, figures off): all eight
      `run_demo` runs of the paper's grid on the card, its predictor trained
      on the card for 60 epochs and its RL nominal fitted there; every run
      finite; the overtaking "mtv" run with the 3-epoch predictor on the card
      and on the CPU: collided equal, h_min to 1e-5 and the states over the
      interaction (the first 80 steps) to 1e-3;
    - LCSS'25 (`eval/papers.py::lcss25_ttcbf`, figures off): the full 15 x 15
      sweeps, 400 steps, of both relative degrees and approaches on the card,
      each again on the CPU: collided maps equal, h_min to 1e-4 relative.

    Returns the seconds of each run."""
    import numpy as np
    import torch

    from sigmarl_tpu_torch.eval import papers
    from sigmarl_tpu_torch.safety import cbf_demo, hocbf_taylor
    from sigmarl_tpu_torch.safety.sm_predictor import (
        DistancePredictor, SafetyMarginEstimatorModule, sm_predictor_from_jax_params,
        to_jax_params,
    )

    out = {}
    n = 41 ** 3
    n_tr = n - int(n * 0.1)
    g = torch.Generator().manual_seed(0)
    perm = torch.randperm(n, generator=g)
    epoch_perms = [torch.randperm(n_tr, generator=g) for _ in range(SM_CHECK_EPOCHS)]
    init = to_jax_params(DistancePredictor(device="cpu", seed=3))
    mods = {}
    for dev in ("cuda", "cpu"):
        m = SafetyMarginEstimatorModule(device=dev)
        t0 = time.perf_counter()
        m.train(epochs=SM_CHECK_EPOCHS, init_net=sm_predictor_from_jax_params(init, device=dev),
                perm=perm, epoch_perms=epoch_perms)
        mods[dev] = (m, time.perf_counter() - t0)
    (mg, sg), (mc, sc) = mods["cuda"], mods["cpu"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(
        mg.train_losses_history + mg.val_losses_history,
        mc.train_losses_history + mc.val_losses_history))
    w_gap = max(float(np.abs(a - b).max()) for a, b in zip(
        [v for d in to_jax_params(mg.net)["params"].values() for v in d.values()],
        [v for d in to_jax_params(mc.net)["params"].values() for v in d.values()]))
    print(f"ECC'25 predictor, {SM_CHECK_EPOCHS} epochs on the 41^3 grid: card {sg:.2f} s, CPU "
          f"{sc:.2f} s; losses card vs CPU relative {gap:.3e} (<= 1e-4), weights {w_gap:.3e} "
          f"(<= 1e-4); val loss {mg.val_losses_history[-1]:.6f}")
    check(gap <= 1e-4 and w_gap <= 1e-4, f"the predictor's card and CPU training part: {gap}, {w_gap}")
    out["sm_predictor_epoch_s"] = {"cuda": sg / SM_CHECK_EPOCHS, "cpu": sc / SM_CHECK_EPOCHS}

    zero_launch_counts()
    t0 = time.perf_counter()
    ecc = papers.ecc25_cbf_grid(out_dir=os.path.join(workdir, "ecc25"), device="cuda",
                                figures=False)
    out["ecc25_s"] = time.perf_counter() - t0
    check(launch_counts() == {"qp_newton": 0, "boundary_stencil": 0}, "the ECC'25 grid launched")
    runs = {k: v for k, v in ecc.items() if "h_min" in v}
    check(len(runs) == 8 and all(math.isfinite(v["h_min"]) for v in runs.values()),
          f"ECC'25 runs {sorted(runs)}")
    for k, v in runs.items():
        print(f"ECC'25 {k}: h_min {v['h_min']:.6f}, collided {v['collided']}, "
              f"{v['seconds']:.2f} s on the card")
    print(f"ECC'25 grid (predictor {ecc['sm_predictor']['seconds']:.2f} s for 60 epochs, RL "
          f"nominal fit {ecc['rl_nominal_fit']['seconds']:.2f} s): {out['ecc25_s']:.1f} s in all; "
          f"on {smi}")
    out["ecc25"] = {k: v["seconds"] for k, v in runs.items()}
    out["ecc25_fits_s"] = {"sm_predictor_60_epochs": ecc["sm_predictor"]["seconds"],
                           "rl_nominal_400_steps": ecc["rl_nominal_fit"]["seconds"]}
    # One run of the grid again on the CPU, with the same predictor (the
    # card-trained one of the check above, its weights copied).
    cfg = cbf_demo.CBFDemoConfig(scenario="overtaking", sm_type="mtv")
    mc.net = sm_predictor_from_jax_params(to_jax_params(mg.net), device="cpu")
    tg = cbf_demo.run_demo(cfg, sm_module=mg, device="cuda")
    tc = cbf_demo.run_demo(cfg, sm_module=mc, device="cpu")
    st_gap = max(float(np.abs(tg[k][:80] - tc[k][:80]).max()) for k in ("ego", "other"))
    print(f"ECC'25 overtaking/mtv, card vs CPU: collided {tg['collided']} / {tc['collided']}, "
          f"h_min {tg['h_min']:.6f} / {tc['h_min']:.6f}, states over 80 steps {st_gap:.3e} (<= 1e-3)")
    check(tg["collided"] == tc["collided"] and abs(tg["h_min"] - tc["h_min"]) <= 1e-5
          and st_gap <= 1e-3, "the ECC'25 run on the card parts from the CPU's")

    t0 = time.perf_counter()
    lcss = papers.lcss25_ttcbf(out_dir=os.path.join(workdir, "lcss25"), device="cuda",
                               figures=False)
    out["lcss25_s"] = time.perf_counter() - t0
    out["lcss25"] = {}
    for key, res in lcss.items():
        deg, appr = key.split("/")
        cfg = hocbf_taylor.HOCBFConfig(relative_degree=int(deg[3:]), approach=appr, num_steps=400,
                                       lambda_1=0.5 if appr == "taylor" else 3.0, lambda_2=3.0)
        grid = dict(np.load(os.path.join(workdir, "lcss25", f"heatmap_{deg}_{appr}.npz")))
        t0 = time.perf_counter()
        ref = hocbf_taylor.run_experiment_multi_parameters(
            cfg, grid["lambda_1"][:, 0], grid["dt"][0], device="cpu")
        cpu_s = time.perf_counter() - t0
        h, h_ref = grid["h_min"], ref["h_min"]
        h_gap = float((np.abs(h - h_ref) / np.maximum(1.0, np.abs(h_ref))).max())
        same = bool((grid["collided"] == ref["collided"]).all())
        print(f"LCSS'25 {key}, 15 x 15 x 400 steps: {res['seconds']:.2f} s on the card, "
              f"{cpu_s:.2f} s on the CPU; collision fraction {res['collision_fraction']:.4f}, "
              f"collided maps equal {same}, h_min relative {h_gap:.3e} (<= 1e-4)")
        check(same and h_gap <= 1e-4, f"LCSS'25 {key}: the card parts from the CPU")
        out["lcss25"][key] = {"cuda_s": res["seconds"], "cpu_s": cpu_s}
    print(f"LCSS'25 sweep: {out['lcss25_s']:.1f} s on the card in all; on {smi}")
    return out


def eval_kernel_checks(evals, itsc, wide) -> dict:
    """K1 and K2 against their plain versions on the evaluation path's
    inputs: K1 with active CLF rows (near-zero ones included) at N=4 and
    N=15 and at one agent (P = 0) for C = 1, 3 and 5, controls after 0 and 1
    iterations bit for bit, F as in phase 4; K2 at C = 1 and 5 and with the
    window selection, bit for bit. Returns the largest differences."""
    import torch

    from sigmarl_tpu_torch.ops.boundary import (
        pseudo_distance_stencil, pseudo_distance_stencil_reference,
    )

    errs = {}
    for label, (args, static), budgets in (
        (" CLF N=4", evals["qp_near_zero"], ((30, 0), (15, 2))),
        (" CLF N=15 B=1024", wide["qp_near_zero"], ((30, 0), (5, 3))),
        *((f" P=0 C={C}", itsc[C]["qp_near_zero"], ((30, 0), (15, 2))) for C in (1, 3, 5)),
    ):
        errs["qp_newton" + label] = check_qp(args, static, label, budgets, atol=0.0)
    for label, args in (("C=1", itsc[1]["pd"]), ("C=5", itsc[5]["pd"]),
                        ("window", evals["windowed"]["pd"])):
        out = pseudo_distance_stencil(*args)
        ref = pseudo_distance_stencil_reference(*args)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        print(f"K2 {label} ({args[0].shape[1]} queries, {args[4].shape[1]} chunks): "
              f"max |d_kernel - d_plain| = {err:.3e} (bit for bit)")
        check(err == 0.0 and all(bool(torch.isfinite(a).all()) for a in out),
              f"K2 {label} differs by {err}")
        errs["boundary_stencil " + label] = err
    return errs


def challenge_small_check(dev) -> None:
    """The challenge buffer's record and replay steps (cpm_mixed, N=4, B=8)
    on the card against the CPU from the same state and draws, to the
    tolerances of `utils/card_checks.py::challenge_buffer_steps_card_vs_cpu`
    (which the card test shares)."""
    from sigmarl_tpu_torch.utils.card_checks import challenge_buffer_steps_card_vs_cpu

    checks = challenge_buffer_steps_card_vs_cpu(dev)
    print("challenge buffer record and replay steps (N=4, B=8), card vs CPU: " + "; ".join(
        f"{c.what} {c.value:.3g} (<= {c.limit:g})" for c in checks))
    for c in checks:
        check(c.ok, f"card vs CPU: {c.what} {c.value} above {c.limit}")


# The sharded phase: `FILTERED_TRAINING` with the challenge buffer on at its
# defaults, the start and the draws drawn once on the card from this seed.
SHARDED_TRAINING = {**FILTERED_TRAINING, "is_challenging_initial_state_buffer": True}
SHARDED_SEED = 7


def sharded_phase(smi: str) -> dict:
    """The CBF-filtered iteration at the main path's width (N=15, B=1024,
    T=16, 2+15, challenge buffer on) over ranks (`parallel/mesh.py`),
    against the same iteration in this process from the same start and
    draws: (a) 2 ranks sharing the card over gloo (512 envs each, CUDA
    tensors staged through the host), (b) a 1-rank nccl group. The checks
    of `utils/card_checks.py::sharded_vs_unsharded` (integer fields and
    flags equal, floats within 1e-3, u* 1e-2, the parameter rule of the
    CPU tests, K1 and K2 once per rollout step on every rank); whether the
    rollout is bit for bit, and if not, how far the policy's outputs for
    512 envs move when it runs on 1024. A second iteration from the
    generators is timed in each. Returns {name: seconds of both
    iterations and launches}."""
    import torch

    from sigmarl_tpu_torch import MAPPOCAVs, Parameters
    from sigmarl_tpu_torch.parallel.dryrun import spawn_ranks
    from sigmarl_tpu_torch.utils.card_checks import (
        policy_rows_invariant,
        sharded_iteration_rank,
        sharded_vs_unsharded,
        unsharded_iteration,
    )

    ref = unsharded_iteration(SHARDED_TRAINING, SHARDED_SEED)
    out = {"unsharded": dict(seconds=ref["seconds"], launches=ref["launches"])}
    print(f"sharded phase, unsharded reference (N=15, B=1024): iterations "
          f"{ref['seconds'][0]:.3f} / {ref['seconds'][1]:.3f} s, launches {ref['launches']}, "
          f"(records, replays) {ref['counts'].tolist()}, (reset, compacted, full-width) steps "
          f"after each iteration {ref['resets']}; on {smi}")
    check(all(r[1] == 0 for r in ref["resets"]),
          f"a compacted reset step with the challenge buffer on ({ref['resets']})")
    tr = MAPPOCAVs(Parameters(**SHARDED_TRAINING, device="cuda"))
    moved = policy_rows_invariant(tr.policy_net, ref["obs"].cuda(), BATCH // 2)
    print(f"sharded phase: the policy's outputs for {BATCH // 2} envs run alone against within "
          f"{BATCH}: max difference {moved:.3g}")
    for name, world, backend in (("2 ranks, gloo, one card", 2, "gloo"),
                                 ("1 rank, nccl", 1, "nccl")):
        t0 = time.perf_counter()
        ranks = spawn_ranks(sharded_iteration_rank, world, SHARDED_TRAINING, ref["start"],
                            ref["draws"], backend=backend, device="cuda:0")
        wall = time.perf_counter() - t0
        checks = sharded_vs_unsharded(ref, ranks, name)
        for c in checks:
            print(f"  {c.what}: {c.value:.6g} (limit {c.limit:g}){'' if c.ok else ' FAIL'}")
        secs = [r["seconds"] for r in ranks]
        print(f"sharded phase, {name}: iterations {secs} s per rank (unsharded "
              f"{ref['seconds']}), {wall:.1f} s with the processes' start; on {smi}")
        for c in checks:
            check(c.ok, f"{c.what}: {c.value} beyond {c.limit}")
        out[name] = dict(seconds=secs, launches=[r["launches"] for r in ranks], wall=wall)
    return out


def host_tools_phase(dev, smi) -> None:
    """The last host-side modules on the card against the CPU: the dense
    QP oracle on `to_dense` of a filtered step's set (N=4, B=8; F to a
    relative 1e-4), `pseudo_distance_to_polyline` on the example map's
    boundary (atol 1e-5), `current_lanelet_id` of every agent (equal);
    then an `InteractiveSession` (keys, 5 steps) and `debug_demo` (5
    steps) on the card, finite."""
    import numpy as np
    import torch

    from sigmarl_tpu_torch import CBFConfig, CBFSafetyFilter, Parameters, make_env
    from sigmarl_tpu_torch.core.geometry import current_lanelet_id
    from sigmarl_tpu_torch.env import debug_demo
    from sigmarl_tpu_torch.env.interactive import InteractiveSession
    from sigmarl_tpu_torch.env.structs import state_to
    from sigmarl_tpu_torch.maps.manager import load_map
    from sigmarl_tpu_torch.safety.pseudo_distance import pseudo_distance_to_polyline
    from sigmarl_tpu_torch.safety.qp import solve_boxed_penalty_qp

    p = Parameters(scenario_type="cpm_entire", n_agents=4, num_vmas_envs=8, dt=0.1,
                   is_use_mtv_distance=False, is_obs_noise=False)
    out = {}
    for d in ("cpu", dev):
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
        u, F = solve_boxed_penalty_qp(dense, u_nom.reshape(8, 8), w_u, lo, hi, n_iters=12)
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
    gap = float(((out[dev]["F"] - out["cpu"]["F"]).abs() / (1 + out["cpu"]["F"].abs())).max())
    pd_err = float((out[dev]["pd"] - out["cpu"]["pd"]).abs().max())
    same_ids = bool(torch.equal(out[dev]["ids"], out["cpu"]["ids"]))
    print(f"host tools, card vs CPU: dense solve F gap {gap:.3g} (<= 1e-4), pseudo distance "
          f"{pd_err:.3g} (<= 1e-5), lanelet IDs equal {same_ids}")
    check(gap <= 1e-4, f"dense solve on the card: F gap {gap}")
    check(pd_err <= 1e-5, f"pseudo distance on the card: {pd_err}")
    check(same_ids, "current_lanelet_id differs between the card and the CPU")
    sess = InteractiveSession(device=dev)
    for k in ("up", "up", "left", "r", "up"):
        sess.key(k)
    rews = [sess.step()[0] for _ in range(5)]
    traj = debug_demo.main(["--steps", "5", "--device", dev])
    check(sess.t == 5 and all(np.isfinite(r).all() for r in rews) and np.isfinite(traj).all(),
          "the interactive session or the debug demo on the card gave non-finite values")
    print(f"host tools: interactive session and debug demo stepped 5 times on the card; on {smi}")


def clf_small_check(dev) -> None:
    """One testing-mode, CLF-filtered, fp16-parity step (cpm_mixed, N=4,
    B=8) on the card against the CPU from the same state and draws, to the
    tolerances of `utils/card_checks.py::clf_step_card_vs_cpu` (which the
    card test shares)."""
    from sigmarl_tpu_torch.utils.card_checks import clf_step_card_vs_cpu

    checks = clf_step_card_vs_cpu(dev)
    print("testing-mode CLF fp16-parity step (N=4, B=8), card vs CPU: " + "; ".join(
        f"{c.what} {c.value:.3e} (<= {c.limit:g})" for c in checks))
    for c in checks:
        check(c.ok, f"card vs CPU: {c.what} {c.value} above {c.limit}")


def kernel_report(qp_args, qp_static, pd_args, launches, errs, paths) -> list:
    import torch

    from sigmarl_tpu_torch.ops.boundary import pseudo_distance_stencil
    from sigmarl_tpu_torch.ops.qp import newton_solve, newton_solve_reference, solve_occupancy

    N, Ks, Kp, P, B = qp_sizes(qp_args)
    d = 2 * N
    budget = dict(soft_iters=3)
    k1 = lambda: newton_solve(*qp_args, *qp_static, 5, **budget)  # noqa: E731
    k1_plain = lambda: newton_solve_reference(*qp_args, *qp_static, 5, **budget)  # noqa: E731
    k1_bytes = sum(t.numel() * t.element_size() for t in qp_args) + (d + 1) * 4 * B
    k1_bound, k1_by = bound_ms(B * qp_flops(N, Ks, Kp, P, 5, 3), k1_bytes)

    k2 = lambda: pseudo_distance_stencil(*pd_args)  # noqa: E731
    k2_row = k2_timing(pd_args)
    q, pid, lseg, rseg, cl, cr = pd_args
    R = q.shape[0]
    n_seg, counting = k2_row.pop("segments"), k2_row.pop("counting")
    k2_bound_all, k2_by_all = k2_row.pop("bound_all")

    rows = [
        dict(name="qp_newton", route="cuda", source="sigmarl_tpu_torch/csrc/qp_newton.cu",
             replaces="sigmarl_tpu/ops/qp_pallas.py:370", launches=launches["qp_newton"],
             max_abs_err=errs["qp_newton"], **cuda_ms_windows(k1, reps=20, queued=True),
             back_to_back_ms=cuda_ms_windows(k1, reps=20)["ms"],
             plain_ms=cuda_ms(k1_plain, reps=2), bound_ms=k1_bound, bound_by=k1_by,
             library_ms=None, launches_by_path=paths["qp_newton"], variants=paths["k1"]),
        dict(name="boundary_stencil", route="cuda",
             source="sigmarl_tpu_torch/csrc/boundary_stencil.cu",
             replaces="sigmarl_tpu/ops/boundary_pallas.py:89",
             launches=launches["boundary_stencil"], max_abs_err=errs["boundary_stencil"],
             **k2_row, back_to_back_ms=cuda_ms_windows(k2, reps=200)["ms"],
             library_ms=None, launches_by_path=paths["boundary_stencil"],
             variants=paths["k2"]),
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

    t_start = time.perf_counter()
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

    warm_resets = reset_branches(env)
    zero_reset_branches(env)
    newton_solve.launches = 0
    pseudo_distance_stencil.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, obs, finite, solved = rollout(env, cbf, policy, gen, state, obs, TIMED_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"qp_newton": newton_solve.launches,
                "boundary_stencil": pseudo_distance_stencil.launches}
    main_resets = reset_branches(env)
    print(f"main path: {TIMED_STEPS} steps, launches {launches}, solved share {solved:.6f}")
    print(f"main path reset steps: {fmt_branches(main_resets, TIMED_STEPS)} of the timed "
          f"steps; warm-up {fmt_branches(warm_resets, WARMUP_STEPS)}")
    check(main_resets[1] > 0, f"no compacted reset step on the main path ({main_resets})")
    act = policy_actions(env, policy, obs, gen)
    syncs = host_syncs(lambda: env.step(state, act, generator=gen))
    print(f"main path: {len(syncs)} host sync in one env step, at {syncs} (the number of "
          "resetting envs)")
    check(len(syncs) == 1, f"{len(syncs)} host syncs in one env step, at {syncs}; want 1")
    check(finite, "non-finite obs, reward or u* on the main path")
    check(obs.shape == (BATCH, N_AGENTS, env.obs_dim), f"obs shape {tuple(obs.shape)}")
    for k, n in launches.items():
        check(n == TIMED_STEPS, f"{k} launched {n} times in {TIMED_STEPS} steps")
    print(f"env-steps/s: {TIMED_STEPS * BATCH / elapsed:.1f} at B={BATCH}, N={N_AGENTS} "
          f"({elapsed / TIMED_STEPS * 1e3:.2f} ms/step) on {smi}")

    small_input_check(dev)
    reset_timing_phase(env, state, smi)
    compact_small_check(dev)

    grouped = grouped_phase(env, policy, gen, smi)
    programs = programs_phase(smi)
    fixture_launches = fixture_certificate_phase(smi)
    scaling = scaling_phase(smi)
    os.makedirs(os.path.join(HERE, "outputs"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.path.join(HERE, "outputs")) as wd:
        informed = informed_training_phase(dev, smi, wd)
        filtered = filtered_training_phase(dev, smi, wd)
        ppo_update_check(dev)
        xpmarl = xpmarl_training_phase(dev, smi, wd)
        wide = wide_xpmarl_phase(dev, smi, wd)
        testing = testing_phase(filtered["model_dir"], smi)
        challenge = challenge_buffer_phase(dev, smi, wd)
        xpmarl_small_check(dev)
        challenge_small_check(dev)
        evals = cbf_eval_phase(smi)
        itsc = itsc25_phase(smi, wd)
        wide_clf = wide_clf_phase(smi)
        at25_run = at25_phase(smi)
        ecc_lcss_phase(smi, wd)
    eval_errs = eval_kernel_checks(evals, itsc, wide_clf)
    clf_small_check(dev)
    sharded = sharded_phase(smi)
    host_tools_phase(dev, smi)

    paths = {k: {"main": launches[k], "grouped": grouped["launches"][k],
                 "cbf_informed_training_per_iteration": [n[k] for n in informed],
                 "cbf_filtered_training_centralized": filtered["centralized"][k],
                 "cbf_filtered_training_decentralized": filtered["decentralized"][k],
                 "xpmarl_learned_priority": xpmarl["learned priority"][k],
                 "xpmarl_random_priority": xpmarl["random priority"][k],
                 "opponent_modeling": xpmarl["opponent modeling"][k],
                 "xpmarl_cbf_filtered_wide": wide[k],
                 "testing": testing["launches"][k],
                 **{f"challenge_buffer_{what}_iteration_{i + 1}": it["launches"][k]
                    for what in ("filtered", "plain") for i, it in enumerate(challenge.get(what, []))},
                 "cbf_eval_centralized": evals["centralized"]["launches"][k],
                 "cbf_eval_decentralized": evals["decentralized"]["launches"][k],
                 "cbf_eval_windowed": evals["windowed"]["launches"][k],
                 **{f"itsc25_c{C}": itsc[C]["launches"][k] for C in itsc},
                 "clf_wide": wide_clf["launches"][k],
                 **{f"program_{name}": programs[name][k]
                    for name in ("bench_b1024", "bench_b4096", "bench_grouped", "bench_census",
                                 "latency_b1", "latency_b16", "certificate")},
                 "program_fixture_certificate": fixture_launches[k],
                 **{f"scaling_{r['global_devices']}_ranks_{r['backend']}_rank_{i}": n[k]
                    for r in scaling["rows"] for i, n in enumerate(r["launches"])},
                 "at25": at25_run["launches"][k],
                 **{f"sharded_{name}_rank_{r}_iteration_{i + 1}": it[k]
                    for name, run in (("gloo_2_ranks", sharded["2 ranks, gloo, one card"]),
                                      ("nccl_1_rank", sharded["1 rank, nccl"]))
                    for r, rank in enumerate(run["launches"]) for i, it in enumerate(rank)}}
             for k in launches}
    paths["k1"] = [dict(input="grouped", **grouped["k1"]),
                   dict(input="filtered training", **filtered["k1"])]
    # Each variant's max_abs_err is the largest control difference on its
    # captured input with near-zero CLF rows injected (K1), or the largest
    # distance difference on its captured input (K2).
    k1_eval = (
        ("CLF rows, cpm_entire N=15 B=1024 (wide CLF evaluation)", wide_clf["qp"],
         wide_clf["launches"], 5, 3, " CLF N=15 B=1024"),
        ("CLF rows, cpm_mixed N=4 B=32 (main_eval defaults)", evals["qp"],
         evals["centralized"]["launches"], 15, 2, " CLF N=4"),
        *((f"P=0, N=1 B=32 C={C} (ITSC'25 sweep)", itsc[C]["qp"], itsc[C]["launches"], 15, 2,
           f" P=0 C={C}") for C in (1, 3, 5)),
    )
    for what, qp, n, n_iters, soft, key in k1_eval:
        r = dict(input=what, launches=n["qp_newton"], max_abs_err=eval_errs["qp_newton" + key],
                 **k1_timing(*qp, n_iters, soft))
        print_k1_timing(what, r, smi)
        paths["k1"].append(r)
    for B in (1, 16):
        qp_args_b, qp_static_b, _, errs_b = programs[f"latency_b{B}_inputs"]
        r = dict(input=f"latency path, cpm_entire N=15 B={B}",
                 launches=programs[f"latency_b{B}"]["qp_newton"],
                 max_abs_err=errs_b["qp_newton"], **k1_timing(qp_args_b, qp_static_b, 5, 3))
        print_k1_timing(r["input"], r, smi)
        paths["k1"].append(r)
    cold_args, cold_static, cold_err = programs["cold"]
    r = dict(input="cold oracle of the warm-start certificate, N=15 B=1024 (stress rollout)",
             launches=programs["certificate"]["qp_newton"], max_abs_err=cold_err,
             **k1_timing(cold_args, cold_static, 30, 2))
    print_k1_timing(r["input"], r, smi)
    paths["k1"].append(r)
    sc_qp, sc_static, sc_pd, sc_errs = scaling["inputs"]
    sc_launches = scaling["rows"][0]["launches"][0]
    sc_n, sc_soft = scaling["budget"]
    r = dict(input=f"weak-scaling bench, cpm_entire N=15 B={sc_qp[2].shape[0]} per rank",
             launches=sc_launches["qp_newton"], max_abs_err=sc_errs["qp_newton"],
             **k1_timing(sc_qp, sc_static, sc_n, sc_soft))
    print_k1_timing(r["input"], r, smi)
    paths["k1"].append(r)
    paths["k2"] = []
    r = k2_timing(sc_pd)
    r.pop("bound_all")
    r = dict(input=f"weak-scaling bench, {sc_pd[0].shape[0]} rows per rank (N=15 B=128)",
             launches=sc_launches["boundary_stencil"], max_abs_err=sc_errs["boundary_stencil"],
             **r)
    print(f"K2 {r['input']}: {r['ms']:.4f} ms queued ({r['ms_min']:.4f} to {r['ms_max']:.4f}), "
          f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}, plain {r['plain_ms']:.3f} ms, "
          f"{r['launches']} launches per rank on its path; on {smi}")
    paths["k2"].append(r)
    for B in (1, 16):
        _, _, pd_b, errs_b = programs[f"latency_b{B}_inputs"]
        r = k2_timing(pd_b)
        r.pop("bound_all")
        r = dict(input=f"latency path, {B * N_AGENTS} rows (N=15 B={B})",
                 launches=programs[f"latency_b{B}"]["boundary_stencil"],
                 max_abs_err=errs_b["boundary_stencil"], **r)
        print(f"K2 {r['input']}: {r['ms']:.4f} ms queued ({r['ms_min']:.4f} to "
              f"{r['ms_max']:.4f}), bound {r['bound_ms']:.5f} ms by {r['bound_by']}, plain "
              f"{r['plain_ms']:.3f} ms, {r['launches']} launches on its path; on {smi}")
        paths["k2"].append(r)
    for what, run, key in (("C=1, N=1 B=32 (ITSC'25 sweep)", itsc[1], "C=1"),
                           ("C=5, N=1 B=32 (ITSC'25 sweep)", itsc[5], "C=5"),
                           ("window selection, N=4 B=32 (pd_topk_chunks=0)", evals["windowed"],
                            "window")):
        r = k2_timing(run["pd"])
        r.pop("bound_all")
        r = dict(input=what, launches=run["launches"]["boundary_stencil"],
                 max_abs_err=eval_errs["boundary_stencil " + key], **r)
        print(f"K2 {what}: {r['ms']:.4f} ms queued ({r['ms_min']:.4f} to {r['ms_max']:.4f}), "
              f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}, plain {r['plain_ms']:.3f} ms, "
              f"{r['launches']} launches on its path; on {smi}")
        paths["k2"].append(r)
    rows = kernel_report(qp_args, qp_static, pd_args, launches, errs, paths)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
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
