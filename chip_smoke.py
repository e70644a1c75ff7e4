#!/usr/bin/env python3
"""The PyTorch/CUDA port's run on one NVIDIA card.

    python3 chip_smoke.py

It builds the kernels, holds K1, K2 and K3 to their plain versions on the
main path's inputs, checks the main path's launches, graph replays and
single host sync, runs the programs and the training, testing and
evaluation phases at their full sizes, and prints the timings of the
kernel table (`PERF.md` §6). The checks that the card tests make
(`python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`) are not
made again here. Phases, in order; any failure exits non-zero before the
result line:

1. the device: `torch.cuda.get_device_name(0)` and nvidia-smi's name and
   power limit (no CUDA device: exit 1);
2. the three CUDA kernels built from `sigmarl_tpu_torch/csrc/` (one nvcc
   each, in parallel): the build seconds and ptxas' resource report;
3. the main path (`bench.py::main_path`: cpm_entire, N=15, B=1024, the
   3x256 policy from seed 0, the centralized CBF-QP filter at 3 ladder +
   5 Newton iterations) and a warm-up of 8 filtered steps from
   `zero_state`; then K1 and K2 against their plain versions on the
   inputs that rollout gives them: K1's controls after 0 and 1 iterations
   to atol 2e-5, F after 30 iterations to a relative 1e-4 and at 3+5 to
   1e-3; K2 both sides, chunked and full scan, to atol 2e-5;
4. 16 timed filtered steps: K1 and K2 once per step, K3 (the spawn) once
   per step that ran the reset, at least one compacted reset step (at
   most 3B/8 = 384 envs reset: only those are spawned), every step a
   replay of the filter's graph and of the env step's six graphs (all
   captured in the warm-up), one host sync per filtered step (the env
   step's read of the resetting envs; PyTorch's sync debug mode counts the
   waits), finite obs, rewards and u*; env-steps/s beside the card's name
   and power limit; then the host's launches (kernels, copies, sets,
   graph launches) of the env step in a step with a reset (B=1024) and in
   one without (B=1, the latency path);
5. K3 against the plain spawn on the main path's env and state (about
   16 % of the envs resetting, N=15, T=12), compacted and at full width,
   every output bit for bit; K3 timed beside an empty kernel's launch (its
   bound) and the plain spawn;
6. grouped filtering (`scripts/bench_grouped.py`'s setup: groups of at
   most 4, Kp = 18 pair rows): K1 against its plain version as in phase 3
   on a grouped input, 16 timed steps with one launch of each kernel per
   step;
7. the main path's programs through their functions at full size, each
   printing its JSON lines, with the kernels' launches checked: the bench
   at B=1024 and as 4 x 1024 sub-batches (one launch of each kernel per
   sub-batch per step), `--grouped` and `--census`; `bench_latency` at
   B=1 and B=16; `check_warm_start` at B=1024, N=15, 3+5, 20 steps of the
   (0.5, 0) stress rollout against the cold 2+30 oracle, which must be ok;
   then K1 and K2 as in phase 3 on the latency path's inputs, and K1 on
   the cold oracle's (also at 2+30);
8. weak scaling over ranks (`bench_scaling` at JAX's defaults: 128 envs
   per rank, N=15, T=32, 3 timed chunks after one warm-up, the filter at
   2+10): K1 and K2 as in phase 3 on the bench's input at B=128 (K1's
   controls also bit for bit at 2+10), then 1 rank over nccl and 2 ranks
   sharing the card over gloo: each rank launches K1 and K2 (chunks + 1) x
   T times and K3 once per reset step, 2 collectives per timed step, a
   finite reward, the card's name in each row, the 2-rank row marked as
   mechanics;
9. the training configurations of `utils/card_checks.py`: CBF-informed
   (2 iterations: K2 once per rollout step and K1 never, finite losses,
   moved weights, the checkpoint reloaded equal); CBF-filtered at the main
   path's width and decentralized at N=4, B=32 (one iteration each, K1 and
   K2 once per step; K1 against its plain version at 2+15 on the
   centralized input, whose weights phase 10 tests); XP-MARL with learned
   and random priority and opponent modeling (every network moved, ranks
   permutations, N turns per step, every step after the first one replay
   of the acting's graphs, 2 policy calls per step with opponent
   modeling, no kernel); wide XP-MARL with a CBF-filtered rollout at
   N=15, B=1024 (15 turns per step; a second, timed iteration whose every
   step is one replay of each acting graph, no capture); each
   iteration's split into rollout, GAE and update;
10. testing (`main_testing`'s function) on phase 9's centralized model,
   deterministic, B=32, 128 steps: finite records, single-agent resets,
   the JAX function's metric keys, no kernel launched; then the challenge
   buffer on the filtered configuration at its defaults, 2 iterations: K1
   and K2 once per rollout step, solved share 1.0, a record in the buffer
   and a replay by the end (else the plain MAPPO iteration at the same
   width carries that check, and the phase says so), no compacted reset
   step;
11. CBF evaluation (`main_eval`'s function at its defaults: cpm_mixed,
   N=4, B=32, CLF nominal), 128 steps centralized and then decentralized,
   and 32 steps with pd_topk_chunks = 0 (the windowed stencil); the
   ITSC'25 sweep through its driver (one agent, B=32, C = 1 to 5, 32 steps
   each); CLF-filtered testing at N=15, B=1024, 3+5, 16 steps: K1 and K2
   once per step, solved share 1.0, a finite QP infeasibility rate; AT25
   (scripted, N=15, B=1, 256 steps): the event counts;
12. the standalone CBF studies: the ECC'25 MTV predictor trained 3 epochs
   on the card and on the CPU from the same weights and permutations; the
   ECC'25 grid on the card (figures off), one run against the CPU; the
   full LCSS'25 sweep on the card against the CPU; no kernel;
13. the CBF-filtered iteration at the main path's width with the challenge
   buffer on, on 2 ranks sharing the card over gloo (512 envs each)
   against the same iteration in this process from the same start and
   draws (`utils/card_checks.py::sharded_vs_unsharded`); a second
   iteration from the generators timed in each;
14. the kernel table as one JSON line: each kernel's time on the main
   path's input and on each variant's input, beside its plain version's
   time and the launches on its path (the CLF, one-agent and window
   inputs, which no earlier phase checks, first held to the plain version
   bit for bit: K1's controls after 0 and 1 iterations, K2's distances),
   then the result line. `ms` (with
   `ms_min`, `ms_max`) is the median, least and largest of 7 CUDA-event
   windows queued behind a spin on the card: the card's time alone.
   `back_to_back_ms` times calls as the host issues them. K1's and K2's
   bound is the least time of the work the input needs, as the
   benchmark counts it (`benchmark/work/k1_newton.py`, `k2_stencil.py`
   over `peaks.py`'s card); an input that count does not define (grouped
   pair rows, active CLF rows) has no bound. K3's bound is an empty
   kernel's launch, measured.

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
# K3's main-path input: the share of envs that reset in a rollout step of
# the benchmark's rollout cell (about 164 of 1024).
SPAWN_SHARE = 0.16
# The challenge-buffer phase's iterations.
CHALLENGE_ITERS = 2
# The ECC'25 predictor's card-vs-CPU training check: a few epochs from the
# same initial weights and permutations on the full 41^3 grid.
SM_CHECK_EPOCHS = 3
# The sharded phase: the start and the draws drawn once on the card from
# this seed.
SHARDED_SEED = 7


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


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


def counted(fn):
    """(fn's result, each kernel's launches while it ran)."""
    from sigmarl_tpu_torch.ops import launch_counts

    before = launch_counts()
    out = fn()
    return out, launch_counts(since=before)


def check_launches(launches: dict, want: dict, what: str) -> None:
    for k, n in want.items():
        check(launches[k] == n, f"{what}: {k} launched {launches[k]} times, want {n}")


def fmt_branches(counts: tuple, steps: int) -> str:
    return f"{counts[0]} reset ({counts[1]} compacted, {counts[2]} full width) in {steps}"


# ---------------------------------------------------------------- kernels
def check_qp(qp_args, qp_static, label: str = "", budgets=((30, 0), (5, 3))) -> float:
    """K1 against its plain version on one input: controls after 0 and 1
    iterations to atol 2e-5, F after 30 iterations to a relative 1e-4 and
    at each other (stiff, soft) budget to 1e-3. Returns the largest control
    difference."""
    import torch

    from sigmarl_tpu_torch.ops.qp import newton_solve, newton_solve_reference
    from sigmarl_tpu_torch.utils.card_checks import rel_gap

    worst = 0.0
    for it in (0, 1):
        u_k, _ = newton_solve(*qp_args, *qp_static, it)
        u_p, _ = newton_solve_reference(*qp_args, *qp_static, it)
        torch.cuda.synchronize()
        err = float((u_k - u_p).abs().max())
        print(f"K1{label} {it} iterations: max |u_kernel - u_plain| = {err:.3e} (atol 2e-05)")
        check(err <= 2e-5 and bool(torch.isfinite(u_k).all()),
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


def qp_sizes(qp_args):
    """(N, Ks, Kp, P, B) of K1's inputs; Kp = 0 for one agent (no pairs)."""
    singles, pairs, u0 = qp_args[:3]
    B, d = u0.shape
    N, P = d // 2, qp_args[5].shape[0]
    return N, singles.shape[-1] // N, (pairs.shape[-1] // P if P else 0), P, B


def k1_timing(qp_args, qp_static, n_iters: int, soft_iters: int, bound: bool = True) -> dict:
    """K1 queued behind a spin at one budget, with its footprint, its plain
    version's time on the same input and, where `bound`, the least time of
    the work this input needs (`benchmark/work/k1_newton.py`: N agents with
    C circles, C^2 rows per pair, the CLF rows inactive)."""
    from sigmarl_tpu_torch.ops.qp import newton_solve, newton_solve_reference, solve_occupancy
    from sigmarl_tpu_torch.utils.card_checks import cuda_ms, cuda_ms_windows

    N, Ks, Kp, P, B = qp_sizes(qp_args)
    least = (None, None)
    if bound:
        from benchmark.work import k1_newton
        from benchmark.work.peaks import least_seconds

        C = Ks // 2 - 1
        check(Kp == C * C, f"K1's input has {Kp} rows per pair, which its count does not define")
        s, by = least_seconds(k1_newton.flops(B, N, C, n_iters, soft_iters),
                              k1_newton.bytes_moved(B, N, C))
        least = (s * 1e3, by)
    win = cuda_ms_windows(lambda: newton_solve(*qp_args, *qp_static, n_iters,
                                               soft_iters=soft_iters), reps=10, queued=True)
    plain = cuda_ms(lambda: newton_solve_reference(*qp_args, *qp_static, n_iters,
                                                   soft_iters=soft_iters), reps=1)
    occ = solve_occupancy(N, Ks, Kp, P, B)
    return dict(N=N, B=B, Kp=Kp, budget=f"{soft_iters}+{n_iters}", **win, least_ms=least[0],
                least_by=least[1], plain_ms=plain, smem_bytes=occ["smem_bytes"],
                blocks_per_sm=occ["blocks_per_sm"], waves=occ["waves"])


def k2_timing(pd_args) -> dict:
    """K2 queued behind a spin on one input, with the least time of the
    work it needs (`benchmark/work/k2_stencil.py`) and its plain version's
    time."""
    from benchmark.work import k2_stencil
    from benchmark.work.peaks import least_seconds

    from sigmarl_tpu_torch.ops.boundary import (
        pseudo_distance_stencil, pseudo_distance_stencil_reference,
    )
    from sigmarl_tpu_torch.utils.card_checks import cuda_ms, cuda_ms_windows

    q, pid, lseg, rseg, cl, cr = pd_args
    R, Q = q.shape[:2]
    s, by = least_seconds(*k2_stencil.count(dict(
        batch=R, n_agents=1, n_circles=Q // 9, pd_chunks=cl.shape[1],
        segment_table=list(lseg.shape))))
    win = cuda_ms_windows(lambda: pseudo_distance_stencil(*pd_args), reps=200, queued=True)
    plain = cuda_ms(lambda: pseudo_distance_stencil_reference(*pd_args), reps=20)
    return dict(rows=R, queries=Q, chunks=cl.shape[1], **win, least_ms=s * 1e3, least_by=by,
                plain_ms=plain)


def fmt_bound(r: dict) -> str:
    if r["least_ms"] is None:
        return "no count of this input's work"
    return f"bound {r['least_ms']:.5f} ms by {r['least_by']}"


def print_k1_timing(what: str, r: dict, smi: str) -> None:
    print(f"K1 {what} (N={r['N']}, B={r['B']}, Kp={r['Kp']}, {r['budget']}): {r['ms']:.4f} ms "
          f"queued ({r['ms_min']:.4f} to {r['ms_max']:.4f}), {fmt_bound(r)}, plain "
          f"{r['plain_ms']:.3f} ms; {r['smem_bytes']} B of shared memory, {r['blocks_per_sm']} "
          f"blocks per SM, {r['waves']:.2f} waves; on {smi}")


def print_k2_timing(r: dict, smi: str) -> None:
    print(f"K2 {r['input']}: {r['ms']:.4f} ms queued ({r['ms_min']:.4f} to {r['ms_max']:.4f}), "
          f"{fmt_bound(r)}, plain {r['plain_ms']:.3f} ms, {r['launches']} launches on its path; "
          f"on {smi}")


# ---------------------------------------------------------------- phases
def main_path_phase(dev, smi) -> dict:
    """Phases 3 and 4: the main path, its kernels against their plain
    versions, and its 16 timed steps."""
    import torch

    from sigmarl_tpu_torch import trace
    from sigmarl_tpu_torch.bench import filtered_step
    from sigmarl_tpu_torch.device import host_syncs
    from sigmarl_tpu_torch.utils.card_checks import (
        capture_kernel_inputs, env_graph_counts, reset_counts, rollout, warm_main_path,
    )

    t0 = time.perf_counter()
    env, cbf, policy, gen, state, obs, finite = warm_main_path(BATCH, N_AGENTS, WARMUP_STEPS)
    torch.cuda.synchronize()
    check(finite, "non-finite values during the warm-up")
    print(f"main path set up and warmed up ({WARMUP_STEPS} steps from zero_state) "
          f"in {time.perf_counter() - t0:.1f} s")

    qp_args, qp_static, pd_args = capture_kernel_inputs(env, cbf, policy, gen, state, obs)
    errs = check_kernels(qp_args, qp_static, pd_args)

    warm_resets = reset_counts(env)
    graphs_before = trace.snapshot()["counts"]
    t0 = time.perf_counter()
    (state, obs, finite), launches = counted(
        lambda: rollout(env, cbf, policy, gen, state, obs, TIMED_STEPS))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    resets = tuple(a - b for a, b in zip(reset_counts(env), warm_resets))
    graphs = {k: trace.snapshot()["counts"].get(f"filter.graph.{k}", 0)
              - graphs_before.get(f"filter.graph.{k}", 0) for k in ("captures", "replays")}
    env_graphs = env_graph_counts(graphs_before)
    print(f"main path: {TIMED_STEPS} steps, launches {launches}, filter graph {graphs}, "
          f"env-step graphs {env_graphs}")
    print(f"main path reset steps: {fmt_branches(resets, TIMED_STEPS)} of the timed steps; "
          f"warm-up {fmt_branches(warm_resets, WARMUP_STEPS)}")
    check(resets[1] > 0, f"no compacted reset step on the main path ({resets})")
    check_launches(launches, {"qp_newton": TIMED_STEPS, "boundary_stencil": TIMED_STEPS,
                              "spawn_place": resets[0]}, "main path")
    check(graphs == {"captures": 0, "replays": TIMED_STEPS},
          f"the filter's graph: {graphs} in {TIMED_STEPS} steps; want every step a replay")
    check(env_graphs == {"captures": 0, "replays": 6 * TIMED_STEPS},
          f"the env step's graphs: {env_graphs} in {TIMED_STEPS} steps; want six replays a step")
    syncs = host_syncs(lambda: filtered_step(env, cbf, policy, state, obs, gen))
    print(f"main path: {len(syncs)} host sync in one filtered step, at {syncs} (the env "
          "step's read of the number of resetting envs; the filter replays its graph)")
    check(len(syncs) == 1, f"{len(syncs)} host syncs in one filtered step, at {syncs}; want 1")
    check(finite, "non-finite obs, reward or u* on the main path")
    check(obs.shape == (BATCH, N_AGENTS, env.obs_dim), f"obs shape {tuple(obs.shape)}")
    print(f"env-steps/s: {TIMED_STEPS * BATCH / elapsed:.1f} at B={BATCH}, N={N_AGENTS} "
          f"({elapsed / TIMED_STEPS * 1e3:.2f} ms/step) on {smi}")
    env_launches_phase(env, cbf, policy, gen, state, obs)
    return dict(env=env, policy=policy, gen=gen, state=state, launches=launches,
                inputs=(qp_args, qp_static, pd_args), errs=errs)


def env_launches_phase(env, cbf, policy, gen, state, obs) -> None:
    """The host's launches of the env step (`utils/card_checks.py::
    host_launches`): in 4 main-path steps at B=1024, each with a reset,
    and in steps of the latency path (B=1) until one without a reset."""
    from sigmarl_tpu_torch.utils.card_checks import env_step_launches, warm_main_path

    def fmt(calls):
        return f"{sum(calls.values())} ({', '.join(f'{k} {n}' for k, n in sorted(calls.items()))})"

    rows, *_ = env_step_launches(env, cbf, policy, gen, state, obs, 4)
    check(all(reset for reset, _ in rows), "a main-path step at B=1024 without a reset")
    print("env step host launches, B=1024, steps with a reset: "
          + "; ".join(fmt(calls) for _, calls in rows))
    env1, cbf1, policy1, gen1, state1, obs1, _ = warm_main_path(1, N_AGENTS, 8)
    rows, *_ = env_step_launches(env1, cbf1, policy1, gen1, state1, obs1, 16)
    calm = [calls for reset, calls in rows if not reset]
    check(calm, "16 steps at B=1 without a step free of resets")
    print(f"env step host launches, B=1, a step without a reset: {fmt(calm[0])}")


def spawn_kernel_phase(env, state, smi) -> dict:
    """K3 (`ops/spawn.py::spawn_place`) on the main path's env and live
    state (cpm_entire, N=15, B=1024, T=12) with a seeded mask of about 16 %
    of the envs, whole envs as the main path resets them: compacted (rows
    from 0) and at full width, every output bit for bit with the plain
    spawn; then K3 compacted, queued behind a spin (the card's time) and
    back to back, beside an empty kernel's launch (`torch.cuda._sleep(1)`,
    K3's bound: the work is a few thousand distance checks per env) and
    the plain spawn. Returns the kernel table's row."""
    import torch

    from sigmarl_tpu_torch.env.reset import compact_slots
    from sigmarl_tpu_torch.ops.spawn import spawn_place, spawn_place_reference
    from sigmarl_tpu_torch.utils.card_checks import cuda_ms, cuda_ms_windows

    dev = env.device
    cfg, tables = env.cfg, env.tables
    g = torch.Generator(device=dev).manual_seed(16)
    env_any = torch.rand((BATCH,), generator=g, device=dev) < SPAWN_SHARE
    mask = env_any[:, None].expand(BATCH, N_AGENTS)
    k, slots, T = int(env_any.sum()), compact_slots(BATCH, False), cfg.max_spawn_tries
    sid = state.scenario_id[:, 0].contiguous()
    inputs = {"compacted": (torch.rand((slots, N_AGENTS, T), generator=g, device=dev),
                            torch.rand((slots, N_AGENTS, T), generator=g, device=dev), (0, k)),
              "full width": (torch.rand((BATCH, N_AGENTS, T), generator=g, device=dev),
                             torch.rand((BATCH, N_AGENTS, T), generator=g, device=dev), None)}
    calls = {}
    for name, (pu, qu, compact) in inputs.items():
        args = (cfg, tables, pu, qu, sid, state.pos, mask, compact)
        got, want = spawn_place(*args), spawn_place_reference(*args)
        differ = [f for f, a, b in zip(("pos", "rot", "path_id", "point_id"), got, want)
                  if not torch.equal(a, b)]
        check(not differ, f"K3 ({name}) differs from the plain spawn in {differ}")
        calls[name] = (lambda a=args: spawn_place(*a), lambda a=args: spawn_place_reference(*a))
    print(f"K3: compacted ({k} of {BATCH} envs) and full width equal the plain spawn bit for bit")
    kernel, plain = calls["compacted"]
    win = cuda_ms_windows(kernel, reps=200, queued=True)
    row = dict(name="spawn_place", route="cuda", source="sigmarl_tpu_torch/csrc/spawn_place.cu",
               replaces="sigmarl_tpu_torch/env/reset.py::spawn_positions (no TPU kernel: XLA)",
               input=f"main path, {k} of {BATCH} envs resetting, N={N_AGENTS}, T={T}",
               max_abs_err=0.0, **win, back_to_back_ms=cuda_ms_windows(kernel, reps=200)["ms"],
               full_width_ms=cuda_ms_windows(calls["full width"][0], reps=200, queued=True)["ms"],
               least_ms=cuda_ms_windows(lambda: torch.cuda._sleep(1), reps=200, queued=True)["ms"],
               least_by="launch", plain_ms=cuda_ms(plain, reps=20), library_ms=None)
    print(f"spawn_place: {row['ms']:.4f} ms queued behind a spin ({row['ms_min']:.4f} to "
          f"{row['ms_max']:.4f}), {row['back_to_back_ms']:.4f} ms back to back, full width "
          f"{row['full_width_ms']:.4f} ms queued; bound {row['least_ms']:.4f} ms by launch (an "
          f"empty kernel), plain {row['plain_ms']:.3f} ms; on {smi}")
    return row


def grouped_phase(env, policy, gen, smi) -> dict:
    """Grouped filtering as `scripts/bench_grouped.py` sets it up (cpm_entire,
    N=15, B=1024, groups of at most 4, 3+5 budget): K1 against its plain
    version on a grouped input (Kp = 18), then 16 timed steps with one
    launch of each kernel per step, and K1's time and footprint."""
    import torch

    from sigmarl_tpu_torch import CBFConfig, CBFSafetyFilter, zero_state
    from sigmarl_tpu_torch.bench import policy_actions
    from sigmarl_tpu_torch.safety.grouping import group_agents_k_nearest, same_group_mask
    from sigmarl_tpu_torch.utils.card_checks import qp_capture, rollout

    cbf = CBFSafetyFilter(
        CBFConfig(n_agents=N_AGENTS, n_circles=3, dt=0.1, newton_iters=5, newton_soft_iters=3),
        env.cfg, env.tables, max_group_size=4, device=env.device,
    )
    state = zero_state(env.cfg, env.device)
    obs = torch.zeros((BATCH, N_AGENTS, env.obs_dim), device=env.device)
    state, obs, finite = rollout(env, cbf, policy, gen, state, obs, WARMUP_STEPS)
    check(finite, "non-finite values during the grouped warm-up")
    gid = group_agents_k_nearest(state.pos, 4)
    cross = float((~same_group_mask(gid, cbf._pi, cbf._pj)).float().mean())
    qp_args, qp_static = qp_capture(cbf, state, policy_actions(env, policy, obs, gen), gid)
    check(qp_args[1].shape[-1] == 18 * qp_args[5].shape[0], "grouped rows are not Kp = 18")
    print(f"grouped input: {cross:.4f} of the pairs cross groups")
    check_qp(qp_args, qp_static, " grouped")

    t0 = time.perf_counter()
    (state, obs, finite), launches = counted(
        lambda: rollout(env, cbf, policy, gen, state, obs, TIMED_STEPS))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    print(f"grouped path: {TIMED_STEPS} steps, launches {launches}, "
          f"{TIMED_STEPS * BATCH / elapsed:.1f} env-steps/s on {smi}")
    check(finite, "non-finite obs, reward or u* on the grouped path")
    check_launches(launches, {"qp_newton": TIMED_STEPS, "boundary_stencil": TIMED_STEPS},
                   "grouped path")
    return dict(launches=launches, inputs=(qp_args, qp_static))


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
    from sigmarl_tpu_torch.utils.card_checks import capture_kernel_inputs, rollout

    per_chunk = (bench.N_CHUNKS + 1) * bench.T_STEPS  # the warm-up chunk and the timed ones
    out = {}
    for batch, n_sub in ((BATCH, 1), (bench.SUB_BATCHES * BATCH, bench.SUB_BATCHES)):
        rc, launches = counted(lambda: bench.main(["--batch", str(batch)]))
        check(rc == 0, f"bench --batch {batch} exited {rc}")
        n = per_chunk * n_sub
        check_launches(launches, {"qp_newton": n, "boundary_stencil": n}, f"bench B={batch}")
        print(f"bench B={batch}: launches {launches} ({n_sub} of each kernel per step)")
        out[f"bench_b{batch}"] = launches
    for flag, n in (("--grouped", 2 * per_chunk),
                    ("--census", bench.T_STEPS + bench.CENSUS_STEPS)):
        rc, launches = counted(lambda: bench.main([flag]))
        check(rc == 0, f"bench {flag} exited {rc}")
        check_launches(launches, {"qp_newton": n, "boundary_stencil": n}, f"bench {flag}")
        print(f"bench {flag}: launches {launches}")
        out["bench" + flag.replace("--", "_")] = launches

    # One more step than timed: the one whose host syncs are counted.
    n = bench_latency.WARMUP_STEPS + 1 + bench_latency.STEPS
    for batch in bench_latency.BATCHES:
        r, launches = counted(lambda: bench_latency.measure(batch, N_AGENTS))
        print(json.dumps(r))
        check_launches(launches, {"qp_newton": n, "boundary_stencil": n}, f"latency B={batch}")
        check(math.isfinite(r["p99"]), f"latency B={batch}: p99 {r['p99']}")
        env, cbf, policy, gen, _, _ = bench.main_path(batch, N_AGENTS, "cuda")
        state, obs = env.reset(generator=gen)
        state, obs, finite = rollout(env, cbf, policy, gen, state, obs,
                                     bench_latency.WARMUP_STEPS)
        check(finite, f"non-finite values on the latency path at B={batch}")
        qp_args, qp_static, pd_args = capture_kernel_inputs(env, cbf, policy, gen, state, obs)
        check_kernels(qp_args, qp_static, pd_args)
        out[f"latency_b{batch}"] = (launches, qp_args, qp_static, pd_args)

    (line, (env, warm, cold, state, act)), launches = counted(
        lambda: check_warm_start.certificate(BATCH, N_AGENTS, 5, 3, 10.0, 30, CERT_STEPS,
                                             device="cuda"))
    print(json.dumps(line))
    # Per step: the cold and the warm solve, the two evaluations and the
    # step's own solve (K1); the three assemblies and the step's (K2).
    check_launches(launches, {"qp_newton": 5 * CERT_STEPS, "boundary_stencil": 4 * CERT_STEPS},
                   "certificate")
    check(line["n_instances"] == BATCH * CERT_STEPS and line["ok"],
          f"the warm-start certificate is not ok: {line['gap_quantiles']}")
    cons, u_nom, _, _ = cold.assemble(state, act)
    cfg = cold.cfg
    cold_args = kernel_inputs(cons, u_nom, (cold.a_min, cold.rate_min),
                              (cold.a_max, cold.rate_max), None, cfg.newton_ws_cap)
    cold_static = ((cfg.w_u_acc, cfg.w_u_steer), (cold.a_min, cold.rate_min),
                   (cold.a_max, cold.rate_max))
    check_qp(cold_args, cold_static, " cold", budgets=((30, 0), (5, 3), (30, 2)))
    out["certificate"] = (launches, cold_args, cold_static)
    return out


def scaling_phase(smi) -> dict:
    """Weak scaling over ranks (`python -m sigmarl_tpu_torch.bench_scaling`)
    at JAX's defaults: 128 envs per rank, N=15, T=32, one warm-up and 3
    timed chunks, the filter at 2+10; first K1 and K2 against their plain
    versions on the input the bench's workload gives them, captured in this
    process at B=128 after 4 steps from the all-zero state (K1's controls
    bit for bit after 0 and 1 iterations and at 2+10), then the launcher:
    1 rank over nccl and 2 ranks sharing the card over gloo. Each rank
    launches K1 and K2 (chunks + 1) x T times and K3 once per reset step,
    runs 2 collectives per timed step, a finite reward; the 2-rank row
    measures mechanics."""
    import torch

    from sigmarl_tpu_torch import bench_scaling, zero_state
    from sigmarl_tpu_torch.ops.qp import newton_solve, newton_solve_reference
    from sigmarl_tpu_torch.utils.card_checks import capture_kernel_inputs, rollout

    args = bench_scaling.parse_args([])
    cfg = bench_scaling.config(args)
    env, cbf, policy = bench_scaling.workload(cfg, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = zero_state(env.cfg, env.device)
    obs = torch.zeros((args.per_device_batch, args.n_agents, env.obs_dim), device="cuda")
    state, obs, finite = rollout(env, cbf, policy, gen, state, obs, 4)
    check(finite, "non-finite values on the scaling bench's workload")
    qp_args, qp_static, pd_args = capture_kernel_inputs(env, cbf, policy, gen, state, obs)
    check_kernels(qp_args, qp_static, pd_args)
    budget = (args.newton_iters, cbf.cfg.newton_soft_iters)
    u_k, F_k = newton_solve(*qp_args, *qp_static, budget[0], soft_iters=budget[1])
    u_p, F_p = newton_solve_reference(*qp_args, *qp_static, budget[0], soft_iters=budget[1])
    torch.cuda.synchronize()
    err = float((u_k - u_p).abs().max())
    print(f"K1 scaling input (N={args.n_agents}, B={args.per_device_batch}, {budget[1]}+"
          f"{budget[0]}): max |u_kernel - u_plain| = {err:.3e}, max |F_kernel - F_plain| = "
          f"{float((F_k - F_p).abs().max()):.3e}")
    check(err == 0.0, f"K1 at {budget[1]}+{budget[0]} differs from its plain version by {err}")

    lines = bench_scaling.launch(args)
    rows, summary = lines[:-1], lines[-1]
    per_rank = (args.chunks + 1) * args.steps
    check([r["global_devices"] for r in rows] == [1, 2], f"scaling rows {rows}")
    for r in rows:
        what = f"scaling, {r['global_devices']} ranks over {r['backend']}"
        for launches in r["launches"]:
            check_launches(launches, {"qp_newton": per_rank, "boundary_stencil": per_rank,
                                      "spawn_place": r["reset_steps"]}, what)
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
    return dict(launches=rows[0]["launches"][0], inputs=(qp_args, qp_static, pd_args),
                budget=budget)


def _finite_losses(m) -> bool:
    keys = ("loss_objective", "loss_critic", "loss_entropy", "reward_mean")
    return all(math.isfinite(float(m[k])) for k in keys)


def print_iteration(what: str, i: int, m, frames: int, smi: str) -> None:
    r, g, u = m["seconds_rollout"], m["seconds_gae"], m["seconds_update"]
    print(f"{what} iteration {i + 1}: {r + g + u:.3f} s (rollout {r:.3f}, GAE {g:.4f}, "
          f"update {u:.3f}), {frames / r:.1f} rollout frames/s, loss {float(m['loss_objective']):.5f}"
          f" / {float(m['loss_critic']):.5f}; on {smi}")


def informed_training_phase(dev, smi, workdir) -> list:
    """CBF-informed training as the paper's reward sweep runs it
    (`INFORMED_TRAINING`: cpm_mixed, N=4, B=32, T=128, 30 epochs of
    minibatch 512, the "cbf" reward with h_nom 0.2 from the margins-only
    filter, observation noise on the observations and on the filter's
    nominal input). 2 iterations of `MAPPOCAVs.train`. K2 launches once per
    rollout step (128 per iteration) and K1 never; losses are finite, the
    weights move, and the checkpoint reloads equal."""
    import numpy as np
    import torch

    from sigmarl_tpu_torch import MAPPOCAVs, Parameters
    from sigmarl_tpu_torch.ops import launch_counts
    from sigmarl_tpu_torch.rl import checkpoint as ckpt
    from sigmarl_tpu_torch.rl.networks import to_jax_params
    from sigmarl_tpu_torch.utils.card_checks import INFORMED_TRAINING

    p = Parameters(**INFORMED_TRAINING, n_iters=2, device=dev,
                   where_to_save=os.path.join(workdir, "informed") + "/")
    tr = MAPPOCAVs(p)
    before = [t.detach().clone() for t in tr.parameter_list()]
    seen = []
    prev = launch_counts()
    _, decision, optim, *_ = tr.train(progress_callback=lambda i, m: seen.append(
        (m, launch_counts())))
    torch.cuda.synchronize()
    per_iter = []
    for i, (m, now) in enumerate(seen):
        per_iter.append({k: now[k] - prev[k] for k in now})
        prev = now
        print_iteration("CBF-informed training", i, m, p.frames_per_batch, smi)
        check(_finite_losses(m), f"non-finite loss or reward in CBF-informed iteration {i + 1}")
    print(f"CBF-informed training: launches per iteration {per_iter}")
    for n in per_iter:
        check_launches(n, {"qp_newton": 0, "boundary_stencil": p.max_steps},
                       "CBF-informed iteration")
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
    """CBF-filtered training at the main path's width (`FILTERED_TRAINING`:
    cpm_entire, N=15, B=1024, T=16, centralized filter at its default 2+15
    budget, one epoch of minibatch 4096), then the same trainer
    decentralized at N=4, B=32: one iteration each, K1 and K2 launched once
    per rollout step. Returns the launches, K1's input on the centralized
    run at 2+15 (checked against its plain version), and the model
    directory of the centralized run's checkpoint."""
    import torch

    from sigmarl_tpu_torch import MAPPOCAVs, Parameters, tanh_normal_sample
    from sigmarl_tpu_torch.rl import checkpoint as ckpt
    from sigmarl_tpu_torch.utils.card_checks import FILTERED_TRAINING, qp_capture, reset_counts

    out = {}
    for name, kw in (
        ("centralized", {}),
        ("decentralized", dict(n_agents=4, num_vmas_envs=32, is_using_centralized_cbf=False)),
    ):
        p = Parameters(**{**FILTERED_TRAINING, **kw}, n_iters=1, device=dev,
                       where_to_save=os.path.join(workdir, "filtered") + "/")
        tr = MAPPOCAVs(p)
        state = tr.initial_state()
        (state, m), launches = counted(lambda: tr.train_iteration(state))
        torch.cuda.synchronize()
        solved = float(m["cbf_solved_share"])
        print_iteration(f"CBF-filtered training ({name}, N={p.n_agents}, B={p.num_vmas_envs})", 0,
                        m, p.frames_per_batch, smi)
        print(f"CBF-filtered training ({name}): launches {launches}, solved share {solved:.6f}, "
              f"reset steps {fmt_branches(reset_counts(tr.env), p.max_steps)}")
        check(_finite_losses(m) and bool(torch.isfinite(state.obs).all()),
              f"non-finite obs, reward or loss in {name} filtered training")
        check(math.isfinite(solved), f"no solved share in {name} filtered training")
        check_launches(launches, {"qp_newton": p.max_steps, "boundary_stencil": p.max_steps},
                       f"{name} filtered training")
        out[name] = launches
        if name == "centralized":
            # The model directory the testing phase loads: this iteration's
            # weights under a reward key (episodes rarely end in 16 steps).
            rew = float(m["episode_reward_mean"])
            rew = round(rew, 2) if math.isfinite(rew) else 0.0
            saver = ckpt.RewardKeyedCheckpointer(p)
            check(saver.maybe_save(rew, tr.checkpoint_params(state), [rew]),
                  "the filtered-training checkpoint was not written")
            out["model_dir"] = saver.dir
            with torch.no_grad():
                loc, scale = state.policy(state.obs)
                act, _ = tanh_normal_sample(loc, scale, tr.low, tr.high, generator=tr.generator)
            out["qp"] = qp_capture(tr.cbf_filter, state.env_state, act)
            check_qp(*out["qp"], " 2+15 input", budgets=((30, 0), (15, 2)))
    return out


def rollout_policy_calls(net):
    """Counts the calls of `net` made without autograd, which are the
    rollout's (the update's loss runs with it); a CUDA graph's replay
    calls no module, so this counts eager acting only. Returns (counter,
    hook handle)."""
    import torch

    calls = [0]

    def hook(module, inputs, output):
        if not torch.is_grad_enabled():
            calls[0] += 1

    return calls, net.register_forward_hook(hook)


# XP-MARL's acting counts: its priority turns (a replay adds the N of its
# graph's capture) and the rank's and the turns' graphs (`rl/act_graphs.py`).
ACTING_COUNTS = ("turns", "turns.graph.captures", "turns.graph.replays", "rank.graph.captures",
                 "rank.graph.replays")


def acting_counts(before: dict) -> dict:
    """The acting counts since `before` (a `trace.snapshot()`'s counts)."""
    from sigmarl_tpu_torch import trace

    now = trace.snapshot()["counts"]
    return {k: now.get(k, 0) - before.get(k, 0) for k in ACTING_COUNTS}


def check_acting(tr, acting: dict, what: str, first: bool) -> None:
    """An XP-MARL rollout: N turns a step, and every step one replay of the
    turns' graph and, with learned priority, of the rank's, with no
    capture; a fresh trainer's first step captures them instead."""
    T, N, cap = tr.parameters.max_steps, tr.parameters.n_agents, int(first)
    learned = tr.prio_policy_net is not None
    check(acting["turns"] == N * T, f"{acting['turns']} turns in {T} {what} steps, want {N} a step")
    want = {"turns.graph.captures": cap, "turns.graph.replays": T - cap,
            "rank.graph.captures": cap * learned, "rank.graph.replays": (T - cap) * learned}
    got = {k: acting[k] for k in want}
    check(got == want, f"{what}: acting graphs {got} in {T} steps, want {want}")


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
    """One `train_iteration` of a fresh trainer; returns (trainer, state,
    metrics, its launches, the rollout's eager policy calls, its acting
    counts, the per-call rank flags)."""
    import torch

    from sigmarl_tpu_torch import MAPPOCAVs, trace

    tr = MAPPOCAVs(p)
    state = tr.initial_state()
    before = [t.detach().clone() for t in tr.parameter_list()]
    counts = trace.snapshot()["counts"]
    calls, handle = rollout_policy_calls(tr.policy_net)
    flags, unwrap = recording_ranks()
    try:
        (state, m), launches = counted(lambda: tr.train_iteration(state))
        torch.cuda.synchronize()
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
    return tr, state, m, launches, calls[0], acting_counts(counts), len(flags)


def xpmarl_training_phase(dev, smi, workdir) -> None:
    """XP-MARL as the ICRA'25 priority comparison runs it
    (`XPMARL_TRAINING`: cpm_mixed, N=4, B=32, T=128, 30 epochs of minibatch
    512, observation noise on): one iteration with learned and one with
    random priority, then one with opponent modeling in the same setting.
    Neither path runs a kernel."""
    from sigmarl_tpu_torch import Parameters
    from sigmarl_tpu_torch.utils.card_checks import OPPONENT_TRAINING, XPMARL_TRAINING

    for name, kw in (
        ("learned priority", XPMARL_TRAINING),
        ("random priority", {**XPMARL_TRAINING, "prioritization_method": "random"}),
        ("opponent modeling", OPPONENT_TRAINING),
    ):
        p = Parameters(**kw, n_iters=1, device=dev,
                       where_to_save=os.path.join(workdir, "xpmarl") + "/")
        tr, _, m, launches, calls, acting, n_ranks = one_iteration(p, smi, f"XP-MARL, {name},")
        print(f"XP-MARL, {name}: launches {launches}, {calls} eager rollout policy calls and "
              f"acting {acting} in {p.max_steps} steps, {n_ranks} ranks checked"
              + (f", priority loss {float(m['loss_priority']):.5f}" if tr.prio_policy_net else ""))
        if tr.use_prio:
            check_acting(tr, acting, name, first=True)
        else:
            check(calls == 2 * p.max_steps,
                  f"{calls} policy calls in {p.max_steps} {name} steps, want 2 per step")
        check(n_ranks == (p.max_steps if tr.use_prio else 0), f"{n_ranks} ranks in {name}")
        check_launches(launches, {"qp_newton": 0, "boundary_stencil": 0}, f"the {name} iteration")


def wide_xpmarl_phase(dev, smi, workdir) -> None:
    """Learned-priority XP-MARL with a CBF-filtered rollout at the main
    path's width on the `Parameters` defaults (`WIDE_XPMARL_TRAINING`: MTV
    distance and observation noise on, cpm_entire, N=15, B=1024, T=16,
    communication noise, the centralized filter at its 2+15 budget, one
    epoch of minibatch 4096). Two iterations: K1 and K2 launched once per
    rollout step, 15 turns per step, finite obs, rewards and losses; the
    first captures the acting's graphs at its first step, and every step
    of the second, timed, replays each once."""
    import time

    import torch

    from sigmarl_tpu_torch import Parameters, trace
    from sigmarl_tpu_torch.utils.card_checks import WIDE_XPMARL_TRAINING, reset_counts

    p = Parameters(**WIDE_XPMARL_TRAINING, n_iters=1, device=dev,
                   where_to_save=os.path.join(workdir, "wide") + "/")
    check(p.is_use_mtv_distance and p.is_obs_noise, "the wide run is not on the defaults")
    tr, state, m, launches, _, acting, _ = one_iteration(p, smi, "wide XP-MARL, CBF-filtered,")
    solved = float(m["cbf_solved_share"])
    print(f"wide XP-MARL, CBF-filtered: launches {launches}, solved share {solved:.6f}, "
          f"acting {acting} in {p.max_steps} steps, priority loss "
          f"{float(m['loss_priority']):.5f}, reset steps "
          f"{fmt_branches(reset_counts(tr.env), p.max_steps)}")
    check(math.isfinite(solved), "no solved share in the wide XP-MARL iteration")
    check_acting(tr, acting, "wide XP-MARL", first=True)
    check_launches(launches, {"qp_newton": p.max_steps, "boundary_stencil": p.max_steps},
                   "wide XP-MARL")
    counts = trace.snapshot()["counts"]
    t0 = time.perf_counter()
    (state, m), launches = counted(lambda: tr.train_iteration(state))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    acting = acting_counts(counts)
    print(f"wide XP-MARL, timed iteration: {elapsed:.3f} s, acting {acting}")
    check(_finite_losses(m), "non-finite loss in the timed wide XP-MARL iteration")
    check_acting(tr, acting, "timed wide XP-MARL", first=False)


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


def testing_phase(model_dir: str, smi: str) -> None:
    """`main_testing`'s function on the filtered-training phase's model
    directory (cpm_entire, N=15, the 3x256 policy), deterministic, B=32 (its
    `--num_envs` default), 128 recorded steps: finite records, single-agent
    resets counted, the JAX function's metric keys, no kernel launched."""
    from sigmarl_tpu_torch import main_testing

    (result, record, env), launches = counted(
        lambda: main_testing.test_model(model_dir, TESTING_STEPS, 32, 0, True, "cuda"))
    check_record(record, "the testing rollout")
    check(record["pos"].shape == (TESTING_STEPS, 32, 15, 2), f"record shape {record['pos'].shape}")
    check(set(result) == expected_metric_keys(record), f"testing metrics {sorted(result)}")
    singles = single_agent_resets(record)
    check(singles > 0 and env.reset_steps > 0, "no single-agent reset in the testing rollout")
    check_launches(launches, {"qp_newton": 0, "boundary_stencil": 0}, "testing")
    share = env.reset_steps / TESTING_STEPS
    print(f"testing (main_testing, cpm_entire, N=15, B=32, deterministic): {TESTING_STEPS} steps, "
          f"{result['timing_steps_per_s']:.1f} env-steps/s, the reset ran in {env.reset_steps} "
          f"steps ({share:.3f}), {singles} single-agent resets, collision rate "
          f"{result['collision_rate_total']:.4f}, launches {launches}; on {smi}")


def challenge_buffer_phase(dev, smi, workdir) -> None:
    """`FILTERED_TRAINING` with the challenging initial-state buffer at its
    defaults (record probability 1.0, replay probability 0.2, 100 slots,
    records from 10 steps back), 2 iterations from one state: K1 and K2
    launched once per rollout step, solved share 1.0, finite losses and
    observations; the records and replays of each iteration (the env's
    device-side counts). After both, at least one record in the buffer
    (cb_valid > 0) and at least one env that replayed. Should the filter
    keep every agent apart at this width (nothing recorded), the plain
    MAPPO iteration at the same width with the buffer on carries the record
    and replay check, and the phase says so."""
    import torch

    from sigmarl_tpu_torch import MAPPOCAVs, Parameters
    from sigmarl_tpu_torch.utils.card_checks import FILTERED_TRAINING, reset_counts

    def run(kw, what, filtered):
        p = Parameters(**kw, is_challenging_initial_state_buffer=True, n_iters=CHALLENGE_ITERS,
                       device=dev, where_to_save=os.path.join(workdir, "challenge") + "/")
        tr = MAPPOCAVs(p)
        state = tr.initial_state()
        replays = 0
        for i in range(CHALLENGE_ITERS):
            before = tr.env.challenge_counts.clone()
            (state, m), launches = counted(lambda: tr.train_iteration(state))
            torch.cuda.synchronize()
            records, replayed = (tr.env.challenge_counts - before).tolist()
            replays += replayed
            print_iteration(what, i, m, p.frames_per_batch, smi)
            check(_finite_losses(m) and bool(torch.isfinite(state.obs).all()),
                  f"non-finite obs, reward or loss in {what}")
            want = p.max_steps if filtered else 0
            check_launches(launches, {"qp_newton": want, "boundary_stencil": want}, what)
            if filtered:
                solved = float(m["cbf_solved_share"])
                check(solved == 1.0, f"{what} solved share {solved}")
            resets = reset_counts(tr.env)
            print(f"{what} iteration {i + 1}: launches {launches}, {records} states recorded, "
                  f"{replayed} env resets replayed a record, cb_valid "
                  f"{int(state.env_state.cb_valid)}, reset steps so far "
                  f"{fmt_branches(resets, (i + 1) * p.max_steps)}")
            check(resets[1] == 0,
                  f"{what}: a compacted reset step with the challenge buffer on")
        return int(state.env_state.cb_valid), replays

    valid, replays = run(FILTERED_TRAINING, "challenge buffer, CBF-filtered (N=15, B=1024)", True)
    if valid == 0 or replays == 0:
        print(f"challenge buffer: the filtered iterations recorded {valid} states and replayed "
              f"{replays}; the plain MAPPO iteration at the same width carries the check")
        plain = {**FILTERED_TRAINING, "rew_method": "distance", "is_using_cbf_training": False,
                 "is_solve_qp": False, "is_apply_cbf_action": False}
        valid, replays = run(plain, "challenge buffer, plain MAPPO (N=15, B=1024)", False)
    check(valid > 0, "the challenge buffer holds no record after the phase")
    check(replays > 0, "no env replayed a record in the challenge-buffer phase")


def check_eval_run(result: dict, record: dict, env, launches: dict, steps: int, what: str,
                   smi: str) -> dict:
    """The checks of a CBF-filtered evaluation rollout: finite records, the
    JAX function's metric keys, K1 and K2 once per step, every solve finite
    (solved share 1.0), a finite QP infeasibility rate. Returns its
    launches."""
    check_record(record, what)
    solved = float(record["cbf_solved"].mean())
    check(set(result) == expected_metric_keys(record), f"{what} metrics {sorted(result)}")
    check_launches(launches, {"qp_newton": steps, "boundary_stencil": steps}, what)
    check(solved == 1.0, f"{what} solved share {solved}")
    check(math.isfinite(result["qp_infeasibility_rate"]), f"{what} infeasibility rate")
    share = env.reset_steps / steps
    print(f"{what}: {steps} steps, {result['timing_steps_per_s']:.1f} env-steps/s, launches "
          f"{launches}, solved share {solved:.6f}, QP infeasibility rate "
          f"{result['qp_infeasibility_rate']:.4f}, the reset ran in {env.reset_steps} steps "
          f"({share:.3f}; {env.compact_reset_steps} compacted, {env.full_reset_steps} full "
          f"width), {single_agent_resets(record)} single-agent resets; on {smi}")
    return launches


def eval_rollout(env, cbf, steps: int, speed: float, what: str, smi: str) -> dict:
    """A recorded rollout through `cbf` with (speed, 0) nominal actions (the
    eval layer's `rollout`, as `main_eval` and the ITSC'25 sweep drive it),
    checked by `check_eval_run`; returns its launches."""
    import torch

    from sigmarl_tpu_torch.eval import metrics as M
    from sigmarl_tpu_torch.eval.rollout import constant_speed_policy, rollout

    gen = torch.Generator(device=env.device).manual_seed(0)
    (record, timings), launches = counted(
        lambda: rollout(env, constant_speed_policy(env, speed), steps, gen, cbf=cbf))
    result = M.basic_metrics(record)
    result["collisions_per_100m"] = M.collisions_per_100m(record)
    result.update({f"timing_{k}": v for k, v in timings.items()})
    return check_eval_run(result, record, env, launches, steps, what, smi)


def cbf_eval_phase(smi: str) -> dict:
    """`main_eval`'s function at its defaults (cpm_mixed, N=4, B=32, CLF
    nominal, windowed flag set, default 2+15 budget), 128 of its 600 steps,
    centralized and then `--decentralized`; then the windowed stencil
    (`windowed_eval_run`). Returns each run's launches, K1's CLF input and
    the window-selection K2 input."""
    from sigmarl_tpu_torch import main_eval
    from sigmarl_tpu_torch.utils.card_checks import clf_qp_capture, filtered_state

    out = {}
    for name, flags in (("centralized", []), ("decentralized", ["--decentralized"])):
        args = main_eval.parse_args(["--max_steps", str(EVAL_STEPS), "--device", "cuda"] + flags)
        (result, record, env, cbf), launches = counted(lambda: main_eval.evaluate(args))
        check(cbf.cfg.nom_controller_type == "clf" and cbf.cfg.use_windowed_pseudo_distance
              and env.cfg.is_testing_mode and cbf.decentralized == (name == "decentralized"),
              "not main_eval's defaults")
        out[name] = check_eval_run(result, record, env, launches, EVAL_STEPS,
                                   f"CBF evaluation ({name}, main_eval defaults)", smi)
        if name == "centralized":
            out["qp"] = clf_qp_capture(cbf, filtered_state(env, cbf))
    out["windowed"] = windowed_eval_run(smi)
    return out


def windowed_eval_run(smi: str) -> dict:
    """The windowed stencil, which JAX and the port take only with
    pd_topk_chunks = 0 (no CLI sets it): `main_eval`'s env and filter with
    that count, through the eval layer's `rollout`, 32 steps, K1 and K2 once
    per step. Returns the launches and K2's window-selection input at a
    state of this env."""
    from sigmarl_tpu_torch import CBFConfig, CBFSafetyFilter, Parameters, make_env
    from sigmarl_tpu_torch.safety.circles import circle_centers_world
    from sigmarl_tpu_torch.utils.card_checks import filtered_state

    p = Parameters(scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=32, dt=0.1,
                   max_steps=WINDOW_STEPS, is_testing_mode=True, is_obs_noise=False,
                   is_use_mtv_distance=False, nom_controller_type="clf", device="cuda")
    env = make_env(p)
    cbf = CBFSafetyFilter(CBFConfig(n_agents=4, dt=0.1, nom_controller_type="clf", pd_topk_chunks=0,
                                    use_windowed_pseudo_distance=True),
                          env.cfg, env.tables, device=env.device)
    launches = eval_rollout(env, cbf, WINDOW_STEPS, 0.5,
                            "windowed CBF evaluation (cpm_mixed, N=4, B=32, pd_topk_chunks=0)", smi)
    state = filtered_state(env, cbf)
    centers = circle_centers_world(cbf.centers_local, state.pos, state.rot)
    q, pid, cl, cr = cbf.stencil_inputs(centers, state.path_id, state.idx_left, state.idx_right)
    check(cl is not None and cl.shape[1] == 6, "no window selection")
    return dict(launches=launches, pd=(q, pid, env.tables.left_seg, env.tables.right_seg, cl, cr))


def itsc25_phase(smi: str, workdir: str) -> dict:
    """The ITSC'25 filter sweep through its driver
    (`sigmarl_tpu_torch/eval/papers.py::itsc25_safety_filter`: cpm_mixed, one
    agent, B=32, testing mode, the CLF controller, 0.6 m/s), one circle count
    at a time for C = 1..5, 32 of the paper's 600 steps each: K1 at P = 0
    and K2 once per step, the checks of `check_eval_run` on the record the
    driver wrote. Then the kernels' inputs of a live state of the same env
    and filter. Returns per C the launches and those inputs."""
    import numpy as np

    from sigmarl_tpu_torch import CBFConfig, CBFSafetyFilter, Parameters, make_env
    from sigmarl_tpu_torch.eval import metrics as M
    from sigmarl_tpu_torch.eval import papers
    from sigmarl_tpu_torch.safety.circles import circle_centers_world
    from sigmarl_tpu_torch.utils.card_checks import clf_qp_capture, filtered_state

    out = {}
    for C in (1, 2, 3, 4, 5):
        d = os.path.join(workdir, "itsc25")
        res, launches = counted(lambda: papers.itsc25_safety_filter(
            out_dir=d, device="cuda", max_steps=ITSC_STEPS, circles=(C,))[f"n_circles={C}"])
        record = dict(np.load(os.path.join(d, f"out_td_c{C}.npz")))
        what = f"ITSC'25 sweep (papers.itsc25_safety_filter), C={C}"
        check(set(res) == set(M.basic_metrics(record)) | {
            "timing_steps_per_s", "timing_wall_time_s", "timing_time_per_step_ms", "reset_share"},
            f"{what} results {sorted(res)}")
        check_record(record, what)
        solved = float(record["cbf_solved"].mean())
        check_launches(launches, {"qp_newton": ITSC_STEPS, "boundary_stencil": ITSC_STEPS}, what)
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
        centers = circle_centers_world(cbf.centers_local, state.pos, state.rot)
        q, pid, cl, cr = cbf.stencil_inputs(centers, state.path_id)
        out[C] = dict(launches=launches, qp=qp,
                      pd=(q, pid, env.tables.left_seg, env.tables.right_seg, cl, cr))
    return out


def wide_clf_phase(smi: str) -> dict:
    """CLF-filtered testing at the main path's width
    (`utils/card_checks.py::wide_clf_setup`: cpm_entire, N=15, B=1024, 3+5),
    16 steps. Returns the launches and K1's input."""
    from sigmarl_tpu_torch.utils.card_checks import clf_qp_capture, filtered_state, wide_clf_setup

    env, cbf = wide_clf_setup()
    launches = eval_rollout(env, cbf, WIDE_CLF_STEPS, 0.5,
                            "wide CLF evaluation (cpm_entire, N=15, B=1024, 3+5)", smi)
    return dict(launches=launches, qp=clf_qp_capture(cbf, filtered_state(env, cbf)))


def at25_phase(smi: str) -> None:
    """The scripted AT25 run (`eval/at25.py::run_model(None, n_agents=15)`)
    from `default_poses` through `reset_predefined`, B=1, 256 of its 18,000
    steps: the event counts per 100 m and the distance driven, finite."""
    from sigmarl_tpu_torch.eval import at25

    res, launches = counted(lambda: at25.run_model(None, n_agents=N_AGENTS, max_steps=AT25_STEPS,
                                                   device="cuda"))
    keys = ("agent_collision_events_per_100m", "boundary_collision_events_per_100m",
            "distance_driven_m")
    check(all(math.isfinite(res[k]) and res[k] >= 0 for k in keys) and res["distance_driven_m"] > 0,
          f"AT25 events {[res.get(k) for k in keys]}")
    print(f"AT25 (scripted, N=15, B=1, {AT25_STEPS} steps): agent events "
          f"{res['agent_collision_events_per_100m']:.4f} and boundary events "
          f"{res['boundary_collision_events_per_100m']:.4f} per 100 m over "
          f"{res['distance_driven_m']:.2f} m, {res['timing_steps_per_s']:.1f} env-steps/s, "
          f"launches {launches}; on {smi}")


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

    t0 = time.perf_counter()
    ecc, launches = counted(lambda: papers.ecc25_cbf_grid(
        out_dir=os.path.join(workdir, "ecc25"), device="cuda", figures=False))
    out["ecc25_s"] = time.perf_counter() - t0
    check_launches(launches, {"qp_newton": 0, "boundary_stencil": 0}, "the ECC'25 grid")
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


def sharded_phase(smi: str) -> None:
    """The CBF-filtered iteration at the main path's width with the
    challenge buffer on (`FILTERED_TRAINING`: N=15, B=1024, T=16, 2+15) on
    2 ranks sharing the card over gloo (`parallel/mesh.py`, 512 envs each,
    CUDA tensors staged through the host), against the same iteration in
    this process from the same start and draws: the checks of
    `utils/card_checks.py::sharded_vs_unsharded` (integer fields and flags
    equal, floats within 1e-3, u* 1e-2, the parameter rule of the CPU
    tests, K1 and K2 once per rollout step on every rank); whether the
    rollout is bit for bit, and if not, how far the policy's outputs for
    512 envs move when it runs on 1024. A second iteration from the
    generators is timed in each. (The 1-rank nccl group is the card test
    `test_one_rank_nccl_iteration_matches_the_unsharded_one`.)"""
    from sigmarl_tpu_torch import MAPPOCAVs, Parameters
    from sigmarl_tpu_torch.parallel.dryrun import spawn_ranks
    from sigmarl_tpu_torch.utils.card_checks import (
        FILTERED_TRAINING,
        policy_rows_invariant,
        sharded_iteration_rank,
        sharded_vs_unsharded,
        unsharded_iteration,
    )

    kw = {**FILTERED_TRAINING, "is_challenging_initial_state_buffer": True}
    ref = unsharded_iteration(kw, SHARDED_SEED)
    print(f"sharded phase, unsharded reference (N=15, B=1024): iterations "
          f"{ref['seconds'][0]:.3f} / {ref['seconds'][1]:.3f} s, launches {ref['launches']}, "
          f"(records, replays) {ref['counts'].tolist()}, (reset, compacted, full-width) steps "
          f"after each iteration {ref['resets']}; on {smi}")
    check(all(r[1] == 0 for r in ref["resets"]),
          f"a compacted reset step with the challenge buffer on ({ref['resets']})")
    tr = MAPPOCAVs(Parameters(**kw, device="cuda"))
    moved = policy_rows_invariant(tr.policy_net, ref["obs"].cuda(), BATCH // 2)
    print(f"sharded phase: the policy's outputs for {BATCH // 2} envs run alone against within "
          f"{BATCH}: max difference {moved:.3g}")
    name = "2 ranks, gloo, one card"
    t0 = time.perf_counter()
    ranks = spawn_ranks(sharded_iteration_rank, 2, kw, ref["start"], ref["draws"],
                        backend="gloo", device="cuda:0")
    wall = time.perf_counter() - t0
    checks = sharded_vs_unsharded(ref, ranks, name)
    for c in checks:
        print(f"  {c.what}: {c.value:.6g} (limit {c.limit:g}){'' if c.ok else ' FAIL'}")
    print(f"sharded phase, {name}: iterations {[r['seconds'] for r in ranks]} s per rank "
          f"(unsharded {ref['seconds']}), {wall:.1f} s with the processes' start; on {smi}")
    for c in checks:
        check(c.ok, f"{c.what}: {c.value} beyond {c.limit}")


def check_bit_for_bit(what: str, kernel, plain) -> None:
    """The kernel's outputs equal its plain version's bit for bit, and
    finite."""
    import torch

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) and bool(torch.isfinite(a).all()) for a, b in zip(out, ref)),
          f"{what}: the kernel differs from its plain version")


def kernel_report(main_run: dict, grouped: dict, programs: dict, scaling: dict, filtered: dict,
                  evals: dict, itsc: dict, wide_clf: dict, smi: str) -> list:
    """The kernel table's rows: K1 and K2 on the main path's input, and
    each variant's input with its launches on its path. The phases held
    each input to the plain version, but the CLF, one-agent and window
    inputs, which are held here: K1's controls after 0 and 1 iterations
    and K2's distances bit for bit."""
    from sigmarl_tpu_torch.ops.boundary import (
        pseudo_distance_stencil, pseudo_distance_stencil_reference,
    )
    from sigmarl_tpu_torch.ops.qp import newton_solve, newton_solve_reference
    from sigmarl_tpu_torch.utils.card_checks import cuda_ms_windows

    qp_args, qp_static, pd_args = main_run["inputs"]
    launches, errs = main_run["launches"], main_run["errs"]
    bench_paths = ("bench_b1024", "bench_b4096", "bench_census")

    k1_rows = []
    for what, (qp_a, qp_s), n_iters, soft, n, bound, exact in (
        ("grouped, Kp=18", grouped["inputs"], 5, 3,
         {"grouped": grouped["launches"], "bench_grouped": programs["bench_grouped"]}, False,
         False),
        ("filtered training", filtered["qp"], 15, 2, {"iteration": filtered["centralized"]}, True,
         False),
        ("CLF rows, cpm_entire N=15 B=1024 (wide CLF evaluation)", wide_clf["qp"], 5, 3,
         {"run": wide_clf["launches"]}, False, True),
        ("CLF rows, cpm_mixed N=4 B=32 (main_eval defaults)", evals["qp"], 15, 2,
         {"run": evals["centralized"]}, False, True),
        *((f"P=0, N=1 B=32 C={C} (ITSC'25 sweep)", itsc[C]["qp"], 15, 2,
           {"run": itsc[C]["launches"]}, False, True) for C in (1, 3, 5)),
        *((f"latency path, cpm_entire N=15 B={B}", programs[f"latency_b{B}"][1:3], 5, 3,
           {"run": programs[f"latency_b{B}"][0]}, True, False) for B in (1, 16)),
        ("cold oracle of the warm-start certificate, N=15 B=1024 (stress rollout)",
         programs["certificate"][1:], 30, 2, {"run": programs["certificate"][0]}, True, False),
        (f"weak-scaling bench, cpm_entire N=15 B={scaling['inputs'][0][2].shape[0]} per rank",
         scaling["inputs"][:2], *scaling["budget"], {"rank": scaling["launches"]}, True, False),
    ):
        for it in (0, 1) if exact else ():
            check_bit_for_bit(f"K1 {what}, {it} iterations",
                              lambda: newton_solve(*qp_a, *qp_s, it)[:1],
                              lambda: newton_solve_reference(*qp_a, *qp_s, it)[:1])
        r = dict(input=what, launches={k: v["qp_newton"] for k, v in n.items()},
                 **k1_timing(qp_a, qp_s, n_iters, soft, bound=bound))
        print_k1_timing(what, r, smi)
        k1_rows.append(r)

    k2_rows = []
    sc_pd = scaling["inputs"][2]
    for what, pd, n, exact in (
        (f"weak-scaling bench, {sc_pd[0].shape[0]} rows per rank (N=15 B=128)", sc_pd,
         scaling["launches"], False),
        *((f"latency path, {B * N_AGENTS} rows (N=15 B={B})", programs[f"latency_b{B}"][3],
           programs[f"latency_b{B}"][0], False) for B in (1, 16)),
        ("C=1, N=1 B=32 (ITSC'25 sweep)", itsc[1]["pd"], itsc[1]["launches"], True),
        ("C=5, N=1 B=32 (ITSC'25 sweep)", itsc[5]["pd"], itsc[5]["launches"], True),
        ("window selection, N=4 B=32 (pd_topk_chunks=0)", evals["windowed"]["pd"],
         evals["windowed"]["launches"], True),
    ):
        if exact:
            check_bit_for_bit(f"K2 {what}", lambda: pseudo_distance_stencil(*pd),
                              lambda: pseudo_distance_stencil_reference(*pd))
        r = dict(input=what, launches=n["boundary_stencil"], **k2_timing(pd))
        print_k2_timing(r, smi)
        k2_rows.append(r)

    k1 = lambda: newton_solve(*qp_args, *qp_static, 5, soft_iters=3)  # noqa: E731
    k1_row = k1_timing(qp_args, qp_static, 5, 3)
    print_k1_timing("main path", k1_row, smi)
    k2 = lambda: pseudo_distance_stencil(*pd_args)  # noqa: E731
    rows = [
        dict(name="qp_newton", route="cuda", source="sigmarl_tpu_torch/csrc/qp_newton.cu",
             replaces="sigmarl_tpu/ops/qp_pallas.py:370", launches=launches["qp_newton"],
             max_abs_err=errs["qp_newton"], **k1_row,
             back_to_back_ms=cuda_ms_windows(k1, reps=20)["ms"], library_ms=None,
             launches_by_path={k: programs[k]["qp_newton"] for k in bench_paths},
             variants=k1_rows),
        dict(name="boundary_stencil", route="cuda",
             source="sigmarl_tpu_torch/csrc/boundary_stencil.cu",
             replaces="sigmarl_tpu/ops/boundary_pallas.py:89",
             launches=launches["boundary_stencil"], max_abs_err=errs["boundary_stencil"],
             **k2_timing(pd_args), back_to_back_ms=cuda_ms_windows(k2, reps=200)["ms"],
             library_ms=None, launches_by_path={k: programs[k]["boundary_stencil"]
                                                for k in bench_paths},
             variants=k2_rows),
    ]
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms queued behind a spin, the card's time alone "
              f"(median of 7 windows, {r['ms_min']:.4f} to {r['ms_max']:.4f}), "
              f"{r['back_to_back_ms']:.4f} ms back to back; {fmt_bound(r)}, plain "
              f"{r['plain_ms']:.3f} ms, no single PyTorch call computes it")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    port = import_port()
    from sigmarl_tpu_torch.device import nvidia_smi_line
    from sigmarl_tpu_torch.ops import build

    t_start = time.perf_counter()
    dev = "cuda"
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"port {port.__version__})")
    print(smi)

    t0 = time.perf_counter()
    report = build.build_all(force=True)
    print(f"build: {len(report)} kernels in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for lib, (sec, log) in report.items():
        info = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        print(f"  {lib}: {sec:.1f} s; " + " | ".join(info))

    main_run = main_path_phase(dev, smi)
    k3_row = spawn_kernel_phase(main_run["env"], main_run["state"], smi)
    grouped = grouped_phase(main_run["env"], main_run["policy"], main_run["gen"], smi)
    programs = programs_phase(smi)
    scaling = scaling_phase(smi)
    os.makedirs(os.path.join(HERE, "outputs"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.path.join(HERE, "outputs")) as wd:
        informed_training_phase(dev, smi, wd)
        filtered = filtered_training_phase(dev, smi, wd)
        xpmarl_training_phase(dev, smi, wd)
        wide_xpmarl_phase(dev, smi, wd)
        testing_phase(filtered["model_dir"], smi)
        challenge_buffer_phase(dev, smi, wd)
        evals = cbf_eval_phase(smi)
        itsc = itsc25_phase(smi, wd)
        wide_clf = wide_clf_phase(smi)
        at25_phase(smi)
        ecc_lcss_phase(smi, wd)
    sharded_phase(smi)

    rows = kernel_report(main_run, grouped, programs, scaling, filtered, evals, itsc, wide_clf,
                         smi)
    spawns = main_run["launches"]["spawn_place"]
    rows.append(dict(k3_row, launches=spawns))
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
