"""The reset of the port's main path on the card: its branches, its host
syncs and its time, compacted against full width.

    python -m sigmarl_tpu_torch.utils.profile_reset [--steps 64] [--windows 7]

Sets up the main path (`bench.py::main_path`: cpm_entire, N=15, B=1024,
centralized filter at 3+5, the 3x256 policy from seed 0), warms up for 8
filtered steps, then:

1. runs `--steps` filtered steps and prints how many envs reset in each
   (the done envs: on cpm_entire in training a reset is a whole env) and
   how many steps took each branch of the reset (none, compacted, full
   width);
2. counts the host syncs of one filtered step, and names where those of
   its filter, of its env step and of one reset in each branch wait
   (`device.py::host_syncs`);
3. on one seeded mask of about 23 % of the envs, times `apply_reset`
   compacted and at full width in turns (compacted, full, full,
   compacted): the host clock around `--windows` windows of 5 calls with
   the card synchronised after each window, and one call of each traced
   with torch.profiler (the device's busy time and the kernel launches of
   one call).

Prints one JSON line at the end. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

REPS = 5
N_AGENTS, BATCH, WARMUP_STEPS = 15, 1024, 8
# The share of envs that reset in one step of the main path (the JAX
# package's measure, `scripts/measure_resets.py`).
RESET_SHARE = 0.23


def traced(fn):
    """(device busy ms, kernel launches) of one call of `fn`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, launches = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.self_device_time_total
            launches += e.count
    return busy / 1e3, launches


def host_ms(fn, windows: int) -> list:
    """Milliseconds per call of `windows` windows of REPS calls, the card
    synchronised at the end of each."""
    import torch

    fn()
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / REPS * 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--windows", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_reset: no CUDA device is available", file=sys.stderr)
        return 1
    from sigmarl_tpu_torch import cbf_filtered_step
    from sigmarl_tpu_torch.bench import filtered_step, policy_actions
    from sigmarl_tpu_torch.device import host_syncs, nvidia_smi_line
    from sigmarl_tpu_torch.env.reset import ResetDraws, apply_reset, compact_slots
    from sigmarl_tpu_torch.utils.card_checks import warm_main_path

    smi = nvidia_smi_line()
    env, cbf, policy, gen, state, obs, _ = warm_main_path(BATCH, N_AGENTS, WARMUP_STEPS)
    slots = compact_slots(BATCH, False)

    before = (env.reset_steps, env.compact_reset_steps, env.full_reset_steps)
    resetting = []
    for _ in range(args.steps):
        state, obs, _, done = filtered_step(env, cbf, policy, state, obs, gen)
        resetting.append(int(done.sum()))
    branches = tuple(a - b for a, b in zip(
        (env.reset_steps, env.compact_reset_steps, env.full_reset_steps), before))
    shares = sorted(n / BATCH for n in resetting)
    print(f"main path, {args.steps} steps: {branches[0]} reset ({branches[1]} compacted, "
          f"{branches[2]} full width); resetting envs per step: mean "
          f"{statistics.mean(shares):.4f}, median {statistics.median(shares):.4f}, max "
          f"{shares[-1]:.4f} of B={BATCH} ({slots} slots)")

    act = policy_actions(env, policy, obs, gen)
    step_syncs = {
        "filtered step": len(host_syncs(
            lambda: cbf_filtered_step(env, cbf, state, act, generator=gen))),
        "filter": host_syncs(lambda: cbf.filter_actions(state, act, u_init=state.cbf_u_prev)),
        "env step": host_syncs(lambda: env.step(state, act, generator=gen)),
    }

    g = torch.Generator(device="cuda").manual_seed(23)
    env_any = torch.rand((BATCH,), generator=g, device="cuda") < RESET_SHARE
    mask = env_any[:, None].expand(BATCH, N_AGENTS).contiguous()
    k = int(env_any.sum())
    draws = ResetDraws.sample(env.cfg, g, "cuda", compact_slots=slots)
    fns = {"compacted": lambda: apply_reset(env.cfg, env.tables, state, mask, draws,
                                            compact=(0, k)),
           "full width": lambda: apply_reset(env.cfg, env.tables, state, mask, draws)}
    reset_syncs = {name: host_syncs(fn) for name, fn in fns.items()}
    print(f"host syncs: {step_syncs}; in one reset {reset_syncs}")

    res = {name: dict(host_ms=[], busy_ms=[], launches=[]) for name in fns}
    for name in ("compacted", "full width", "full width", "compacted"):
        res[name]["host_ms"] += host_ms(fns[name], args.windows)
        busy, launches = traced(fns[name])
        res[name]["busy_ms"].append(busy)
        res[name]["launches"].append(launches)
    for name, r in res.items():
        r["host_ms_median"] = statistics.median(r["host_ms"])
        print(f"reset ({name}, {k} of {BATCH} envs, N={N_AGENTS}): host "
              f"{r['host_ms_median']:.4f} ms per call (median of {len(r['host_ms'])} windows, "
              f"{min(r['host_ms']):.4f} to {max(r['host_ms']):.4f}), device busy "
              f"{r['busy_ms']} ms, {r['launches']} launches per call; on {smi}")
    print(smi)
    print(json.dumps(dict(device=smi, batch=BATCH, n_agents=N_AGENTS, steps=args.steps,
                          branches=branches, resetting_per_step=resetting,
                          step_syncs=step_syncs, reset_syncs=reset_syncs,
                          resetting_envs=k, reset=res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
