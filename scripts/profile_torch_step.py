#!/usr/bin/env python3
"""Where one CBF-filtered step of the PyTorch port spends its time on the
card.

    python3 scripts/profile_torch_step.py [--steps 8]

Sets up the main path as chip_smoke.py does (cpm_entire, N=15, B=1024,
centralized filter at the 3+5 budget), warms up, then:

1. times each stage of `--steps` steps on the host clock, with the card
   synchronised around every stage: the policy, the filter's constraint
   assembly (which runs the stencil kernel K2), the rest of the filter
   (the solve kernel K1 and the safe-action write-back), and the
   environment step;
2. traces `--steps` plain steps with torch.profiler and prints the kernel
   launches per step, the device's busy time per step and its busy and
   idle shares of the step (the sum of the stage times: the profiler's
   start-up inflates its own wall time), K1's and K2's shares, and the
   kernels with the most device time.

Prints one JSON line at the end. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device is available", file=sys.stderr)
        return 1
    cs.import_port()
    from sigmarl_tpu_torch import cbf_filtered_step
    from sigmarl_tpu_torch.env.structs import replace_state

    smi = cs.nvidia_smi_line()
    env, cbf, policy, gen, state, obs = cs.setup_main_path("cuda")
    state, obs, _, _ = cs.rollout(env, cbf, policy, gen, state, obs, cs.WARMUP_STEPS)

    stages = dict(policy=0.0, assemble=0.0, filter_rest=0.0, env_step=0.0)
    sync = torch.cuda.synchronize
    for _ in range(args.steps):
        sync()
        t0 = time.perf_counter()
        act = cs.policy_actions(env, policy, obs, gen)
        sync()
        t1 = time.perf_counter()
        cbf.assemble(state, act)
        sync()
        t2 = time.perf_counter()
        finfo = cbf.filter_actions(state, act, u_init=state.cbf_u_prev)
        sync()
        t3 = time.perf_counter()
        state = replace_state(state, nominal_action=finfo.nominal_actions,
                              applied_action=finfo.safe_actions, cbf_u_prev=finfo.u_star)
        state, obs, _, _, _ = env.step(state, finfo.safe_actions, generator=gen)
        sync()
        t4 = time.perf_counter()
        stages["policy"] += t1 - t0
        stages["assemble"] += t2 - t1
        stages["filter_rest"] += (t3 - t2) - (t2 - t1)
        stages["env_step"] += t4 - t3
    stage_ms = {k: v / args.steps * 1e3 for k, v in stages.items()}
    for k, v in stage_ms.items():
        print(f"stage {k}: {v:.3f} ms/step")

    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            act = cs.policy_actions(env, policy, obs, gen)
            state, obs, *_ = cbf_filtered_step(env, cbf, state, act, generator=gen)
        sync()
    wall_ms = (time.perf_counter() - t0) / args.steps * 1e3

    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        name = e.key
        if us > 0 or e.count:
            tot, cnt = kernels.get(name, (0.0, 0))
            kernels[name] = (tot + us, cnt + e.count)
    busy_ms = sum(t for t, _ in kernels.values()) / args.steps / 1e3
    launches = sum(c for _, c in kernels.values()) / args.steps

    def share(tag):
        return sum(t for k, (t, _) in kernels.items() if tag in k) / args.steps / 1e3

    k1_ms, k2_ms = share("qp_newton_kernel"), share("pd_stencil_kernel")
    # The profiler's own start-up fills the traced wall time, so the busy
    # share is taken against the synchronised stage times of the first part.
    step_ms = sum(stage_ms.values())
    print(f"traced {args.steps} steps: {wall_ms:.3f} ms/step wall (profiler on), device busy "
          f"{busy_ms:.3f} ms/step, {launches:.0f} kernel launches/step; against the "
          f"{step_ms:.3f} ms step of the stages the device is busy {busy_ms / step_ms:.1%} "
          f"and idle {1 - busy_ms / step_ms:.1%}")
    print(f"K1 qp_newton {k1_ms:.4f} ms/step, K2 pd_stencil {k2_ms:.4f} ms/step, "
          f"other kernels {busy_ms - k1_ms - k2_ms:.3f} ms/step")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (us, cnt) in top:
        print(f"  {us / args.steps / 1e3:8.4f} ms/step  {cnt / args.steps:6.1f}/step  {name[:90]}")
    print(smi)
    print(json.dumps(dict(
        device=smi, batch=cs.BATCH, n_agents=cs.N_AGENTS, steps=args.steps,
        stage_ms=stage_ms, step_ms=step_ms, traced_wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1 - busy_ms / step_ms,
        launches_per_step=launches, k1_ms=k1_ms, k2_ms=k2_ms,
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
