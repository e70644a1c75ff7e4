#!/usr/bin/env python3
"""The host work of one CBF-filtered step of the port's main path, counted
as PyTorch operator calls, in one or more checkouts. Runs on the CPU.

    python3 scripts/count_step_ops.py [--checkout DIR ...] [--steps 4]

Each `--checkout` (default: this one) is a directory holding a
`sigmarl_tpu_torch/`, for example an earlier commit unpacked with
`git archive` into `_checkout/` (git-ignored). Each runs in a process of
its own: the main path's configuration (cpm_entire, N=15, centralized
filter at 3+5, the 3x256 policy) at B=8, with the two kernels' wrappers
replaced by stubs that return zeros (on the CPU their plain versions would
issue most of the calls, where the card runs one launch each), 3 warm-up
steps, then `--steps` steps under `torch.profiler`. Prints the `aten::`
calls per step of each checkout and, for every later checkout, the
operators whose counts differ from the first's.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(checkout: str, steps: int) -> dict:
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import sigmarl_tpu_torch.safety.cbf_qp as cbf_module
    import sigmarl_tpu_torch.safety.qp as qp_module
    from sigmarl_tpu_torch import (
        CBFConfig, CBFSafetyFilter, Parameters, PolicyNet, cbf_filtered_step, make_env,
        tanh_normal_sample,
    )

    torch.set_num_threads(1)
    qp_module.newton_solve = lambda singles, pairs, u0, *a, **k: (
        u0.clone(), torch.zeros(u0.shape[0]))
    cbf_module.pseudo_distance_stencil = lambda q, *a: (
        torch.zeros(q.shape[:2]), torch.zeros(q.shape[:2]))
    B, N = 8, 15
    p = Parameters(scenario_type="cpm_entire", n_agents=N, num_vmas_envs=B, dt=0.1,
                   max_steps=1_000_000, is_use_mtv_distance=False, is_obs_noise=False,
                   is_using_cbf_testing=True, is_using_centralized_cbf=True)
    env = make_env(p, device="cpu")
    cbf = CBFSafetyFilter(CBFConfig(n_agents=N, n_circles=3, dt=0.1, newton_iters=5,
                                    newton_soft_iters=3), env.cfg, env.tables, device="cpu")
    policy = PolicyNet(env.obs_dim, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(0)
    lim = env.action_limits
    state, obs = env.reset(generator=gen)

    def step(state, obs):
        with torch.no_grad():
            loc, scale = policy(obs)
            act, _ = tanh_normal_sample(loc, scale, -lim, lim, generator=gen)
        state, obs, *_ = cbf_filtered_step(env, cbf, state, act, generator=gen)
        return state, obs

    for _ in range(3):
        state, obs = step(state, obs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            state, obs = step(state, obs)
    counts = collections.Counter({e.key: e.count for e in prof.key_averages()
                                  if e.key.startswith("aten::")})
    return dict(checkout=checkout, steps=steps, per_step=sum(counts.values()) / steps,
                counts=counts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", action="append", default=None)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.steps)))
        return 0
    runs = []
    for checkout in args.checkout or [HERE]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", checkout,
                              "--steps", str(args.steps)], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        r = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{checkout}: {r['per_step']:.2f} aten:: calls per filtered step "
              f"(B=8, kernels stubbed, {r['steps']} steps)")
        if runs:
            first = runs[0]["counts"]
            for k in sorted(set(first) | set(r["counts"])):
                a, b = first.get(k, 0), r["counts"].get(k, 0)
                if a != b:
                    print(f"  {k}: {a / args.steps:g} -> {b / args.steps:g} per step")
        runs.append(r)
    print(json.dumps({"runs": [{k: v for k, v in r.items() if k != "counts"} for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
