#!/usr/bin/env python3
"""Env-steps/s of the port's main path in one or more checkouts, one after
another on the same card.

    python3 scripts/time_main_path.py [--checkout DIR ...] [--steps 16] [--repeats 7]

Each `--checkout` (default: this one) is a directory holding a
`chip_smoke.py` and its `sigmarl_tpu_torch/`, for example an earlier
commit unpacked with `git archive` into `_checkout/` (git-ignored). Give
them in the order to run, such as parent, change, change, parent. Each runs
in a process of its own: it builds the kernels of its checkout, sets up the
main path as that checkout's `chip_smoke.py` does (cpm_entire, N=15,
B=1024, centralized filter at 3+5, the 3x256 policy), warms up, and times
`--repeats` windows of `--steps` filtered steps on the host clock with the
card synchronised around each window. Prints one line per run and one JSON
line at the end with every window's rate. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(checkout: str, steps: int, repeats: int) -> dict:
    """Time the main path of `checkout` in this process."""
    sys.path.insert(0, os.path.abspath(checkout))
    import chip_smoke as cs
    import torch

    cs.import_port()
    from sigmarl_tpu_torch.ops import build

    build.build_all()
    env, cbf, policy, gen, state, obs = cs.setup_main_path("cuda")
    state, obs, finite, _ = cs.rollout(env, cbf, policy, gen, state, obs, cs.WARMUP_STEPS)
    rates = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, obs, ok, _ = cs.rollout(env, cbf, policy, gen, state, obs, steps)
        torch.cuda.synchronize()
        rates.append(steps * cs.BATCH / (time.perf_counter() - t0))
        finite = finite and ok
    if not finite:
        raise SystemExit(f"{checkout}: non-finite values on the main path")
    return dict(checkout=checkout, steps=steps, batch=cs.BATCH, rates=rates,
                median=statistics.median(rates))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", action="append", default=None)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.steps, args.repeats)))
        return 0

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    smi = smi[0] if smi else "nvidia-smi gave nothing"
    runs = []
    for checkout in args.checkout or [HERE]:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", checkout,
             "--steps", str(args.steps), "--repeats", str(args.repeats)],
            capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        r = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{checkout}: median {r['median']:.1f} env-steps/s over {len(r['rates'])} windows "
              f"of {r['steps']} steps at B={r['batch']} "
              f"({min(r['rates']):.1f} to {max(r['rates']):.1f}); on {smi}")
        runs.append(r)
    print(json.dumps({"device": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
