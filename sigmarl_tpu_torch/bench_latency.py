"""The lab deployment's latency: one filtered control decision per step,
each ended by a blocking wait for the card.

    python -m sigmarl_tpu_torch.bench_latency [--batch 1 --batch 16]
        [--n_agents 15] [--steps 300] [--device cuda]

The counterpart of the JAX package's `scripts/bench_latency.py`. The
reference's lab makes one control decision every dt = 0.1 s; this times
one step of the main path (policy, centralized CBF-QP filter at 3+5, env
step; `bench.py`'s setup) at small batch, issued once per control period
and ended with `torch.cuda.synchronize()`, the read-back before
actuation. For each batch: `env.reset` from the generator's seed 0, 20
warm-up steps, then `--steps` timed steps on the host's clock. Prints one
JSON line per batch: mean, p50 and p99 of the step's milliseconds, the
100 ms budget and the share of it the p99 uses, and the host syncs of one
step (PyTorch's sync debug mode; not measured on the CPU).

On the CPU (`--device cpu`, the kernels' plain versions) for a small run:
`--device cpu --batch 1 --n_agents 4 --steps 3`. Without a card and
without `--device cpu` the program raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from sigmarl_tpu_torch.bench import N_AGENTS, filtered_step, main_path
from sigmarl_tpu_torch.device import device_line, host_syncs, resolve_device, synchronize

CONTROL_BUDGET_MS = 100.0  # the reference's dt = 0.1 s
BATCHES, STEPS, WARMUP_STEPS = (1, 16), 300, 20


def measure(batch: int, n_agents: int = N_AGENTS, n_steps: int = STEPS, device=None,
            warmup: int = WARMUP_STEPS) -> dict:
    """Latency of one filtered step at `batch` envs, each step ended by a
    wait for the card."""
    dev = resolve_device(device)
    env, cbf, policy, gen, _, _ = main_path(batch, n_agents, dev)
    state, obs = env.reset(generator=gen)
    for _ in range(warmup):
        state, obs, _, _ = filtered_step(env, cbf, policy, state, obs, gen)
    synchronize(dev)
    syncs = None
    if dev.type == "cuda":
        syncs = len(host_syncs(lambda: filtered_step(env, cbf, policy, state, obs, gen)))

    lat = np.zeros(n_steps)
    for i in range(n_steps):
        t0 = time.perf_counter()
        state, obs, rew, _ = filtered_step(env, cbf, policy, state, obs, gen)
        synchronize(dev)  # the control loop: wait before actuating
        lat[i] = time.perf_counter() - t0
    lat_ms = lat * 1e3
    p99 = float(np.percentile(lat_ms, 99))
    return {
        "metric": "cbf_filtered_step_latency_ms",
        "batch": batch,
        "n_agents": n_agents,
        "steps": n_steps,
        "mean": round(float(lat_ms.mean()), 3),
        "p50": round(float(np.percentile(lat_ms, 50)), 3),
        "p99": round(p99, 3),
        "budget_ms": CONTROL_BUDGET_MS,
        "budget_used_pct_p99": round(p99 / CONTROL_BUDGET_MS * 100, 2),
        "host_syncs_per_step": syncs,
        "device": device_line(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, action="append", default=None,
                    help=f"repeatable (default: {', '.join(map(str, BATCHES))})")
    ap.add_argument("--n_agents", type=int, default=N_AGENTS)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for batch in args.batch or BATCHES:
        print(json.dumps(measure(batch, args.n_agents, args.steps, dev)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
