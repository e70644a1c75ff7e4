"""The readings the correctness limits are set from, at a cell's own
sizes, several seeds in one process.

    python -m benchmark.readings --workload <cell> --seeds 11,12,13 --seconds 10 \
        [--variants lower,half,altered,unchanged]

For each seed: the cell's set-up, a window of `--seconds` (long enough to
reach the sampled steps), then the compared numbers of the program (the
lower readings) and of each variant put in the program's place: `lower`,
the reference in the next precision down (the control: the policy's and
critic's products in TF32, every other float output rounded to
bfloat16); on the train cell also `half` (each minibatch's loss over half
its rows), `altered` (a reward altered where the env step produces it)
and `unchanged` (an update that leaves the parameters and moments as
they were). One JSON line per seed and variant; the limits in
`workloads/<cell>.json` lie between the program's largest reading and the
smallest reading that fails it."""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys

import torch

from benchmark.harness import card, guard
from benchmark.run import ROOT, cell_files, load, merge


def readings(workload: str, seeds, seconds: float, variants, device=None,
             overrides=None) -> list:
    cell, config, traffic, limits = cell_files(load(ROOT, "BENCHMARK.json"), workload)
    overrides = overrides or {}
    config = merge(config, overrides.get("config", {}))
    traffic = merge(traffic, overrides.get("traffic", {}))
    guard.import_program(ROOT)
    dev = card.require_cards(cell["chips"]) if device is None else torch.device(device)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    out = []
    for seed in seeds:
        run = driver.Driver(config, traffic, limits, seed, dev)
        run.setup()
        run.window(seconds)
        run.release()
        gc.collect()
        for variant in [None, *variants]:
            checks = run.check(control=variant if variant != "lower" else True)
            line = {"workload": workload, "seed": seed, "variant": variant or "program",
                    "values": {c.name: c.value for c in checks},
                    "correct": all(c.passes for c in checks)}
            print(json.dumps(line), flush=True)
            out.append(line)
        del run
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    guard.check_imports()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--variants", default="lower")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    variants = [v for v in args.variants.split(",") if v]
    try:
        readings(args.workload, seeds, args.seconds, variants)
    except (card.NoCard, guard.GuardError) as e:
        print(f"readings: {e}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
