"""What the port's tracing (`sigmarl_tpu_torch/trace.py`) costs when it is
on without a profiler: the benchmark's untraced window of each cell, run
in one process alternately with tracing off and with `trace.enable()`,
time per unit (step, iteration, decision) of each window and the on
windows' median over the off windows' median.

    python3 scripts/trace_cost.py [--cells a,b] [--pairs 3] [--seconds 15] [--seed n]

One JSON line per cell, the card's name and power limit in each.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def per_unit_seconds(driver) -> float:
    n, seconds = (driver.units if hasattr(driver, "units")
                  else (driver.stats["iterations"], driver.stats["seconds"]))
    return seconds / n


def main(argv=None) -> None:
    import torch

    from benchmark import run
    from sigmarl_tpu_torch import trace
    from sigmarl_tpu_torch.device import device_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="cpm_entire_n15.rollout,cpm_mixed_n4.train,"
                                       "cpm_entire_n15.latency_b1")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=3_100_000_001)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = run.load(ROOT, "BENCHMARK.json")
    dev = torch.device(args.device)
    for name in args.cells.split(","):
        cell, config, traffic, limits = run.cell_files(spec, name)
        drv = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
        d = drv.Driver(config, traffic, limits, args.seed, dev)
        d.setup()
        off, on = [], []
        for i in range(2 * args.pairs):
            # Off first in even pairs, on first in odd ones.
            tracing = (i % 2 == 1) != ((i // 2) % 2 == 1)
            if tracing:
                trace.enable()
            try:
                metric = d.window(args.seconds)
            finally:
                trace.disable()
            (on if tracing else off).append((per_unit_seconds(d), metric))
        ratio = statistics.median(t for t, _ in on) / statistics.median(t for t, _ in off)
        print(json.dumps({"cell": name, "seconds": args.seconds, "device": device_line(dev),
                          "off_s_per_unit": [t for t, _ in off],
                          "on_s_per_unit": [t for t, _ in on],
                          "off": [m for _, m in off], "on": [m for _, m in on],
                          "on_over_off_pct": (ratio - 1.0) * 100.0}), flush=True)
        trace.reset()
        d.release()
        del d
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
