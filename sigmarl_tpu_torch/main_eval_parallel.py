"""CBF-evaluation sweep launcher of the PyTorch port.

    python -m sigmarl_tpu_torch.main_eval_parallel [--n_seeds 3]
        [--scenarios cpm_mixed ...] [--sweep_cbf] [--jobs 1] [--device {cuda,cpu}]

Builds the grid (seeds x scenarios x CBF on/off) and launches one
`python -m sigmarl_tpu_torch.main_eval` run per cell, one after another
or with `--jobs > 1` that many at a time. Every run goes to `--device`
(`cuda` unless `--device cpu` is given): with `--jobs > 1` on the card,
that many processes share it.
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_grid(args):
    grid = []
    for seed, scenario, cbf in itertools.product(
        range(args.n_seeds), args.scenarios, [False, True] if args.sweep_cbf else [True]
    ):
        cmd = [
            sys.executable, "-m", "sigmarl_tpu_torch.main_eval",
            "--scenario_type", scenario,
            "--n_agents", str(args.n_agents),
            "--num_envs", str(args.num_envs),
            "--max_steps", str(args.max_steps),
            "--seed", str(seed),
            "--out_dir", args.out_dir,
            "--device", args.device,
        ]
        if not cbf:
            cmd.append("--no_cbf")
        grid.append(cmd)
    return grid


def run(cmd):
    print("[RUN]", " ".join(cmd), flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    return subprocess.run(cmd, env=env).returncode


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_seeds", type=int, default=3)
    ap.add_argument("--scenarios", nargs="+", default=["cpm_mixed"])
    ap.add_argument("--n_agents", type=int, default=4)
    ap.add_argument("--num_envs", type=int, default=32)
    ap.add_argument("--max_steps", type=int, default=600)
    ap.add_argument("--sweep_cbf", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out_dir", type=str, default="outputs/eval_cbf")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    grid = build_grid(args)
    if args.jobs > 1:
        # Each worker only waits on its subprocess.
        with ThreadPoolExecutor(max_workers=args.jobs) as ex:
            codes = list(ex.map(run, grid))
    else:
        codes = [run(c) for c in grid]
    bad = [c for c in codes if c != 0]
    print(f"{len(grid) - len(bad)}/{len(grid)} runs succeeded")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
