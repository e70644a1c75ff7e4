#!/usr/bin/env python3
"""Run every paper driver of the PyTorch port once with `--quick` and its
figures off, and print each driver's seconds beside the card's name and
power limit.

    python3 scripts/time_paper_drivers.py [--device cuda] [--out_dir outputs/papers_quick]
        [--only NAME ...]

Each driver runs in this process, one after another, through
`sigmarl_tpu_torch.eval.papers.main` (as `python -m
sigmarl_tpu_torch.eval.papers NAME --quick --no_figures` runs it; the
ECC'25 grid has no quick form and runs whole). Prints one line per driver
and a JSON line of {driver: seconds}; exits non-zero if a driver fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    from sigmarl_tpu_torch.eval import papers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out_dir", default=os.path.join(HERE, "outputs", "papers_quick"))
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args(argv)
    smi = card_line() if args.device == "cuda" else "the CPU"
    seconds = {}
    for name in args.only or sorted(papers.EXPERIMENTS):
        cli = [name, "--quick", "--no_figures", "--device", args.device,
               "--out_dir", os.path.join(args.out_dir, name)]
        t0 = time.perf_counter()
        papers.main(cli)
        seconds[name] = time.perf_counter() - t0
        print(f"paper driver {name} --quick: {seconds[name]:.1f} s on {smi}", flush=True)
    print(smi)
    print(json.dumps({"seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
