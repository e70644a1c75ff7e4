#!/usr/bin/env python3
"""Time versions of the port's kernel sources against each other on the card,
in one process, on the main path's input.

    python3 scripts/time_kernel_sources.py [--qp FILE ...] [--stencil FILE ...]

Sets up the main path (`bench.py::main_path`: cpm_entire, N=15, B=1024,
centralized filter at the 3+5 budget), warms it up for 8 filtered steps and
captures the input of both kernels. Each `--qp` source is built in place of `csrc/qp_newton.cu`
and each `--stencil` source in place of `csrc/boundary_stencil.cu` (same C
interface; default: this checkout's), then run through the port's wrappers:

- checked against the plain version on that input: K1's controls after 0
  and 1 iterations and F at 30 and at the 3+5 budget, K2 in both modes;
- timed in two rounds, the second in reverse order (A, B, B, A), each
  time a median of 5 CUDA-event windows queued behind a spin on the card
  (`utils/card_checks.py::cuda_ms`), so the card's time alone.

To compare with an earlier commit, unpack its source into a directory that
.gitignore lists (`git show <commit>:sigmarl_tpu_torch/csrc/qp_newton.cu`)
and pass both files. Prints one JSON line at the end. Needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--qp", action="append", default=None, help="K1 source (repeatable)")
    ap.add_argument("--stencil", action="append", default=None, help="K2 source (repeatable)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_kernel_sources: no CUDA device is available", file=sys.stderr)
        return 1
    from sigmarl_tpu_torch.device import nvidia_smi_line
    from sigmarl_tpu_torch.ops import build as b
    from sigmarl_tpu_torch.ops.boundary import (
        pseudo_distance_stencil, pseudo_distance_stencil_reference,
    )
    from sigmarl_tpu_torch.ops.qp import newton_solve, newton_solve_reference
    from sigmarl_tpu_torch.utils import card_checks as cc

    kinds = {"qp_newton": args.qp, "boundary_stencil": args.stencil}
    if not any(kinds.values()):
        kinds = {name: [os.path.join(b.CSRC, src)] for name, src in b.SOURCES.items()}
    smi = nvidia_smi_line()
    env, cbf, policy, gen, state, obs, _ = cc.warm_main_path()
    qa, qs, pd = cc.capture_kernel_inputs(env, cbf, policy, gen, state, obs)
    q, pid, lseg, rseg, _, _ = pd

    def k1_errors():
        out = {}
        for it, soft in ((0, 0), (1, 0), (30, 0), (5, 3)):
            u_k, F_k = newton_solve(*qa, *qs, it, soft_iters=soft)
            u_p, F_p = newton_solve_reference(*qa, *qs, it, soft_iters=soft)
            key = f"{soft}+{it}"
            out[key] = (float((u_k - u_p).abs().max()) if it <= 1 else cc.rel_gap(F_k, F_p))
        return out

    def k2_errors():
        out = {}
        for mode, a in (("chunked", pd), ("full scan", (q, pid, lseg, rseg))):
            o, r = pseudo_distance_stencil(*a), pseudo_distance_stencil_reference(*a)
            out[mode] = max(float((o[i] - r[i]).abs().max()) for i in range(2))
        return out

    tags = {f"cmp_{kind}_{i}": (kind, src)
            for kind, sources in kinds.items() for i, src in enumerate(sources or [])}
    libs = b.build_sources({tag: src for tag, (_, src) in tags.items()})
    jobs = [(kind, src, libs[tag]) for tag, (kind, src) in tags.items()]

    calls = {"qp_newton": (lambda: newton_solve(*qa, *qs, 5, soft_iters=3), 20),
             "boundary_stencil": (lambda: pseudo_distance_stencil(*pd), 200)}
    results = {(kind, src): dict(kind=kind, source=os.path.relpath(src, ROOT), ms=[])
               for kind, src, _ in jobs}
    for kind, src, lib in jobs:
        with b.swapped_library(kind, lib):
            errs = k1_errors() if kind == "qp_newton" else k2_errors()
        torch.cuda.synchronize()
        results[(kind, src)]["errors"] = errs
        print(f"{kind} {src}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    # Two rounds, the second in reverse order, so drift hits every source alike.
    for kind, src, lib in jobs + jobs[::-1]:
        fn, reps = calls[kind]
        with b.swapped_library(kind, lib):
            t = cc.cuda_ms_windows(fn, reps=reps, windows=5, queued=True)
        results[(kind, src)]["ms"].append(t["ms"])
        print(f"{kind} {src}: {t['ms']:.4f} ms (median of 5 windows, {t['ms_min']:.4f} to "
              f"{t['ms_max']:.4f})", flush=True)
    print(smi)
    print(json.dumps(dict(device=smi, results=list(results.values()))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
