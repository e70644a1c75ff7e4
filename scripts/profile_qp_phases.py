#!/usr/bin/env python3
"""Where the solve kernel K1 (`csrc/qp_newton.cu`) spends its time, phase by
phase, on the card.

    python3 scripts/profile_qp_phases.py [--source FILE ...] [--input {main,clf}]

Sets up the main path (`bench.py::main_path`: cpm_entire, N=15, B=1024,
centralized filter), warms it up for 8 filtered steps and captures K1's
input; with `--input clf`, the same width in testing mode with the CLF
nominal controller (its two CLF rows per agent active), as the wide CLF
evaluation of `utils/card_checks.py::wide_clf_setup` runs it, 4 filtered
steps after a reset. Then, for each
kernel source (default: this checkout's), it builds an instrumented copy
in `sigmarl_tpu_torch/_build/`: every function of the source that holds
phase markers (comment lines `// ---- <phase> ...`, each placed right
after a block barrier) gets a `clock64()` stamp on thread 0 at each marker
and at its end, and the kernel gets one at its start and end. Per block
the stamps add the cycles of each phase; the script prints the cycles per
block, their share of the block's cycles, and that share of the
uninstrumented kernel's time (median of 7 CUDA-event windows queued
behind a spin, at the 3 ladder + 5 Newton budget). It also gives the
cycles of each phase with one block per SM (the first 132 envs), where no
other block competes for the SM, and the kernel's time at 1, 2 and 4
blocks per SM. The committed source carries no switch for this: the copy
is made here, and a source without markers is refused.

Each source is run through this checkout's `ops/qp.py::newton_solve`, so a
source given with `--source` must have the same C interface. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_PRELUDE = r"""
__device__ unsigned long long __qp_cycles[64];
__device__ unsigned long long __qp_count[64];
__device__ __forceinline__ void __qp_stamp(int done) {
    __shared__ long long last;
    if (threadIdx.x == 0) {
        const long long now = clock64();
        if (done >= 0) {
            atomicAdd(&__qp_cycles[done], (unsigned long long)(now - last));
            atomicAdd(&__qp_count[done], 1ull);
        }
        last = now;
    }
}
__device__ __forceinline__ void __qp_total(bool end) {
    __shared__ long long t0;
    if (threadIdx.x == 0) {
        const long long now = clock64();
        if (end) {
            atomicAdd(&__qp_cycles[0], (unsigned long long)(now - t0));
            atomicAdd(&__qp_count[0], 1ull);
        } else {
            t0 = now;
        }
    }
}
"""

_EPILOGUE = r"""
extern "C" int qp_prof_read(unsigned long long* cycles, unsigned long long* count) {
    cudaError_t e = cudaMemcpyFromSymbol(cycles, __qp_cycles, sizeof(__qp_cycles));
    if (e == cudaSuccess) e = cudaMemcpyFromSymbol(count, __qp_count, sizeof(__qp_count));
    return (int)e;
}
extern "C" int qp_prof_reset() {
    unsigned long long z[64] = {0};
    cudaError_t e = cudaMemcpyToSymbol(__qp_cycles, z, sizeof(z));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(__qp_count, z, sizeof(z));
    return (int)e;
}
"""

_MARK = re.compile(r"^\s*// ---- ([A-Za-z0-9 _+-]+?)(?:[:,.(]|$)")


def _body_end(lines, start):
    """Index of the line holding the closing brace of the function whose
    signature starts at `start` (brace counting; the source keeps braces
    out of strings and comments at function level)."""
    depth, opened = 0, False
    for k in range(start, len(lines)):
        code = lines[k].split("//")[0]
        for ch in code:
            if ch == "{":
                depth, opened = depth + 1, True
            elif ch == "}":
                depth -= 1
                if opened and depth == 0:
                    return k
    raise ValueError(f"no end for the function at line {start + 1}")


def instrument(src: str):
    """(instrumented source, phase names by id). Phase 0 is the whole
    kernel."""
    lines = src.splitlines()
    names = ["kernel total"]
    inserts = {}  # line index -> list of statements inserted before it
    sig = re.compile(r"^(?:__global__|__device__)[^;]*\b(\w+)\s*\(")
    k = 0
    while k < len(lines):
        m = sig.match(lines[k])
        if not m or (k + 1 < len(lines) and lines[k].rstrip().endswith(";")):
            k += 1
            continue
        end = _body_end(lines, k)
        marks = [i for i in range(k, end) if _MARK.match(lines[i])]
        if "__global__" in lines[k]:
            first = next(i for i in range(k, end) if "{" in lines[i].split("//")[0])
            inserts.setdefault(first + 1, []).append("__qp_total(false);")
            inserts.setdefault(end, []).append("__qp_total(true);")
        elif marks:
            prev = -1
            for i in marks:
                inserts.setdefault(i, []).append(f"__qp_stamp({prev});")
                names.append(_MARK.match(lines[i]).group(1).strip())
                prev = len(names) - 1
            inserts.setdefault(end, []).append(f"__qp_stamp({prev});")
        k = end + 1
    out = []
    for i, ln in enumerate(lines):
        for stmt in inserts.get(i, []):
            out.append("    " + stmt)
        out.append(ln)
    if len(names) == 1:
        raise ValueError("the source has no phase markers (`// ---- <phase>` comment lines)")
    text = "\n".join(out)
    # The prelude goes after the includes, the reader functions at the end.
    head, sep, rest = text.partition("namespace {")
    if not sep:
        raise ValueError("the source has no anonymous namespace to instrument")
    return head + _PRELUDE + sep + rest + _EPILOGUE, names


def build(source: str, idx: int):
    """The source as it is and its instrumented copy, both built and loaded:
    (plain library, instrumented library, phase names)."""
    from sigmarl_tpu_torch.ops import build as b

    with open(source) as f:
        text, names = instrument(f.read())
    os.makedirs(b.BUILD_DIR, exist_ok=True)
    cu = os.path.join(b.BUILD_DIR, f"qp_prof_{idx}.cu")
    with open(cu, "w") as f:
        f.write(text)
    libs = b.build_sources({f"qp_plain_{idx}": source, f"qp_prof_{idx}": cu})
    return libs[f"qp_plain_{idx}"], libs[f"qp_prof_{idx}"], names


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=None,
                    help="kernel source to instrument (repeatable; default csrc/qp_newton.cu)")
    ap.add_argument("--input", choices=["main", "clf"], default="main",
                    help="K1's input: the main path's, or the CLF-filtered testing run's")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_qp_phases: no CUDA device is available", file=sys.stderr)
        return 1
    from sigmarl_tpu_torch.device import nvidia_smi_line
    from sigmarl_tpu_torch.ops import build as b
    from sigmarl_tpu_torch.ops.qp import newton_solve
    from sigmarl_tpu_torch.utils import card_checks as cc

    sources = args.source or [os.path.join(b.CSRC, "qp_newton.cu")]
    smi = nvidia_smi_line()
    if args.input == "main":
        env, cbf, policy, gen, state, obs, _ = cc.warm_main_path()
        qp_args, qp_static, _ = cc.capture_kernel_inputs(env, cbf, policy, gen, state, obs)
    else:
        env, cbf = cc.wide_clf_setup()
        qp_args, qp_static = cc.clf_qp_capture(cbf, cc.filtered_state(env, cbf))
    B = qp_args[2].shape[0]

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def solver(n):
        args = [t[:n] if t.dim() > 1 else t for t in qp_args[:5]] + list(qp_args[5:])
        return lambda: newton_solve(*args, *qp_static, 5, soft_iters=3)  # noqa: E731

    def phase_cycles(lib, n):
        """Cycles per block of each phase at a batch of n envs."""
        solve = solver(n)
        with b.swapped_library("qp_newton", lib):
            solve()
            torch.cuda.synchronize()
            lib.qp_prof_reset()
            solve()
            torch.cuda.synchronize()
        cyc = (ctypes.c_ulonglong * 64)()
        cnt = (ctypes.c_ulonglong * 64)()
        err = lib.qp_prof_read(cyc, cnt)
        if err:
            raise RuntimeError(f"reading the phase counters failed: CUDA error {err}")
        return [c / n for c in cyc], [c / n for c in cnt]

    results = []
    for idx, src in enumerate(sources):
        plain_lib, prof_lib, names = build(src, idx)
        with b.swapped_library("qp_newton", plain_lib):
            ms = cc.cuda_ms_windows(solver(B), reps=10, windows=7, queued=True)
            # Batches of 1, 2 and 4 blocks per SM: flat times mean each
            # block's own latency sets the time, times that grow with the
            # batch mean the SMs' issue rate does.
            scaling = {n: cc.cuda_ms_windows(solver(n), reps=10, windows=5, queued=True)["ms"]
                       for n in (sms, 2 * sms, 4 * sms) if n <= B}
        cyc, cnt = phase_cycles(prof_lib, B)
        cyc1, _ = phase_cycles(prof_lib, min(sms, B))
        total = cyc[0]
        print(f"{src}: kernel {ms['ms']:.4f} ms at B={B} (median of 7; {ms['ms_min']:.4f}-"
              f"{ms['ms_max']:.4f}); " + ", ".join(f"B={n}: {t:.4f} ms" for n, t in scaling.items()))
        print(f"  cycles per block at B={B} | alone (B={min(sms, B)}, one block per SM)")
        print(f"  {'whole kernel':28s} {total:10.0f} | {cyc1[0]:10.0f}")
        phases = {}
        inside = inside1 = 0.0
        for i, name in enumerate(names[1:], start=1):
            inside += cyc[i]
            inside1 += cyc1[i]
            share = cyc[i] / total
            phases[name] = dict(cycles_per_block=cyc[i], cycles_alone=cyc1[i],
                                stamps_per_block=cnt[i], share=share, ms=share * ms["ms"])
            print(f"  {name:28s} {cyc[i]:10.0f} | {cyc1[i]:10.0f}  ({cnt[i]:4.1f} per block) "
                  f"{share:6.1%}  ~{share * ms['ms']:.4f} ms")
        rest = (total - inside) / total
        phases["outside the marked phases"] = dict(
            cycles_per_block=total - inside, cycles_alone=cyc1[0] - inside1, share=rest,
            ms=rest * ms["ms"])
        print(f"  {'outside the marked phases':28s} {total - inside:10.0f} | "
              f"{cyc1[0] - inside1:10.0f}             {rest:6.1%}  ~{rest * ms['ms']:.4f} ms")
        results.append(dict(source=os.path.relpath(src, ROOT), **ms, scaling_ms=scaling,
                            cycles_per_block=total, cycles_alone=cyc1[0], phases=phases))
    print(smi)
    print(json.dumps(dict(device=smi, input=args.input, batch=B, budget="3+5", results=results)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
