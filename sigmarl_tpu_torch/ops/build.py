"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), placed in
`_build/` beside the package. A library is rebuilt when its source is newer.
`build_all` starts one nvcc per source at once; `library` builds on first
use and loads. `build_sources` and `swapped_library` let tools run another
version of a kernel's source through the same wrappers.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: Kernel library name -> CUDA source under csrc/.
SOURCES = {
    "boundary_stencil": "boundary_stencil.cu",
    "qp_newton": "qp_newton.cu",
    "spawn_place": "spawn_place.cu",
}

# sm_90a keeps Hopper-only instructions available to later kernels.
# --fmad=false keeps every multiply and add rounded on its own, as the
# plain PyTorch versions round them, so kernel and plain version differ
# only by summation order.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels build only on a CUDA machine")
    return path


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    out, src = lib_path(name), os.path.join(CSRC, SOURCES[name])
    return not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src)


def _compile(jobs: dict) -> dict:
    """Run one nvcc per {library path: source} at once. Returns {library
    path: (seconds, ptxas report)}; raises if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for out, src in jobs.items():
        tmp = out + f".{os.getpid()}.tmp"
        procs[out] = (tmp, src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    report, failed = {}, []
    for out, (tmp, src, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)
        report[out] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def build_all(names=None, force: bool = False) -> dict:
    """Compile the named kernel libraries (all by default) in parallel, one
    nvcc process each. Returns {name: (seconds, ptxas report)}; raises if a
    build fails."""
    names = list(SOURCES) if names is None else list(names)
    done = _compile({lib_path(n): os.path.join(CSRC, SOURCES[n])
                     for n in names if force or _stale(n)})
    return {n: done.get(lib_path(n), (0.0, "up to date")) for n in names}


def build_sources(sources: dict) -> dict:
    """Compile CUDA sources from anywhere ({tag: path}) with the kernels'
    flags, in parallel, into `_build/lib<tag>.so`, and load them: {tag:
    CDLL}. For tools that run other versions of a kernel through the port's
    wrappers (see `swapped_library`)."""
    _compile({lib_path(tag): path for tag, path in sources.items()})
    return {tag: ctypes.CDLL(lib_path(tag)) for tag in sources}


@contextlib.contextmanager
def swapped_library(name: str, lib: ctypes.CDLL):
    """Within the block, the wrappers that load kernel library `name` get
    `lib` instead, which must have the same C interface."""
    global library
    real = library
    library = lambda n: lib if n == name else real(n)  # noqa: E731
    try:
        yield
    finally:
        library = real


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    if _stale(name):
        build_all([name])
    return ctypes.CDLL(lib_path(name))
