"""The port's hand-written CUDA kernels: K1, the QP's Newton solve
(`ops/qp.py`), K2, the pseudo-distance stencil (`ops/boundary.py`), and
K3, the reset's spawn placement (`ops/spawn.py`)."""

from __future__ import annotations


def launch_counts(since: dict | None = None) -> dict:
    """The launches of each kernel in this process so far (or since
    `trace.reset()`), from the trace's counts `k1.launches`,
    `k2.launches` and `k3.launches`; with `since`, an earlier reading,
    those after it."""
    from sigmarl_tpu_torch import trace

    counts = trace.snapshot()["counts"]
    now = {"qp_newton": counts.get("k1.launches", 0),
           "boundary_stencil": counts.get("k2.launches", 0),
           "spawn_place": counts.get("k3.launches", 0)}
    return now if since is None else {k: n - since[k] for k, n in now.items()}
