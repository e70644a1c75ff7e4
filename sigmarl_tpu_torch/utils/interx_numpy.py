"""Unbatched numpy curve-intersection reference.

The plain O(S1*S2) two-curve intersection test of MATLAB's InterX (as the
original SigmaRL's `interX_original.py` has it), kept as an independent
oracle for the batched tensor version (`core/geometry.py::interx`); used
by tests and host-side tools.
"""

from __future__ import annotations

import numpy as np


def interx_points(L1: np.ndarray, L2: np.ndarray) -> np.ndarray:
    """Intersection points of two polylines. L1 [P1, 2], L2 [P2, 2].

    Returns [K, 2] intersection coordinates (K may be 0). Collinear-overlap
    segments report their endpoint crossings like the MATLAB original.
    """
    x1, y1 = L1[:, 0], L1[:, 1]
    x2, y2 = L2[:, 0], L2[:, 1]
    dx1, dy1 = np.diff(x1), np.diff(y1)
    dx2, dy2 = np.diff(x2), np.diff(y2)

    S1 = dx1 * y1[:-1] - dy1 * x1[:-1]
    S2 = dx2 * y2[:-1] - dy2 * x2[:-1]

    C1 = (
        (dx1[:, None] * y2[None, :] - dy1[:, None] * x2[None, :] - S1[:, None])[:, :-1]
        * (dx1[:, None] * y2[None, :] - dy1[:, None] * x2[None, :] - S1[:, None])[:, 1:]
    ) <= 0
    C2 = (
        (y1[:, None] * dx2[None, :] - x1[:, None] * dy2[None, :] - S2[None, :])[:-1, :]
        * (y1[:, None] * dx2[None, :] - x1[:, None] * dy2[None, :] - S2[None, :])[1:, :]
    ) <= 0

    i, j = np.nonzero(C1 & C2)
    if i.size == 0:
        return np.zeros((0, 2))

    out = []
    for a, b in zip(i, j):
        d = dx1[a] * dy2[b] - dy1[a] * dx2[b]
        if abs(d) < 1e-14:
            continue  # parallel/collinear pair
        t = (dx2[b] * (y1[a] - y2[b]) - dy2[b] * (x1[a] - x2[b])) / d
        out.append([x1[a] + t * dx1[a], y1[a] + t * dy1[a]])
    if not out:
        return np.zeros((0, 2))
    return np.unique(np.round(np.array(out), 12), axis=0)


def interx_bool(L1: np.ndarray, L2: np.ndarray) -> bool:
    """Strict-crossing test matching the batched kernel's semantics
    (`core/geometry.py::interx` uses strict inequality — touching without
    crossing does not register)."""
    x1, y1 = L1[:, 0], L1[:, 1]
    x2, y2 = L2[:, 0], L2[:, 1]
    dx1, dy1 = np.diff(x1), np.diff(y1)
    dx2, dy2 = np.diff(x2), np.diff(y2)
    S1 = dx1 * y1[:-1] - dy1 * x1[:-1]
    S2 = dx2 * y2[:-1] - dy2 * x2[:-1]
    d1 = dx1[:, None] * y2[None, :] - dy1[:, None] * x2[None, :]
    C1 = (d1[:, :-1] - S1[:, None]) * (d1[:, 1:] - S1[:, None]) < 0
    d2 = y1[:, None] * dx2[None, :] - x1[:, None] * dy2[None, :]
    C2 = (d2[:-1, :] - S2[None, :]) * (d2[1:, :] - S2[None, :]) < 0
    return bool(np.any(C1 & C2))
