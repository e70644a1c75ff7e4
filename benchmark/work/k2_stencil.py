"""K2, the pseudo-distance stencil: the operations and bytes that the
queries against the segments the input selects need.

R = B N rows (one per agent), Q = 9 C queries per row (the 9-point
stencil around each circle centre), two sides, k selected chunks of 16
segments per row and side, segment tables [K, S, 8] float32 per side.

Operations: a query's distance is the minimum over the selected segments
whose projection is valid, so each (row, query, side) needs at least the
exact evaluation of the segment that attains it: the query in the
segment's frame (8), the projection's numerator and denominator (4), the
division (1), the distance's square (5), the window test (2), the root
(1): 21. Which other segments can be ruled out depends on the data, so
none of them is counted.

Bytes: each input read once (queries [R, Q, 2] float32, path ids [R] and
chunk indices [R, k] per side int32, both segment tables) and each
output written once (distances [R, Q] per side, float32)."""

from __future__ import annotations

EVAL_OPS = 21


def count(shapes: dict) -> tuple:
    """(flops, bytes) of one stencil launch at the cell's shapes."""
    R = shapes["batch"] * shapes["n_agents"]
    Q = 9 * shapes["n_circles"]
    k = shapes["pd_chunks"]
    K, S, W = shapes["segment_table"]
    flops = R * Q * 2 * EVAL_OPS
    nbytes = R * Q * 2 * 4 + R * 4 + 2 * R * k * 4 + 2 * K * S * W * 4 + 2 * R * Q * 4
    return float(flops), float(nbytes)
