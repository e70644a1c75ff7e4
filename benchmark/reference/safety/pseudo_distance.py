"""Pseudo-distance field to lane boundaries (batched tensors).

A smooth point-to-polyline distance: each segment's projection is
interpolated between the pseudo tangent vectors at its two end points, so
the field is continuous across segment joints; the distance is the min
over segments whose projection is valid. All math in float32.

The per-segment frame and tangent slopes depend only on the map and are
precomputed once (`segment_table`); the hot-path query sweep against those
rows runs in the CUDA kernel of `ops/boundary.py`.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_BIG = 1000.0

# Segment-chunk granularity for top-k chunk pruning: segment tables are
# padded to a PD_CHUNK multiple and per-chunk bounding circles precomputed
# (`env/map_tables.build_map_tables`).
PD_CHUNK = 16

# Projection-validity tolerance: the valid regions lambda in [0, 1) of
# neighbouring segments meet exactly at their joint, so strict bounds are
# knife-edged under float reassociation; widening them by _LAM_EPS turns
# the gap into a small overlap (min over two nearly equal candidates).
_LAM_EPS = 1e-3


def segment_table(boundary: Tensor, tangents: Tensor, n_valid: Tensor | None = None) -> Tensor:
    """Per-segment rows (pbx, pby, cos_t, sin_t, len, m_b, m_t, valid):
    boundary, tangents [..., P, 2]; n_valid [...]. Returns [..., P-1, 8]."""
    p_b = boundary[..., :-1, :]
    p_t = boundary[..., 1:, :]
    t_b = tangents[..., :-1, :]
    t_t = tangents[..., 1:, :]
    seg = p_t - p_b
    seg_len = torch.sqrt((seg * seg).sum(-1))
    theta = torch.atan2(seg[..., 1], seg[..., 0])
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)

    def to_local(vx, vy):
        return cos_t * vx + sin_t * vy, -sin_t * vx + cos_t * vy

    tbx, tby = to_local(t_b[..., 0], t_b[..., 1])
    ttx, tty = to_local(t_t[..., 0], t_t[..., 1])
    one = torch.ones_like(tbx)
    m_b = torch.where(tbx != 0, tby / torch.where(tbx != 0, tbx, one), 1e-8)
    m_t = torch.where(ttx != 0, tty / torch.where(ttx != 0, ttx, one), 1e-8)

    valid = seg_len > 1e-9
    if n_valid is not None:
        seg_idx = torch.arange(seg.shape[-2], device=seg.device)
        valid = valid & (seg_idx < (n_valid[..., None] - 1))
    return torch.stack(
        [p_b[..., 0], p_b[..., 1], cos_t, sin_t, seg_len, m_b, m_t, valid.to(boundary.dtype)],
        dim=-1,
    )


def _seg_terms(points: Tensor, seg: Tensor) -> tuple[Tensor, Tensor]:
    """Squared distance of every query to every segment row and whether
    that segment counts for it (valid, lambda in its window): both
    [..., Q, S], for points [..., Q, 2] and seg [..., S, 8]."""
    pbx = seg[..., None, :, 0]
    pby = seg[..., None, :, 1]
    cos_t = seg[..., None, :, 2]
    sin_t = seg[..., None, :, 3]
    ln = seg[..., None, :, 4]
    m_b = seg[..., None, :, 5]
    m_t = seg[..., None, :, 6]
    valid = seg[..., None, :, 7] > 0.5
    rx = points[..., :, None, 0] - pbx
    ry = points[..., :, None, 1] - pby
    x = cos_t * rx + sin_t * ry
    y = -sin_t * rx + cos_t * ry
    denom = ln - y * (m_t - m_b)
    lam = (x + y * m_b) / denom
    nx = x - lam * ln
    d2 = nx * nx + y * y
    ok = valid & (lam >= -_LAM_EPS) & (lam < 1 + _LAM_EPS)
    return d2, ok


def pseudo_distance_seg(points: Tensor, seg: Tensor) -> Tensor:
    """Pseudo distance against segment-table rows.
    points [..., Q, 2]; seg [..., S, 8]. Returns [..., Q]."""
    d2, ok = _seg_terms(points, seg)
    # Min over squared distances, one sqrt per query; sqrt(_BIG**2) is _BIG.
    return torch.sqrt(torch.where(ok, d2, _BIG * _BIG).min(dim=-1).values)


def pseudo_distance_to_polyline(
    points: Tensor,  # [..., Q, 2] query points
    boundary: Tensor,  # [..., P, 2] polyline vertices (padded by repetition)
    tangents: Tensor,  # [..., P, 2] pseudo tangent vectors at the vertices
    n_valid: Tensor | None = None,  # [...] number of valid vertices
) -> Tensor:
    """Pseudo distance of each query point to the polyline [..., Q]: per
    segment, the query and both end tangents in the segment's frame, the
    projection factor lambda = (x + y m_b) / (l - y (m_t - m_b)) from the
    tangents' slopes, and the norm of (x - lambda l, y), valid for lambda in
    [-_LAM_EPS, 1 + _LAM_EPS); the min over valid segments (segments past
    `n_valid` and degenerate ones, of length <= 1e-9, never count; _BIG
    where none does)."""
    return pseudo_distance_seg(points, segment_table(boundary, tangents, n_valid))


def counting_segments(points: Tensor, seg: Tensor) -> Tensor:
    """[..., S] bool: the segment rows that count for at least one of the
    queries [..., Q, 2] (the rest leave every query's minimum as it is)."""
    return _seg_terms(points, seg)[1].any(dim=-2)


def topk_chunks(
    chunk_cc: Tensor,  # [K, NC, 2] chunk bound centers (MapTables)
    chunk_cr: Tensor,  # [K, NC] chunk bound radii
    path_id: Tensor,  # [...] int32
    p_ref: Tensor,  # [..., 2] per-row reference point
    reach: float,  # max |query - p_ref| over the row's queries
    k: int,
) -> Tensor:
    """Indices [..., k] int32 of the k chunks with the smallest lower bound
    |p_ref - cc| - cr - reach on the distance of any query within `reach`
    of `p_ref` to any segment of the chunk. A min over those chunks' rows
    is exact whenever the true minimum is below every unselected bound."""
    pid = path_id.long()
    ccp = chunk_cc[pid]  # [..., NC, 2]
    crp = chunk_cr[pid]
    diff = p_ref[..., None, :] - ccp
    lbound = torch.sqrt((diff * diff).sum(-1)) - crp - reach
    return torch.topk(-lbound, k, dim=-1).indices.to(torch.int32)


def chunk_rows(seg_table: Tensor, path_id: Tensor, chunks: Tensor) -> Tensor:
    """Gather the segment rows of the selected chunks: seg_table [K, S, 8];
    path_id [...]; chunks [..., k]. Returns [..., k*PD_CHUNK, 8]."""
    K, S = seg_table.shape[0], seg_table.shape[1]
    NC = S // PD_CHUNK
    flat = path_id.long()[..., None] * NC + chunks.long()
    rows = seg_table.reshape(K * NC, PD_CHUNK, 8)[flat]
    return rows.reshape(*flat.shape[:-1], chunks.shape[-1] * PD_CHUNK, 8)


def window_chunks(
    path_id: Tensor,  # [...] int32
    center_idx: Tensor,  # [...] int32 closest boundary vertex index
    window: int,
    n_seg: Tensor,  # [K] int32 valid segment count per path
    is_loop: Tensor,  # [K] bool
    n_rows: int,  # S, the segment axis of the table
) -> Tensor:
    """Indices [..., 2 * ((window - 1) // PD_CHUNK + 2)] int32 of chunks
    that together hold every segment of each row's `window` around its
    closest boundary vertex, as the JAX package's `window_segment_rows`
    picks it: `window` consecutive indices from center - window // 2,
    wrapping modulo the segment count on loop paths, clamped into [0,
    n_seg) (and below S) on open ones. The window is one run of indices,
    or two where it wraps; a run of at most `window` indices starting in
    chunk c lies in chunks c .. c + (window - 1) // PD_CHUNK + 1, each
    listed capped at the run's last chunk (repeats leave a minimum as it
    is). The chunks hold more segments than the window, which can only
    lower the minimum."""
    pid = path_id.long()
    c = center_idx.long()
    ns = n_seg[pid].long()
    loop = is_loop[pid]
    half = window // 2
    # Open paths: one run from the clamped start.
    start = torch.minimum(torch.clamp(c - half, min=0), torch.clamp(ns - window, min=0))
    open_end = torch.clamp(start + window - 1, max=n_rows - 1)
    # Loop paths: from (c - half) mod ns; a window as long as the path
    # covers all of it.
    nsp = torch.clamp(ns, min=1)
    a0 = torch.remainder(c - half, nsp)
    whole = ns <= window
    wraps = a0 + window - 1 >= nsp
    loop_a0 = torch.where(whole, torch.zeros_like(a0), a0)
    loop_a1 = torch.where(whole | wraps, nsp - 1, a0 + window - 1)
    loop_b0 = torch.where(wraps & ~whole, torch.zeros_like(a0), loop_a0)
    loop_b1 = torch.where(wraps & ~whole, torch.remainder(a0 + window - 1, nsp), loop_a1)
    runs = [
        (torch.where(loop, loop_a0, start), torch.where(loop, loop_a1, open_end)),
        (torch.where(loop, loop_b0, start), torch.where(loop, loop_b1, open_end)),
    ]
    per_run = (window - 1) // PD_CHUNK + 2
    out = []
    for x, y in runs:
        first, last = torch.div(x, PD_CHUNK, rounding_mode="floor"), torch.div(
            y, PD_CHUNK, rounding_mode="floor")
        out += [torch.minimum(first + j, last) for j in range(per_run)]
    return torch.stack(out, dim=-1).to(torch.int32)
