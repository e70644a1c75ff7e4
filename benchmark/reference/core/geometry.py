"""Batched geometry on tensors, vectorized over arbitrary leading axes.

The port's counterparts of the JAX package's `core/geometry.py` functions
that `update_geometry`, the reset and the rewards use. Padded polylines
repeat their end point; every function is padding-safe (zero-length
segments contribute nothing).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.device import constant

Tensor = torch.Tensor


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt((v * v).sum(-1))


def angle_eliminate_two_pi(angle: Tensor) -> Tensor:
    """Wrap angles to (-pi, pi]. Floor modulo, as `%` is on JAX arrays."""
    two_pi = 2 * math.pi
    angle = torch.remainder(angle, two_pi)
    return torch.where(angle > math.pi, angle - two_pi, angle)


def decreasing_fcn(x: Tensor, x0: float, x1: float, kind: str = "linear") -> Tensor:
    """Decreasing ramp on [x0, x1] with y(x0)=1, y(x1)=0."""
    x = torch.clamp(x, x0, x1)
    denom = x1 - x0
    if kind == "linear":
        return 1.0 - (x - x0) / denom
    if kind == "exponential":
        e_inv = 1.0 / math.e
        return (torch.exp(-(x - x0) / denom) - e_inv) / (1.0 - e_inv)
    raise ValueError(f"unsupported kind {kind!r}")


def rectangle_vertices(
    center: Tensor, yaw: Tensor, width: float, length: float, close_shape: bool = True
) -> Tensor:
    """Rectangle vertices for batched poses. center [..., 2], yaw [...];
    returns [..., 4 or 5, 2] (first vertex repeated when `close_shape`)."""
    lh, wh = length / 2, width / 2
    base = ((lh, wh), (lh, -wh), (-lh, -wh), (-lh, wh))
    if close_shape:
        base = base + base[:1]
    base = constant(base, center.dtype, center.device)
    cos_y, sin_y = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    vx = base[:, 0] * cos_y - base[:, 1] * sin_y
    vy = base[:, 0] * sin_y + base[:, 1] * cos_y
    return torch.stack([vx, vy], dim=-1) + center[..., None, :]


def perpendicular_distances(
    point: Tensor, polyline: Tensor, n_valid: Tensor | None = None
) -> tuple[Tensor, Tensor]:
    """Minimum perpendicular distance from point(s) to a padded polyline.

    point [..., 2]; polyline [..., P, 2]; n_valid [...] valid point count.
    Returns (distance [...], index [...] int32): the closest polyline point
    pushed one forward; segments at index >= n_valid-1 take the distance
    of segment n_valid-2.
    """
    starts = polyline[..., :-1, :]
    vecs = polyline[..., 1:, :] - starts
    rel = point[..., None, :] - starts
    len2 = (vecs * vecs).sum(-1)
    t = (rel * vecs).sum(-1) / torch.clamp(len2, min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    closest = starts + vecs * t[..., None]
    d = _norm(closest - point[..., None, :])
    if n_valid is not None:
        n_seg = d.shape[-1]
        end_idx = torch.clamp(n_valid.long() - 2, min=0)
        d_end = torch.gather(
            d, -1, end_idx.expand(d.shape[:-1])[..., None]
        )
        seg_idx = torch.arange(n_seg, device=d.device)
        d = torch.where(seg_idx >= (n_valid[..., None] - 1), d_end, d)
    idx = (torch.argmin(d, dim=-1) + 1).to(torch.int32)
    return d.min(dim=-1).values, idx


def min_perpendicular_distance(point: Tensor, polyline: Tensor) -> Tensor:
    """Minimum distance only (no closest index, no padding correction);
    equals `perpendicular_distances(...)[0]` on end-padded polylines."""
    starts = polyline[..., :-1, :]
    vecs = polyline[..., 1:, :] - starts
    rel = point[..., None, :] - starts
    len2 = (vecs * vecs).sum(-1)
    t = (rel * vecs).sum(-1) / torch.clamp(len2, min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    diff = starts + vecs * t[..., None] - point[..., None, :]
    d2 = (diff * diff).sum(-1)
    return torch.sqrt(d2.min(dim=-1).values)


def min_distance_to_segment_rows(points: Tensor, rows: Tensor) -> Tensor:
    """Minimum clamped point-to-segment distance against pseudo-distance
    segment-table rows ([..., S, 8] = (pbx, pby, cos_t, sin_t, len, m_b,
    m_t, valid)); invalid rows are masked out. points [..., Q, 2];
    returns [..., Q]."""
    sx = rows[..., None, :, 0]
    sy = rows[..., None, :, 1]
    ln = rows[..., None, :, 4]
    vx = ln * rows[..., None, :, 2]
    vy = ln * rows[..., None, :, 3]
    valid = rows[..., None, :, 7] > 0.5
    relx = points[..., :, None, 0] - sx
    rely = points[..., :, None, 1] - sy
    t = torch.clamp((relx * vx + rely * vy) / torch.clamp(ln * ln, min=1e-12), 0.0, 1.0)
    dx = relx - t * vx
    dy = rely - t * vy
    d2 = dx * dx + dy * dy
    return torch.sqrt(torch.where(valid, d2, 1.0e6).min(dim=-1).values)


def short_term_reference_path(
    polyline: Tensor,
    index_closest_point: Tensor,
    n_points_to_return: int,
    is_loop: Tensor,
    n_points_long_term: Tensor,
    sample_interval: int = 2,
    n_points_shift: int = 1,
) -> tuple[Tensor, Tensor]:
    """Sample a short-term window from a (possibly looped) padded polyline.
    Returns ([..., n_points_to_return, 2], indices int32)."""
    dev = polyline.device
    offsets = torch.arange(n_points_to_return, dtype=torch.int32, device=dev) * sample_interval
    future = offsets + index_closest_point[..., None].to(torch.int32) + n_points_shift
    n = n_points_long_term[..., None].to(torch.int32)
    wrapped = torch.where(
        future >= n - 1, torch.remainder(future + 1, torch.clamp(n, min=1)), future
    )
    future = torch.where(is_loop[..., None], wrapped, future)
    future = torch.clamp(future, 0, polyline.shape[-2] - 1)
    idx = future.long()[..., None].expand(*future.shape, 2)
    return torch.gather(polyline, -2, idx), future


def c2c_distances(pos: Tensor, set_diagonal_to: float | None = None) -> Tensor:
    """Pairwise center-to-center distances. pos [..., N, 2] -> [..., N, N]."""
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    if set_diagonal_to is not None:
        n = pos.shape[-2]
        eye = torch.eye(n, dtype=torch.bool, device=pos.device)
        d = torch.where(eye, torch.full_like(d, set_diagonal_to), d)
    return d


def mtv_distances(vertices: Tensor, set_diagonal_to: float | None = None) -> Tensor:
    """Pairwise SAT/MTV rectangle distances, vectorized over the pairs.

    vertices [..., N, >=4, 2] (the first 4 are used). Returns [..., N, N]:
    positive is the separation (Euclidean over the per-axis gaps of one
    rectangle's vertices on the other's two normal axes, least over the 8
    vertices of the pair), negative the penetration depth (the smaller
    projection overlap) wherever a vertex of either lies inside the other.
    """
    v = vertices[..., :4, :]  # [..., N, 4, 2]
    axes = torch.diff(vertices[..., 0:3, :], dim=-2)  # [..., N, 2, 2]
    axes = axes / torch.clamp(_norm(axes), min=1e-12)[..., None]

    # proj[..., i, j, p, a]: vertex p of rect i projected on axis a of rect j.
    proj = (v[..., :, None, :, None, :] * axes[..., None, :, None, :, :]).sum(-1)
    # Rect j's projection extents on its own axes.
    proj_self = (v[..., :, :, None, :] * axes[..., :, None, :, :]).sum(-1)  # [..., N, 4, 2]
    max_j = proj_self.max(dim=-2).values[..., None, :, :]  # [..., 1, N, 2]
    min_j = proj_self.min(dim=-2).values[..., None, :, :]
    min_jb, max_jb = min_j[..., None, :], max_j[..., None, :]  # [..., 1, N, 1, 2]

    below, above = proj <= min_jb, proj >= max_jb
    gap = (proj - min_jb) * below.to(proj.dtype) + (max_jb - proj) * above.to(proj.dtype)
    pos_dist = _norm(gap)  # [..., N, N, 4]

    # Projection extents of rect i on rect j's axes, and their overlap.
    overlap = (torch.minimum(max_j, proj.max(dim=-2).values)
               - torch.maximum(min_j, proj.min(dim=-2).values))  # [..., N, N, 2]
    inside = ((proj > min_jb) & (proj < max_jb)).all(-1)  # [..., N, N, 4]
    neg_mag = -overlap.min(dim=-1).values[..., None] * inside.to(proj.dtype)

    # Pair (i, j): the vertices of i against rect j and those of j against
    # rect i.
    dist = torch.cat([pos_dist, pos_dist.transpose(-3, -2)], dim=-1).min(dim=-1).values
    any_inside = (neg_mag.abs() > 0).any(-1)
    any_inside = any_inside | any_inside.transpose(-2, -1)
    overlap_min = overlap.min(dim=-1).values
    pen = -torch.minimum(overlap_min, overlap_min.transpose(-2, -1))
    dist = torch.where(any_inside, pen, dist)
    if set_diagonal_to is not None:
        eye = torch.eye(v.shape[-3], dtype=torch.bool, device=v.device)
        dist = torch.where(eye, torch.full_like(dist, set_diagonal_to), dist)
    return dist


def nearest_indices(d: Tensor, k: int) -> Tensor:
    """Indices of the k smallest entries of `d` along its last axis, nearest
    first, the lower index first among equal distances (the order of JAX's
    `lax.top_k(-d, k)`; `torch.topk` promises none on ties)."""
    return torch.argsort(d, dim=-1, stable=True)[..., :k]


def interx(L1: Tensor, L2: Tensor) -> Tensor:
    """Whether two (batched) polylines intersect (signed-distance test).
    L1 [..., P1, 2]; L2 [..., P2, 2]; returns [...] bool."""
    x1, y1 = L1[..., 0], L1[..., 1]
    x2, y2 = L2[..., 0], L2[..., 1]
    dx1, dy1 = torch.diff(x1, dim=-1), torch.diff(y1, dim=-1)
    dx2, dy2 = torch.diff(x2, dim=-1), torch.diff(y2, dim=-1)
    S1 = dx1 * y1[..., :-1] - dy1 * x1[..., :-1]
    S2 = dx2 * y2[..., :-1] - dy2 * x2[..., :-1]
    d1 = dx1[..., :, None] * y2[..., None, :] - dy1[..., :, None] * x2[..., None, :]
    C1 = (d1[..., :, :-1] - S1[..., :, None]) * (d1[..., :, 1:] - S1[..., :, None]) < 0
    d2 = y1[..., :, None] * dx2[..., None, :] - x1[..., :, None] * dy2[..., None, :]
    C2 = (d2[..., :-1, :] - S2[..., None, :]) * (d2[..., 1:, :] - S2[..., None, :]) < 0
    return (C1 & C2).flatten(-2).any(dim=-1)


def rect_polyline_hit(
    pos: Tensor, rot: Tensor, width: float, length: float, polyline: Tensor
) -> Tensor:
    """Whether a polyline crosses a solid oriented rectangle: exact
    segment-vs-box slab test in the rectangle's frame. The polyline must
    extend beyond the rectangle (lane boundaries vs the agent box).
    pos [..., 2]; rot [...]; polyline [..., P, 2]. Returns [...] bool."""
    c, s = torch.cos(rot)[..., None], torch.sin(rot)[..., None]
    rel = polyline - pos[..., None, :]
    x = c * rel[..., 0] + s * rel[..., 1]
    y = -s * rel[..., 0] + c * rel[..., 1]
    hl, hw = length / 2, width / 2
    x0, y0 = x[..., :-1], y[..., :-1]
    dx = x[..., 1:] - x0
    dy = y[..., 1:] - y0
    big = 1e30
    eps = 1e-12

    def slab(p0, d, h):
        degen = torch.abs(d) <= eps
        safe = torch.where(degen, torch.ones_like(d), d)
        t1 = (-h - p0) / safe
        t2 = (h - p0) / safe
        tmin = torch.minimum(t1, t2)
        tmax = torch.maximum(t1, t2)
        inside0 = (p0 > -h) & (p0 < h)
        big_t = torch.full_like(d, big)
        tmin = torch.where(degen, torch.where(inside0, -big_t, big_t), tmin)
        tmax = torch.where(degen, torch.where(inside0, big_t, -big_t), tmax)
        return tmin, tmax, degen

    tminx, tmaxx, degx = slab(x0, dx, hl)
    tminy, tmaxy, degy = slab(y0, dy, hw)
    t_lo = torch.clamp(torch.maximum(tminx, tminy), min=0.0)
    t_hi = torch.clamp(torch.minimum(tmaxx, tmaxy), max=1.0)
    hit = (t_lo < t_hi) & ~(degx & degy)
    return hit.any(dim=-1)


def global_to_local(pos_i: Tensor, pos_j: Tensor, rot_i: Tensor) -> Tensor:
    """Transform points into an agent's ego frame (polar form).
    pos_i [..., 2]; rot_i [...]; pos_j [..., M, 2]. Returns [..., M, 2]."""
    vec = pos_j - pos_i[..., None, :]
    r = _norm(vec)
    theta = torch.atan2(vec[..., 1], vec[..., 0]) - rot_i[..., None]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def current_lanelet_id(
    point: Tensor, segment_points: Tensor, n_lanelets: Tensor, lanelet_ids: Tensor
) -> Tensor:
    """The ID of the lanelet closest to each point along its reference path:
    point [..., 2]; segment_points [..., L+1, 2] the lanelets' connection
    points; n_lanelets [...]; lanelet_ids [..., L]. The segment between
    connection points l and l+1 stands for lanelet l; the first of equally
    close ones wins. Returns [...]."""
    starts = segment_points[..., :-1, :]
    vecs = segment_points[..., 1:, :] - starts
    rel = point[..., None, :] - starts
    t = (rel * vecs).sum(-1) / torch.clamp((vecs * vecs).sum(-1), min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    d = _norm(starts + vecs * t[..., None] - point[..., None, :])
    seg_idx = torch.arange(d.shape[-1], device=d.device)
    d = torch.where(seg_idx < n_lanelets[..., None], d, torch.full_like(d, math.inf))
    nearest = torch.argmin(d, dim=-1)
    return torch.gather(lanelet_ids, -1, nearest[..., None])[..., 0]
