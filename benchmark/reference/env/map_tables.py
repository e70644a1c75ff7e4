"""Device-side map tables: every reference path padded and stacked so that
per-agent path (re)assignment is one index gather.

The tables are computed once on the host (float32, on the CPU), exactly as
the JAX package builds them, then moved to the requested device. Per-agent
lookups are plain index gathers (`table[path_id]`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from benchmark.reference.maps.data import MapData, RefPath

Tensor = torch.Tensor


@dataclass(frozen=True)
class MapTables:
    """Stacked, padded per-path map tensors.

    K = number of candidate paths; P = padded long-term length;
    PB = padded boundary length; S = segment
    rows (a multiple of PD_CHUNK); NC = S / PD_CHUNK chunks.
    """

    long_term: Tensor  # [K, P, 2] center line, extended and end-padded
    n_points_long_term: Tensor  # [K] int32 (raw center-line points)
    center_line_yaw: Tensor  # [K, P]
    left_boundary: Tensor  # [K, PB, 2] shared left boundary, end-padded
    right_boundary: Tensor  # [K, PB, 2]
    n_points_left_b: Tensor  # [K] int32
    n_points_right_b: Tensor  # [K] int32
    left_seg: Tensor  # [K, S, 8] pseudo-distance segment rows
    right_seg: Tensor  # [K, S, 8]
    left_chunk_cc: Tensor  # [K, NC, 2] chunk bounding-circle centers
    left_chunk_cr: Tensor  # [K, NC] radii
    right_chunk_cc: Tensor  # [K, NC, 2]
    right_chunk_cr: Tensor  # [K, NC]
    entry: Tensor  # [K, 2, 2] entry segment (first boundary points)
    exit: Tensor  # [K, 2, 2] exit segment (last boundary points)
    is_loop: Tensor  # [K] bool
    group_id: Tensor  # [K] int32 — each path's group
    group_mask: Tensor  # [G, K] bool — valid paths per group id
    # Lanelet IDs along each path, for `core/geometry.py::current_lanelet_id`.
    ref_lanelet_ids: Tensor  # [K, L] int32 (0-padded)
    n_ref_lanelet_ids: Tensor  # [K] int32
    ref_lanelet_segment_points: Tensor  # [K, L+1, 2] lanelet connection points
    lanelet_centers: Tensor  # [n_lanelets, Lc, 2]
    n_lanelet_center_points: Tensor  # [n_lanelets] int32
    neighboring_lanelets: Tensor  # [n_lanelets, n_lanelets] bool
    # Spawn-point geometry: every spawn candidate is (long_term[k, p],
    # center_line_yaw[k, p]), so its boundary geometry is precomputed here
    # with the same functions the step uses.
    spawn_d_ref: Tensor  # [K, P]
    spawn_idx_ref: Tensor  # [K, P] int32
    spawn_idx_left: Tensor  # [K, P] int32
    spawn_idx_right: Tensor  # [K, P] int32
    spawn_d_left: Tensor  # [K, P, 5]
    spawn_d_right: Tensor  # [K, P, 5]

    def to(self, device) -> "MapTables":
        return MapTables(
            **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )


def _pad_polyline(p: np.ndarray, length: int) -> np.ndarray:
    if p.shape[0] >= length:
        return p[:length]
    pad = np.repeat(p[-1:], length - p.shape[0], axis=0)
    return np.concatenate([p, pad], axis=0)


def _chunk_bounds(seg: np.ndarray, bnd: np.ndarray, chunk: int):
    """(cc [K, NC, 2], cr [K, NC]) bounding circles over each chunk's
    boundary points. Chunk c covers segments [c*CH, (c+1)*CH), whose extent
    is boundary points [c*CH, (c+1)*CH]. Only points incident to a valid
    segment enter the bound; empty chunks are pushed to 1e6."""
    Kn, Sp = seg.shape[0], seg.shape[1]
    NC = Sp // chunk
    if bnd.shape[1] < Sp + 1:
        tail = np.repeat(bnd[:, -1:], Sp + 1 - bnd.shape[1], axis=1)
        bnd = np.concatenate([bnd, tail], axis=1)
    valid = seg[..., 7] > 0.5
    cc = np.full((Kn, NC, 2), 1.0e6, np.float32)
    cr = np.zeros((Kn, NC), np.float32)
    for c in range(NC):
        lo, hi = c * chunk, (c + 1) * chunk
        m_seg = valid[:, lo:hi]
        m_pt = np.zeros((Kn, hi - lo + 1), bool)
        m_pt[:, :-1] |= m_seg
        m_pt[:, 1:] |= m_seg
        pts = bnd[:, lo:hi + 1]
        w = m_pt[..., None].astype(np.float64)
        cnt = w.sum(1)
        has = cnt[:, 0] > 0
        mid = (pts * w).sum(1) / np.maximum(cnt, 1.0)
        r = np.sqrt(((pts - mid[:, None]) ** 2).sum(-1))
        r = np.where(m_pt, r, 0.0).max(1)
        cc[has, c] = mid[has].astype(np.float32)
        cr[has, c] = r[has].astype(np.float32)
    return cc, cr


def build_map_tables(
    map_data: MapData,
    scenario_type: str,
    n_points_short_term: int,
    sample_interval: int,
    device: str | torch.device = "cpu",
) -> MapTables:
    """Build the stacked path tables for a scenario, on `device`.

    For "cpm_mixed" the candidate paths are the intersection + merge-in +
    merge-out families (group ids 1/2/3); otherwise all reference paths
    (group id 0).
    """
    from benchmark.reference.constants import AGENTS
    from benchmark.reference.core import geometry as G
    from benchmark.reference.safety.pseudo_distance import PD_CHUNK, segment_table

    if scenario_type == "cpm_mixed":
        fams = [
            (1, map_data.reference_paths_intersection),
            (2, map_data.reference_paths_merge_in),
            (3, map_data.reference_paths_merge_out),
        ]
    else:
        fams = [(0, map_data.reference_paths)]
    paths: List[RefPath] = []
    group_ids: List[int] = []
    for gid, fam in fams:
        paths.extend(fam)
        group_ids.extend([gid] * len(fam))

    n_ext = n_points_short_term * sample_interval
    max_center = max(p.center_line.shape[0] for p in paths)
    P = max_center + n_ext + 2
    PB = max(max(p.left_boundary_shared.shape[0], p.right_boundary_shared.shape[0]) for p in paths)

    K = len(paths)
    long_term = np.zeros((K, P, 2), np.float32)
    yaw = np.zeros((K, P), np.float32)
    n_long = np.zeros(K, np.int32)
    lb = np.zeros((K, PB, 2), np.float32)
    rb = np.zeros((K, PB, 2), np.float32)
    lb_pv = np.zeros((K, PB, 2), np.float32)
    rb_pv = np.zeros((K, PB, 2), np.float32)
    n_lb = np.zeros(K, np.int32)
    n_rb = np.zeros(K, np.int32)
    entry = np.zeros((K, 2, 2), np.float32)
    exit_ = np.zeros((K, 2, 2), np.float32)
    is_loop = np.zeros(K, bool)
    L = max(len(p.lanelet_ids) for p in paths)
    lane_ids = np.zeros((K, L), np.int32)
    n_lane_ids = np.zeros(K, np.int32)
    seg_pts = np.zeros((K, L + 1, 2), np.float32)

    for k, p in enumerate(paths):
        c = p.center_line
        n_long[k] = c.shape[0]
        # Extension: n_ext points continuing along the last segment, then
        # the final point repeated.
        direction = c[-1] - c[-2]
        ext = c[-1] + np.arange(1, n_ext + 1, dtype=np.float32)[:, None] * direction
        long_term[k] = _pad_polyline(np.concatenate([c, ext], axis=0), P)
        yaw[k] = _pad_polyline(p.center_line_yaw[:, None], P)[:, 0]
        lb[k] = _pad_polyline(p.left_boundary_shared, PB)
        rb[k] = _pad_polyline(p.right_boundary_shared, PB)
        lb_pv[k] = _pad_polyline(p.left_boundary_shared_pseudo_vector, PB)
        rb_pv[k] = _pad_polyline(p.right_boundary_shared_pseudo_vector, PB)
        n_lb[k] = p.left_boundary_shared.shape[0]
        n_rb[k] = p.right_boundary_shared.shape[0]
        entry[k, 0] = p.left_boundary_shared[0]
        entry[k, 1] = p.right_boundary_shared[0]
        exit_[k, 0] = p.left_boundary_shared[-1]
        exit_[k, 1] = p.right_boundary_shared[-1]
        is_loop[k] = p.is_loop
        ids = p.lanelet_ids
        lane_ids[k, : len(ids)] = ids
        n_lane_ids[k] = len(ids)
        sp = map_data.ref_lanelet_segment_points(ids)
        seg_pts[k, : sp.shape[0]] = sp
        seg_pts[k, sp.shape[0]:] = sp[-1]

    gid = np.asarray(group_ids, np.int32)
    n_groups = max(4, int(gid.max()) + 1) if gid.size else 1
    group_mask = np.stack([gid == g for g in range(n_groups)], axis=0)

    t = torch.from_numpy
    left_seg = segment_table(t(lb), t(lb_pv), t(n_lb)).numpy()
    right_seg = segment_table(t(rb), t(rb_pv), t(n_rb)).numpy()
    # Pad the segment axis to a PD_CHUNK multiple (all-zero rows: invalid).
    S_raw = left_seg.shape[1]
    S_pad = ((S_raw + PD_CHUNK - 1) // PD_CHUNK) * PD_CHUNK
    pad = ((0, 0), (0, S_pad - S_raw), (0, 0))
    left_seg = np.pad(left_seg, pad)
    right_seg = np.pad(right_seg, pad)
    l_cc, l_cr = _chunk_bounds(left_seg, lb, PD_CHUNK)
    r_cc, r_cr = _chunk_bounds(right_seg, rb, PD_CHUNK)

    n_lanelets = len(map_data.lanelets)
    Lc = max(ll.center_line.shape[0] for ll in map_data.lanelets)
    lanelet_centers = np.stack([_pad_polyline(ll.center_line, Lc) for ll in map_data.lanelets])
    n_lc = np.asarray([ll.center_line.shape[0] for ll in map_data.lanelets], np.int32)
    neigh = np.zeros((n_lanelets, n_lanelets), bool)
    for i, nb in enumerate(map_data.neighboring_lanelets_idx):
        for j in nb:
            neigh[i, j] = True

    # Spawn-point geometry, with the same functions as `update_geometry`.
    lt_t, yaw_t, lb_t, rb_t = t(long_term), t(yaw), t(lb), t(rb)
    half_w = AGENTS["width"] / 2
    sp_verts = G.rectangle_vertices(lt_t, yaw_t, AGENTS["width"], AGENTS["length"], True)
    sp_d_ref, sp_idx_ref = G.perpendicular_distances(lt_t, lt_t[:, None], t(n_long)[:, None])
    sp_dl0, sp_idx_left = G.perpendicular_distances(lt_t, lb_t[:, None], t(n_lb)[:, None])
    sp_dr0, sp_idx_right = G.perpendicular_distances(lt_t, rb_t[:, None], t(n_rb)[:, None])
    v4 = sp_verts[..., 0:4, :]
    sp_dlv = G.min_perpendicular_distance(v4, lb_t[:, None, None])
    sp_drv = G.min_perpendicular_distance(v4, rb_t[:, None, None])
    spawn_d_left = torch.cat([(sp_dl0 - half_w)[..., None], sp_dlv], -1)
    spawn_d_right = torch.cat([(sp_dr0 - half_w)[..., None], sp_drv], -1)

    tables = MapTables(
        long_term=lt_t,
        n_points_long_term=t(n_long),
        center_line_yaw=yaw_t,
        left_boundary=lb_t,
        right_boundary=rb_t,
        n_points_left_b=t(n_lb),
        n_points_right_b=t(n_rb),
        left_seg=t(left_seg),
        right_seg=t(right_seg),
        left_chunk_cc=t(l_cc),
        left_chunk_cr=t(l_cr),
        right_chunk_cc=t(r_cc),
        right_chunk_cr=t(r_cr),
        entry=t(entry),
        exit=t(exit_),
        is_loop=t(is_loop),
        group_id=t(gid),
        group_mask=t(group_mask),
        ref_lanelet_ids=t(lane_ids),
        n_ref_lanelet_ids=t(n_lane_ids),
        ref_lanelet_segment_points=t(seg_pts),
        lanelet_centers=t(lanelet_centers.astype(np.float32)),
        n_lanelet_center_points=t(n_lc),
        neighboring_lanelets=t(neigh),
        spawn_d_ref=sp_d_ref,
        spawn_idx_ref=sp_idx_ref,
        spawn_idx_left=sp_idx_left,
        spawn_idx_right=sp_idx_right,
        spawn_d_left=spawn_d_left,
        spawn_d_right=spawn_d_right,
    )
    return tables.to(device)
