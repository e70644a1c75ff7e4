"""Per-step world-state updates: distances, vertices, collisions, paths.

The agent axis is folded into tensor ops and every polyline lookup is an
index gather into the stacked `MapTables`.
"""

from __future__ import annotations

import numpy as np
import torch

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.core import geometry as G
from sigmarl_tpu_torch.env.map_tables import MapTables
from sigmarl_tpu_torch.env.structs import EnvConfig, WorldState, replace_state

Tensor = torch.Tensor


def _agent_distances(cfg: EnvConfig, pos: Tensor, verts: Tensor) -> Tensor:
    """Mutual agent distances [B, N, N] of the configured kind (centre to
    centre, or the rectangles' MTV distance), the diagonal set to the
    world's half diagonal."""
    if cfg.distance_type == "c2c":
        return G.c2c_distances(pos, set_diagonal_to=cfg.world_semidiag)
    return G.mtv_distances(verts, set_diagonal_to=cfg.world_semidiag)


def update_geometry(
    cfg: EnvConfig, tables: MapTables, state: WorldState, skip_collisions: bool = False
) -> WorldState:
    """Recompute vertices, boundary/reference distances, mutual distances
    and collision flags from the current kinematic state.

    `skip_collisions` keeps the existing collision flags."""
    pos, rot = state.pos, state.rot
    with trace.span(".agents"):
        verts = G.rectangle_vertices(pos, rot, cfg.agent_width, cfg.agent_length, True)
        d_agents = _agent_distances(cfg, pos, verts)

    pid = state.path_id.long()
    lb = tables.left_boundary[pid]  # [B, N, PB, 2]
    rb = tables.right_boundary[pid]
    with trace.span(".boundaries"):
        lt = tables.long_term[pid]  # [B, N, P, 2]
        d_ref, idx_ref = G.perpendicular_distances(pos, lt, tables.n_points_long_term[pid])

        half_w = cfg.agent_width / 2
        dl0, idx_left = G.perpendicular_distances(pos, lb, tables.n_points_left_b[pid])
        dr0, idx_right = G.perpendicular_distances(pos, rb, tables.n_points_right_b[pid])
        v4 = verts[..., 0:4, :]  # [B, N, 4, 2]
        if cfg.geom_topk_chunks > 0:
            # Corner sweep over the k chunks of 16 segments with the
            # smallest bounding-circle lower bound from the agent CG (reach:
            # the rectangle's half diagonal covers all four corners).
            from sigmarl_tpu_torch.safety.pseudo_distance import (
                PD_CHUNK,
                chunk_rows,
                topk_chunks,
            )

            k_sel = min(cfg.geom_topk_chunks, tables.left_seg.shape[1] // PD_CHUNK)
            reach = 0.5 * float(np.hypot(cfg.agent_length, cfg.agent_width))
            lsel = topk_chunks(tables.left_chunk_cc, tables.left_chunk_cr, pid, pos, reach, k_sel)
            rsel = topk_chunks(tables.right_chunk_cc, tables.right_chunk_cr, pid, pos, reach,
                               k_sel)
            dlv = G.min_distance_to_segment_rows(v4, chunk_rows(tables.left_seg, pid, lsel))
            drv = G.min_distance_to_segment_rows(v4, chunk_rows(tables.right_seg, pid, rsel))
        else:
            dlv = G.min_perpendicular_distance(v4, lb[..., None, :, :])
            drv = G.min_perpendicular_distance(v4, rb[..., None, :, :])
        d_left = torch.cat([(dl0 - half_w)[..., None], dlv], dim=-1)  # [B, N, 5]
        d_right = torch.cat([(dr0 - half_w)[..., None], drv], dim=-1)
        d_boundary = torch.minimum(d_left.min(-1).values, d_right.min(-1).values)

    if skip_collisions:
        coll_agents, coll_lanelets = state.coll_agents, state.coll_lanelets
        coll_entry, coll_exit = state.coll_entry, state.coll_exit
    else:
        with trace.span(".collisions"):
            if cfg.distance_type == "c2c":
                pair_hit = G.interx(verts[:, :, None], verts[:, None, :])  # [B, N, N]
                eye = torch.eye(cfg.n_agents, dtype=torch.bool, device=pos.device)
                coll_agents = pair_hit & ~eye
            else:
                coll_agents = d_agents <= 0.0
            coll_lanelets = G.rect_polyline_hit(
                pos, rot, cfg.agent_width, cfg.agent_length, lb
            ) | G.rect_polyline_hit(pos, rot, cfg.agent_width, cfg.agent_length, rb)
            if cfg.all_paths_loop:
                coll_entry = torch.zeros_like(state.coll_entry)
                coll_exit = torch.zeros_like(state.coll_exit)
            else:
                not_loop = ~tables.is_loop[pid]
                coll_entry = G.interx(verts, tables.entry[pid]) & not_loop
                coll_exit = G.interx(verts, tables.exit[pid]) & not_loop

    return replace_state(
        state,
        vertices=verts,
        d_agents=d_agents,
        d_ref=d_ref,
        idx_ref=idx_ref,
        idx_left=idx_left,
        idx_right=idx_right,
        d_left=d_left,
        d_right=d_right,
        d_boundary=d_boundary,
        coll_agents=coll_agents,
        coll_lanelets=coll_lanelets,
        coll_entry=coll_entry,
        coll_exit=coll_exit,
    )


def refresh_geometry_after_reset(
    cfg: EnvConfig, tables: MapTables, state: WorldState, reset_mask: Tensor
) -> WorldState:
    """Post-reset geometry refresh without boundary sweeps: every spawned
    pose is a (path, point) entry of the spawn tables, so reset agents'
    derived fields are a gather; other agents keep theirs; vertices and
    mutual distances are recomputed."""
    pos, rot = state.pos, state.rot
    m = reset_mask
    verts = G.rectangle_vertices(pos, rot, cfg.agent_width, cfg.agent_length, True)
    d_agents = _agent_distances(cfg, pos, verts)
    pid, pt = state.path_id.long(), state.point_id.long()

    def g(t):
        return t[pid, pt]

    m1 = m[..., None]
    d_left = torch.where(m1, g(tables.spawn_d_left), state.d_left)
    d_right = torch.where(m1, g(tables.spawn_d_right), state.d_right)
    return replace_state(
        state,
        vertices=verts,
        d_agents=d_agents,
        d_ref=torch.where(m, g(tables.spawn_d_ref), state.d_ref),
        idx_ref=torch.where(m, g(tables.spawn_idx_ref), state.idx_ref),
        idx_left=torch.where(m, g(tables.spawn_idx_left), state.idx_left),
        idx_right=torch.where(m, g(tables.spawn_idx_right), state.idx_right),
        d_left=d_left,
        d_right=d_right,
        d_boundary=torch.minimum(d_left.min(-1).values, d_right.min(-1).values),
    )


def update_short_term_paths(
    cfg: EnvConfig, tables: MapTables, state: WorldState, at_reset: bool = False
) -> WorldState:
    """Refresh the short-term reference window (and the nearing boundary
    points when boundary points are observed instead of distances; at
    reset those windows shift +1 instead of -2)."""
    pid = state.path_id.long()
    n_lt = tables.n_points_long_term[pid]
    is_loop = tables.is_loop[pid]

    def window(table: Tensor, idx: Tensor, n_points: int, interval: int, shift: int):
        P = table.shape[1]
        offsets = torch.arange(n_points, dtype=torch.int32, device=idx.device) * interval
        future = offsets + idx[..., None].to(torch.int32) + shift
        n = n_lt[..., None].to(torch.int32)
        wrapped = torch.where(
            future >= n - 1, torch.remainder(future + 1, torch.clamp(n, min=1)), future
        )
        future = torch.where(is_loop[..., None], wrapped, future)
        future = torch.clamp(future, 0, P - 1)
        return table[pid[..., None], future.long()]  # [B, N, n_points, 2]

    out = {
        "short_term": window(
            tables.long_term, state.idx_ref, cfg.n_points_short_term,
            cfg.sample_interval_ref_path, 1,
        )
    }
    if not cfg.is_observe_distance_to_boundaries:
        shift = 1 if at_reset else -2
        out["nearing_left"] = window(
            tables.left_boundary, state.idx_left, cfg.n_points_nearing_boundary, 1, shift
        )
        out["nearing_right"] = window(
            tables.right_boundary, state.idx_right, cfg.n_points_nearing_boundary, 1, shift
        )
    return replace_state(state, **out)


def push_state_buffer(state: WorldState) -> WorldState:
    """Write the current [pos, rot, vel, scenario, path, point] record into
    (a copy of) the circular state buffer and advance the pointer."""
    rec = torch.cat(
        [
            state.pos,
            state.rot[..., None],
            state.vel,
            state.scenario_id[..., None].to(torch.float32),
            state.path_id[..., None].to(torch.float32),
            state.point_id[..., None].to(torch.float32),
        ],
        dim=-1,
    )
    n_stored = state.state_buffer.shape[0]
    slot = (state.sb_pointer.long() % n_stored).reshape(1)
    buf = state.state_buffer.index_copy(0, slot, rec[None])
    return replace_state(state, state_buffer=buf, sb_pointer=(state.sb_pointer + 1) % n_stored)


def latest_state_record(state: WorldState) -> Tensor:
    """The most recent record in the circular buffer. [B, N, 8]."""
    n_stored = state.state_buffer.shape[0]
    slot = ((state.sb_pointer.long() - 1) % n_stored).reshape(1)
    return state.state_buffer.index_select(0, slot)[0]
