"""Goal-reaching world state (single-agent point-to-goal task).

One agent per env whose reference path is the straight segment from its
spawn position to a goal point. Tracked per step: rectangle vertices, the
perpendicular distance to the spawn->goal segment and the c2c
mutual-distance matrix (zero for N = 1, kept for symmetry with the
road-traffic state). Functions of `[B, N, ...]` tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sigmarl_tpu_torch.constants import AGENTS
from sigmarl_tpu_torch.core import geometry as G

Tensor = torch.Tensor


class GoalReachingState(NamedTuple):
    """Dynamic state, [B, N, ...]."""

    pos: Tensor  # [B, N, 2]
    rot: Tensor  # [B, N]
    original_pos: Tensor  # [B, N, 2] spawn position (segment start)
    goal: Tensor  # [B, N, 2] goal point (segment end)
    vertices: Tensor  # [B, N, 5, 2] closed rectangle vertices
    d_ref: Tensor  # [B, N] perpendicular distance to the spawn->goal segment
    d_agents: Tensor  # [B, N, N] mutual c2c distances


def init_goal_reaching(pos: Tensor, rot: Tensor, goal: Tensor) -> GoalReachingState:
    """State at the spawn poses, with the goals."""
    state = GoalReachingState(
        pos=pos,
        rot=rot,
        original_pos=pos,
        goal=goal,
        vertices=pos.new_zeros(pos.shape[:-1] + (5, 2)),
        d_ref=pos.new_zeros(pos.shape[:-1]),
        d_agents=pos.new_zeros(pos.shape[:-1] + (pos.shape[-2],)),
    )
    return update_goal_reaching(state, pos, rot)


def update_goal_reaching(state: GoalReachingState, pos: Tensor, rot: Tensor) -> GoalReachingState:
    """Vertices, distance to the spawn->goal segment and mutual distances
    at the new poses."""
    verts = G.rectangle_vertices(pos, rot, AGENTS["width"], AGENTS["length"], True)
    seg = torch.stack([state.original_pos, state.goal], dim=-2)  # [B, N, 2, 2]
    d_ref, _ = G.perpendicular_distances(pos, seg)
    d_agents = G.c2c_distances(pos, set_diagonal_to=0.0)
    return state._replace(pos=pos, rot=rot, vertices=verts, d_ref=d_ref, d_agents=d_agents)


def goal_reached(state: GoalReachingState, threshold: float) -> Tensor:
    """Whether each agent is within `threshold` of its goal, [B, N] bool."""
    return torch.linalg.norm(state.pos - state.goal, dim=-1) < threshold
