"""Spatial agent grouping for the grouped CBF-QP mode, batched over envs.

Pair constraints couple both agents' controls only inside a group; a
cross-group pair gets two single-sided rows instead. The QP cost is
separable per agent, so the per-group QPs are exactly one QP whose pair
rows are masked by group membership, which is how the filter solves them.

Grouping: K = ceil(N / m) seeds by farthest-point sampling from agent 0,
then every other agent, in agent order, joins the nearest centroid that
still has room, and that centroid moves to the group's new mean. Ties go
to the lower index (first argmax / argmin), as in the JAX package.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

_BIG = 1e9


def _sq_dist(a: Tensor, b: Tensor) -> Tensor:
    d = a - b
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]


def group_agents_k_nearest(pos: Tensor, max_group_size: int) -> Tensor:
    """Assign agents to K = ceil(N / max_group_size) spatially coherent
    groups. pos [B, N, 2] -> group_id [B, N] int32 in [0, K)."""
    B, N = pos.shape[:2]
    K = int(math.ceil(N / max_group_size))
    dev = pos.device
    envs = torch.arange(B, device=dev)

    # Farthest-point seeds: seed 0 is agent 0; seed k is the agent farthest
    # from its nearest chosen seed (chosen seeds themselves excluded).
    seeds = torch.zeros((B, K), dtype=torch.long, device=dev)
    is_seed = torch.zeros((B, N), dtype=torch.bool, device=dev)
    is_seed[:, 0] = True
    for k in range(1, K):
        d2 = _sq_dist(pos[:, :, None, :], pos[envs[:, None], seeds][:, None, :, :])  # [B,N,K]
        d2 = torch.where(torch.arange(K, device=dev) < k, d2, _BIG)
        d_min = torch.where(is_seed, -1.0, d2.min(-1).values)
        s = torch.argmax(d_min, dim=-1)
        seeds[:, k] = s
        is_seed.scatter_(1, s[:, None], True)

    centroids = pos[envs[:, None], seeds].clone()  # [B, K, 2]
    counts = torch.ones((B, K), dtype=torch.int32, device=dev)
    group_id = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    group_id[envs[:, None], seeds] = torch.arange(K, dtype=torch.int32, device=dev)

    for i in range(N):
        free = group_id[:, i] < 0  # [B]
        p = pos[:, i]  # [B, 2]
        d2 = torch.where(counts < max_group_size, _sq_dist(p[:, None, :], centroids), _BIG)
        g = torch.argmin(d2, dim=-1)  # [B]
        new_count = counts[envs, g] + 1
        c_g = centroids[envs, g]
        new_centroid = c_g + (p - c_g) / new_count[:, None].to(pos.dtype)
        group_id[:, i] = torch.where(free, g.to(torch.int32), group_id[:, i])
        centroids[envs, g] = torch.where(free[:, None], new_centroid, c_g)
        counts[envs, g] = torch.where(free, new_count, counts[envs, g])
    return group_id


def same_group_mask(group_id: Tensor, pair_i: Tensor, pair_j: Tensor) -> Tensor:
    """[B, P] bool: whether both agents of each pair share a group."""
    return group_id[:, pair_i] == group_id[:, pair_j]
