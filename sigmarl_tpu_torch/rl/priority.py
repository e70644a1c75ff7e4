"""XP-MARL: priority assignment and prioritized action propagation.

A second actor-critic (`score_policy` / `score_critic`) scores the agents,
or a random permutation ranks them. The agents then act one after another
in descending priority: each acting agent's observation carries, in its
zero-padded tail, the actions its k nearest neighbours have already
decided (zeros for those still to act), optionally with Gaussian
communication noise. Each turn runs the policy on the acting agent's row
only.

Every random number can be given as tensors (the priority sample's normals
or the permutations, the per-turn action and communication noise), else it
comes from a `torch.Generator`. Each turn adds one to the count `turns`
(`trace.count`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.constants import AGENTS
# Each agent's k nearest agents [B, N, k], nearest first, the lower index
# first among equal distances.
from sigmarl_tpu_torch.core.geometry import nearest_indices as nearing_agent_indices  # noqa: F401
from sigmarl_tpu_torch.rl.networks import tanh_normal_sample

Tensor = torch.Tensor


class PriorityOutput(NamedTuple):
    rank: Tensor  # [B, N] agent indices in descending priority
    scores: Tensor  # [B, N]
    log_prob: Tensor  # [B, N]


@torch.no_grad()
def priority_rank(
    method: str,
    net: nn.Module | None,
    obs: Tensor,  # [B, N, obs] priority observation (unpadded)
    generator: torch.Generator | None = None,
    noise: Tensor | None = None,  # [B, N, 1] normals of the score sample ("marl")
    perms: Tensor | None = None,  # [B, N] one permutation per env ("random")
) -> PriorityOutput:
    """The per-env priority rank. "random": a random permutation per env,
    scores and log-probabilities zero. "marl": a TanhNormal score in
    (-1, 1) per agent from `net`, ranked by a stable descending sort (equal
    scores keep the lower index first)."""
    B, N = obs.shape[:2]
    dev = obs.device
    if method == "random":
        if perms is None:
            perms = torch.argsort(torch.rand((B, N), generator=generator, device=dev), dim=-1)
        zeros = torch.zeros((B, N), device=dev)
        return PriorityOutput(perms.to(torch.int32), zeros, zeros)
    loc, scale = net(obs)
    one = torch.ones((1,), device=dev)
    scores, log_prob = tanh_normal_sample(loc, scale, -one, one, generator=generator, noise=noise)
    rank = torch.argsort(-scores[..., 0], dim=-1, stable=True).to(torch.int32)
    return PriorityOutput(rank, scores[..., 0], log_prob)


class APResult(NamedTuple):
    actions: Tensor  # [B, N, 2]
    log_prob: Tensor  # [B, N]
    obs_used: Tensor  # [B, N, obs_pad] observation each agent acted on


@torch.no_grad()
def prioritized_action_propagation(
    policy: nn.Module,
    base_obs: Tensor,  # [B, N, obs_dim + k*2] zero-padded tail
    rank: Tensor,  # [B, N]
    nearing_idx: Tensor,  # [B, N, k]
    low: Tensor,
    high: Tensor,
    generator: torch.Generator | None = None,
    action_noise: Tensor | None = None,  # [N, B, 2] normals, one block per turn
    communication_noise_level: float = 0.0,
    communication_noise: Tensor | None = None,  # [N, B, 2k] normals per turn
) -> APResult:
    """Sequential decisions over the N priority turns. In turn t the agent
    `rank[:, t]` of every env fills its observation's tail with its
    neighbours' decided actions (plus communication noise of std
    [max_speed, max_steering] * level per neighbour when the level is
    positive), runs the policy on that row and samples its action."""
    B, N = base_obs.shape[:2]
    k = nearing_idx.shape[-1]
    dev = base_obs.device
    env_idx = torch.arange(B, device=dev)
    actions = torch.zeros((B, N, 2), device=dev)
    log_prob = torch.zeros((B, N), device=dev)
    obs_used = base_obs.clone()
    std = torch.tensor([AGENTS["max_speed"], AGENTS["max_steering"]] * k, device=dev)
    std = std * communication_noise_level
    for t in range(N):
        trace.count("turns")
        acting = rank[:, t].long()  # [B]
        obs_a = base_obs[env_idx, acting]  # [B, obs_pad] (a copy)
        if k > 0:
            neighbors = nearing_idx[env_idx, acting].long()  # [B, k]
            tail = actions[env_idx[:, None], neighbors].reshape(B, 2 * k)
            if communication_noise_level > 0:
                z = (torch.randn((B, 2 * k), generator=generator, device=dev)
                     if communication_noise is None else communication_noise[t])
                tail = tail + std * z
            obs_a[:, -2 * k:] = tail
        loc, scale = policy(obs_a)
        a, lp = tanh_normal_sample(
            loc, scale, low, high, generator=generator,
            noise=None if action_noise is None else action_noise[t],
        )
        actions[env_idx, acting] = a
        log_prob[env_idx, acting] = lp
        obs_used[env_idx, acting] = obs_a
    return APResult(actions, log_prob, obs_used)
