"""XP-MARL's learned priority and prioritized action propagation.

The priority actor scores every agent with a TanhNormal sample in (-1, 1);
a stable descending sort of the scores ranks the agents of each env (equal
scores keep the lower index first). The agents then act in N turns, the
highest priority first: in its turn an agent's observation carries, in its
zero-padded tail, the actions its k nearest neighbours have already decided
(zeros for those still to act), and the policy runs on that agent's row
alone. The priority stream learns by its own GAE and Clip-PPO loss, with the
priority critic's values, on the scores it sampled.

Upstream: sigmarl/modules/priority_module.py:36-186 (the score networks,
`rank_agents` at :128-150, the Clip-PPO loss at :93-126) and
sigmarl/helper_training.py:1162-1314 (`prioritized_ap_policy`, the turns).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from benchmark.reference.core.geometry import nearest_indices
from benchmark.reference.rl import ppo
from benchmark.reference.rl.networks import tanh_normal_sample

Tensor = torch.Tensor


def score_sample(loc: Tensor, scale: Tensor, noise: Tensor) -> Tuple[Tensor, Tensor]:
    """Every agent's score in (-1, 1) and its log-probability, [B, N] each,
    from the priority actor's (loc, scale) [B, N, 1] and standard normals
    `noise` [B, N, 1]."""
    one = torch.ones((1,), device=loc.device)
    scores, log_prob = tanh_normal_sample(loc, scale, -one, one, noise=noise)
    return scores[..., 0], log_prob


def rank_agents(scores: Tensor) -> Tensor:
    """[B, N] agent indices in descending score, equal scores in index
    order."""
    return torch.argsort(-scores, dim=-1, stable=True)


def neighbours(d_agents: Tensor, k: int) -> Tensor:
    """Each agent's k nearest agents [B, N, k] (the env state's distances
    [B, N, N]), nearest first."""
    return nearest_indices(d_agents, k)


def pad(obs: Tensor, k: int) -> Tensor:
    """The policy's observation: `obs` with 2k zero columns for the
    neighbours' actions."""
    return torch.cat([obs, obs.new_zeros(obs.shape[:-1] + (2 * k,))], -1)


def propagate(policy: Callable[[Tensor], Tuple[Tensor, Tensor]], base_obs: Tensor, rank: Tensor,
              nbrs: Tensor, low: Tensor, high: Tensor, action_noise: Tensor,
              decided: Tensor | None = None):
    """The N turns. In turn t the agent `rank[:, t]` of every env writes its
    neighbours' actions decided in earlier turns (zeros for the others)
    into its observation's tail, runs `policy` on that row and samples its
    action with the normals `action_noise[t]` [B, 2]. The decided actions
    are the turns' own, or with `decided` [B, N, 2] those given (the
    actions another implementation took, each agent judged from them).
    Returns (actions [B, N, 2], log_prob [B, N], the observation each agent
    acted on [B, N, obs + 2k])."""
    B, N = base_obs.shape[:2]
    k = nbrs.shape[-1]
    envs = torch.arange(B, device=base_obs.device)
    actions = base_obs.new_zeros((B, N, 2))
    log_prob = base_obs.new_zeros((B, N))
    acted = torch.zeros((B, N), dtype=torch.bool, device=base_obs.device)
    obs_used = base_obs.clone()
    for t in range(N):
        agent = rank[:, t].long()
        obs = base_obs[envs, agent].clone()
        if k > 0:
            near = nbrs[envs, agent].long()  # [B, k]
            source = actions if decided is None else decided
            tail = torch.where(acted[envs[:, None], near][..., None],
                               source[envs[:, None], near], torch.zeros_like(source[:, :k]))
            obs[:, -2 * k:] = tail.reshape(B, 2 * k)
        loc, scale = policy(obs)
        a, lp = tanh_normal_sample(loc, scale, low, high, noise=action_noise[t])
        actions[envs, agent] = a
        log_prob[envs, agent] = lp
        obs_used[envs, agent] = obs
        acted[envs, agent] = True
    return actions, log_prob, obs_used


def priority_gae(reward: Tensor, values: Tensor, next_values: Tensor, done: Tensor, gamma: float,
                 lmbda: float):
    """The priority stream's advantages and value targets [T, B, N]: GAE of
    the env's rewards with the priority critic's values."""
    return ppo.gae(reward, values, next_values, done, gamma, lmbda)


def priority_loss(loc: Tensor, scale: Tensor, values: Tensor, scores: Tensor, old_log_prob: Tensor,
                  adv: Tensor, vt: Tensor, cfg: ppo.PPOConfig, entropy_noise: Tensor):
    """The priority stream's Clip-PPO loss on a minibatch: the sampled
    scores [M, N] as the actions of a 1-D TanhNormal in (-1, 1), the
    priority critic's values [M, N], its entropy from the normals
    `entropy_noise` [M, N, 1]. Returns (total, statistics)."""
    one = torch.ones((1,), device=loc.device)
    return ppo.ppo_losses(loc, scale, values, scores[..., None], old_log_prob, adv, vt, -one, one,
                          cfg, entropy_noise)
