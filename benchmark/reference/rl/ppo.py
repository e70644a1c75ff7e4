"""GAE and the clipped-PPO losses.

GAE runs over the time axis; the PPO objective is clipped, the critic loss
is smooth-L1 against the GAE value target, and the entropy bonus is a
single-sample Monte-Carlo estimate (TanhNormal has no closed-form
entropy). Advantages are not normalised: normalising across the agent
dimension is wrong for MARL.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from benchmark.reference.rl.networks import tanh_normal_log_prob, tanh_normal_sample

Tensor = torch.Tensor


class PPOConfig(NamedTuple):
    gamma: float = 0.99
    lmbda: float = 0.9
    clip_epsilon: float = 0.2
    entropy_eps: float = 1e-4
    critic_coeff: float = 1.0


def gae(
    rewards: Tensor,  # [T, B, N]
    values: Tensor,  # [T, B, N]
    next_values: Tensor,  # [T, B, N]
    dones: Tensor,  # [T, B] bool (terminated)
    gamma: float,
    lmbda: float,
) -> Tuple[Tensor, Tensor]:
    """Generalized advantage estimation over the leading time axis.
    Returns (advantages [T,B,N], value_targets [T,B,N])."""
    not_done = (~dones).to(rewards.dtype)[..., None]  # [T, B, 1]
    deltas = rewards + gamma * next_values * not_done - values
    advs = torch.empty_like(deltas)
    carry = torch.zeros_like(deltas[-1])
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * lmbda * not_done[t] * carry
        advs[t] = carry
    return advs, advs + values


def smooth_l1(pred: Tensor, target: Tensor, beta: float = 1.0) -> Tensor:
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def ppo_losses(
    loc: Tensor,
    scale: Tensor,
    values: Tensor,
    actions: Tensor,
    old_log_prob: Tensor,
    advantages: Tensor,
    value_targets: Tensor,
    low: Tensor,
    high: Tensor,
    cfg: PPOConfig,
    entropy_noise: Tensor,
    count: int | None = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Clip-PPO loss terms for one minibatch.

    Shapes: loc/scale/actions/entropy_noise [M, N, A]; values/old_log_prob/
    advantages/value_targets [M, N]. The entropy estimate draws one
    reparameterised sample through the squash from the standard-normal
    `entropy_noise`, so its gradient flows through loc and scale.

    Each term is a mean over the minibatch's rows. With `count` the rows
    are one rank's part of a minibatch of `count` rows, and each term is
    their sum over count (the ranks' terms and gradients then sum to the
    whole minibatch's)."""

    def mean(x: Tensor) -> Tensor:
        return x.mean() if count is None else x.sum() / (count * math.prod(x.shape[1:]))

    log_prob = tanh_normal_log_prob(actions, loc, scale, low, high)
    ratio = torch.exp(log_prob - old_log_prob)
    surr1 = ratio * advantages
    surr2 = torch.clamp(ratio, 1 - cfg.clip_epsilon, 1 + cfg.clip_epsilon) * advantages
    loss_objective = -mean(torch.minimum(surr1, surr2))

    loss_critic = cfg.critic_coeff * mean(smooth_l1(values, value_targets))

    _, sample_lp = tanh_normal_sample(loc, scale, low, high, noise=entropy_noise)
    entropy = -mean(sample_lp)
    loss_entropy = -cfg.entropy_eps * entropy

    total = loss_objective + loss_critic + loss_entropy
    stats = {
        "loss_objective": loss_objective,
        "loss_critic": loss_critic,
        "loss_entropy": loss_entropy,
        "entropy": entropy,
        "ratio_mean": mean(ratio),
    }
    return total, stats
