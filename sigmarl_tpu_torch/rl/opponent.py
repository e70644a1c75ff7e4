"""Opponent modeling: each agent predicts its observed neighbours' tentative
actions with its own policy, optionally corrupted by Gaussian model noise,
writes them into the zero-padded tail of its observation and acts on that.
Two policy passes per step over all agents at once. The passes' normals
(and the model noise) can be given as tensors, else they come from a
`torch.Generator`."""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from sigmarl_tpu_torch.constants import AGENTS
from sigmarl_tpu_torch.rl.networks import tanh_normal_sample

Tensor = torch.Tensor


class OpponentModelResult(NamedTuple):
    actions: Tensor  # [B, N, 2]
    log_prob: Tensor  # [B, N]
    obs_used: Tensor  # [B, N, obs_pad]


@torch.no_grad()
def opponent_modeling_policy(
    policy: nn.Module,
    obs: Tensor,  # [B, N, obs_dim + k*2] zero-padded tail
    nearing_idx: Tensor,  # [B, N, k]
    low: Tensor,
    high: Tensor,
    generator: torch.Generator | None = None,
    action_noise: Tensor | None = None,  # [2, B, N, 2] normals: tentative, final
    noise_percentage: float = 0.0,
    model_noise: Tensor | None = None,  # [B, N, 2] normals of the model noise
) -> OpponentModelResult:
    """Pass 1 samples tentative actions on the observation as it is; with
    `noise_percentage` > 0 they get noise of std [max_speed, max_steering]
    * noise_percentage. Pass 2 samples the final actions on the observation
    whose tail holds the neighbours' tentative actions."""
    B, N = obs.shape[:2]
    k = nearing_idx.shape[-1]
    dev = obs.device

    def noise(i):
        return None if action_noise is None else action_noise[i]

    loc, scale = policy(obs)
    tentative, _ = tanh_normal_sample(loc, scale, low, high, generator=generator, noise=noise(0))
    if noise_percentage > 0:
        std = torch.tensor([AGENTS["max_speed"], AGENTS["max_steering"]], device=dev)
        z = (torch.randn(tentative.shape, generator=generator, device=dev)
             if model_noise is None else model_noise)
        tentative = tentative + std * noise_percentage * z

    obs2 = obs.clone()
    if k > 0:
        b_idx = torch.arange(B, device=dev)[:, None, None]
        neighbour_actions = tentative[b_idx, nearing_idx.long()]  # [B, N, k, 2]
        obs2[..., -2 * k:] = neighbour_actions.reshape(B, N, 2 * k)

    loc, scale = policy(obs2)
    actions, log_prob = tanh_normal_sample(loc, scale, low, high, generator=generator,
                                           noise=noise(1))
    return OpponentModelResult(actions, log_prob, obs2)
