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

On the CPU the learned rank and the turns run as eager bodies
(`_score_rank`, `_turns`). On the card each is one CUDA graph per input
key, replayed once a call (`rl/act_graphs.py`); the random rank stays
eager.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.constants import AGENTS
from sigmarl_tpu_torch.device import constant
# Each agent's k nearest agents [B, N, k], nearest first, the lower index
# first among equal distances.
from sigmarl_tpu_torch.core.geometry import nearest_indices as nearing_agent_indices  # noqa: F401
from sigmarl_tpu_torch.rl import act_graphs
from sigmarl_tpu_torch.rl.act_graphs import signature
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
    scores keep the lower index first); on the card replayed from a CUDA
    graph (`rl/act_graphs.py`), the score normals drawn first where they
    come from `generator`."""
    B, N = obs.shape[:2]
    dev = obs.device
    if method == "random":
        if perms is None:
            perms = torch.argsort(torch.rand((B, N), generator=generator, device=dev), dim=-1)
        zeros = torch.zeros((B, N), device=dev)
        return PriorityOutput(perms.to(torch.int32), zeros, zeros)
    if not obs.is_cuda:
        return _score_rank(net, obs, generator, noise)

    def inputs(bufs):
        z = noise
        if z is None:  # the body's draw: `tanh_normal_sample`'s, of the scores' shape
            z = torch.empty((B, N, 1), device=dev) if bufs is None else bufs[1]
            torch.randn(z.shape, generator=generator, out=z)
        return obs, z

    key = (dev, signature(obs), noise is None or signature(noise))
    return act_graphs.replayed("rank", net, key, inputs, lambda x: _score_rank(net, x[0], None, x[1]))


def _score_rank(net: nn.Module, obs: Tensor, generator: torch.Generator | None,
                noise: Tensor | None) -> PriorityOutput:
    """`priority_rank`'s learned branch: the score network, the sample and
    the stable descending sort."""
    loc, scale = net(obs)
    one = torch.ones((1,), device=obs.device)
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
    positive), runs the policy on that row and samples its action. On the
    card the N turns are replayed from one CUDA graph (`rl/act_graphs.py`),
    the normals that come from `generator` drawn first, per turn the
    communication's and then the action's, as the turns draw them."""
    B, N = base_obs.shape[:2]
    k = nearing_idx.shape[-1]
    dev = base_obs.device
    noisy = k > 0 and communication_noise_level > 0
    std = None
    if noisy:
        std = constant((AGENTS["max_speed"], AGENTS["max_steering"]) * k, torch.float32, dev)
        std = std * communication_noise_level
    comm = communication_noise if noisy else None
    if not base_obs.is_cuda:
        return _turns(policy, base_obs, rank, nearing_idx, low, high, std, generator,
                      action_noise, comm)
    draw_act, draw_comm = action_noise is None, noisy and comm is None

    def inputs(bufs):
        act, z = action_noise, comm
        if draw_act:
            act = torch.empty((N, B, 2), device=dev) if bufs is None else bufs[6]
        if draw_comm:
            z = torch.empty((N, B, 2 * k), device=dev) if bufs is None else bufs[7]
        for t in range(N):
            if draw_comm:
                torch.randn(z[t].shape, generator=generator, out=z[t])
            if draw_act:
                torch.randn(act[t].shape, generator=generator, out=act[t])
        return base_obs, rank, nearing_idx, low, high, std, act, z

    key = (dev, *map(signature, (base_obs, rank, nearing_idx, low, high)),
           draw_act or signature(action_noise), draw_comm or signature(comm), noisy)
    return act_graphs.replayed(
        "turns", policy, key, inputs, lambda x: _turns(policy, *x[:6], None, *x[6:]))


def _turns(
    policy: nn.Module,
    base_obs: Tensor,
    rank: Tensor,
    nearing_idx: Tensor,
    low: Tensor,
    high: Tensor,
    std: Tensor | None,  # [2k] the communication noise's std; None: no noise
    generator: torch.Generator | None,
    action_noise: Tensor | None,
    communication_noise: Tensor | None,
) -> APResult:
    """`prioritized_action_propagation`'s N turns, op by op: what the CPU
    runs and the card's graph holds. It makes no tensor from host values,
    so nothing in it waits for the card."""
    B, N = base_obs.shape[:2]
    k = nearing_idx.shape[-1]
    dev = base_obs.device
    env_idx = torch.arange(B, device=dev)
    actions = torch.zeros((B, N, 2), device=dev)
    log_prob = torch.zeros((B, N), device=dev)
    obs_used = base_obs.clone()
    for t in range(N):
        trace.count("turns")
        acting = rank[:, t].long()  # [B]
        obs_a = base_obs[env_idx, acting]  # [B, obs_pad] (a copy)
        if k > 0:
            neighbors = nearing_idx[env_idx, acting].long()  # [B, k]
            tail = actions[env_idx[:, None], neighbors].reshape(B, 2 * k)
            if std is not None:
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
