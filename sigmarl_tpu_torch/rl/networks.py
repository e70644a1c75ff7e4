"""Actor and critic networks and the bounded TanhNormal action head.

`PolicyNet`: a 3x256 Tanh MLP shared across agents, whose head splits into
(loc, scale) with a biased-softplus scale. `CentralizedCritic`: the MAPPO
critic, one value from all agents' observations, broadcast to every agent;
`DecentralizedCritic`: one value per agent. `score_policy` and
`score_critic` build the 2x256 networks of a 1-D score in (-1, 1):
XP-MARL's priority actor-critic and the learned-CBF module's.
`tanh_normal_sample`, `tanh_normal_log_prob` and `tanh_normal_mode` squash
a normal into the action box. `policy_from_jax_params` /
`critic_from_jax_params` carry weights over from the JAX package's flax
parameters (they read the widths from the tree, so they load the score
networks too) and `to_jax_params` gives them back in that layout.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.device import resolve_device

Tensor = torch.Tensor

_SOFTPLUS_BIAS_1 = math.log(math.e - 1.0)  # softplus(bias) == 1.0
_SCALE_LB = 1e-4
HIDDEN = (256, 256, 256)
SCORE_HIDDEN = (256, 256)  # the priority and learned-CBF networks


def full_fp32_matmuls() -> None:
    """Keep float32 matrix products full float32 on the card: TF32 would
    keep about three decimal digits and break parity with the JAX networks.
    Every network constructor calls this."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class MLP(nn.Module):
    """Tanh MLP `widths[0] -> ... -> widths[-1]` (no activation on the
    output), initialised as flax's `Dense` is: truncated-normal (lecun)
    kernels and zero biases, drawn from `seed`."""

    def __init__(self, widths: Sequence[int], device: torch.device, seed: int = 0):
        super().__init__()
        full_fp32_matmuls()
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(widths[:-1], widths[1:])
        )
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in self.layers:
                std = 1.0 / math.sqrt(layer.in_features) / 0.87962566103423978
                w = torch.empty(layer.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
                layer.weight.copy_(w)
                layer.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        for layer in self.layers[:-1]:
            x = torch.tanh(layer(x))
        return self.layers[-1](x)


class PolicyNet(nn.Module):
    """Decentralized, parameter-shared policy: obs [..., N, obs_dim] ->
    (loc, scale), each [..., N, act_dim]."""

    def __init__(
        self,
        obs_dim: int,
        act_dim: int = 2,
        hidden: Sequence[int] = HIDDEN,
        device: str | torch.device | None = None,
        seed: int = 0,
    ):
        super().__init__()
        self.mlp = MLP([obs_dim, *hidden, 2 * act_dim], resolve_device(device), seed)
        self.act_dim = act_dim

    @property
    def layers(self) -> nn.ModuleList:
        return self.mlp.layers

    @trace.span("policy")
    def forward(self, obs: Tensor) -> Tuple[Tensor, Tensor]:
        out = self.mlp(obs)
        loc, scale_raw = out[..., : self.act_dim], out[..., self.act_dim:]
        scale = torch.clamp(
            torch.nn.functional.softplus(scale_raw + _SOFTPLUS_BIAS_1), min=_SCALE_LB
        )
        return loc, scale


class CentralizedCritic(nn.Module):
    """MAPPO critic: all N agents' observations concatenated -> one shared
    value, broadcast back to every agent. [..., N, obs_dim] -> [..., N, 1]."""

    def __init__(
        self,
        obs_dim: int,
        n_agents: int,
        hidden: Sequence[int] = HIDDEN,
        device: str | torch.device | None = None,
        seed: int = 1,
    ):
        super().__init__()
        self.mlp = MLP([n_agents * obs_dim, *hidden, 1], resolve_device(device), seed)

    def forward(self, obs: Tensor) -> Tensor:
        v = self.mlp(obs.reshape(obs.shape[:-2] + (-1,)))  # [..., 1]
        return v[..., None, :].expand(obs.shape[:-1] + (1,))


class DecentralizedCritic(nn.Module):
    """Per-agent critic, parameter shared. [..., N, obs_dim] -> [..., N, 1]."""

    def __init__(
        self,
        obs_dim: int,
        hidden: Sequence[int] = HIDDEN,
        device: str | torch.device | None = None,
        seed: int = 1,
    ):
        super().__init__()
        self.mlp = MLP([obs_dim, *hidden, 1], resolve_device(device), seed)

    def forward(self, obs: Tensor) -> Tensor:
        return self.mlp(obs)


def score_policy(
    obs_dim: int, device: str | torch.device | None = None, seed: int = 0
) -> PolicyNet:
    """Policy of a 1-D TanhNormal score: obs [..., N, obs_dim] -> (loc,
    scale), each [..., N, 1], on a 2x256 Tanh MLP (XP-MARL's `PriorityNet`,
    the learned-CBF module's `CBFScoreNet`)."""
    return PolicyNet(obs_dim, 1, SCORE_HIDDEN, device=device, seed=seed)


def score_critic(
    obs_dim: int, n_agents: int | None, device: str | torch.device | None = None, seed: int = 1
) -> nn.Module:
    """Critic of a score policy on a 2x256 Tanh MLP: centralized over
    `n_agents` agents (XP-MARL's `PriorityCritic`, the learned-CBF module's
    MAPPO critic), or per agent with `n_agents=None`."""
    if n_agents is None:
        return DecentralizedCritic(obs_dim, SCORE_HIDDEN, device=device, seed=seed)
    return CentralizedCritic(obs_dim, n_agents, SCORE_HIDDEN, device=device, seed=seed)


# ------------------------------------------------------------ flax layout
def _dense_stack(params_np: Mapping):
    """The kernels [in, out] and biases of a flax `MLP_0` tree, in layer
    order, as float32 numpy arrays."""
    mlp = params_np.get("params", params_np)["MLP_0"]
    names = sorted(mlp, key=lambda s: int(s.split("_")[-1]))
    kernels = [np.asarray(mlp[n]["kernel"], np.float32) for n in names]
    biases = [np.asarray(mlp[n]["bias"], np.float32) for n in names]
    return kernels, biases


def _load_dense_stack(net: nn.Module, kernels, biases) -> nn.Module:
    """Copy flax kernels [in, out] into `nn.Linear.weight` [out, in]."""
    with torch.no_grad():
        for layer, k, b in zip(net.mlp.layers, kernels, biases):
            layer.weight.copy_(torch.from_numpy(k.T.copy()))
            layer.bias.copy_(torch.from_numpy(b.copy()))
    return net


def policy_from_jax_params(
    params_np: Mapping, device: str | torch.device | None = None
) -> PolicyNet:
    """A `PolicyNet` holding the weights of a flax `PolicyNet` parameter
    tree given as numpy arrays (as `PolicyNet.init` returns it, or as
    `rl/checkpoint.py` saves it)."""
    kernels, biases = _dense_stack(params_np)
    hidden = [k.shape[1] for k in kernels[:-1]]
    net = PolicyNet(kernels[0].shape[0], kernels[-1].shape[1] // 2, hidden, device=device)
    return _load_dense_stack(net, kernels, biases)


def critic_from_jax_params(
    params_np: Mapping, n_agents: int | None, device: str | torch.device | None = None
) -> nn.Module:
    """A critic holding the weights of a flax critic parameter tree:
    a `CentralizedCritic` over `n_agents` agents, or with `n_agents=None`
    a `DecentralizedCritic`."""
    kernels, biases = _dense_stack(params_np)
    hidden = [k.shape[1] for k in kernels[:-1]]
    in_dim = kernels[0].shape[0]
    if n_agents is None:
        net = DecentralizedCritic(in_dim, hidden, device=device)
    else:
        if in_dim % n_agents:
            raise ValueError(f"input width {in_dim} does not split over {n_agents} agents")
        net = CentralizedCritic(in_dim // n_agents, n_agents, hidden, device=device)
    return _load_dense_stack(net, kernels, biases)


def to_jax_params(net: nn.Module) -> dict:
    """The flax parameter tree of a network of this module, as numpy
    arrays: {"params": {"MLP_0": {"Dense_k": {"kernel": [in, out],
    "bias": [out]}}}}."""
    dense = {
        f"Dense_{k}": {
            "kernel": layer.weight.detach().cpu().numpy().T.copy(),
            "bias": layer.bias.detach().cpu().numpy().copy(),
        }
        for k, layer in enumerate(net.mlp.layers)
    }
    return {"params": {"MLP_0": dense}}


# ------------------------------------------------------------- TanhNormal
def _normal_log_prob(z: Tensor, loc: Tensor, scale: Tensor) -> Tensor:
    var = scale**2
    return -((z - loc) ** 2) / (2 * var) - torch.log(scale) - 0.5 * math.log(2 * math.pi)


def _squash_log_prob(z, t, loc_c, scale, half) -> Tensor:
    """log-prob of the squashed action, summed over action dims."""
    log_prob = _normal_log_prob(z, loc_c, scale) - torch.log(half * (1 - t**2) + 1e-6)
    return log_prob.sum(-1)


def tanh_normal_sample(
    loc: Tensor,
    scale: Tensor,
    low: Tensor,
    high: Tensor,
    generator: torch.Generator | None = None,
    noise: Tensor | None = None,
    upscale: float = 5.0,
) -> Tuple[Tensor, Tensor]:
    """Sample a bounded action and its log-probability (summed over action
    dims). The pre-squash loc is soft-clipped by upscale * tanh(loc /
    upscale); z = loc + scale * noise with standard-normal `noise` (drawn
    from `generator` when not given); the action is tanh(z) rescaled into
    [low, high]. Differentiable in loc and scale."""
    if noise is None:
        noise = torch.randn(loc.shape, generator=generator, device=loc.device)
    loc_c = upscale * torch.tanh(loc / upscale)
    z = loc_c + scale * noise
    t = torch.tanh(z)
    mid, half = (high + low) / 2, (high - low) / 2
    return mid + half * t, _squash_log_prob(z, t, loc_c, scale, half)


def tanh_normal_log_prob(
    action: Tensor, loc: Tensor, scale: Tensor, low: Tensor, high: Tensor, upscale: float = 5.0
) -> Tensor:
    """Log-probability of a given bounded action (for PPO ratios); the
    normalised action is clipped to +-(1 - 1e-6) before `atanh`."""
    loc_c = upscale * torch.tanh(loc / upscale)
    mid, half = (high + low) / 2, (high - low) / 2
    t = torch.clamp((action - mid) / half, -1 + 1e-6, 1 - 1e-6)
    return _squash_log_prob(torch.atanh(t), t, loc_c, scale, half)


def tanh_normal_mode(loc: Tensor, low: Tensor, high: Tensor, upscale: float = 5.0) -> Tensor:
    """Deterministic (mode) action: tanh of the clipped loc, rescaled."""
    t = torch.tanh(upscale * torch.tanh(loc / upscale))
    return (high + low) / 2 + (high - low) / 2 * t
