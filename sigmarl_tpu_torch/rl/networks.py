"""Policy network and the bounded TanhNormal action sampler.

`PolicyNet`: a 3x256 Tanh MLP shared across agents, whose head splits into
(loc, scale) with a biased-softplus scale. `tanh_normal_sample` squashes a
normal draw into the action box. `policy_from_jax_params` carries weights
over from the JAX package's flax parameters.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sigmarl_tpu_torch.device import resolve_device

Tensor = torch.Tensor

_SOFTPLUS_BIAS_1 = math.log(math.e - 1.0)  # softplus(bias) == 1.0
_SCALE_LB = 1e-4


class PolicyNet(nn.Module):
    """Decentralized, parameter-shared policy: obs [..., N, obs_dim] ->
    (loc, scale), each [..., N, act_dim]."""

    def __init__(
        self,
        obs_dim: int,
        act_dim: int = 2,
        hidden: Sequence[int] = (256, 256, 256),
        device: str | torch.device | None = None,
        seed: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        # Float32 matrix products stay full float32 on the card: TF32 would
        # keep about three decimal digits and break parity with the JAX
        # policy. Both switches are set explicitly here.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        widths = [obs_dim, *hidden, 2 * act_dim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=dev) for a, b in zip(widths[:-1], widths[1:])
        )
        self.act_dim = act_dim
        # Flax's default initialization: truncated-normal (lecun) kernels,
        # zero biases, drawn from `seed`.
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in self.layers:
                std = 1.0 / math.sqrt(layer.in_features) / 0.87962566103423978
                w = torch.empty(layer.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
                layer.weight.copy_(w)
                layer.bias.zero_()

    def forward(self, obs: Tensor) -> Tuple[Tensor, Tensor]:
        x = obs
        for layer in self.layers[:-1]:
            x = torch.tanh(layer(x))
        out = self.layers[-1](x)
        loc, scale_raw = out[..., : self.act_dim], out[..., self.act_dim:]
        scale = torch.clamp(
            torch.nn.functional.softplus(scale_raw + _SOFTPLUS_BIAS_1), min=_SCALE_LB
        )
        return loc, scale


def policy_from_jax_params(
    params_np: Mapping, device: str | torch.device | None = None
) -> PolicyNet:
    """A `PolicyNet` holding the weights of a flax `PolicyNet` parameter
    tree given as numpy arrays (as `PolicyNet.init` returns it, or as
    `rl/checkpoint.py` saves it). A flax `Dense.kernel` of shape [in, out]
    becomes `nn.Linear.weight` of shape [out, in]."""
    tree = params_np.get("params", params_np)
    mlp = tree["MLP_0"]
    names = sorted(mlp, key=lambda s: int(s.split("_")[-1]))
    kernels = [np.asarray(mlp[n]["kernel"], np.float32) for n in names]
    obs_dim = kernels[0].shape[0]
    hidden = [k.shape[1] for k in kernels[:-1]]
    act_dim = kernels[-1].shape[1] // 2
    net = PolicyNet(obs_dim, act_dim, hidden, device=device)
    with torch.no_grad():
        for layer, n, k in zip(net.layers, names, kernels):
            layer.weight.copy_(torch.from_numpy(k.T.copy()))
            layer.bias.copy_(torch.from_numpy(np.asarray(mlp[n]["bias"], np.float32)))
    return net


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
    [low, high]."""
    if noise is None:
        noise = torch.randn(loc.shape, generator=generator, device=loc.device)
    loc_c = upscale * torch.tanh(loc / upscale)
    z = loc_c + scale * noise
    t = torch.tanh(z)
    mid, half = (high + low) / 2, (high - low) / 2
    action = mid + half * t
    var = scale**2
    normal_lp = -((z - loc_c) ** 2) / (2 * var) - torch.log(scale) - 0.5 * math.log(2 * math.pi)
    log_prob = normal_lp - torch.log(half * (1 - t**2) + 1e-6)
    return action, log_prob.sum(-1)
