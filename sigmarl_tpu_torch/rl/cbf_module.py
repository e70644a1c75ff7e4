"""Learned-CBF module: an actor-critic that scores control-barrier values.

A second actor-critic whose TanhNormal score head learns a CBF from a
`cbf_observation` (the base observation with a zero tail of k * 2 columns,
where action propagation writes the neighbours' decided actions), trained
by its own full-batch Clip-PPO update after GAE under a constant-rate Adam
with no clipping (optax's `adam(lr)`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from sigmarl_tpu_torch.rl.networks import score_critic, score_policy, tanh_normal_sample
from sigmarl_tpu_torch.rl.optim import Adam, AdamState
from sigmarl_tpu_torch.rl.ppo import PPOConfig, gae, ppo_losses

Tensor = torch.Tensor


def make_cbf_observation(base_obs: Tensor, n_nearing_agents: int) -> Tensor:
    """The base observation with a fresh zero tail of `n_nearing_agents * 2`
    columns."""
    pad = base_obs.new_zeros(base_obs.shape[:-1] + (n_nearing_agents * 2,))
    return torch.cat([base_obs, pad], dim=-1)


class CBFModuleState(NamedTuple):
    policy: nn.Module
    critic: nn.Module
    opt_state: AdamState


class CBFModule:
    """Actor-critic learning CBF scores with its own Clip-PPO optimizer.
    The critic is centralized (MAPPO) unless `mappo` is False."""

    def __init__(
        self,
        obs_dim: int,
        n_agents: int,
        mappo: bool = True,
        lr: float = 1e-4,
        ppo: PPOConfig = PPOConfig(),
        device: str | torch.device | None = None,
    ):
        self.obs_dim, self.n_agents, self.mappo = obs_dim, n_agents, mappo
        self.ppo = ppo
        self.device = device
        self.optimizer = Adam(lr)

    def init(self, seed: int = 0) -> CBFModuleState:
        """Fresh networks (weights drawn from `seed`) and Adam moments."""
        policy = score_policy(self.obs_dim, device=self.device, seed=2 * seed)
        critic = score_critic(self.obs_dim, self.n_agents if self.mappo else None,
                              device=self.device, seed=2 * seed + 1)
        return self.state(policy, critic)

    def state(self, policy: nn.Module, critic: nn.Module) -> CBFModuleState:
        """A state around given networks, with fresh Adam moments."""
        return CBFModuleState(policy, critic, self.optimizer.init(self._params(policy, critic)))

    @staticmethod
    def _params(policy, critic):
        return list(policy.parameters()) + list(critic.parameters())

    @staticmethod
    def _bounds(ref: Tensor) -> Tuple[Tensor, Tensor]:
        one = torch.ones((1,), device=ref.device)
        return -one, one

    @torch.no_grad()
    def sample_scores(
        self, state: CBFModuleState, obs: Tensor, generator: torch.Generator | None = None,
        noise: Tensor | None = None,
    ) -> Tuple[Tensor, Tensor]:
        """TanhNormal scores in (-1, 1) and their log-probabilities, each
        [..., N]; `noise` [..., N, 1] are the sample's normals."""
        loc, scale = state.policy(obs)
        scores, log_prob = tanh_normal_sample(loc, scale, *self._bounds(obs),
                                              generator=generator, noise=noise)
        return scores[..., 0], log_prob

    def train_step(
        self,
        state: CBFModuleState,
        obs: Tensor,  # [T, B, N, obs_dim]
        next_obs: Tensor,  # [T, B, N, obs_dim]
        scores: Tensor,  # [T, B, N]
        old_log_prob: Tensor,  # [T, B, N]
        rewards: Tensor,  # [T, B, N]
        dones: Tensor,  # [T, B] bool
        entropy_noise: Tensor | None = None,  # [T * B, N, 1] normals
        generator: torch.Generator | None = None,
    ) -> Tuple[CBFModuleState, Dict[str, Tensor]]:
        """One full-batch PPO update on a recorded rollout: GAE with the
        critic before the update, then one Adam step on the Clip-PPO loss.
        Updates the networks in place; returns the new state and the loss
        statistics."""
        with torch.no_grad():
            values = state.critic(obs)[..., 0]
            next_values = state.critic(next_obs)[..., 0]
            advs, targets = gae(rewards, values, next_values, dones, self.ppo.gamma,
                                self.ppo.lmbda)

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        obs_f = flat(obs)
        if entropy_noise is None:
            entropy_noise = torch.randn(obs_f.shape[:-1] + (1,), generator=generator,
                                        device=obs.device)
        loc, scale = state.policy(obs_f)
        vals = state.critic(obs_f)[..., 0]
        total, stats = ppo_losses(
            loc, scale, vals, flat(scores)[..., None], flat(old_log_prob), flat(advs),
            flat(targets), *self._bounds(obs), self.ppo, entropy_noise,
        )
        params = self._params(state.policy, state.critic)
        grads = torch.autograd.grad(total, params)
        opt_state = self.optimizer.step(params, grads, state.opt_state)
        return (CBFModuleState(state.policy, state.critic, opt_state),
                {k: v.detach() for k, v in stats.items()})
