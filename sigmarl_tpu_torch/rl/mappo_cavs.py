"""MAPPO trainer for the road-traffic environment.

One training iteration is a rollout of `max_steps` env transitions over
all envs (a Python loop: plain `env.step`, or the CBF-filtered or the
margins-only step when CBF training is on), GAE, and `num_epochs` epochs
of minibatch PPO updates over a random permutation of the frames (or,
with `is_prb`, over prioritized samples). Checkpointing keeps the
reward-keyed retention policy of `rl/checkpoint.py`: a checkpoint is
written only when the mean episode reward improves, lower-reward files
are deleted, and the run configuration rides along as a JSON sidecar.

Every random number an iteration consumes can be given as tensors
(`IterationDraws`), so tests can feed it the JAX package's draws; without
them they come from the trainer's generator on its device.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.env.env import RoadTrafficEnv, make_env
from sigmarl_tpu_torch.env.reset import ResetDraws
from sigmarl_tpu_torch.env.structs import WorldState
from sigmarl_tpu_torch.rl import checkpoint as ckpt
from sigmarl_tpu_torch.rl.networks import (
    CentralizedCritic,
    PolicyNet,
    critic_from_jax_params,
    policy_from_jax_params,
    tanh_normal_mode,
    tanh_normal_sample,
    to_jax_params,
)
from sigmarl_tpu_torch.rl.optim import AdamState, ClippedAdam
from sigmarl_tpu_torch.rl.ppo import PPOConfig, gae, ppo_losses
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step, cbf_margin_step

Tensor = torch.Tensor

PRB_ALPHA = 0.7  # priority exponent of the prioritized replay buffer


@dataclass
class DecisionMakingModule:
    """The trained policy and its action box."""

    net: PolicyNet
    low: Tensor
    high: Tensor

    @torch.no_grad()
    def act(
        self,
        obs: Tensor,
        generator: torch.Generator | None = None,
        deterministic: bool = False,
        noise: Tensor | None = None,
    ):
        """(action [..., N, 2], log_prob [..., N]); the mode action has log_prob 0."""
        loc, scale = self.net(obs)
        if deterministic:
            return tanh_normal_mode(loc, self.low, self.high), torch.zeros_like(loc[..., 0])
        return tanh_normal_sample(loc, scale, self.low, self.high, generator=generator, noise=noise)


@dataclass
class OptimizationModule:
    """The critic and the optimizer with its state."""

    critic: nn.Module
    optimizer: ClippedAdam
    opt_state: AdamState


@dataclass
class TrainState:
    """What one iteration carries to the next. `train_iteration` updates
    the networks in place and returns a new state."""

    policy: PolicyNet
    critic: nn.Module
    opt_state: AdamState
    env_state: WorldState
    obs: Tensor  # [B, N, obs_dim]
    ep_reward_accum: Tensor  # [B, N] running episodic reward
    iteration: int


class Transition(NamedTuple):
    obs: Tensor  # [B, N, obs] observation the policy acted on
    action: Tensor  # [B, N, 2]
    log_prob: Tensor  # [B, N]
    reward: Tensor  # [B, N]
    done: Tensor  # [B]
    next_obs: Tensor  # [B, N, obs]
    ep_reward_at_done: Tensor  # [B, N] episodic reward, read where done


@dataclass
class IterationDraws:
    """Every random number of one training iteration.

    action_noise: [T, B, N, 2] standard normals of the policy's samples.
    reset_draws: T `ResetDraws`, one per env step (used where envs reset).
    permutations: [E, M] frame permutations, one per epoch (None with PRB).
    entropy_noise: [E, n_mb, mb, N, 2] standard normals of the entropy
        estimate, one block per minibatch.
    prb_indices: [E, n_mb, mb] sampled frames of each minibatch (PRB only).
    """

    action_noise: Tensor
    reset_draws: Sequence[ResetDraws]
    permutations: Optional[Tensor]
    entropy_noise: Tensor
    prb_indices: Optional[Tensor] = None


def compute_td_error(reward, values, next_values, done, gamma: float = 0.9) -> Tensor:
    """Normalized TD-error priorities of the prioritized replay buffer:
    |TD error| averaged over the cooperative agents, min-max normalized to
    [1e-3, 10]."""
    not_done = (~done).to(reward.dtype)[..., None]
    td = torch.abs(reward + gamma * next_values * not_done - values).mean(-1)
    rng = torch.clamp(td.max() - td.min(), min=1e-3)
    return torch.clamp((td - td.min()) / rng * 10.0, 1e-3, 10.0)


def _check_ported(p: Parameters) -> None:
    unported = {
        "XP-MARL (is_using_prioritized_marl; ROADMAP A.1, rl/priority.py)": (
            p.is_using_prioritized_marl
        ),
        "opponent modeling (is_using_opponent_modeling; ROADMAP A.1, rl/opponent.py)": (
            p.is_using_opponent_modeling
        ),
        "debug_numerics (ROADMAP A.1, utils/debug.py)": p.debug_numerics,
    }
    for what, on in unported.items():
        if on:
            raise NotImplementedError(f"{what} is not ported to the PyTorch trainer")


class MAPPOCAVs:
    """Multi-agent PPO trainer. Runs on `device` (by default
    `parameters.device`, "cuda")."""

    def __init__(
        self,
        parameters: Parameters,
        env: Optional[RoadTrafficEnv] = None,
        device: str | torch.device | None = None,
    ):
        _check_ported(parameters)
        self.parameters = p = parameters
        self.env = env if env is not None else make_env(
            p, device=device if device is not None else p.device
        )
        self.device = dev = self.env.device
        cfg = self.env.cfg

        # One batched filter over all envs: in margins-only mode
        # (is_solve_qp=False) it feeds the "cbf" reward method, otherwise
        # it filters the actions.
        self.cbf_filter = None
        if p.is_using_cbf_training or p.is_using_cbf_testing:
            self.cbf_filter = CBFSafetyFilter(
                CBFConfig(
                    n_agents=p.n_agents,
                    n_circles=p.n_circles_approximate_vehicle,
                    dt=p.dt,
                    is_solve_qp=p.is_solve_qp,
                    adaptive_lambda_cost=p.adaptive_lambda,
                    nom_controller_type=p.nom_controller_type,
                    h_nom=p.h_nom,
                    is_obs_noise=p.is_obs_noise,
                    obs_noise_level=p.obs_noise_level,
                ),
                cfg,
                self.env.tables,
                decentralized=not p.is_using_centralized_cbf,
                device=dev,
            )

        self.policy_net = PolicyNet(cfg.obs_dim, 2, device=dev, seed=2 * p.random_seed)
        self.critic_net = CentralizedCritic(
            cfg.obs_dim, cfg.n_agents, device=dev, seed=2 * p.random_seed + 1
        )
        self.low = -self.env.action_limits
        self.high = self.env.action_limits
        self.generator = torch.Generator(device=dev).manual_seed(p.random_seed)

        self.ppo_cfg = PPOConfig(
            gamma=p.gamma, lmbda=p.lmbda, clip_epsilon=p.clip_epsilon, entropy_eps=p.entropy_eps
        )
        self.n_minibatches = max(1, p.frames_per_batch // p.minibatch_size)
        self.updates_per_iter = p.num_epochs * self.n_minibatches
        self.optimizer = ClippedAdam(
            p.max_grad_norm, p.lr, p.lr_min, self.updates_per_iter, p.n_iters
        )

        # Continue training from the checkpoint directory, with fresh Adam
        # moments; the sidecar's best reward and reward history carry on.
        self._restored_history: List[float] = []
        if p.is_continue_train and p.is_load_model:
            loaded = ckpt.load_best(p)
            self.policy_net = policy_from_jax_params(loaded["policy"], device=dev)
            self.critic_net = critic_from_jax_params(loaded["critic"], cfg.n_agents, device=dev)
            side = ckpt.load_sidecar(p)
            if side is not None:
                self._restored_history = list(side.get("episode_reward_mean_list", []))
                best = side.get("parameters", {}).get("episode_reward_intermediate")
                if best is not None:
                    p.episode_reward_intermediate = float(best)
        self.opt_state = self.optimizer.init(self.parameter_list())

    def parameter_list(self, policy: nn.Module | None = None, critic: nn.Module | None = None):
        """The policy's then the critic's parameters (the trainer's networks
        unless others are given): the tensors the optimizer updates."""
        policy = policy if policy is not None else self.policy_net
        critic = critic if critic is not None else self.critic_net
        return list(policy.parameters()) + list(critic.parameters())

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ rollout
    def env_transition(self, env_state: WorldState, action: Tensor, reset_draws=None):
        """One env step of the rollout, through the filter the flags ask for."""
        p, env, cbf = self.parameters, self.env, self.cbf_filter
        kw = dict(generator=self.generator, reset_draws=reset_draws)
        if p.is_using_cbf_training and cbf is not None:
            if p.is_solve_qp and p.is_apply_cbf_action:
                return cbf_filtered_step(env, cbf, env_state, action, **kw)
            return cbf_margin_step(env, cbf, env_state, action, **kw)
        return env.step(env_state, action, **kw)

    def initial_state(self, reset_draws: ResetDraws | None = None) -> TrainState:
        """A fresh episode in every env, and the trainer's networks."""
        env_state, obs = self.env.reset(generator=self.generator, draws=reset_draws)
        B, N = obs.shape[:2]
        return TrainState(
            policy=self.policy_net,
            critic=self.critic_net,
            opt_state=self.opt_state,
            env_state=env_state,
            obs=obs,
            ep_reward_accum=torch.zeros((B, N), device=self.device),
            iteration=0,
        )

    @torch.no_grad()
    def rollout(self, state: TrainState, draws: IterationDraws | None = None):
        """`max_steps` transitions of every env. Returns (env_state, obs,
        ep_reward_accum, batch, solved) with the batch's fields stacked to
        [T, ...] and `solved` the filter's solved share over the rollout
        (None without a filtered step)."""
        env_state, obs, ep_accum = state.env_state, state.obs, state.ep_reward_accum
        steps: List[Transition] = []
        solved = []
        for t in range(self.parameters.max_steps):
            loc, scale = state.policy(obs)
            action, log_prob = tanh_normal_sample(
                loc, scale, self.low, self.high, generator=self.generator,
                noise=None if draws is None else draws.action_noise[t],
            )
            env_state, next_obs, reward, done, info = self.env_transition(
                env_state, action, None if draws is None else draws.reset_draws[t]
            )
            if "cbf_solved" in info:
                solved.append(info["cbf_solved"].float().mean())
            ep_accum = ep_accum + reward
            ep_at_done = ep_accum
            ep_accum = torch.where(done[:, None], torch.zeros_like(ep_accum), ep_accum)
            steps.append(Transition(obs, action, log_prob, reward, done, next_obs, ep_at_done))
            obs = next_obs
        batch = Transition(*(torch.stack(f) for f in zip(*steps)))
        return env_state, obs, ep_accum, batch, torch.stack(solved).mean() if solved else None

    # ------------------------------------------------------------- update
    def loss(self, policy, critic, mb: Dict[str, Tensor], entropy_noise: Tensor):
        """The PPO loss of a minibatch (obs, action, log_prob, adv, vt) and
        its statistics."""
        loc, scale = policy(mb["obs"])
        v = critic(mb["obs"])[..., 0]
        return ppo_losses(
            loc, scale, v, mb["action"], mb["log_prob"], mb["adv"], mb["vt"],
            self.low, self.high, self.ppo_cfg, entropy_noise,
        )

    def minibatch_update(self, state_nets, opt_state: AdamState, mb, entropy_noise):
        """One PPO gradient step on a minibatch. `state_nets` = (policy,
        critic), updated in place. Returns (opt_state, loss stats)."""
        params = self.parameter_list(*state_nets)
        total, stats = self.loss(*state_nets, mb, entropy_noise)
        grads = torch.autograd.grad(total, params)
        opt_state = self.optimizer.step(params, grads, opt_state)
        return opt_state, {k: v.detach() for k, v in stats.items()}

    def train_iteration(self, state: TrainState, draws: IterationDraws | None = None):
        """Rollout, GAE and the PPO epochs. Returns (state', metrics): the
        episode-reward metric, the number of done events, the mean step
        reward, the loss statistics (means over minibatches, then epochs),
        the filter's solved share when the rollout filters
        (`cbf_solved_share`) and `seconds_{rollout,gae,update}` (host
        clock, the card synchronised at each phase's end)."""
        p, dev = self.parameters, self.device
        nets = (state.policy, state.critic)
        n_mb = self.n_minibatches
        t0 = time.perf_counter()

        # 1. Collect frames_per_batch = B * T frames.
        env_state, obs, ep_accum, batch, solved = self.rollout(state, draws)
        self._sync()
        t1 = time.perf_counter()

        # 2. Values and GAE with the critic before this iteration's updates.
        with torch.no_grad():
            values = state.critic(batch.obs)[..., 0]  # [T, B, N]
            next_values = state.critic(batch.next_obs)[..., 0]
            advantages, value_targets = gae(
                batch.reward, values, next_values, batch.done, self.ppo_cfg.gamma,
                self.ppo_cfg.lmbda,
            )
        self._sync()
        t2 = time.perf_counter()

        # 3. Epochs of minibatch updates over the flattened frames.
        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        data = dict(
            obs=flat(batch.obs), action=flat(batch.action), log_prob=flat(batch.log_prob),
            adv=flat(advantages), vt=flat(value_targets),
        )
        if p.is_prb:
            priorities = compute_td_error(batch.reward, values, next_values, batch.done).reshape(-1)
            data.update(
                reward=flat(batch.reward), next_obs=flat(batch.next_obs),
                done=batch.done.reshape(-1),
            )
        M = data["obs"].shape[0]
        mb_size = M // n_mb
        mb_shape = (mb_size,) + data["action"].shape[1:]
        opt_state = state.opt_state
        epoch_stats = []
        for e in range(p.num_epochs):
            if not p.is_prb:
                perm = (torch.randperm(M, generator=self.generator, device=dev)
                        if draws is None else draws.permutations[e])
            mb_stats = []
            for m in range(n_mb):
                if p.is_prb:
                    if draws is None:
                        probs = torch.softmax(PRB_ALPHA * torch.log(priorities), dim=0)
                        idx = torch.multinomial(probs, mb_size, replacement=True,
                                                generator=self.generator)
                    else:
                        idx = draws.prb_indices[e, m]
                else:
                    idx = perm[m * mb_size:(m + 1) * mb_size]
                mb = {k: v[idx] for k, v in data.items()}
                noise = (torch.randn(mb_shape, generator=self.generator, device=dev)
                         if draws is None else draws.entropy_noise[e, m])
                opt_state, stats = self.minibatch_update(nets, opt_state, mb, noise)
                if p.is_prb:
                    # Refresh the sampled frames' priorities with the
                    # updated critic.
                    with torch.no_grad():
                        td = compute_td_error(
                            mb["reward"], state.critic(mb["obs"])[..., 0],
                            state.critic(mb["next_obs"])[..., 0], mb["done"],
                        )
                    priorities[idx] = td
                mb_stats.append(stats)
            epoch_stats.append({k: torch.stack([s[k] for s in mb_stats]).mean()
                                for k in mb_stats[0]})
        self._sync()
        t3 = time.perf_counter()

        # 4. Mean episodic reward over the done events of the rollout.
        done_f = batch.done[..., None].to(batch.reward.dtype)  # [T, B, 1]
        n_done = done_f.sum() * self.env.cfg.n_agents
        ep_rew_sum = (batch.ep_reward_at_done * done_f).sum()
        episode_reward_mean = torch.where(
            n_done > 0, ep_rew_sum / torch.clamp(n_done, min=1.0),
            torch.full((), math.nan, device=dev),
        )
        metrics = {
            "episode_reward_mean": episode_reward_mean,
            "n_done": done_f.sum(),
            "reward_mean": batch.reward.mean(),
            **{k: torch.stack([s[k] for s in epoch_stats]).mean() for k in epoch_stats[0]},
            "seconds_rollout": t1 - t0,
            "seconds_gae": t2 - t1,
            "seconds_update": t3 - t2,
        }
        if solved is not None:
            metrics["cbf_solved_share"] = solved
        new_state = TrainState(
            policy=state.policy, critic=state.critic, opt_state=opt_state,
            env_state=env_state, obs=obs, ep_reward_accum=ep_accum,
            iteration=state.iteration + 1,
        )
        return new_state, metrics

    def checkpoint_params(self, state: TrainState) -> Dict[str, dict]:
        return {"policy": to_jax_params(state.policy), "critic": to_jax_params(state.critic)}

    # -------------------------------------------------------------- train
    def train(self, progress_callback: Optional[Callable[[int, dict], None]] = None):
        """Run the whole training loop. Returns (env, decision_making_module,
        optimization_module, priority_module, cbf_controllers, parameters);
        the priority module and the CBF controllers are None."""
        p = self.parameters
        state = self.initial_state()
        saver = ckpt.RewardKeyedCheckpointer(p)
        reward_history = list(self._restored_history)
        for i in range(p.n_iters):
            state, metrics = self.train_iteration(state)
            rew = float(metrics["episode_reward_mean"])
            rew = round(rew, 2) if np.isfinite(rew) else rew
            reward_history.append(rew)
            if p.is_save_intermediate_model:
                saver.maybe_save(rew, self.checkpoint_params(state), reward_history)
            if progress_callback:
                progress_callback(i, metrics)

        saver.save_final(self.checkpoint_params(state), reward_history)
        self.opt_state = state.opt_state
        return (
            self.env,
            DecisionMakingModule(state.policy, self.low, self.high),
            OptimizationModule(state.critic, self.optimizer, state.opt_state),
            None,
            None,
            p,
        )


def mappo_cavs(parameters: Parameters, device: str | torch.device | None = None):
    """Functional entry point: train, or with `is_load_model` and not
    `is_continue_train` load the best (or final) checkpoint without
    training. Returns what `MAPPOCAVs.train` returns."""
    trainer = MAPPOCAVs(parameters, device=device)
    if not parameters.is_continue_train and parameters.is_load_model:
        params = ckpt.load_best(parameters)
        dev = trainer.device
        policy = policy_from_jax_params(params["policy"], device=dev)
        critic = critic_from_jax_params(params["critic"], trainer.env.cfg.n_agents, device=dev)
        return (
            trainer.env,
            DecisionMakingModule(policy, trainer.low, trainer.high),
            OptimizationModule(critic, trainer.optimizer, trainer.optimizer.init(
                trainer.parameter_list(policy, critic))),
            None,
            None,
            parameters,
        )
    return trainer.train()
