"""MAPPO trainer for the road-traffic environment.

One training iteration is a rollout of `max_steps` env transitions over
all envs (a Python loop: plain `env.step`, or the CBF-filtered or the
margins-only step when CBF training is on), GAE, and `num_epochs` epochs
of minibatch PPO updates over a random permutation of the frames (or,
with `is_prb`, over prioritized samples). The policy acts in one pass, or
with XP-MARL (`is_using_prioritized_marl`) in priority turns with action
propagation (`rl/priority.py`), or with opponent modeling
(`is_using_opponent_modeling`, ignored under XP-MARL; `rl/opponent.py`)
in two passes. Learned priority ("marl") adds a priority actor-critic
whose Clip-PPO loss joins the policy's, under the same optimizer. Checkpointing keeps the
reward-keyed retention policy of `rl/checkpoint.py`: a checkpoint is
written only when the mean episode reward improves, lower-reward files
are deleted, and the run configuration rides along as a JSON sidecar.

Every random number an iteration consumes can be given as tensors
(`IterationDraws`), so tests can feed it the JAX package's draws; without
them they come from the trainer's generator on its device.

With a `parallel.mesh.Shard` the trainer is one of W ranks that together
run the iteration one process runs over all B envs: each rank rolls out
its B/W envs (a global `IterationDraws` is sliced to them; without draws
the env's numbers come from a generator seeded by (seed, rank)), the
minibatches are global (permutations, entropy noise and PRB samples come
from the generator every rank shares), each rank's loss sums its rows of
a minibatch over the whole minibatch's size, and the gradients are summed
over the ranks before the clipped Adam step, so every rank takes the same
step. PRB priorities are gathered over the ranks, metrics reduced, and
only rank 0 writes checkpoints.

The minibatch update of an unsharded trainer without PRB or
`debug_numerics` is one `UpdateProgram` (`rl/update_program.py`): on the
card a CUDA graph captured once per trainer and replayed for every
minibatch, the counterpart of JAX's jitted update; on the CPU, or with
`update_graph=False`, the same step run eagerly. The sharded trainer
(its rows come from a boolean mask, a dynamic shape, and its gradients
are all-reduced), PRB (its sampling and priority refresh) and
`debug_numerics` (its finiteness check reads the loss on the host) keep
the eager loop over `minibatch_update`.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.env.env import RoadTrafficEnv, make_env
from sigmarl_tpu_torch.env.reset import ResetDraws
from sigmarl_tpu_torch.env.structs import WorldState
from sigmarl_tpu_torch.parallel.mesh import Shard
from sigmarl_tpu_torch.rl import checkpoint as ckpt
from sigmarl_tpu_torch.rl.networks import (
    CentralizedCritic,
    PolicyNet,
    critic_from_jax_params,
    policy_from_jax_params,
    score_critic,
    score_policy,
    tanh_normal_mode,
    tanh_normal_sample,
    to_jax_params,
)
from sigmarl_tpu_torch.rl.opponent import opponent_modeling_policy
from sigmarl_tpu_torch.rl.optim import AdamState, ClippedAdam
from sigmarl_tpu_torch.rl.ppo import PPOConfig, gae, ppo_losses
from sigmarl_tpu_torch.rl.priority import (
    nearing_agent_indices,
    prioritized_action_propagation,
    priority_rank,
)
from sigmarl_tpu_torch.rl.update_program import UpdateProgram
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step, cbf_margin_step
from sigmarl_tpu_torch.utils.debug import assert_finite, enable_debug_numerics

Tensor = torch.Tensor

PRB_ALPHA = 0.7  # priority exponent of the prioritized replay buffer
PRIORITY_SEED = 1000  # offset of the priority networks' weight seeds


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
    prio_policy: Optional[nn.Module] = None  # learned priority (XP-MARL "marl")
    prio_critic: Optional[nn.Module] = None

    @property
    def networks(self) -> tuple:
        """The networks the optimizer updates: policy, critic and, with
        learned priority, the priority policy and critic."""
        prio = () if self.prio_policy is None else (self.prio_policy, self.prio_critic)
        return (self.policy, self.critic, *prio)


class Transition(NamedTuple):
    obs: Tensor  # [B, N, obs_policy] observation the policy acted on
    action: Tensor  # [B, N, 2]
    log_prob: Tensor  # [B, N]
    reward: Tensor  # [B, N]
    done: Tensor  # [B]
    next_obs: Tensor  # [B, N, obs] raw next observation
    ep_reward_at_done: Tensor  # [B, N] episodic reward, read where done
    # The learned-priority stream (None without it)
    prio_obs: Optional[Tensor] = None  # [B, N, obs] raw observation
    prio_scores: Optional[Tensor] = None  # [B, N]
    prio_log_prob: Optional[Tensor] = None  # [B, N]


@dataclass
class IterationDraws:
    """Every random number of one training iteration.

    action_noise: standard normals of the policy's samples: [T, B, N, 2];
        under XP-MARL [T, N, B, 2], one block per priority turn; under
        opponent modeling [T, 2, B, N, 2], the tentative and the final pass.
    reset_draws: T `ResetDraws`, one per env step (used where envs reset).
    permutations: [E, M] frame permutations, one per epoch (None with PRB).
    entropy_noise: [E, n_mb, mb, N, 2] standard normals of the entropy
        estimate, one block per minibatch.
    prb_indices: [E, n_mb, mb] sampled frames of each minibatch (PRB only).
    obs_noise: [T, B, N, obs_dim] uniforms of each env step's observation
        noise (with `is_obs_noise`).
    cbf_noise: [T, B, N, 2] uniforms of the filter's noise on its nominal
        input (a filtered or margins-only rollout with `is_obs_noise`).
    priority_noise: [T, B, N, 1] standard normals of the priority scores
        (learned priority).
    priority_perms: [T, B, N] the per-env permutations (random priority).
    communication_noise: [T, N, B, 2k] standard normals of the
        communication noise per priority turn.
    priority_entropy_noise: [E, n_mb, mb, N, 1] standard normals of the
        priority loss's entropy estimate.
    A field left None is drawn from the trainer's generator.
    """

    action_noise: Tensor
    reset_draws: Sequence[ResetDraws]
    permutations: Optional[Tensor]
    entropy_noise: Tensor
    prb_indices: Optional[Tensor] = None
    obs_noise: Optional[Tensor] = None
    cbf_noise: Optional[Tensor] = None
    priority_noise: Optional[Tensor] = None
    priority_perms: Optional[Tensor] = None
    communication_noise: Optional[Tensor] = None
    priority_entropy_noise: Optional[Tensor] = None

    def to(self, device) -> "IterationDraws":
        moved = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for k, v in moved.items():
            if v is not None:
                moved[k] = [r.to(device) for r in v] if k == "reset_draws" else v.to(device)
        return IterationDraws(**moved)


def _draw(draws: IterationDraws | None, name: str, index):
    """`draws.<name>[index]`, or None where the draws or the field are
    missing (the consumer then draws from its generator)."""
    x = None if draws is None else getattr(draws, name)
    return None if x is None else x[index]


def compute_td_error(reward, values, next_values, done, gamma: float = 0.9,
                     shard: Shard | None = None) -> Tensor:
    """Normalized TD-error priorities of the prioritized replay buffer:
    |TD error| averaged over the cooperative agents, min-max normalized to
    [1e-3, 10] (the extremes over every rank's rows with a `shard`)."""
    not_done = (~done).to(reward.dtype)[..., None]
    td = torch.abs(reward + gamma * next_values * not_done - values).mean(-1)
    if shard is None:
        lo, hi = td.min(), td.max()
    else:  # one rank may hold none of the rows
        inf = torch.full((1,), math.inf, device=td.device)
        ext = shard.all_reduce_max(torch.stack([-torch.cat([td.reshape(-1), inf]).min(),
                                                torch.cat([td.reshape(-1), -inf]).max()]))
        lo, hi = -ext[0], ext[1]
    rng = torch.clamp(hi - lo, min=1e-3)
    return torch.clamp((td - lo) / rng * 10.0, 1e-3, 10.0)


class MAPPOCAVs:
    """Multi-agent PPO trainer. Runs on `device` (by default
    `parameters.device`, "cuda"); with a `shard`, as that rank of a
    data-parallel group (its env then holds the rank's envs).

    `update_graph`: True (the default) captures the update as a CUDA
    graph on the card wherever the configuration allows it (`eager_reason`
    is None); False runs the same update eagerly on the card too, to
    compare the two. The CPU runs it eagerly."""

    def __init__(
        self,
        parameters: Parameters,
        env: Optional[RoadTrafficEnv] = None,
        device: str | torch.device | None = None,
        shard: Shard | None = None,
        update_graph: bool = True,
    ):
        self.parameters = p = parameters
        self.shard = shard
        if p.debug_numerics:
            enable_debug_numerics()
        self.env = env if env is not None else make_env(
            p, device=device if device is not None else p.device, shard=shard
        )
        if shard is not None and self.env.shard is not shard:
            raise ValueError("a sharded trainer needs an env built with the same shard")
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

        # XP-MARL pads the policy's observation with k * 2 columns for the
        # propagated actions; opponent modeling's pad is part of cfg.obs_dim.
        self.use_prio = p.is_using_prioritized_marl
        self.use_om = p.is_using_opponent_modeling and not self.use_prio
        self.prio_method = p.prioritization_method.lower()
        if self.use_prio and self.prio_method not in ("marl", "random"):
            raise ValueError(f"unknown prioritization_method {p.prioritization_method!r}")
        self.k_nearing = cfg.n_nearing_agents_observed
        self.pad_extra = 2 * self.k_nearing if self.use_prio else 0
        self.policy_obs_dim = cfg.obs_dim + self.pad_extra
        self.communication_noise_level = (
            p.communication_noise_level if p.is_communication_noise else 0.0
        )

        self.policy_net = PolicyNet(self.policy_obs_dim, 2, device=dev, seed=2 * p.random_seed)
        self.critic_net = CentralizedCritic(
            self.policy_obs_dim, cfg.n_agents, device=dev, seed=2 * p.random_seed + 1
        )
        self.prio_policy_net = self.prio_critic_net = None
        if self.use_prio and self.prio_method == "marl":
            seed = PRIORITY_SEED + 2 * p.random_seed
            self.prio_policy_net = score_policy(cfg.obs_dim, device=dev, seed=seed)
            self.prio_critic_net = score_critic(
                cfg.obs_dim, cfg.n_agents, device=dev, seed=seed + 1
            )
        self.low = -self.env.action_limits
        self.high = self.env.action_limits
        # The generator every rank shares (permutations, entropy noise, PRB
        # samples) and the one of this rank's envs (rollout draws); one and
        # the same without a shard.
        self.generator = torch.Generator(device=dev).manual_seed(p.random_seed)
        self.env_generator = self.generator
        if shard is not None:
            seed = int(np.random.SeedSequence([p.random_seed, shard.rank]).generate_state(1)[0])
            self.env_generator = torch.Generator(device=dev).manual_seed(seed)

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

        # The update's form, by configuration: the eager loop where rows or
        # steps depend on the data or the host reads the loss, else one
        # program, captured on the card.
        self.eager_reason = (
            "sharded" if shard is not None else "prb" if p.is_prb
            else "debug_numerics" if p.debug_numerics else None
        )
        self.update_graph = update_graph and dev.type == "cuda" and self.eager_reason is None
        self.program: Optional[UpdateProgram] = None

    def networks(self) -> tuple:
        """The trainer's networks: policy, critic and, with learned
        priority, the priority policy and critic."""
        prio = () if self.prio_policy_net is None else (self.prio_policy_net, self.prio_critic_net)
        return (self.policy_net, self.critic_net, *prio)

    def parameter_list(self, *nets: nn.Module) -> List[Tensor]:
        """The parameters of `nets` in order (the trainer's networks when
        none are given): the tensors the optimizer updates."""
        return [t for net in (nets or self.networks()) for t in net.parameters()]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            trace.count_sync(self.device)

    # ------------------------------------------------------------ rollout
    def env_transition(
        self, env_state: WorldState, action: Tensor, reset_draws=None, cbf_noise=None,
        obs_noise=None,
    ):
        """One env step of the rollout, through the filter the flags ask for."""
        p, env, cbf = self.parameters, self.env, self.cbf_filter
        kw = dict(generator=self.env_generator, reset_draws=reset_draws, obs_noise=obs_noise)
        if p.is_using_cbf_training and cbf is not None:
            if p.is_solve_qp and p.is_apply_cbf_action:
                return cbf_filtered_step(env, cbf, env_state, action, cbf_noise=cbf_noise, **kw)
            return cbf_margin_step(env, cbf, env_state, action, cbf_noise=cbf_noise, **kw)
        return env.step(env_state, action, **kw)

    def initial_state(
        self, reset_draws: ResetDraws | None = None, obs_noise: Tensor | None = None
    ) -> TrainState:
        """A fresh episode in every env, and the trainer's networks. With a
        shard, global draws are sliced to the rank's envs."""
        if self.shard is not None:
            sl = self.shard.env_slice(self.parameters.num_vmas_envs)
            reset_draws = None if reset_draws is None else reset_draws.for_envs(sl)
            obs_noise = None if obs_noise is None else obs_noise[sl]
        env_state, obs = self.env.reset(
            generator=self.env_generator, draws=reset_draws, obs_noise=obs_noise
        )
        B, N = obs.shape[:2]
        return TrainState(
            policy=self.policy_net,
            critic=self.critic_net,
            opt_state=self.opt_state,
            env_state=env_state,
            obs=obs,
            ep_reward_accum=torch.zeros((B, N), device=self.device),
            iteration=0,
            prio_policy=self.prio_policy_net,
            prio_critic=self.prio_critic_net,
        )

    def _pad(self, obs: Tensor) -> Tensor:
        """The policy's observation: `obs` with XP-MARL's zero tail."""
        return nn.functional.pad(obs, (0, self.pad_extra)) if self.pad_extra else obs

    def act(self, state: TrainState, env_state: WorldState, obs: Tensor, draws=None, t: int = 0):
        """The policy's actions in the rollout's mode. Returns (action,
        log_prob, the observation each agent acted on, priority scores and
        their log-probabilities (None without learned priority)). Under
        XP-MARL the rank and the turns are the spans `.priority` and
        `.turns` (`train.rollout.act.priority`, `train.rollout.act.turns`
        in an iteration)."""
        low, high, gen = self.low, self.high, self.env_generator
        noise = _draw(draws, "action_noise", t)
        if self.use_prio:
            with trace.span(".priority"):
                prio = priority_rank(
                    self.prio_method, state.prio_policy, obs, gen,
                    noise=_draw(draws, "priority_noise", t),
                    perms=_draw(draws, "priority_perms", t),
                )
            with trace.span(".turns"):
                ap = prioritized_action_propagation(
                    state.policy, self._pad(obs), prio.rank,
                    nearing_agent_indices(env_state.d_agents, self.k_nearing), low, high, gen,
                    action_noise=noise, communication_noise_level=self.communication_noise_level,
                    communication_noise=_draw(draws, "communication_noise", t),
                )
            if state.prio_policy is None:
                return ap.actions, ap.log_prob, ap.obs_used, None, None
            return ap.actions, ap.log_prob, ap.obs_used, prio.scores, prio.log_prob
        if self.use_om:
            om = opponent_modeling_policy(
                state.policy, obs, nearing_agent_indices(env_state.d_agents, self.k_nearing),
                low, high, gen, action_noise=noise,
            )
            return om.actions, om.log_prob, om.obs_used, None, None
        loc, scale = state.policy(obs)
        action, log_prob = tanh_normal_sample(loc, scale, low, high, generator=gen, noise=noise)
        return action, log_prob, obs, None, None

    def local_draws(self, draws: IterationDraws | None) -> IterationDraws | None:
        """The draws of this rank's rollout: every field with an env axis
        sliced to the rank's envs; the update's fields stay global."""
        if self.shard is None or draws is None:
            return draws
        sl = self.shard.env_slice(self.parameters.num_vmas_envs)

        def cut(x, axis):
            return None if x is None else x[(slice(None),) * axis + (sl,)]

        # Action noise: [T, B, ...]; per priority turn [T, N, B, 2]; the
        # opponent-modeling passes [T, 2, B, N, 2].
        act_axis = 2 if (self.use_prio or self.use_om) else 1
        return dataclasses.replace(
            draws,
            action_noise=cut(draws.action_noise, act_axis),
            reset_draws=[r.for_envs(sl) for r in draws.reset_draws],
            obs_noise=cut(draws.obs_noise, 1),
            cbf_noise=cut(draws.cbf_noise, 1),
            priority_noise=cut(draws.priority_noise, 1),
            priority_perms=cut(draws.priority_perms, 1),
            communication_noise=cut(draws.communication_noise, 2),
        )

    @torch.no_grad()
    def rollout(self, state: TrainState, draws: IterationDraws | None = None):
        """`max_steps` transitions of every env (of the rank's envs with a
        shard, from draws already sliced by `local_draws`). Returns
        (env_state, obs, ep_reward_accum, batch, solved) with the batch's
        fields stacked to [T, ...] and `solved` the filter's solved flags
        [T, B] (None without a filtered step). A step's acting and its env
        transition are the spans `.act` and `.transition`
        (`train.rollout.act`, `train.rollout.transition` in an iteration)."""
        env_state, obs, ep_accum = state.env_state, state.obs, state.ep_reward_accum
        steps: List[Transition] = []
        solved = []
        for t in range(self.parameters.max_steps):
            with trace.span(".act"):
                action, log_prob, obs_ppo, scores, scores_lp = self.act(
                    state, env_state, obs, draws, t)
            with trace.span(".transition"):
                env_state, next_obs, reward, done, info = self.env_transition(
                    env_state, action, _draw(draws, "reset_draws", t),
                    cbf_noise=_draw(draws, "cbf_noise", t), obs_noise=_draw(draws, "obs_noise", t),
                )
            if "cbf_solved" in info:
                solved.append(info["cbf_solved"])
            ep_accum = ep_accum + reward
            ep_at_done = ep_accum
            ep_accum = torch.where(done[:, None], torch.zeros_like(ep_accum), ep_accum)
            steps.append(Transition(
                obs_ppo, action, log_prob, reward, done, next_obs, ep_at_done,
                None if scores is None else obs, scores, scores_lp,
            ))
            obs = next_obs
        batch = Transition(*(None if f[0] is None else torch.stack(f) for f in zip(*steps)))
        return env_state, obs, ep_accum, batch, torch.stack(solved) if solved else None

    # ------------------------------------------------------------- update
    def loss(self, nets, mb: Dict[str, Tensor], entropy_noise: Tensor,
             prio_entropy_noise: Tensor | None = None, count: int | None = None):
        """The PPO loss of a minibatch (obs, action, log_prob, adv, vt) and
        its statistics. `nets` = (policy, critic) or, with learned priority,
        (policy, critic, priority policy, priority critic): then the
        priority's Clip-PPO loss on its score stream (prio_obs,
        prio_scores, prio_log_prob, prio_adv, prio_vt), with its own
        entropy noise [mb, N, 1], is added and reported as
        `loss_priority`. With `count`, `mb` holds one rank's rows of a
        minibatch of `count` rows (`ppo_losses`)."""
        policy, critic = nets[:2]
        loc, scale = policy(mb["obs"])
        v = critic(mb["obs"])[..., 0]
        total, stats = ppo_losses(
            loc, scale, v, mb["action"], mb["log_prob"], mb["adv"], mb["vt"],
            self.low, self.high, self.ppo_cfg, entropy_noise, count,
        )
        if len(nets) > 2:
            prio_policy, prio_critic = nets[2:]
            p_loc, p_scale = prio_policy(mb["prio_obs"])
            p_v = prio_critic(mb["prio_obs"])[..., 0]
            one = torch.ones((1,), device=p_v.device)
            p_total, _ = ppo_losses(
                p_loc, p_scale, p_v, mb["prio_scores"][..., None], mb["prio_log_prob"],
                mb["prio_adv"], mb["prio_vt"], -one, one, self.ppo_cfg, prio_entropy_noise, count,
            )
            total = total + p_total
            stats = {**stats, "loss_priority": p_total}
        return total, stats

    def minibatch_update(self, nets, opt_state: AdamState, mb, entropy_noise,
                         prio_entropy_noise: Tensor | None = None, count: int | None = None):
        """One PPO gradient step on a minibatch. `nets` as in `loss`,
        updated in place. Returns (opt_state, loss stats). Under
        `debug_numerics` a non-finite loss raises before the step. With a
        shard, `mb` holds the rank's rows of a minibatch of `count` rows,
        and the gradients are summed over the ranks before the step."""
        opt_state, stats = self.gradient_step(
            nets, mb, entropy_noise, prio_entropy_noise, count,
            lambda params, grads: self.optimizer.step(params, grads, opt_state),
        )
        return opt_state, {k: v.detach() for k, v in stats.items()}

    def gradient_step(self, nets, mb, entropy_noise, prio_entropy_noise, count, step):
        """The loss of a minibatch (`loss`), its gradients (summed over the
        ranks with a shard) and `step(params, grads)`, the optimizer's step:
        the sequence `minibatch_update` and `UpdateProgram.step` share.
        Returns (what `step` returns, the loss statistics). Under
        `debug_numerics` a non-finite loss raises before the step."""
        params = self.parameter_list(*nets)
        total, stats = self.loss(nets, mb, entropy_noise, prio_entropy_noise, count)
        if self.parameters.debug_numerics:
            assert_finite(total.detach(), "ppo_loss")
        grads = torch.autograd.grad(total, params)
        if self.shard is not None:
            grads = self.shard.all_reduce_grads(grads)
        return step(params, grads), stats

    def frames(self, state: TrainState, batch: Transition):
        """Values and GAE with the critic before this iteration's updates,
        and the rollout's frames flattened to [T * B, ...]: (data, the PRB
        priorities or None). With PRB the data also holds the reward, the
        next observation and the done flags (the priorities' refresh), and
        the priorities are over every rank's frames."""
        p, shard = self.parameters, self.shard
        gamma, lmbda = self.ppo_cfg.gamma, self.ppo_cfg.lmbda
        with torch.no_grad():
            values = state.critic(batch.obs)[..., 0]  # [T, B, N]
            next_values = state.critic(self._pad(batch.next_obs))[..., 0]
            advantages, value_targets = gae(
                batch.reward, values, next_values, batch.done, gamma, lmbda
            )
            if state.prio_critic is not None:
                prio_adv, prio_vt = gae(
                    batch.reward, state.prio_critic(batch.prio_obs)[..., 0],
                    state.prio_critic(batch.next_obs)[..., 0], batch.done, gamma, lmbda,
                )

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        data = dict(
            obs=flat(batch.obs), action=flat(batch.action), log_prob=flat(batch.log_prob),
            adv=flat(advantages), vt=flat(value_targets),
        )
        if state.prio_critic is not None:
            data.update(
                prio_obs=flat(batch.prio_obs), prio_scores=flat(batch.prio_scores),
                prio_log_prob=flat(batch.prio_log_prob), prio_adv=flat(prio_adv),
                prio_vt=flat(prio_vt),
            )
        priorities = None
        if p.is_prb:
            priorities = compute_td_error(batch.reward, values, next_values, batch.done,
                                          shard=shard)
            data.update(
                reward=flat(batch.reward), next_obs=flat(batch.next_obs),
                done=batch.done.reshape(-1),
            )
            if shard is not None:  # global frame order t * B + b
                priorities = shard.all_gather(priorities[None]).permute(1, 0, 2)
            priorities = priorities.reshape(-1)
        return data, priorities

    def update(self, state: TrainState, data: Dict[str, Tensor],
               draws: IterationDraws | None = None, priorities: Tensor | None = None):
        """The iteration's epochs of minibatch updates over `data` (as
        `frames` gives it), on the networks and optimizer state of `state`
        in place. Returns (the optimizer state after them, the loss
        statistics: means over the minibatches, then the epochs)."""
        if self.eager_reason is None:
            return self._update_program(state, data, draws)
        return self._update_loop(state, data, draws, priorities)

    def update_program(self, state: TrainState, data: Dict[str, Tensor]) -> UpdateProgram:
        """The `UpdateProgram` of the networks and moments of `state` and
        frames shaped like `data`: built (and on the card captured) once,
        and again only when those tensors or the frames' layout change."""
        nets, opt_state = state.networks, state.opt_state
        prog = self.program
        if prog is None or prog.key != UpdateProgram.key_of(self, nets, opt_state, data):
            prog = self.program = UpdateProgram(
                self, nets, opt_state, data, self.updates_per_iter,
                data["action"].shape[0] // self.n_minibatches)
        if self.update_graph and prog.graph is None:
            prog.begin(data, opt_state.count)
            prog.capture()
        return prog

    def _update_program(self, state: TrainState, data, draws):
        """The update through `update_program`: the host draws the numbers
        and fills the buffers, the program (a graph replay on the card)
        does each minibatch."""
        p, dev = self.parameters, self.device
        opt_state = state.opt_state
        n_mb = self.n_minibatches
        M = data["action"].shape[0]
        mb_size = M // n_mb
        prog = self.update_program(state, data)
        prog.begin(data, opt_state.count)
        mb_shape = (mb_size,) + data["action"].shape[1:]
        for e in range(p.num_epochs):
            perm = (torch.randperm(M, generator=self.generator, device=dev)
                    if draws is None else draws.permutations[e])
            for m in range(n_mb):
                noise = _draw(draws, "entropy_noise", (e, m))
                if noise is None:
                    noise = torch.randn(mb_shape, generator=self.generator, device=dev)
                prio_noise = None
                if state.prio_policy is not None:
                    prio_noise = _draw(draws, "priority_entropy_noise", (e, m))
                    if prio_noise is None:
                        prio_noise = torch.randn(mb_shape[:-1] + (1,), generator=self.generator,
                                                 device=dev)
                prog.run(perm[m * mb_size:(m + 1) * mb_size], noise, prio_noise)
        opt_state = AdamState(opt_state.count + self.updates_per_iter, prog.mu, prog.nu)
        return opt_state, prog.loss_stats(p.num_epochs, n_mb)

    def _update_loop(self, state: TrainState, data, draws, priorities):
        """The update as an eager loop over `minibatch_update`: the sharded,
        PRB and `debug_numerics` trainers' form."""
        p, dev, shard = self.parameters, self.device, self.shard
        nets = state.networks
        n_mb = self.n_minibatches
        # Frames are indexed t * B + b over every env; a rank holds the
        # frames of its envs at t * B_local + (b - first env).
        T = p.max_steps
        B_local = data["action"].shape[0] // T
        B = B_local * (1 if shard is None else shard.world)
        M = T * B
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
                    idx = _draw(draws, "prb_indices", (e, m))
                    if idx is None:
                        probs = torch.softmax(PRB_ALPHA * torch.log(priorities), dim=0)
                        idx = torch.multinomial(probs, mb_size, replacement=True,
                                                generator=self.generator)
                else:
                    idx = perm[m * mb_size:(m + 1) * mb_size]
                noise = _draw(draws, "entropy_noise", (e, m))
                if noise is None:
                    noise = torch.randn(mb_shape, generator=self.generator, device=dev)
                prio_noise = None
                if state.prio_policy is not None:
                    prio_noise = _draw(draws, "priority_entropy_noise", (e, m))
                    if prio_noise is None:
                        prio_noise = torch.randn(mb_shape[:-1] + (1,), generator=self.generator,
                                                 device=dev)
                rows = local_idx = None
                if shard is not None:  # this rank's rows of the minibatch
                    env, t_idx = idx % B, idx // B
                    rows = (env // B_local) == shard.rank
                    local_idx = t_idx[rows] * B_local + env[rows] - shard.rank * B_local
                    noise = noise[rows]
                    prio_noise = None if prio_noise is None else prio_noise[rows]
                mb = {k: v[idx if shard is None else local_idx] for k, v in data.items()}
                opt_state, stats = self.minibatch_update(
                    nets, opt_state, mb, noise, prio_noise, None if shard is None else mb_size)
                if p.is_prb:
                    # Refresh the sampled frames' priorities with the
                    # updated critic.
                    with torch.no_grad():
                        td = compute_td_error(
                            mb["reward"], state.critic(mb["obs"])[..., 0],
                            state.critic(self._pad(mb["next_obs"]))[..., 0], mb["done"],
                            shard=shard,
                        )
                    if shard is not None:  # each row from the rank that holds it
                        td = shard.all_reduce_sum(
                            torch.zeros(mb_size, device=dev).masked_scatter(rows, td))
                    priorities[idx] = td
                mb_stats.append(stats)
            epoch_stats.append({k: torch.stack([s[k] for s in mb_stats]).mean()
                                for k in mb_stats[0]})
        return opt_state, {k: torch.stack([s[k] for s in epoch_stats]).mean()
                           for k in epoch_stats[0]}

    def train_iteration(self, state: TrainState, draws: IterationDraws | None = None):
        """Rollout, GAE and the PPO epochs. Returns (state', metrics): the
        episode-reward metric, the number of done events, the mean step
        reward, the loss statistics (means over minibatches, then epochs),
        the filter's solved share when the rollout filters
        (`cbf_solved_share`) and `seconds_{rollout,gae,update}` (host
        clock, the card synchronised at each phase's end). With a shard,
        `draws` are global and the metrics are over every rank's envs."""
        p, dev, shard = self.parameters, self.device, self.shard
        t0 = time.perf_counter()

        # 1. Collect frames_per_batch = B * T frames.
        with trace.span("train.rollout"):
            env_state, obs, ep_accum, batch, solved = self.rollout(state, self.local_draws(draws))
            self._sync()
        t1 = time.perf_counter()

        # 2. Values and GAE with the critic before this iteration's updates.
        with trace.span("train.gae"):
            data, priorities = self.frames(state, batch)
            self._sync()
        t2 = time.perf_counter()

        # 3. Epochs of minibatch updates over the flattened frames.
        with trace.span("train.update"):
            opt_state, loss_stats = self.update(state, data, draws, priorities)
            if state.opt_state.mu is self.opt_state.mu:  # the trainer's moments moved in place
                self.opt_state = opt_state
            self._sync()
        t3 = time.perf_counter()

        # 4. Mean episodic reward over the done events of the rollout.
        M = batch.reward.shape[0] * batch.reward.shape[1] * (1 if shard is None else shard.world)
        done_f = batch.done[..., None].to(batch.reward.dtype)  # [T, B, 1]
        n_done = done_f.sum()
        ep_rew_sum = (batch.ep_reward_at_done * done_f).sum()
        if shard is None:
            reward_mean = batch.reward.mean()
            solved_share = None if solved is None else torch.stack(
                [s.float().mean() for s in solved]).mean()
        else:  # sums over every rank's envs; the loss terms are partial sums
            sums = shard.all_reduce_sum(torch.stack([
                n_done, ep_rew_sum, batch.reward.sum(),
                torch.zeros((), device=dev) if solved is None else solved.float().sum(),
                *loss_stats.values()]))
            n_done, ep_rew_sum = sums[0], sums[1]
            reward_mean = sums[2] / (M * batch.reward.shape[-1])
            solved_share = None if solved is None else sums[3] / M
            loss_stats = dict(zip(loss_stats, sums[4:]))
        n_agent_done = n_done * self.env.cfg.n_agents
        episode_reward_mean = torch.where(
            n_agent_done > 0, ep_rew_sum / torch.clamp(n_agent_done, min=1.0),
            torch.full((), math.nan, device=dev),
        )
        metrics = {
            "episode_reward_mean": episode_reward_mean,
            "n_done": n_done,
            "reward_mean": reward_mean,
            **loss_stats,
            "seconds_rollout": t1 - t0,
            "seconds_gae": t2 - t1,
            "seconds_update": t3 - t2,
        }
        if solved_share is not None:
            metrics["cbf_solved_share"] = solved_share
        new_state = TrainState(
            policy=state.policy, critic=state.critic, opt_state=opt_state,
            env_state=env_state, obs=obs, ep_reward_accum=ep_accum,
            iteration=state.iteration + 1, prio_policy=state.prio_policy,
            prio_critic=state.prio_critic,
        )
        return new_state, metrics

    def challenge_counts(self) -> Tensor:
        """The challenge buffer's (records, replays) since the env was
        built, over every rank's envs with a shard."""
        c = self.env.challenge_counts
        return c if self.shard is None else self.shard.all_reduce_sum(c)

    def checkpoint_params(self, state: TrainState) -> Dict[str, dict]:
        return {"policy": to_jax_params(state.policy), "critic": to_jax_params(state.critic)}

    # -------------------------------------------------------------- train
    def train(self, progress_callback: Optional[Callable[[int, dict], None]] = None):
        """Run the whole training loop. Returns (env, decision_making_module,
        optimization_module, priority_module, cbf_controllers, parameters);
        the priority module and the CBF controllers are None. Checkpoints
        hold the policy and the critic only."""
        p = self.parameters
        state = self.initial_state()
        # Every rank holds the same networks; rank 0 writes them.
        writes = self.shard is None or self.shard.rank == 0
        saver = ckpt.RewardKeyedCheckpointer(p)
        reward_history = list(self._restored_history)
        for i in range(p.n_iters):
            state, metrics = self.train_iteration(state)
            rew = float(metrics["episode_reward_mean"])
            rew = round(rew, 2) if np.isfinite(rew) else rew
            reward_history.append(rew)
            if p.is_save_intermediate_model and writes:
                saver.maybe_save(rew, self.checkpoint_params(state), reward_history)
            if progress_callback:
                progress_callback(i, metrics)

        if writes:
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
