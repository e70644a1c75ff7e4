"""Rank functions of `tests/test_torch_parallel.py`, run by
`sigmarl_tpu_torch.parallel.dryrun.spawn_ranks` in spawned processes.
This module imports no JAX: the processes import it by name."""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

import sigmarl_tpu_torch.config as tcfg
from sigmarl_tpu_torch.env.env import RoadTrafficEnv, make_env
from sigmarl_tpu_torch.parallel.mesh import Shard, gather_world_state, shard_world_state
from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs, TrainState
from sigmarl_tpu_torch.rl.networks import critic_from_jax_params, policy_from_jax_params
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step


def make_trainer(kw: dict, env_changes: dict, shard=None) -> MAPPOCAVs:
    """A trainer on the CPU from `Parameters(**kw)`, its env's config
    changed by `env_changes` (settings `Parameters` does not carry)."""
    env = make_env(tcfg.Parameters(**kw), device="cpu", shard=shard)
    env = RoadTrafficEnv(dataclasses.replace(env.cfg, **env_changes), env.tables, env.device,
                         shard)
    return MAPPOCAVs(tcfg.Parameters(**kw), env=env, shard=shard)


def start_state(tr: MAPPOCAVs, start, shard=None) -> TrainState:
    """The iteration's start: ("reset", global ResetDraws) resets the env
    from those draws with the trainer's own weights; ("state", global env
    state, obs, flax-layout policy and critic weights) starts there. With
    a shard, from this rank's envs."""
    if start[0] == "reset":
        return tr.initial_state(reset_draws=start[1])
    _, env_state, obs, policy_params, critic_params = start
    if shard is not None:
        env_state = shard_world_state(env_state, shard.rank, shard.world)
        obs = obs[shard.env_slice(obs.shape[0])]
    policy = policy_from_jax_params(policy_params, device="cpu")
    critic = critic_from_jax_params(critic_params, tr.env.cfg.n_agents, device="cpu")
    return TrainState(
        policy=policy, critic=critic,
        opt_state=tr.optimizer.init(list(policy.parameters()) + list(critic.parameters())),
        env_state=env_state, obs=obs, ep_reward_accum=torch.zeros(obs.shape[:2]), iteration=0)


def flat_parameters(state: TrainState) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for n in state.networks for t in n.parameters()])


def iteration_rank(shard, device, kw, env_changes, start, draws, step=None, pair=None):
    """With `step` = (global state, actions, reset draws), first one
    sharded `cbf_filtered_step` from that state; then one training
    iteration on this rank's envs from `start` (see `start_state`) with
    the global `draws`; with `pair` = (kw, start, draws), then one more
    iteration on ranks 0 and 1 in a group of their own (under "xpmarl").
    Returns the gathered results: the step's outputs, the iteration's
    state, obs, metrics and challenge counts, and this rank's
    parameters."""
    tr = make_trainer(kw, env_changes, shard)
    out = {}
    if step is not None:
        s0, act, rd = step
        sl = shard.env_slice(act.shape[0])
        s1, o1, r1, d1, info = cbf_filtered_step(
            tr.env, tr.cbf_filter, shard_world_state(s0, shard.rank, shard.world), act[sl],
            reset_draws=rd.for_envs(sl))
        out["step"] = dict(state=gather_world_state(s1, shard), obs=shard.all_gather(o1),
                           reward=shard.all_gather(r1), done=shard.all_gather(d1),
                           solved=shard.all_gather(info["cbf_solved"]))
    new, m = tr.train_iteration(start_state(tr, start, shard), draws)
    out.update(
        env_state=gather_world_state(new.env_state, shard),
        obs=shard.all_gather(new.obs),
        metrics={k: float(v) for k, v in m.items() if not k.startswith("seconds")},
        params=flat_parameters(new),
        challenge_counts=tr.challenge_counts(),
    )
    if pair is not None:
        group = dist.new_group([0, 1])  # every rank takes part in creating it
        if shard.rank < 2:
            out["xpmarl"] = iteration_rank(Shard(shard.rank, 2, group), device, pair[0], {},
                                           pair[1], pair[2])
    return out


def collide(state, envs):
    """`state` with agent 1 put 2 cm from agent 0 in `envs` (a port
    state): those envs collide in the next step."""
    from sigmarl_tpu_torch.env.structs import replace_state

    pos = state.pos.clone()
    pos[envs, 1] = pos[envs, 0] + torch.tensor([0.02, 0.0])
    return replace_state(state, pos=pos)


def env_steps_rank(shard, device, kw, state, actions, draws, colliding):
    """Env steps on this rank's envs of the global `state`: before step t
    the envs `colliding[t]` (global indices) collide, then the step runs
    with the global actions [B, N, 2] and reset draws cut to the rank.
    Returns the gathered state, obs, reward and done of every step, the
    collectives each step called, and this rank's (reset, compacted,
    full-width) reset-step counts."""
    env = make_env(tcfg.Parameters(**kw), device=str(device), shard=shard)
    B = state.pos.shape[0]
    sl = shard.env_slice(B)
    s = shard_world_state(state, shard.rank, shard.world)
    steps, calls = [], []
    real = {name: getattr(dist, name) for name in ("all_gather", "all_reduce", "broadcast")}

    def counted(name):
        def call(*args, **kwargs):
            calls[-1].append(name)
            return real[name](*args, **kwargs)
        return call

    for act, rd, envs in zip(actions, draws, colliding):
        local = [e - sl.start for e in envs if sl.start <= e < sl.stop]
        calls.append([])
        for name in real:
            setattr(dist, name, counted(name))
        try:
            s, obs, rew, done, _ = env.step(collide(s, local), act[sl],
                                            reset_draws=rd.for_envs(sl))
        finally:
            for name, fn in real.items():
                setattr(dist, name, fn)
        steps.append(dict(state=gather_world_state(s, shard), obs=shard.all_gather(obs),
                          reward=shard.all_gather(rew), done=shard.all_gather(done)))
    return dict(steps=steps, collectives=calls,
                counts=(env.reset_steps, env.compact_reset_steps, env.full_reset_steps))
