"""The main path's throughput on the card: CBF-QP-filtered env-steps/s.

    python -m sigmarl_tpu_torch.bench [--batch B] [--chunk 1024]
        [--newton_iters 5] [--soft_iters 3] [--grouped | --census]
        [--device cuda]

The counterpart of the JAX package's `bench.py`. The main path is one
CBF-QP-filtered step of cpm_entire with N=15 agents: the 3x256 policy with
weights from seed 0 samples an action, the centralized filter (3 circles
per vehicle, RL nominal controller, 3 stiffness-ladder and 5 full-stiffness
Newton iterations, warm-started from the previous step) corrects it, and
the env steps. A chunk is T=32 such steps; the warm-up chunk starts from
the all-zero state, whose first step resets every env at full width (the
env's own reset, as JAX's in-graph auto-reset), then 5 chunks are timed:
B * T * 5 env-steps over the host's wall time, with one synchronize at the
end, and each chunk's rate from CUDA events recorded at chunk boundaries
(no extra sync).

With no `--batch`, both framings run: B = `--chunk` (1024, the headline)
and 4 sub-batches of `--chunk` envs (4 x 1024 = 4096), which keeps 4
independent states on one env and one filter and steps them in turn at
every step, as the JAX bench's `lax.map` does: each sub-batch draws from
its own generator (sub-batch s from seed s), the reset compaction's budget
is per sub-batch (3 * 1024 / 8 = 384 envs), and both kernels launch once
per sub-batch per step. A `--batch` that is a multiple of `--chunk` above
it runs as sub-batches the same way. The last line is one JSON object:
`{"metric": "cbf_filtered_env_steps_per_s_15agents_cpm", "value", "unit",
"detail": {...}}`; `detail.b4096_*` is the second framing.

`--grouped` prints one line each for the plain and the grouped filter
(groups of at most 4, 18 rows per pair) at B=1024, as the JAX package's
`scripts/bench_grouped.py`. `--census` (its `scripts/measure_resets.py`)
runs 64 untimed steps after the warm-up chunk and prints the distribution
of resetting envs per step and the share of steps that took each branch of
the reset (none, compacted, full width). Its draws come from a host
generator, moved to the card, so the card starts from the CPU's instances;
the two rollouts part within a few steps all the same, where the filter's
float32 solve turns rounding differences into millimetres
(`utils/census_parity.py`). The timed runs draw on the card: drawn on the
host, the rate at B=1024 fell from 55,158-60,051 to 33,645-37,014
env-steps/s on an H100 (700 W).

`--n_agents`, `--steps` (T) and `--chunks` cut the run for the CPU
(`--device cpu`, where the kernels run their plain versions): for example
`--device cpu --chunk 4 --n_agents 4 --steps 2 --chunks 1`. Without a card
and without `--device cpu` the program raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.device import device_line, normal, resolve_device, synchronize
from sigmarl_tpu_torch.env.env import make_env
from sigmarl_tpu_torch.env.reset import compact_slots
from sigmarl_tpu_torch.env.structs import zero_state
from sigmarl_tpu_torch.rl.networks import PolicyNet, tanh_normal_sample
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step

METRIC = "cbf_filtered_env_steps_per_s_15agents_cpm"
N_AGENTS, CHUNK, T_STEPS, N_CHUNKS, SUB_BATCHES = 15, 1024, 32, 5, 4
CENSUS_STEPS = 64
# The census's thresholds of resetting envs per step (JAX's).
CENSUS_THRESHOLDS = (8, 16, 32, 64, 128)


def main_path(batch: int, n_agents: int, device, newton_iters: int = 5, soft_iters: int = 3,
              grouped: bool = False, draws_on=None):
    """The main path at `batch` envs: (env, filter, policy, generator from
    seed 0 on `draws_on` (by default the device), the all-zero state, zero
    observations). cpm_entire, no
    observation noise, no MTV distance, no episode-end resets; the
    centralized filter at `soft_iters` + `newton_iters` iterations, with
    groups of at most 4 agents if `grouped`; the 3x256 policy from seed 0."""
    dev = resolve_device(device)
    p = Parameters(
        scenario_type="cpm_entire", n_agents=n_agents, num_vmas_envs=batch, dt=0.1,
        max_steps=1_000_000, is_use_mtv_distance=False, is_obs_noise=False,
        is_using_cbf_testing=True, is_using_centralized_cbf=True,
    )
    env = make_env(p, device=dev)
    cbf = CBFSafetyFilter(
        CBFConfig(n_agents=n_agents, n_circles=3, dt=0.1, newton_iters=newton_iters,
                  newton_soft_iters=soft_iters),
        env.cfg, env.tables, max_group_size=4 if grouped else 0, device=dev,
    )
    policy = PolicyNet(env.obs_dim, device=dev, seed=0)
    gen = torch.Generator(device=draws_on or dev).manual_seed(0)
    state = zero_state(env.cfg, dev)
    obs = torch.zeros((batch, n_agents, env.obs_dim), device=dev)
    return env, cbf, policy, gen, state, obs


def policy_actions(env, policy, obs, gen):
    """The policy's sampled actions at `obs`, noise from `gen` (drawn on
    the generator's device and moved)."""
    lim = env.action_limits
    with torch.no_grad():
        loc, scale = policy(obs)
        act, _ = tanh_normal_sample(loc, scale, -lim, lim, noise=normal(loc.shape, gen, loc.device))
    return act


def filtered_step(env, cbf, policy, state, obs, gen):
    """One step of the main path: (state', obs', reward, done)."""
    act = policy_actions(env, policy, obs, gen)
    state, obs, rew, done, _ = cbf_filtered_step(env, cbf, state, act, generator=gen)
    return state, obs, rew, done


def rollout_chunk(env, cbf, policy, states: list, obs: list, gens: list, T: int):
    """T filtered steps of every sub-batch, the sub-batches in turn at
    every step, sub-batch s drawing from `gens[s]`. Returns the new states
    and observations, the mean reward (a tensor on the device: no sync)
    and the done flags of every step and sub-batch ([T][n_sub] tensors
    [B])."""
    states, obs = list(states), list(obs)
    reward = torch.zeros((), device=obs[0].device)
    dones = []
    for _ in range(T):
        step_dones = []
        for s, gen in enumerate(gens):
            states[s], obs[s], rew, done = filtered_step(env, cbf, policy, states[s], obs[s], gen)
            reward = reward + rew.mean()
            step_dones.append(done)
        dones.append(step_dones)
    return states, obs, reward / (T * len(gens)), dones


def _stamp(dev):
    """A point in time: a CUDA event recorded on the card's queue, or the
    host's clock on the CPU."""
    if dev.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _seconds(a, b) -> float:
    return a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event) else b - a


def sub_batches(env, state, obs, gen, n_sub: int):
    """`n_sub` independent starts on `env`: the given one, then the
    all-zero state with generators from seeds 1 .. n_sub - 1."""
    dev = obs.device
    states = [state] + [zero_state(env.cfg, dev) for _ in range(1, n_sub)]
    obs = [obs] + [torch.zeros_like(obs) for _ in range(1, n_sub)]
    gens = [gen] + [torch.Generator(device=gen.device).manual_seed(s) for s in range(1, n_sub)]
    return states, obs, gens


def _check_finite(states, obs, reward) -> None:
    finite = torch.isfinite(reward)
    for s, o in zip(states, obs):
        finite &= torch.isfinite(o).all() & torch.isfinite(s.cbf_u_prev).all()
    if not bool(finite):
        raise RuntimeError("non-finite reward, observation or u* on the main path")


def measure(batch: int, chunk: int = CHUNK, n_chunks: int = N_CHUNKS, T: int = T_STEPS,
            n_agents: int = N_AGENTS, device=None, newton_iters: int = 5, soft_iters: int = 3,
            grouped: bool = False) -> dict:
    """The filtered rollout's env-steps/s at `batch` envs, as sub-batches
    of `chunk` envs where `batch` is a multiple of `chunk` above it.
    Returns steps_per_s (B * T * n_chunks over the wall time of the timed
    chunks), warmup_s (the chunk from the all-zero state), n_sub, the
    sub-batch width, and chunk_rates (each timed chunk's env-steps/s from
    CUDA events at its boundaries, or the host's clock on the CPU). Raises
    if a reward, observation or u* is not finite."""
    dev = resolve_device(device)
    n_sub = batch // chunk if batch > chunk and batch % chunk == 0 else 1
    width = batch // n_sub
    env, cbf, policy, gen, state, obs = main_path(width, n_agents, dev, newton_iters, soft_iters,
                                                  grouped)
    states, obs, gens = sub_batches(env, state, obs, gen, n_sub)

    t0 = time.perf_counter()
    states, obs, reward, _ = rollout_chunk(env, cbf, policy, states, obs, gens, T)
    synchronize(dev)
    warmup_s = time.perf_counter() - t0

    stamps = [_stamp(dev)]
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        states, obs, reward, _ = rollout_chunk(env, cbf, policy, states, obs, gens, T)
        stamps.append(_stamp(dev))
    synchronize(dev)
    elapsed = time.perf_counter() - t0
    _check_finite(states, obs, reward)
    chunk_rates = [batch * T / _seconds(a, b) for a, b in zip(stamps, stamps[1:])]
    return dict(steps_per_s=batch * T * n_chunks / elapsed, warmup_s=warmup_s, n_sub=n_sub,
                width=width, chunk_rates=chunk_rates)


def spread(rates: list) -> dict:
    return dict(min=round(min(rates), 1), median=round(statistics.median(rates), 1),
                max=round(max(rates), 1))


def bench_line(args, dev) -> dict:
    """The headline line: one framing (`--batch`) or both."""
    kw = dict(chunk=args.chunk, n_chunks=args.chunks, T=args.steps, n_agents=args.n_agents,
              device=dev, newton_iters=args.newton_iters, soft_iters=args.soft_iters)
    if args.batch is not None:
        r = measure(args.batch, **kw)
        detail = dict(batch=args.batch, chunks=r["n_sub"], warmup_s=round(r["warmup_s"], 1),
                      chunk_rates=spread(r["chunk_rates"]))
    else:
        r = measure(args.chunk, **kw)
        r4 = measure(SUB_BATCHES * args.chunk, **kw)
        detail = dict(batch=args.chunk, chunks=1, warmup_s=round(r["warmup_s"], 1),
                      chunk_rates=spread(r["chunk_rates"]),
                      b4096_chunked=round(r4["steps_per_s"], 1),
                      b4096_batch=SUB_BATCHES * args.chunk, b4096_sub_batches=r4["n_sub"],
                      warmup_b4096_s=round(r4["warmup_s"], 1),
                      chunk_rates_b4096=spread(r4["chunk_rates"]))
    sps = r["steps_per_s"]
    detail.update(n_agents=args.n_agents, n_circles=3, qp_per_s=round(sps, 1),
                  agent_steps_per_s=round(sps * args.n_agents, 1),
                  newton_iters=args.newton_iters, soft_iters=args.soft_iters,
                  device=device_line(dev))
    return dict(metric=METRIC, value=round(sps, 1), unit="env-steps/s/card", detail=detail)


def grouped_lines(args, dev) -> list:
    """The plain and the grouped filter at one batch (JAX's
    `scripts/bench_grouped.py`)."""
    batch = args.batch or args.chunk
    out = []
    for grouped in (False, True):
        r = measure(batch, chunk=args.chunk, n_chunks=args.chunks, T=args.steps,
                    n_agents=args.n_agents, device=dev, newton_iters=args.newton_iters,
                    soft_iters=args.soft_iters, grouped=grouped)
        out.append(dict(metric=METRIC, mode="grouped_m4" if grouped else "centralized",
                        value=round(r["steps_per_s"], 1), unit="env-steps/s/card",
                        batch=batch, n_agents=args.n_agents,
                        warmup_s=round(r["warmup_s"], 1), chunk_rates=spread(r["chunk_rates"]),
                        device=device_line(dev)))
    return out


def census(batch: int, steps: int = CENSUS_STEPS, T: int = T_STEPS, n_agents: int = N_AGENTS,
           device=None, newton_iters: int = 5, soft_iters: int = 3) -> dict:
    """The per-step count of resetting envs over `steps` untimed steps of
    the main path after a warm-up chunk of T steps from the all-zero state
    (in training mode a reset is a whole env: the done envs), and the
    share of those steps that took each branch of the env's reset."""
    dev = resolve_device(device)
    env, cbf, policy, gen, state, obs = main_path(batch, n_agents, dev, newton_iters, soft_iters,
                                                  draws_on="cpu")
    states, obs, _, _ = rollout_chunk(env, cbf, policy, [state], [obs], [gen], T)
    env.reset_steps = env.compact_reset_steps = env.full_reset_steps = 0
    states, obs, reward, dones = rollout_chunk(env, cbf, policy, states, obs, [gen], steps)
    _check_finite(states, obs, reward)
    c = torch.stack([d[0] for d in dones]).sum(-1).cpu().numpy()
    return dict(
        census="resetting_envs_per_step", batch=batch, n_agents=n_agents, steps=steps,
        slots=compact_slots(batch, False),
        mean=float(c.mean()), p50=float(np.percentile(c, 50)), p90=float(np.percentile(c, 90)),
        p99=float(np.percentile(c, 99)), max=int(c.max()), share_zero=float((c == 0).mean()),
        p_above={str(r): float((c > r).mean()) for r in CENSUS_THRESHOLDS},
        branches=dict(none=(steps - env.reset_steps) / steps,
                      compacted=env.compact_reset_steps / steps,
                      full_width=env.full_reset_steps / steps),
        counts=c.tolist(), device=device_line(dev),
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="one framing at this batch (default: both framings)")
    ap.add_argument("--chunk", type=int, default=CHUNK, help="sub-batch width")
    ap.add_argument("--newton_iters", type=int, default=5)
    ap.add_argument("--soft_iters", type=int, default=3)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--grouped", action="store_true",
                      help="the plain and the grouped filter, one line each")
    mode.add_argument("--census", action="store_true",
                      help="the per-step count of resetting envs (untimed)")
    ap.add_argument("--n_agents", type=int, default=N_AGENTS)
    ap.add_argument("--steps", type=int, default=T_STEPS, help="steps per chunk (T)")
    ap.add_argument("--chunks", type=int, default=N_CHUNKS, help="timed chunks")
    ap.add_argument("--census_steps", type=int, default=CENSUS_STEPS)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.census:
        lines = [census(args.batch or args.chunk, args.census_steps, args.steps, args.n_agents,
                        dev, args.newton_iters, args.soft_iters)]
    elif args.grouped:
        lines = grouped_lines(args, dev)
    else:
        lines = [bench_line(args, dev)]
    for line in lines:
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
