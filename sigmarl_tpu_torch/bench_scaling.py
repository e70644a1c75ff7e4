"""Weak scaling over ranks: the CBF-filtered rollout's env-steps/s with a
fixed batch per rank, the env axis sharded over the ranks.

    python -m sigmarl_tpu_torch.bench_scaling [--ranks 1,2]
        [--per_device_batch 128] [--n_agents 15] [--scenario_type cpm_entire]
        [--steps 32] [--chunks 3] [--newton_iters 10]
        [--device cuda|cpu] [--backend nccl|gloo]
    torchrun --nproc_per_node W -m sigmarl_tpu_torch.bench_scaling --worker ...

The counterpart of the JAX package's `scripts/bench_scaling.py` (mesh
sizes on one host) and `scripts/bench_scaling_multihost.py` (processes
joined into one group), with their flags and defaults; the multihost
script's own `--steps 16` and 8 Newton iterations are `--steps 16
--newton_iters 8`. Without `--worker` this is the launcher: it runs each
rank count of `--ranks` as that many spawned processes in one group
(`parallel/dryrun.py::spawn_ranks`). With `--worker`, under torchrun, the
process joins the group from torchrun's variables
(`parallel/mesh.py::initialize_distributed`) and rank 0 prints that world
size's row, as JAX's worker runs unchanged on a pod. Both run
`scaling_rank`.

Each rank runs JAX's chunk on its share of the global batch (per-rank
batch x W): cpm_entire with N=15 agents, no observation noise, no MTV
distance, no episode-end resets; the centralized filter (3 circles,
CBFConfig's 2 ladder iterations, then `--newton_iters`); the 3x256 policy
from seed 0; from the all-zero state and zero observations (the first
step resets every env); each step the policy's sampled action through
`cbf_filtered_step`, and the step's reward mean over the global batch
(each rank's per-env sums placed in a global vector and summed with one
all-reduce on the device, as JAX's `reward.mean()` in the scan is a
cross-rank collective). A chunk is T steps; its mean reward is formed once
at its end and read after the timed window. Rank r draws from generators
seeded r; `scaling_rank` also takes the policy noise and the reset draws
as tensors of the global batch, which it slices to the rank's envs.

Timing: one warm-up chunk (`warmup_s`: the kernels' load, the counterpart
of JAX's `compile_s`; the launcher builds the kernels once before it
spawns), then a barrier, the timed chunks, a synchronize and another
barrier; `steps_per_s` = global batch x T x chunks over the slowest rank's
window. Rank 0 times each chunk with CUDA events at chunk boundaries (no
extra sync).

Ranks: on the CPU over gloo; on cards, one rank per card over nccl where
there are enough cards, else every rank on `cuda:0` over gloo (nccl
refuses two ranks on one card, and gloo stages CUDA tensors through the
host). Ranks that share a card or run on the CPU measure the mechanics of
the sharded program, not scaling over cards (`mechanics` in each line).

Output: one JSON line per rank count, with JAX's keys (`global_devices`,
the ranks; `batch`; `steps_per_s`), `warmup_s` for `compile_s`, and the
per-rank batch, backend, cards, the chunks' rates, each rank's kernel
launches, the collectives per step, the env's reset-branch counts, the
reward and the card's name and power limit; then one summary line
`{"metric": "scaling_efficiency", ...}`. Without a card and without
`--device cpu` the program raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time

import torch
import torch.distributed as dist

from sigmarl_tpu_torch.bench import _seconds, _stamp
from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.device import device_line, resolve_device, synchronize
from sigmarl_tpu_torch.env.env import make_env
from sigmarl_tpu_torch.env.structs import zero_state
from sigmarl_tpu_torch.parallel.mesh import Shard, gather_world_state, initialize_distributed
from sigmarl_tpu_torch.rl.networks import PolicyNet, tanh_normal_sample
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step

NOTE = ("weak scaling of the sharded filtered rollout: a fixed batch per rank. Ranks that "
        "share one card or run on the CPU measure the mechanics of the sharded program "
        "(collectives, per-rank launches, gloo's host staging), not scaling over cards; "
        "efficiency over cards needs one card per rank.")


@dataclasses.dataclass(frozen=True)
class CountedShard(Shard):
    """A `Shard` that counts the collectives it runs."""

    calls: list = dataclasses.field(default_factory=lambda: [0], compare=False)

    def _all_reduce(self, x, op):
        self.calls[0] += 1
        return super()._all_reduce(x, op)

    def all_gather(self, x):
        self.calls[0] += 1
        return super().all_gather(x)


def _launches() -> dict:
    from sigmarl_tpu_torch.ops.boundary import pseudo_distance_stencil
    from sigmarl_tpu_torch.ops.qp import newton_solve

    return {"qp_newton": newton_solve.launches,
            "boundary_stencil": pseudo_distance_stencil.launches}


def workload(cfg: dict, device, shard=None):
    """One rank's share of JAX's chunk: (env, filter, policy), the env
    holding the rank's `per_rank_batch` envs of the global batch."""
    world = 1 if shard is None else shard.world
    N = cfg["n_agents"]
    p = Parameters(
        scenario_type=cfg["scenario_type"], n_agents=N,
        num_vmas_envs=cfg["per_rank_batch"] * world, dt=0.1, max_steps=1_000_000,
        is_use_mtv_distance=False, is_obs_noise=False, is_using_cbf_testing=True,
        is_using_centralized_cbf=True,
    )
    env = make_env(p, device, shard=shard)
    cbf = CBFSafetyFilter(CBFConfig(n_agents=N, n_circles=3, dt=0.1,
                                    newton_iters=cfg["newton_iters"]),
                          env.cfg, env.tables, device=device)
    return env, cbf, PolicyNet(env.obs_dim, device=device, seed=0)


def scaling_rank(shard, device, cfg: dict, draws=None) -> dict:
    """One rank of the weak-scaling run (a function for `spawn_ranks`; with
    `shard` None, one process holds the whole batch). `cfg`: per_rank_batch,
    n_agents, scenario_type, steps, chunks, newton_iters. `draws`, if given,
    is (policy noise [S, B, N, 2], one `ResetDraws` per step) of the global
    batch B over all S = (chunks + 1) x steps steps, on the CPU; else rank
    r draws from generators seeded r.

    Returns plain numbers, the same on every rank: the per-step global
    reward means, the timed chunks' mean reward, the slowest rank's timed
    window, rank 0's chunk seconds, every rank's warm-up seconds, kernel
    launches and devices, the collectives per timed step, the env's
    reset-branch counts, and (with `draws`) the gathered final state on
    the CPU."""
    dev = torch.device(device)
    rank, world = (0, 1) if shard is None else (shard.rank, shard.world)
    if shard is not None and not isinstance(shard, CountedShard):
        shard = CountedShard(shard.rank, shard.world, shard.group)
    env, cbf, policy = workload(cfg, dev, shard)
    B, T, N = cfg["per_rank_batch"], cfg["steps"], cfg["n_agents"]
    envs = slice(rank * B, (rank + 1) * B)
    lim = env.action_limits
    gen = None if draws is not None else torch.Generator(device=dev).manual_seed(rank)
    state = zero_state(env.cfg, dev)
    obs = torch.zeros((B, N, env.obs_dim), device=dev)
    step_means = []

    def chunk():
        nonlocal state, obs
        first = len(step_means)
        for _ in range(T):
            s = len(step_means)
            with torch.no_grad():
                loc, scale = policy(obs)
                noise = None if draws is None else draws[0][s, envs].to(dev)
                act, _ = tanh_normal_sample(loc, scale, -lim, lim, generator=gen, noise=noise)
            reset = None if draws is None else draws[1][s].for_envs(envs).to(dev)
            state, obs, rew, _, _ = cbf_filtered_step(env, cbf, state, act, generator=gen,
                                                      reset_draws=reset)
            # The global mean from every env's sum: each rank fills its
            # envs' entries and one all-reduce completes the vector, which
            # sums in the same order whatever the number of ranks.
            per_env = torch.zeros(B * world, device=dev)
            per_env[envs] = rew.sum(-1)
            if shard is not None:
                per_env = shard.all_reduce_sum(per_env)
            step_means.append(per_env.sum() / (B * world * N))
        return torch.stack(step_means[first:]).mean()

    def barrier():
        if shard is not None:
            dist.barrier()

    launches0 = _launches()
    t0 = time.perf_counter()
    chunk()
    synchronize(dev)
    warmup_s = time.perf_counter() - t0

    barrier()
    calls0 = shard.calls[0] if shard is not None else 0
    stamps, rewards = [_stamp(dev)], []
    t0 = time.perf_counter()
    for _ in range(cfg["chunks"]):
        rewards.append(chunk())
        stamps.append(_stamp(dev))
    synchronize(dev)
    barrier()
    wall = time.perf_counter() - t0
    collectives = (shard.calls[0] - calls0) if shard is not None else 0
    launches = {k: v - launches0[k] for k, v in _launches().items()}
    chunk_s = [_seconds(a, b) for a, b in zip(stamps, stamps[1:])]

    if shard is not None:
        wall = float(shard.all_reduce_max(torch.tensor([wall], dtype=torch.float64,
                                                       device=dev))[0])
    mine = dict(warmup_s=warmup_s, launches=launches, device=str(dev))
    ranks = [mine]
    if shard is not None:
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
    out = dict(
        step_rewards=torch.stack(step_means).cpu().tolist(),
        reward=float(torch.stack(rewards).mean()), wall_s=wall,
        chunk_s=chunk_s if rank == 0 else None, ranks=ranks,
        collectives_per_step=collectives / (cfg["chunks"] * T),
        reset_steps=env.reset_steps, compact_reset_steps=env.compact_reset_steps,
        full_reset_steps=env.full_reset_steps,
    )
    if draws is not None:
        final = state if shard is None else gather_world_state(state, shard)
        out["state"] = {f.name: getattr(final, f.name).cpu()
                        for f in dataclasses.fields(final)}
    return out


def _spread(rates: list) -> dict:
    return dict(min=min(rates), median=statistics.median(rates), max=max(rates))


def row(result: dict, cfg: dict, world: int, backend: str, dev: torch.device) -> dict:
    """The JSON line of one rank count from rank 0's result."""
    batch = cfg["per_rank_batch"] * world
    T = cfg["steps"]
    cards = len({r["device"] for r in result["ranks"] if r["device"] != "cpu"})
    return dict(
        global_devices=world, batch=batch, per_rank_batch=cfg["per_rank_batch"],
        steps_per_s=batch * T * cfg["chunks"] / result["wall_s"],
        warmup_s=max(r["warmup_s"] for r in result["ranks"]), backend=backend, cards=cards,
        chunk_steps_per_s=_spread([batch * T / s for s in result["chunk_s"]]),
        launches=[r["launches"] for r in result["ranks"]],
        collectives_per_step=result["collectives_per_step"],
        reset_steps=result["reset_steps"], compact_reset_steps=result["compact_reset_steps"],
        full_reset_steps=result["full_reset_steps"], reward=result["reward"],
        n_agents=cfg["n_agents"], steps=T, chunks=cfg["chunks"],
        newton_iters=cfg["newton_iters"], soft_iters=CBFConfig.newton_soft_iters,
        mechanics=cards < world, device=device_line(dev),
    )


def summary(rows: list, per_rank_batch: int) -> dict:
    base = rows[0]["steps_per_s"] / rows[0]["global_devices"]
    return {
        "metric": "scaling_efficiency", "per_device_batch": per_rank_batch,
        "sizes": [r["global_devices"] for r in rows],
        "steps_per_s": [r["steps_per_s"] for r in rows],
        "efficiency_vs_1dev": [round(r["steps_per_s"] / (base * r["global_devices"]), 3)
                               for r in rows],
        "mechanics": any(r["mechanics"] for r in rows), "note": NOTE,
    }


def placement(world: int, dev: torch.device, backend: str | None) -> tuple:
    """(backend, each rank's device for `spawn_ranks`) of `world` ranks:
    gloo on the CPU; on cards nccl with one card per rank where there are
    enough, else gloo with every rank on `cuda:0`. nccl on the CPU raises."""
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; use gloo on the CPU")
        return "gloo", "cpu"
    enough = world <= torch.cuda.device_count()
    backend = backend or ("nccl" if enough else "gloo")
    return backend, (None if enough else "cuda:0")


def config(args) -> dict:
    return dict(per_rank_batch=args.per_device_batch, n_agents=args.n_agents,
                scenario_type=args.scenario_type, steps=args.steps, chunks=args.chunks,
                newton_iters=args.newton_iters)


def launch(args) -> list:
    """Every rank count of `--ranks`; prints and returns the rows and the
    summary."""
    from sigmarl_tpu_torch.parallel.dryrun import spawn_ranks

    dev = resolve_device(args.device)
    sizes = [int(s) for s in args.ranks.split(",")]
    plans = [placement(w, dev, args.backend) for w in sizes]
    if dev.type == "cuda":
        from sigmarl_tpu_torch.ops import build

        build.build_all()  # once, so that no two ranks compile at first use
    cfg, rows = config(args), []
    for world, (backend, rank_device) in zip(sizes, plans):
        results = spawn_ranks(scaling_rank, world, cfg, backend=backend, device=rank_device)
        rows.append(row(results[0], cfg, world, backend,
                        dev if rank_device is None else torch.device(rank_device)))
        print(json.dumps(rows[-1]), flush=True)
    lines = rows + [summary(rows, args.per_device_batch)]
    print(json.dumps(lines[-1]), flush=True)
    return lines


def worker(args) -> dict | None:
    """One torchrun process: join the group from torchrun's variables
    (local rank l on card l modulo the cards; nccl by default on cards,
    gloo on the CPU), run the rank, and print the row on rank 0."""
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        backend, rank_dev = placement(1, dev, args.backend)
    else:
        backend = args.backend or "nccl"
        rank_dev = f"cuda:{int(os.environ.get('LOCAL_RANK', 0)) % torch.cuda.device_count()}"
    shard, rank_dev = initialize_distributed(backend=backend, device=rank_dev)
    try:
        result = scaling_rank(shard, rank_dev, config(args))
    finally:
        dist.destroy_process_group()
    if shard.rank != 0:
        return None
    line = row(result, config(args), shard.world, backend, rank_dev)
    print(json.dumps(line), flush=True)
    return line


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true",
                    help="one process of a torchrun group (prints its world size's row)")
    ap.add_argument("--ranks", default="1,2", help="rank counts to run, comma-separated")
    ap.add_argument("--per_device_batch", type=int, default=128)
    ap.add_argument("--n_agents", type=int, default=15)
    ap.add_argument("--scenario_type", default="cpm_entire")
    ap.add_argument("--steps", type=int, default=32, help="steps per chunk (T)")
    ap.add_argument("--chunks", type=int, default=3, help="timed chunks")
    ap.add_argument("--newton_iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker:
        worker(args)
    else:
        launch(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
