"""Multi-rank dry run: one CBF-filtered training iteration with the env
batch sharded over n ranks, both kernels on its path.

    python -m sigmarl_tpu_torch.parallel.dryrun [n] [--device cuda|cpu]
        [--backend nccl|gloo]

`spawn_ranks` starts n processes (spawn method) that join one process
group on a free localhost port, run a function as their rank, and return
its results in rank order; a rank that raises fails the whole run.
"""

from __future__ import annotations

import argparse
import math
import multiprocessing as mp
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, List

import torch

# Tiny shapes: 2 envs per rank, N=4, T=4, one epoch of one minibatch.
DRYRUN = dict(
    scenario_type="cpm_entire", n_agents=4, dt=0.1, max_steps=4, n_iters=1, num_epochs=1,
    is_use_mtv_distance=False, is_obs_noise=False, is_save_intermediate_model=False,
    is_using_cbf_training=True, is_solve_qp=True, is_apply_cbf_action=True,
    is_using_centralized_cbf=True, rew_method="cbf",
)
# Seconds a rank may take before the run is given up.
RANK_TIMEOUT_S = 600.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device, fn, args, results):
    import torch.distributed as dist

    from sigmarl_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    try:
        shard, dev = initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend,
                                            device)
        try:
            # Plain pickle: a queue would share tensors through this
            # process's file descriptors, gone once it exits.
            results.put((rank, pickle.dumps(fn(shard, dev, *args)), None))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, None, traceback.format_exc()))


def spawn_ranks(fn: Callable, n: int, *args, backend: str | None = None,
                device: str | None = None, timeout: float = RANK_TIMEOUT_S) -> List[Any]:
    """Run `fn(shard, device, *args)` on n ranks in n spawned processes and
    return the results in rank order. `fn` and `args` must pickle (a
    module-level function). `device` is each rank's device (None:
    `cuda:rank`); `backend` as `mesh.initialize_distributed` picks it."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, backend, device, fn, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    out, errors, got = [None] * n, [], 0
    deadline = time.monotonic() + timeout
    try:
        while got < n and not errors:  # drain before joining
            try:
                rank, value, err = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"ranks {dead} exited with codes "
                                  f"{[procs[r].exitcode for r in dead]}")
                elif time.monotonic() > deadline:
                    errors.append(f"no result within {timeout:.0f} s")
                continue
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
                continue
            out[rank] = pickle.loads(value)  # bytes our own rank wrote
            got += 1
    finally:
        for p in procs:
            p.join(timeout=10.0 if not errors else 1.0)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("a rank failed: " + "\n".join(errors))
    return out


def _dryrun_rank(shard, device, n_ranks: int) -> float:
    from sigmarl_tpu_torch.config import Parameters
    from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs

    B = 2 * n_ranks
    p = Parameters(**DRYRUN, num_vmas_envs=B, minibatch_size=B * DRYRUN["max_steps"],
                   where_to_save="unused/", device=str(device))
    tr = MAPPOCAVs(p, shard=shard)
    _, m = tr.train_iteration(tr.initial_state())
    loss = float(m["loss_objective"])
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss_objective {loss}")
    return loss


def dryrun_multichip(n: int, device: str | None = None, backend: str | None = None) -> float:
    """One CBF-filtered training iteration sharded over n ranks (cpm_entire,
    N=4, 2 envs per rank, T=4); prints and returns the loss, which every
    rank must agree on. `device` "cpu" runs on the CPU over gloo; by
    default each rank takes its own card over nccl; several ranks on one
    card need `device="cuda:0", backend="gloo"`."""
    losses = spawn_ranks(_dryrun_rank, n, n, backend=backend, device=device)
    if len(set(losses)) != 1:
        raise RuntimeError(f"the ranks disagree on the loss: {losses}")
    print(f"dryrun_multichip({n}): ok — loss_objective={losses[0]:.4f}")
    return losses[0]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=dryrun_multichip.__doc__)
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--device", type=str, default=None)
    ap.add_argument("--backend", type=str, default=None, choices=["nccl", "gloo"])
    a = ap.parse_args()
    dryrun_multichip(a.n, a.device, a.backend)
