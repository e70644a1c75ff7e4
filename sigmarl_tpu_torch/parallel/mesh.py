"""Scenario-axis data parallelism over ranks with `torch.distributed`.

The env batch shards over W ranks, B/W envs each, and an env never spans
ranks. Rollouts are rank-local; the PPO update's gradient all-reduce is the
only communication of the update. Given the same draws, W ranks compute the
iteration that one process computes with B envs: the steps that the global
program decides over all envs (how many envs reset, which decides the
spawn's branch and each rank's compacted slots; the challenge buffer's
record, ranked over every env) take one collective each.

A `Shard` is one rank's view: its rank, the world size and the process
group, with the collectives the trainer and the env use. The gloo backend
keeps tensors on the host, so a CUDA tensor goes through a host copy there
(how several ranks share one card); nccl reduces on the cards, one card per
rank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import torch
import torch.distributed as dist

from sigmarl_tpu_torch.device import resolve_device
from sigmarl_tpu_torch.env.structs import WorldState

Tensor = torch.Tensor

# Fields whose env axis is axis 1 ([n_stored, B, ...]).
AXIS1_FIELDS = ("state_buffer", "obs_history")


@dataclasses.dataclass(frozen=True)
class Shard:
    """One rank of the env axis: rank r of W holds envs [r B/W, (r+1) B/W)."""

    rank: int
    world: int
    group: object = None  # the process group (None: the default group)

    def env_slice(self, B: int) -> slice:
        return env_shard(B, self.rank, self.world)

    def _host_staged(self, x: Tensor) -> bool:
        return x.is_cuda and dist.get_backend(self.group) == "gloo"

    def _all_reduce(self, x: Tensor, op) -> Tensor:
        y = x.detach().cpu() if self._host_staged(x) else x.detach().clone()
        dist.all_reduce(y, op=op, group=self.group)
        return y.to(x.device)

    def all_reduce_sum(self, x: Tensor) -> Tensor:
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def all_reduce_max(self, x: Tensor) -> Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: Tensor) -> Tensor:
        """Every rank's `x` concatenated along axis 0 in rank order (all
        ranks pass the same shape)."""
        y = x.detach().cpu() if self._host_staged(x) else x.detach().contiguous()
        parts = [torch.empty_like(y) for _ in range(self.world)]
        dist.all_gather(parts, y, group=self.group)
        return torch.cat(parts, 0).to(x.device)

    def all_reduce_grads(self, grads: Sequence[Tensor]) -> List[Tensor]:
        """The sum of every rank's gradients, in one flat all-reduce."""
        flat = self.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
        out, i = [], 0
        for g in grads:
            out.append(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        return out


def env_shard(B: int, rank: int, world: int) -> slice:
    """The envs of `rank`: a contiguous B/world block. B must divide by
    world."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of world {world}")
    if B % world:
        raise ValueError(f"{B} envs do not divide over {world} ranks")
    n = B // world
    return slice(rank * n, (rank + 1) * n)


def _env_axis(name: str, value: Tensor, B: int):
    """The env axis of a `WorldState` field (None: replicated). The rules
    of the JAX package's `shard_world_state`: the state buffer and the
    observation history on axis 1, every field with leading axis B on axis
    0, everything else (scalars, the global challenge buffer) replicated."""
    if name in AXIS1_FIELDS:
        return 1
    if name != "challenge_buffer" and value.dim() >= 1 and value.shape[0] == B:
        return 0
    return None


def shard_world_state(state: WorldState, rank: int, world: int) -> WorldState:
    """The envs of `rank` out of a global state; replicated fields are
    kept whole."""
    B = state.pos.shape[0]
    sl = env_shard(B, rank, world)
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        axis = _env_axis(f.name, v, B)
        out[f.name] = v if axis is None else v.narrow(axis, sl.start, sl.stop - sl.start).clone()
    return WorldState(**out)


def gather_world_state(state: WorldState, shard: Shard) -> WorldState:
    """The global state from every rank's shard (the counterpart of the
    JAX package's `make_global_state`); replicated fields are this rank's."""
    B = state.pos.shape[0]
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        axis = _env_axis(f.name, v, B)
        if axis is None:
            out[f.name] = v
        elif axis == 0:
            out[f.name] = shard.all_gather(v)
        else:
            out[f.name] = shard.all_gather(v.transpose(0, 1).contiguous()).transpose(0, 1)
    return WorldState(**out)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: str | torch.device | None = None,
) -> tuple[Shard, torch.device]:
    """Join the process group and return (this rank's `Shard`, its device).

    With no coordinator it reads torchrun's `RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`; otherwise pass the
    address (`tcp://host:port`), the world size and this process's rank.
    The device is `device`, by default `cuda:LOCAL_RANK`. The backend is
    `nccl` for a CUDA device (one card per rank) and `gloo` for the CPU; a
    caller may ask for `gloo` with CUDA tensors, so that ranks share one
    card. A backend that fails to initialise raises."""
    if coordinator_address is None:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        rank, world, local = process_id, num_processes, process_id
        init_method = coordinator_address
    dev = resolve_device(f"cuda:{local}" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return Shard(rank, world), dev
