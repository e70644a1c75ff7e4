"""One PPO minibatch update over fixed buffers, captured once per trainer as
a CUDA graph and replayed for every minibatch of every epoch: the port's
counterpart of the JAX package's jitted update (`jax.jit` at
`sigmarl_tpu/rl/mappo_cavs.py:227`, the epochs and minibatches as
`lax.scan`s at :467-495).

`UpdateProgram.step` is the function the graph holds. It reads only
buffers whose addresses stay fixed for the trainer's life:

- `data`, per-iteration copies of the rollout's flattened frames
  (`begin` copies them in), gathered by the index buffer `idx`;
- `noise` (and `prio_noise` under learned priority), the entropy
  estimate's standard normals;
- the parameters and the optimizer's moments, updated in place
  (`rl/optim.py`);
- `table`, the step size and the two bias corrections of every update of
  the iteration, computed on the host in float64 (`Adam.schedule`) and
  rounded once, read at the row of the device counter `row`, which the
  step itself increments;
- `stats`, the loss statistics of every update (the keys `loss` returns,
  read at the first step), written at the same row.

The host's work per minibatch is to copy the permutation's slice into
`idx` (device to device), to write the entropy noise into its buffer, and
to replay. The random numbers stay outside the graph, drawn in the calls
and the order of the eager loop (`MAPPOCAVs._update_loop`), so a graph
replay computes what the same step run eagerly computes.

On the CPU, and on the card when the trainer is built with
`update_graph=False`, `run` calls `step` eagerly instead of replaying it.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import torch

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.rl.optim import AdamState

Tensor = torch.Tensor

WARMUP_STEPS = 2  # eager steps on a side stream before the capture (reverted after it)


class UpdateProgram:
    """The minibatch update of `trainer` (a `MAPPOCAVs`) for the networks
    `nets`, the optimizer moments of `opt_state` and frames shaped like
    `data`, with `updates` minibatch updates per iteration."""

    def __init__(self, trainer, nets: Sequence[torch.nn.Module], opt_state: AdamState,
                 data: Dict[str, Tensor], updates: int, mb_rows: int):
        dev = trainer.device
        self.trainer = trainer
        self.nets = tuple(nets)
        self.params = trainer.parameter_list(*self.nets)
        self.mu, self.nu = opt_state.mu, opt_state.nu
        self.data = {k: torch.empty_like(v) for k, v in data.items()}
        act = data["action"].shape[1:]  # [N, 2]
        self.idx = torch.zeros(mb_rows, dtype=torch.long, device=dev)
        self.noise = torch.zeros((mb_rows,) + act, device=dev)
        prio = len(self.nets) > 2
        self.prio_noise = torch.zeros((mb_rows,) + act[:-1] + (1,), device=dev) if prio else None
        self.row = torch.zeros(1, dtype=torch.long, device=dev)
        self.table = torch.zeros((updates, 3), dtype=self.params[0].dtype, device=dev)
        self.keys: Optional[tuple] = None  # the loss's statistics, known at the first step
        self.stats: Optional[Tensor] = None  # [keys, updates]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_seconds = 0.0
        self.key = self.key_of(trainer, nets, opt_state, data)

    @staticmethod
    def key_of(trainer, nets, opt_state: AdamState, data: Dict[str, Tensor]) -> tuple:
        """What a program is built for: the addresses of the tensors it
        updates (which a captured graph holds) and the frames' layout."""
        tensors = trainer.parameter_list(*nets) + list(opt_state.mu) + list(opt_state.nu)
        return (tuple(t.data_ptr() for t in tensors),
                tuple((k, tuple(v.shape), v.dtype) for k, v in data.items()))

    def begin(self, data: Dict[str, Tensor], count: int) -> None:
        """Load an iteration: its frames, the scalars of the updates at
        counts `count` .. `count + updates - 1`, and the row counter at 0.
        No host sync: the table comes from pinned memory on the card."""
        for k, v in data.items():
            self.data[k].copy_(v)
        host = self.trainer.optimizer.schedule(count, self.table.shape[0], self.table.dtype)
        if self.table.is_cuda:
            host = host.pin_memory()
        self.table.copy_(host, non_blocking=True)
        self.row.zero_()

    def step(self) -> None:
        """One minibatch update: gather the rows, the loss, its gradients,
        the clipped Adam step in place, the statistics at `row`, and
        `row + 1`."""
        tr = self.trainer

        def adam(params, grads):
            sc = self.table.index_select(0, self.row)[0]
            tr.optimizer.apply(params, grads, self.mu, self.nu, sc[0], sc[1], sc[2])

        mb = {k: v.index_select(0, self.idx) for k, v in self.data.items()}
        _, stats = tr.gradient_step(self.nets, mb, self.noise, self.prio_noise, None, adam)
        if self.stats is None:  # never under capture: the warm-up steps first
            self.keys = tuple(stats)
            self.stats = torch.zeros((len(self.keys), self.table.shape[0]), device=self.row.device)
        with torch.no_grad():
            self.stats.index_copy_(1, self.row, torch.stack([stats[k] for k in self.keys])[:, None])
            self.row.add_(1)

    def capture(self) -> None:
        """Capture `step` as a CUDA graph: warm it up on a side stream, as
        PyTorch's graph documentation asks, undo what the warm-up changed,
        and capture. A failure raises; there is no eager fallback."""
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.row.device)
        side = torch.cuda.Stream(self.row.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.warm_up()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.step()
        torch.cuda.synchronize(self.row.device)
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0

    def warm_up(self) -> None:
        """`step` run `WARMUP_STEPS` times at the table's first row, then
        the parameters, moments and counter put back as they were (the
        statistics' row 0 is written again by every iteration)."""
        state = self.params + self.mu + self.nu + [self.row]
        saved = [t.detach().clone() for t in state]
        for _ in range(WARMUP_STEPS):
            self.row.zero_()  # an iteration may have one update only
            self.step()
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)

    def run(self, idx: Tensor, noise: Tensor, prio_noise: Tensor | None = None) -> None:
        """One minibatch: its rows and noise into the buffers, then a
        replay (or, uncaptured, `step`)."""
        self.idx.copy_(idx)
        self.noise.copy_(noise)
        if self.prio_noise is not None:
            self.prio_noise.copy_(prio_noise)
        if self.graph is not None:
            with trace.span("update.replay"):
                self.graph.replay()
        else:
            self.step()

    def loss_stats(self, epochs: int, minibatches: int) -> Dict[str, Tensor]:
        """The statistics as the eager loop reports them: means over the
        minibatches of each epoch, then over the epochs."""
        per_epoch = self.stats.view(len(self.keys), epochs, minibatches).mean(-1)
        return dict(zip(self.keys, per_epoch.mean(-1).unbind()))
