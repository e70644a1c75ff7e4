"""XP-MARL's acting on the card: the priority rank and the N priority turns
replayed from CUDA graphs.

`rl/priority.py` runs both as eager bodies on the CPU. On the card each
body is captured once per key, as the filter's is (`safety/cbf_qp.py::
_FilterGraph`), and every later call copies its inputs into the graph's
buffers (device to device), replays it and returns copies of its outputs:
the rollout keeps every step's outputs, which the next replay overwrites.

- The key: what the call can observe (the input tensors' device, shapes
  and dtypes, which draws are tensors, and flags the caller adds), and
  the network's parameters by address, shape and dtype. The update writes
  the parameters in place, so a replay reads the current weights; a
  network with other tensors captures anew. The graphs of a network are
  kept with it (weakly), and go when it goes.
- The random draws stay outside the graphs. Draws that come from a
  generator are drawn into the graph's noise buffers before the replay,
  in the eager body's calls and order, so a replay computes what the body
  computes, bit for bit.
- Counters: `<name>.graph.captures` (one per key) and
  `<name>.graph.replays` (one per call after the first); a replay also
  adds the counts its capture diverted (`turns`: N per call).
"""

from __future__ import annotations

import itertools
import weakref
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.env.step_graphs import _copy

Tensor = torch.Tensor
Inputs = Tuple[Optional[Tensor], ...]


class _ActGraph:
    """One body captured as a CUDA graph: the input buffers it reads, the
    graph, the outputs it writes and the counts its capture diverted."""

    def __init__(self, graph, inputs: Inputs, outputs: tuple, counts: dict):
        self.graph, self.inputs, self.outputs, self.counts = graph, inputs, outputs, counts

    @classmethod
    def capture(cls, name: str, body: Callable[[Inputs], tuple], inputs: Inputs):
        """Copy `inputs` into new buffers, run `body` on them on a side
        stream (the warm-up; its result is this call's) and capture it.
        Returns (the graph, the result). A capture that fails raises: there
        is no eager fallback."""
        dev = next(t for t in inputs if t is not None).device
        static = tuple(None if t is None else t.clone(memory_format=torch.contiguous_format)
                       for t in inputs)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = body(static)
        cur.wait_stream(side)
        for t in out:
            t.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with trace.diverted() as counts, torch.cuda.graph(graph):
            outputs = body(static)
        trace.count_sync(dev)  # the capture synchronises the card first
        trace.count(f"{name}.graph.captures")
        return cls(graph, static, outputs, counts), out

    def replay(self, name: str, inputs: Inputs) -> tuple:
        """Copy `inputs` into the buffers (those drawn into a buffer in
        place are skipped), replay, and return copies of the outputs."""
        _copy([b for b in self.inputs if b is not None], [t for t in inputs if t is not None])
        self.graph.replay()
        for counter, n in self.counts.items():
            trace.count(counter, n)
        trace.count(f"{name}.graph.replays")
        return type(self.outputs)(*(t.clone() for t in self.outputs))


# network -> {key: _ActGraph}
_graphs: "weakref.WeakKeyDictionary[nn.Module, dict]" = weakref.WeakKeyDictionary()


def signature(t: Optional[Tensor]):
    """A tensor's part of a key: None, or its shape and dtype."""
    return None if t is None else (tuple(t.shape), t.dtype)


def replayed(name: str, net: nn.Module, key: tuple,
             inputs: Callable[[Optional[Inputs]], Inputs],
             body: Callable[[Inputs], tuple]) -> tuple:
    """`body`'s outputs for this call, from `net`'s graph of `key` (captured
    here at the key's first call). `inputs(buffers)` gives the call's input
    tensors: None at the first call, else the graph's input buffers, into
    which it may draw in place."""
    tensors = itertools.chain(net.parameters(), net.buffers())
    key = (name, key, tuple((t.data_ptr(), *signature(t)) for t in tensors))
    graphs = _graphs.setdefault(net, {})
    graph = graphs.get(key)
    if graph is None:
        graph, out = _ActGraph.capture(name, body, inputs(None))
        graphs[key] = graph
        return out
    return graph.replay(name, inputs(graph.inputs))
