"""The env step on the card: its sync-free phases replayed from CUDA graphs.

A step has one host read, the number of resetting envs, which picks the
reset's branch (none, compacted, full width). The phases before it
(dynamics, geometry, rewards, paths, done) and the observation after the
reset are fixed-shape tensor work that reads no host value, so on the card
each is one CUDA graph, captured at the first call of an input key and
replayed inside its phase's span; the read and the reset stay eager.

- The key: the shapes, dtypes and device of the state's fields, the
  actions and the challenge buffer's uniform (present with the buffer on),
  and the observation noise's shape and dtype (present with noise on).
  The reset's draws are not inputs of a graph: the reset is eager.
- The five graphs before the read share one memory pool, each reading the
  outputs of the one before in place. The observation's graph reads the
  state the done graph leaves; after a reset the fields the reset changed
  are copied into those buffers first.
- Per call the inputs are copied into the graphs' buffers (one multi-tensor
  copy per dtype). Draws stay outside, in the eager body's order: the
  record's uniform before the done graph, then the reset's, then the
  observation noise's before the observation's graph; so a replay computes
  what the eager body computes, bit for bit.
- The done graph packs the reward, done and info, and the observation's
  graph the state and the observation, into one byte buffer (`_Pack`),
  which one copy copies out into a buffer of the call's own: what a step
  returns is views of that buffer, never a graph's buffer, which the next
  replay overwrites. The views are made before the read, while the card
  runs the phases.

Counters: `env_step.graph.captures` (one per key) and
`env_step.graph.replays` (one per graph replayed, six a step); a replay
also adds the counts its capture diverted. The phase spans and their
sub-spans (`env_step.geometry.agents`, ...) open in a key's warm-up; later
calls open the phase spans around the replays.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.device import uniform
from sigmarl_tpu_torch.env.observations import observe_with_history
from sigmarl_tpu_torch.env.rewards import compute_rewards
from sigmarl_tpu_torch.env.structs import WorldState
from sigmarl_tpu_torch.env.updates import update_geometry

Tensor = torch.Tensor

FIELDS = tuple(f.name for f in dataclasses.fields(WorldState))
PRE_READ = ("env_step.dynamics", "env_step.geometry", "env_step.rewards", "env_step.paths",
            "env_step.done")
OBSERVE = "env_step.observe"


class _Pack:
    """Tensors of fixed shapes laid out in one byte buffer, part after part
    and in each part one region per dtype (16-byte aligned), so that one
    copy copies them all. `write(i, tensors)` packs part i, one
    concatenation per region; `unpack(other)` gives every part's tensors
    as views of another buffer of the same size (one strided view each)."""

    def __init__(self, parts: List[List[Tensor]], device: torch.device):
        self.regions, self.views, end = [], [], 0
        for tensors in parts:
            regions, views = [], [None] * len(tensors)
            for dtype in dict.fromkeys(t.dtype for t in tensors):
                idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
                size = tensors[idx[0]].element_size()
                start = -(-end // 16) * 16
                end = offset = start
                for i in idx:
                    shape = tuple(tensors[i].shape)
                    strides = torch.empty(shape, device="meta").stride()
                    views[i] = (dtype, shape, strides, offset // size)
                    offset += tensors[i].numel() * size
                end = offset
                regions.append((dtype, start, end, idx))
            self.regions.append(regions)
            self.views.append(views)
        self.dtypes = tuple(dict.fromkeys(v[0] for views in self.views for v in views))
        self.buffer = torch.empty(-(-end // 16) * 16, dtype=torch.uint8, device=device)

    def write(self, part: int, tensors: List[Tensor]) -> None:
        if len(tensors) != len(self.views[part]):
            raise RuntimeError(f"part {part} of the step's outputs has {len(tensors)} tensors, "
                               f"its layout {len(self.views[part])}")
        for i, (t, (dtype, shape, _, _)) in enumerate(zip(tensors, self.views[part])):
            if t.dtype != dtype or tuple(t.shape) != shape:
                raise RuntimeError(f"output {i} of part {part}: {t.dtype} {tuple(t.shape)}, "
                                   f"laid out as {dtype} {shape}")
        for dtype, start, end, idx in self.regions[part]:
            torch.cat([tensors[i].reshape(-1) for i in idx], out=self.buffer[start:end].view(dtype))

    def unpack(self, other: Tensor) -> List[List[Tensor]]:
        typed = {dtype: other.view(dtype) for dtype in self.dtypes}
        return [[typed[dtype].as_strided(shape, stride, offset)
                 for dtype, shape, stride, offset in views] for views in self.views]


def _copy(dst: List[Tensor], src: List[Tensor]) -> None:
    """dst[i] <- src[i] for every i where they differ (the reset's changed
    fields into the buffers they replace): one multi-tensor copy per dtype
    over the pairs of one contiguous layout, one copy each for the rest."""
    groups = {}
    for d, s in zip(dst, src):
        if d is s:
            continue
        if d.dtype == s.dtype and d.shape == s.shape and d.is_contiguous() and s.is_contiguous():
            a, b = groups.setdefault(d.dtype, ([], []))
            a.append(d)
            b.append(s)
        else:
            d.copy_(s)
    for a, b in groups.values():
        torch._foreach_copy_(a, b)


def _draw_into(buffer: Tensor, generator) -> None:
    """`buffer` <- `device.uniform(buffer.shape, generator, ...)`: drawn in
    place where the generator lives on the buffer's device (the same
    numbers: `torch.rand` fills its output by `uniform_`), else drawn on
    the generator's device and copied."""
    if generator is None or generator.device == buffer.device:
        torch.rand(buffer.shape, generator=generator, out=buffer)
    else:
        buffer.copy_(uniform(buffer.shape, generator, buffer.device))


def _state(tensors: List[Tensor]) -> WorldState:
    return WorldState(**dict(zip(FIELDS, tensors)))


def _fields(state: WorldState) -> List[Tensor]:
    return [getattr(state, f) for f in FIELDS]


class StepGraphs:
    """The six graphs of one input key, their input buffers and the pack
    they write. `StepGraphs(env, inputs, noise)` captures them: `inputs`
    are the state's fields, the actions and the record's uniform (if any),
    `noise` the observation noise's (shape, dtype) or None."""

    def __init__(self, env, inputs: List[Tensor], noise):
        dev = inputs[0].device
        foreign = {t.device for t in inputs} - {dev}
        if foreign:
            raise ValueError(f"the step's inputs lie on {dev} and {foreign}; a graph would bake "
                             "the values of another device's tensors in")
        with torch.no_grad():
            self.inputs = [t.clone(memory_format=torch.contiguous_format) for t in inputs]
            # The copy in: one multi-tensor copy per dtype (PyTorch copies
            # pair by pair where a layout differs).
            self.copy_in = [
                ([self.inputs[i] for i in idx], idx) for idx in (
                    [i for i, t in enumerate(inputs) if t.dtype == dtype]
                    for dtype in dict.fromkeys(t.dtype for t in inputs))]
            self.noise = None if noise is None else torch.zeros(noise[0], dtype=noise[1],
                                                                device=dev)
            start = dict(state=_state(self.inputs), actions=self.inputs[len(FIELDS)],
                         record_u=self.inputs[len(FIELDS) + 1] if len(inputs) > len(FIELDS) + 1
                         else None, noise=self.noise)
            phases = self._phases(env)
            # The warm-up, on a side stream (as PyTorch's graphs ask), with
            # the phases' spans; its results lay out the pack.
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                warm = dict(start)
                for name, phase in zip(PRE_READ + (OBSERVE,), phases):
                    with trace.span(name):
                        phase(warm)
                self.info_keys = tuple(warm["info"])
                self.pack = _Pack([self._results(warm), self._outputs(warm)], dev)
                del warm
            cur.wait_stream(side)
            pool = torch.cuda.graph_pool_handle()
            carry = dict(start)
            self.graphs, self.counts = [], []
            for i, phase in enumerate(phases):
                graph = torch.cuda.CUDAGraph()
                with trace.diverted() as counts, torch.cuda.graph(graph, pool=pool):
                    phase(carry)
                    if i == len(PRE_READ) - 1:
                        if carry["n_recorded"] is not None:
                            env.challenge_counts[0] += carry["n_recorded"]
                        self.pack.write(0, self._results(carry))
                        # What the reset and the observation's graph read.
                        self.pre, self.reset_mask = carry["state"], carry["reset_mask"]
                        self.n_reset = carry["n_reset"]
                    elif i == len(PRE_READ):
                        self.pack.write(1, self._outputs(carry))
                trace.count_sync(dev)  # a capture synchronises the card first
                self.graphs.append(graph)
                self.counts.append(counts)
        trace.count("env_step.graph.captures")

    @staticmethod
    def _phases(env) -> list:
        """The phases as functions of a carry dict, in the step's order:
        the five before the read, then the observation."""

        def dynamics(c):
            c["state"], c["prev_pos"], c["prev_short_term"] = env._dynamics(c["state"],
                                                                            c["actions"])

        def geometry(c):
            c["state"] = update_geometry(env.cfg, env.tables, c["state"])

        def rewards(c):
            c["reward"], c["rew_info"] = compute_rewards(
                env.cfg, c["state"], c["prev_pos"], c["prev_short_term"], env.weighting_ref)

        def paths(c):
            c["state"] = env._paths(c["state"])

        def done(c):
            (c["state"], c["done"], c["reset_mask"], c["info"], c["n_reset"],
             c["n_recorded"]) = env._done(c["state"], c["rew_info"], c["record_u"])

        def observe(c):
            c["obs"], c["state"] = observe_with_history(
                env.cfg, env.tables, c["state"], reset_mask=c["reset_mask"], noise=c["noise"])

        return [dynamics, geometry, rewards, paths, done, observe]

    @staticmethod
    def _results(c) -> List[Tensor]:
        """What the done graph packs: reward, done, then info's values (the
        state's fields among them as they stand before the reset)."""
        return [c["reward"], c["done"], *c["info"].values()]

    @staticmethod
    def _outputs(c) -> List[Tensor]:
        """What the observation's graph packs: the state's fields, then the
        observation."""
        return _fields(c["state"]) + [c["obs"]]

    def _replay(self, i: int) -> None:
        self.graphs[i].replay()
        for name, n in self.counts[i].items():
            trace.count(name, n)
        trace.count("env_step.graph.replays")

    def step(self, env, inputs: List[Tensor], generator, reset_draws, obs_noise):
        """One step from `inputs` (`RoadTrafficEnv.step`'s result)."""
        with torch.no_grad():
            for dst, idx in self.copy_in:
                torch._foreach_copy_(dst, [inputs[i] for i in idx])
            for i, name in enumerate(PRE_READ):
                with trace.span(name):
                    self._replay(i)
                    if name == PRE_READ[-1]:
                        # What this call returns: views of a buffer of its
                        # own, laid out while the card runs the phases (the
                        # read below waits for them).
                        out = torch.empty_like(self.pack.buffer)
                        results, outputs = self.pack.unpack(out)
                        counts = env._read_resets(self.n_reset)
            reset = None
            if sum(counts) > 0:
                with trace.span("env_step.reset"):
                    reset = env._reset(self.pre, self.reset_mask, counts, reset_draws, generator)
            with trace.span(OBSERVE):
                if reset is not None:
                    _copy(_fields(self.pre), _fields(reset))
                if self.noise is not None and obs_noise is not None:
                    self.noise.copy_(obs_noise)
                elif self.noise is not None:
                    _draw_into(self.noise, generator)
                self._replay(len(PRE_READ))
            out.copy_(self.pack.buffer)
        info = dict(zip(self.info_keys, results[2:]))
        return _state(outputs[:-1]), outputs[-1], results[0], results[1], info


def step_graphed(env, state: WorldState, actions: Tensor, generator, reset_draws, obs_noise):
    """`RoadTrafficEnv.step` on the card through the graphs of its input
    key, captured at the key's first call."""
    record_u = env._record_u(reset_draws, generator)
    inputs = _fields(state) + [actions] + ([] if record_u is None else [record_u])
    noise = None
    if env.cfg.is_obs_noise:
        shape = tuple(state.pos.shape[:2]) + (env.cfg.obs_dim,)
        if obs_noise is not None and tuple(obs_noise.shape) != shape:
            raise ValueError(f"obs_noise is {tuple(obs_noise.shape)}, the observation {shape}")
        noise = (shape, torch.float32 if obs_noise is None else obs_noise.dtype)
    key = (tuple((t.shape, t.dtype, t.device) for t in inputs), noise)
    graphs = env._graphs.get(key)
    if graphs is None:
        graphs = env._graphs[key] = StepGraphs(env, inputs, noise)
    return graphs.step(env, inputs, generator, reset_draws, obs_noise)
