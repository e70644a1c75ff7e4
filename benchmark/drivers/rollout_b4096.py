"""The main path at B = `sub_batches` x `batch`: one env, filter and
policy, and one state per sub-batch, the sub-batches stepped in turn each
step, as the port's `bench.py::measure` frames a batch too large for one
step (and JAX's `lax.map`).

Sub-batch s starts from the all-zero state and draws from a generator of
its own (sub-batch 0's, seeded with the run's seed, also draws the
policy's weights); each is warm-started from its own previous u*. Set-up
steps every sub-batch `warmup_steps` times (sub-batch 0's first step is
checked as the start); the window steps them in turn for `--seconds`, and
the rate is `sub_batches` x B x steps over the time from the window's
start to the end of the last step. The steps the seed samples are
checked in the first and the last sub-batch, each from its own state."""

from __future__ import annotations

import copy
import time

import torch

from benchmark.drivers import rollout
from benchmark.harness import mainpath
from benchmark.harness.card import synchronize
from benchmark.harness.spans import Spans
from benchmark.harness.trace import traced


def sub_batch(first: mainpath.MainPath, seed: int, s: int) -> mainpath.MainPath:
    """Sub-batch `s` beside `first`: its env, filter, policy and weights,
    a generator of its own and no state yet."""
    mp = copy.copy(first)
    mp.gen = torch.Generator(device=first.dev).manual_seed(seed * 4 + s)
    mp.unsolved = torch.zeros_like(first.unsolved)
    mp.records, mp.start, mp.state, mp.obs = [], None, None, None
    return mp


class Driver(rollout.Driver):

    def setup(self) -> None:
        first = mainpath.MainPath(self.config, self.batch, self.seed, self.dev)
        n = self.traffic["sub_batches"]
        self.parts = [first] + [sub_batch(first, self.seed, s) for s in range(1, n)]
        self.mp = first
        for mp in self.parts:
            mp.start_zero()
        for i in range(self.traffic["warmup_steps"]):
            for mp in self.parts:
                mp.step(record=i == 0 and mp is first)
        synchronize(self.dev)

    def step(self, record: bool = False) -> None:
        """One step of every sub-batch, in turn; with `record`, the first's
        and the last's kept for the check."""
        for mp in self.parts:
            mp.step(record=record and mp in (self.parts[0], self.parts[-1]))

    def window(self, seconds: float) -> dict:
        for mp in self.parts:
            mp.unsolved.zero_()
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.step(record=n in self.sampled)
            n += 1
        synchronize(self.dev)
        elapsed = time.perf_counter() - t0
        width = len(self.parts) * self.batch
        self.attempted += n * width
        self.failed += sum(int(mp.unsolved) for mp in self.parts)
        self.units = (n, elapsed)
        return {"env_steps_per_s": n * width / elapsed}

    def layers(self, seconds: float) -> dict:
        """The traced run: the window with host spans around the policy, the
        filter and the env step, then `traced_steps` steps of every
        sub-batch under the profiler."""
        mp, spans = self.mp, Spans()
        spans.wrap(mp.policy, "forward", "bench.policy")
        spans.wrap(mp.cbf, "filter_actions", "bench.filter")
        spans.wrap(mp.env, "step", "bench.env_step")
        self.window(seconds)
        host = {k: spans.ms_per_call(k) for k in spans.totals}
        steps = self.traffic["traced_steps"]
        summary = traced(lambda: [self.step() for _ in range(steps)], self.dev)
        spans.restore()
        return {"spans_ms": host, "trace": summary, "traced_units": steps,
                "window": self.units, "shapes": self.shapes()}

    def release(self) -> None:
        self.weights = self.mp.weights
        self.records = self.parts[0].records + self.parts[-1].records
        for mp in self.parts:
            mp.release()

    def check(self, control: bool = False) -> list:
        return mainpath.check(self.config, self.batch, self.dev, self.weights, self.records,
                              self.limits, control, self.mp.start)
