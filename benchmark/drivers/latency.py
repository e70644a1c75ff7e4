"""Closed loop of single filtered decisions at small batch: the lab's
control loop, one decision in flight and no pause between decisions.

Set-up builds the configuration at the traffic's batch (weights from the
seed), resets every env from the benchmark's draws and makes
`warmup_steps` decisions. In the window each decision is one filtered
step ended by `torch.cuda.synchronize()` (the read-back before
actuation), timed on the host's clock; the metric is the 95th percentile
of every decision begun in the window."""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import mainpath
from benchmark.harness.card import synchronize
from benchmark.harness.spans import Spans, host_syncs
from benchmark.harness.trace import traced


class Driver:
    end_to_end = ("decision_p95_ms",)

    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, dev):
        self.config, self.traffic, self.limits, self.seed, self.dev = (
            config, traffic, limits, seed, dev)
        self.batch = traffic["batch"]
        self.sampled = mainpath.sampled_steps(seed, traffic["sampled_steps"],
                                              traffic["sample_below"])
        self.attempted = self.failed = 0

    def setup(self) -> None:
        self.mp = mainpath.MainPath(self.config, self.batch, self.seed, self.dev)
        self.mp.start_reset()
        for _ in range(self.traffic["warmup_steps"]):
            self.mp.step()
            synchronize(self.dev)

    def decide(self, record: bool = False) -> None:
        self.mp.step(record)
        synchronize(self.dev)  # the control loop waits before actuating

    def window(self, seconds: float) -> dict:
        self.mp.unsolved.zero_()
        lat = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            self.decide(record=len(lat) in self.sampled)
            lat.append(time.perf_counter() - ts)
        self.units = (len(lat), time.perf_counter() - t0)
        self.attempted += len(lat)
        self.failed += int(self.mp.unsolved)
        return {"decision_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95))}

    def layers(self, seconds: float) -> dict:
        """The traced run: the host syncs of one decision, the window with
        host spans around the policy, the filter and the env step, then
        `traced_steps` decisions under the profiler."""
        syncs = None
        if self.dev.type == "cuda":
            syncs = len(host_syncs(self.mp.step))
        spans = Spans()
        spans.wrap(self.mp.policy, "forward", "bench.policy")
        spans.wrap(self.mp.cbf, "filter_actions", "bench.filter")
        spans.wrap(self.mp.env, "step", "bench.env_step")
        self.window(seconds)
        host = {k: spans.ms_per_call(k) for k in spans.totals}
        steps = self.traffic["traced_steps"]
        summary = traced(lambda: [self.decide() for _ in range(steps)], self.dev)
        spans.restore()
        return {"spans_ms": host, "trace": summary, "host_syncs": syncs, "traced_units": steps,
                "window": self.units}

    def release(self) -> None:
        self.weights = self.mp.weights
        self.mp.release()

    def check(self, control: bool = False) -> list:
        return mainpath.check(self.config, self.batch, self.dev, self.weights, self.mp.records,
                              self.limits, control, self.mp.start)
