"""Whole MAPPO training iterations back to back: the cost of training.

Set-up builds the trainer with weights from the seed and runs
`warmup_iterations` iterations (the first captures the update's CUDA
graph and is recorded for the check, with the start). Each iteration
gets every draw from the benchmark (`harness/training.py`). In the window
iterations are begun until `--seconds` have passed and each runs to its
end; the one the seed drew from the first `sampled_iteration_below` is
recorded for the check too (the window runs on until it has begun, which
a window of some iterations always has). The rate is B x T env-steps per
iteration over the time from the window's start to the last iteration's
end (the trainer synchronises the card at the end of each phase)."""

from __future__ import annotations

import math
import time

from benchmark.harness import training
from benchmark.harness.card import synchronize
from benchmark.harness.spans import Spans
from benchmark.harness.trace import traced


class Driver:
    end_to_end = ("train_env_steps_per_s",)

    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, dev):
        self.config, self.traffic, self.limits, self.seed, self.dev = (
            config, traffic, limits, seed, dev)
        self.batch = traffic["batch"]
        self.attempted = self.failed = 0

    def setup(self) -> None:
        self.tr = training.Trainer(self.config, self.batch, self.seed, self.dev,
                                   self.traffic["sampled_steps"], self.traffic["checked_updates"],
                                   self.traffic["sampled_iteration_below"])
        self.tr.first_iteration()
        for _ in range(self.traffic["warmup_iterations"] - 1):
            self.tr.iterate()
        synchronize(self.dev)

    def window(self, seconds: float) -> dict:
        tr = self.tr
        per_iter = self.batch * tr.p.max_steps
        rollout_s = update_s = 0.0
        losses = []
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or n <= tr.window_iteration:
            recorded = n == tr.window_iteration and len(tr.records) == 1
            m = tr.record_iteration() if recorded else tr.iterate()
            rollout_s += m["seconds_rollout"]
            update_s += m["seconds_update"]
            losses.append(m["loss_objective"] + m["loss_critic"])
            n += 1
        synchronize(self.dev)
        elapsed = time.perf_counter() - t0
        self.attempted += n * per_iter
        bad = sum(not math.isfinite(float(x)) for x in losses)
        self.failed += bad * per_iter
        self.stats = {"iterations": n, "seconds": elapsed, "rollout_s": rollout_s,
                      "update_s": update_s, "shapes": tr.shapes()}
        return {"train_env_steps_per_s": n * per_iter / elapsed}

    def layers(self, seconds: float) -> dict:
        """The traced run: the window (the trainer's own phase times), then
        one iteration under the profiler with spans around its phases."""
        self.window(seconds)
        spans = Spans()
        for attr, name in (("rollout", "bench.rollout"), ("frames", "bench.gae"),
                           ("update", "bench.update")):
            spans.wrap(self.tr.trainer, attr, name)
        summary = traced(self.tr.iterate, self.dev)
        spans.restore()
        return {"train": self.stats, "trace": summary, "traced_units": 1,
                "window": (self.stats["iterations"], self.stats["seconds"])}

    def release(self) -> None:
        self.weights = self.tr.weights
        self.tr.release()

    def check(self, control=None) -> list:
        variant = {True: "lower", False: None}.get(control, control)
        return training.check(self.config, self.batch, self.dev, self.weights, self.tr.records,
                              self.limits, variant)
