"""Whole CBF-filtered MAPPO training iterations back to back: the cost of
training with the safety filter in the loop.

The train cell's driver (`drivers/train.py`: set-up, window, the traced
iteration) on `harness/filtered_training.py`'s trainer, whose every
rollout action passes the centralized CBF-QP filter at the
configuration's budget. An env-step whose filter fell back to the nominal
action (no finite solution) counts as failed, as do an iteration's
env-steps where its loss is not finite. The traced run's line also reads
the filter's spans and K1 in the trace (`shapes`)."""

from __future__ import annotations

from benchmark.drivers import train
from benchmark.harness import filtered_training
from benchmark.harness.card import synchronize


class Driver(train.Driver):

    def setup(self) -> None:
        t = self.traffic
        self.tr = filtered_training.FilteredTrainer(
            self.config, self.batch, self.seed, self.dev, t["sampled_steps"],
            t["checked_updates"], t["sampled_iteration_below"])
        self.tr.first_iteration()
        for _ in range(t["warmup_iterations"] - 1):
            self.tr.iterate()
        synchronize(self.dev)

    def window(self, seconds: float) -> dict:
        self.tr.unsolved.zero_()
        out = super().window(seconds)
        self.failed += round(float(self.tr.unsolved))
        return out

    def layers(self, seconds: float) -> dict:
        return dict(super().layers(seconds), shapes=self.tr.shapes())

    def check(self, control=None) -> list:
        variant = {True: "lower", False: None}.get(control, control)
        return filtered_training.check(self.config, self.batch, self.dev, self.weights,
                                       self.tr.records, self.limits, variant)
