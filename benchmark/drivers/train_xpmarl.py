"""Whole XP-MARL training iterations back to back: the cost of training
with learned priority, whose agents act in sequential priority turns.

The train cell's driver (`drivers/train.py`: set-up, window, the traced
iteration) on `harness/xpmarl_training.py`'s trainer: the priority actor
ranks the agents of every env, the policy runs once per priority turn on
the acting agents' rows, and every update steps the four networks. An
iteration's env-steps whose loss is not finite count as failed. The
traced run's line also reads the acting's spans `.priority` and
`.turns`."""

from __future__ import annotations

from benchmark.drivers import train
from benchmark.harness import xpmarl_training
from benchmark.harness.card import synchronize


class Driver(train.Driver):

    def setup(self) -> None:
        t = self.traffic
        self.tr = xpmarl_training.XPMARLTrainer(
            self.config, self.batch, self.seed, self.dev, t["sampled_steps"],
            t["checked_updates"], t["sampled_iteration_below"])
        self.tr.first_iteration()
        for _ in range(t["warmup_iterations"] - 1):
            self.tr.iterate()
        synchronize(self.dev)

    def check(self, control=None) -> list:
        variant = {True: "lower", False: None}.get(control, control)
        return xpmarl_training.check(self.config, self.batch, self.dev, self.weights,
                                     self.tr.records, self.limits, variant)
