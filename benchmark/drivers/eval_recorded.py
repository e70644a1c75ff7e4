"""`main_eval`'s recorded CBF-filter evaluation back to back: whole
testing-mode episodes through the filter with the CLF nominal controller,
every step recorded and copied to the host a chunk at a time.

Set-up builds env, filter and nominal policy through `main_eval.build`
(`harness/clf_eval.py`), then runs `warmup_chunks` chunks of
`record_chunk` steps from `env.reset` (the graphs' captures), every step
watched until one in which an agent reset alone is kept for the check
(`search_chunks` chunks more at most). The window runs `episode_steps`-step
rollouts from `env.reset` back to back, as `main_eval` runs one; a rollout
begun in the window runs to its end, and the rate is B x steps over the
time from the window's start to the last rollout's return, its host
record included. The first rollout's sampled steps and its episode's
last step (every env resets there) are checked."""

from __future__ import annotations

import time

from benchmark.harness import clf_eval, mainpath
from benchmark.harness.card import synchronize
from benchmark.harness.trace import traced


class Driver:
    end_to_end = ("env_steps_per_s",)

    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, dev):
        clf_eval.refuse(config)
        self.config, self.traffic, self.limits, self.seed, self.dev = (
            config, traffic, limits, seed, dev)
        self.batch, self.steps = traffic["batch"], traffic["episode_steps"]
        # testing mode: every env's episode ends at step max_steps - 1, the
        # rollout's step index max_steps - 2
        self.episode_end = config["parameters"]["max_steps"] - 2
        self.sampled = mainpath.sampled_steps(seed, traffic["sampled_steps"],
                                              traffic["sample_below"]) | {self.episode_end}
        self.attempted = self.failed = 0

    def setup(self) -> None:
        t = self.traffic
        self.ev = clf_eval.ClfEval(self.config, self.batch, self.seed, self.dev,
                                   t["record_chunk"])
        self.ev.warm_up(t["warmup_chunks"], t["search_chunks"])
        synchronize(self.dev)

    def window(self, seconds: float) -> dict:
        ev = self.ev
        ev.unsolved = 0
        runs = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ev.run(self.steps, sample=self.sampled if runs == 0 and not ev.records else ())
            runs += 1
        synchronize(self.dev)
        elapsed = time.perf_counter() - t0
        self.attempted += runs * self.steps * self.batch
        self.failed += ev.unsolved
        self.units = (runs * self.steps, elapsed)
        return {"env_steps_per_s": runs * self.steps * self.batch / elapsed}

    def layers(self, seconds: float) -> dict:
        """The traced run: the window, then `traced_chunks` recorded chunks
        from `env.reset` under the profiler, K1's launches and IEEE
        re-solves counted around them."""
        self.window(seconds)
        steps = self.traffic["record_chunk"] * self.traffic["traced_chunks"]
        before = self._k1_counts()
        summary = traced(lambda: self.ev.run(steps), self.dev)
        after = self._k1_counts()
        k1 = None if before is None else tuple(a - b for a, b in zip(after, before))
        return {"trace": summary, "traced_units": steps, "window": self.units,
                "batch": self.batch, "k1_ieee": k1}

    def _k1_counts(self):
        """(K1's launches, its envs solved with IEEE divisions) so far, the
        card's count collected first (a read of the card, outside any
        timed stretch); None where the program does not count them."""
        from sigmarl_tpu_torch import trace
        from sigmarl_tpu_torch.ops import qp

        if not hasattr(qp, "collect_ieee_resolves"):
            return None
        if self.dev.type == "cuda":
            qp.collect_ieee_resolves(self.dev)
        counts = trace.snapshot()["counts"]
        return counts.get("k1.launches", 0), counts.get("k1.ieee_resolves", 0)

    def release(self) -> None:
        self.ev.release()

    def check(self, control: bool = False) -> list:
        return clf_eval.check(self.config, self.batch, self.dev, self.ev, self.episode_end,
                              self.limits, control)
