"""Closed loop of CBF-filtered rollout steps at a fixed batch: the main
path's throughput.

Set-up builds the configuration's env, filter and policy (weights from
the seed), then runs `warmup_steps` steps from the all-zero state, whose
first step resets every env (the same shapes the window uses: full-width
and compacted resets both occur). The window then issues steps back to
back for `--seconds`; steps begun in it run to their end, and the rate is
B x steps over the time from the window's start to the end of the last
step (one synchronise there)."""

from __future__ import annotations

import time

from benchmark.harness import mainpath
from benchmark.harness.card import synchronize
from benchmark.harness.spans import Spans
from benchmark.harness.trace import traced


class Driver:
    end_to_end = ("env_steps_per_s",)

    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, dev):
        self.config, self.traffic, self.limits, self.seed, self.dev = (
            config, traffic, limits, seed, dev)
        self.batch = traffic["batch"]
        self.sampled = mainpath.sampled_steps(seed, traffic["sampled_steps"],
                                              traffic["sample_below"])
        self.attempted = self.failed = 0

    def setup(self) -> None:
        self.mp = mainpath.MainPath(self.config, self.batch, self.seed, self.dev)
        self.mp.start_zero()
        # The first step starts every env (a full-width reset): it is
        # checked as the start.
        for i in range(self.traffic["warmup_steps"]):
            self.mp.step(record=i == 0)
        synchronize(self.dev)

    def window(self, seconds: float) -> dict:
        mp = self.mp
        mp.unsolved.zero_()
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            mp.step(record=n in self.sampled)
            n += 1
        synchronize(self.dev)
        elapsed = time.perf_counter() - t0
        self.attempted += n * self.batch
        self.failed += int(mp.unsolved)
        self.units = (n, elapsed)
        return {"env_steps_per_s": n * self.batch / elapsed}

    def layers(self, seconds: float) -> dict:
        """The traced run: the window with host spans around the policy, the
        filter and the env step, then `traced_steps` steps under the
        profiler."""
        mp, spans = self.mp, Spans()
        spans.wrap(mp.policy, "forward", "bench.policy")
        spans.wrap(mp.cbf, "filter_actions", "bench.filter")
        spans.wrap(mp.env, "step", "bench.env_step")
        self.window(seconds)
        host = {k: spans.ms_per_call(k) for k in spans.totals}
        steps = self.traffic["traced_steps"]
        summary = traced(lambda: [mp.step() for _ in range(steps)], self.dev)
        spans.restore()
        return {"spans_ms": host, "trace": summary, "traced_units": steps,
                "window": self.units, "shapes": self.shapes()}

    def shapes(self) -> dict:
        env, cfg = self.mp.env, self.config
        return {"batch": self.batch, "n_agents": env.n_agents, "obs_dim": env.obs_dim,
                "n_circles": cfg["filter"]["n_circles"], "hidden": cfg["policy"]["hidden"],
                "newton_iters": cfg["filter"]["newton_iters"],
                "soft_iters": cfg["filter"]["newton_soft_iters"],
                "pd_chunks": self.mp.cbf.cfg.pd_topk_chunks,
                "segment_table": list(env.tables.left_seg.shape)}

    def release(self) -> None:
        self.weights = self.mp.weights
        self.mp.release()

    def check(self, control: bool = False) -> list:
        return mainpath.check(self.config, self.batch, self.dev, self.weights, self.mp.records,
                              self.limits, control, self.mp.start)
