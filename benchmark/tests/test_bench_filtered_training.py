"""The filtered training cell (`cpm_entire_n15_cbf_train.train_filtered`) on
the CPU at a tiny size: it runs, prints the contract line and is correct;
its traced run reads the program's spans; and `correct` comes out false
for each fault its check has to see in the timed path, and for the
control."""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys

import pytest

from benchmark.run import HERE, ROOT, reader
from benchmark.tests.conftest import SEED
from benchmark.tests.test_bench_faults import (_half_batch_loss, _nominal_as_safe,
                                               _unchanged_update)

CELL = "cpm_entire_n15_cbf_train.train_filtered"
# N=4, B=4, T=4: the 16 frames are one minibatch, so an iteration has one
# update, and that one is checked.
TINY = {"config": {"parameters": {"n_agents": 4, "max_steps": 4, "minibatch_size": 16}},
        "traffic": {"batch": 4, "checked_updates": 1, "sampled_iteration_below": 2}}
# 8 agents in 16 envs: after 2+15 iterations from the nominal start some
# solve is still short of where the warm start leads (at N=4, B=4 the two
# starts reach the same point in these few steps).
CROWDED = {"config": {"parameters": {"n_agents": 8, "max_steps": 4, "minibatch_size": 64}},
           "traffic": {"batch": 16, "checked_updates": 1, "sampled_iteration_below": 2}}
# The cell's per-layer metrics.
METRICS = ("rollout_s.train_filtered", "update_s.train_filtered", "traced_s.filter.train_filtered",
           "traced_s.train.rollout.act.train_filtered", "k1_roofline.train_filtered",
           "mfu.train_filtered", "device_idle.train_filtered", "host_syncs.train_filtered")
# The readers of the program's own spans and counters (a CPU run has no
# device time: the rooflines, the share of the peak and the idle read
# nothing there).
PROGRAM_METRICS = ("traced_s.filter.train_filtered", "traced_s.train.rollout.act.train_filtered",
                   "host_syncs.train_filtered")


def run_tiny(capsys, trace: int = 0, control=None, overrides=None):
    """(exit code, parsed result line, standard error) of one CPU run, at
    `TINY` unless `overrides` are given."""
    from benchmark import run

    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.5",
                   "--trace", str(trace)], device="cpu", overrides=overrides or TINY,
                  control=control)
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_correct_and_prints_the_contract_line(capsys, trace):
    from sigmarl_tpu_torch import trace as program_trace

    program_trace.reset()
    rc, line, err = run_tiny(capsys, trace)
    assert rc == 0, err
    assert line["correct"] is True, err
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == {"action_gap", "qp_objective_gap", "safe_action_gap",
                                   "nominal_action_gap", "lane_margin_gap", "env_gap", "gae_gap",
                                   "loss_gap", "grad_gap", "update_gap"}
    if trace:
        assert set(PROGRAM_METRICS) <= set(line["metrics"]) <= set(METRICS)
        for name in PROGRAM_METRICS:
            value = line["metrics"][name]["value"]
            assert value == 0 if name.startswith("host_syncs") else value > 0, (name, value)
    else:
        assert set(line["metrics"]) == {"train_env_steps_per_s", "setup_s"}


def test_the_cell_is_declared_as_the_configuration_states():
    s = spec()
    cell = next(w for w in s["workloads"] if w["name"] == CELL)
    config = next(c for c in s["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, config["file"])) as f:
        data = json.load(f)
    assert cell["chips"] == 1 and len(cell["why"]) <= 200 and len(config["why"]) <= 200
    assert data["reduced"] == config["reduced"] and set(data["upstream"]) == set(data["reduced"])
    assert data["filter"] == {"n_circles": 3, "newton_iters": 15, "newton_soft_iters": 2}
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert CELL in e2e["train_env_steps_per_s"]["workloads"]
    assert CELL not in e2e["env_steps_per_s"]["workloads"] + e2e["decision_p95_ms"]["workloads"]
    per_layer = {m["name"]: m for m in s["per_layer"]}
    for name in METRICS:
        m = per_layer[name]
        assert m["workloads"] == [CELL] and m["moves"] == "train_env_steps_per_s"
        assert os.path.isfile(os.path.join(HERE, "metrics", name + ".py"))
    for sub in ("traffic/train_filtered", f"workloads/{CELL}"):
        assert os.path.isfile(os.path.join(HERE, sub + ".json"))


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    """A tree before the rollout's `.act` span (or without tracing at all)
    reads None and does not raise."""
    from sigmarl_tpu_torch import trace

    trace.reset()
    for name in PROGRAM_METRICS:
        assert reader(name)({"traced_units": 1}) is None, name
    monkeypatch.setitem(sys.modules, "sigmarl_tpu_torch.trace", None)
    import sigmarl_tpu_torch

    monkeypatch.delattr(sigmarl_tpu_torch, "trace")
    for name in PROGRAM_METRICS:
        assert reader(name)({"traced_units": 1}) is None, name


def _cold_start(monkeypatch):
    """The filter drops its warm start (the previous step's u*)."""
    from sigmarl_tpu_torch.safety.cbf_qp import CBFSafetyFilter

    filt = CBFSafetyFilter.filter_actions

    def broken(self, state, rl_actions, u_init=None, **kw):
        return filt(self, state, rl_actions, **kw)

    monkeypatch.setattr(CBFSafetyFilter, "filter_actions", broken)


def _no_deviation_reward(monkeypatch):
    """The program's env rewards by "distance", without the penalty on the
    filter's correction (the reference keeps "cbf")."""
    env = importlib.import_module("sigmarl_tpu_torch.env.env")
    rewards = env.compute_rewards

    def broken(cfg, *args, **kw):
        return rewards(dataclasses.replace(cfg, rew_method="distance"), *args, **kw)

    monkeypatch.setattr(env, "compute_rewards", broken)


# (fault, the numbers that have to fail: all of them, or any one of a set,
# the sizes)
FAULTS = [
    (_nominal_as_safe, ("safe_action_gap", "env_gap"), all, TINY),
    (_cold_start, ("qp_objective_gap", "safe_action_gap"), any, CROWDED),
    (_no_deviation_reward, ("env_gap",), all, TINY),
    (_unchanged_update, ("grad_gap", "update_gap"), all, TINY),
    (_half_batch_loss, ("loss_gap",), all, TINY),
]


@pytest.mark.parametrize("fault, numbers, which, sizes", FAULTS,
                         ids=[f.__name__[1:] for f, *_ in FAULTS])
def test_a_broken_filtered_iteration_is_not_correct(capsys, monkeypatch, fault, numbers, which,
                                                    sizes):
    fault(monkeypatch)
    rc, line, err = run_tiny(capsys, overrides=sizes)
    assert rc == 0, err
    assert line["correct"] is False
    fails = [line["checks"][n]["value"] > line["checks"][n]["limit"] for n in numbers]
    assert which(fails), (numbers, line["checks"])


def test_the_control_is_not_correct(capsys):
    rc, line, err = run_tiny(capsys, control=True)
    assert rc == 0, err
    assert line["correct"] is False
