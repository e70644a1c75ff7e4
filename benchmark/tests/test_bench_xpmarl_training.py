"""The XP-MARL training cell (`cpm_entire_n15_xpmarl.train_xpmarl`) and the
grouped rollout cell (`cpm_entire_n15.rollout_grouped`) on the CPU at a
tiny size: they run, print the contract line and are correct; the traced
run reads the program's spans; `correct` comes out false for each fault
the XP-MARL check has to see, on the number named for it, and for the
control of each cell."""

from __future__ import annotations

import importlib
import json
import os
import sys

import pytest
import torch

from benchmark.run import HERE, ROOT, reader
from benchmark.tests.conftest import SEED

CELL = "cpm_entire_n15_xpmarl.train_xpmarl"
GROUPED = "cpm_entire_n15.rollout_grouped"
# N=4, B=4, T=4: the 16 frames are one minibatch, so an iteration has one
# update, and that one is checked.
TINY = {"config": {"parameters": {"n_agents": 4, "max_steps": 4, "minibatch_size": 16}},
        "traffic": {"batch": 4, "checked_updates": 1, "sampled_iteration_below": 2}}
# 8 agents in groups of at most 4: two groups, pairs across them split.
GROUPED_TINY = {"config": {"parameters": {"n_agents": 8}},
                "traffic": {"batch": 4, "warmup_steps": 2, "sampled_steps": 2,
                            "sample_below": 2, "traced_steps": 2}}
CHECKS = {"score_gap", "rank_mismatch", "obs_tail_gap", "action_gap", "env_gap", "gae_gap",
          "loss_gap", "grad_gap", "update_gap"}
METRICS = ("traced_s.train.rollout.act.priority.train_xpmarl",
           "traced_s.train.rollout.act.turns.train_xpmarl", "rollout_s.train_xpmarl",
           "update_s.train_xpmarl", "host_syncs.train_xpmarl", "device_idle.train_xpmarl",
           "mfu.train_xpmarl")
GROUPED_METRICS = ("device_idle.rollout_grouped", "k1_ms.rollout_grouped")
# The readers of the program's own spans and counters (a CPU run has no
# device time: the share of the peak and the idle read nothing there).
PROGRAM_METRICS = ("traced_s.train.rollout.act.priority.train_xpmarl",
                   "traced_s.train.rollout.act.turns.train_xpmarl", "host_syncs.train_xpmarl")


def run_tiny(capsys, cell=CELL, trace: int = 0, control=None, overrides=None):
    """(exit code, parsed result line, standard error) of one CPU run."""
    from benchmark import run

    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.5",
                   "--trace", str(trace)], device="cpu",
                  overrides=overrides or (TINY if cell == CELL else GROUPED_TINY),
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
    rc, line, err = run_tiny(capsys, trace=trace)
    assert rc == 0, err
    assert line["correct"] is True, err
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == CHECKS
    if trace:
        assert set(PROGRAM_METRICS) <= set(line["metrics"]) <= set(METRICS)
        for name in PROGRAM_METRICS:
            value = line["metrics"][name]["value"]
            assert value == 0 if name.startswith("host_syncs") else value > 0, (name, value)
    else:
        assert set(line["metrics"]) == {"train_env_steps_per_s", "setup_s"}


def test_the_grouped_cell_runs_correct_and_its_control_does_not(capsys):
    rc, line, err = run_tiny(capsys, GROUPED)
    assert rc == 0, err
    assert line["correct"] is True, err
    assert set(line["metrics"]) == {"env_steps_per_s", "setup_s"}
    rc, line, err = run_tiny(capsys, GROUPED, control=True)
    assert rc == 0, err
    assert line["correct"] is False


def test_the_grouped_cells_filter_is_grouped():
    from benchmark.drivers import rollout_grouped

    with open(os.path.join(HERE, "traffic", "rollout_grouped.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(HERE, "configs", "cpm_entire_n15.json")) as f:
        config = json.load(f)
    run = rollout_grouped.Driver(config, traffic, {}, SEED, torch.device("cpu"))
    assert run.config["filter"]["max_group_size"] == traffic["max_group_size"] == 4
    assert config["filter"]["max_group_size"] == 0  # the file is the ungrouped cell's


def test_the_cells_are_declared_as_the_configuration_states():
    s = spec()
    cells = {w["name"]: w for w in s["workloads"]}
    config = next(c for c in s["configs"] if c["name"] == cells[CELL]["config"])
    with open(os.path.join(ROOT, config["file"])) as f:
        data = json.load(f)
    assert cells[CELL]["chips"] == cells[GROUPED]["chips"] == 1
    assert cells[GROUPED]["config"] == "cpm_entire_n15"
    assert data["reduced"] == config["reduced"] and set(data["upstream"]) == set(data["reduced"])
    assert data["policy"] == data["critic"] == {"hidden": [256, 256, 256]}
    assert data["priority_policy"] == data["priority_critic"] == {"hidden": [256, 256]}
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert CELL in e2e["train_env_steps_per_s"]["workloads"]
    assert GROUPED in e2e["env_steps_per_s"]["workloads"]
    per_layer = {m["name"]: m for m in s["per_layer"]}
    for names, cell, moves in ((METRICS, CELL, "train_env_steps_per_s"),
                               (GROUPED_METRICS, GROUPED, "env_steps_per_s")):
        for name in names:
            m = per_layer[name]
            assert m["workloads"] == [cell] and m["moves"] == moves
            assert os.path.isfile(os.path.join(HERE, "metrics", name + ".py"))
    for sub in ("traffic/train_xpmarl", f"workloads/{CELL}", "traffic/rollout_grouped",
                f"workloads/{GROUPED}"):
        assert os.path.isfile(os.path.join(HERE, sub + ".json"))


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    """A tree before the rank's and the turns' spans (or without tracing
    at all) reads None and does not raise."""
    from sigmarl_tpu_torch import trace

    trace.reset()
    for name in PROGRAM_METRICS:
        assert reader(name)({"traced_units": 1}) is None, name
    monkeypatch.setitem(sys.modules, "sigmarl_tpu_torch.trace", None)
    import sigmarl_tpu_torch

    monkeypatch.delattr(sigmarl_tpu_torch, "trace")
    for name in PROGRAM_METRICS:
        assert reader(name)({"traced_units": 1}) is None, name


def _mappo():
    return importlib.import_module("sigmarl_tpu_torch.rl.mappo_cavs")


def _ascending_turns(monkeypatch):
    """The agents act lowest priority first."""
    mod = _mappo()
    rank = mod.priority_rank

    def broken(*args, **kw):
        out = rank(*args, **kw)
        return out._replace(rank=out.rank.flip(-1))

    monkeypatch.setattr(mod, "priority_rank", broken)


def _no_propagation(monkeypatch):
    """Every turn acts on a zero tail: no neighbour's decided action."""
    mod = _mappo()
    turns = mod.prioritized_action_propagation

    def broken(policy, base_obs, rank, nearing_idx, *args, **kw):
        return turns(policy, base_obs, rank, nearing_idx[..., :0], *args, **kw)

    monkeypatch.setattr(mod, "prioritized_action_propagation", broken)


def _no_priority_loss(monkeypatch):
    """The priority's loss is reported but left out of the update."""
    mod = _mappo()
    loss = mod.MAPPOCAVs.loss

    def broken(self, nets, mb, entropy_noise, prio_entropy_noise=None, count=None):
        total, stats = loss(self, nets, mb, entropy_noise, prio_entropy_noise, count)
        prio = stats["loss_priority"]
        return total - (prio - prio.detach()), stats  # its value kept, its gradient gone

    monkeypatch.setattr(mod.MAPPOCAVs, "loss", broken)


def _policy_critic_for_priority(monkeypatch):
    """The priority stream's GAE takes the policy critic's values."""
    mod = _mappo()
    frames = mod.MAPPOCAVs.frames

    def broken(self, state, batch):
        data, prio = frames(self, state, batch)
        return dict(data, prio_adv=data["adv"], prio_vt=data["vt"]), prio

    monkeypatch.setattr(mod.MAPPOCAVs, "frames", broken)


# (fault, the numbers that have to fail: all of them, or any one of a set)
FAULTS = [
    (_ascending_turns, ("rank_mismatch",), all),
    (_no_propagation, ("obs_tail_gap",), all),
    (_no_priority_loss, ("loss_gap", "grad_gap"), any),
    (_policy_critic_for_priority, ("gae_gap",), all),
]


@pytest.mark.parametrize("fault, numbers, which", FAULTS, ids=[f.__name__[1:] for f, *_ in FAULTS])
def test_a_broken_xpmarl_iteration_is_not_correct(capsys, monkeypatch, fault, numbers, which):
    fault(monkeypatch)
    rc, line, err = run_tiny(capsys)
    assert rc == 0, err
    assert line["correct"] is False
    fails = [line["checks"][n]["value"] > line["checks"][n]["limit"] for n in numbers]
    assert which(fails), (numbers, line["checks"])


def test_the_control_is_not_correct(capsys):
    rc, line, err = run_tiny(capsys, control=True)
    assert rc == 0, err
    assert line["correct"] is False
