"""`correct` comes out false where the timed path is broken underneath
(each fault a cell can have), and for the control put in the program's
place; true on the same runs unbroken (`test_bench_harness.py`)."""

from __future__ import annotations

import dataclasses
import importlib

import pytest
import torch

from benchmark.tests.conftest import run_cell


def _unchanged_state(monkeypatch):
    from sigmarl_tpu_torch.env.env import RoadTrafficEnv

    step = RoadTrafficEnv.step

    def broken(self, state, actions, **kw):
        out = step(self, state, actions, **kw)
        return (state,) + out[1:]

    monkeypatch.setattr(RoadTrafficEnv, "step", broken)


def _half_batch_rollout(monkeypatch):
    """The env step computes the first half of the envs; the rest keep
    their state."""
    from sigmarl_tpu_torch.env.env import RoadTrafficEnv

    step = RoadTrafficEnv.step

    def broken(self, state, actions, **kw):
        out = step(self, state, actions, **kw)
        h = actions.shape[0] // 2
        kept = {f.name: torch.cat([getattr(out[0], f.name)[:h], getattr(state, f.name)[h:]])
                for f in dataclasses.fields(state)
                if getattr(state, f.name).dim() and getattr(state, f.name).shape[0] == 2 * h}
        return (dataclasses.replace(out[0], **kept),) + out[1:]

    monkeypatch.setattr(RoadTrafficEnv, "step", broken)


def _altered_action(monkeypatch):
    from sigmarl_tpu_torch.rl import networks

    sample = networks.tanh_normal_sample

    def broken(*args, **kw):
        act, lp = sample(*args, **kw)
        act = act.clone()
        act[0, 0, 0] += 0.01
        return act, lp

    monkeypatch.setattr(networks, "tanh_normal_sample", broken)


def _unchanged_update(monkeypatch):
    from sigmarl_tpu_torch.rl.optim import ClippedAdam

    monkeypatch.setattr(ClippedAdam, "apply", lambda self, *a, **k: None)


def _stale_frames(monkeypatch):
    """The update program loads its first iteration's frames only: later
    iterations' updates train on them again."""
    from sigmarl_tpu_torch.rl.update_program import UpdateProgram

    begin = UpdateProgram.begin

    def broken(self, data, count):
        if getattr(self, "loaded", False):
            data = self.data
        self.loaded = True
        begin(self, data, count)

    monkeypatch.setattr(UpdateProgram, "begin", broken)


def _first_schedule_rows(monkeypatch):
    """The update program reads the scalars (step size, bias corrections)
    of the first iteration's updates in every iteration."""
    from sigmarl_tpu_torch.rl.update_program import UpdateProgram

    begin = UpdateProgram.begin
    monkeypatch.setattr(UpdateProgram, "begin", lambda self, data, count: begin(self, data, 0))


def _nominal_as_safe(monkeypatch):
    """The filter solves for u* but returns the nominal action as the
    applied one."""
    from sigmarl_tpu_torch.safety.cbf_qp import CBFSafetyFilter

    filt = CBFSafetyFilter.filter_actions

    def broken(self, *args, **kw):
        out = filt(self, *args, **kw)
        return out._replace(safe_actions=out.nominal_actions)

    monkeypatch.setattr(CBFSafetyFilter, "filter_actions", broken)


def _half_batch_loss(monkeypatch):
    """The loss takes the mean over the first half of the minibatch."""
    mappo_cavs = importlib.import_module("sigmarl_tpu_torch.rl.mappo_cavs")
    losses = mappo_cavs.ppo_losses

    def broken(loc, scale, values, actions, old_lp, adv, vt, low, high, cfg, noise, count=None):
        h = loc.shape[0] // 2
        return losses(loc[:h], scale[:h], values[:h], actions[:h], old_lp[:h], adv[:h], vt[:h],
                      low, high, cfg, noise[:h], count)

    monkeypatch.setattr(mappo_cavs, "ppo_losses", broken)


def _altered_reward(monkeypatch):
    from sigmarl_tpu_torch.env.env import RoadTrafficEnv

    step = RoadTrafficEnv.step

    def broken(self, state, actions, **kw):
        s, o, r, d, i = step(self, state, actions, **kw)
        r = r.clone()
        r[0, 0] += 0.5
        return s, o, r, d, i

    monkeypatch.setattr(RoadTrafficEnv, "step", broken)


def _altered_reset(monkeypatch):
    """The start (`env.reset`) hands on an altered observation."""
    from sigmarl_tpu_torch.env.env import RoadTrafficEnv

    reset = RoadTrafficEnv.reset

    def broken(self, *args, **kw):
        state, obs = reset(self, *args, **kw)
        return state, obs + 0.01

    monkeypatch.setattr(RoadTrafficEnv, "reset", broken)


# (cell, fault, the number that has to fail)
FAULTS = [
    ("cpm_entire_n15.rollout", _unchanged_state, "env_gap"),
    ("cpm_entire_n15.rollout", _half_batch_rollout, "env_gap"),
    ("cpm_entire_n15.rollout", _altered_action, "action_gap"),
    ("cpm_entire_n15.rollout", _nominal_as_safe, "safe_action_gap"),
    ("cpm_entire_n15.latency_b1", _unchanged_state, "env_gap"),
    ("cpm_entire_n15.latency_b1", _altered_action, "action_gap"),
    ("cpm_entire_n15.latency_b1", _altered_reset, "env_gap"),
    ("cpm_entire_n15.latency_b1", _nominal_as_safe, "safe_action_gap"),
    ("cpm_mixed_n4.train", _altered_reset, "env_gap"),
    ("cpm_mixed_n4.train", _unchanged_update, "update_gap"),
    ("cpm_mixed_n4.train", _half_batch_loss, "loss_gap"),
    ("cpm_mixed_n4.train", _altered_reward, "env_gap"),
    # the set-up's iteration loads its frames and reads its rows rightly:
    # these fail in the window's recorded iteration
    ("cpm_mixed_n4.train", _stale_frames, "loss_gap"),
    ("cpm_mixed_n4.train", _first_schedule_rows, "update_gap"),
]


@pytest.mark.parametrize("cell, fault, number", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(capsys, monkeypatch, cell, fault, number):
    fault(monkeypatch)
    rc, line, err = run_cell(capsys, cell)
    assert rc == 0, err
    assert line["correct"] is False
    c = line["checks"][number]
    assert c["value"] > c["limit"], (number, line["checks"])


@pytest.mark.parametrize("cell", ["cpm_entire_n15.rollout", "cpm_mixed_n4.train",
                                  "cpm_entire_n15.latency_b1"])
def test_the_control_is_not_correct(capsys, cell):
    rc, line, err = run_cell(capsys, cell, control=True)
    assert rc == 0, err
    assert line["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["cpm_entire_n15.rollout", "cpm_mixed_n4.train",
                                  "cpm_entire_n15.latency_b1"])
def test_the_control_fails_at_the_cell_size_on_the_card(card, cell):
    from benchmark.readings import readings

    lines = readings(cell, [101, 202, 303], 10.0, ["lower"])
    assert all(ln["correct"] for ln in lines if ln["variant"] == "program")
    assert not any(ln["correct"] for ln in lines if ln["variant"] == "lower")

