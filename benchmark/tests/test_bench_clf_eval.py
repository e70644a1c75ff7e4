"""The eval cell (`cpm_entire_n15_clf_eval.eval_recorded`) and the
sub-batched rollout cell (`cpm_entire_n15.rollout_b4096`) on the CPU at a
tiny size: they run, print the contract line and are correct; the traced
run reads the program's spans; the harness refuses a configuration that
is not `main_eval`'s; and `correct` comes out false for each fault the
checks have to see, on the number named for it, and for the control of
each cell."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from benchmark.tests.conftest import SEED

EVAL = "cpm_entire_n15_clf_eval.eval_recorded"
B4096 = "cpm_entire_n15.rollout_b4096"
# N=4, B=8, episodes of 6 steps in rollouts of 8 (two chunks of 4): the
# episode's end at step 4, agents reset alone in the warm-up's chunk.
TINY = {
    EVAL: {"config": {"parameters": {"n_agents": 4, "max_steps": 6}},
           "traffic": {"batch": 8, "episode_steps": 8, "record_chunk": 4, "sampled_steps": 2,
                       "sample_below": 4, "search_chunks": 6}},
    B4096: {"config": {"parameters": {"n_agents": 4}},
            "traffic": {"batch": 4, "warmup_steps": 2, "sampled_steps": 2, "sample_below": 2,
                        "traced_steps": 2}},
}
EVAL_CHECKS = {"env_gap", "qp_objective_gap", "safe_action_gap", "nominal_action_gap",
               "lane_margin_gap", "record_gap", "single_reset_missing", "episode_end_missing"}


def run_tiny(capsys, cell: str, trace: int = 0, control=None, overrides=None):
    """(exit code, parsed result line, standard error) of one CPU run."""
    from benchmark import run

    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.5",
                   "--trace", str(trace)], device="cpu", overrides=overrides or TINY[cell],
                  control=control)
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err


@pytest.mark.parametrize("trace", [0, 1])
def test_the_eval_cell_runs_correct_and_prints_the_contract_line(capsys, trace):
    from sigmarl_tpu_torch import trace as program_trace

    program_trace.reset()
    rc, line, err = run_tiny(capsys, EVAL, trace=trace)
    assert rc == 0, err
    assert line["correct"] is True, err
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == EVAL_CHECKS
    if trace:
        # the CPU counts no sync, and has no device time or K1 launch
        assert set(line["metrics"]) == {"traced_ms.eval.record.eval_recorded",
                                        "host_syncs.eval_recorded"}
        assert line["metrics"]["traced_ms.eval.record.eval_recorded"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"env_steps_per_s", "setup_s"}


@pytest.mark.parametrize("trace", [0, 1])
def test_the_b4096_cell_runs_correct(capsys, trace):
    rc, line, err = run_tiny(capsys, B4096, trace=trace)
    assert rc == 0, err
    assert line["correct"] is True, err
    assert line["attempted"] > 0 and line["attempted"] % (4 * 4) == 0
    assert set(line["metrics"]) == ({"host_syncs.rollout_b4096"} if trace
                                    else {"env_steps_per_s", "setup_s"})


@pytest.mark.parametrize("cell", [EVAL, B4096])
def test_the_control_fails_every_gap(capsys, cell):
    rc, line, err = run_tiny(capsys, cell, control=True)
    assert rc == 0, err
    assert line["correct"] is False
    gaps = {k: v for k, v in line["checks"].items() if k.endswith("_gap")}
    assert all(not float(v["value"]) <= v["limit"] for v in gaps.values()), gaps


def test_the_harness_refuses_another_evaluation(capsys):
    tiny = TINY[EVAL]
    for wrong in ({"filter": {"newton_iters": 5}}, {"parameters": {"is_testing_mode": False}},
                  {"parameters": {"nom_controller_type": "rl"}}):
        overrides = {"config": {k: {**tiny["config"].get(k, {}), **v} for k, v in wrong.items()},
                     "traffic": tiny["traffic"]}
        overrides["config"].setdefault("parameters", tiny["config"]["parameters"])
        with pytest.raises(ValueError):
            run_tiny(capsys, EVAL, overrides=overrides)


def _rl_nominal(monkeypatch):
    """The filter assembles with the RL nominal (the constant action, no
    CLF rows) in place of the CLF controller."""
    from sigmarl_tpu_torch.safety.cbf_qp import CBFSafetyFilter

    assemble = CBFSafetyFilter.assemble

    def broken(self, *args, **kw):
        cfg = self.cfg
        self.cfg = dataclasses.replace(cfg, nom_controller_type="rl")
        try:
            return assemble(self, *args, **kw)
        finally:
            self.cfg = cfg

    monkeypatch.setattr(CBFSafetyFilter, "assemble", broken)


def _no_clf_rows(monkeypatch):
    """The CLF nominal action, but its two rows per agent left out of the
    QP. The nominal action meets its own CLF rows (u = e against e u >=
    e^2), so they bind only where other rows push u* off it, and u* moves
    little (the QP's objective by about 1e-6 here); the record's
    infeasibility flags and largest penetration, which count the CLF rows,
    show the fault."""
    from sigmarl_tpu_torch.safety.cbf_qp import CBFSafetyFilter

    assemble = CBFSafetyFilter.assemble

    def broken(self, *args, **kw):
        cons, *rest = assemble(self, *args, **kw)
        valid = cons.valid_s.clone()
        valid[..., -2:] = False
        return (dataclasses.replace(cons, valid_s=valid), *rest)

    monkeypatch.setattr(CBFSafetyFilter, "assemble", broken)


def _training_mode_resets(monkeypatch):
    """A collision ends and resets the whole env, as in training."""
    from sigmarl_tpu_torch.env.env import RoadTrafficEnv

    done_and_mask = RoadTrafficEnv._done_and_reset_mask

    def broken(self, state):
        cfg = self.cfg
        self.cfg = dataclasses.replace(cfg, is_testing_mode=False)
        try:
            return done_and_mask(self, state)
        finally:
            self.cfg = cfg

    monkeypatch.setattr(RoadTrafficEnv, "_done_and_reset_mask", broken)


def _shifted_record(monkeypatch):
    """The host's record one step late."""
    import importlib

    module = importlib.import_module("sigmarl_tpu_torch.eval.rollout")
    rollout = module.rollout

    def broken(*args, **kw):
        out, timings = rollout(*args, **kw)
        return {k: np.roll(v, 1, axis=0) for k, v in out.items()}, timings

    monkeypatch.setattr(module, "rollout", broken)


def _wrong_sub_batch(monkeypatch):
    """Every step of the last sub-batch starts from the state of the
    sub-batch stepped before it."""
    from sigmarl_tpu_torch.env.env import RoadTrafficEnv

    step = RoadTrafficEnv.step
    seen = []

    def broken(self, state, actions, **kw):
        seen.append(state)
        if len(seen) % 4 == 0:
            state = dataclasses.replace(seen[-2], nominal_action=state.nominal_action,
                                        applied_action=state.applied_action,
                                        cbf_u_prev=state.cbf_u_prev)
        return step(self, state, actions, **kw)

    monkeypatch.setattr(RoadTrafficEnv, "step", broken)


@pytest.mark.parametrize("cell, fault, number", [
    (EVAL, _rl_nominal, "nominal_action_gap"),
    (EVAL, _no_clf_rows, "record_gap"),
    (EVAL, _training_mode_resets, "env_gap"),
    (EVAL, _shifted_record, "record_gap"),
    (B4096, _wrong_sub_batch, "env_gap"),
])
def test_a_fault_fails_its_number(capsys, monkeypatch, cell, fault, number):
    fault(monkeypatch)
    rc, line, err = run_tiny(capsys, cell)
    assert rc == 0, err
    assert line["correct"] is False, err
    check = line["checks"][number]
    assert not float(check["value"]) <= check["limit"], (number, check)
