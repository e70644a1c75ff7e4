"""CBF-filtered MAPPO training as the benchmark runs it
(`cpm_entire_n15_cbf_train.train_filtered`, `benchmark/configs/
cpm_entire_n15_cbf_train.json`) on the CPU: the cell at a tiny size is
correct against the benchmark's plain reference, the trainer's filter
solves at the configuration's budget, `utils/card_checks.py::
FILTERED_TRAINING` (which `chip_smoke.py` runs on the card) is the same
configuration, and the rollout's acting and transition spans open
under `train.rollout` with the filter inside the transition."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness.filtered_training import filter_budget
from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs
from sigmarl_tpu_torch.safety.cbf_qp import CBFSafetyFilter
from sigmarl_tpu_torch.utils.card_checks import FILTERED_TRAINING

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "cpm_entire_n15_cbf_train.train_filtered"
TINY = {"config": {"parameters": {"n_agents": 4, "max_steps": 4, "minibatch_size": 16}},
        "traffic": {"batch": 4, "checked_updates": 1, "sampled_iteration_below": 2}}

# The cell in a fresh interpreter: a run refuses a process that holds JAX,
# which this suite's conftest loads.
_RUN = """
import sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from benchmark import run
sys.exit(run.main(["--workload", {cell!r}, "--seed", "3000000123", "--seconds", "0.5",
                   "--trace", "0"], device="cpu", overrides={tiny!r}))
"""


def config_file():
    with open(os.path.join(ROOT, "benchmark", "configs", "cpm_entire_n15_cbf_train.json")) as f:
        return json.load(f)


def traffic_file():
    with open(os.path.join(ROOT, "benchmark", "traffic", "train_filtered.json")) as f:
        return json.load(f)


def trainer(tmp_path, **kw) -> MAPPOCAVs:
    p = Parameters(**{**config_file()["parameters"], **kw}, device="cpu",
                   where_to_save=str(tmp_path) + "/", is_save_intermediate_model=False)
    return MAPPOCAVs(p)


def test_the_cell_at_a_tiny_size_is_correct():
    out = subprocess.run([sys.executable, "-c", _RUN.format(root=ROOT, cell=CELL, tiny=TINY)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr
    assert line["failed"] == 0 and line["attempted"] == 2 * 4 * 4
    assert {"qp_objective_gap", "safe_action_gap", "env_gap", "update_gap"} <= set(line["checks"])


def test_the_trainers_filter_solves_at_the_configurations_budget(tmp_path):
    tr = trainer(tmp_path, num_vmas_envs=2)
    assert tr.cbf_filter is not None and not tr.cbf_filter.decentralized
    assert filter_budget(tr.cbf_filter) == config_file()["filter"]


def test_chip_smokes_filtered_training_is_the_configuration():
    params = config_file()["parameters"]
    smoke = FILTERED_TRAINING
    shared = set(smoke) & set(params)
    assert shared >= {"scenario_type", "n_agents", "max_steps", "num_epochs", "minibatch_size",
                      "rew_method", "is_using_cbf_training", "is_solve_qp",
                      "is_apply_cbf_action", "is_using_centralized_cbf"}
    assert {k: smoke[k] for k in shared} == {k: params[k] for k in shared}
    assert smoke["num_vmas_envs"] == traffic_file()["batch"]


@pytest.fixture
def traced():
    trace.reset()
    trace.enable()
    yield
    trace.disable()
    trace.reset()


def test_acting_and_the_transition_open_under_the_rollout(tmp_path, monkeypatch, traced):
    T = 3
    tr = trainer(tmp_path, n_agents=4, num_vmas_envs=2, max_steps=T, minibatch_size=6)
    stacks = []
    assemble = CBFSafetyFilter.assemble

    def watched(self, *args, **kw):  # runs inside the span `filter.assemble`
        stacks.append([s.name for s in trace._state.stack])
        return assemble(self, *args, **kw)

    monkeypatch.setattr(CBFSafetyFilter, "assemble", watched)
    tr.train_iteration(tr.initial_state())
    spans = trace.snapshot()["spans"]
    for name in ("train.rollout.act", "train.rollout.transition", "filter"):
        assert spans[name]["calls"] == T, name
    assert stacks == [["train.rollout", "train.rollout.transition", "rollout_step", "filter",
                       "filter.assemble"]] * T
    # The policy acts inside `.act`; the transition covers the filter.
    assert spans["policy"]["calls"] >= T
    assert spans["train.rollout.transition"]["total_ns"] >= spans["filter"]["total_ns"]
