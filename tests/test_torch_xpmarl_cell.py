"""XP-MARL training and the grouped filtered rollout as the benchmark runs
them (`cpm_entire_n15_xpmarl.train_xpmarl`, `benchmark/configs/
cpm_entire_n15_xpmarl.json`; `cpm_entire_n15.rollout_grouped`) on the CPU:
each cell at a tiny size is correct against the benchmark's plain
reference; the rollout's rank and turns are the spans `.priority` and
`.turns` under `train.rollout.act`, and `turns` counts one per agent and
step; the reference's priority rank and turns (`benchmark/reference/rl/
priority.py`) agree with the port's `rl/priority.py` on seeded weights."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.reference.core.geometry import nearest_indices as ref_nearest
from benchmark.reference.rl import networks as ref_networks
from benchmark.reference.rl import priority as ref_priority
from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs
from sigmarl_tpu_torch.rl.networks import PolicyNet, score_policy
from sigmarl_tpu_torch.rl.priority import (nearing_agent_indices, prioritized_action_propagation,
                                           priority_rank)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XPMARL = "cpm_entire_n15_xpmarl.train_xpmarl"
GROUPED = "cpm_entire_n15.rollout_grouped"
TINY = {
    XPMARL: {"config": {"parameters": {"n_agents": 4, "max_steps": 4, "minibatch_size": 16}},
             "traffic": {"batch": 4, "checked_updates": 1, "sampled_iteration_below": 2}},
    # 8 agents in groups of at most 4: two groups, so pairs across groups
    # are split.
    GROUPED: {"config": {"parameters": {"n_agents": 8}},
              "traffic": {"batch": 4, "warmup_steps": 2, "sampled_steps": 2, "sample_below": 2,
                          "traced_steps": 2}},
}
CHECKS = {
    XPMARL: {"score_gap", "rank_mismatch", "obs_tail_gap", "action_gap", "env_gap", "gae_gap",
             "loss_gap", "grad_gap", "update_gap"},
    GROUPED: {"action_gap", "qp_objective_gap", "safe_action_gap", "nominal_action_gap",
              "lane_margin_gap", "env_gap"},
}

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


@pytest.mark.parametrize("cell", [XPMARL, GROUPED])
def test_the_cell_at_a_tiny_size_is_correct(cell):
    out = subprocess.run(
        [sys.executable, "-c", _RUN.format(root=ROOT, cell=cell, tiny=TINY[cell])],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == CHECKS[cell]


def config_file():
    with open(os.path.join(ROOT, "benchmark", "configs", "cpm_entire_n15_xpmarl.json")) as f:
        return json.load(f)


@pytest.fixture
def traced():
    trace.reset()
    trace.enable()
    yield
    trace.disable()
    trace.reset()


def test_the_rank_and_the_turns_open_under_acting(tmp_path, traced):
    N, T = 4, 3
    p = Parameters(**{**config_file()["parameters"], "n_agents": N, "num_vmas_envs": 2,
                      "max_steps": T, "minibatch_size": 6},
                   device="cpu", where_to_save=str(tmp_path) + "/",
                   is_save_intermediate_model=False)
    tr = MAPPOCAVs(p)
    tr.train_iteration(tr.initial_state())
    snap = trace.snapshot()
    spans = snap["spans"]
    for name in ("train.rollout.act.priority", "train.rollout.act.turns"):
        assert spans[name]["calls"] == T, name
    assert spans["train.rollout.act"]["total_ns"] >= (
        spans["train.rollout.act.priority"]["total_ns"]
        + spans["train.rollout.act.turns"]["total_ns"])
    assert snap["counts"]["turns"] == N * T
    assert spans["train.rollout.act.turns"]["counts"]["turns"] == N * T


def _seeded(net, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in net.mlp.layers:
            layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen)
                               / layer.in_features ** 0.5)
            layer.bias.copy_(0.1 * torch.randn(layer.bias.shape, generator=gen))
    return net


def test_the_references_rank_and_turns_are_the_ports():
    B, N, D, K = 64, 6, 20, 2
    gen = torch.Generator().manual_seed(7)
    obs = torch.randn((B, N, D), generator=gen)
    d = torch.rand((B, N, N), generator=gen)
    d[:, :, :2] = d[:, :, 2:4]  # tied distances: the lower index comes first
    d = d + 10 * torch.eye(N)  # an agent is not its own neighbour
    score_noise = torch.randn((B, N, 1), generator=gen)
    action_noise = torch.randn((N, B, 2), generator=gen)
    lim = torch.tensor([1.0, 0.4])

    scorer = _seeded(score_policy(D, device="cpu"), 1)
    policy = _seeded(PolicyNet(D + 2 * K, 2, device="cpu"), 2)
    ref_scorer = ref_networks.PolicyNet(D, 1, ref_networks.SCORE_HIDDEN, device="cpu")
    ref_policy = ref_networks.PolicyNet(D + 2 * K, 2, device="cpu")
    ref_scorer.load_state_dict(scorer.state_dict())
    ref_policy.load_state_dict(policy.state_dict())

    prio = priority_rank("marl", scorer, obs, noise=score_noise)
    with torch.no_grad():
        scores, log_prob = ref_priority.score_sample(*ref_scorer(obs), score_noise)
    rank = ref_priority.rank_agents(scores)
    torch.testing.assert_close(prio.scores, scores, rtol=0, atol=0)
    torch.testing.assert_close(prio.log_prob, log_prob, rtol=0, atol=0)
    assert torch.equal(prio.rank.long(), rank)

    nbrs = nearing_agent_indices(d, K)
    assert torch.equal(nbrs, ref_nearest(d, K))
    ap = prioritized_action_propagation(policy, ref_priority.pad(obs, K), prio.rank, nbrs, -lim,
                                        lim, action_noise=action_noise)
    with torch.no_grad():
        actions, lp, used = ref_priority.propagate(ref_policy, ref_priority.pad(obs, K), rank,
                                                   nbrs, -lim, lim, action_noise)
    torch.testing.assert_close(ap.actions, actions, rtol=0, atol=0)
    torch.testing.assert_close(ap.log_prob, lp, rtol=0, atol=0)
    torch.testing.assert_close(ap.obs_used, used, rtol=0, atol=0)
    # Judged from the port's own decisions, the reference's turns give the same.
    with torch.no_grad():
        judged = ref_priority.propagate(ref_policy, ref_priority.pad(obs, K), rank, nbrs, -lim,
                                        lim, action_noise, decided=ap.actions)
    for a, b in zip(judged, (ap.actions, ap.log_prob, ap.obs_used)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # The last agent to act sees every decided neighbour's action in its tail.
    last = rank[:, -1]
    tail = used[torch.arange(B), last, -2 * K:].reshape(B, K, 2)
    near = nbrs[torch.arange(B), last]
    assert torch.equal(tail, actions[torch.arange(B)[:, None], near])
