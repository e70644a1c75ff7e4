"""XP-MARL's acting as CUDA graphs (`rl/act_graphs.py`): on the card the
learned priority rank and the N priority turns, replayed, against their
eager bodies (`rl/priority.py::_score_rank`, `_turns`) run on the card, bit
for bit; on the CPU, the contract the trainer's callers rely on. The
card's tests carry the marker `gpu` and skip without a card. The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_act_graph.py
"""

import importlib

import pytest
import torch

from sigmarl_tpu_torch import trace
from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.constants import AGENTS
from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs
from sigmarl_tpu_torch.rl.networks import PolicyNet, score_policy
from sigmarl_tpu_torch.rl.priority import (_score_rank, _turns, prioritized_action_propagation,
                                           priority_rank)

D, K = 30, 2  # the observation's width and the neighbours whose actions it carries
COUNTERS = ("turns.graph.captures", "turns.graph.replays", "rank.graph.captures",
            "rank.graph.replays")
# (N, B, communication noise level): the cell's width, and a small batch
# with the noise on.
SIZES = {"n15_b1024": (15, 1024, 0.0), "n4_b8_noise": (4, 8, 0.1)}


def _counts() -> dict:
    counts = trace.snapshot()["counts"]
    return {k: counts.get(k, 0) for k in (*COUNTERS, "turns")}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


def _counted(fn, total: dict):
    """fn's result; the counts it made are added to `total`."""
    before = _counts()
    out = fn()
    for k, v in _since(before).items():
        total[k] = total.get(k, 0) + v
    return out


class _Acting:
    """A policy, a score network and a generator of each call's inputs on
    the card; `graphed` runs the rank and the turns through the public
    functions (replayed), `eager` through their bodies."""

    def __init__(self, N: int, B: int, level: float, tensor_draws: bool, seed: int = 0):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        self.N, self.B, self.level, self.tensor_draws = N, B, level, tensor_draws
        self.policy = PolicyNet(D + 2 * K, device="cuda", seed=3 + seed)
        self.scorer = score_policy(D, device="cuda", seed=5 + seed)
        self.lim = torch.tensor([1.0, 0.54], device="cuda")
        self.g = torch.Generator(device="cuda").manual_seed(11 + seed)

    def inputs(self, B: int | None = None) -> dict:
        N, B, g = self.N, B or self.B, self.g
        obs = torch.randn((B, N, D), generator=g, device="cuda")
        x = dict(obs=obs, base_obs=torch.nn.functional.pad(obs, (0, 2 * K)),
                 nearing=torch.randint(0, N, (B, N, K), generator=g, device="cuda"))
        if self.tensor_draws:
            x.update(score_noise=torch.randn((B, N, 1), generator=g, device="cuda"),
                     action_noise=torch.randn((N, B, 2), generator=g, device="cuda"),
                     comm_noise=torch.randn((N, B, 2 * K), generator=g, device="cuda"))
        return x

    def _draws(self, x):
        return x.get("score_noise"), x.get("action_noise"), x.get("comm_noise")

    def graphed(self, x, gen=None):
        score_noise, action_noise, comm_noise = self._draws(x)
        prio = priority_rank("marl", self.scorer, x["obs"], gen, noise=score_noise)
        ap = prioritized_action_propagation(
            self.policy, x["base_obs"], prio.rank, x["nearing"], -self.lim, self.lim, gen,
            action_noise=action_noise, communication_noise_level=self.level,
            communication_noise=comm_noise)
        return prio, ap

    def eager(self, x, gen=None):
        score_noise, action_noise, comm_noise = self._draws(x)
        prio = _score_rank(self.scorer, x["obs"], gen, score_noise)
        std = None
        if self.level > 0:
            std = torch.tensor([AGENTS["max_speed"], AGENTS["max_steering"]] * K,
                               device="cuda") * self.level
        ap = _turns(self.policy, x["base_obs"], prio.rank, x["nearing"], -self.lim, self.lim,
                    std, gen, action_noise, comm_noise if self.level > 0 else None)
        return prio, ap


def _generators(seed: int):
    """Two card generators from one seed: the replayed and the eager side
    draw the same numbers."""
    return tuple(torch.Generator(device="cuda").manual_seed(seed) for _ in range(2))


def _assert_equal(got, want):
    for name, a, b in zip((*got[0]._fields, *got[1]._fields), (*got[0], *got[1]),
                          (*want[0], *want[1])):
        assert torch.equal(a, b), (name, float((a.double() - b.double()).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("draws", ["tensors", "generator"])
@pytest.mark.parametrize("size", list(SIZES))
def test_replays_equal_the_eager_bodies(size, draws):
    """Three calls with different inputs: the replayed rank and turns
    equal the eager bodies bit for bit, with the draws given as tensors or
    drawn from a generator; each call's outputs still equal their eager
    values after the later replays (copies, not the graphs' buffers). The
    counters: one capture of each graph, then one replay a call, `turns`
    N a call."""
    N, B, level = SIZES[size]
    acting = _Acting(N, B, level, draws == "tensors")
    g_graph, g_eager = _generators(7)
    counts = {}
    kept = []
    for _ in range(3):
        x = acting.inputs()
        got = _counted(lambda: acting.graphed(x, g_graph), counts)
        want = acting.eager(x, g_eager)
        _assert_equal(got, want)
        kept.append((got, want))
    torch.cuda.synchronize()
    for got, want in kept:
        _assert_equal(got, want)
    assert counts == {"turns.graph.captures": 1, "turns.graph.replays": 2,
                      "rank.graph.captures": 1, "rank.graph.replays": 2, "turns": 3 * N}


@pytest.mark.gpu
def test_a_replay_reads_weights_changed_in_place():
    """After an in-place change of both networks' weights (as the update's
    Adam step makes), the next replay equals the eager bodies on the new
    weights, without a capture."""
    acting = _Acting(4, 8, 0.1, tensor_draws=True)
    x = acting.inputs()
    acting.graphed(x)
    with torch.no_grad():
        for p in (*acting.policy.parameters(), *acting.scorer.parameters()):
            p.add_(0.05 * torch.randn(p.shape, generator=acting.g, device="cuda"))
    x = acting.inputs()
    counts = {}
    _assert_equal(_counted(lambda: acting.graphed(x), counts), acting.eager(x))
    assert counts == {"turns.graph.captures": 0, "turns.graph.replays": 1,
                      "rank.graph.captures": 0, "rank.graph.replays": 1, "turns": 4}


@pytest.mark.gpu
def test_a_new_batch_captures_anew():
    """A call with another B captures both graphs anew, and each key then
    replays its own graph."""
    acting = _Acting(4, 8, 0.0, tensor_draws=True, seed=1)
    acting.graphed(acting.inputs())
    counts = {}
    for B in (16, 8, 16):
        x = acting.inputs(B)
        _assert_equal(_counted(lambda: acting.graphed(x), counts), acting.eager(x))
    assert counts == {"turns.graph.captures": 1, "turns.graph.replays": 2,
                      "rank.graph.captures": 1, "rank.graph.replays": 2, "turns": 12}


@pytest.mark.gpu
@pytest.mark.parametrize("draws", ["tensors", "generator"])
def test_a_replay_waits_for_nothing(draws):
    """A replayed call, the generator's draws included, runs under
    `torch.cuda.set_sync_debug_mode("error")` without raising."""
    acting = _Acting(15, 1024, 0.0, draws == "tensors", seed=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    acting.graphed(acting.inputs(), gen)
    x = acting.inputs()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        acting.graphed(x, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_the_trainer_calls_rank_and_turns_once_a_step_on_the_cpu(monkeypatch, tmp_path):
    """One tiny learned-priority rollout on the CPU (N=4, B=4, T=4,
    communication noise on): `MAPPOCAVs.act` calls the trainer module's
    `priority_rank` and `prioritized_action_propagation` once a step each,
    the latter with that step's rank as its third argument (the
    benchmark's harness records it there); the CPU runs the eager bodies
    (no graph counter moves) and `turns` counts N x T."""
    N, T = 4, 4
    p = Parameters(scenario_type="cpm_mixed", n_agents=N, num_vmas_envs=4, dt=0.1, max_steps=T,
                   n_iters=1, num_epochs=1, minibatch_size=16, is_using_prioritized_marl=True,
                   prioritization_method="marl", is_communication_noise=True, device="cpu",
                   where_to_save=str(tmp_path) + "/")
    tr = MAPPOCAVs(p)
    module = importlib.import_module("sigmarl_tpu_torch.rl.mappo_cavs")
    rank_fn, turns_fn = module.priority_rank, module.prioritized_action_propagation
    calls = []

    def rank(*args, **kw):
        out = rank_fn(*args, **kw)
        calls.append(("rank", out.rank))
        return out

    def turns(*args, **kw):
        calls.append(("turns", args[2]))
        return turns_fn(*args, **kw)

    monkeypatch.setattr(module, "priority_rank", rank)
    monkeypatch.setattr(module, "prioritized_action_propagation", turns)
    before = _counts()
    _, _, _, batch, _ = tr.rollout(tr.initial_state())
    assert [c[0] for c in calls] == ["rank", "turns"] * T
    for (_, ranked), (_, used) in zip(calls[::2], calls[1::2]):
        assert used is ranked
        assert torch.equal(used.sort(dim=-1).values, torch.arange(N).expand(4, N).to(used.dtype))
    assert _since(before) == {**dict.fromkeys(COUNTERS, 0), "turns": N * T}
    assert batch.action.shape == (T, 4, N, 2) and bool(torch.isfinite(batch.action).all())
