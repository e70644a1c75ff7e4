"""The port's measuring programs on the CPU at a small size:
`sigmarl_tpu_torch.bench` (both framings, `--grouped`, `--census`) and
`sigmarl_tpu_torch.bench_latency`: their result lines, the sub-batch
framing against separate runs, and a chunk against the step loop that
`tests/test_torch_slice.py` holds against JAX."""

import dataclasses
import json

import pytest
import torch

from sigmarl_tpu_torch import bench, bench_latency, check_warm_start
from sigmarl_tpu_torch.env.structs import WorldState, zero_state
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step
from sigmarl_tpu_torch.utils import certificate_tail

torch.set_num_threads(1)
B, N, T = 4, 4, 3
SMALL = ["--device", "cpu", "--n_agents", str(N), "--steps", "2", "--chunks", "1"]


def last_lines(capsys, n=1):
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()[-n:]]


def assert_same_state(a: WorldState, b: WorldState):
    for f in dataclasses.fields(WorldState):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_bench_line_has_the_jax_keys(capsys):
    """Both framings at B=8 and 4 x 8 (N=4, T=2, one timed chunk): one
    JSON line of the JAX bench's shape, with the chunks' spread and the
    device."""
    assert bench.main(SMALL + ["--chunk", "8"]) == 0
    (line,) = last_lines(capsys)
    assert line["metric"] == "cbf_filtered_env_steps_per_s_15agents_cpm"
    assert line["unit"] == "env-steps/s/card" and line["value"] > 0
    d = line["detail"]
    assert {"batch", "chunks", "b4096_chunked", "b4096_sub_batches", "n_agents", "n_circles",
            "qp_per_s", "agent_steps_per_s", "warmup_s", "chunk_rates", "device"} <= set(d)
    assert (d["batch"], d["chunks"], d["b4096_sub_batches"], d["b4096_batch"]) == (8, 1, 4, 32)
    assert d["n_agents"] == N and d["device"] == "cpu" and d["b4096_chunked"] > 0
    assert set(d["chunk_rates"]) == {"min", "median", "max"}
    assert "vs_baseline" not in line


def test_sub_batches_equal_separate_runs():
    """4 sub-batches of 4 envs stepped in turn on one env and filter equal
    four separate B=4 runs from the same starts and generators, bit for
    bit: states, observations and done flags of every step."""
    env, cbf, policy, gen, state, obs = bench.main_path(B, N, "cpu")
    states, obs_l, gens = bench.sub_batches(env, state, obs, gen, 4)
    framed_s, framed_o, _, framed_d = bench.rollout_chunk(env, cbf, policy, states, obs_l, gens, T)
    for s in range(4):
        alone_s, alone_o, _, alone_d = bench.rollout_chunk(
            env, cbf, policy, [zero_state(env.cfg, "cpu")], [torch.zeros_like(obs)],
            [torch.Generator().manual_seed(s)], T)
        assert_same_state(framed_s[s], alone_s[0])
        assert torch.equal(framed_o[s], alone_o[0])
        for t in range(T):
            assert torch.equal(framed_d[t][s], alone_d[t][0])


def test_chunk_is_the_step_loop():
    """A chunk from the all-zero state is T calls of the policy and
    `cbf_filtered_step` (the loop `tests/test_torch_slice.py` holds
    against JAX) with the same generator."""
    env, cbf, policy, gen, state, obs = bench.main_path(B, N, "cpu")
    (s1,), (o1,), r1, _ = bench.rollout_chunk(env, cbf, policy, [state], [obs], [gen], T)
    gen = torch.Generator().manual_seed(0)
    state, obs, total = zero_state(env.cfg, "cpu"), torch.zeros_like(obs), 0.0
    for _ in range(T):
        act = bench.policy_actions(env, policy, obs, gen)
        state, obs, rew, _, _ = cbf_filtered_step(env, cbf, state, act, generator=gen)
        total = total + rew.mean()
    assert_same_state(s1, state)
    assert torch.equal(o1, obs)
    assert torch.allclose(r1, total / T, rtol=1e-6, atol=0)


def test_grouped_and_census_lines(capsys):
    """`--grouped`: one line for the plain and one for the grouped filter;
    `--census`: the resetting envs per step and the reset branches' shares
    (the first step from the all-zero state resets every env, so the
    census counts after the warm-up chunk)."""
    assert bench.main(SMALL + ["--chunk", str(B), "--grouped"]) == 0
    plain, grouped = last_lines(capsys, 2)
    assert (plain["mode"], grouped["mode"]) == ("centralized", "grouped_m4")
    for line in (plain, grouped):
        assert {"metric", "mode", "value", "unit", "warmup_s", "chunk_rates", "device"} <= set(line)
        assert line["value"] > 0 and line["batch"] == B
    assert bench.main(SMALL + ["--chunk", str(B), "--census", "--census_steps", "3"]) == 0
    (c,) = last_lines(capsys)
    assert {"mean", "p50", "p99", "max", "share_zero", "p_above", "branches"} <= set(c)
    assert set(c["p_above"]) == {"8", "16", "32", "64", "128"} and c["steps"] == 3
    assert len(c["counts"]) == 3 and max(c["counts"]) <= B
    assert sum(c["branches"].values()) == pytest.approx(1.0)
    # Below 1024 envs the spawn is never compacted (no slots).
    assert c["slots"] == 0 and c["branches"]["compacted"] == 0.0


def test_latency_keys():
    r = bench_latency.measure(1, N, 3, device="cpu", warmup=2)
    assert {"metric", "batch", "n_agents", "mean", "p50", "p99", "budget_ms",
            "budget_used_pct_p99", "host_syncs_per_step", "device"} <= set(r)
    assert r["metric"] == "cbf_filtered_step_latency_ms" and r["budget_ms"] == 100.0
    assert 0 < r["p50"] <= r["p99"] and r["device"] == "cpu"
    # The sync debug mode counts waits on a card only.
    assert r["host_syncs_per_step"] is None


@pytest.mark.parametrize("main", [bench.main, bench_latency.main, check_warm_start.main,
                                  certificate_tail.main])
def test_programs_default_to_cuda_and_raise_without_a_card(monkeypatch, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([])


def test_census_parity_follows_the_census_and_finds_the_first_parting():
    """`utils/census_parity.py` rolls out the census's instances (its
    counted steps are `census`'s counts on the same device), a record
    against itself never parts, and a record with one env's done flag
    flipped at step 3 parts there, at that env."""
    from sigmarl_tpu_torch.utils import census_parity

    rec = census_parity.rollout_record(4, 1, 3, "cpu")
    assert census_parity.counted(rec) == bench.census(4, steps=3, T=1, device="cpu")["counts"]
    assert census_parity.parting(rec, rec)["first_parting_step"] is None
    other = dict(rec, done=rec["done"].copy())
    other["done"][2, 1] = ~other["done"][2, 1]
    p = census_parity.parting(rec, other)
    assert p["first_parting_step"] == 3 and p["envs"] == [1] and p["max_pos_gap_m"] == 0.0
