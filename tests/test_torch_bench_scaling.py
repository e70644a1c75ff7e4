"""Weak scaling over ranks (`sigmarl_tpu_torch/bench_scaling.py`) on the
CPU: ranks spawned as processes in one gloo group, the kernels' plain
versions.

- The launcher at a tiny size (1 and 2 ranks, 2 envs each, N=4, T=2, one
  timed chunk) prints a row per rank count with its keys and a summary.
- 2 ranks fed the slices of one global draw (policy noise and reset
  draws) compute what one process computes at B=4 fed the whole draw: the
  per-step global reward means and the gathered final state. The filter,
  the env step and its resets give the same bits on any split of the envs
  (`test_torch_parallel.py` holds a sharded step to 0); the policy does
  not: its float32 matrix products round differently for 8 and 16 rows on
  the CPU (up to 4e-7 in its outputs), so the rollout's floats are held
  within 1e-4 (u* 1e-3) and its means to a relative 1e-5, its integer
  fields, flags and reset counts exactly, and the first step, whose
  all-zero observations every row shares, bit for bit.
- `--device cuda` without a card raises; nccl on the CPU raises.
"""

import concurrent.futures
import json

import pytest
import torch

from sigmarl_tpu_torch import bench_scaling as bs
from sigmarl_tpu_torch.env.reset import ResetDraws
from sigmarl_tpu_torch.parallel.dryrun import spawn_ranks

torch.set_num_threads(1)
TINY = ["--device", "cpu", "--per_device_batch", "2", "--n_agents", "4", "--steps", "2",
        "--chunks", "1"]
ROW_KEYS = {"global_devices", "batch", "steps_per_s", "warmup_s", "per_rank_batch", "backend",
            "cards", "chunk_steps_per_s", "launches", "collectives_per_step", "reset_steps",
            "compact_reset_steps", "full_reset_steps", "mechanics", "device", "reward"}
CFG = dict(per_rank_batch=2, n_agents=4, scenario_type="cpm_entire", steps=2, chunks=1,
           newton_iters=10)
WORLD = 2


def _global_draws(seed: int = 0):
    """Policy noise [S, B, N, 2] and one `ResetDraws` per step of the
    global batch (B = 4), S = (chunks + 1) x steps."""
    B, N, S = CFG["per_rank_batch"] * WORLD, CFG["n_agents"], (CFG["chunks"] + 1) * CFG["steps"]
    env = bs.workload(dict(CFG, per_rank_batch=B), torch.device("cpu"))[0]
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn((S, B, N, 2), generator=g)
    return noise, [ResetDraws.sample(env.cfg, g, "cpu") for _ in range(S)]


@pytest.fixture(scope="module")
def ranks_run():
    """The 2-rank run on one global draw, started in the background (its
    processes overlap the launcher's), and one process on the same draw."""
    draws = _global_draws()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(spawn_ranks, bs.scaling_rank, WORLD, CFG, draws, backend="gloo",
                        device="cpu")
    one = bs.scaling_rank(None, "cpu", dict(CFG, per_rank_batch=CFG["per_rank_batch"] * WORLD),
                          draws)
    yield ranks, one
    pool.shutdown()


def test_launcher_prints_a_row_per_rank_count_and_a_summary(ranks_run, capsys):
    assert bs.main(TINY + ["--ranks", "1,2"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 3
    for world, r in zip((1, 2), lines):
        assert ROW_KEYS <= set(r), ROW_KEYS - set(r)
        assert r["global_devices"] == world and r["batch"] == 2 * world
        assert r["per_rank_batch"] == 2 and r["backend"] == "gloo" and r["cards"] == 0
        assert r["mechanics"] and r["device"] == "cpu" and r["steps_per_s"] > 0
        assert set(r["chunk_steps_per_s"]) == {"min", "median", "max"}
        # No kernel launches on the CPU (the plain versions run), one per rank.
        assert r["launches"] == [{"qp_newton": 0, "boundary_stencil": 0}] * world
        # The ranks' reset count (all-gather) and the reward's all-reduce.
        assert r["collectives_per_step"] == 2
        # The first step resets every env; below 1024 envs nothing compacts.
        assert r["reset_steps"] >= 1 and r["compact_reset_steps"] == 0
        assert r["reset_steps"] == r["full_reset_steps"]
        assert r["soft_iters"] == 2 and r["newton_iters"] == 10
    s = lines[2]
    assert s["metric"] == "scaling_efficiency" and s["sizes"] == [1, 2]
    assert s["per_device_batch"] == 2 and s["efficiency_vs_1dev"][0] == 1.0
    assert s["steps_per_s"] == [lines[0]["steps_per_s"], lines[1]["steps_per_s"]]
    assert s["mechanics"] and "mechanics" in s["note"]


def test_ranks_on_one_global_draw_equal_one_process(ranks_run):
    ranks, one = ranks_run
    ranks = ranks.result()
    S = (CFG["chunks"] + 1) * CFG["steps"]
    assert len(one["step_rewards"]) == S
    for r in ranks:
        assert r["step_rewards"][0] == one["step_rewards"][0]
        assert r["step_rewards"] == pytest.approx(one["step_rewards"], rel=1e-5, abs=0)
        assert r["reset_steps"] == one["reset_steps"] >= 1
        assert r["reward"] == pytest.approx(one["reward"], rel=1e-5, abs=0)
        assert r["collectives_per_step"] == 2
    for name, value in one["state"].items():
        for r in ranks:
            if value.is_floating_point():
                atol = 1e-3 if name == "cbf_u_prev" else 1e-4
                torch.testing.assert_close(r["state"][name], value, rtol=0, atol=atol, msg=name)
            else:
                assert torch.equal(r["state"][name], value), name


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bs.main(["--device", "cuda"])


def test_nccl_on_the_cpu_raises():
    with pytest.raises(ValueError, match="nccl"):
        bs.main(TINY + ["--backend", "nccl"])
    with pytest.raises(ValueError, match="nccl"):
        bs.placement(2, torch.device("cpu"), "nccl")
    assert bs.placement(2, torch.device("cpu"), None) == ("gloo", "cpu")
