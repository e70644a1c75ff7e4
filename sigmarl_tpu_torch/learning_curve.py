"""Learning curve of the port: MAPPO training runs whose episode reward
rises from the initial (random) policy's, with the initial and the trained
policy evaluated on one deterministic rollout each, aggregated over seeds
(mean +/- CI95).

    python -m sigmarl_tpu_torch.learning_curve [--n_iters 250] [--seeds 3]
        [--num_envs 128] [--out LEARNING_CURVE_TORCH.json] [--device cuda]

The protocol, metrics, defaults and JSON keys are those of
`scripts/train_learning_curve.py` (cpm_mixed, N=4, B=128, T=128, 30 epochs
of minibatch 512, observation noise on, entropy_eps 4e-3, 250 iterations
of 3 seeds, the best-reward checkpoint evaluated against the initial
policy on the same draws), plus the card's name and power limit and each
iteration's seconds. `tests/test_torch_learning_curve.py` holds the committed artifact.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.eval.rollout import checkpoint_policy, rollout
from sigmarl_tpu_torch.rl import checkpoint as ckpt
from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs
from sigmarl_tpu_torch.rl.networks import to_jax_params

EVAL_STEPS = 200


def eval_policy(env, policy_params, seed: int, steps: int = EVAL_STEPS) -> dict:
    """Deterministic eval rollout: mean step reward and collision rates,
    the collisions also per 100 m driven (a random policy barely moves, so
    a per-step rate rewards standing still)."""
    gen = torch.Generator(device=env.device).manual_seed(seed)
    record, _ = rollout(env, checkpoint_policy(policy_params, env, deterministic=True), steps,
                        generator=gen)
    dist_m = float(np.linalg.norm(np.diff(record["pos"], axis=0), axis=-1).sum())
    coll_agents = np.asarray(record["is_collision_with_agents"], bool)
    coll_lane = np.asarray(record["is_collision_with_lanelets"], bool)
    coll_steps = float((coll_agents | coll_lane).sum())
    return {
        "reward_mean": float(np.mean(record["reward"])),
        "collision_rate_agents": float(coll_agents.mean()),
        "collision_rate_lanelets": float(coll_lane.mean()),
        "collision_steps_per_100m": round(coll_steps / max(dist_m, 1e-9) * 100, 3),
        "meters_driven": round(dist_m, 1),
    }


# The protocol's training configuration (30 epochs of minibatch 512 are
# the `Parameters` defaults).
TRAINING = dict(scenario_type="cpm_mixed", n_agents=4, num_vmas_envs=128, max_steps=128, dt=0.1,
                is_use_mtv_distance=False, is_obs_noise=True, entropy_eps=4e-3)


def parameters(n_iters: int, seed: int, device: str, where_to_save: str, **changes) -> Parameters:
    """`TRAINING` (with `changes`) for one seed of `n_iters` iterations."""
    return Parameters(
        **{**TRAINING, **changes}, n_iters=n_iters, random_seed=seed, device=device,
        # The best-reward checkpoint is the deployed model, and the one evaluated.
        is_save_intermediate_model=True, where_to_save=where_to_save,
    )


def run_seed(args, seed: int):
    p = parameters(args.n_iters, seed, args.device, os.path.join(args.work_dir, f"seed{seed}") + "/",
                   num_vmas_envs=args.num_envs, entropy_eps=args.entropy_eps)
    trainer = MAPPOCAVs(p)
    env = trainer.env
    init_params = to_jax_params(trainer.policy_net)
    history, seconds, split = [], [], []
    t_last = time.perf_counter()

    def progress(i, metrics):
        nonlocal t_last
        rew = float(metrics["episode_reward_mean"])
        history.append(rew)
        now = time.perf_counter()
        seconds.append(now - t_last)
        split.append([round(metrics[f"seconds_{k}"], 3) for k in ("rollout", "gae", "update")])
        t_last = now
        print(f"seed {seed} iter {i:3d} episode_reward_mean {rew:8.3f} ({seconds[-1]:.2f} s)",
              flush=True)

    t0 = time.perf_counter()
    _, dm, *_ = trainer.train(progress_callback=progress)
    train_s = time.perf_counter() - t0
    try:
        final_params = ckpt.load_best(p)["policy"]
    except FileNotFoundError:  # no iteration improved on the initial reward
        final_params = to_jax_params(dm.net)
    ev_init = eval_policy(env, init_params, 100 + seed)
    ev_final = eval_policy(env, final_params, 100 + seed)
    print(f"seed {seed} initial: {ev_init}\nseed {seed} trained: {ev_final}", flush=True)
    return p, {
        "seed": seed,
        "train_wall_s": round(train_s, 1),
        "iteration_seconds": [round(s, 3) for s in seconds],
        "iteration_rollout_gae_update_seconds": split,
        "reward_history": [round(r, 3) for r in history],
        "eval_initial": ev_init,
        "eval_final": ev_final,
    }


def _ci95(x):
    """Mean and CI95 half-width (1.96 s / sqrt(n)) over the seed axis."""
    x = np.asarray(x, float)
    n = x.shape[0]
    half = 1.96 * x.std(axis=0, ddof=1) / np.sqrt(n) if n > 1 else np.zeros(x.shape[1:])
    return x.mean(axis=0), half


def device_description(device: torch.device) -> dict:
    """The card's name and nvidia-smi's name and power limit (None for the
    CPU)."""
    if device.type != "cuda":
        return {"device": "cpu", "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(device), "nvidia_smi": smi}


def record(head: dict, runs: list) -> dict:
    """The artifact: `head` (the configuration and the device) and the
    aggregates over `runs`, one per seed."""
    histories = np.array([r["reward_history"] for r in runs])  # [S, I]
    hist_mean, hist_ci = _ci95(histories)
    w = max(1, min(5, histories.shape[1] // 4))

    def agg_eval(which):
        out = {}
        for k in runs[0][which]:
            m, c = _ci95(np.array([[r[which][k]] for r in runs]))
            out[k] = round(float(m[0]), 4)
            out[k + "_ci95"] = round(float(c[0]), 4)
        return out

    return {
        **head,
        "n_seeds": len(runs),
        "train_wall_s": round(sum(r["train_wall_s"] for r in runs), 1),
        "reward_history": [round(float(r), 3) for r in hist_mean],
        "reward_history_ci95": [round(float(c), 3) for c in hist_ci],
        "initial_window_mean": round(float(hist_mean[:w].mean()), 3),
        "final_window_mean": round(float(hist_mean[-w:].mean()), 3),
        "final_window_mean_per_seed": [round(float(h[-w:].mean()), 3) for h in histories],
        "eval_initial": agg_eval("eval_initial"),
        "eval_final": agg_eval("eval_final"),
        "per_seed": runs,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="Learning curve of the PyTorch port")
    ap.add_argument("--n_iters", type=int, default=250)
    ap.add_argument("--num_envs", type=int, default=128)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--entropy_eps", type=float, default=4e-3)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--work_dir", type=str, default="outputs/learning_curve_torch")
    ap.add_argument("--out", type=str, default="LEARNING_CURVE_TORCH.json")
    args = ap.parse_args(argv)

    runs, p = [], None
    for seed in range(args.seeds):
        p, r = run_seed(args, seed)
        runs.append(r)
    head = {
        "scenario": p.scenario_type,
        "n_agents": p.n_agents,
        "num_envs": p.num_vmas_envs,
        "n_iters": p.n_iters,
        "entropy_eps": p.entropy_eps,
        "frames_per_batch": p.frames_per_batch,
        "total_env_steps": p.frames_per_batch * p.n_iters,
        "backend": "torch-" + torch.device(args.device).type,
        **device_description(torch.device(args.device)),
    }
    art = record(head, runs)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1)
    print(f"wrote {args.out}")
    return art


if __name__ == "__main__":
    main()
