"""Testing entry point of the PyTorch port.

    python -m sigmarl_tpu_torch.main_testing <model_dir> [--max_steps 1200]
        [--num_envs 32] [--seed 0] [--deterministic] [--save_video]
        [--device {cuda,cpu}]

Loads a trained model directory (its JSON sidecar restores the training
configuration), switches to testing mode, runs a recorded rollout, saves
the record (`out_td_seed<seed>.npz` in the model directory) and prints the
metrics; `--save_video` renders env 0 of the record on the host to
`video_seed<seed>.mp4` there (needs matplotlib and OpenCV, and raises
before the rollout where either is missing). The options are those of the
JAX package's `main_testing.py`; the device is `cuda` unless `--device
cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from sigmarl_tpu_torch import render
from sigmarl_tpu_torch.env.env import make_env
from sigmarl_tpu_torch.eval import metrics as M
from sigmarl_tpu_torch.eval.evaluation_base import load_model_dir
from sigmarl_tpu_torch.eval.rollout import checkpoint_policy, rollout


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Test a trained MAPPO model (PyTorch port)")
    ap.add_argument("path", type=str, help="model directory (with reward*.pkl)")
    ap.add_argument("--max_steps", type=int, default=1200)
    ap.add_argument("--num_envs", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--save_video", action="store_true")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def test_model(path: str, max_steps: int, num_envs: int, seed: int, deterministic: bool,
               device: str):
    """The recorded testing rollout of a model directory. Returns (metrics,
    record, env)."""
    parameters, params, _ = load_model_dir(path, device, num_vmas_envs=num_envs,
                                           max_steps=max_steps)
    env = make_env(parameters)
    gen = torch.Generator(device=env.device).manual_seed(seed)
    record, timings = rollout(
        env, checkpoint_policy(params["policy"], env, deterministic), max_steps, gen
    )
    result = M.basic_metrics(record)
    result["collisions_per_100m"] = M.collisions_per_100m(record)
    result.update({f"timing_{k}": round(v, 3) for k, v in timings.items()})
    return result, record, env


def main(argv=None):
    args = parse_args(argv)
    if args.save_video:
        render.require_video()
    result, record, env = test_model(args.path, args.max_steps, args.num_envs, args.seed,
                                     args.deterministic, args.device)
    out_file = os.path.join(args.path, f"out_td_seed{args.seed}.npz")
    np.savez_compressed(out_file, **record)
    print(json.dumps(result, indent=1))
    print(f"rollout record saved to {out_file}")
    if args.save_video:
        video_file = os.path.join(args.path, f"video_seed{args.seed}.mp4")
        render.save_rollout_video(env.cfg.scenario_type, record, video_file)
        print(f"video saved to {video_file}")
    return result


if __name__ == "__main__":
    main()
