"""CBF safety-filter evaluation entry point of the PyTorch port.

    python -m sigmarl_tpu_torch.main_eval [--model_path DIR] [--scenario_type cpm_mixed]
        [--n_agents 4] [--num_envs 32] [--max_steps 600] [--n_circles 3]
        [--nom_controller_type {rl,clf}] [--decentralized] [--no_cbf] ...
        [--save_video] [--device {cuda,cpu}]

A testing-mode rollout through the CBF-QP filter (centralized or
decentralized, optionally grouped; RL or CLF nominal controller), saving
the rollout record (`out_td_<tag>.npz`), the metrics with the timing
(`computation_t_<tag>.json`) and printing them, the QP infeasibility rate
included; `--save_video` renders env 0 of the record on the host, with
the filter's interventions as pairs of action arrows, to
`video_<tag>.mp4` (needs matplotlib and OpenCV, and raises before the
rollout where either is missing). The options are those of the JAX
package's `main_eval.py`; the device is `cuda` unless `--device cpu` is
given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from sigmarl_tpu_torch import render
from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.env.env import make_env
from sigmarl_tpu_torch.eval import metrics as M
from sigmarl_tpu_torch.eval.rollout import checkpoint_policy, constant_speed_policy, rollout
from sigmarl_tpu_torch.safety.cbf_qp import CBFConfig, CBFSafetyFilter


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Evaluate the CBF-QP safety filter (PyTorch port)")
    ap.add_argument("--model_path", type=str, default=None,
                    help="trained model dir (omit for the CLF nominal controller)")
    ap.add_argument("--scenario_type", type=str, default="cpm_mixed")
    ap.add_argument("--n_agents", type=int, default=4)
    ap.add_argument("--num_envs", type=int, default=32)
    ap.add_argument("--max_steps", type=int, default=600)
    ap.add_argument("--n_circles", type=int, default=3)
    ap.add_argument("--nom_controller_type", choices=["rl", "clf"], default="clf")
    ap.add_argument("--is_grouping_agents", action="store_true")
    ap.add_argument("--max_group_size", type=int, default=2)
    ap.add_argument("--decentralized", action="store_true")
    ap.add_argument("--no_cbf", action="store_true", help="baseline without filter")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out_dir", type=str, default="outputs/eval_cbf")
    ap.add_argument("--save_video", action="store_true",
                    help="render an mp4 with CBF-vs-nominal action arrows")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def run_tag(args) -> str:
    return (f"{args.scenario_type}_n{args.n_agents}_c{args.n_circles}_"
            f"{args.nom_controller_type}_{'nocbf' if args.no_cbf else 'cbf'}_s{args.seed}")


def build(args):
    """What the evaluation of parsed `args` runs: (env in testing mode,
    filter or None, nominal policy)."""
    parameters = Parameters(
        scenario_type=args.scenario_type,
        n_agents=args.n_agents,
        num_vmas_envs=args.num_envs,
        max_steps=args.max_steps,
        dt=0.1,
        is_testing_mode=True,
        is_obs_noise=False,
        is_use_mtv_distance=False,
        n_circles_approximate_vehicle=args.n_circles,
        nom_controller_type=args.nom_controller_type,
        is_using_cbf_testing=not args.no_cbf,
        is_using_centralized_cbf=not args.decentralized,
        device=args.device,
    )
    env = make_env(parameters)
    cbf = None
    if not args.no_cbf:
        cbf = CBFSafetyFilter(
            CBFConfig(
                n_agents=args.n_agents,
                n_circles=args.n_circles,
                dt=parameters.dt,
                nom_controller_type=args.nom_controller_type,
                use_windowed_pseudo_distance=True,
            ),
            env.cfg,
            env.tables,
            decentralized=args.decentralized,
            max_group_size=args.max_group_size if args.is_grouping_agents else 0,
            device=env.device,
        )
    if args.model_path:
        from sigmarl_tpu_torch.rl import checkpoint as ckpt

        parameters.where_to_save = os.path.dirname(args.model_path.rstrip("/")) + "/"
        parameters.model_name = os.path.basename(args.model_path.rstrip("/"))
        policy_fn = checkpoint_policy(ckpt.load_best(parameters)["policy"], env)
    else:
        # (0.5, 0) nominal actions; with the CLF nominal controller the
        # filter replaces them with its own.
        policy_fn = constant_speed_policy(env)
    return env, cbf, policy_fn


def evaluate(args):
    """The evaluation rollout of parsed `args`. Returns (metrics, record,
    env, filter or None)."""
    env, cbf, policy_fn = build(args)
    gen = torch.Generator(device=env.device).manual_seed(args.seed)
    record, timings = rollout(env, policy_fn, args.max_steps, gen, cbf=cbf)
    result = M.basic_metrics(record)
    result["collisions_per_100m"] = M.collisions_per_100m(record)
    result.update({f"timing_{k}": round(v, 4) for k, v in timings.items()})
    return result, record, env, cbf


def main(argv=None):
    args = parse_args(argv)
    if args.save_video:
        render.require_video()
    result, record, _, _ = evaluate(args)
    os.makedirs(args.out_dir, exist_ok=True)
    tag = run_tag(args)
    np.savez_compressed(os.path.join(args.out_dir, f"out_td_{tag}.npz"), **record)
    if args.save_video:
        render.save_rollout_video(args.scenario_type, record,
                                  os.path.join(args.out_dir, f"video_{tag}.mp4"))
    with open(os.path.join(args.out_dir, f"computation_t_{tag}.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
