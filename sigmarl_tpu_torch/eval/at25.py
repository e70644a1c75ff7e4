"""CPM-lab benchmark (AT25).

Replay checkpoints from predefined initial poses over long (18,000-step)
rollouts in testing mode, then compute offline distance-normalized
agent-agent and boundary collision events with hysteresis debouncing,
average speed, per-100 m normalization, and IQM/CI95 aggregation across
models and seeds. Run:
`python -m sigmarl_tpu_torch.eval.at25 [<model_dir> ...] [--quick] [--device {cuda,cpu}]`.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np


def default_poses(n_agents: int, scenario_type: str = "cpm_entire"):
    """Predefined initial poses spread along distinct reference paths (the
    lab's poses file): agent i on path i mod K at center-line point
    6 + 3 (i // K). Returns (poses [N, 3] (x, y, yaw), path ids [N])."""
    from sigmarl_tpu_torch.maps.manager import load_map

    m = load_map(scenario_type)
    poses, paths = [], []
    for i in range(n_agents):
        p = m.reference_paths[i % len(m.reference_paths)]
        k = 6 + 3 * (i // len(m.reference_paths))
        poses.append([*p.center_line[k], p.center_line_yaw[k]])
        paths.append(i % len(m.reference_paths))
    return np.asarray(poses, np.float32), np.asarray(paths, np.int32)


def run_model(
    model_path: Optional[str],
    n_agents: int = 15,
    max_steps: int = 18_000,
    n_envs: int = 1,
    seed: int = 0,
    device: str = "cuda",
    draws=None,
) -> Dict:
    """One benchmark rollout from the predefined poses (a checkpoint's
    policy, or (0.5, 0) without one). `draws` (a `StepDraws` per step)
    gives the steps' random numbers; without them they come from a
    generator seeded with `seed`."""
    import torch

    from sigmarl_tpu_torch.config import Parameters
    from sigmarl_tpu_torch.env.env import make_env
    from sigmarl_tpu_torch.eval import metrics as M
    from sigmarl_tpu_torch.eval.rollout import checkpoint_policy, constant_speed_policy, rollout

    parameters = Parameters(
        scenario_type="cpm_entire", n_agents=n_agents, num_vmas_envs=n_envs,
        dt=0.1, max_steps=max_steps + 1, is_testing_mode=True,
        is_use_mtv_distance=False, is_obs_noise=False, device=device,
    )
    env = make_env(parameters)
    if model_path:
        from sigmarl_tpu_torch.rl import checkpoint as ckpt

        parameters.where_to_save = os.path.dirname(model_path.rstrip("/")) + "/"
        parameters.model_name = os.path.basename(model_path.rstrip("/"))
        policy_fn = checkpoint_policy(ckpt.load_best(parameters)["policy"], env)
    else:
        policy_fn = constant_speed_policy(env)

    gen = torch.Generator(device=env.device).manual_seed(seed)
    poses, paths = default_poses(n_agents)
    start = env.reset_predefined(torch.from_numpy(poses), torch.from_numpy(paths), generator=gen)
    record, timings = rollout(env, policy_fn, max_steps, gen, state=start, draws=draws)

    res = M.basic_metrics(record)
    coll_aa = np.asarray(record["is_collision_with_agents"], bool)
    coll_b = np.asarray(record["is_collision_with_lanelets"], bool)
    pos = np.asarray(record["pos"])
    dist_total = np.linalg.norm(np.diff(pos, axis=0), axis=-1).sum()
    res["agent_collision_events_per_100m"] = float(
        M.debounced_collision_events(coll_aa).sum() / max(dist_total, 1e-9) * 100
    )
    res["boundary_collision_events_per_100m"] = float(
        M.debounced_collision_events(coll_b).sum() / max(dist_total, 1e-9) * 100
    )
    res["distance_driven_m"] = float(dist_total)
    res.update({f"timing_{k}": round(v, 4) for k, v in timings.items()})
    return res


def aggregate(per_run: List[Dict]) -> Dict:
    """Mean, IQM and 95% CI of every metric over the runs."""
    from sigmarl_tpu_torch.eval import metrics as M

    agg = {}
    for k in per_run[0]:
        vals = np.asarray([r[k] for r in per_run], np.float64)
        agg[k] = {"mean": float(np.nanmean(vals)), "iqm": M.iqm(vals), "ci95": M.ci95(vals)}
    return agg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("models", nargs="*", help="model dirs (none = scripted)")
    ap.add_argument("--n_agents", type=int, default=15)
    ap.add_argument("--max_steps", type=int, default=18_000)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out_dir", default="outputs/at25")
    args = ap.parse_args(argv)
    if args.quick:
        args.max_steps, args.n_agents = 64, 4

    results = {}
    for model in args.models or [None]:
        runs = [run_model(model, args.n_agents, args.max_steps, seed=s, device=args.device)
                for s in range(args.seeds)]
        results[str(model)] = aggregate(runs)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
