"""Training entry point of the PyTorch port.

    python -m sigmarl_tpu_torch.main_training [--device {cuda,cpu}] [options]

Loads `sigmarl_tpu_torch/config.json` (or `--config`), applies the
command-line overrides, writes an `info.txt` parameter dump beside the
checkpoints, and runs MAPPO training, printing one line per iteration.
The options are those of the JAX package's `main_training.py`; the device
is `cuda` unless `--device cpu` is given.

Under `torchrun --nproc_per_node W` the envs shard over the W ranks
(`parallel/mesh.py`): each rank takes the card `cuda:LOCAL_RANK` (nccl) or,
with `--device cpu`, the CPU (gloo); rank 0 writes `info.txt`, the
checkpoints and the progress lines.
"""

from __future__ import annotations

import argparse
import math
import os

import torch.distributed

from sigmarl_tpu_torch.config import Parameters, get_model_name
from sigmarl_tpu_torch.env.env import REWARD_METHODS
from sigmarl_tpu_torch.parallel.mesh import initialize_distributed
from sigmarl_tpu_torch.rl.mappo_cavs import MAPPOCAVs

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config.json")
OVERRIDES = (
    "random_seed", "scenario_type", "n_agents", "n_iters", "num_vmas_envs",
    "max_steps", "where_to_save", "rew_method", "reward_progress", "h_nom",
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train MAPPO CAVs (PyTorch port)")
    ap.add_argument("--config", type=str, default=DEFAULT_CONFIG)
    ap.add_argument("--random_seed", type=int, default=None)
    ap.add_argument("--scenario_type", type=str, default=None)
    ap.add_argument("--n_agents", type=int, default=None)
    ap.add_argument("--n_iters", type=int, default=None)
    ap.add_argument("--num_vmas_envs", type=int, default=None)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--where_to_save", type=str, default=None)
    ap.add_argument("--rew_method", type=str, default=None, choices=list(REWARD_METHODS))
    ap.add_argument("--reward_progress", type=float, default=None)
    ap.add_argument("--h_nom", type=float, default=None)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    parameters = Parameters.from_json(args.config) if os.path.exists(args.config) else Parameters()
    for name in OVERRIDES:
        v = getattr(args, name)
        if v is not None:
            setattr(parameters, name, v)
    parameters.device = args.device
    parameters.is_continue_train = True
    # The model directory's name from the final (overridden) values.
    parameters.model_name = get_model_name(parameters)

    shard = device = None
    if "WORLD_SIZE" in os.environ:  # launched by torchrun
        shard, device = initialize_distributed(device="cpu" if args.device == "cpu" else None)
    try:
        return _train(parameters, shard, device)
    finally:
        if shard is not None:
            torch.distributed.destroy_process_group()


def _train(parameters: Parameters, shard, device):
    lead = shard is None or shard.rank == 0
    out_dir = os.path.join(parameters.where_to_save, parameters.model_name)
    if lead:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "info.txt"), "w") as f:
            for k, v in parameters.to_dict().items():
                f.write(f"{k}: {v}\n")

    def progress(i, m):
        if not lead:
            return
        rew = float(m["episode_reward_mean"])
        head = f"iter {i + 1}/{parameters.n_iters}: "
        msg = (f"episode mean reward = {rew:.2f}" if math.isfinite(rew)
               else "no episode finished")
        print(head + msg + f" ({m['seconds_rollout'] + m['seconds_gae'] + m['seconds_update']:.2f} s)",
              flush=True)

    trainer = MAPPOCAVs(parameters, device=device, shard=shard)
    return trainer.train(progress_callback=progress)


if __name__ == "__main__":
    main()
