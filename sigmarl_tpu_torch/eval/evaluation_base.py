"""Evaluation harness over trained model directories.

For each model directory: load the best checkpoint (reward-keyed), re-run
(or load cached) evaluation rollouts in testing mode, compute the metric
suite, aggregate over seeds (IQM, CI95), and draw bar summaries. Rollout
records are cached as `.npz` files.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from sigmarl_tpu_torch.config import Parameters
from sigmarl_tpu_torch.env.env import make_env
from sigmarl_tpu_torch.eval import metrics as M
from sigmarl_tpu_torch.eval.rollout import checkpoint_policy, rollout
from sigmarl_tpu_torch.rl import checkpoint as ckpt


def load_model_dir(model_path: str, device: str, **testing) -> tuple:
    """The run `Parameters` of a model directory (from its newest JSON
    sidecar), switched to testing mode with observation noise off and the
    `testing` overrides applied, and its best checkpoint. Returns
    (parameters, params, reward history)."""
    sidecars = sorted(f for f in os.listdir(model_path) if f.endswith("_data.json"))
    if not sidecars:
        raise FileNotFoundError(f"no data sidecar in {model_path}")
    with open(os.path.join(model_path, sidecars[-1])) as f:
        data = json.load(f)
    parameters = Parameters.from_dict(data["parameters"])
    parameters.where_to_save = os.path.dirname(model_path.rstrip("/")) + "/"
    parameters.model_name = os.path.basename(model_path.rstrip("/"))
    parameters.is_testing_mode = True
    parameters.is_obs_noise = False
    parameters.device = device
    for k, v in testing.items():
        setattr(parameters, k, v)
    return parameters, ckpt.load_best(parameters), data.get("episode_reward_mean_list", [])


@dataclass
class Evaluation:
    """Evaluate a set of trained models."""

    model_paths: List[str]
    n_sims: int = 32  # parallel envs per model
    max_steps: int = 1200  # steps per model
    render_titles: Optional[List[str]] = None
    where_to_save_eva_results: str = "outputs/eval"
    is_load_out_td: bool = True  # load cached rollout records when present
    device: str = "cuda"
    results: Dict[str, Dict] = field(default_factory=dict)

    def evaluate_model(self, model_path: str, seed: int = 0) -> Dict:
        cache = os.path.join(
            self.where_to_save_eva_results,
            os.path.basename(model_path.rstrip("/")) + f"_seed{seed}.npz",
        )
        parameters, params, reward_hist = load_model_dir(
            model_path, self.device, num_vmas_envs=self.n_sims, max_steps=self.max_steps
        )
        if self.is_load_out_td and os.path.exists(cache):
            record = dict(np.load(cache))
            timings = {}
        else:
            env = make_env(parameters)
            gen = torch.Generator(device=env.device).manual_seed(seed)
            record, timings = rollout(
                env, checkpoint_policy(params["policy"], env), self.max_steps, gen
            )
            os.makedirs(self.where_to_save_eva_results, exist_ok=True)
            np.savez_compressed(cache, **record)

        result = M.basic_metrics(record)
        result["collisions_per_100m"] = M.collisions_per_100m(record)
        result["episode_reward_final"] = float(reward_hist[-1]) if reward_hist else float("nan")
        result.update({f"timing_{k}": v for k, v in timings.items()})
        self.results[model_path] = result
        return result

    def run_evaluation(self, seeds: List[int] = (0,)) -> Dict[str, Dict]:
        """Evaluate all model directories over the given seeds; aggregate
        with the mean, IQM and CI95."""
        for path in self.model_paths:
            per_seed = [self.evaluate_model(path, seed=s) for s in seeds]
            agg = {}
            for k in per_seed[0]:
                vals = np.asarray([r[k] for r in per_seed], np.float64)
                agg[k] = float(np.nanmean(vals))
                agg[k + "_iqm"] = M.iqm(vals)
                agg[k + "_ci95"] = M.ci95(vals)
            self.results[path] = agg
        return self.results

    def plot(self, save_path: Optional[str] = None):
        """Bar summary of the headline metrics per model (needs
        matplotlib)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        keys = ["collision_rate_total", "center_line_deviation_mean", "average_speed"]
        fig, axes = plt.subplots(1, len(keys), figsize=(4 * len(keys), 3))
        names = [os.path.basename(p.rstrip("/")) for p in self.results]
        for ax, k in zip(axes, keys):
            vals = [self.results[p].get(k, np.nan) for p in self.results]
            ax.bar(range(len(names)), vals)
            ax.set_xticks(range(len(names)))
            ax.set_xticklabels(names, rotation=45, ha="right", fontsize=7)
            ax.set_title(k, fontsize=9)
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path, dpi=150)
        return fig
