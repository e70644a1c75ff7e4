"""Reward-keyed checkpointing.

Checkpoints are named `reward{mean:.2f}_*` and written only when the mean
episode reward improves; older lower-reward files are deleted; a JSON
sidecar stores the run `Parameters` and the reward history, so saved
models describe themselves; `final_*` files are written at the end of
training.

A checkpoint is a pickle of the network's flax parameter tree as numpy
arrays (`rl/networks.py::to_jax_params`), with no torch object in it: the
JAX package's `rl/checkpoint.py` writes and reads the same files, so a
checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import re
from typing import Any, Dict, List, Optional

import numpy as np

from sigmarl_tpu_torch.config import Parameters

_REWARD_RE = re.compile(r"reward(-?\d+\.\d+)_")


def model_dir(parameters: Parameters) -> str:
    return os.path.join(parameters.where_to_save, parameters.model_name or "model")


def save_params(path: str, params: Any) -> None:
    """Pickle a numpy parameter tree."""
    with open(path, "wb") as f:
        pickle.dump(params, f)


def load_params(path: str) -> Any:
    """Unpickle a parameter tree written by `save_params` (of either
    package)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def find_highest_reward(directory: str) -> Optional[float]:
    """Highest reward among the saved checkpoints, or None."""
    rewards = [
        float(m.group(1))
        for p in glob.glob(os.path.join(directory, "reward*_policy.pkl"))
        if (m := _REWARD_RE.search(os.path.basename(p)))
    ]
    return max(rewards) if rewards else None


def delete_files_with_lower_reward(directory: str, keep_reward: float) -> None:
    for p in glob.glob(os.path.join(directory, "reward*")):
        m = _REWARD_RE.search(os.path.basename(p))
        if m and float(m.group(1)) < keep_reward:
            os.remove(p)


class RewardKeyedCheckpointer:
    """Writes `params` = {"policy": tree, "critic": tree} (numpy flax
    trees) under the model directory of `parameters`."""

    def __init__(self, parameters: Parameters):
        self.parameters = parameters
        self.dir = model_dir(parameters)
        os.makedirs(self.dir, exist_ok=True)
        self.best = parameters.episode_reward_intermediate

    def _sidecar(self, reward_history: List[float]) -> Dict:
        p = self.parameters.to_dict()
        p["episode_reward_intermediate"] = self.best
        return {"parameters": p, "episode_reward_mean_list": reward_history}

    def maybe_save(self, reward: float, params: Dict[str, Any], reward_history: List[float]) -> bool:
        """Save a checkpoint if `reward` beats the best so far; always
        refresh the JSON sidecar. Returns True if model files were written."""
        improved = bool(np.isfinite(reward) and reward > self.best)
        if improved:
            self.best = reward
            tag = f"reward{reward:.2f}"
            save_params(os.path.join(self.dir, f"{tag}_policy.pkl"), params["policy"])
            save_params(os.path.join(self.dir, f"{tag}_critic.pkl"), params["critic"])
            delete_files_with_lower_reward(self.dir, reward)
        tag = f"reward{self.best:.2f}" if np.isfinite(self.best) else "reward0.00"
        with open(os.path.join(self.dir, f"{tag}_data.json"), "w") as f:
            json.dump(self._sidecar(reward_history), f)
        return improved

    def save_final(self, params: Dict[str, Any], reward_history: List[float]) -> None:
        save_params(os.path.join(self.dir, "final_policy.pkl"), params["policy"])
        save_params(os.path.join(self.dir, "final_critic.pkl"), params["critic"])
        with open(os.path.join(self.dir, "final_data.json"), "w") as f:
            json.dump(self._sidecar(reward_history), f)


def load_sidecar(parameters: Parameters) -> Optional[Dict]:
    """The JSON sidecar of the checkpoint `load_best` would pick, or None."""
    d = model_dir(parameters)
    if parameters.is_load_final_model:
        path = os.path.join(d, "final_data.json")
    else:
        best = find_highest_reward(d)
        if best is None:
            return None
        path = os.path.join(d, f"reward{best:.2f}_data.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_best(parameters: Parameters) -> Dict[str, Any]:
    """The best (or, with `is_load_final_model`, the final) checkpoint as
    {"policy": tree, "critic": tree} of numpy arrays."""
    d = model_dir(parameters)
    if parameters.is_load_final_model:
        tag = "final"
    else:
        best = find_highest_reward(d)
        if best is None:
            raise FileNotFoundError(f"no reward-keyed checkpoints in {d}")
        tag = f"reward{best:.2f}"
    return {
        "policy": load_params(os.path.join(d, f"{tag}_policy.pkl")),
        "critic": load_params(os.path.join(d, f"{tag}_critic.pkl")),
    }
