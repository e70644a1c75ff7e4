"""The port's committed learning curve, `LEARNING_CURVE_TORCH.json`, as
`python -m sigmarl_tpu_torch.learning_curve` wrote it on the card
(cpm_mixed, N=4, B=128, T=128, the protocol of
`scripts/train_learning_curve.py`): a real run on a CUDA device at JAX's
settings (250 iterations of 3 seeds), every value finite, and in every
seed the episode reward's mean over the last 10 iterations at least 0.07
above its mean over the first 10 (half the smallest rise of the JAX
package's seeds on the TPU over their first 60 iterations, -0.11 / -0.15
/ -0.14 to 0.025 / 0.035 / 0.016)."""

import json
import os

import numpy as np

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "LEARNING_CURVE_TORCH.json")


def _artifact() -> dict:
    with open(ART) as f:
        return json.load(f)


def test_learning_curve_is_a_real_card_run():
    a = _artifact()
    assert a["n_iters"] == 250 and a["n_seeds"] == 3 == len(a["per_seed"])
    assert a["frames_per_batch"] == 128 * 128
    assert a["total_env_steps"] == a["n_iters"] * a["frames_per_batch"]
    assert a["backend"] == "torch-cuda" and "H100" in a["device"] and "W" in a["nvidia_smi"]
    assert len(a["reward_history"]) == a["n_iters"] == len(a["reward_history_ci95"])
    for r in a["per_seed"]:
        assert len(r["reward_history"]) == len(r["iteration_seconds"]) == a["n_iters"]
        assert np.isfinite(r["reward_history"]).all() and np.isfinite(r["iteration_seconds"]).all()
    assert np.isfinite(a["reward_history"]).all()
    for which in ("eval_initial", "eval_final"):
        assert np.isfinite(list(a[which].values())).all()


def test_reward_rises_from_the_first_to_the_last_ten_iterations():
    for r in _artifact()["per_seed"]:
        h = np.asarray(r["reward_history"])
        assert h[-10:].mean() - h[:10].mean() >= 0.07, (h[:10].mean(), h[-10:].mean())


def test_aggregates_are_those_of_the_per_seed_runs():
    """The record's mean curve, CI95, window means and evaluations are
    `learning_curve.record` of its own per-seed runs."""
    from sigmarl_tpu_torch.learning_curve import record

    a = _artifact()
    head = {k: v for k, v in a.items() if k in ("scenario", "n_agents", "num_envs", "n_iters",
                                                 "entropy_eps", "frames_per_batch",
                                                 "total_env_steps", "backend", "device",
                                                 "nvidia_smi")}
    assert record(head, a["per_seed"]) == a
