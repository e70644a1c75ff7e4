"""Evaluation metrics over recorded rollouts (numpy; the port's copy of the
JAX package's `eval/metrics.py`, the same functions):
- collision rates (agent-agent / agent-lanelet), center-line deviation,
  average speed (`evaluation_base.py:184-217`, `:670-727`),
- distance-normalized, hysteresis-debounced collision events per 100 m
  (`eva_at25/marl_evaluation.py:43-68`),
- interquartile mean and 95% CI aggregation
  (`eva_at25/marl_aggregated_evaluation.py:29-53`).

All metrics operate on the rollout record dict produced by
`sigmarl_tpu_torch.eval.rollout` (numpy arrays [T, B, N, ...]).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def basic_metrics(record: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Episode-level summary metrics (reference `evaluation_base.py:184-217`)."""
    coll_agents = np.asarray(record["is_collision_with_agents"], bool)  # [T, B, N]
    coll_lanelets = np.asarray(record["is_collision_with_lanelets"], bool)
    vel = np.asarray(record["vel"])  # [T, B, N, 2]
    d_ref = np.asarray(record["distance_ref"])  # [T, B, N]

    speed = np.linalg.norm(vel, axis=-1)
    out = {
        "collision_rate_agents": float(coll_agents.any(-1).mean()),
        "collision_rate_lanelets": float(coll_lanelets.any(-1).mean()),
        "collision_rate_total": float((coll_agents | coll_lanelets).any(-1).mean()),
        "center_line_deviation_mean": float(d_ref.mean()),
        "average_speed": float(speed.mean()),
    }
    if "cbf_infeasible" in record:
        # Explicit QP-infeasibility rate (reference `evaluation_itsc25.py:565`):
        # share of (step, env) solves whose converged solution still
        # penetrates a CBF constraint beyond tolerance — see
        # CBFConfig.infeasibility_tol for the solver-status mapping.
        out["qp_infeasibility_rate"] = float(
            np.asarray(record["cbf_infeasible"], bool).mean()
        )
        out["qp_unsolved_rate"] = float(
            (~np.asarray(record["cbf_solved"], bool)).mean()
        )
    return out


def debounced_collision_events(
    collisions: np.ndarray, n_on: int = 3, n_off: int = 10
) -> np.ndarray:
    """Count distinct collision events with hysteresis debouncing.

    A new event starts after `n_on` consecutive colliding steps and ends
    after `n_off` consecutive clear steps (reference
    `eva_at25/marl_evaluation.py:43-68`).

    collisions: [T, ...] bool. Returns event counts with shape [...].
    """
    T = collisions.shape[0]
    flat = collisions.reshape(T, -1)
    counts = np.zeros(flat.shape[1], np.int64)
    for j in range(flat.shape[1]):
        on_streak = off_streak = 0
        in_event = False
        for t in range(T):
            if flat[t, j]:
                on_streak += 1
                off_streak = 0
                if not in_event and on_streak >= n_on:
                    in_event = True
                    counts[j] += 1
            else:
                off_streak += 1
                on_streak = 0
                if in_event and off_streak >= n_off:
                    in_event = False
    return counts.reshape(collisions.shape[1:])


def collisions_per_100m(record: Dict[str, np.ndarray], n_on: int = 3, n_off: int = 10) -> float:
    """Distance-normalized debounced collision events
    (reference `eva_at25/marl_evaluation.py:212-230`)."""
    pos = np.asarray(record["pos"])  # [T, B, N, 2]
    coll = np.asarray(record["is_collision_with_agents"], bool) | np.asarray(
        record["is_collision_with_lanelets"], bool
    )
    dist = np.linalg.norm(np.diff(pos, axis=0), axis=-1).sum()  # total meters driven
    events = debounced_collision_events(coll, n_on, n_off).sum()
    return float(events / max(dist, 1e-9) * 100.0)


def iqm(x: np.ndarray) -> float:
    """Interquartile mean (reference `marl_aggregated_evaluation.py:29-41`)."""
    x = np.sort(np.asarray(x, np.float64).ravel())
    n = x.size
    lo, hi = int(np.floor(n * 0.25)), int(np.ceil(n * 0.75))
    return float(x[lo:hi].mean()) if hi > lo else float(x.mean())


def ci95(x: np.ndarray) -> float:
    """Half-width of the 95% confidence interval of the mean."""
    x = np.asarray(x, np.float64).ravel()
    if x.size < 2:
        return 0.0
    return float(1.96 * x.std(ddof=1) / np.sqrt(x.size))
