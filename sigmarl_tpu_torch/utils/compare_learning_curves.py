"""Compare the port's learning curve with the JAX package's, seed by seed.

    python -m sigmarl_tpu_torch.utils.compare_learning_curves [--port LEARNING_CURVE_TORCH.json]
        [--jax LEARNING_CURVE.json] [--at 10 60 120 250] [--window 50 70]

Prints Markdown tables: each seed's initial and final window means (the
records' own windows), the seed mean and its CI95 at the given iterations
(1-based), each seed's mean over the given window of iterations against
the other package's seed range there, and the deterministic evaluations
of the initial and the trained policy. Reads only the two JSON records.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def seed_histories(rec: dict) -> np.ndarray:
    return np.array([r["reward_history"] for r in rec["per_seed"]], float)  # [S, I]


def window(h: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Each seed's mean over iterations lo..hi (1-based, inclusive)."""
    return h[:, lo - 1:hi].mean(axis=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", default=os.path.join(ROOT, "LEARNING_CURVE_TORCH.json"))
    ap.add_argument("--jax", default=os.path.join(ROOT, "LEARNING_CURVE.json"))
    ap.add_argument("--at", type=int, nargs="+", default=[10, 60, 120, 250])
    ap.add_argument("--window", type=int, nargs=2, default=[50, 70])
    args = ap.parse_args(argv)
    recs = {"port": load(args.port), "JAX": load(args.jax)}
    for name, r in recs.items():
        dev = r.get("nvidia_smi") or r.get("backend")
        print(f"{name}: {r['n_seeds']} seeds x {r['n_iters']} iterations, {dev}")

    print("\n| | seed | initial window | final window |\n| --- | --- | --- | --- |")
    for name, r in recs.items():
        h = seed_histories(r)
        w = max(1, min(5, h.shape[1] // 4))
        for s, row in zip((x["seed"] for x in r["per_seed"]), h):
            print(f"| {name} | {s} | {row[:w].mean():.3f} | {row[-w:].mean():.3f} |")
        print(f"| {name} | mean | {r['initial_window_mean']:.3f} | {r['final_window_mean']:.3f} |")

    print("\n| iteration | " + " | ".join(f"{n} mean (CI95)" for n in recs) + " |")
    print("| --- |" + " --- |" * len(recs))
    for it in args.at:
        cells = []
        for r in recs.values():
            if it <= r["n_iters"]:
                cells.append(f"{r['reward_history'][it - 1]:.3f} "
                             f"({r['reward_history_ci95'][it - 1]:.3f})")
            else:
                cells.append("not run")
        print(f"| {it} | " + " | ".join(cells) + " |")

    lo, hi = args.window
    h = {n: seed_histories(r) for n, r in recs.items()}
    print(f"\n| seeds' mean over iterations {lo}-{hi} | values | range |\n| --- | --- | --- |")
    for n, x in h.items():
        v = window(x, lo, hi)
        print(f"| {n} | " + ", ".join(f"{a:.3f}" for a in v) + f" | {v.min():.3f} to {v.max():.3f} |")
    port_w, jax_w = window(h["port"], lo, hi), window(h["JAX"], lo, hi)
    print(f"\nall port seeds above JAX's highest at {lo}-{hi}: {bool((port_w > jax_w.max()).all())}")
    pf, jf = h["port"][:, -5:].mean(1), h["JAX"][:, -5:].mean(1)
    outside = (pf < jf.min()) | (pf > jf.max())
    print(f"port seeds outside JAX's final range [{jf.min():.3f}, {jf.max():.3f}]: "
          f"{int(outside.sum())} of {len(pf)}")

    keys = ("reward_mean", "collision_rate_agents", "collision_rate_lanelets",
            "collision_steps_per_100m", "meters_driven")
    print("\n| evaluation | " + " | ".join(f"{n} {w}" for n in recs for w in ("initial", "final"))
          + " |\n| --- |" + " --- |" * (2 * len(recs)))
    for k in keys:
        cells = [f"{r[w][k]:.4g} ({r[w][k + '_ci95']:.2g})" for r in recs.values()
                 for w in ("eval_initial", "eval_final")]
        print(f"| {k} | " + " | ".join(cells) + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
