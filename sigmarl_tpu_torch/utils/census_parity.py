"""Where the reset census's rollout on one device parts from another's.

    python -m sigmarl_tpu_torch.utils.census_parity [--devices cuda cpu] [--batch 16]
        [--warmup 4] [--steps 8] [--out_dir outputs/census_parity] [--against FILE.npz ...]

Runs the main path of `bench.census` (the same generators, draws and
steps: a warm-up of `--warmup` steps from the all-zero state, then
`--steps` counted steps) on each device and keeps, for every step, the
done envs, each agent's collision flags and its margin to each collision
test: the rectangle's MTV distance to the nearest other agent (the
agent-agent test fires at overlap, a margin at or below 0), and for the
lanelet test (a lane boundary crosses the rectangle) the least of
`DELTAS` by which the rectangle must grow on every side for the test to
fire, or shrink (the margin then negative) for it to stop firing. Each
device's record is written to `<out_dir>/<device>-torch<version>-B<batch>.npz`.

For every pair of records (this run's devices and the `--against` files,
say another machine's CPU record), one JSON line: the counted steps'
resetting envs of each, the first step whose done envs differ (1-based
over the whole rollout), and there the envs that differ, the agents whose
flags differ with their margins on both sides, and the largest distance
between the two records' agent positions at that step and the one before.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from sigmarl_tpu_torch import bench
from sigmarl_tpu_torch.core import geometry as G
from sigmarl_tpu_torch.device import device_line, resolve_device
from sigmarl_tpu_torch.safety.wrappers import cbf_filtered_step

DELTAS = (1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)  # m


def lanelet_margin(cfg, tables, pos, rot, path_id, hit) -> torch.Tensor:
    """Each agent's margin to the lanelet test, to within a decade: the
    least delta of `DELTAS` by which its rectangle grown (where the test
    does not fire) or shrunk (where it fires, the margin then negative) on
    every side flips the test; +-inf past the last."""
    pid = path_id.long()
    bounds = (tables.left_boundary[pid], tables.right_boundary[pid])

    def fires(grow):
        w, l = cfg.agent_width + 2 * grow, cfg.agent_length + 2 * grow
        return G.rect_polyline_hit(pos, rot, w, l, bounds[0]) | G.rect_polyline_hit(
            pos, rot, w, l, bounds[1])

    margin = torch.full(hit.shape, float("inf"), device=pos.device)
    for d in reversed(DELTAS):  # the smallest delta that flips is kept
        flips = torch.where(hit, ~fires(-d), fires(d))
        margin = torch.where(flips, torch.full_like(margin, d), margin)
    return torch.where(hit, -margin, margin)


def rollout_record(batch: int, warmup: int, steps: int, device) -> dict:
    """The census's rollout on `device`, step by step, as numpy arrays
    [steps, ...] (warm-up steps first)."""
    dev = resolve_device(device)
    env, cbf, policy, gen, state, obs = bench.main_path(batch, bench.N_AGENTS, dev, draws_on="cpu")
    cfg = env.cfg
    keys = ("done", "coll_agents", "coll_lanelets", "margin_agents", "margin_lanelets", "pos")
    out = {k: [] for k in keys}
    for _ in range(warmup + steps):
        act = bench.policy_actions(env, policy, obs, gen)
        state, obs, _, done, info = cbf_filtered_step(env, cbf, state, act, generator=gen)
        verts = G.rectangle_vertices(info["pos"], info["rot"], cfg.agent_width, cfg.agent_length,
                                     True)
        d = G.mtv_distances(verts, set_diagonal_to=float("inf"))
        row = dict(done=done, coll_agents=info["is_collision_with_agents"],
                   coll_lanelets=info["is_collision_with_lanelets"],
                   margin_agents=d.min(-1).values,
                   margin_lanelets=lanelet_margin(cfg, env.tables, info["pos"], info["rot"],
                                                  info["path_id"],
                                                  info["is_collision_with_lanelets"]),
                   pos=info["pos"])
        for k in keys:
            out[k].append(row[k].cpu().numpy())
    rec = {k: np.stack(v) for k, v in out.items()}
    rec["warmup"] = np.int64(warmup)
    rec["label"] = np.str_(f"{dev.type}-torch{torch.__version__}")
    rec["device"] = np.str_(device_line(dev))
    return rec


def counted(rec: dict) -> list:
    """The resetting envs of each counted step, as `bench.census` counts them."""
    return rec["done"][int(rec["warmup"]):].sum(-1).tolist()


def parting(a: dict, b: dict) -> dict:
    """The first step at which the done envs of records `a` and `b`
    differ, and what differs there."""
    out = dict(a=str(a["label"]), b=str(b["label"]), counts_a=counted(a), counts_b=counted(b),
               warmup=int(a["warmup"]))
    differ = np.nonzero((a["done"] != b["done"]).any(-1))[0]
    pos_gap = np.abs(a["pos"] - b["pos"]).max(axis=(1, 2, 3))
    if len(differ) == 0:
        return {**out, "first_parting_step": None, "max_pos_gap_m": float(pos_gap.max())}
    t = int(differ[0])
    envs = np.nonzero(a["done"][t] != b["done"][t])[0].tolist()
    agents = []
    for e in envs:
        for i in np.nonzero((a["coll_agents"][t, e] != b["coll_agents"][t, e])
                            | (a["coll_lanelets"][t, e] != b["coll_lanelets"][t, e]))[0]:
            agents.append({
                "env": e, "agent": int(i),
                **{f"{k}_{s}": (bool(r[k][t, e, i]) if k.startswith("coll") else
                                float(r[k][t, e, i]))
                   for k in ("coll_agents", "coll_lanelets", "margin_agents", "margin_lanelets")
                   for s, r in (("a", a), ("b", b))},
                "pos_gap_m": float(np.abs(a["pos"][t, e, i] - b["pos"][t, e, i]).max()),
            })
    return {**out, "first_parting_step": t + 1, "envs": envs, "agents": agents,
            "max_pos_gap_m": float(pos_gap[t]),
            "max_pos_gap_m_step_before": float(pos_gap[t - 1]) if t > 0 else 0.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", nargs="+", default=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out_dir", default="outputs/census_parity")
    ap.add_argument("--against", nargs="*", default=[], metavar="FILE.npz")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    recs = []
    for d in args.devices:
        rec = rollout_record(args.batch, args.warmup, args.steps, d)
        np.savez(os.path.join(args.out_dir, f"{rec['label']}-B{args.batch}.npz"), **rec)
        recs.append(rec)
    for path in args.against:
        with np.load(path) as f:
            recs.append({k: f[k] for k in f.files})
    for i in range(len(recs)):
        for j in range(i + 1, len(recs)):
            print(json.dumps({"batch": args.batch, **parting(recs[i], recs[j])}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
