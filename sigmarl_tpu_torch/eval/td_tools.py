"""Rollout-record aggregation tools.

Scan a directory of saved rollout records (`out_td_*.npz`, as
`main_eval` and `main_testing` write them), parse their filename tags,
compute collision rates, average speeds and timing stats, and draw box
plots (matplotlib, imported only to plot). Run:
`python -m sigmarl_tpu_torch.eval.td_tools <dir>`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Dict, List, Optional

import numpy as np

from sigmarl_tpu_torch.eval import metrics as M

_TAG_RE = re.compile(
    r"out_td_(?P<scenario>[a-z0-9_]+?)_n(?P<n_agents>\d+)_c(?P<n_circles>\d+)_"
    r"(?P<nom>rl|clf)_(?P<cbf>cbf|nocbf)_s(?P<seed>\d+)\.npz"
)


def parse_tag(path: str) -> Optional[Dict]:
    m = _TAG_RE.search(os.path.basename(path))
    return m.groupdict() if m else None


def analyze_record(path: str) -> Dict:
    record = dict(np.load(path))
    res = M.basic_metrics(record)
    res["collisions_per_100m"] = M.collisions_per_100m(record)
    tag = parse_tag(path)
    if tag:
        res.update(tag)
    res["file"] = os.path.basename(path)
    return res


def analyze_dir(directory: str) -> List[Dict]:
    results = [analyze_record(p) for p in sorted(glob.glob(os.path.join(directory, "out_td_*.npz")))]
    # Merge computation-time JSONs when present (main_eval companions).
    for res in results:
        t_file = os.path.join(
            directory, res["file"].replace("out_td_", "computation_t_").replace(".npz", ".json")
        )
        if os.path.exists(t_file):
            with open(t_file) as f:
                res.update({k: v for k, v in json.load(f).items() if k.startswith("timing_")})
    return results


def boxplot(results: List[Dict], key: str, group_by: str = "cbf", save_path: str = None):
    """Grouped box plot of a metric."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups: Dict[str, List[float]] = {}
    for r in results:
        g = str(r.get(group_by, "all"))
        groups.setdefault(g, []).append(float(r[key]))
    fig, ax = plt.subplots(figsize=(4, 3))
    ax.boxplot(list(groups.values()), labels=list(groups.keys()))
    ax.set_ylabel(key)
    ax.set_xlabel(group_by)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("directory")
    ap.add_argument("--plot_key", default="collision_rate_total")
    ap.add_argument("--group_by", default="cbf")
    args = ap.parse_args()
    results = analyze_dir(args.directory)
    print(json.dumps(results, indent=1, default=str))
    if results:
        out = os.path.join(args.directory, f"boxplot_{args.plot_key}.png")
        boxplot(results, args.plot_key, args.group_by, out)
        print(f"plot saved to {out}")


if __name__ == "__main__":
    main()
