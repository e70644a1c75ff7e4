"""Pseudo-distance concept figures: the pseudo-distance field to the left
and right shared lane boundaries of the example map on a regular grid,
drawn as colormaps with the boundary polyline and its pseudo tangent
vectors overlaid.

    python -m sigmarl_tpu_torch.safety.pseudo_distance_example [out_dir]
        [--device cuda|cpu]

The field is computed on `device` (`cuda` unless the caller asks for the
CPU); the figures are drawn on the host with matplotlib, as `render.py`
draws.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from sigmarl_tpu_torch.device import resolve_device
from sigmarl_tpu_torch.maps.manager import load_map
from sigmarl_tpu_torch.safety.pseudo_distance import pseudo_distance_to_polyline


def compute_field(boundary: np.ndarray, tangents: np.ndarray, xlim, ylim,
                  resolution: int = 200, device: str | torch.device | None = None):
    """Pseudo-distance field on a resolution x resolution grid over xlim x
    ylim. Returns (X, Y, D), numpy arrays of that shape."""
    dev = resolve_device(device)
    X, Y = np.meshgrid(np.linspace(*xlim, resolution), np.linspace(*ylim, resolution))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    pts = t(np.stack([X.ravel(), Y.ravel()], -1))
    d = pseudo_distance_to_polyline(pts, t(boundary), t(tangents))
    return X, Y, d.cpu().numpy().reshape(resolution, resolution)


def make_figures(out_dir: str, scenario: str = "pseudo_distance_example",
                 device: str | torch.device | None = None):
    """Write `pseudo_distance_{left,right}.png` to out_dir; returns their
    paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    path = load_map(scenario).reference_paths[0]
    allpts = np.concatenate([path.left_boundary_shared, path.right_boundary_shared])
    pad = 0.15
    xlim = (allpts[:, 0].min() - pad, allpts[:, 0].max() + pad)
    ylim = (allpts[:, 1].min() - pad, allpts[:, 1].max() + pad)
    os.makedirs(out_dir, exist_ok=True)
    sides = [
        ("left", path.left_boundary_shared, path.left_boundary_shared_pseudo_vector),
        ("right", path.right_boundary_shared, path.right_boundary_shared_pseudo_vector),
    ]
    paths_out = []
    for name, bnd, tan in sides:
        X, Y, D = compute_field(bnd, tan, xlim, ylim, device=device)
        D = np.where(D >= 999.0, np.nan, D)
        fig, ax = plt.subplots(figsize=(5, 4))
        pc = ax.pcolormesh(X, Y, D, shading="auto", cmap="viridis")
        fig.colorbar(pc, ax=ax, label="pseudo distance [m]")
        ax.plot(bnd[:, 0], bnd[:, 1], "k-", lw=1.5)
        ax.quiver(bnd[:, 0], bnd[:, 1], tan[:, 0], tan[:, 1], angles="xy", scale_units="xy",
                  scale=12, width=0.004, color="w")
        ax.set_title(f"pseudo distance to {name} boundary")
        ax.set_aspect("equal")
        fig.tight_layout()
        out = os.path.join(out_dir, f"pseudo_distance_{name}.png")
        fig.savefig(out, dpi=150)
        plt.close(fig)
        paths_out.append(out)
    return paths_out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Pseudo-distance concept figures")
    ap.add_argument("out_dir", nargs="?", default="outputs/pseudo_distance_example")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    for p in make_figures(args.out_dir, device=args.device):
        print(p)


if __name__ == "__main__":
    main()
