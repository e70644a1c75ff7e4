"""Circle over-approximation of the vehicle rectangle: n circles of minimal
common radius along the length axis, and their world-frame centers."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from sigmarl_tpu_torch import trace


@dataclass(frozen=True)
class CircleApproximation:
    length: float
    width: float
    n_circles: int

    @property
    def radius(self) -> float:
        """Minimal radius reaching the far corners of each length segment."""
        segment = self.length / self.n_circles
        return math.hypot(segment / 2, self.width / 2)

    @property
    def centers_local(self) -> np.ndarray:
        """[n_circles, 2] circle centers in the vehicle frame (y = 0)."""
        step = self.length / self.n_circles
        start = -self.length / 2 + step / 2
        xs = start + np.arange(self.n_circles) * step
        return np.stack([xs, np.zeros_like(xs)], axis=-1).astype(np.float32)


def circle_centers_world(
    approx: CircleApproximation, pos: torch.Tensor, rot: torch.Tensor
) -> torch.Tensor:
    """Rotate local circle centers into the world frame.
    pos [..., 2]; rot [...]. Returns [..., n_circles, 2]."""
    local = torch.as_tensor(approx.centers_local, device=pos.device)
    trace.count_sync(pos.device)  # a copy from pageable host memory
    c, s = torch.cos(rot)[..., None], torch.sin(rot)[..., None]
    x = local[:, 0] * c - local[:, 1] * s
    y = local[:, 0] * s + local[:, 1] * c
    return torch.stack([x, y], dim=-1) + pos[..., None, :]
