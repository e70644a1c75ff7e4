"""Circle over-approximation of the vehicle rectangle: n circles of minimal
common radius along the length axis, and their world-frame centers."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


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
    centers_local: torch.Tensor, pos: torch.Tensor, rot: torch.Tensor
) -> torch.Tensor:
    """Rotate local circle centers into the world frame. centers_local
    [n_circles, 2] on pos's device (the filter's, made once: a tensor made
    here per call would copy from pageable host memory); pos [..., 2];
    rot [...]. Returns [..., n_circles, 2]."""
    c, s = torch.cos(rot)[..., None], torch.sin(rot)[..., None]
    x = centers_local[:, 0] * c - centers_local[:, 1] * s
    y = centers_local[:, 0] * s + centers_local[:, 1] * c
    return torch.stack([x, y], dim=-1) + pos[..., None, :]
