"""Host-side map data structures (numpy).

The map stack runs in two stages:

1. *Parse* (this module + `parse_xml.py`): read the raw map file into
   `MapData` — plain numpy polylines per lanelet and per reference path.
   Host-side preprocessing, runs once.
2. *Compile* (`env/map_tables.py`): pad and stack everything into
   fixed-shape tensors so that per-agent path (re)assignment on the device
   is a single index gather.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def polyline_yaw_and_vecs(polyline: np.ndarray):
    """Per-segment yaw, normalized vectors, and mean segment length of a polyline.

    Equivalent to the reference's center-line post-processing
    (`parse_xml.py:696-709`, `parse_osm.py:264-281`).
    """
    vecs = np.diff(polyline, axis=0)
    lengths = np.linalg.norm(vecs, axis=1)
    yaw = np.arctan2(vecs[:, 1], vecs[:, 0])
    vecs_normalized = vecs / np.maximum(lengths[:, None], 1e-12)
    return yaw.astype(np.float32), vecs_normalized.astype(np.float32), float(lengths.mean())


def pseudo_tangent_vector(points: np.ndarray) -> np.ndarray:
    """Tangent-vector approximation at each polyline point.

    First point: forward difference; last point: backward difference;
    interior: central difference (reference `helper_scenario.py:1369-1399`).
    """
    n = points.shape[0]
    t = np.zeros_like(points)
    if n >= 2:
        t[0] = points[1] - points[0]
        t[-1] = points[-1] - points[-2]
    if n >= 3:
        t[1:-1] = points[2:] - points[:-2]
    return t.astype(np.float32)


@dataclass
class RefPath:
    """One reference path: a center line with its (shared) lane boundaries."""

    lanelet_ids: List[int]
    center_line: np.ndarray  # [P, 2]
    center_line_yaw: np.ndarray  # [P-1]
    center_line_vec_normalized: np.ndarray  # [P-1, 2]
    center_line_vec_mean_length: float
    left_boundary: np.ndarray  # [Pl, 2]
    right_boundary: np.ndarray  # [Pr, 2]
    left_boundary_shared: np.ndarray  # [Pls, 2]
    right_boundary_shared: np.ndarray  # [Prs, 2]
    is_loop: bool
    # Pseudo tangent vectors for the pseudo-distance field (computed lazily).
    left_boundary_shared_pseudo_vector: Optional[np.ndarray] = None
    right_boundary_shared_pseudo_vector: Optional[np.ndarray] = None

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                setattr(self, f.name, v.astype(np.float32))
        if self.left_boundary_shared_pseudo_vector is None:
            self.left_boundary_shared_pseudo_vector = pseudo_tangent_vector(
                self.left_boundary_shared
            )
        if self.right_boundary_shared_pseudo_vector is None:
            self.right_boundary_shared_pseudo_vector = pseudo_tangent_vector(
                self.right_boundary_shared
            )


@dataclass
class Lanelet:
    """A single lanelet (lane segment) of the map."""

    lanelet_id: int  # 1-based ID as used by the map format
    left_boundary: np.ndarray  # [P, 2]
    right_boundary: np.ndarray  # [P, 2]
    center_line: np.ndarray  # [P, 2]
    left_line_marking: Optional[str] = None
    right_line_marking: Optional[str] = None
    predecessors: List[int] = field(default_factory=list)
    successors: List[int] = field(default_factory=list)


@dataclass
class MapData:
    """Parsed map: lanelets, reference paths, and world bounds."""

    scenario_type: str
    lanelets: List[Lanelet]
    reference_paths: List[RefPath]
    reference_paths_intersection: List[RefPath] = field(default_factory=list)
    reference_paths_merge_in: List[RefPath] = field(default_factory=list)
    reference_paths_merge_out: List[RefPath] = field(default_factory=list)
    neighboring_lanelets_idx: List[List[int]] = field(default_factory=list)
    bounds: Dict[str, float] = field(default_factory=dict)

    def ref_lanelet_segment_points(self, lanelet_ids: List[int]) -> np.ndarray:
        """The start point of each lanelet's center line plus the end point
        of the last one [len(ids) + 1, 2]. IDs resolve by `lanelet_id`, and
        an ID no lanelet carries by its 0-based index (the OSM maps' IDs)."""
        by_id = {ll.lanelet_id: ll for ll in self.lanelets}
        pts = []
        for lid in lanelet_ids:
            lane = by_id.get(lid)
            if lane is None:
                lane = self.lanelets[lid]
            pts.append(lane.center_line[0])
        pts.append(lane.center_line[-1])
        return np.stack(pts, axis=0).astype(np.float32)
