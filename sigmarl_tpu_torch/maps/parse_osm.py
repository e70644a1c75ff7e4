"""JOSM OSM map parser, host-side numpy (the port's copy of the JAX
package's `maps/parse_osm.py`).

OSM nodes give
lanelet center lines (lat -> x, lon -> y, scaled and shifted to positive
coordinates); left/right boundaries are per-segment perpendicular offsets of
+-lane_width/2; reference paths concatenate lanelet center lines per the
scenario's `reference_paths_ids` (dropping duplicated connection nodes, and
the final node for loops).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np

from sigmarl_tpu_torch.constants import SCENARIOS
from sigmarl_tpu_torch.maps.data import Lanelet, MapData, RefPath, polyline_yaw_and_vecs


def _boundaries_from_center(center: np.ndarray, width: float):
    """Perpendicular offset boundaries; the last point reuses the final
    segment's normal."""
    d = np.diff(center, axis=0)
    perp = np.stack([-d[:, 1], d[:, 0]], axis=-1)
    norm = np.linalg.norm(perp, axis=-1, keepdims=True)
    perp = np.where(norm > 0, perp / np.maximum(norm, 1e-12), perp)
    perp_full = np.concatenate([perp, perp[-1:]], axis=0)
    left = center + perp_full * (width / 2)
    right = center - perp_full * (width / 2)
    return left.astype(np.float32), right.astype(np.float32)


def parse_osm(scenario_type: str, osm_path: str, lane_width: float = None) -> MapData:
    scen = SCENARIOS[scenario_type]
    width = lane_width if lane_width is not None else scen["lane_width"]
    scale = scen["scale"]
    ref_ids: List[List[str]] = scen["reference_paths_ids"]
    neighboring: Dict[str, List[str]] = scen.get("neighboring_lanelet_ids", {})

    tree = ET.parse(osm_path)
    root = tree.getroot()

    # Nodes: lat -> x, lon -> y; scale & shift so all coordinates are positive
    # with a 1.2*width margin.
    raw = {}
    for node in root.findall("node"):
        raw[int(node.get("id"))] = (float(node.get("lat")), float(node.get("lon")))
    lats = [v[0] for v in raw.values()]
    lons = [v[1] for v in raw.values()]
    min_lat, min_lon = min(lats), min(lons)
    nodes = {
        nid: (
            (lat - min_lat) * scale + width * 1.2,
            (lon - min_lon) * scale + width * 1.2,
        )
        for nid, (lat, lon) in raw.items()
    }

    # Ways tagged with 'lanes' are lanelets; the tag value is the lanelet ID.
    ways_by_id = {}
    for way in root.findall("way"):
        tag = way.find("tag[@k='lanes']")
        if tag is None:
            continue
        lanes_id = int(tag.get("v"))
        node_refs = [int(nd.get("ref")) for nd in way.findall("nd")]
        ways_by_id[lanes_id] = node_refs

    max_id = max(ways_by_id)
    lanelets = []
    for lid in range(1, max_id + 1):
        node_refs = ways_by_id[lid]
        center = np.array([nodes[n] for n in node_refs], dtype=np.float32)
        left, right = _boundaries_from_center(center, width)
        lanelets.append(
            Lanelet(
                lanelet_id=lid,
                left_boundary=left,
                right_boundary=right,
                center_line=center,
            )
        )

    reference_paths = []
    for seq in ref_ids:
        is_loop = len(seq) > 1 and seq[0] == seq[-1]
        pts = []
        for k, sid in enumerate(seq):
            cl = lanelets[int(sid) - 1].center_line
            pts.extend(cl[1:] if k > 0 else cl)
        if is_loop and pts:
            pts.pop()
        center = np.stack(pts, axis=0)
        yaw, vec_norm, mean_len = polyline_yaw_and_vecs(center)
        left, right = _boundaries_from_center(center, width)
        reference_paths.append(
            RefPath(
                lanelet_ids=[int(s) - 1 for s in seq],  # 0-based (OSM convention)
                center_line=center,
                center_line_yaw=yaw,
                center_line_vec_normalized=vec_norm,
                center_line_vec_mean_length=mean_len,
                left_boundary=left,
                right_boundary=right,
                left_boundary_shared=left,
                right_boundary_shared=right,
                is_loop=is_loop,
            )
        )

    neighboring_idx = []
    if neighboring:
        max_k = max(int(k) for k in neighboring)
        neighboring_idx = [
            [int(n) - 1 for n in neighboring[str(i + 1)]] for i in range(max_k)
        ]

    all_pts = np.concatenate(
        [p.center_line for p in reference_paths]
        + [p.left_boundary for p in reference_paths]
        + [p.right_boundary for p in reference_paths],
        axis=0,
    )
    bounds = {
        "min_x": float(all_pts[:, 0].min()),
        "max_x": float(all_pts[:, 0].max()),
        "min_y": float(all_pts[:, 1].min()),
        "max_y": float(all_pts[:, 1].max()),
    }
    bounds["world_x_dim"] = bounds["max_x"] + bounds["min_x"]
    bounds["world_y_dim"] = bounds["max_y"] + bounds["min_y"]

    return MapData(
        scenario_type=scenario_type,
        lanelets=lanelets,
        reference_paths=reference_paths,
        neighboring_lanelets_idx=neighboring_idx,
        bounds=bounds,
    )
