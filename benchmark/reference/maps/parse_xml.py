"""CPM-lab map parser (CommonRoad-style XML), host-side numpy.

Behavioral parity with the reference `sigmarl/parse_xml.py`: lanelet
boundaries come from the XML; the center line is the boundary mean; the 40
loop reference paths, 24 intersection paths, and 4+4 merge-in/out paths are
assembled from the CPM topology tables (`cpm_topology.json`, a data file
holding the loop/shared-boundary ID lists from `parse_xml.py:34-567`),
with duplicate-point removal at lanelet connections, smooth interpolation
where shared boundaries jump, and loop-closure smoothing
(`parse_xml.py:605-908`).
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np

from benchmark.reference.constants import SCENARIOS
from benchmark.reference.maps.data import Lanelet, MapData, RefPath, polyline_yaw_and_vecs

from benchmark.reference.constants import _HERE as _DATA

_HERE = os.path.join(_DATA, "maps")

with open(os.path.join(_HERE, "cpm_topology.json")) as _f:
    CPM_TOPOLOGY = json.load(_f)


def _smooth_concatenate(a: np.ndarray, b: np.ndarray, overlap: int = 4) -> np.ndarray:
    """Join two polylines with a linear blend over `overlap` points each side
    (reference `parse_xml.py:831-871`)."""
    start_point = a[-overlap]
    end_point = b[overlap - 1]
    t = np.linspace(0.0, 1.0, 2 * overlap, dtype=a.dtype)[:, None]
    interp = (1 - t) * start_point + t * end_point
    return np.concatenate([a[:-overlap], interp, b[overlap:]], axis=0)


def _smooth_loop_boundary(boundary: np.ndarray, overlap: int = 4) -> np.ndarray:
    """Blend the two ends of a loop boundary and close it
    (reference `parse_xml.py:873-908`)."""
    start_point = boundary[-overlap]
    end_point = boundary[overlap - 1]
    t = np.linspace(0.0, 1.0, 2 * overlap, dtype=boundary.dtype)[:, None]
    interp = (1 - t) * start_point + t * end_point
    out = boundary.copy()
    out[:overlap] = interp[overlap:]
    out[-overlap:] = interp[:overlap]
    return np.concatenate([out, out[:1]], axis=0)


def _parse_lanelets(xml_path: str) -> List[Lanelet]:
    tree = ET.parse(xml_path)
    root = tree.getroot()
    lanelets = []
    for child in root:
        if child.tag != "lanelet":
            continue
        lid = int(child.get("id"))
        bounds = {}
        markings = {}
        preds, succs = [], []
        for el in child:
            if el.tag in ("leftBound", "rightBound"):
                pts = np.array(
                    [
                        [float(p.find("x").text), float(p.find("y").text)]
                        for p in el.findall("point")
                    ],
                    dtype=np.float32,
                )
                bounds[el.tag] = pts
                lm = el.find("lineMarking")
                markings[el.tag] = lm.text if lm is not None else None
            elif el.tag == "predecessor":
                preds.append(int(el.get("ref")))
            elif el.tag == "successor":
                succs.append(int(el.get("ref")))
        lanelets.append(
            Lanelet(
                lanelet_id=lid,
                left_boundary=bounds["leftBound"],
                right_boundary=bounds["rightBound"],
                center_line=(bounds["leftBound"] + bounds["rightBound"]) / 2,
                left_line_marking=markings.get("leftBound"),
                right_line_marking=markings.get("rightBound"),
                predecessors=preds,
                successors=succs,
            )
        )
    lanelets.sort(key=lambda l: l.lanelet_id)
    return lanelets


def _build_ref_path(
    lanelet_ids: List[int],
    lanelets_by_id: Dict[int, Lanelet],
    share_groups: List[List[int]],
) -> RefPath:
    """Assemble one reference path from a lanelet-ID sequence
    (reference `parse_xml.py:605-797`)."""

    def shared_group(lid):
        for g in share_groups:
            if lid in g:
                return g
        raise ValueError(f"lanelet {lid} not in any shared-boundary group")

    left = right = left_sh = right_sh = None
    for lid in lanelet_ids:
        lane = lanelets_by_id[lid]
        group = shared_group(lid)
        lb, rb = lane.left_boundary, lane.right_boundary
        lb_sh = lanelets_by_id[group[0]].left_boundary
        rb_sh = lanelets_by_id[group[-1]].right_boundary
        if left is None:
            left, right, left_sh, right_sh = lb, rb, lb_sh, rb_sh
            continue
        # Drop the duplicated connection point when segments meet exactly;
        # blend-connect shared boundaries when they jump (merge areas).
        if np.linalg.norm(left[-1] - lb[0]) < 1e-4:
            left = np.concatenate([left, lb[1:]], axis=0)
        else:
            left = np.concatenate([left, lb], axis=0)
        if np.linalg.norm(left_sh[-1] - lb_sh[0]) < 1e-4:
            left_sh = np.concatenate([left_sh, lb_sh[1:]], axis=0)
        else:
            left_sh = _smooth_concatenate(left_sh, lb_sh, overlap=4)
        if np.linalg.norm(right[-1] - rb[0]) < 1e-4:
            right = np.concatenate([right, rb[1:]], axis=0)
        else:
            right = np.concatenate([right, rb], axis=0)
        if np.linalg.norm(right_sh[-1] - rb_sh[0]) < 1e-4:
            right_sh = np.concatenate([right_sh, rb_sh[1:]], axis=0)
        else:
            right_sh = _smooth_concatenate(right_sh, rb_sh, overlap=4)

    center = (left + right) / 2
    yaw, vec_norm, mean_len = polyline_yaw_and_vecs(center)
    is_loop = bool(np.linalg.norm(center[0] - center[-1]) <= 1e-4)
    if is_loop:
        if np.linalg.norm(left_sh[0] - left_sh[-1]) > 0.1:
            left_sh = _smooth_loop_boundary(left_sh)
        if np.linalg.norm(right_sh[0] - right_sh[-1]) > 0.1:
            right_sh = _smooth_loop_boundary(right_sh)

    return RefPath(
        lanelet_ids=list(lanelet_ids),
        center_line=center,
        center_line_yaw=yaw,
        center_line_vec_normalized=vec_norm,
        center_line_vec_mean_length=mean_len,
        left_boundary=left,
        right_boundary=right,
        left_boundary_shared=left_sh,
        right_boundary_shared=right_sh,
        is_loop=is_loop,
    )


def parse_cpm_xml(scenario_type: str, xml_path: str) -> MapData:
    """Parse the CPM-lab map and build all reference-path families."""
    topo = CPM_TOPOLOGY
    lanelets = _parse_lanelets(xml_path)
    by_id = {l.lanelet_id: l for l in lanelets}
    share_groups = topo["lanelets_share_same_boundaries_list"]

    # 40 loop paths: each entry of path_to_loop is (loop_index, starting_lanelet);
    # rotate the loop's lanelet sequence to start at starting_lanelet.
    loops = topo["reference_paths_ids"]
    reference_paths = []
    for path_id in sorted(topo["path_to_loop"], key=int):
        loop_index, start_lanelet = topo["path_to_loop"][path_id]
        seq = loops[loop_index - 1]
        k = seq.index(start_lanelet)
        reference_paths.append(_build_ref_path(seq[k:] + seq[:k], by_id, share_groups))

    def build_all(seqs):
        return [_build_ref_path(seq, by_id, share_groups) for seq in seqs]

    scen = SCENARIOS[scenario_type]
    bounds = {
        "min_x": scen["x_dim_min"],
        "max_x": scen["x_dim_max"],
        "min_y": scen["y_dim_min"],
        "max_y": scen["y_dim_max"],
        "world_x_dim": scen["x_dim_min"] + scen["x_dim_max"],
        "world_y_dim": scen["y_dim_min"] + scen["y_dim_max"],
    }

    return MapData(
        scenario_type=scenario_type,
        lanelets=lanelets,
        reference_paths=reference_paths,
        reference_paths_intersection=build_all(topo["path_intersection"]),
        reference_paths_merge_in=build_all(topo["path_merge_in"]),
        reference_paths_merge_out=build_all(topo["path_merge_out"]),
        neighboring_lanelets_idx=[],
        bounds=bounds,
    )
