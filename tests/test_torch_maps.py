"""Port map tables vs the JAX package's `build_map_tables`."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sigmarl_tpu.constants import SCENARIOS as JAX_SCENARIOS
from sigmarl_tpu.env.map_tables import build_map_tables as jax_build
from sigmarl_tpu.maps.manager import load_map as jax_load_map
from sigmarl_tpu.maps.manager import parse_map as jax_parse_map
from sigmarl_tpu_torch.constants import SCENARIOS
from sigmarl_tpu_torch.core import geometry as G
from sigmarl_tpu_torch.env.map_tables import MapTables, build_map_tables
from sigmarl_tpu.maps.manager import MapManager as JaxMapManager
from sigmarl_tpu_torch.maps.manager import MapManager, load_map, parse_map

torch.set_num_threads(1)
OSM = sorted(s for s in JAX_SCENARIOS if "cpm" not in s)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.mark.parametrize("scenario", ["cpm_entire", "cpm_mixed", "intersection_1", "roundabout_2",
                                      "on_ramp_2_multilane"])
def test_map_tables_match_jax(scenario):
    """Every table equals the JAX one: floats to atol 2e-6, integer and
    bool tables exactly, except the spawn boundary indices, whose argmin
    may pick the other of two segments at equal distance (float32 ties)."""
    ours = build_map_tables(load_map(scenario), scenario, 3, 2)
    ref = jax_build(jax_load_map(scenario), scenario, 3, 2)
    for f in dataclasses.fields(MapTables):
        a = getattr(ours, f.name).numpy()
        b = np.asarray(getattr(ref, f.name))
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        if f.name in ("spawn_idx_left", "spawn_idx_right"):
            continue
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            np.testing.assert_allclose(a, b, atol=2e-6, rtol=0, err_msg=f.name)

    # Where the spawn boundary index differs, both indices' segments are
    # at the same distance from the spawn point (to 1e-6).
    for side in ("left", "right"):
        a = getattr(ours, f"spawn_idx_{side}")
        b = torch.from_numpy(np.array(getattr(ref, f"spawn_idx_{side}")))
        bnd = getattr(ours, f"{side}_boundary")  # [K, PB, 2]
        diff = (a != b).nonzero()
        assert diff.shape[0] <= 0.01 * a.numel()
        for k, p in diff.tolist():
            pt = ours.long_term[k, p]
            d = [
                G.min_perpendicular_distance(pt, bnd[k, int(i) - 1:int(i) + 1])
                for i in (a[k, p], b[k, p])
            ]
            assert abs(float(d[0] - d[1])) < 1e-6


def test_map_tables_move_to_device_field_by_field():
    tables = build_map_tables(load_map("cpm_mixed"), "cpm_mixed", 3, 2)
    moved = tables.to("cpu")
    for f in dataclasses.fields(MapTables):
        assert torch.equal(getattr(moved, f.name), getattr(tables, f.name))


def test_unported_scenario_raises():
    """Every scenario of the registry loads (the OSM ones too); an unknown
    name raises."""
    with pytest.raises(ValueError, match="unknown scenario"):
        load_map("intersection_99")


def test_osm_parse_matches_golden():
    """intersection_1 against the golden of the original SigmaRL parser."""
    g = np.load(os.path.join(GOLDEN, "osm_intersection_1.npz"))
    m = load_map("intersection_1")
    assert len(m.reference_paths) == 4
    for i, p in enumerate(m.reference_paths):
        np.testing.assert_allclose(p.center_line, g[f"p{i}_center"], atol=1e-4)
        np.testing.assert_allclose(p.left_boundary, g[f"p{i}_lb"], atol=1e-4)
        np.testing.assert_allclose(p.right_boundary, g[f"p{i}_rb"], atol=1e-4)
        assert bool(p.is_loop) == bool(g[f"p{i}_loop"])


def _assert_maps_equal(ours, ref, what):
    assert ours.neighboring_lanelets_idx == ref.neighboring_lanelets_idx, what
    assert ours.bounds == ref.bounds, what
    for a, b in zip(ours.lanelets + ours.reference_paths, ref.lanelets + ref.reference_paths,
                    strict=True):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f"{what} {f.name}")
            else:
                assert x == y, (what, f.name)


@pytest.mark.parametrize("lane_width", [None, 0.25])
def test_osm_parse_matches_jax(lane_width):
    """Every OSM scenario of the registry (the port's own copies of the
    files and entries) parses as the JAX package's parser parses it, with
    the scenario's lane width and with an override: every polyline, flag
    and index list equal."""
    assert set(SCENARIOS) == set(JAX_SCENARIOS)
    for scen in OSM:
        _assert_maps_equal(load_map(scen, lane_width=lane_width),
                           jax_parse_map(scen, lane_width=lane_width), scen)


@pytest.mark.parametrize("scenario", ["cpm_entire", "roundabout_1"])
def test_parse_map_and_map_manager_match_jax(scenario):
    """`parse_map` (CPM XML and OSM) parses as the JAX package's does, and
    `MapManager` holds the same map as the JAX package's facade, with the
    device it was given; an unknown scenario raises."""
    _assert_maps_equal(parse_map(scenario), jax_parse_map(scenario), scenario)
    width = None if "cpm" in scenario else 0.25  # an OSM map with another lane width
    manager = MapManager(scenario, device="cpu", lane_width=width)
    ref = JaxMapManager(scenario, lane_width=width)
    assert manager.device == torch.device("cpu") and manager.parser is manager.map_data
    _assert_maps_equal(manager.parser, ref.parser, f"{scenario} manager")
    with pytest.raises(ValueError, match="unknown scenario"):
        parse_map("intersection_99")


def test_map_manager_needs_a_card_unless_asked_for_the_cpu():
    """Like the port's entry points, `MapManager` goes to `cuda` by
    default: without a card that raises rather than running on the CPU."""
    if torch.cuda.is_available():
        assert MapManager("intersection_1").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MapManager("intersection_1")
