"""Map manager: resolves a scenario type to parsed `MapData`.

The port parses the map files shipped in `maps/assets/` on every load (a
tenth of a second for the CPM-lab XML, less for an OSM map); it keeps no
compiled cache, so `load_map` is `parse_map`. "cpm*" scenarios use the CPM
XML parser, every other scenario of `maps/scenarios.json` the OSM parser.
`MapManager` is the object form of `load_map`.
"""

from __future__ import annotations

import os

import torch

from benchmark.reference.constants import SCENARIOS
from benchmark.reference.device import resolve_device
from benchmark.reference.maps.data import MapData

from benchmark.reference.constants import _HERE as _DATA

_ASSETS = os.path.join(_DATA, "maps", "assets")


def parse_map(scenario_type: str, lane_width: float | None = None) -> MapData:
    """Parse a scenario's map from the file shipped with the package.
    `lane_width` overrides the scenario's own (OSM maps only, as in the
    JAX package)."""
    if scenario_type not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario_type!r}; known: {sorted(SCENARIOS)}")
    map_file = os.path.join(_ASSETS, SCENARIOS[scenario_type]["map_path"])
    if "cpm" in scenario_type:
        from benchmark.reference.maps.parse_xml import parse_cpm_xml

        return parse_cpm_xml(scenario_type, map_file)
    raise NotImplementedError("the benchmark's reference parses the CPM-lab maps only")


def load_map(scenario_type: str, lane_width: float | None = None) -> MapData:
    """A scenario's map: `parse_map` (no cache to prefer)."""
    return parse_map(scenario_type, lane_width=lane_width)


class MapManager:
    """A scenario's map (`load_map`) and the device its tables go to:
    `device` as the port's entry points take it (`cuda` unless the caller
    asks for another; without a card only `device="cpu"` works)."""

    def __init__(self, scenario_type: str = "cpm_entire", device: str | torch.device | None = None,
                 lane_width: float | None = None):
        self._scenario_type = scenario_type
        self.device = resolve_device(device)
        self.map_data = load_map(scenario_type, lane_width=lane_width)

    @property
    def parser(self) -> MapData:
        return self.map_data
