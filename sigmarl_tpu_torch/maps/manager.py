"""Map manager: resolves a scenario type to parsed `MapData`.

The port parses the map files shipped in `maps/assets/` on every load (a
tenth of a second for the CPM-lab XML, less for an OSM map); it keeps no
compiled cache. "cpm*" scenarios use the CPM XML parser, every other
scenario of `maps/scenarios.json` the OSM parser.
"""

from __future__ import annotations

import os

from sigmarl_tpu_torch.constants import SCENARIOS
from sigmarl_tpu_torch.maps.data import MapData

_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def load_map(scenario_type: str, lane_width: float | None = None) -> MapData:
    """Parse a scenario's map from the file shipped with the package.
    `lane_width` overrides the scenario's own (OSM maps only, as in the
    JAX package)."""
    if scenario_type not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario_type!r}; known: {sorted(SCENARIOS)}")
    map_file = os.path.join(_ASSETS, SCENARIOS[scenario_type]["map_path"])
    if "cpm" in scenario_type:
        from sigmarl_tpu_torch.maps.parse_xml import parse_cpm_xml

        return parse_cpm_xml(scenario_type, map_file)
    from sigmarl_tpu_torch.maps.parse_osm import parse_osm

    return parse_osm(scenario_type, map_file, lane_width=lane_width)
