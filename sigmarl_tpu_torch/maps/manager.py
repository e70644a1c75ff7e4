"""Map manager: resolves a scenario type to parsed `MapData`.

The port parses the CPM-lab XML shipped in `maps/assets/` on every load
(about a tenth of a second); it keeps no compiled cache. Only the CPM
scenarios are registered in the port's `maps/scenarios.json`.
"""

from __future__ import annotations

import os

from sigmarl_tpu_torch.constants import SCENARIOS
from sigmarl_tpu_torch.maps.data import MapData

_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def load_map(scenario_type: str) -> MapData:
    """Parse a scenario's map from the XML shipped with the package."""
    if scenario_type not in SCENARIOS:
        raise NotImplementedError(
            f"scenario {scenario_type!r} is not ported; the port loads "
            f"{sorted(SCENARIOS)}"
        )
    from sigmarl_tpu_torch.maps.parse_xml import parse_cpm_xml

    map_file = os.path.join(_ASSETS, SCENARIOS[scenario_type]["map_path"])
    return parse_cpm_xml(scenario_type, map_file)
