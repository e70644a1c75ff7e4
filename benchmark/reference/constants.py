"""Scenario registry, vehicle constants, and thresholds.

The port's own copy of the JAX package's constants: the scenario registry
is read from `maps/scenarios.json` (the CPM-lab scenarios and the OSM
maps), vehicle constants describe the CPM-lab muCar.
"""

from __future__ import annotations

import json
import math
import os

# The raw map data both sides read: the program's shipped files.
_HERE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     "sigmarl_tpu_torch")

with open(os.path.join(_HERE, "maps", "scenarios.json")) as _f:
    #: Scenario registry. Keys: scenario type (e.g. "cpm_entire",
    #: "cpm_mixed", "intersection_1"). Values include "map_path",
    #: "n_agents", "lane_width", "scale", and for OSM maps
    #: "reference_paths_ids" and "neighboring_lanelet_ids".
    SCENARIOS: dict = json.load(_f)

#: Vehicle constants of the CPM-lab muCar.
AGENTS = {
    "width": 0.107,  # [m]
    "length": 0.22,  # [m]
    "l_f": 0.075,  # [m] front wheelbase (CG -> front axle)
    "l_r": 0.075,  # [m] rear wheelbase (CG -> rear axle)
    "l_wb": 0.15,  # [m] wheelbase
    "max_speed": 1.0,  # [m/s]
    "min_speed": -0.5,  # [m/s]
    "max_steering": 31 * math.pi / 180,  # [rad]
    "min_steering": -31 * math.pi / 180,  # [rad]
    "max_acc": 5.0,  # [m/s^2]
    "min_acc": -5.0,  # [m/s^2]
    "max_steering_rate": math.pi / 2,  # [rad/s]
    "min_steering_rate": -math.pi / 2,  # [rad/s]
    "n_actions": 2,
}

#: Distance thresholds.
THRESHOLD = {
    "initial_distance": 1.2 * math.sqrt(AGENTS["width"] ** 2 + AGENTS["length"] ** 2),
    "reach_goal": AGENTS["width"],
}
