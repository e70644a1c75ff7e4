"""RWTH color palette for rendering and plots: the port's own copy of the
palette (data from https://www.color-hex.com/color-palettes/?keyword=rwth),
a compact base-color table with programmatic tints.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

RGB = Tuple[float, float, float]

_BASE: Dict[str, Tuple[int, int, int]] = {
    "blue": (0, 84, 159),
    "purple": (122, 111, 172),
    "violet": (97, 33, 88),
    "bordeaux": (161, 16, 53),
    "red": (204, 7, 30),
    "orange": (246, 168, 0),
    "maygreen": (189, 205, 0),
    "green": (87, 171, 39),
    "turquoise": (0, 152, 161),
    "petrol": (0, 97, 101),
    "yellow": (255, 237, 0),
    "magenta": (227, 0, 102),
    "black": (0, 0, 0),
}


def _tint(rgb: Tuple[int, int, int], level: int) -> RGB:
    """Blend toward white: level 100 = base color, 10 = near white."""
    f = level / 100.0
    return tuple((c * f + 255 * (1 - f)) / 255 for c in rgb)  # type: ignore


class Color:
    """Attribute access like the reference: Color.blue100, Color.red50, ..."""


for _name, _rgb in _BASE.items():
    for _level in (100, 75, 50, 25, 10):
        setattr(Color, f"{_name}{_level}", _tint(_rgb, _level))

#: Default per-agent colors (used by rendering), mirroring the reference's
#: `colors` list ordering of distinct 100-level hues.
colors: List[RGB] = [
    _tint(_BASE[n], 100)
    for n in (
        "blue", "orange", "green", "red", "purple", "turquoise",
        "magenta", "maygreen", "bordeaux", "petrol", "violet", "yellow",
    )
]


def get_n_colors_cmap(n: int) -> List[RGB]:
    """N distinct colors from a matplotlib colormap (reference
    `helper_common.get_n_colors_cmap`)."""
    import matplotlib
    import numpy as np

    cmap = matplotlib.colormaps["rainbow"]
    return [tuple(cmap(i)[:3]) for i in np.linspace(0, 1, n)]
