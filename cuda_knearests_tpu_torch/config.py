"""Runtime configuration of the PyTorch/CUDA kNN engine.

Counterpart of ``cuda_knearests_tpu/config.py``: the same grid constants and
the fields of ``KnnConfig`` that the all-points main path reads.  Fields the
reference package has but this port does not honour yet are still accepted
at their default value, so a configuration written by the reference package
(``load_problem``) reads back; any other value raises
:class:`InvalidConfigError` at construction.  A knob is never silently
ignored.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .utils.memory import InvalidConfigError

# The reference's domain contract: all points lie in [0, 1000]^3.
DOMAIN_SIZE = 1000.0

# Average points-per-cell target used to size the grid.
DEFAULT_CELL_DENSITY = 3.1

# Default k (the reference's DEFAULT_NB_PLANES).
DEFAULT_K = 50


def grid_dim_for(n_points: int, density: float = DEFAULT_CELL_DENSITY) -> int:
    """Cells per axis for a cubic grid with ~``density`` points per cell
    (at least one cell per axis)."""
    return max(1, int(round((n_points / density) ** (1.0 / 3.0))))


def default_ring_radius(k: int, density: float = DEFAULT_CELL_DENSITY) -> int:
    """Ring radius (in cells) expected to certify most queries for a given k:
    the expected k-th neighbour radius of a uniform process with ``density``
    points per cell, plus one cell of slack."""
    r_expect = (3.0 * k / (4.0 * math.pi * density)) ** (1.0 / 3.0)
    return max(1, int(math.ceil(r_expect)) + 1)


# Reference-package fields this slice does not honour, with the one value
# each accepts (the reference's default, or the value meaning "exact grid
# route").  Anything else is refused with the reason.
_UNSUPPORTED = {
    "scorer": (("auto", "elementwise"),
               "the MXU/approximate scorer is not ported yet"),
    "recall_target": ((1.0,), "approximate search (recall_target < 1) is "
                              "not ported yet"),
    "backend": (("auto",), "only the grid engine with the CUDA kernel is "
                           "ported ('oracle' and 'xla' are not)"),
    "kernel": (("kpass", "auto"), "the blocked two-stage kernel is not "
                                  "ported yet"),
    "precision": (("auto", "f32"), "reduced-precision scoring is not "
                                   "ported yet"),
    "plane_feed": ((False,), "the Voronoi plane feed is not ported yet"),
    "adaptive": ((True,), "only the adaptive class schedule is ported"),
    "dist_method": (("diff",), "only 'diff' distance arithmetic is ported"),
}


@dataclasses.dataclass(frozen=True)
class KnnConfig:
    """Tunables of the engine.

    Attributes:
      k: neighbours per query.
      density: grid sizing target, average points per cell.
      ring_radius: candidate dilation radius in cells around each
        supercell.  None -> per-supercell radii from local ring occupancy
        (``ops.adaptive.select_radii``).
      supercell: query-tile side length in cells.
      exclude_self: drop the query point itself by storage index
        (coordinate duplicates of the query are still reported).
      fallback: 'brute' resolves uncertified rows exactly; 'none' leaves
        them best-effort.
      max_classes: cap on adaptive capacity classes (one launch each).

    The remaining fields exist so that configurations of the reference
    package read back; each accepts only the values this port honours.
    """

    k: int = DEFAULT_K
    density: float = DEFAULT_CELL_DENSITY
    ring_radius: Optional[int] = None
    supercell: int = 3
    exclude_self: bool = True
    fallback: str = "brute"
    max_classes: int = 4
    scorer: str = "auto"
    recall_target: float = 1.0
    backend: str = "auto"
    kernel: str = "kpass"
    precision: str = "auto"
    plane_feed: bool = False
    adaptive: bool = True
    dist_method: str = "diff"

    def __post_init__(self):
        for name, (allowed, why) in _UNSUPPORTED.items():
            value = getattr(self, name)
            if value not in allowed:
                raise InvalidConfigError(
                    f"{name}={value!r} is not supported by the PyTorch/CUDA "
                    f"port: {why} (accepted: {allowed})")
        if self.fallback not in ("brute", "none"):
            raise InvalidConfigError(
                f"unknown fallback {self.fallback!r}: expected 'brute' or "
                f"'none'")
        if int(self.supercell) < 1 or int(self.max_classes) < 1:
            raise InvalidConfigError(
                f"supercell and max_classes must be >= 1, got "
                f"supercell={self.supercell} max_classes={self.max_classes}")
