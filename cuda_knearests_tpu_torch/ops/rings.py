"""Ring occupancy of supercell dilations (host numpy).

Counterpart of ``cuda_knearests_tpu/ops/rings.py:108-171``: a 3-D summed-
area table over the per-cell counts answers, per supercell and per dilation
radius r, how many points (and how many in-grid cells) the r-dilated box
holds -- the signal the adaptive planner turns into per-supercell radii.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def summed_area_table(counts3: np.ndarray) -> np.ndarray:
    """(dz+1, dy+1, dx+1) int64 inclusive 3-D prefix sums of per-cell
    counts (int64: the sums reach the total point count)."""
    dz, dy, dx = counts3.shape
    sat = np.zeros((dz + 1, dy + 1, dx + 1), dtype=np.int64)
    sat[1:, 1:, 1:] = counts3.cumsum(0).cumsum(1).cumsum(2)
    return sat


def box_sums(counts3: np.ndarray, lo: np.ndarray, hi: np.ndarray,
             sat: np.ndarray | None = None) -> np.ndarray:
    """Sum of per-cell counts over boxes [lo, hi); counts3 is indexed
    [z, y, x], lo/hi are (m, 3) as (x, y, z)."""
    dz, dy, dx = counts3.shape
    if sat is None:
        sat = summed_area_table(counts3)
    dims = np.array([dx, dy, dz])
    lo = np.clip(lo, 0, dims)
    hi = np.clip(hi, 0, dims)
    x0, y0, z0 = lo[:, 0], lo[:, 1], lo[:, 2]
    x1, y1, z1 = hi[:, 0], hi[:, 1], hi[:, 2]
    return (sat[z1, y1, x1] - sat[z0, y1, x1] - sat[z1, y0, x1]
            - sat[z1, y1, x0] + sat[z0, y0, x1] + sat[z0, y1, x0]
            + sat[z1, y0, x0] - sat[z0, y0, x0])


def ring_occupancy(counts3: np.ndarray, sc_coords: np.ndarray,
                   supercell: int, rmax: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-supercell cumulative point and cell counts of the dilations
    r = 0..rmax.  Returns (points_cum, cells_cum), both (num_sc, rmax+1)
    int64; column r covers [sc*s - r, sc*s + s + r) clamped to the grid."""
    dim = counts3.shape[0]
    num_sc = sc_coords.shape[0]
    pts = np.empty((num_sc, rmax + 1), np.int64)
    cells = np.empty((num_sc, rmax + 1), np.int64)
    base_lo = sc_coords * supercell
    base_hi = base_lo + supercell
    sat = summed_area_table(counts3)
    for r in range(rmax + 1):
        lo = np.clip(base_lo - r, 0, dim)
        hi = np.clip(base_hi + r, 0, dim)
        pts[:, r] = box_sums(counts3, lo, hi, sat=sat)
        cells[:, r] = np.prod(hi - lo, axis=1)
    return pts, cells
