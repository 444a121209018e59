"""Chebyshev ring schedule and ring occupancy of supercell dilations (host
numpy).

Counterpart of ``cuda_knearests_tpu/ops/rings.py``: :func:`ring_schedule`
lists the cell offsets of rings 0..nmax-1 around a cell in ring order
(friends-of-friends walks rings 0..1, the 27-cell block), and a 3-D
summed-area table over the per-cell counts answers, per supercell and per
dilation radius r, how many points (and how many in-grid cells) the
r-dilated box holds -- the signal the adaptive planner turns into
per-supercell radii.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class RingSchedule(NamedTuple):
    """Cell offsets of rings 0..nmax-1.

    offsets:    (m, 3) int32 -- (di, dj, dk) per cell, ring-major order.
    ring_of:    (m,) int32   -- Chebyshev ring of each offset.
    ring_start: (nmax+1,) int32 -- ring r's offsets are
                [ring_start[r], ring_start[r+1]).
    """

    offsets: np.ndarray
    ring_of: np.ndarray
    ring_start: np.ndarray

    @property
    def nmax(self) -> int:
        return len(self.ring_start) - 1


def ring_schedule(nmax: int) -> RingSchedule:
    """All (2*nmax-1)^3 cell offsets around a centre cell, ordered by ring
    (ring r is the shell ``max(|di|, |dj|, |dk|) == r``), lexicographic
    within a ring."""
    if nmax < 1:
        raise ValueError("nmax must be >= 1")
    r = np.arange(-(nmax - 1), nmax, dtype=np.int32)
    di, dj, dk = np.meshgrid(r, r, r, indexing="ij")
    offs = np.stack([di.ravel(), dj.ravel(), dk.ravel()], axis=1)
    ring = np.abs(offs).max(axis=1).astype(np.int32)
    # a stable sort by ring keeps the lexicographic order within a shell
    order = np.argsort(ring, kind="stable")
    offs, ring = offs[order], ring[order]
    ring_start = np.searchsorted(ring, np.arange(nmax + 1),
                                 side="left").astype(np.int32)
    return RingSchedule(offsets=np.ascontiguousarray(offs),
                        ring_of=np.ascontiguousarray(ring),
                        ring_start=ring_start)


def summed_area_table(counts3: np.ndarray) -> np.ndarray:
    """(dz+1, dy+1, dx+1) int64 inclusive 3-D prefix sums of per-cell
    counts (int64: the sums reach the total point count)."""
    dz, dy, dx = counts3.shape
    sat = np.zeros((dz + 1, dy + 1, dx + 1), dtype=np.int64)  # kntpu-ok: wide-dtype -- population prefix sums (see above)
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
    pts = np.empty((num_sc, rmax + 1), np.int64)  # kntpu-ok: wide-dtype -- population sums (see above)
    cells = np.empty((num_sc, rmax + 1), np.int64)  # kntpu-ok: wide-dtype -- population sums (see above)
    base_lo = sc_coords * supercell
    base_hi = base_lo + supercell
    sat = summed_area_table(counts3)
    for r in range(rmax + 1):
        lo = np.clip(base_lo - r, 0, dim)
        hi = np.clip(base_hi + r, 0, dim)
        pts[:, r] = box_sums(counts3, lo, hi, sat=sat)
        cells[:, r] = np.prod(hi - lo, axis=1)
    return pts, cells
