"""Deterministic uniform-grid spatial hash (sort-based counting sort).

Counterpart of ``cuda_knearests_tpu/ops/gridhash.py:38-134``.  One stable
sort of the points by linear cell id gives the CSR layout: sorted points,
the sorted-position -> original-index permutation, and per-cell segment
starts and counts.  Cell coordinates are computed exactly as the reference
package computes them (float32 scale by ``dim/domain`` rounded to float32,
truncation to int32, clamp), so both packages put every point in the same
cell and produce identical arrays.  Linearisation is x fastest, z slowest.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import DEFAULT_CELL_DENSITY, DOMAIN_SIZE, grid_dim_for


@dataclasses.dataclass(frozen=True)
class GridHash:
    """CSR grid layout.

    Attributes:
      points: (n, 3) f32 -- points reordered by cell.
      permutation: (n,) i32 -- sorted position -> original index.
      cell_starts: (dim^3,) i32 -- CSR segment start per cell.
      cell_counts: (dim^3,) i32 -- points per cell.
      dim: cells per axis (the grid is cubic).
      domain: side length of the point domain.
    """

    points: torch.Tensor
    permutation: torch.Tensor
    cell_starts: torch.Tensor
    cell_counts: torch.Tensor
    dim: int
    domain: float

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])

    @property
    def device(self) -> torch.device:
        return self.points.device


def cell_coords(points: torch.Tensor, dim: int,
                domain: float = DOMAIN_SIZE) -> torch.Tensor:
    """(n, 3) int32 cell coordinates, clamped to the grid."""
    scale = torch.tensor(dim / domain, dtype=torch.float32,
                         device=points.device)
    return torch.clamp((points * scale).to(torch.int32), 0, dim - 1)


def cell_ids(points: torch.Tensor, dim: int,
             domain: float = DOMAIN_SIZE) -> torch.Tensor:
    """Linear cell id, x fastest: x + dim * (y + dim * z)."""
    c = cell_coords(points, dim, domain)
    return c[:, 0] + dim * (c[:, 1] + dim * c[:, 2])


def build_grid(points: torch.Tensor, dim: int | None = None,
               density: float = DEFAULT_CELL_DENSITY,
               domain: float = DOMAIN_SIZE) -> GridHash:
    """Build the spatial hash of an (n, 3) float32 tensor on its device."""
    n = int(points.shape[0])
    if dim is None:
        dim = grid_dim_for(n, density)
    dim = int(dim)
    points = points.to(torch.float32)
    cids = cell_ids(points, dim, domain)
    order = torch.sort(cids, stable=True).indices
    counts = torch.bincount(cids, minlength=dim ** 3).to(torch.int32)
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    return GridHash(points=points[order], permutation=order.to(torch.int32),
                    cell_starts=starts, cell_counts=counts, dim=dim,
                    domain=float(domain))
