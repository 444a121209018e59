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

import numpy as np
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


def cell_coords_host(points: np.ndarray, dim: int,
                     domain: float = DOMAIN_SIZE) -> np.ndarray:
    """Host numpy twin of :func:`cell_coords`: the same float32 scale,
    truncation and clamp, so queries bucket on the host into exactly the
    cells the device grid uses, with no device round trip."""
    scaled = np.asarray(points, np.float32) * np.float32(dim / domain)
    return np.clip(scaled.astype(np.int32), 0, dim - 1)


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


def delta_csr_host(points: np.ndarray, dim: int,
                   domain: float = DOMAIN_SIZE):
    """Host CSR layout of a delta point set on an existing grid's cells
    (counterpart of ``cuda_knearests_tpu/ops/gridhash.py:137``): the
    grid build's count / reserve / scatter run over the delta alone and
    held compact, segments indexed by dirty-cell position rather than cell
    id, so its cost is O(d log d) in the delta, never O(dim^3).

    Returns (order, dirty, starts, counts): ``order`` sorts the delta rows
    by cell (stable); ``dirty`` the sorted unique cell ids they occupy;
    ``order[starts[j]:starts[j] + counts[j]]`` are the rows in cell
    ``dirty[j]``."""
    coords = cell_coords_host(points, dim, domain)
    cids = coords[:, 0] + dim * (coords[:, 1] + dim * coords[:, 2])
    order = np.argsort(cids, kind="stable").astype(np.int32)
    dirty, counts = np.unique(cids, return_counts=True)
    counts = counts.astype(np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    return order, dirty.astype(np.int32), starts, counts


def cell_min_d2_host(queries: np.ndarray, cells: np.ndarray, dim: int,
                     domain: float = DOMAIN_SIZE) -> np.ndarray:
    """(m, c) lower bound on the squared distance from each query to any
    point of each cell (counterpart of ``gridhash.py:168``): the delta
    overlay's pruning bound.  Computed in float64 against the exact cell
    box [lo, hi] with the per-axis clamp max(lo - q, 0, q - hi), so it
    never exceeds a true distance; a query inside the cell gets 0."""
    w = np.float64(domain) / dim
    cx = cells % dim
    cy = (cells // dim) % dim
    cz = cells // (dim * dim)
    lo = np.stack([cx, cy, cz], axis=-1).astype(np.float64) * w
    hi = lo + w
    q = np.asarray(queries, np.float64)[:, None, :]
    d = np.maximum(np.maximum(lo[None] - q, q - hi[None]), 0.0)
    return (d * d).sum(-1)
