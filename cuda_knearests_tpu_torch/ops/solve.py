"""Supercell geometry, CSR slot packing, the certificate and the exact
brute-force fallback.

Counterpart of ``cuda_knearests_tpu/ops/solve.py``.  Queries are grouped by
supercell (a tile of s^3 grid cells); every query of a supercell shares one
candidate set, the supercell dilated by its ring radius.  A query is
certified when its k-th distance is within its margin to the dilated box,
so no un-gathered point can be nearer; uncertified rows are resolved
exactly by :func:`brute_force_by_index`, which stays plain torch as it is
plain XLA in the reference package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .topk import init_topk, merge_topk, pack_key, unpack_key

# (query row, point) pairs per chunk of the brute-force fallback.
_BRUTE_CHUNK_PAIRS = 1 << 24


@dataclasses.dataclass(frozen=True)
class KnnResult:
    """Neighbours in *sorted* point indexing, ascending by distance.

    ``certified`` marks rows proven complete by the box-margin bound;
    ``uncert_count`` is the number of rows that were not (on a finalized
    result: the rows the exact fallback had to resolve)."""

    neighbors: np.ndarray | torch.Tensor   # (n, k) i32
    dists_sq: np.ndarray | torch.Tensor    # (n, k) f32
    certified: np.ndarray | torch.Tensor   # (n,) bool
    uncert_count: Optional[np.ndarray | torch.Tensor] = None


def _boxes_grid(n_sc: int) -> np.ndarray:
    """(n_sc^3, 3) supercell integer coordinates, x fastest."""
    r = np.arange(n_sc, dtype=np.int32)
    zz, yy, xx = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)


def _box_cell_ids(sc_coords: np.ndarray, lo_off: int, hi_off: int, s: int,
                  dim: int) -> np.ndarray:
    """Linear cell ids of box [sc*s+lo_off, sc*s+s+hi_off) per supercell,
    -1 where the box leaves the grid.  Returns (num_sc, side^3) int32."""
    side = s + hi_off - lo_off
    offs = np.arange(lo_off, s + hi_off, dtype=np.int32)
    ax = sc_coords[:, :, None] * s + offs[None, None, :]
    ok = (ax >= 0) & (ax < dim)
    axc = np.clip(ax, 0, dim - 1)
    x, y, z = axc[:, 0], axc[:, 1], axc[:, 2]
    okx, oky, okz = ok[:, 0], ok[:, 1], ok[:, 2]
    lin = (x[:, None, None, :]
           + dim * y[:, None, :, None]
           + dim * dim * z[:, :, None, None])
    valid = (okx[:, None, None, :] & oky[:, None, :, None]
             & okz[:, :, None, None])
    out = np.where(valid, lin, -1).reshape(sc_coords.shape[0], side ** 3)
    return out.astype(np.int32)


def _round_up(x: int, m: int) -> int:
    return max(m, ((int(x) + m - 1) // m) * m)


def pack_cells(cells: torch.Tensor, starts: torch.Tensor,
               counts: torch.Tensor, cap: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-pack the points of ragged cell lists: (B, M) cell ids (-1 pad)
    -> (B, cap) stored-point indices, slot t holding the t-th point across
    the row's cells in order.  Returns (indices clamped to 0 where invalid,
    valid mask)."""
    valid_cell = cells >= 0
    safe = torch.where(valid_cell, cells, 0).long()
    cnt = torch.where(valid_cell, counts[safe].long(), 0)
    cum = torch.cumsum(cnt, dim=1)
    off = cum - cnt
    total = cum[:, -1]
    slots = torch.arange(cap, dtype=torch.int64, device=cells.device)
    which = torch.searchsorted(
        cum, slots.expand(cells.shape[0], cap).contiguous(), right=True)
    which = torch.clamp(which, 0, cells.shape[1] - 1)
    adj = starts[safe].long() - off
    idx = slots[None, :] + torch.gather(adj, 1, which)
    ok = slots[None, :] < total[:, None]
    return torch.where(ok, idx, 0).to(torch.int32), ok


def _margin_sq(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               domain: float) -> torch.Tensor:
    """Squared margin from each (n, 3) query to the complement of its
    dilated box [lo, hi); box sides at or beyond the domain boundary do not
    constrain.  Returns (n,)."""
    inf = torch.tensor(float("inf"), dtype=q.dtype, device=q.device)
    m_lo = torch.where(lo <= 0.0, inf, q - lo)
    m_hi = torch.where(hi >= domain, inf, hi - q)
    m = torch.clamp(torch.minimum(m_lo, m_hi).amin(dim=-1), min=0.0)
    return torch.where(torch.isinf(m), inf, m * m)


def brute_force_by_index(points: torch.Tensor, q_idx: torch.Tensor, k: int,
                         exclude_self: bool = True, tile: int = 8192
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of selected stored points against the whole set, streamed
    over point tiles.  ``q_idx`` may be padded with -1 (those rows come back
    all -1/inf).  Returns ((m, k) ids ascending, (m, k) d2) in sorted
    indexing; ties go to the lowest stored id.  Query rows run in chunks of
    at most ``_BRUTE_CHUNK_PAIRS // tile``, which bounds the (rows, tile)
    temporaries however many rows need the fallback."""
    n = int(points.shape[0])
    m = int(q_idx.shape[0])
    out_d = torch.empty((m, k), dtype=torch.float32, device=points.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=points.device)
    step = max(1, _BRUTE_CHUNK_PAIRS // tile)
    for r0 in range(0, m, step):
        qi = q_idx[r0:r0 + step]
        q_ok = qi >= 0
        q = points[torch.where(q_ok, qi, 0).long()] if n else None
        best = init_topk((qi.shape[0],), k, device=points.device)
        for t0 in range(0, n, tile):
            pts_t = points[t0:t0 + tile]
            ids_t = torch.arange(t0, t0 + pts_t.shape[0], dtype=torch.int32,
                                 device=points.device)
            d2 = None
            for ax in range(3):
                diff = q[:, None, ax] - pts_t[None, :, ax]
                d2 = diff * diff if d2 is None else d2 + diff * diff
            mask = q_ok[:, None].expand(d2.shape)
            if exclude_self:
                mask = mask & (ids_t[None, :] != qi[:, None])
            best = merge_topk(best,
                              pack_key(d2, ids_t.expand(d2.shape), mask))
        out_d[r0:r0 + step], out_i[r0:r0 + step] = unpack_key(best)
    return out_i, out_d
