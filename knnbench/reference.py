"""The plain reference: exact k nearest neighbours of chosen points of a
cloud, by brute force in plain PyTorch.  It imports nothing of the port.

The configuration states float32 coordinates and the 'diff' distance:
``d2 = (dx*dx + dy*dy) + dz*dz`` with ``dx = p_x - q_x``, every operation
rounded to float32 on its own (IEEE round-to-nearest, no fused
multiply-add: each eager torch operation below is its own rounded kernel).
That is the arithmetic the configuration promises, so the exact answer's
distances are determined bit for bit, and a point never counts as its own
neighbour (``exclude_self``: by index; a duplicate of its coordinates
does).  ``dtype=torch.bfloat16`` computes the same in bfloat16: the
control, the nearest precision below the stated one.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: (query, point) pairs one block holds: two float32 matrices of this
#: many entries, 2 GiB each.
PAIR_BLOCK = 1 << 29


def _pair_matrix(points: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(b, n) distances of b query coordinates to every point, in the
    points' dtype, summed in the stated order."""
    acc = points[:, 0][None, :] - q[:, 0][:, None]
    acc.mul_(acc)
    for axis in (1, 2):
        t = points[:, axis][None, :] - q[:, axis][:, None]
        t.mul_(t)
        acc.add_(t)
    return acc


def knn_rows(points: torch.Tensor, q_idx: torch.Tensor, k: int,
             dtype: torch.dtype = torch.float32,
             pair_block: int = PAIR_BLOCK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of the points ``q_idx`` (original indices, int64) among
    ``points`` ((n, 3) float32), the query itself excluded.  Returns
    ((m, k) squared distances as float32, ascending, inf where fewer than
    k neighbours exist; (m, k) int64 neighbour indices, -1 there).  Ties
    at equal distance may come in any order."""
    n = int(points.shape[0])
    m = int(q_idx.shape[0])
    dev = points.device
    pts = points.to(dtype)
    kk = max(0, min(k, n - 1))
    out_d = torch.full((m, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((m, k), -1, dtype=torch.int64, device=dev)
    if kk == 0 or m == 0:
        return out_d, out_i
    step = max(1, pair_block // max(n, 1))
    for r0 in range(0, m, step):
        qi = q_idx[r0:r0 + step]
        d2 = _pair_matrix(pts, pts[qi])
        d2[torch.arange(qi.shape[0], device=dev), qi] = float("inf")
        vals, ids = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
        out_d[r0:r0 + step, :kk] = vals.float()
        out_i[r0:r0 + step, :kk] = ids
        del d2
    return out_d, out_i


def pair_d2(points: torch.Tensor, q_idx: torch.Tensor,
            ids: torch.Tensor) -> torch.Tensor:
    """(m, k) float32 squared distances from each point ``q_idx[i]`` to
    ``ids[i, j]`` in the stated arithmetic; inf where ``ids`` is
    negative."""
    ok = ids >= 0
    p = points[torch.where(ok, ids, 0)]
    q = points[q_idx][:, None, :]
    acc = p[..., 0] - q[..., 0]
    acc = acc * acc
    for axis in (1, 2):
        t = p[..., axis] - q[..., axis]
        acc = acc + t * t
    return torch.where(ok, acc, torch.full_like(acc, float("inf")))
