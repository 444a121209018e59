"""Exact kNN of external query coordinates.

Counterpart of ``cuda_knearests_tpu/ops/query.py:149-180``
(``brute_force_by_coords``): the external-query twin of
``ops.solve.brute_force_by_index``, plain torch like it.  It resolves the
external-query rows the class route cannot certify or has no class for
(``ops.adaptive.query_adaptive``) and the brute route's uncertified rows
(``mxu/solve.py``).  The reference's legacy (non-adaptive) query route is
not ported: the port runs only the adaptive class schedule.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import solve as _solve
from .topk import init_topk, merge_topk, pack_key, translate_ids, unpack_key


def brute_force_by_coords(points: torch.Tensor, queries: torch.Tensor,
                          k: int, tile: int = 8192,
                          ids_map: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of (m, d) query coordinates against the (n, d) stored
    points for any d >= 1, streamed over point tiles with the 'diff'
    arithmetic of :func:`ops.solve.sum_sq_diff`.  Returns ((m, k) ids
    ascending, (m, k) d2); ties go to the lowest stored id, missing
    neighbours are (-1, inf).  ``ids_map`` (the grid permutation)
    translates the ids on the device before any readback.  Query rows run
    in chunks that bound the (rows, tile) temporaries, as in the index
    twin."""
    n, m = int(points.shape[0]), int(queries.shape[0])
    out_d = torch.empty((m, k), dtype=torch.float32, device=points.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=points.device)
    step = max(1, _solve._BRUTE_CHUNK_PAIRS // tile)
    for r0 in range(0, m, step):
        q = queries[r0:r0 + step]
        best = init_topk((q.shape[0],), k, device=points.device)
        for t0 in range(0, n, tile):
            pts_t = points[t0:t0 + tile]
            ids_t = torch.arange(t0, t0 + pts_t.shape[0], dtype=torch.int32,
                                 device=points.device)
            d2 = _solve.sum_sq_diff(q, pts_t)
            best = merge_topk(best, pack_key(d2, ids_t.expand(d2.shape)))
        out_d[r0:r0 + step], out_i[r0:r0 + step] = unpack_key(best)
    if ids_map is not None:
        out_i = translate_ids(out_i, ids_map)
    return out_i, out_d
