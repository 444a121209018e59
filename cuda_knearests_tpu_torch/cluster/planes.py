"""The Voronoi plane feed: per-neighbour bisector planes (host numpy).

Counterpart of ``cuda_knearests_tpu/cluster/planes.py``.  The reference
names its k ``DEFAULT_NB_PLANES`` because its neighbour tables feed a
Voronoi-cell clipping pipeline: each neighbour q of a site p contributes
the half-space of points closer to p than to q.  The feed gives that
half-space with every neighbour row:

    n = p_neighbour - p_site                 (the plane normal)
    d = (|p_neighbour|^2 - |p_site|^2) / 2   (the offset)

and the site's cell is the intersection of the half-spaces ``n . x <= d``.

Precision contract: the offset subtracts two squared norms of up to
``3 * domain^2`` that agree in nearly every bit for near neighbours, so
float32 arithmetic loses the plane to cancellation.  The feed therefore
runs in float64 numpy on the fetched host rows and rounds to float32 once;
it stays on the host because a device float64 sum would not keep numpy's
summation order, and the contract is bit identity with an independent
float64 recompute from the returned ids.  The normal is exact either way:
the float64 difference of two float32 values is exact.
"""

from __future__ import annotations

import numpy as np


def bisector_planes(sites: np.ndarray, points: np.ndarray,
                    neighbor_ids: np.ndarray) -> np.ndarray:
    """(m, k, 4) float32 plane feed ``[nx, ny, nz, d]`` of each (site,
    neighbour) pair of a kNN result.

    ``sites`` (m, 3): the query coordinates (for the all-points self-solve,
    the points themselves in original order).  ``points`` (n, 3): the
    stored cloud in original indexing.  ``neighbor_ids`` (m, k): the
    neighbour table in original indexing, ``-1`` beyond the available
    neighbours.  A slot with id < 0 gives the trivially true half-space
    ``n = 0, d = +inf``, so a consumer can intersect all k rows.
    """
    sites = np.asarray(sites, np.float32)
    ids = np.asarray(neighbor_ids)
    points = np.asarray(points, np.float32)
    m, k = ids.shape
    out = np.zeros((m, k, 4), np.float32)
    out[:, :, 3] = np.inf
    if m == 0 or k == 0 or points.shape[0] == 0:
        return out
    valid = ids >= 0
    safe = np.clip(ids, 0, points.shape[0] - 1)
    p = points[safe].astype(np.float64)  # kntpu-ok: wide-dtype -- the plane offset cancels catastrophically in f32 (module docstring); host-only, rounded to f32 once, never staged
    q = sites.astype(np.float64)[:, None, :]  # kntpu-ok: wide-dtype -- same f64 plane-feed contract as above
    normal = (p - q).astype(np.float32)
    d = (((p * p).sum(-1) - (q * q).sum(-1)) / 2.0).astype(np.float32)
    out[:, :, :3] = np.where(valid[:, :, None], normal, np.float32(0.0))
    out[:, :, 3] = np.where(valid, d, np.float32(np.inf))
    return out
