"""The host sidecar tier: tiny and degenerate tenants off the dense ladder.

Counterpart of ``cuda_knearests_tpu/serve/fleet/sidecar.py``.  A tenant
whose cloud is under ``ServeFleetConfig.sidecar_threshold`` (or smaller
than its k) is served by this brute worker on the host, in the reference
package as here ("Hybrid KNN-Join", arXiv 1810.04758, splits work between
the accelerator and the CPU by density; the fleet splits it by tenant).
This is the fleet's own placement for such tenants, not a fallback of the
card path: a 48-point tenant would otherwise take its own prepare, its
own bucket warmups and batching latency for microscopic work.  Its
answers are synchronous at admission and it moves nothing across the
host boundary (0 ``dispatch`` fetches or stages).

Semantics follow the dense path's contracts: canonical current ids with
``np.delete`` / ``np.concatenate`` mutation indexing (the rebuild
oracle's indexing in ``serve/delta.py``), (-1, inf) padding past the
available neighbours, ascending distances with the lower id first on
ties, f32 'diff' arithmetic.  The distances are host numpy f32, exact
under the tie-aware comparison contract; bit identity to the kernels is a
dense-path promise only.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ...oracle import UnionFind


@dataclasses.dataclass
class SidecarFof:
    """FoF answer over a sidecar tenant's cloud (the daemon's shape)."""

    labels: np.ndarray
    n_clusters: int


class CpuSidecar:
    """One tiny tenant's serving state: a host point array and brute
    answers.  Not thread-safe, as the dense overlay (the fleet front door
    is single-threaded)."""

    def __init__(self, points: np.ndarray, k: int):
        self.points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        self.k_serve = int(k)
        self.queries_served = 0
        self.inserts = 0
        self.deletes = 0

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])

    def mutated_points(self) -> np.ndarray:
        """The current cloud in canonical order (the rebuild oracle's
        input): the sidecar stores exactly that order."""
        return self.points

    def insert(self, points: np.ndarray) -> None:
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        if pts.shape[0]:
            self.points = np.ascontiguousarray(
                np.concatenate([self.points, pts]))
            self.inserts += pts.shape[0]

    def delete(self, ids: np.ndarray) -> None:
        ids = np.asarray(ids).reshape(-1)
        if ids.size:
            self.points = np.ascontiguousarray(
                np.delete(self.points, ids, axis=0))
            self.deletes += ids.size

    def query(self, queries: np.ndarray, k: int) \
            -> Tuple[np.ndarray, np.ndarray]:
        """Exact brute kNN rows: (m, k) int32 ids (-1 pads) and (m, k) f32
        d2 ascending (inf pads), the lower id first on ties."""
        queries = np.asarray(queries, np.float32).reshape(-1, 3)
        m, n = queries.shape[0], self.n_points
        ids = np.full((m, k), -1, np.int32)
        d2 = np.full((m, k), np.inf, np.float32)
        self.queries_served += m
        if m == 0 or n == 0:
            return ids, d2
        diff = queries[:, None, :] - self.points[None, :, :]
        dd = (diff * diff).sum(axis=2)
        kk = min(k, n)
        # a stable sort keeps storage order within ties: the lower id
        order = np.argsort(dd, axis=1, kind="stable")[:, :kk]
        ids[:, :kk] = order.astype(np.int32)
        d2[:, :kk] = np.take_along_axis(dd, order, axis=1)
        return ids, d2

    def fof(self, b: float) -> SidecarFof:
        """Friends-of-friends labels under the engine's f32 'diff' edge
        test (d2 <= f32(b)^2), labelled by each cluster's smallest member
        id as ``cluster/fof.py`` labels them."""
        n = self.n_points
        uf = UnionFind(n)
        b2 = np.float32(b) * np.float32(b)
        for i in range(n - 1):
            diff = self.points[i + 1:] - self.points[i]
            dd = (diff * diff).sum(axis=1)
            for j in np.nonzero(dd <= b2)[0]:
                uf.union(i, i + 1 + int(j))
        labels = uf.canonical_labels()
        return SidecarFof(labels=labels,
                          n_clusters=int(np.unique(labels).size) if n else 0)

    def stats_dict(self) -> dict:
        return {"sidecar": True, "n_points": self.n_points,
                "queries_served": self.queries_served,
                "inserts": self.inserts, "deletes": self.deletes}
