"""Exact host references of friends-of-friends clustering (numpy only).

Counterpart of the FoF half of ``cuda_knearests_tpu/oracle.py``: a
path-compressed union-find over exact float64 fixed-radius pairs.  The
engine scores pairs in float32, so a pair whose true distance lies within
the float32 rounding band of the linking length may legally link either
way; the oracle therefore gives TWO partitions (mandatory: pairs provably
inside the radius; allowed: pairs possibly inside), and the tie-aware
check (``cluster/compare.py``) requires the engine's partition to lie
between them.
"""

from __future__ import annotations

import numpy as np


class UnionFind:
    """Array union-find with path compression and union by size (host)."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.size = np.ones(n, dtype=np.int64)

    def find(self, i: int) -> int:
        p = self.parent
        root = i
        while p[root] != root:
            root = p[root]
        while p[i] != root:  # path compression
            p[i], i = root, p[i]
        return int(root)

    def union(self, i: int, j: int) -> None:
        ri, rj = self.find(i), self.find(j)
        if ri == rj:
            return
        if self.size[ri] < self.size[rj]:
            ri, rj = rj, ri
        self.parent[rj] = ri
        self.size[ri] += self.size[rj]

    def canonical_labels(self) -> np.ndarray:
        """(n,) int32 labels: every member carries the minimum member id
        of its component (the engine's canonical labels)."""
        n = self.parent.shape[0]
        roots = np.fromiter((self.find(i) for i in range(n)),
                            dtype=np.int64, count=n)
        mins = np.full(n, n, dtype=np.int64)
        np.minimum.at(mins, roots, np.arange(n))
        return mins[roots].astype(np.int32)


def _fof_thresholds(b: float, band: float):
    """(lo, hi) squared-distance thresholds around the engine's float32
    link predicate ``d2_f32 <= f32(b)^2``: below ``lo`` a pair must link,
    above ``hi`` it must not, in between it may do either.  ``band`` is
    the absolute slack in squared-distance units (0.0: the exact
    radius)."""
    b2 = float(np.float64(b) ** 2)
    return max(b2 - band, 0.0), b2 + band


def _pairs_within(points: np.ndarray, hi: float, chunk: int = 1024):
    """All pairs (i < j) with float64 squared distance <= ``hi``: (pairs
    (E, 2) int64, d2 (E,) float64).  A chunked O(n^2) brute force -- the
    oracle is exact, not fast."""
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    out_p, out_d = [], []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d2 = ((pts[s:e, None, :] - pts[None, :, :]) ** 2).sum(-1)
        ii, jj = np.nonzero(d2 <= hi)
        keep = (ii + s) < jj  # each pair once, no self-pairs
        out_p.append(np.stack([ii[keep] + s, jj[keep]], axis=1))
        out_d.append(d2[ii[keep], jj[keep]])
    if not out_p:
        return (np.empty((0, 2), np.int64), np.empty((0,), np.float64))
    return np.concatenate(out_p), np.concatenate(out_d)


def fof_oracle(points: np.ndarray, b: float, band: float = 0.0):
    """(mandatory_labels, allowed_labels): canonical minimum-id FoF
    labelings under the two bracketing edge sets (:func:`_fof_thresholds`).
    With ``band=0`` they coincide: the exact float64 FoF partition at
    radius b.  Any engine component lies inside one allowed component, and
    every mandatory component carries one engine label."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    uf_m, uf_a = UnionFind(n), UnionFind(n)
    if n == 0:
        return (np.empty((0,), np.int32), np.empty((0,), np.int32))
    lo, hi = _fof_thresholds(b, band)
    pairs, d2 = _pairs_within(points, hi)
    for (i, j), d in zip(pairs, d2):
        uf_a.union(int(i), int(j))
        if d <= lo:
            uf_m.union(int(i), int(j))
    return uf_m.canonical_labels(), uf_a.canonical_labels()
