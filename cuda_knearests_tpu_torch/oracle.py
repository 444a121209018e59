"""Exact host references: the kd-tree oracle and friends-of-friends.

Counterpart of ``cuda_knearests_tpu/oracle.py``.  :class:`KdTreeOracle`
binds, with ctypes, the repository's C++ kd-tree (``oracle/kd_tree.cpp``,
built on first use with ``make -C oracle`` into ``oracle/liboracle.so``,
without OpenMP where the compiler has none); it answers
``KnnConfig(backend='oracle')`` on the host, every row exact.
Where the library cannot be built or loaded it falls back to a numpy brute
force with the same semantics, as the reference does;
:func:`native_available` says which engine answers.

The FoF half is a path-compressed union-find over exact float64
fixed-radius pairs.  The engine scores pairs in float32, so a pair whose
true distance lies within the float32 rounding band of the linking length
may legally link either way; the oracle therefore gives TWO partitions
(mandatory: pairs provably inside the radius; allowed: pairs possibly
inside), and the tie-aware check (``cluster/compare.py``) requires the
engine's partition to lie between them.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_ORACLE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "oracle")
_LIB_PATH = os.path.join(_ORACLE_DIR, "liboracle.so")
_lock = threading.Lock()
# None: not tried yet; False: tried and failed (make is not run again);
# else the loaded library.
_lib = None
# How the loaded library came to be: 'openmp' (built with the Makefile's
# flags), 'serial' (built without OpenMP) or 'found' (present before the
# first use); None before a load.
build_kind: Optional[str] = None


# The Makefile's flags less OpenMP, for a compiler that has no OpenMP
# runtime: the same tree, its queries on one thread.
_SERIAL_FLAGS = "CXXFLAGS=-O3 -march=native -fPIC -std=c++17"


def _make(*args: str) -> None:
    subprocess.run(["make", "-C", _ORACLE_DIR, "-s", *args], check=True,
                   capture_output=True)


def _load() -> Optional[ctypes.CDLL]:
    """The kd-tree library, built with ``make`` when missing (without
    OpenMP where the compiler refuses it); None where it cannot be built
    or loaded."""
    global _lib, build_kind
    with _lock:
        if _lib is not None:
            return _lib or None
        try:
            kind = "found"
            if not os.path.exists(_LIB_PATH):
                try:
                    _make()
                    kind = "openmp"
                except subprocess.CalledProcessError:
                    _make(_SERIAL_FLAGS)
                    kind = "serial"
            lib = ctypes.CDLL(_LIB_PATH)
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.kdt_build.restype = ctypes.c_void_p
            lib.kdt_build.argtypes = [f32p, ctypes.c_int64]
            lib.kdt_free.argtypes = [ctypes.c_void_p]
            lib.kdt_knn.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64,
                                    ctypes.c_int32, i32p, i32p, f32p]
            if hasattr(lib, "kdt_knn_all"):
                lib.kdt_knn_all.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                            i32p, f32p]
        except Exception:  # noqa: BLE001 -- any failure: the numpy engine
            _lib = False
            return None
        _lib, build_kind = lib, kind
        return lib


def native_available() -> bool:
    """Whether the C++ kd-tree answers (else the numpy brute force)."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class KdTreeOracle:
    """Exact kNN over a fixed (n, 3) float32 point set.  The query point
    is not excluded unless an exclude id is given."""

    def __init__(self, points: np.ndarray):
        self.points = np.ascontiguousarray(points, dtype=np.float32)
        if self.points.ndim != 2 or self.points.shape[1] != 3:
            raise ValueError("points must be (n, 3)")
        self._lib = _load()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.kdt_build(_ptr(self.points,
                                                    ctypes.c_float),
                                               self.points.shape[0])

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.kdt_free(self._handle)
            self._handle = None

    def knn(self, queries: np.ndarray, k: int,
            exclude_ids: Optional[np.ndarray] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
        """(nq, k) nearest ids and squared distances, ascending; -1/inf
        where fewer than k exist.  ``exclude_ids`` (nq,) drops one stored
        id per query (-1: none)."""
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        nq = queries.shape[0]
        if self._handle is None:
            return self._brute(queries, k, exclude_ids)
        ids = np.empty((nq, k), dtype=np.int32)
        d2 = np.empty((nq, k), dtype=np.float32)
        excl = None
        if exclude_ids is not None:
            excl = np.ascontiguousarray(exclude_ids, dtype=np.int32)
        self._lib.kdt_knn(self._handle, _ptr(queries, ctypes.c_float), nq, k,
                          None if excl is None else _ptr(excl, ctypes.c_int32),
                          _ptr(ids, ctypes.c_int32), _ptr(d2, ctypes.c_float))
        return ids, d2

    def knn_all_points(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """The all-points self-query, self excluded by index (the native
        library walks the queries in tree order)."""
        n = self.points.shape[0]
        if self._handle is not None and hasattr(self._lib, "kdt_knn_all"):
            ids = np.empty((n, k), dtype=np.int32)
            d2 = np.empty((n, k), dtype=np.float32)
            self._lib.kdt_knn_all(self._handle, k, _ptr(ids, ctypes.c_int32),
                                  _ptr(d2, ctypes.c_float))
            return ids, d2
        return self.knn(self.points, k,
                        exclude_ids=np.arange(n, dtype=np.int32))

    def _brute(self, queries, k, exclude_ids, chunk: int = 512):
        n, nq = self.points.shape[0], queries.shape[0]
        out_ids = np.full((nq, k), -1, np.int32)
        out_d2 = np.full((nq, k), np.inf, np.float32)
        for s in range(0, nq, chunk):
            e = min(s + chunk, nq)
            d2 = ((queries[s:e, None, :] - self.points[None, :, :]) ** 2
                  ).sum(-1)
            if exclude_ids is not None:
                rows = np.arange(e - s)
                ex = exclude_ids[s:e]
                ok = ex >= 0
                d2[rows[ok], ex[ok]] = np.inf
            kk = min(k, n)
            part = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
            pd = np.take_along_axis(d2, part, axis=1)
            order = np.argsort(pd, axis=1, kind="stable")
            ids = np.take_along_axis(part, order, axis=1)
            d2s = np.take_along_axis(pd, order, axis=1)
            good = np.isfinite(d2s)
            out_ids[s:e, :kk] = np.where(good, ids, -1)
            out_d2[s:e, :kk] = np.where(good, d2s, np.inf)
        return out_ids, out_d2


class UnionFind:
    """Array union-find with path compression and union by size (host)."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)  # kntpu-ok: wide-dtype -- host index arithmetic, never staged
        self.size = np.ones(n, dtype=np.int64)  # kntpu-ok: wide-dtype -- host index arithmetic, never staged

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
                            dtype=np.int64, count=n)  # kntpu-ok: wide-dtype -- host index arithmetic, never staged
        mins = np.full(n, n, dtype=np.int64)  # kntpu-ok: wide-dtype -- host index arithmetic, never staged
        np.minimum.at(mins, roots, np.arange(n))
        return mins[roots].astype(np.int32)


def _fof_thresholds(b: float, band: float):
    """(lo, hi) squared-distance thresholds around the engine's float32
    link predicate ``d2_f32 <= f32(b)^2``: below ``lo`` a pair must link,
    above ``hi`` it must not, in between it may do either.  ``band`` is
    the absolute slack in squared-distance units (0.0: the exact
    radius)."""
    b2 = float(np.float64(b) ** 2)  # kntpu-ok: wide-dtype -- exact host threshold arithmetic, never staged
    return max(b2 - band, 0.0), b2 + band


def _pairs_within(points: np.ndarray, hi: float, chunk: int = 1024):
    """All pairs (i < j) with float64 squared distance <= ``hi``: (pairs
    (E, 2) int64, d2 (E,) float64).  A chunked O(n^2) brute force -- the
    oracle is exact, not fast."""
    pts = np.asarray(points, np.float64)  # kntpu-ok: wide-dtype -- exact oracle distances, host-only, never staged
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
        return (np.empty((0, 2), np.int64), np.empty((0,), np.float64))  # kntpu-ok: wide-dtype -- exact oracle distances, host-only, never staged
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
