"""Point-cloud input: the validating front door, ``.xyz`` loading,
normalisation into the engine domain, and the synthetic generators.

Counterpart of ``cuda_knearests_tpu/io.py``.  The generators are byte-for-
byte copies (same numpy recipe, same seeds, same output), so a dataset named
by its generator and seed is the same cloud in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .config import DOMAIN_SIZE
from .utils.memory import (CorruptInputError, DegenerateExtentError,
                           DomainBoundsError, InvalidConfigError,
                           InvalidKError, InvalidShapeError,
                           NonFiniteInputError)


def load_xyz(path: str) -> np.ndarray:
    """Parse an .xyz file (first line the point count, then ``x y z`` per
    line) into a float32 (n, 3) array; a count mismatch raises."""
    with open(path, "r") as f:
        first = f.readline().split()
        n = int(first[0])
        data = np.loadtxt(f, dtype=np.float32)
    data = np.atleast_2d(data)[:, :3].astype(np.float32)
    if data.shape[0] != n:
        raise CorruptInputError(
            f"{path}: header says {n} points, found {data.shape[0]}")
    return np.ascontiguousarray(data)


def bbox(points: np.ndarray, pad_fraction: float = 0.001
         ) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned bounding box padded by ``pad_fraction`` of its largest
    side."""
    points = np.asarray(points)
    if points.size == 0:
        raise DegenerateExtentError(
            "cannot take a bounding box of an empty point set (input "
            "contract: normalization needs at least one point)")
    lo = points.min(axis=0).astype(np.float64)
    hi = points.max(axis=0).astype(np.float64)
    pad = float((hi - lo).max()) * pad_fraction
    return lo - pad, hi + pad


def normalize_points(points: np.ndarray,
                     domain: float = DOMAIN_SIZE) -> np.ndarray:
    """Rescale so the longest padded bbox side maps to [0, domain],
    preserving aspect; a zero-extent cloud is centred instead."""
    points = np.asarray(points, dtype=np.float32)
    lo, hi = bbox(points)
    extent = float((hi - lo).max())
    if extent <= 0.0:
        out = points.astype(np.float64) - lo + domain / 2.0
        return np.ascontiguousarray(out.astype(np.float32))
    scale = domain / extent
    out = (points.astype(np.float64) - lo) * scale
    return np.ascontiguousarray(out.astype(np.float32))


def validate_or_raise(points, k: Optional[int] = None,
                      domain: float = DOMAIN_SIZE,
                      what: str = "points",
                      dims: Optional[Tuple[int, ...]] = (3,)) -> np.ndarray:
    """The input front door of every entry point.

    Legal input: a (n, d) array of finite coordinates with d drawn from
    ``dims`` (n = 0 is legal), and ``k`` (when given) a positive integer
    (k > n is legal: rows pad -1/inf).  The default ``dims=(3,)`` is the
    grid contract: three axes, inside ``[0, domain]^3``; other widths are
    refused with a pointer at the brute route (``mxu.solve_general``).
    ``dims=None`` is the brute route's contract: any d >= 1 and no domain
    check (finiteness still holds).  Anything else raises the typed
    taxonomy of ``utils/memory.py``.  Returns the validated contiguous
    float32 array.
    """
    if k is not None:
        if isinstance(k, bool) or not isinstance(k, (int, np.integer)):
            raise InvalidKError(
                f"k must be a positive integer, got {k!r} (input contract)")
        if k < 1:
            raise InvalidKError(
                f"k must be >= 1, got {k} (input contract; note k > n is "
                f"legal: rows pad -1/inf beyond the available neighbors)")
    try:
        points = np.asarray(points, np.float32)
    except (TypeError, ValueError) as e:
        raise InvalidShapeError(
            f"{what} are not a numeric array: {e} (input contract: "
            f"(n, d) finite float coordinates)") from e
    if points.ndim != 2 or points.shape[1] < 1:
        raise InvalidShapeError(
            f"{what} must be a 2-d (n, d) array, got shape {points.shape} "
            f"(input contract)")
    if dims is not None and points.shape[1] not in dims:
        want = dims[0] if len(dims) == 1 else f"one of {dims}"
        raise InvalidShapeError(
            f"{what} are (n, {points.shape[1]}) but the grid-route input "
            f"contract is (n, {want}) -- the spatial hash linearizes "
            f"exactly that many axes; general-d point sets run on the brute "
            f"route instead (cuda_knearests_tpu_torch.mxu.knn / "
            f"mxu.solve_general)")
    if points.size:
        if not np.isfinite(points).all():
            bad = int((~np.isfinite(points)).sum())
            raise NonFiniteInputError(
                f"{what} contain {bad} NaN/inf coordinate(s); clean the "
                f"input first (input contract: finite f32)")
        lo, hi = float(points.min()), float(points.max())
        if dims is not None and (lo < 0.0 or hi > domain):
            raise DomainBoundsError(
                f"{what} span [{lo:.3g}, {hi:.3g}] but the engine domain "
                f"contract is [0, {domain:g}]^3 -- run io.normalize_points "
                f"first")
    return np.ascontiguousarray(points)


def validate_linking_length(b) -> float:
    """The linking-length front door of friends-of-friends
    (``cluster.fof_labels``): ``b`` must be a finite positive real.  A
    ``b`` wider than the domain is legal (every point joins one cluster).
    Returns ``float(b)``."""
    if isinstance(b, bool) or isinstance(b, (str, bytes)):
        # bool is an int subclass and float('12') would parse: neither is
        # ever meant as a linking length
        raise InvalidConfigError(
            f"linking length must be a positive real number, got {b!r} "
            f"(FoF input contract)")
    try:
        out = float(b)
    except (TypeError, ValueError) as e:
        raise InvalidConfigError(
            f"linking length must be a positive real number, got {b!r} "
            f"(FoF input contract)") from e
    if not np.isfinite(out) or out <= 0.0:
        raise InvalidConfigError(
            f"linking length must be finite and > 0, got {out!r} (FoF "
            f"input contract; b beyond the domain diagonal is legal: "
            f"everything joins one cluster)")
    return out


def generate_uniform(n: int, seed: int = 0,
                     domain: float = DOMAIN_SIZE) -> np.ndarray:
    """n i.i.d. uniform points in [0, domain]^3."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3), dtype=np.float64) * domain
    return pts.astype(np.float32)


def generate_clustered(n: int, seed: int = 0, domain: float = DOMAIN_SIZE,
                       blob_fraction: float = 0.6, n_blobs: int = 12,
                       sigma_fraction: float = 0.012) -> np.ndarray:
    """n points with heavy density skew: tight gaussian blobs over a
    uniform background -- the workload the adaptive class planner exists
    for."""
    rng = np.random.default_rng(seed)
    n_blob_pts = int(n * blob_fraction)
    n_bg = n - n_blob_pts
    centers = rng.uniform(0.15 * domain, 0.85 * domain, (n_blobs, 3))
    sizes = np.full(n_blobs, n_blob_pts // n_blobs, np.int64)
    sizes[: n_blob_pts - int(sizes.sum())] += 1
    blobs = [rng.normal(c, sigma_fraction * domain, (int(m), 3))
             for c, m in zip(centers, sizes)]
    bg = rng.uniform(0, domain, (n_bg, 3))
    pts = np.concatenate(blobs + [bg])
    return np.clip(pts, 0, np.nextafter(domain, 0)).astype(np.float32)


def generate_blue_noise(n: int, seed: int = 0,
                        domain: float = DOMAIN_SIZE) -> np.ndarray:
    """~n blue-noise points in [0, domain]^3 by grid-jitter stratified
    sampling: one uniformly jittered sample per cell of an m^3 grid
    (m = ceil(n^(1/3))), then a random subset of exactly n."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n ** (1.0 / 3.0)))
    cells = m * m * m
    ijk = np.stack(np.meshgrid(np.arange(m), np.arange(m), np.arange(m),
                               indexing="ij"), axis=-1)
    ijk = ijk.reshape(cells, 3).astype(np.float64)
    jitter = rng.random((cells, 3))
    pts = (ijk + jitter) * (domain / m)
    keep = rng.permutation(cells)[:n]
    keep.sort()
    return pts[keep].astype(np.float32)
