"""Point-cloud input: the validating front door, ``.xyz`` loading,
normalisation into the engine domain, and the synthetic generators.

Counterpart of ``cuda_knearests_tpu/io.py``.  The generators are byte-for-
byte copies (same numpy recipe, same seeds, same output), so a dataset named
by its generator and seed is the same cloud in both packages.  The serving
daemon's request front door (:func:`validate_request`) lives here too.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .config import DOMAIN_SIZE
from .utils.memory import (CorruptInputError, DegenerateExtentError,
                           DomainBoundsError, InvalidConfigError,
                           InvalidKError, InvalidRequestError,
                           InvalidShapeError, NonFiniteInputError,
                           OverQuotaError, UnknownTenantError)

# The checkout's data directory (the reference's named datasets).
DATA_DIR = Path(__file__).resolve().parents[1] / "data"


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


# Legal operation kinds of the serving request stream.  'fof' answers
# friends-of-friends labels of the current mutated cloud; its payload is
# the linking length.
REQUEST_KINDS = ("query", "insert", "delete", "fof")


def validate_request(kind: str, payload, *, k=None, k_max: Optional[int] = None,
                     n_current: Optional[int] = None,
                     max_batch: Optional[int] = None,
                     domain: float = DOMAIN_SIZE,
                     tenant: Optional[str] = None,
                     tenants: Optional[Tuple[str, ...]] = None,
                     quota_ok: Optional[bool] = None):
    """The request-stream front door, enforced by the serving daemon at
    admission, so a malformed request is refused with the typed
    ``InputContractError`` taxonomy instead of crashing the batch it would
    have ridden.

    Legal requests:
      * ``('query', (m, 3) coords)``: the points contract of
        :func:`validate_or_raise` against the prepared domain, ``k`` (when
        given) a positive integer <= ``k_max`` (the serving k), and
        ``m <= max_batch`` (a wider request could never flush).
      * ``('insert', (m, 3) coords)``: the same points contract.
      * ``('delete', (m,) integer ids)``: unique ids of the current mutated
        cloud, in [0, n_current).
      * ``('fof', linking_length)``: one finite positive real
        (:func:`validate_linking_length`).

    With ``tenants`` (a multi-tenant front door's registry), ``tenant``
    must name one of them (:class:`UnknownTenantError`); ``quota_ok=False``
    (the admission controller's verdict) refuses with
    :class:`OverQuotaError`.

    Raises InvalidRequestError, UnknownTenantError, OverQuotaError,
    InvalidKError, InvalidConfigError (a bad linking length) or the points
    contract's errors.  Returns the validated payload: float32 (m, 3) for
    query and insert, the integer id array for delete, a float for fof."""
    if tenants is not None and tenant not in tenants:
        raise UnknownTenantError(
            f"unknown tenant {tenant!r}: this front door serves "
            f"{tuple(tenants)} (request contract; the tenant field is "
            f"mandatory on fleet wires)")
    if quota_ok is False:
        raise OverQuotaError(
            f"tenant {tenant!r} is over quota: the token-bucket admission "
            f"rate for this tenant is exhausted -- retry after backoff "
            f"(request contract)")
    if kind not in REQUEST_KINDS:
        raise InvalidRequestError(
            f"unknown request kind {kind!r}: expected one of "
            f"{REQUEST_KINDS} (request contract)")
    if kind == "fof":
        return validate_linking_length(payload)
    if kind in ("query", "insert"):
        what = "request queries" if kind == "query" else "request inserts"
        out = validate_or_raise(payload, k=k if kind == "query" else None,
                                domain=domain, what=what)
        if kind == "query" and k is not None and k_max is not None \
                and int(k) > int(k_max):
            who = f"tenant {tenant!r}'s" if tenant is not None else "the"
            raise InvalidKError(
                f"request k={int(k)} exceeds {who} serving k={int(k_max)} "
                f"(request contract)")
        if max_batch is not None and out.shape[0] > int(max_batch):
            raise InvalidRequestError(
                f"{what} carry {out.shape[0]} rows but the daemon's largest "
                f"capacity bucket is max_batch={int(max_batch)}; split the "
                f"request (request contract)")
        return out
    try:
        ids = np.asarray(payload)
    except (TypeError, ValueError) as e:
        raise InvalidRequestError(
            f"delete ids are not an array: {e} (request contract)") from e
    if ids.ndim != 1 or not np.issubdtype(ids.dtype, np.integer):
        raise InvalidRequestError(
            f"delete ids must be a 1-d integer array, got shape "
            f"{ids.shape} dtype {ids.dtype} (request contract)")
    if ids.size and np.unique(ids).size != ids.size:
        raise InvalidRequestError(
            "delete ids contain duplicates (request contract: each id "
            "deletes one point of the current cloud)")
    if n_current is not None and ids.size:
        lo, hi = int(ids.min()), int(ids.max())
        if lo < 0 or hi >= int(n_current):
            raise InvalidRequestError(
                f"delete ids span [{lo}, {hi}] but the current cloud has "
                f"{int(n_current)} points (request contract: ids index the "
                f"mutated cloud at admission time)")
    return ids


def validate_points(points: np.ndarray,
                    domain: float = DOMAIN_SIZE) -> np.ndarray:
    """The points half of :func:`validate_or_raise` under the reference's
    older name."""
    return validate_or_raise(points, domain=domain)


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


# The reference's named datasets, by the generator and seed each was made
# with.
_GENERATORS = {
    "pts20K.xyz": lambda: generate_uniform(20626, seed=20),
    "pts300K.xyz": lambda: generate_uniform(300_000, seed=300),
    "300k_blue_cube.xyz": lambda: generate_blue_noise(300_000, seed=301),
    "900k_blue_cube.xyz": lambda: generate_blue_noise(900_000, seed=900),
}


def get_dataset(name: str, data_dir=DATA_DIR) -> np.ndarray:
    """A named dataset, normalized into the engine domain: the ``.xyz``
    file in ``data_dir`` (the checkout's ``data/``) when it is there, else
    regenerated from the reference's generator for the name.  Nothing is
    downloaded or written."""
    path = os.path.join(data_dir, name)
    if os.path.exists(path):
        return normalize_points(load_xyz(path))
    if name not in _GENERATORS:
        raise FileNotFoundError(f"unknown dataset {name!r}")
    return normalize_points(_GENERATORS[name]())
