"""The adversarial generator zoo: hostile point distributions, each tagged
with the hazard it targets.

Counterpart of ``cuda_knearests_tpu/fuzz/generators.py``, the same zoo and
the same bytes.  Every case is regenerable from its :class:`CaseSpec`
(generator name, seed, n, k), so the campaign, the supervisor workers and
the banked corpus never ship point arrays around: a killed worker's case
is rebuilt in the parent from four scalars.

Generators emit raw coordinates at whatever scale exercises their hazard;
:func:`generate_case` then routes them through ``io.normalize_points``
into the engine domain -- the path real callers take -- unless the
generator is ``in_domain`` (lattice and boundary-aligned zoos build their
coordinates on the hazard, and normalization would move them off it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np

from ..config import DEFAULT_CELL_DENSITY, DOMAIN_SIZE, grid_dim_for
from ..io import normalize_points

# default palettes the campaign draws from: a small set of sizes and ks
DEFAULT_NS = (33, 96, 257)
DEFAULT_KS = (1, 4, 10)
# degenerate sizes relative to k, the tiny-n zoo's whole point
TINY_NS = lambda k: (0, 1, max(0, k - 1), k, k + 1)  # noqa: E731


@dataclasses.dataclass(frozen=True)
class CaseSpec:
    """Regenerable identity of one fuzz case."""

    generator: str
    seed: int
    n: int
    k: int

    def case_id(self) -> str:
        return f"{self.generator}-s{self.seed}-n{self.n}-k{self.k}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "CaseSpec":
        return cls(generator=str(d["generator"]), seed=int(d["seed"]),
                   n=int(d["n"]), k=int(d["k"]))


@dataclasses.dataclass(frozen=True)
class ZooEntry:
    fn: Callable[[np.random.Generator, int, int], np.ndarray]
    hazard: str
    in_domain: bool


_ZOO: Dict[str, ZooEntry] = {}


def generator(name: str, hazard: str, in_domain: bool = False):
    """Register a zoo generator: ``fn(rng, n, k) -> (n, 3) float array``."""
    def deco(fn):
        if name in _ZOO:
            raise ValueError(f"duplicate fuzz generator {name!r}")
        _ZOO[name] = ZooEntry(fn=fn, hazard=hazard, in_domain=in_domain)
        return fn
    return deco


def zoo_names() -> List[str]:
    return sorted(_ZOO)


def hazard_of(name: str) -> str:
    return _ZOO[name].hazard


def generate_case(spec: CaseSpec) -> np.ndarray:
    """The (n, 3) f32 in-domain point set of ``spec`` -- deterministic."""
    entry = _ZOO.get(spec.generator)
    if entry is None:
        raise KeyError(f"unknown fuzz generator {spec.generator!r} "
                       f"(known: {zoo_names()})")
    if spec.n == 0:
        return np.empty((0, 3), np.float32)
    rng = np.random.default_rng(
        np.random.SeedSequence([spec.seed, spec.n, spec.k]))
    pts = np.asarray(entry.fn(rng, spec.n, spec.k))
    pts = np.atleast_2d(pts)[: spec.n, :3]
    if entry.in_domain:
        return np.ascontiguousarray(pts, dtype=np.float32)
    return normalize_points(pts)


# -- the zoo ------------------------------------------------------------------

@generator("uniform", "control: the reference's own assumption (no hazard)",
           in_domain=True)
def _g_uniform(rng, n, k):
    return (rng.random((n, 3)) * DOMAIN_SIZE).astype(np.float32)


@generator("all-coincident",
           "every point identical: one occupied cell, all-zero distances, "
           "maximal exact ties, k > distinct-neighbor count", in_domain=True)
def _g_all_coincident(rng, n, k):
    p = rng.random(3) * DOMAIN_SIZE
    return np.tile(p.astype(np.float32), (n, 1))


@generator("quantized-dups",
           "coarse-lattice coordinates: heavy exact duplicates and "
           "equal-distance ties straddling cell borders", in_domain=True)
def _g_quantized(rng, n, k):
    scale = int(rng.integers(2, 8))  # tiny lattice -> many exact duplicates
    ints = rng.integers(0, scale + 1, (n, 3))
    return (ints * (DOMAIN_SIZE / scale)).astype(np.float32)


@generator("collinear",
           "all points on one line: two zero-extent dimensions after "
           "normalization, near-empty grid, dilation radii at their cap")
def _g_collinear(rng, n, k):
    t = rng.random((n, 1))
    a, b = rng.normal(size=3), rng.normal(size=3)
    return a + t * b


@generator("coplanar",
           "all points on one plane: empty z-slabs (sharded halo pressure), "
           "2-D occupancy inside a 3-D grid")
def _g_coplanar(rng, n, k):
    uv = rng.random((n, 2))
    o = rng.normal(size=3)
    e1, e2 = rng.normal(size=3), rng.normal(size=3)
    return o + uv[:, :1] * e1 + uv[:, 1:] * e2


@generator("power-law-clusters",
           "pareto-sized dense blobs over sparse background: per-class "
           "capacity skew, the adaptive planner's worst case")
def _g_power_law(rng, n, k):
    n_blobs = max(1, min(8, n // 8))
    weights = rng.pareto(0.8, n_blobs) + 1e-3
    sizes = np.maximum(1, (weights / weights.sum() * n).astype(int))
    centers = rng.random((n_blobs, 3))
    scales = 10.0 ** rng.uniform(-6, -1, n_blobs)
    parts = [c + rng.normal(size=(int(m), 3)) * s
             for c, s, m in zip(centers, scales, sizes)]
    pts = np.concatenate(parts)
    if pts.shape[0] < n:  # integer rounding under-counted: top up blob 0
        extra = centers[0] + rng.normal(size=(n - pts.shape[0], 3)) * scales[0]
        pts = np.concatenate([pts, extra])
    return pts[:n]


@generator("grid-plane-aligned",
           "coordinates exactly on cell-boundary planes: the floor/clamp "
           "edge the reference silently mis-bins (knearests.cu:26-28)",
           in_domain=True)
def _g_grid_aligned(rng, n, k):
    dim = grid_dim_for(n, DEFAULT_CELL_DENSITY)
    w = DOMAIN_SIZE / dim
    ijk = rng.integers(0, dim + 1, (n, 3))  # boundary planes incl. domain edge
    return (ijk * w).astype(np.float32)


@generator("denormal",
           "subnormal-f32 magnitudes: normalization must rescale ~1e-38 "
           "extents without underflowing to zero width")
def _g_denormal(rng, n, k):
    return (rng.random((n, 3)) * 1e-38).astype(np.float32).astype(np.float64)


@generator("huge-magnitude",
           "~1e30 coordinates: f32 overflow hazards in bbox, scale, and "
           "squared distances before normalization")
def _g_huge(rng, n, k):
    return rng.random((n, 3)) * 1e30 - 5e29


@generator("zero-extent-axis",
           "one or two constant axes: zero-width bbox axes must normalize, "
           "not divide by zero; occupancy collapses to a plane/line")
def _g_zero_extent(rng, n, k):
    pts = rng.random((n, 3))
    for ax in rng.permutation(3)[: int(rng.integers(1, 3))]:
        pts[:, ax] = pts[0, ax]
    return pts


@generator("extreme-aspect",
           "~1e12 bbox aspect ratio: the longest side sets the scale, "
           "short axes collapse to ~one cell layer")
def _g_aspect(rng, n, k):
    return rng.random((n, 3)) * np.array([1e6, 1.0, 1e-6])


@generator("tiny-n",
           "degenerate sizes n in {0, 1, k-1, k, k+1}: k > n padding "
           "(-1/inf rows), empty plans, single-point grids", in_domain=True)
def _g_tiny(rng, n, k):
    return (rng.random((n, 3)) * DOMAIN_SIZE).astype(np.float32)


def draw_cases(n_cases: int, seed: int,
               ns: Tuple[int, ...] = DEFAULT_NS,
               ks: Tuple[int, ...] = DEFAULT_KS) -> List[CaseSpec]:
    """The campaign's deterministic case list: cycles the zoo so every
    generator is covered before any repeats, drawing n/k from the bounded
    palettes (tiny-n draws its n from the degenerate set instead)."""
    rng = np.random.default_rng(seed)
    names = zoo_names()
    cases: List[CaseSpec] = []
    for i in range(n_cases):
        name = names[i % len(names)]
        k = int(rng.choice(ks))
        if name == "tiny-n":
            n = int(rng.choice(TINY_NS(k)))
        else:
            n = int(rng.choice(ns))
        cases.append(CaseSpec(generator=name, seed=seed * 100003 + i,
                              n=n, k=k))
    return cases
