"""Runtime configuration of the PyTorch/CUDA kNN engine.

Counterpart of ``cuda_knearests_tpu/config.py``: the same grid constants,
the fields of ``KnnConfig`` that the grid route reads, and the resolution
rules of the scorer, precision and kernel knobs.  Every field of the
reference package's ``KnnConfig`` exists here.  Fields the grid route does
not honour are accepted at their default value (or at the value that
means what this port does) and any other value raises
:class:`InvalidConfigError` at construction: a knob is never silently
ignored.  The scorer knobs (``scorer``, ``recall_target``, ``precision``)
are checked where the reference checks them, when a problem is prepared
(``resolved_scorer``/``resolved_precision``).  ``load_problem`` drops the
reference's runtime knobs (the last six fields below) from a checkpoint's
configuration before it builds one, since they tune how the reference
runs on its hardware and cannot change an answer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .utils.memory import InvalidConfigError

# The reference's domain contract: all points lie in [0, 1000]^3.
DOMAIN_SIZE = 1000.0

# Average points-per-cell target used to size the grid.
DEFAULT_CELL_DENSITY = 3.1

# Default k (the reference's DEFAULT_NB_PLANES).
DEFAULT_K = 50


def grid_dim_for(n_points: int, density: float = DEFAULT_CELL_DENSITY) -> int:
    """Cells per axis for a cubic grid with ~``density`` points per cell
    (at least one cell per axis)."""
    return max(1, int(round((n_points / density) ** (1.0 / 3.0))))


def default_ring_radius(k: int, density: float = DEFAULT_CELL_DENSITY) -> int:
    """Ring radius (in cells) expected to certify most queries for a given k:
    the expected k-th neighbour radius of a uniform process with ``density``
    points per cell, plus one cell of slack."""
    r_expect = (3.0 * k / (4.0 * math.pi * density)) ** (1.0 / 3.0)
    return max(1, int(math.ceil(r_expect)) + 1)


# Reference-package fields the grid route does not honour, with the
# values each accepts (the reference's default, or the value meaning
# "exact grid route").  Anything else is refused with the reason.
_UNSUPPORTED = {
    "backend": (("auto",), "only the grid engine with the CUDA kernel is "
                           "ported ('oracle' and 'xla' are not)"),
    "kernel": (("kpass", "auto", "blocked"), "unknown kernel"),
    "plane_feed": ((False, True), "plane_feed is a bool"),
    "adaptive": ((True,), "only the adaptive class schedule is ported"),
    "dist_method": (("diff",), "only 'diff' distance arithmetic is ported"),
    # the reference's runtime knobs
    "sc_batch": ((64,), "the reference's supercells per Pallas grid step; "
                        "the CUDA kernels launch a block per supercell"),
    "interpret": ((False,), "the reference's Pallas interpret mode has no "
                            "counterpart: on the CPU the port runs its "
                            "kernels' plain versions"),
    "stream_tile": ((2048,), "the reference's streamed-route tile; the "
                             "port's streamed route sizes its own steps"),
    "hbm_budget_bytes": ((None,), "a configured memory budget is not "
                                  "honoured yet: the port plans against "
                                  "0.8 x the card's free memory"),
    "epilogue": (("auto", "scatter"), "the port's kernels scatter rows to "
                                      "their destination (mode (a)); the "
                                      "gather epilogue is not ported yet"),
    "query_chunk": ((None,), "the chunked query pipeline of the "
                             "reference's legacy query route is not "
                             "ported"),
}


@dataclasses.dataclass(frozen=True)
class KnnConfig:
    """Tunables of the engine.

    Attributes:
      k: neighbours per query.
      density: grid sizing target, average points per cell.
      ring_radius: candidate dilation radius in cells around each
        supercell.  None -> per-supercell radii from local ring occupancy
        (``ops.adaptive.select_radii``).
      supercell: query-tile side length in cells.
      exclude_self: drop the query point itself by storage index
        (coordinate duplicates of the query are still reported).
      fallback: 'brute' resolves uncertified rows exactly; 'none' leaves
        them best-effort.
      max_classes: cap on adaptive capacity classes (one launch each).
      kernel: the selection kernel of each class: 'kpass' (or 'auto') the
        one-stage supercell top-k, 'blocked' the two-stage per-block top-m
        kernel where ``blocked_topm`` finds the class eligible.  Solvers
        read ``effective_kernel()``, not this field.
      plane_feed: attach the Voronoi plane feed to every solve's result
        (``KnnResult.planes``, ``cluster.planes.bisector_planes``).
      scorer: 'elementwise' (exact diff arithmetic), 'mxu' (the grid
        MXU class scorer, ``mxu.scorer.grid_class_topk``, on every class
        ``class_eligible`` takes) or 'auto'.  Solvers read
        ``resolved_scorer()``.
      recall_target: the TPU-KNN expected-recall bound of the MXU fold in
        (0, 1]; 1.0 is exhaustive.  Uncertified rows still go to the
        exact fallback unless ``fallback='none'``.
      precision: the MXU scorer's scoring tier, 'f32', 'bf16' or 'auto'
        (f32).  Solvers read ``resolved_precision()``.

    The remaining fields exist so that configurations of the reference
    package read back; each accepts only the values this port honours.
    """

    k: int = DEFAULT_K
    density: float = DEFAULT_CELL_DENSITY
    ring_radius: Optional[int] = None
    supercell: int = 3
    exclude_self: bool = True
    fallback: str = "brute"
    max_classes: int = 4
    scorer: str = "auto"
    recall_target: float = 1.0
    backend: str = "auto"
    kernel: str = "kpass"
    precision: str = "auto"
    plane_feed: bool = False
    adaptive: bool = True
    dist_method: str = "diff"
    sc_batch: int = 64
    interpret: bool = False
    stream_tile: int = 2048
    hbm_budget_bytes: Optional[int] = None
    epilogue: str = "auto"
    query_chunk: Optional[int] = None

    def __post_init__(self):
        for name, (allowed, why) in _UNSUPPORTED.items():
            value = getattr(self, name)
            if value not in allowed:
                raise InvalidConfigError(
                    f"{name}={value!r} is not supported by the PyTorch/CUDA "
                    f"port: {why} (accepted: {allowed})")
        if self.fallback not in ("brute", "none"):
            raise InvalidConfigError(
                f"unknown fallback {self.fallback!r}: expected 'brute' or "
                f"'none'")
        if int(self.supercell) < 1 or int(self.max_classes) < 1:
            raise InvalidConfigError(
                f"supercell and max_classes must be >= 1, got "
                f"supercell={self.supercell} max_classes={self.max_classes}")

    def resolved_scorer(self) -> str:
        """:func:`resolve_scorer` of this config (ValueError on an unknown
        scorer, a recall_target outside (0, 1], or 'elementwise' below
        1.0).  The reference also requires its adaptive route for 'mxu';
        here ``adaptive``, ``dist_method`` and ``backend`` take only their
        adaptive values, so every accepted config is on it."""
        return resolve_scorer(self.scorer, self.recall_target, self.precision)

    def resolved_precision(self) -> str:
        """:func:`resolve_precision` of this config against its resolved
        scorer (ValueError on an unknown tier, or 'bf16' with the
        elementwise scorer)."""
        return resolve_precision(self.precision, self.resolved_scorer())

    def effective_kernel(self) -> str:
        """The kernel string solvers resolve from.  fallback='none' pins
        blocked/auto to 'kpass': blocked deficit rows resolve through the
        exact fallback, and without one they would lose their trailing
        entries where kpass keeps the exact row."""
        if self.fallback == "none" and self.kernel in ("blocked", "auto"):
            return "kpass"
        return self.kernel


def resolve_scorer(scorer: str, recall_target: float,
                   precision: str = "auto") -> str:
    """'auto' -> 'mxu' below a 1.0 recall target or under a reduced
    scoring precision (only the MXU engine has either), 'elementwise' at
    exactly 1.0/f32.  Explicit scorers pass through; 'elementwise' with a
    sub-1.0 target is refused (the exact path cannot honour an
    approximation budget)."""
    if scorer not in ("auto", "mxu", "elementwise"):
        raise ValueError(
            f"unknown scorer {scorer!r}: expected 'auto', 'mxu' or "
            f"'elementwise'")
    r = float(recall_target)
    if not (0.0 < r <= 1.0):
        raise ValueError(
            f"recall_target must lie in (0, 1], got {recall_target!r} "
            f"(1.0 = exact; the TPU-KNN bound is meaningless outside)")
    if scorer == "elementwise" and r < 1.0:
        raise ValueError(
            f"scorer='elementwise' computes exact top-k only; "
            f"recall_target={r} needs scorer='mxu' (or 'auto')")
    if scorer == "auto":
        return "mxu" if (r < 1.0 or precision == "bf16") else "elementwise"
    return scorer


def resolve_precision(precision: str, scorer_resolved: str = "mxu") -> str:
    """'auto' -> 'f32': reduced precision is an opt-in speed knob, never a
    silent accuracy change.  Explicit tiers pass ``mxu.topk.PRECISIONS``
    validation; 'bf16' with the elementwise scorer is refused (that path
    has no reduced-precision mode)."""
    from .mxu.topk import check_precision

    if precision == "auto":
        return "f32"
    check_precision(precision)
    if precision != "f32" and scorer_resolved == "elementwise":
        raise ValueError(
            f"precision={precision!r} needs the MXU scorer; the elementwise "
            f"path has no reduced-precision mode (set scorer='mxu' or leave "
            f"it 'auto')")
    return precision


def blocked_topm(k: int, ccap: int) -> int:
    """Per-block kept count m of the 'blocked' kernel, or 0 when the
    blocked route is ineligible for this (k, ccap): it needs at least two
    128-slot blocks and a survivor pool (m * blocks) covering k three
    times over (a pool close to k flags almost every row as a deficit)."""
    g = ccap // 128
    if ccap % 128 != 0 or g < 2:
        return 0
    m = min(max(-(-k // g) + 4, -(-3 * k // g)), 16)
    return m if m * g >= 3 * k else 0


def resolve_kernel(kernel: str, k: int, ccap: int) -> str:
    """'auto' -> 'kpass'; 'blocked' stays explicit-request-only and
    degrades to 'kpass' on a shape ``blocked_topm`` finds ineligible."""
    if kernel not in ("auto", "blocked", "kpass"):
        raise ValueError(
            f"unknown kernel {kernel!r}: expected 'auto', 'blocked' or "
            f"'kpass'")
    if kernel == "auto":
        return "kpass"
    if kernel == "blocked" and not blocked_topm(k, ccap):
        return "kpass"
    return kernel


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Tunables of the serving daemon (``serve/``); counterpart of the
    reference's ``ServeConfig``.

    Attributes:
      max_batch: largest batch capacity (queries a flushed batch holds),
        and the size trigger: the batcher flushes as soon as admitting the
        next request would exceed it.  A single request wider than this is
        refused at admission (``InvalidRequestError``).
      max_delay_s: deadline trigger: a pending request older than this
        forces a flush of a batch that is not full.
      min_bucket: smallest capacity bucket.  A flushed batch pads up to the
        next power-of-two bucket in [min_bucket, max_batch], so the batch
        shapes a session can run form a fixed, finite set that the warmup
        covers.
      compact_threshold: mutations (inserts + deletes) the delta overlay
        absorbs before it folds them into a full re-prepare of the mutated
        cloud (``serve/delta.py``).
      warmup: run one sentinel batch per capacity bucket when the daemon
        starts and after each compaction.
      k: neighbours per served query (None: the problem's prepared k).
        Every batch runs at this k; a request's own smaller k truncates its
        columns on the way out.
    """

    max_batch: int = 256
    max_delay_s: float = 0.01
    min_bucket: int = 8
    compact_threshold: int = 512
    warmup: bool = True
    k: Optional[int] = None

    def __post_init__(self):
        if self.min_bucket < 1 or self.max_batch < self.min_bucket:
            raise ValueError(
                f"serve buckets need 1 <= min_bucket <= max_batch, got "
                f"min_bucket={self.min_bucket} max_batch={self.max_batch}")
        if self.max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, "
                             f"got {self.max_delay_s}")
        if self.compact_threshold < 1:
            raise ValueError(f"compact_threshold must be >= 1, "
                             f"got {self.compact_threshold}")
        if self.k is not None and self.k < 1:
            raise ValueError(f"serving k must be >= 1 (or None for the "
                             f"prepared k), got {self.k}")

    def buckets(self) -> tuple:
        """The fixed capacity-bucket ladder: powers of two from min_bucket
        up to and including a bucket covering max_batch."""
        out = []
        b = 1 << (self.min_bucket - 1).bit_length()
        while b < self.max_batch:
            out.append(b)
            b <<= 1
        out.append(b)
        return tuple(out)

    def bucket_for(self, m: int) -> int:
        """Smallest bucket covering an m-query batch (m <= max_batch)."""
        for b in self.buckets():
            if m <= b:
                return b
        # the batcher never forms a batch over the cap: admission refuses
        # wider requests
        raise ValueError(f"batch of {m} queries exceeds max_batch="
                         f"{self.max_batch}")
