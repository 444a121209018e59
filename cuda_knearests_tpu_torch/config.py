"""Runtime configuration of the PyTorch/CUDA kNN engine.

Counterpart of ``cuda_knearests_tpu/config.py``: the same grid constants,
the fields of ``KnnConfig`` that the grid route reads, and the resolution
rules of the scorer, precision and kernel knobs.  Every field of the
reference package's ``KnnConfig`` exists here.  Fields the grid route does
not honour are accepted at their default value (or at the value that
means what this port does) and any other value raises
:class:`InvalidConfigError` at construction: a knob is never silently
ignored.  ``load_problem`` drops the reference's runtime knobs (the last
six fields below) from a checkpoint's configuration before it builds one,
since they tune how the reference runs on its hardware and cannot change
an answer.
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
    "scorer": (("auto", "elementwise"),
               "the grid route's MXU class scorer is not ported yet; the "
               "brute route (mxu.solve_general) has the MXU scorer"),
    "recall_target": ((1.0,), "approximate search (recall_target < 1) on "
                              "the grid route is not ported yet; the brute "
                              "route (mxu.solve_general) has it"),
    "backend": (("auto",), "only the grid engine with the CUDA kernel is "
                           "ported ('oracle' and 'xla' are not)"),
    "kernel": (("kpass", "auto", "blocked"), "unknown kernel"),
    "precision": (("auto", "f32"), "reduced-precision scoring on the grid "
                                   "route is not ported yet; the brute "
                                   "route (mxu.solve_general) has it"),
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
