"""Runtime configuration of the PyTorch/CUDA kNN engine.

Counterpart of ``cuda_knearests_tpu/config.py``: the same grid constants,
every field of the reference package's ``KnnConfig`` and the resolution
rules of the scorer, precision, kernel and epilogue knobs.  Two fields
the port does not honour, ``interpret`` and ``stream_tile``, are accepted
at their defaults and any other value raises :class:`InvalidConfigError`
at construction, as does an unknown value of a field with a fixed set of
choices: a knob is never silently ignored.  The scorer knobs (``scorer``,
``recall_target``, ``precision``) are checked where the reference checks
them, when a problem is prepared (``resolved_scorer``/
``resolved_precision``).  ``load_problem`` drops ``interpret`` and
``stream_tile`` from a checkpoint's configuration before it builds one,
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

# Default entry cap of the tuned-plan store (tune/store.py): one entry per
# (device kind, problem signature) the autotuner has searched, evicted
# least recently used first.  KNTPU_TUNE_CACHE_CAP overrides it.
DEFAULT_TUNE_CACHE_ENTRIES = 64


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


# Reference-package fields the port does not honour, with the values each
# accepts (the reference's default).  Anything else is refused with the
# reason.
_UNSUPPORTED = {
    "interpret": ((False,), "the reference's Pallas interpret mode has no "
                            "counterpart: on the CPU the port runs its "
                            "kernels' plain versions"),
    "stream_tile": ((2048,), "the reference's streamed-route tile; the "
                             "port's streamed route sizes its own steps"),
}

# Fields that take one of a fixed set of values.
_CHOICES = {
    "backend": ("auto", "pallas", "xla", "oracle"),
    "kernel": ("kpass", "auto", "blocked"),
    "dist_method": ("diff", "dot"),
    "epilogue": ("auto", "scatter", "gather"),
    "plane_feed": (False, True),
    "adaptive": (False, True),
    "fallback": ("brute", "none"),
}


@dataclasses.dataclass(frozen=True)
class KnnConfig:
    """Tunables of the engine.

    Attributes:
      k: neighbours per query.
      density: grid sizing target, average points per cell.
      ring_radius: candidate dilation radius in cells around each
        supercell.  None -> per-supercell radii from local ring occupancy
        (``ops.adaptive.select_radii``) on the adaptive route, and
        ``default_ring_radius(k, density)`` on the legacy route.
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
      adaptive: the per-radius capacity classes (``ops/adaptive.py``).
        False, or ``dist_method='dot'``, or ``backend='xla'``, takes the
        legacy single-schedule route: one global (qcap, ccap) over every
        supercell (``ops/solve.py``).
      backend: 'auto' and 'pallas' (the reference's name for its kernel
        route) run the class kernels (``ops/cuda_solve.py``), launched on
        the card and their plain versions on the CPU; 'xla' runs the
        legacy route's supercell scan in plain torch
        (``ops.solve.chunk_best``); 'oracle' answers through the kd-tree
        of ``oracle/`` on the host (``oracle.KdTreeOracle``), every row
        certified.
      dist_method: 'diff' sums (a - b)^2 over x, y, z, each op rounded on
        its own; 'dot' computes |a|^2 + |b|^2 - 2 a.b with a torch matmul
        (no TF32), on the 'xla' scan only (it may order near-ties
        differently).
      sc_batch: supercells a step of the legacy schedule (the 'xla'
        scan's chunk; the kernel route packs every supercell at once).
      hbm_budget_bytes: device bytes one plan may commit (its packs and
        outputs).  None -> the ``KNTPU_HBM_BUDGET_BYTES`` environment
        variable, else 0.8 x the card's free memory, else (on the CPU)
        unbounded; <= 0 means unbounded (``cuda_solve.hbm_budget_bytes``).
      epilogue: how the kernel's rows reach the (n, k) output.  'scatter'
        (mode (a)): the kernel writes each row at its destination;
        'gather' (mode (b)): the kernel writes its (S, k, Q) layout and
        one gather through the prepare-time inverse map reads the rows.
        The answers are equal.  'auto' is 'scatter' on both devices (the
        reference picks 'gather' off its kernel platforms, a gate the
        port does not have).  Solvers read ``resolved_epilogue()``.
      query_chunk: queries a chunk of the legacy route's external-query
        pipeline (None: one shot); the chunks launch back to back and
        are read back in one fetch.  Solvers read
        ``resolved_query_chunk()``.
      interpret, stream_tile: the reference's; accepted at their defaults
        only.
    """

    # The reference's field order: a checkpoint's config JSON lists the
    # fields in this order (``dataclasses.asdict``), so the same problem
    # saves to the same bytes in both packages.
    k: int = DEFAULT_K
    density: float = DEFAULT_CELL_DENSITY
    scorer: str = "auto"
    recall_target: float = 1.0
    ring_radius: Optional[int] = None
    supercell: int = 3
    sc_batch: int = 64
    dist_method: str = "diff"
    exclude_self: bool = True
    fallback: str = "brute"
    backend: str = "auto"
    interpret: bool = False
    adaptive: bool = True
    max_classes: int = 4
    stream_tile: int = 2048
    hbm_budget_bytes: Optional[int] = None
    kernel: str = "kpass"
    epilogue: str = "auto"
    query_chunk: Optional[int] = None
    precision: str = "auto"
    plane_feed: bool = False

    def __post_init__(self):
        for name, (allowed, why) in _UNSUPPORTED.items():
            value = getattr(self, name)
            if value not in allowed:
                raise InvalidConfigError(
                    f"{name}={value!r} is not supported by the PyTorch/CUDA "
                    f"port: {why} (accepted: {allowed})")
        for name, allowed in _CHOICES.items():
            value = getattr(self, name)
            if value not in allowed:
                raise InvalidConfigError(
                    f"unknown {name} {value!r}: expected one of {allowed}")
        for name in ("supercell", "max_classes", "sc_batch"):
            value = getattr(self, name)
            if isinstance(value, bool) or int(value) < 1:
                raise InvalidConfigError(
                    f"{name} must be an integer >= 1, got {value!r}")
        for name in ("hbm_budget_bytes", "query_chunk"):
            value = getattr(self, name)
            if value is not None and (isinstance(value, bool)
                                      or not isinstance(value, int)):
                raise InvalidConfigError(
                    f"{name} must be None or an integer, got {value!r}")

    def resolved_ring_radius(self) -> int:
        """The legacy route's one global radius: ``ring_radius`` (at
        least 1), else :func:`default_ring_radius`."""
        if self.ring_radius is not None:
            return max(1, int(self.ring_radius))
        return default_ring_radius(self.k, self.density)

    def adaptive_eligible(self) -> bool:
        """Whether a problem takes the adaptive class route: ``adaptive``,
        'diff' arithmetic and a kernel backend ('auto' or 'pallas').  The
        reference takes 'pallas' there only on its kernel platforms; the
        port's kernel route runs on both devices."""
        return (self.adaptive and self.dist_method == "diff"
                and self.backend in ("auto", "pallas"))

    def resolved_scorer(self) -> str:
        """:func:`resolve_scorer` of this config (ValueError on an unknown
        scorer, a recall_target outside (0, 1], or 'elementwise' below
        1.0)."""
        return resolve_scorer(self.scorer, self.recall_target, self.precision)

    def resolved_precision(self) -> str:
        """:func:`resolve_precision` of this config against its resolved
        scorer (ValueError on an unknown tier, or 'bf16' with the
        elementwise scorer)."""
        return resolve_precision(self.precision, self.resolved_scorer())

    def resolved_epilogue(self) -> str:
        """:func:`resolve_epilogue` of this config: 'auto' is 'scatter'
        on both devices."""
        return resolve_epilogue(self.epilogue)

    def resolved_query_chunk(self) -> Optional[int]:
        """Queries a chunk of the legacy query pipeline; None (one shot)
        for None or a value <= 0."""
        q = self.query_chunk
        return int(q) if q is not None and int(q) > 0 else None

    def effective_kernel(self) -> str:
        """The kernel string solvers resolve from.  fallback='none' pins
        blocked/auto to 'kpass': blocked deficit rows resolve through the
        exact fallback, and without one they would lose their trailing
        entries where kpass keeps the exact row."""
        if self.fallback == "none" and self.kernel in ("blocked", "auto"):
            return "kpass"
        return self.kernel


def resolve_epilogue(epilogue: str) -> str:
    """'auto' -> 'scatter'; 'scatter' and 'gather' pass through; anything
    else is the reference's ``ValueError``.  The reference resolves 'auto'
    to 'gather' off its kernel platforms (no TPU and no interpret mode),
    because its host routes had no fused scatter; the port's kernels and
    their plain versions fuse it on both devices."""
    if epilogue not in ("auto", "scatter", "gather"):
        raise ValueError(
            f"unknown epilogue {epilogue!r}: expected 'auto', 'scatter' or "
            f"'gather'")
    return "scatter" if epilogue == "auto" else epilogue


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


def resolve_tuned(cfg: "KnnConfig", signature, device_kind=None, *,
                  device=None) -> "KnnConfig":
    """Fill a config's still-default knobs from the tuned-plan store: the
    one seam between the autotuner (``tune/``) and the solvers, which
    every prepare (single-device, sharded, pod) passes its config
    through.  The reference's laws:

      * only knobs still at 'auto'/None are filled, and only those of
        ``tune.store.RESOLVABLE_KEYS``: an explicit choice always wins;
      * with ``KNTPU_TUNE_STORE`` unset and no store registered
        (``tune.store.set_default_store``) ``cfg`` comes back as the same
        object and the tuner is not imported;
      * ``signature`` is a ``tune.store.plan_signature`` key, or an
        ``(n, d)`` tuple converted after that check.

    The store key's device half is ``tune.store.device_key(device_kind,
    device=device)``: the explicit kind, else the device the problem runs
    on ('cpu', or the CUDA card's name), so a plan measured on one never
    resolves for the other.  Plans fill only 'auto' slots and every tier
    certifies soundly, so at ``recall_target=1.0`` a tuned answer is the
    untuned one byte for byte."""
    import os

    if "KNTPU_TUNE_STORE" not in os.environ:
        import sys
        tune_store = sys.modules.get(__package__ + ".tune.store")
        if tune_store is None or tune_store.get_default_store() is None:
            return cfg  # no store active: no change, and no import
    from .tune import store as _store

    if isinstance(signature, tuple):
        n, d = signature
        signature = _store.plan_signature(n, d, cfg.k, cfg.recall_target)
    plan = _store.lookup_plan(signature,
                              _store.device_key(device_kind, device=device))
    if not plan:
        return cfg
    updates = {}
    if cfg.precision == "auto" and plan.get("precision"):
        updates["precision"] = str(plan["precision"])
    if cfg.scorer == "auto" and plan.get("scorer"):
        updates["scorer"] = str(plan["scorer"])
    if cfg.epilogue == "auto" and plan.get("epilogue"):
        updates["epilogue"] = str(plan["epilogue"])
    if cfg.query_chunk is None and plan.get("query_chunk"):
        updates["query_chunk"] = int(plan["query_chunk"])
    return dataclasses.replace(cfg, **updates) if updates else cfg


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


@dataclasses.dataclass(frozen=True)
class SloClass:
    """One service-level-objective tier of the serving fleet
    (``serve/fleet``).  A class picks the batching law's deadline and depth
    for its tenants: the latency tier flushes small batches fast, the
    throughput tier buffers deep batches on the large buckets.

    Attributes:
      name: the class's wire name ('latency' / 'throughput').
      max_delay_s: deadline flush trigger for tenants of this class.
      max_batch: batch depth cap (clamped to the fleet ladder's max_batch,
        so every batch shape stays on the shared bucket ladder).
      p99_budget_ms: the class's latency promise; a session stamps
        ``slo_ok`` (p99 <= budget) per tenant."""

    name: str
    max_delay_s: float
    max_batch: int
    p99_budget_ms: float


# The fleet's SLO classes: tenants name one, and the front door builds
# each tenant's ServeConfig from it plus the shared ladder.
SLO_CLASSES = {
    "latency": SloClass("latency", max_delay_s=0.002, max_batch=64,
                        p99_budget_ms=250.0),
    "throughput": SloClass("throughput", max_delay_s=0.05, max_batch=256,
                           p99_budget_ms=4000.0),
}


@dataclasses.dataclass(frozen=True)
class ServeFleetConfig:
    """Tunables of the multi-tenant serving fleet (``serve/fleet``);
    counterpart of the reference's ``ServeFleetConfig``.

    Attributes:
      min_bucket: smallest capacity bucket of the shared ladder.
      max_batch: the ladder's global cap; per-class max_batch clamps to it.
      compact_threshold: per-tenant delta-overlay compaction threshold.
      warmup: run one sentinel batch per bucket per dense tenant when the
        fleet starts, so no kernel library loads inside a session.
      sidecar_threshold: tenants whose cloud is smaller than this (or
        degenerate, n < k) are served by the host brute sidecar
        (``serve/fleet/sidecar.py``), not the dense batching ladder.
      quota_qps: default token-bucket refill rate (query rows/s) of
        tenants that set none; None = unmetered.
      quota_burst: default token-bucket depth (rows).
      drr_quantum: deficit-round-robin quantum (query rows added to each
        backlogged tenant's deficit per round).  Over any window in which
        tenants stay backlogged, their served rows differ by at most one
        quantum plus one batch.
      pod_threshold: tenants whose cloud is at least this large serve from
        an elastic pod index (``pod/reshard.ElasticIndex``); None disables
        the pod rung of the ladder sidecar -> dense -> pod.
      pod_shards: initial Morton-range shard count of pod tenants.
      pod_skew_threshold: population skew (max shard / mean) past which a
        pod tenant's mutations trigger a live rebalance.
    """

    min_bucket: int = 8
    max_batch: int = 256
    compact_threshold: int = 512
    warmup: bool = True
    sidecar_threshold: int = 192
    quota_qps: Optional[float] = None
    quota_burst: float = 4096.0
    drr_quantum: int = 64
    pod_threshold: Optional[int] = None
    pod_shards: int = 2
    pod_skew_threshold: float = 3.0

    def __post_init__(self):
        if self.min_bucket < 1 or self.max_batch < self.min_bucket:
            raise ValueError(
                f"fleet ladder needs 1 <= min_bucket <= max_batch, got "
                f"min_bucket={self.min_bucket} max_batch={self.max_batch}")
        if self.sidecar_threshold < 0:
            raise ValueError(f"sidecar_threshold must be >= 0, got "
                             f"{self.sidecar_threshold}")
        if self.drr_quantum < 1:
            raise ValueError(f"drr_quantum must be >= 1, got "
                             f"{self.drr_quantum}")
        if self.quota_qps is not None and self.quota_qps <= 0:
            raise ValueError(f"quota_qps must be > 0 (or None for "
                             f"unmetered), got {self.quota_qps}")
        if self.pod_threshold is not None \
                and self.pod_threshold <= self.sidecar_threshold:
            raise ValueError(
                f"pod_threshold must exceed sidecar_threshold (the "
                f"placement ladder is sidecar -> dense -> pod), got "
                f"pod_threshold={self.pod_threshold} <= "
                f"sidecar_threshold={self.sidecar_threshold}")
        if self.pod_shards < 1:
            raise ValueError(f"pod_shards must be >= 1, got "
                             f"{self.pod_shards}")
        if self.pod_skew_threshold <= 1.0:
            raise ValueError(f"pod_skew_threshold must be > 1.0, got "
                             f"{self.pod_skew_threshold}")

    def serve_config_for(self, slo: SloClass,
                         k: Optional[int] = None) -> ServeConfig:
        """The per-tenant ServeConfig an SLO class induces on the shared
        ladder: the class's deadline and depth, the fleet's floor and
        cap, so every tenant's buckets are a prefix of one ladder."""
        return ServeConfig(
            max_batch=min(int(slo.max_batch), self.max_batch),
            max_delay_s=float(slo.max_delay_s),
            min_bucket=self.min_bucket,
            compact_threshold=self.compact_threshold,
            warmup=self.warmup, k=k)
