"""Engine API: prepare a point cloud once, solve its all-points kNN and
answer arbitrary queries against it.

Counterpart of ``cuda_knearests_tpu/api.py``.  ``KnnProblem.prepare``
validates the points, builds the grid on the device and plans the capacity
classes (packing each class's kernel inputs); ``solve`` launches the kernel
once per class, certifies every row, reads the result back in one batched
fetch, and resolves uncertified rows exactly with one more.  Results are in
sorted point indexing (``get_knearests``) or original indexing
(``get_knearests_original``, ``get_edges``).  ``query`` and
``query_radius`` answer (m, 3) query coordinates through the same classes
(``ops.adaptive.query_adaptive``), in original indexing; ``save_problem``
and ``load_problem`` checkpoint the prepared grid.  The Voronoi plane feed
(``KnnConfig.plane_feed``, ``get_planes``, ``query(planes=True)``) is a
host epilogue over the fetched rows (``cluster/planes.py``).

Three routes, chosen at prepare as the reference chooses them
(``_route_name``): 'oracle' (``backend='oracle'``: the kd-tree of
``oracle.py`` on the host, every row certified), 'adaptive' (the class
plan, ``KnnConfig.adaptive_eligible()``), else 'legacy' (one global
schedule, ``ops/solve.py``: the class kernel over one pack of every
supercell, or with ``backend='xla'`` the plain-torch scan; its queries
through ``ops.query.query_knn``).  ``print_stats``/``stats`` report the
grid, the plan and the certificate margins (``utils/stats.py``).

Everything runs on the GPU unless ``device='cpu'`` is passed.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from .cluster.planes import bisector_planes
from .config import KnnConfig
from .io import validate_or_raise
from .ops.adaptive import (AdaptivePlan, build_adaptive_plan, query_adaptive,
                           solve_adaptive)
from .ops.gridhash import GridHash, build_grid
from .ops.query import query_knn
from .ops.solve import (KnnResult, SolvePlan, brute_force_by_index,
                        build_plan, prepare_pack, resolve_backend)
from .ops.solve import solve as solve_legacy
from .obs import spans as _obs_spans
from .oracle import KdTreeOracle
from .runtime import dispatch
from .utils import stats as _stats
from .utils.memory import InvalidConfigError, InvalidKError
from .utils.platform import resolve_device

# Fields of KnnConfig that tune how the reference package runs on its own
# hardware and that the port does not honour; load_problem drops them from
# a checkpoint's configuration, so a checkpoint written under any value of
# them reads back (KnnConfig itself refuses a value it does not honour).
_REFERENCE_RUNTIME_KNOBS = frozenset({"interpret", "stream_tile"})


def _check_scorer_route(config: KnnConfig) -> None:
    """The reference's fail-fast resolution at prepare: the scorer knobs'
    ValueErrors, and the MXU scorer refused off the adaptive route."""
    config.resolved_precision()
    if config.resolved_scorer() == "mxu" and not config.adaptive_eligible():
        raise InvalidConfigError(
            f"scorer='mxu' (recall_target={config.recall_target}) needs the "
            f"adaptive grid route (adaptive=True, dist_method='diff', "
            f"backend 'auto' or 'pallas'); this config would route to the "
            f"legacy path and silently score elementwise -- use the "
            f"brute/MXU route (cuda_knearests_tpu_torch.mxu.solve_general) "
            f"for plan-free scoring")


def _resolve_tuned_for(cfg: KnnConfig, points, device) -> KnnConfig:
    """The tuned-plan seam of every prepare: ``config.resolve_tuned`` over
    this problem's (n, d) signature, keyed by ``device`` (the problem's,
    or its first slab's or chip's).  It fills only still-default knobs,
    and with no active store it returns ``cfg`` itself.  Shape probing is
    forgiving: a malformed input is refused by the front door, not
    here."""
    from .config import resolve_tuned

    shape = getattr(points, "shape", None)
    if shape is None:
        try:
            shape = np.asarray(points).shape
        except Exception:  # noqa: BLE001 -- malformed input: validate_or_raise owns the refusal
            return cfg
    if len(shape) != 2:
        return cfg
    return resolve_tuned(cfg, (int(shape[0]), int(shape[1])), device=device)


def radius_mask_from_knn(ids: np.ndarray, d2: np.ndarray, radius: float,
                         cap: int):
    """Shared tail of the query_radius surfaces (single-chip and sharded):
    mask exact k-NN rows beyond ``radius``.  The k-NN rows are globally exact,
    so the mask is exact for any radius; the only possible incompleteness is
    the cap itself, flagged per query via ``truncated``.  Returns (ids with
    -1 beyond count, d2 with inf beyond, counts, truncated)."""
    in_range = d2 <= np.float32(radius) ** 2
    counts = in_range.sum(axis=1).astype(np.int32)
    truncated = counts >= cap
    return (np.where(in_range, ids, -1), np.where(in_range, d2, np.inf),
            counts, truncated)


def edges_from_neighbors(nbrs: np.ndarray, symmetric: bool = False
                         ) -> np.ndarray:
    """(n, k) neighbor table (original ids, -1 = none) -> COO edge list
    (E, 2).  ``symmetric`` adds reverse edges and deduplicates."""
    n, k = nbrs.shape
    src = np.repeat(np.arange(n, dtype=np.int32), k)
    dst = nbrs.reshape(-1)
    keep = dst >= 0
    edges = np.stack([src[keep], dst[keep]], axis=1)
    if symmetric:
        und = np.concatenate([edges, edges[:, ::-1]])
        edges = np.unique(und, axis=0)
    return edges


@dataclasses.dataclass
class KnnProblem:
    """One prepared all-points kNN problem."""

    grid: GridHash
    config: KnnConfig
    aplan: Optional[AdaptivePlan] = None
    result: Optional[KnnResult] = None
    # the legacy route's schedule, its backend ('pallas' or 'xla') and, on
    # 'pallas', its pack (ops.cuda_solve.LegacyPack)
    plan: Optional[SolvePlan] = None
    backend: Optional[str] = None
    pack: Optional[object] = None
    # the kd-tree of backend='oracle', over the sorted points
    _oracle: Optional[KdTreeOracle] = dataclasses.field(default=None,
                                                        repr=False)
    # the stored cloud in original order on the host: the validated input
    # array, kept by reference by prepare; None on a problem resumed from
    # a checkpoint until the plane feed first needs it (_host_original)
    host_points: Optional[np.ndarray] = None

    @property
    def device(self) -> torch.device:
        return self.grid.device

    @classmethod
    def prepare(cls, points, config: KnnConfig | None = None,
                dim: int | None = None, validate: bool = True, *,
                device=None) -> "KnnProblem":
        """Validate ``points`` ((n, 3) inside [0, 1000]^3), build the grid
        (``dim`` cells per axis, default from the density) and plan the
        classes on ``device`` (default: the GPU).  n = 0 and k > n are
        legal degraded modes.  ``validate=False`` skips the front door and
        only casts to float32, for callers that validated already.  The
        scorer knobs are resolved first, as the reference resolves them:
        ValueError on an unknown scorer or tier, a recall_target outside
        (0, 1], or 'elementwise' with recall_target < 1 or 'bf16'; and
        ``InvalidConfigError`` for the MXU scorer off the adaptive route.
        A tuned plan, where a store is active, then fills the config's
        still-default knobs (``_resolve_tuned_for``, keyed by ``device``)
        and the result meets the same checks.
        The legacy route packs here, after its preflight
        (``ops.solve.prepare_pack``) refuses what the launch gate or the
        memory budget cannot take."""
        return cls._prepare(points, config or KnnConfig(), dim, validate,
                            device, tune=True)

    @classmethod
    def _prepare(cls, points, config: KnnConfig, dim, validate: bool,
                 device, tune: bool) -> "KnnProblem":
        with _obs_spans.span("knn.prepare", k=int(config.k)):
            _check_scorer_route(config)
            device = resolve_device(device)
            tuned = (_resolve_tuned_for(config, points, device) if tune
                     else config)
            if tuned is not config:
                # a tuned scorer or tier meets the same fail-fast checks
                config = tuned
                _check_scorer_route(config)
            points = (validate_or_raise(points, k=config.k) if validate
                      else np.ascontiguousarray(points, np.float32))
            with _obs_spans.span("prepare.grid"):
                grid = build_grid(torch.as_tensor(points, device=device),
                                  dim=dim, density=config.density)
                # the one wait on the grid's device work: the plan's census
                counts = grid.cell_counts.cpu().numpy()
            with _obs_spans.span("prepare.plan"):
                problem = cls._planned(grid, config, counts)
            problem.host_points = points
            return problem

    def with_points(self, points, validate: bool = True) -> "KnnProblem":
        """A fresh problem over ``points`` under this problem's config, on
        its device: the rebuild-from-scratch primitive of serving
        (``validate`` as in :meth:`prepare`).  The config is already
        resolved, so no tuned plan is applied again."""
        return KnnProblem._prepare(points, self.config, None, validate,
                                   self.device, tune=False)

    @classmethod
    def _planned(cls, grid: GridHash, config: KnnConfig,
                 cell_counts_host: np.ndarray | None = None
                 ) -> "KnnProblem":
        problem = cls(grid=grid, config=config)
        if not grid.n_points:
            return problem
        if config.backend == "oracle":
            problem._oracle = KdTreeOracle(grid.points.cpu().numpy())
        elif config.adaptive_eligible():
            problem.aplan = build_adaptive_plan(grid, config,
                                                cell_counts_host)
        else:
            problem.plan = build_plan(grid, config, cell_counts_host)
            problem.backend = resolve_backend(config, problem.plan)
            problem.pack = prepare_pack(grid, config, problem.plan,
                                        problem.backend)
        return problem

    def _route_name(self) -> str:
        """'oracle', 'adaptive' or 'legacy': the route solve and query
        take."""
        if self.config.backend == "oracle":
            return "oracle"
        return "adaptive" if self.config.adaptive_eligible() else "legacy"

    def solve(self) -> KnnResult:
        """Run the grid solve, then resolve uncertified rows exactly (with
        ``fallback='brute'``).  At most two host round trips.  With
        ``config.plane_feed`` the result carries the plane feed
        (``planes``)."""
        with _obs_spans.span("knn.solve", n=int(self.grid.n_points),
                             k=int(self.config.k),
                             route=self._route_name()):
            return self._solve()

    def _solve(self) -> KnnResult:
        cfg = self.config
        if self.grid.n_points == 0:
            self.result = KnnResult(
                neighbors=np.empty((0, cfg.k), np.int32),
                dists_sq=np.empty((0, cfg.k), np.float32),
                certified=np.empty((0,), bool), uncert_count=np.int32(0))
        elif self._oracle is not None:
            # the kd-tree answers on the host: no device round trip
            ids, d2 = (self._oracle.knn_all_points(cfg.k) if cfg.exclude_self
                       else self._oracle.knn(self._oracle.points, cfg.k))
            self.result = KnnResult(
                neighbors=ids, dists_sq=d2,
                certified=np.ones((self.grid.n_points,), bool),
                uncert_count=np.int32(0))
        elif self.aplan is not None:
            self.result = self._finalize(
                solve_adaptive(self.grid, cfg, self.aplan))
        else:
            self.result = self._finalize(solve_legacy(
                self.grid, cfg, self.plan, self.pack, self.backend))
        return self._with_plane_feed()

    def _finalize(self, res: KnnResult) -> KnnResult:
        """One batched readback of ids, d2, certificates and the
        uncertified count; then, only when rows are uncertified and the
        fallback is on, their exact resolution behind one more fetch."""
        nbr, d2, cert, n_unc = dispatch.fetch(  # syncflow: solve-final
            res.neighbors, res.dists_sq, res.certified, res.uncert_count)
        n_unc = int(n_unc)
        if n_unc == 0 or self.config.fallback != "brute":
            return KnnResult(neighbors=nbr, dists_sq=d2, certified=cert,
                             uncert_count=np.int32(n_unc))
        bad = np.nonzero(~cert)[0].astype(np.int32)
        b_ids, b_d2 = brute_force_by_index(
            self.grid.points, dispatch.stage(bad, self.device),  # syncflow: solve-fallback-stage
            self.config.k, self.config.exclude_self)
        b_ids, b_d2 = dispatch.fetch(b_ids, b_d2)  # syncflow: solve-fallback
        nbr[bad] = b_ids
        d2[bad] = b_d2
        cert[bad] = True
        return KnnResult(neighbors=nbr, dists_sq=d2, certified=cert,
                         uncert_count=np.int32(n_unc))

    # -- external queries ---------------------------------------------------

    def query(self, queries, k: int | None = None, planes: bool = False):
        """Exact kNN of arbitrary (m, 3) query coordinates inside the
        domain against the stored points; the query set is independent of
        the stored one (no self-exclusion).  ``k`` defaults to, and may not
        exceed, the prepared k, which sized the candidate dilation the
        certificate relies on.  Returns ((m, k) neighbour ids in original
        indexing, ascending by distance, -1 = none; (m, k) squared
        distances, inf = none).  At most two host round trips.

        ``planes=True`` adds the (m, k, 4) Voronoi plane feed of the rows
        (``cluster.planes.bisector_planes``: ``[nx, ny, nz, d]``, the
        half-space ``n . x <= d`` holds the query), computed on the host
        from the fetched rows."""
        with _obs_spans.span("knn.query", k=int(k or self.config.k),
                             route=self._route_name()):
            return self._query(queries, k, planes)

    def _query(self, queries, k, planes):
        k = self.config.k if k is None else k
        queries = validate_or_raise(queries, k=k, what="queries")
        k = int(k)
        if k > self.config.k:
            raise InvalidKError(
                f"k={k} exceeds the prepared k={self.config.k}; re-prepare "
                f"with a larger config.k (it sizes the candidate dilation)")
        ids, d2 = self._query_ids(queries, k)
        if not planes:
            return ids, d2
        return ids, d2, bisector_planes(queries, self._host_original(), ids)

    def _query_ids(self, queries: np.ndarray, k: int):
        """query()'s route (validated inputs): ((m, k) ids in original
        indexing, (m, k) d2)."""
        cfg = self.config
        if self.grid.n_points == 0:
            # no stored points: every row is all -1/inf
            return (np.full((queries.shape[0], k), -1, np.int32),
                    np.full((queries.shape[0], k), np.inf, np.float32))
        if self._oracle is not None:
            # sorted-index rows from the tree over sorted storage
            ids, d2 = self._oracle.knn(queries, k)
            perm = self.get_permutation()
            return (np.where(ids >= 0, perm[np.clip(ids, 0, None)],
                             ids).astype(np.int32), d2)
        if self.aplan is not None:
            return query_adaptive(self.grid, cfg, self.aplan, queries, k,
                                  cfg.fallback)
        return query_knn(self.grid, self.plan, self.pack, queries, k,
                         cfg.supercell, cfg.fallback, cfg.resolved_epilogue(),
                         chunk=cfg.resolved_query_chunk())

    def query_radius(self, queries, radius: float,
                     max_neighbors: int | None = None):
        """All stored points within ``radius`` of each query, at most
        ``max_neighbors`` (default: the prepared k) of them: the exact k-NN
        rows at k = ``max_neighbors``, masked beyond the radius.  Returns
        (ids (m, cap) in original indexing, -1 beyond the count; d2 (m,
        cap) ascending, inf beyond; counts (m,); truncated (m,): True where
        the cap was reached, so more neighbours may lie in range)."""
        cap = self.config.k if max_neighbors is None else int(max_neighbors)
        if cap > self.config.k:
            raise InvalidKError(
                f"max_neighbors={cap} exceeds the prepared k={self.config.k}")
        ids, d2 = self.query(queries, k=cap)
        return radius_mask_from_knn(ids, d2, radius, cap)

    # -- the Voronoi plane feed ---------------------------------------------

    def _with_plane_feed(self) -> KnnResult:
        """solve()'s one exit: with ``config.plane_feed``, attach the plane
        feed to the finalized result (a host epilogue over the fetched
        rows, no device round trip on a prepared problem)."""
        if self.config.plane_feed:
            self.get_planes()
        return self.result

    def _host_original(self) -> np.ndarray:
        """The stored cloud in original order on the host: free on a
        prepared problem; a problem resumed from a checkpoint pays one
        counted fetch of the sorted points and the permutation, cached."""
        if self.host_points is None:
            pts, perm = dispatch.fetch(self.grid.points,  # syncflow: host-original
                                       self.grid.permutation)
            out = np.empty_like(pts)
            out[perm] = pts
            self.host_points = out
        return self.host_points

    def _compute_planes(self) -> np.ndarray:
        pts = self._host_original()
        return bisector_planes(pts, pts, self.get_knearests_original())

    def get_planes(self) -> np.ndarray:
        """(n, k, 4) float32 plane feed of the solved all-points kNN, rows
        in original point order: ``[nx, ny, nz, d]`` per neighbour, the
        half-space ``n . x <= d`` holding the site; pad slots are the
        trivially true ``n = 0, d = inf``.  Computed once and cached on
        the result."""
        self._require_solved()
        if self.result.planes is None:
            self.result = dataclasses.replace(
                self.result, planes=self._compute_planes())
        return self.result.planes

    # -- result extraction --------------------------------------------------

    def get_points(self) -> np.ndarray:
        """Points in sorted (grid) order."""
        return self.grid.points.cpu().numpy()

    def get_permutation(self) -> np.ndarray:
        """Sorted position -> original index."""
        return self.grid.permutation.cpu().numpy()

    def get_knearests(self) -> np.ndarray:
        """(n, k) neighbour ids in sorted indexing, ascending by distance
        (-1 = none)."""
        self._require_solved()
        return np.asarray(self.result.neighbors)

    def get_dists_sq(self) -> np.ndarray:
        self._require_solved()
        return np.asarray(self.result.dists_sq)

    def get_knearests_original(self) -> np.ndarray:
        """(n, k) neighbour table in original point ids: row ``perm[r]``
        holds ``perm[nbrs[r]]`` (sentinels kept)."""
        self._require_solved()
        nbrs = np.asarray(self.result.neighbors)
        if self.grid.n_points == 0:
            return nbrs
        # a counted readback: the plane feed calls this inside solve()
        (perm,) = dispatch.fetch(self.grid.permutation)  # syncflow: extract-original
        mapped = np.where(nbrs >= 0,
                          perm[np.clip(nbrs, 0, self.grid.n_points - 1)], -1)
        out = np.empty_like(mapped)
        out[perm] = mapped
        return out

    def get_edges(self, symmetric: bool = False) -> np.ndarray:
        """The kNN graph as a COO edge list (E, 2) of original point ids;
        ``symmetric`` adds reverse edges and deduplicates."""
        self._require_solved()
        return edges_from_neighbors(self.get_knearests_original(), symmetric)

    def print_stats(self) -> dict:
        """Print occupancy, plan, certification and memory
        (``utils.stats.print_stats``); returns :meth:`stats`."""
        return _stats.print_stats(self)

    def stats(self) -> dict:
        """The problem's statistics as a dict, with the reference's keys
        (``utils.stats.problem_stats``)."""
        return _stats.problem_stats(self)

    def _require_solved(self) -> None:
        if self.result is None:
            raise RuntimeError("call solve() first")


def knn(points, k: int = 10, config: KnnConfig | None = None,
        device=None) -> np.ndarray:
    """One call: exact all-points kNN in original indexing."""
    cfg = dataclasses.replace(config or KnnConfig(), k=k)
    problem = KnnProblem.prepare(points, cfg, device=device)
    problem.solve()
    return problem.get_knearests_original()


def _npz_path(path: str) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_problem(problem: KnnProblem, path: str) -> None:
    """Checkpoint a prepared problem (grid and config) to one ``.npz``
    ('.npz' is appended when missing), in the reference package's layout:
    this port's :func:`load_problem` and the reference's read it back.
    Solved results are not saved (the solve is deterministic)."""
    g = problem.grid
    cfg = dataclasses.asdict(problem.config)
    np.savez_compressed(
        _npz_path(path),
        points=g.points.cpu().numpy(),
        permutation=g.permutation.cpu().numpy(),
        cell_starts=g.cell_starts.cpu().numpy(),
        cell_counts=g.cell_counts.cpu().numpy(),
        dim=np.int64(g.dim), domain=np.float64(g.domain),  # kntpu-ok: wide-dtype -- on-disk checkpoint schema, never staged to a device
        config_json=np.bytes_(json.dumps(
            {key: v for key, v in cfg.items() if v is not None}).encode()))


def load_problem(path: str, device=None) -> KnnProblem:
    """Resume a prepared problem from the ``.npz`` checkpoint the reference
    package's ``save_problem`` writes (points, permutation, cell starts and
    counts, dim, domain, config): the grid goes to ``device`` as saved and
    the route's plan (or kd-tree) is rebuilt from it, as ``prepare``
    builds it.  The config keeps every honoured knob; ``interpret`` and
    ``stream_tile``, which the port does not honour, are dropped."""
    device = resolve_device(device)
    with np.load(_npz_path(path)) as z:
        saved = json.loads(bytes(z["config_json"]).decode())
        known = {f.name for f in dataclasses.fields(KnnConfig)}
        unknown = set(saved) - known
        if unknown:
            raise InvalidConfigError(
                f"{path}: saved config has fields this port does not know: "
                f"{sorted(unknown)}")
        cfg = KnnConfig(**{key: v for key, v in saved.items()
                           if key not in _REFERENCE_RUNTIME_KNOBS})
        _check_scorer_route(cfg)
        counts = z["cell_counts"].astype(np.int32)
        grid = GridHash(
            points=torch.as_tensor(z["points"].astype(np.float32),
                                   device=device),
            permutation=torch.as_tensor(
                z["permutation"].astype(np.int32), device=device),
            cell_starts=torch.as_tensor(
                z["cell_starts"].astype(np.int32), device=device),
            cell_counts=torch.as_tensor(counts, device=device),
            dim=int(z["dim"]), domain=float(z["domain"]))
    return KnnProblem._planned(grid, cfg, cell_counts_host=counts)
