"""Engine API: prepare a point cloud once, solve its all-points kNN.

Counterpart of ``cuda_knearests_tpu/api.py``.  ``KnnProblem.prepare``
validates the points, builds the grid on the device and plans the capacity
classes (packing each class's kernel inputs); ``solve`` launches the kernel
once per class, certifies every row, reads the result back in one batched
fetch, and resolves uncertified rows exactly with one more.  Results are in
sorted point indexing (``get_knearests``) or original indexing
(``get_knearests_original``).

Everything runs on the GPU unless ``device='cpu'`` is passed.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from .config import KnnConfig
from .io import validate_or_raise
from .ops.adaptive import AdaptivePlan, build_adaptive_plan, solve_adaptive
from .ops.gridhash import GridHash, build_grid
from .ops.solve import KnnResult, brute_force_by_index
from .runtime import dispatch
from .utils.memory import InvalidConfigError
from .utils.platform import resolve_device

# Fields of the reference package's KnnConfig that tune how it runs on its
# own hardware and cannot change an answer; a configuration read from its
# checkpoints drops them.
_REFERENCE_RUNTIME_KNOBS = frozenset({
    "sc_batch", "interpret", "stream_tile", "epilogue", "query_chunk",
    "hbm_budget_bytes"})


@dataclasses.dataclass
class KnnProblem:
    """One prepared all-points kNN problem."""

    grid: GridHash
    config: KnnConfig
    aplan: Optional[AdaptivePlan] = None
    result: Optional[KnnResult] = None

    @property
    def device(self) -> torch.device:
        return self.grid.device

    @classmethod
    def prepare(cls, points, config: KnnConfig | None = None,
                device=None, dim: int | None = None) -> "KnnProblem":
        """Validate ``points`` ((n, 3) inside [0, 1000]^3), build the grid
        and plan the classes on ``device`` (default: the GPU).  n = 0 and
        k > n are legal degraded modes."""
        config = config or KnnConfig()
        device = resolve_device(device)
        points = validate_or_raise(points, k=config.k)
        grid = build_grid(torch.as_tensor(points, device=device), dim=dim,
                          density=config.density)
        return cls._planned(grid, config)

    @classmethod
    def _planned(cls, grid: GridHash, config: KnnConfig,
                 cell_counts_host: np.ndarray | None = None
                 ) -> "KnnProblem":
        problem = cls(grid=grid, config=config)
        if grid.n_points:
            problem.aplan = build_adaptive_plan(grid, config,
                                                cell_counts_host)
        return problem

    def solve(self) -> KnnResult:
        """Run the grid solve, then resolve uncertified rows exactly (with
        ``fallback='brute'``).  At most two host round trips."""
        if self.grid.n_points == 0:
            k = self.config.k
            self.result = KnnResult(
                neighbors=np.empty((0, k), np.int32),
                dists_sq=np.empty((0, k), np.float32),
                certified=np.empty((0,), bool), uncert_count=np.int32(0))
            return self.result
        res = solve_adaptive(self.grid, self.config, self.aplan)
        self.result = self._finalize(res)
        return self.result

    def _finalize(self, res: KnnResult) -> KnnResult:
        """One batched readback of ids, d2, certificates and the
        uncertified count; then, only when rows are uncertified and the
        fallback is on, their exact resolution behind one more fetch."""
        nbr, d2, cert, n_unc = dispatch.fetch(
            res.neighbors, res.dists_sq, res.certified, res.uncert_count)
        n_unc = int(n_unc)
        if n_unc == 0 or self.config.fallback != "brute":
            return KnnResult(neighbors=nbr, dists_sq=d2, certified=cert,
                             uncert_count=np.int32(n_unc))
        bad = np.nonzero(~cert)[0].astype(np.int32)
        b_ids, b_d2 = brute_force_by_index(
            self.grid.points, dispatch.stage(bad, self.device),
            self.config.k, self.config.exclude_self)
        b_ids, b_d2 = dispatch.fetch(b_ids, b_d2)
        nbr[bad] = b_ids
        d2[bad] = b_d2
        cert[bad] = True
        return KnnResult(neighbors=nbr, dists_sq=d2, certified=cert,
                         uncert_count=np.int32(n_unc))

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
        perm = self.get_permutation()
        mapped = np.where(nbrs >= 0,
                          perm[np.clip(nbrs, 0, self.grid.n_points - 1)], -1)
        out = np.empty_like(mapped)
        out[perm] = mapped
        return out

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


def load_problem(path: str, device=None) -> KnnProblem:
    """Resume a prepared problem from the ``.npz`` checkpoint the reference
    package's ``save_problem`` writes (points, permutation, cell starts and
    counts, dim, domain, config): the grid goes to ``device`` as saved and
    the class plan is rebuilt from it."""
    device = resolve_device(device)
    with np.load(_npz_path(path)) as z:
        saved = json.loads(bytes(z["config_json"]).decode())
        known = {f.name for f in dataclasses.fields(KnnConfig)}
        unknown = set(saved) - known - _REFERENCE_RUNTIME_KNOBS
        if unknown:
            raise InvalidConfigError(
                f"{path}: saved config has fields this port does not know: "
                f"{sorted(unknown)}")
        cfg = KnnConfig(**{key: v for key, v in saved.items()
                           if key in known})
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
