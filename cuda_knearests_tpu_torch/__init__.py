"""cuda_knearests_tpu_torch: the PyTorch/CUDA port of cuda_knearests_tpu.

The all-points k-nearest-neighbour engine on an NVIDIA GPU: a uniform-grid
spatial hash built by one stable sort, adaptive supercell capacity classes,
a hand-written CUDA top-k kernel per class (``csrc/supercell_topk.cu``, or
the two-stage ``csrc/blocked_topk.cu`` under ``kernel='blocked'``), per-row
completeness certificates and an exact brute-force fallback.  External
queries (``KnnProblem.query``, ``query_radius``) run through the same
classes and kernels.  Point sets of any dimension take the brute route,
:mod:`cuda_knearests_tpu_torch.mxu` (``csrc/mxu_select.cu``).  Entry points
run on the GPU unless ``device='cpu'`` is passed.  :mod:`serve` is the
serving daemon over a prepared problem (dynamic batching, a mutation
overlay, typed failure containment, open-loop load generation).
"""

from .api import (KnnProblem, edges_from_neighbors, knn, load_problem,
                  radius_mask_from_knn, save_problem)
from .config import (DEFAULT_CELL_DENSITY, DEFAULT_K, DOMAIN_SIZE, KnnConfig,
                     ServeConfig)
from .ops.gridhash import (GridHash, build_grid, cell_coords, cell_ids,
                           unpermute_neighbors)
from .ops.solve import KnnResult, brute_force_by_index, build_plan, solve
from . import serve

__version__ = "0.1.0"

__all__ = [
    "KnnProblem", "knn", "save_problem", "load_problem",
    "edges_from_neighbors", "radius_mask_from_knn",
    "KnnConfig", "ServeConfig", "KnnResult", "GridHash", "serve",
    "build_grid", "build_plan", "solve", "brute_force_by_index",
    "cell_coords", "cell_ids", "unpermute_neighbors",
    "DOMAIN_SIZE", "DEFAULT_K", "DEFAULT_CELL_DENSITY",
]
