"""cuda_knearests_tpu_torch: the PyTorch/CUDA port of cuda_knearests_tpu.

The all-points k-nearest-neighbour engine on an NVIDIA GPU: a uniform-grid
spatial hash built by one stable sort, adaptive supercell capacity classes,
a hand-written CUDA top-k kernel per class (``csrc/supercell_topk.cu``),
per-row completeness certificates and an exact brute-force fallback.
Entry points run on the GPU unless ``device='cpu'`` is passed.
"""

from .api import KnnProblem, knn, load_problem
from .config import DEFAULT_CELL_DENSITY, DEFAULT_K, DOMAIN_SIZE, KnnConfig
from .ops.gridhash import GridHash, build_grid, cell_coords, cell_ids
from .ops.solve import KnnResult, brute_force_by_index

__version__ = "0.1.0"

__all__ = [
    "KnnProblem", "knn", "load_problem",
    "KnnConfig", "KnnResult", "GridHash",
    "build_grid", "brute_force_by_index", "cell_coords", "cell_ids",
    "DOMAIN_SIZE", "DEFAULT_K", "DEFAULT_CELL_DENSITY",
]
