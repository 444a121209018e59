"""The brute route: dot-form scoring with the TPU-KNN per-block top-k and
exact-certify refinement, for point sets of any dimension.

Counterpart of ``cuda_knearests_tpu/mxu``.  ``mxu.knn`` /
``mxu.solve_general`` accept ``(n, d)`` points for any d; the grid route
keeps its d=3 contract and refuses wider input with a pointer here
(``io.validate_or_raise``).

* :mod:`topk`   -- the recall bound, per-block keep counts, error bound and
  slot interleave (host numpy).
* :mod:`scorer` -- dot-form scores, the fold, ``select_plain`` (the plain
  version of the selection kernel), and ``grid_class_topk``, the grid
  route's MXU class scorer (``KnnConfig(scorer='mxu')``, plain torch).
* :mod:`kernel` -- ``select``: the CUDA selection kernels
  (``csrc/mxu_select.cu`` at f32, ``csrc/mxu_select_bf16.cu`` at bf16,
  ``csrc/mxu_select_split.cu`` for the k they do not hold) on CUDA
  tensors, the plain version on CPU ones.
* :mod:`solve`  -- ``solve_general`` (any d, recall knob, at most two host
  round trips) and ``knn``.
* :mod:`measure` -- the tie-aware float64 recall oracle (numpy).
* ``python -m cuda_knearests_tpu_torch.mxu [--device cpu]`` -- the smoke.
"""

from __future__ import annotations

from .solve import MxuResult, knn, solve_general
from .topk import BLOCK, per_block_m, recall_bound

__all__ = ["BLOCK", "MxuResult", "knn", "per_block_m", "recall_bound",
           "solve_general"]
