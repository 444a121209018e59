"""Clustering on the grid core, and the Voronoi plane feed.

Counterpart of ``cuda_knearests_tpu/cluster/``:

* :mod:`fof` -- friends-of-friends connected components over fixed-radius
  pairs, walking the grid's 27-cell block on the device with a counted
  convergence read per round;
* :mod:`planes` -- the per-neighbour bisector planes of a kNN result (the
  input of Voronoi-cell clipping), a float64 host epilogue;
* :mod:`compare` -- the tie-aware check of FoF labels against the
  union-find oracle (``oracle.fof_oracle``).

``python -m cuda_knearests_tpu_torch.cluster [--device cpu]`` runs the
checks of this package on the GPU (default) or the CPU.
"""

from __future__ import annotations

from .fof import FofResult, fof_labels  # noqa: F401
from .planes import bisector_planes  # noqa: F401

__all__ = ["FofResult", "fof_labels", "bisector_planes"]
