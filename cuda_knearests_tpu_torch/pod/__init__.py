"""The cell-partitioned index over a pod of chips.

Counterpart of ``cuda_knearests_tpu/pod/``: grid cells split across chips
as contiguous Morton (z-order) ranges balanced by point population, each
chip holding only its range's CSR; only boundary cells move between
chips, along the chip chain, as far as the candidate boxes measure; and a
per-chip memory model that splits a cloud over more chips instead of
refusing it.

* :mod:`.partition` -- host planning: Morton ranges, the directory, each
  chip's window layout and classes, the measured ring depth.
* :mod:`.halo`      -- staging and the exchange of export blocks.
* :mod:`.stream`    -- the per-chip memory model and its budget gate.
* :mod:`.solve`     -- :class:`PodKnnProblem`: prepare, solve, query.

``python -m cuda_knearests_tpu_torch.pod`` runs the smoke (``--device
cpu`` on a host without a GPU).
"""

from .solve import PodKnnProblem

__all__ = ["PodKnnProblem"]
