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
* :mod:`.reshard`   -- mutation under partitioning: :class:`PodOverlay`
  (deletes tombstone bucket rows in place, only the dirty chips are
  staged again, and the halo exchange runs again only when a dirty cell
  is in its owner's export block; inserts ride a pruned host delta) and
  :class:`ElasticIndex` (the serving tier's Morton-range shards, each a
  legacy-route problem plus a delta overlay, with live boundary
  migration under traffic).

``python -m cuda_knearests_tpu_torch.pod`` runs the smoke (``--device
cpu`` on a host without a GPU).
"""

from .reshard import ElasticIndex, PodOverlay
from .solve import PodKnnProblem

__all__ = ["PodKnnProblem", "PodOverlay", "ElasticIndex"]
