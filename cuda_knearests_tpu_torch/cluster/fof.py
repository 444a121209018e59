"""Friends-of-friends clustering on the grid-hash core.

Counterpart of ``cuda_knearests_tpu/cluster/fof.py``.  FoF links every pair
of points within a fixed *linking length* ``b`` and returns the connected
components of that graph.

1. **Host twin and preflight.**  The grid dim is capped so the cell width
   stays >= ``b`` (:func:`fof_grid_dim`); then every link lies in the
   27-cell block around a point's cell, ``ops.rings.ring_schedule(2)``.
   The host's cell coordinates (``ops.gridhash.cell_coords_host``, the
   bit-identical twin of the device mapping) give the sorted order, the
   densest cell and each point's 27 neighbour cells with no device round
   trip, and a cloud whose round would hold more than
   :data:`MAX_PAIR_SLOTS` candidate slots is refused before anything is
   put on the device.
2. **Links, once.**  :func:`link_slots` walks the 27 neighbour cells of
   every point and scores the candidates in float32 ``diff`` arithmetic
   (``dx*dx + dy*dy + dz*dz``, each operation rounded on its own, so the
   card and the CPU link the same pairs), keeping each candidate slot's
   sorted index where it links and ``n`` elsewhere: one int32 a slot,
   the 4 bytes a slot the preflight counts.  The links do not depend on
   the labels, so the reference's rounds, which score every round, and
   these, which score once, link the same pairs.
3. **Rounds.**  Labels start as each point's own sorted index.  A round
   (:func:`fof_round`) takes the minimum label over each point's linked
   slots and pointer-jumps twice (``L <- L[L]``).  Labels only decrease
   and always name a member of their own component, so they reach the
   component's minimum sorted index in O(log n) rounds.
4. **Counted convergence.**  The round's ``changed`` flag is read through
   ``runtime.dispatch.fetch`` once a round, and the labels and sizes come
   back in one more fetch: a solve costs ``rounds + 1`` host round trips
   (``FofResult.host_syncs``).
5. **Canonical labels.**  :func:`fof_finalize` maps each component to the
   minimum original point id among its members and scatters labels and
   sizes back to input order on the device.

Links and rounds are plain torch: the reference's rounds are XLA, not a
Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT_CELL_DENSITY, DOMAIN_SIZE, grid_dim_for
from ..io import validate_linking_length, validate_or_raise
from ..ops.gridhash import build_grid, cell_coords_host
from ..ops.rings import ring_schedule
from ..runtime import dispatch
from ..utils.memory import LaunchBudgetError
from ..utils.platform import resolve_device

# Pointer jumping converges in O(log n) rounds; 64 covers any n an int32
# index addresses many times over, so reaching it is a fault, not a big
# input.
MAX_ROUNDS = 64

# A solve holds n * m * 27 candidate slots (m = the densest cell's
# occupancy rounded up to a power of two) of 4 bytes; a cloud beyond this
# is refused with a typed oom-kind error before any device allocation.
MAX_PAIR_SLOTS = 1 << 28

_I32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class FofResult:
    """One FoF solve's output, on the host, rows in input order.

    Attributes:
      labels: (n,) int32 cluster label of each point: the minimum original
        point id of its component.
      sizes: (n,) int32 size of each point's component.
      n_clusters: number of components.
      rounds: propagation rounds to convergence.
      host_syncs: blocking host round trips of the solve (one convergence
        read a round plus the final fetch).
      linking_length: the b of this solve.
      dim: grid cells per axis (cell width >= b).
      cell_max: occupancy of the densest cell.
    """

    labels: np.ndarray
    sizes: np.ndarray
    n_clusters: int
    rounds: int
    host_syncs: int
    linking_length: float
    dim: int
    cell_max: int

    def cluster_sizes(self) -> "tuple[np.ndarray, np.ndarray]":
        """(labels, sizes) of each distinct cluster, labels ascending."""
        if self.labels.size == 0:
            return (np.empty((0,), np.int32), np.empty((0,), np.int64))  # kntpu-ok: wide-dtype -- np.unique's native count dtype, host-only
        lab, cnt = np.unique(self.labels, return_counts=True)
        return lab.astype(np.int32), cnt


def fof_grid_dim(n: int, b: float, domain: float = DOMAIN_SIZE,
                 density: float = DEFAULT_CELL_DENSITY) -> int:
    """Cells per axis of a FoF solve: the density-targeted dim, capped so
    the cell width stays >= ``b``.  A ``b`` wider than the domain gives one
    cell."""
    dim = grid_dim_for(n, density)
    if b > 0.0:
        dim = max(1, min(dim, int(domain / b)))
    while dim > 1 and domain / dim < b:  # float-division guard
        dim -= 1
    return dim


def _round_pow2(x: int, minimum: int = 8) -> int:
    return max(minimum, 1 << max(0, int(x) - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class FofPlan:
    """The host twin of one FoF solve: grid dim, the stable sorted order
    (equal to the device grid's permutation), the densest cell and the
    padded candidate slots a cell takes per offset."""

    dim: int
    order: np.ndarray     # (n,) int32
    cell_max: int
    m: int


def plan_fof(points: np.ndarray, b: float, domain: float = DOMAIN_SIZE,
             density: float = DEFAULT_CELL_DENSITY) -> FofPlan:
    """The host twin of a validated non-empty cloud, refusing with
    :class:`LaunchBudgetError` (``site='cluster.fof'``) a round over
    :data:`MAX_PAIR_SLOTS` candidate slots."""
    n = points.shape[0]
    dim = fof_grid_dim(n, b, domain, density)
    c = cell_coords_host(points, dim, domain)
    cids = c[:, 0] + dim * (c[:, 1] + dim * c[:, 2])
    order = np.argsort(cids, kind="stable").astype(np.int32)
    cell_max = int(np.bincount(cids, minlength=dim ** 3).max())
    m = _round_pow2(cell_max, minimum=8)
    if n * m * 27 > MAX_PAIR_SLOTS:
        raise LaunchBudgetError(
            f"FoF round would materialize {n}x{m} candidate slots per "
            f"offset (densest cell holds {cell_max} of {n} points at "
            f"dim={dim}); beyond the {MAX_PAIR_SLOTS} pair-slot budget",
            requested=n * m * 27 * 4, budget=MAX_PAIR_SLOTS * 4,
            site="cluster.fof")
    return FofPlan(dim=dim, order=order, cell_max=cell_max, m=m)


def _neighbor_cells_host(points: np.ndarray, order: np.ndarray, dim: int,
                         domain: float):
    """(n, 27) neighbour-cell ids (int32) and in-grid mask of each sorted
    row, in ``ring_schedule(2)``'s offset order.  Built an axis at a time
    (x + dim * y + dim^2 * z), which spares numpy an (n, 27, 3)
    reduction."""
    coords = cell_coords_host(points, dim, domain)[order]
    offs = ring_schedule(2).offsets
    ok = np.ones((coords.shape[0], offs.shape[0]), bool)
    cids = np.zeros((coords.shape[0], offs.shape[0]), np.int32)
    for axis, scale in ((0, 1), (1, dim), (2, dim * dim)):
        nc = coords[:, axis, None] + offs[None, :, axis]
        ok &= (nc >= 0) & (nc < dim)
        cids += np.clip(nc, 0, dim - 1) * np.int32(scale)
    return cids, ok


def stage_fof(points: np.ndarray, b: float, plan: FofPlan, domain: float,
              device: torch.device):
    """The grid of ``points`` on ``device`` and its linked slots
    (:func:`link_slots`) at linking length ``b``."""
    grid = build_grid(torch.as_tensor(points, device=device), dim=plan.dim,
                      domain=domain)
    nbr_cells, nbr_ok = _neighbor_cells_host(points, plan.order, plan.dim,
                                             domain)
    b2 = float(np.float32(b) * np.float32(b))
    slots = link_slots(grid.points[:, 0].contiguous(),
                       grid.points[:, 1].contiguous(),
                       grid.points[:, 2].contiguous(), grid.cell_starts,
                       grid.cell_counts, dispatch.stage(nbr_cells, device),  # syncflow: fof-stage
                       dispatch.stage(nbr_ok, device), b2, plan.m)  # syncflow: fof-stage
    return grid, slots


def link_slots(px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor,
               starts: torch.Tensor, counts: torch.Tensor,
               nbr_cells: torch.Tensor, nbr_ok: torch.Tensor, b2: float,
               m: int) -> torch.Tensor:
    """(27, n, m) int32 linked candidate slots: for each neighbour-cell
    offset, point and slot, the candidate's sorted index where the pair
    links (``d2 <= b2``), else ``n``.

    px/py/pz (n,) float32 sorted coordinates; starts/counts (dim^3,) int32
    CSR; nbr_cells/nbr_ok (n, 27) each point's neighbour cells and in-grid
    mask; b2 the float32 square of the linking length; m the slots a cell
    takes (at least the densest cell's occupancy)."""
    n = px.shape[0]
    slot = torch.arange(m, dtype=torch.int32, device=px.device)
    out = torch.empty((nbr_cells.shape[1], n, m), dtype=torch.int32,
                      device=px.device)
    for o in range(nbr_cells.shape[1]):
        cid = nbr_cells[:, o]
        ok_c = nbr_ok[:, o]
        st = torch.where(ok_c, starts[cid], 0)
        ct = torch.where(ok_c, counts[cid], 0)
        valid = slot[None, :] < ct[:, None]
        idx = torch.where(valid, st[:, None] + slot[None, :], 0)
        dx = px[:, None] - px[idx]
        dy = py[:, None] - py[idx]
        dz = pz[:, None] - pz[idx]
        d2 = dx * dx + dy * dy + dz * dz
        out[o] = torch.where(valid & (d2 <= b2), idx, n)
    return out


def fof_round(labels: torch.Tensor, slots: torch.Tensor):
    """One propagation round: each point takes the minimum label over
    itself and its linked slots (``slots`` from :func:`link_slots`), then
    two pointer jumps.  labels (n,) int32 sorted-index labels.  Returns
    (new labels, 0-d bool tensor: any label changed)."""
    n = labels.shape[0]
    # slot value n (no link) reads the sentinel label n
    ext = torch.cat([labels, labels.new_full((1,), n)])
    acc = labels
    for o in range(slots.shape[0]):
        acc = torch.minimum(acc, ext[slots[o]].min(dim=1).values)
    # pointer jumping: labels satisfy L[i] <= i, so the label graph is a
    # forest, and two hops at least quadruple how far a component's
    # minimum has travelled in a round
    acc = acc[acc]
    acc = acc[acc]
    return acc, (acc != labels).any()


def fof_finalize(labels: torch.Tensor, perm: torch.Tensor):
    """Sorted-index root labels -> (labels, sizes) in input order, each
    label the minimum original id of its component (int32 scatters, which
    are deterministic)."""
    n = labels.shape[0]
    lab = labels.long()
    dst = perm.long()
    canon = torch.full((n,), _I32_MAX, dtype=torch.int32,
                       device=labels.device).scatter_reduce_(
                           0, lab, perm, "amin")
    root_sizes = torch.zeros(n, dtype=torch.int32,
                             device=labels.device).scatter_add_(
                                 0, lab, torch.ones_like(labels))
    out_l = torch.empty_like(labels)
    out_s = torch.empty_like(labels)
    out_l[dst] = canon[lab]
    out_s[dst] = root_sizes[lab]
    return out_l, out_s


def fof_labels(points, linking_length: float, *,
               density: float = DEFAULT_CELL_DENSITY,
               domain: float = DOMAIN_SIZE,
               validate: bool = True,
               max_rounds: int = MAX_ROUNDS,
               device=None) -> FofResult:
    """Friends-of-friends components of ``points`` at ``linking_length``
    on ``device`` (default: the GPU).

    ``points`` go through ``io.validate_or_raise`` (skipped with
    ``validate=False``, which only casts to float32) and ``b`` through
    ``io.validate_linking_length``; n = 0 and n = 1 are legal.  Two points
    at float32 squared distance exactly ``f32(b)^2`` are linked.  Returns a
    :class:`FofResult` with canonical minimum-original-id labels.
    """
    device = resolve_device(device)
    b = validate_linking_length(linking_length)
    points = (validate_or_raise(points, domain=domain) if validate
              else np.ascontiguousarray(points, np.float32))
    n = points.shape[0]
    s0 = dispatch.stats()
    if n == 0:
        return FofResult(labels=np.empty((0,), np.int32),
                         sizes=np.empty((0,), np.int32), n_clusters=0,
                         rounds=0, host_syncs=0, linking_length=b,
                         dim=1, cell_max=0)
    plan = plan_fof(points, b, domain, density)
    grid, slots = stage_fof(points, b, plan, domain, device)
    labels = dispatch.stage(np.arange(n, dtype=np.int32), device)  # syncflow: fof-stage
    rounds = 0
    changed = n > 1
    while changed and rounds < max_rounds:
        labels, chg = fof_round(labels, slots)
        rounds += 1
        changed = bool(dispatch.fetch(chg)[0])  # syncflow: fof-round  # kntpu-ok: host-sync-loop -- the per-round convergence flag IS the FoF window's proven rounds + 1 syncs (syncflow fof-round)
    if changed:
        raise AssertionError(
            f"FoF propagation failed to converge in {max_rounds} rounds "
            f"(n={n}); pointer jumping guarantees O(log n) -- this is a "
            f"fault, not a large input")
    out_l, out_s = dispatch.fetch(*fof_finalize(labels, grid.permutation))  # syncflow: fof-final
    syncs = dispatch.stats().host_syncs - s0.host_syncs
    return FofResult(labels=out_l, sizes=out_s,
                     n_clusters=int(np.unique(out_l).size), rounds=rounds,
                     host_syncs=syncs, linking_length=b, dim=plan.dim,
                     cell_max=plan.cell_max)
