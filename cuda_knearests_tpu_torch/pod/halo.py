"""The halo exchange of a pod: export blocks walked along the chip chain.

Counterpart of ``cuda_knearests_tpu/pod/halo.py``, whose one program of
``lax.ppermute`` ring steps becomes device copies here.  The partition
(``partition.py``) decided on the host which cells cross chip boundaries
and where each lands in its receivers' windows, so the device side is
pure data movement: each chip gathers its export block (the rows of its
cells that another chip's candidate boxes reach; pads where ``export_idx``
is -1), then, ``steps`` times in each direction, every chip hands the
block it holds to its neighbour -- chip d + 1 on the forward walk, d - 1
on the backward one -- each hand-over a copy onto the receiver's device.
After step s of the forward walk a chip holds the block of the chip s
below it, which lands at window slot s - 1; the backward walk fills slots
steps .. 2 * steps - 1 (``PodMeta.halo_base``).  An edge chip's missing
blocks are pad rows, which no window cell references.  Pads sit at 0, as
``parallel.sharded._PAD_XYZ`` (the reference pads at 1e30).

Every step moves one block over each of the ndev - 1 links of the chain
in each direction, so the bytes moved equal ``PodMeta.halo_bytes``, which
the caller records through ``runtime.dispatch.ici``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..parallel.sharded import _PAD_XYZ
from ..runtime import dispatch
from .partition import PodMeta


def pad_block(meta: PodMeta, device: torch.device, slots: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``slots`` empty blocks: (slots, hcap, 3) pad points and (slots,
    hcap) -1 ids."""
    return (torch.full((slots, meta.hcap, 3), _PAD_XYZ, dtype=torch.float32,
                       device=device),
            torch.full((slots, meta.hcap), -1, dtype=torch.int32,
                       device=device))


def export_block(pts: torch.Tensor, ids: torch.Tensor,
                 export_idx: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A chip's export block: its bucket rows at ``export_idx`` (hcap,),
    pads where the index is -1."""
    ok = export_idx >= 0
    safe = export_idx.clamp(min=0).long()
    return (torch.where(ok[:, None], pts[safe], _PAD_XYZ),
            torch.where(ok, ids[safe], -1))


def exchange(meta: PodMeta, chips: Dict[int, dict], devices: Sequence
             ) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """Walk every export block ``meta.steps`` chips along the chain in each
    direction.  ``chips[d]`` holds chip d's staged ``pts``, ``ids`` and
    ``export_idx`` on ``devices[d]``.  Returns per chip its received blocks
    in slot order, ((2 * steps, hcap, 3) points, (2 * steps, hcap) ids) on
    its device, pads where no chip lies that far.  Each hand-over copies
    the block the sender holds into the receiver's slot, which the
    receiver hands on at the next step.  Nothing is read back to the
    host."""
    ndev, steps = meta.ndev, meta.steps
    out = {d: pad_block(meta, devices[d], 2 * steps) for d in range(ndev)}
    blocks = [export_block(chips[d]["pts"], chips[d]["ids"],
                           chips[d]["export_idx"]) for d in range(ndev)]
    for base, shift in ((0, 1), (steps, -1)):   # forward, then backward
        held = blocks
        for s in range(base, base + steps):
            for d in range(ndev):
                src = d - shift
                if 0 <= src < ndev:
                    for dst, blk in zip(out[d], held[src]):
                        dst[s].copy_(blk, non_blocking=True)
            held = [(out[d][0][s], out[d][1][s]) for d in range(ndev)]
    return out


def stage_chips(bucket_pts: np.ndarray, bucket_ids: np.ndarray,
                export_idx: np.ndarray, devices: Sequence
                ) -> Dict[int, dict]:
    """Stage each chip's bucket (points, ids) and export indices onto its
    own device, one ``dispatch.stage`` an array a chip: the whole cloud
    never rides one transfer."""
    return {d: {"pts": dispatch.stage(bucket_pts[d], dv),  # syncflow: pod-prepare-stage
                "ids": dispatch.stage(bucket_ids[d], dv),  # syncflow: pod-prepare-stage
                "export_idx": dispatch.stage(export_idx[d], dv)}  # syncflow: pod-prepare-stage
            for d, dv in enumerate(devices)}
