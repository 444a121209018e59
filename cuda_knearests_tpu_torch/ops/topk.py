"""Exact top-k under the (squared distance, stored id) order.

Counterpart of ``cuda_knearests_tpu/ops/topk.py``.  The reference selects
with ``lax.top_k``, whose ties go to the lower index; ``torch.topk``
promises no order among equal values.  So the selection here runs on one
int64 key per candidate, ``(bits(d2) << 32) | id``: a non-negative float32's
bit pattern orders like the float, ids are unique within a row, so the keys
are distinct and their order is exactly the lexicographic (d2, id) order.
Missing candidates carry the largest key and decode to ``(inf, INVALID_ID)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

INVALID_ID = -1  # "not found" sentinel

_ID_MASK = 0xFFFFFFFF
_MISSING = (0x7F800000 << 32) | _ID_MASK  # inf distance, all-ones id


def pack_key(d2: torch.Tensor, ids: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """int64 (d2, id) keys; ``mask`` False (or an inf distance) marks a
    missing candidate.  d2 must be non-negative (sums of squares are)."""
    bits = d2.contiguous().view(torch.int32).to(torch.int64)
    key = (bits << 32) | (ids.to(torch.int64) & _ID_MASK)
    missing = torch.isinf(d2)
    if mask is not None:
        missing = missing | ~mask
    return torch.where(missing, torch.full_like(key, _MISSING), key)


def unpack_key(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_key`: (f32 d2, i32 ids), missing slots
    ``(inf, INVALID_ID)``."""
    d2 = (key >> 32).to(torch.int32).view(torch.float32)
    ids = (key & _ID_MASK).to(torch.int32)
    return d2, torch.where(torch.isinf(d2), torch.full_like(ids, INVALID_ID),
                           ids)


def smallest_keys(key: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest keys of the last axis, ascending; rows narrower than
    k pad with missing keys."""
    width = key.shape[-1]
    if width < k:
        pad = torch.full(key.shape[:-1] + (k - width,), _MISSING,
                         dtype=torch.int64, device=key.device)
        key = torch.cat([key, pad], dim=-1)
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).values


def init_topk(batch_shape: Tuple[int, ...], k: int,
              device=None) -> torch.Tensor:
    """An empty running top-k: k missing keys per row."""
    return torch.full(tuple(batch_shape) + (k,), _MISSING, dtype=torch.int64,
                      device=device)


def merge_topk(best: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Fold a tile of new keys into a running ascending top-k of keys."""
    return smallest_keys(torch.cat([best, new], dim=-1), best.shape[-1])
