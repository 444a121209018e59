"""The table of peaks and the byte bound of an all-points solve.

The bound counts the work from the cell's n, k and d alone, whatever
implements it: each input point read once (n·d float32) and each output
row written once (n·k ids as int32 and n·k distances as float32).  Exact
kNN has no operation count free of its implementation (how many
candidates a point scores is the implementation's), so the bound is by
bytes only.
"""

from __future__ import annotations

from typing import Optional

#: Published peak memory bandwidth, bytes/s, by a lowercased substring of
#: ``torch.cuda.get_device_name()``.  NVIDIA H100 Tensor Core GPU
#: datasheet, SXM5 part ("NVIDIA H100 80GB HBM3"): 3.35 TB/s at its
#: 700 W limit.
HBM_BYTES_PER_S = {"h100 80gb hbm3": 3.35e12}


def peak_bytes_per_s(device_kind: str) -> Optional[float]:
    kind = (device_kind or "").lower()
    return next((v for key, v in HBM_BYTES_PER_S.items() if key in kind),
                None)


def solve_bytes(n: int, k: int, d: int) -> int:
    """Bytes an all-points solve must move at the least: n·d·4 in, n·k·8
    out."""
    return int(n) * int(d) * 4 + int(n) * int(k) * 8


def bound_s(n: int, k: int, d: int, device_kind: str) -> Optional[float]:
    """Seconds the byte bound allows a solve on this device; None where
    the table has no peak for it."""
    peak = peak_bytes_per_s(device_kind)
    return None if peak is None else solve_bytes(n, k, d) / peak
