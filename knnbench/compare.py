"""The comparison that decides ``correct``.

It judges rows the timed path produced: each kept row is the solve's row
``r`` in sorted indexing, which the port's own permutation maps to the
original point ``perm[r]`` and its neighbour ids to ``perm[ids]``.  The
reference (``reference.py``) recomputes that point's neighbours from the
original cloud.  Every number counts faults, so each limit is 0 (an exact
comparison; ``PERF.md`` gives the readings of the program and of the
bfloat16 control that it lies between):

* ``d2_mismatch``: entries whose distance differs from the reference's at
  the same rank.  Distances are compared, not ids, so ties at equal
  distance may be broken either way.
* ``id_mismatch``: entries whose id is out of range, repeated in its row,
  the point itself, or whose recomputed distance is not the one the row
  reports: an answer altered after it was scored.
* ``uncertified``: kept rows the solve left uncertified (the exact
  fallback must close every one).
* ``perm_violations``: values of ``[0, n)`` the permutation misses.
* ``failed_solves``: solves of the window that raised.

``rows_checked`` is reported beside them; a run that checked none is not
correct.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import reference

LIMITS = {"d2_mismatch": 0, "id_mismatch": 0, "uncertified": 0,
          "perm_violations": 0, "failed_solves": 0}


def perm_violations(perm: np.ndarray, n: int) -> int:
    """Values of [0, n) that ``perm`` misses (0 for a permutation)."""
    perm = np.asarray(perm).astype(np.int64)
    if perm.shape != (n,):
        return n
    inside = perm[(perm >= 0) & (perm < n)]
    return int(n - np.count_nonzero(np.bincount(inside, minlength=n)))


def _repeats(ids: np.ndarray) -> int:
    """Valid ids that repeat an earlier one of their row."""
    s = np.sort(ids, axis=1)
    dup = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    return int(dup.sum())


def judge(points: torch.Tensor, perm: np.ndarray, rows: np.ndarray,
          ids: np.ndarray, d2: np.ndarray, cert: np.ndarray, k: int,
          failed: int = 0) -> Dict[str, dict]:
    """The compared numbers, each with its limit.

    ``points``: the original cloud, (n, 3) float32, on the device the
    reference runs on.  ``perm``: the program's sorted-to-original
    permutation.  ``rows``, ``ids``, ``d2``, ``cert``: the kept rows'
    sorted indices, (m, k) ids in sorted indexing, (m, k) distances and
    (m,) certificates as the timed path returned them.  The reference
    computes in float32, the configuration's precision."""
    n = int(points.shape[0])
    perm = np.asarray(perm).astype(np.int64)
    nv = perm_violations(perm, n)
    rows = np.asarray(rows, np.int64)
    ids = np.asarray(ids).astype(np.int64)
    d2 = np.asarray(d2, np.float32)
    out_of_range = (ids >= n) | (ids < -1)
    valid = (ids >= 0) & ~out_of_range
    if nv == 0:
        q = perm[rows]
        mapped = np.where(valid, perm[np.where(valid, ids, 0)], -1)
    else:
        # no sound map: judge the rows as if unpermuted; the permutation's
        # own count already fails the run
        q = rows
        mapped = np.where(valid, ids, -1)
    dev = points.device
    q_t = torch.as_tensor(q, device=dev)
    ref_d2, _ = reference.knn_rows(points, q_t, k)
    ref_d2 = ref_d2.cpu().numpy()
    again = reference.pair_d2(points, q_t,
                              torch.as_tensor(mapped, device=dev))
    again = again.cpu().numpy()
    d2_bad = int(np.count_nonzero(~(d2 == ref_d2)))
    id_bad = (int(out_of_range.sum()) + _repeats(mapped)
              + int(np.count_nonzero(mapped == q[:, None]))
              + int(np.count_nonzero(~(again == d2))))
    values = {"d2_mismatch": d2_bad, "id_mismatch": id_bad,
              "uncertified": int(np.count_nonzero(~np.asarray(cert, bool))),
              "perm_violations": nv, "failed_solves": int(failed)}
    return {name: {"value": v, "limit": LIMITS[name]}
            for name, v in values.items()}


def is_correct(checks: Dict[str, dict], rows_checked: int) -> bool:
    return rows_checked > 0 and all(c["value"] <= c["limit"]
                                    for c in checks.values())


def lines(checks: Dict[str, dict], rows_checked: int) -> Sequence[str]:
    """The stderr lines: each number beside its limit."""
    out = [f"check rows_checked {rows_checked} (at least 1)"]
    out += [f"check {name} {c['value']} limit {c['limit']}"
            for name, c in checks.items()]
    return out
