"""Tie-aware comparison of FoF labels with the union-find oracle.

Counterpart of ``cuda_knearests_tpu/cluster/compare.py``.  Label equality
is the wrong check at the linking length: the engine scores pairs in
float32 and the oracle in float64, so a pair whose true distance lies
within the float32 rounding band of ``b`` may legally link in one and not
the other, and one such edge can merge two components.  What is exactly
checkable:

  1. well-formedness: labels are (n,) integers in [0, n), and sizes (when
     given) count label multiplicity exactly;
  2. canonical labels: every cluster's label is its minimum member id;
  3. mandatory links: every component of the pairs provably inside the
     radius carries one engine label;
  4. allowed links: every engine component lies inside one component of
     the pairs possibly inside the radius.

3 and 4 put the engine's partition between the oracle's bracketing
partitions; with no pair in the band the brackets coincide and the check
is exact partition equality.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..fuzz.compare import Mismatch
from ..oracle import fof_oracle


def fof_band(b: float) -> float:
    """Absolute squared-distance slack around ``b^2`` that brackets the
    engine's float32 link predicate: the threshold ``f32(b)^2`` rounded in
    float32 and the float32 diff-square-sum distance each err by a few
    ulps of b^2, plus a coordinate-ulp cross term; a 1e-4 relative band
    plus 4e-3 * b covers both with two orders of magnitude to spare."""
    b2 = float(np.float64(b) ** 2)  # kntpu-ok: wide-dtype -- host threshold arithmetic, never staged
    return 1e-4 * b2 + 4e-3 * float(b) + 1e-9


def _groups_share_one_value(group_of: np.ndarray, value_of: np.ndarray
                            ) -> Optional[int]:
    """First index whose ``value_of`` differs from its group's first
    member's, or None when every group carries one value."""
    order = np.argsort(group_of, kind="stable")
    g = group_of[order]
    v = value_of[order]
    starts = np.concatenate([[True], g[1:] != g[:-1]])
    first_of_group = np.maximum.accumulate(
        np.where(starts, np.arange(g.size), 0))
    bad = v != v[first_of_group]
    if bad.any():
        return int(order[np.nonzero(bad)[0][0]])
    return None


def _well_formed(n: int, labels: np.ndarray, sizes) -> Optional[Mismatch]:
    """Checks 1 and 2 on (n,) labels and optional sizes."""
    if labels.shape != (n,) or not np.issubdtype(labels.dtype, np.integer):
        return Mismatch(-1, "shape",
                        f"labels {labels.shape} {labels.dtype}, want ({n},) "
                        f"integer")
    if n == 0:
        return None
    if labels.min() < 0 or labels.max() >= n:
        r = int(np.nonzero((labels < 0) | (labels >= n))[0][0])
        return Mismatch(r, "label-range",
                        f"label {int(labels[r])} outside [0, {n})")
    mins = np.full(n, n, dtype=np.int64)  # kntpu-ok: wide-dtype -- host index arithmetic, never staged
    np.minimum.at(mins, labels, np.arange(n))
    uniq = np.unique(labels)
    bad = uniq[mins[uniq] != uniq]
    if bad.size:
        lab = int(bad[0])
        return Mismatch(lab, "not-canonical",
                        f"cluster labeled {lab} but its minimum member id "
                        f"is {int(mins[lab])}")
    if sizes is not None:
        sizes = np.asarray(sizes)
        counts = np.bincount(labels, minlength=n)
        if sizes.shape != (n,) or (sizes != counts[labels]).any():
            r = 0 if sizes.shape != (n,) else \
                int(np.nonzero(sizes != counts[labels])[0][0])
            return Mismatch(r, "size-mismatch",
                            f"sizes disagree with label multiplicity at "
                            f"row {r}")
    return None


def _bracketed(labels: np.ndarray, mandatory: np.ndarray,
               allowed: np.ndarray) -> Optional[Mismatch]:
    """Checks 3 and 4 against the bracketing partitions."""
    r = _groups_share_one_value(mandatory, labels)
    if r is not None:
        return Mismatch(r, "mandatory-split",
                        f"point {r} (engine label {int(labels[r])}) is "
                        f"mandatorily linked to oracle component "
                        f"{int(mandatory[r])} whose members carry another "
                        f"engine label")
    r = _groups_share_one_value(labels, allowed)
    if r is not None:
        return Mismatch(r, "forbidden-merge",
                        f"engine cluster {int(labels[r])} spans distinct "
                        f"allowed-oracle components (a link beyond the "
                        f"radius band merged them)")
    return None


def check_fof_bracket(labels, sizes, mandatory: np.ndarray,
                      allowed: np.ndarray) -> Optional[Mismatch]:
    """:func:`check_fof_result` against bracketing partitions computed
    elsewhere (any group ids; for example connected components of a
    kd-tree's pairs within sqrt(b^2 -+ band), where the O(n^2) oracle
    cannot run)."""
    labels = np.asarray(labels)
    return (_well_formed(np.asarray(mandatory).shape[0], labels, sizes)
            or _bracketed(labels, mandatory, allowed))


def check_fof_result(points: np.ndarray, b: float, labels: np.ndarray,
                     sizes: Optional[np.ndarray] = None,
                     band: Optional[float] = None) -> Optional[Mismatch]:
    """First tie-aware disagreement between an engine FoF labeling and the
    union-find oracle, or None when the labeling is exact.  ``band``
    overrides the default float32 rounding band (squared-distance
    units)."""
    points = np.asarray(points, np.float32)
    labels = np.asarray(labels)
    bad = _well_formed(points.shape[0], labels, sizes)
    if bad is not None or points.shape[0] == 0:
        return bad
    band = fof_band(b) if band is None else float(band)
    mandatory, allowed = fof_oracle(points, b, band=band)
    return _bracketed(labels, mandatory, allowed)
