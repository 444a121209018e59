"""TPU-KNN approximate top-k: the bound math (host numpy only).

Counterpart of ``cuda_knearests_tpu/mxu/topk.py``, constants kept bit for
bit.  The candidate axis is partitioned into 128-slot *blocks*; each block
keeps its ascending top-``m`` and the final top-k runs on the surviving
``G * m`` pool.  With candidates spread uniformly at random across
``L = G * m`` kept slots, the expected recall of the true top-k is bounded
below by

    E[recall@k] >= 1 - k * (k - 1) / (2 * L)

(TPU-KNN, arXiv 2206.14286).  :func:`per_block_m` inverts it: the smallest
per-block keep count whose bound meets a ``recall_target``.  Candidate slots
are round-robin interleaved across blocks (:func:`interleave_slots`) so
spatially adjacent candidates spread evenly.

Exactness tier: with ``s(j) = |q|^2 + |p_j|^2 - 2 q.p_j`` the float32
dot-form score and ``d(j)`` the true squared distance, ``|s - d| <= B``
(:func:`dot_error_bound`).  With ``t`` the k-th selected score and
``kplus`` the smallest score the selection excluded, a row certifies iff

    kplus >= t + 2 * B

which proves every excluded candidate's true distance is at least every
selected one's: the selected id set is a true top-k set up to exact ties.
"""

from __future__ import annotations

import math

import numpy as np

#: Candidate-axis block width.
BLOCK = 128

#: f32 unit roundoff.
_EPS32 = float(np.finfo(np.float32).eps)

#: Safety factor on the dot-form error bound: covers the rounding sites
#: (two norms, the dot reduction, two adds) plus headroom for
#: reassociation.  An under-bound would certify rows whose selection a
#: rounding swap corrupted.
_ERR_SAFETY = 4.0

#: Scoring precisions the engines accept.  "auto" is a config-layer alias
#: (resolved before any engine sees it).
PRECISIONS = ("f32", "bf16")

#: Extra per-coordinate roundoff the scoring precision adds on top of the
#: f32 pipeline: nothing for f32 (the (d + 8) * eps32 term covers it), and
#: bf16's eps = 2^-7 for bf16 (inputs and norm squares round to 8 mantissa
#: bits).
_SCORE_EPS = {"f32": 0.0, "bf16": 2.0 ** -7}

#: Rounding sites of the reduced-precision terms: two input casts and one
#: product rounding per side of the product, plus the two norm squares --
#: 6 sites, padded to 8.
_CAST_SITES = 8.0


def check_precision(precision: str) -> str:
    """Refuse unknown scoring precisions (the config layer wraps the
    ValueError into its typed refusal)."""
    if precision not in PRECISIONS:
        raise ValueError(  # kntpu-ok: bare-valueerror -- host-only module; config layer wraps with InvalidConfigError
            f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    return precision


def bins_for(recall_target: float, k: int) -> int:
    """Kept-slot count L whose TPU-KNN bound meets ``recall_target``:
    L = ceil(k(k-1) / (2(1-r))).  k at r = 1.0 (exhaustive)."""
    r = float(recall_target)
    if k <= 1 or r >= 1.0:
        return k
    return max(k, int(math.ceil(k * (k - 1) / (2.0 * (1.0 - r)))))


def per_block_m(recall_target: float, k: int, n_blocks: int) -> int:
    """Per-block keep count m for ``n_blocks`` candidate blocks.

    r = 1.0 keeps min(k, BLOCK) per block, which is exhaustive (no block
    can hold more than min(k, 128) of the global top-k).  Below 1.0, the
    smallest m whose L = m * n_blocks meets the bound; the floor
    ceil(k / n_blocks) keeps the pool wide enough to hold k at all."""
    n_blocks = max(1, int(n_blocks))
    cap = min(int(k), BLOCK)
    if float(recall_target) >= 1.0:
        return cap
    need = bins_for(recall_target, k)
    m = max(1, -(-need // n_blocks), -(-int(k) // n_blocks))
    return min(m, cap)


def recall_bound(k: int, n_blocks: int, m: int) -> float:
    """The expected-recall lower bound of an (n_blocks, m) fold: 1.0 when
    the fold is exhaustive (m covers min(k, BLOCK)), else the TPU-KNN
    expression over L = m * n_blocks kept slots."""
    if m >= min(int(k), BLOCK) or k <= 1:
        return 1.0
    loss = k * (k - 1) / (2.0 * m * max(1, n_blocks))
    return max(0.0, 1.0 - loss)


def dot_error_bound(qn, pn_max, d: int, precision: str = "f32"):
    """Per-row upper bound B on |dot-form score - true squared distance|:
    ``4 * ((d + 8) * eps32 + 8 * eps_prec) * (qn + pn_max)``, elementwise
    on arrays (qn per row, pn_max a scalar or row-shaped).  The f32 term is
    the reduction depth at f32 accumulation; the second term covers the
    input casts and products of a reduced scoring precision (0 for f32)."""
    check_precision(precision)
    return (_ERR_SAFETY * ((d + 8) * _EPS32 + _CAST_SITES * _SCORE_EPS[precision])
            * (qn + pn_max))


def interleave_slots(n_slots: int) -> np.ndarray:
    """Round-robin slot permutation: slot ``r * G + g -> g * BLOCK + r``.
    Adjacent input slots land in different blocks.  ``n_slots`` must be a
    BLOCK multiple.  Returns the (n_slots,) int32 gather map:
    out[i] = in[perm[i]]."""
    if n_slots % BLOCK != 0:
        raise ValueError(f"n_slots={n_slots} is not a multiple of {BLOCK}")  # kntpu-ok: bare-valueerror -- internal layout invariant (callers pad), not user input
    g = n_slots // BLOCK
    return np.arange(n_slots, dtype=np.int32).reshape(
        BLOCK, g).T.reshape(-1)
