"""Dot-form scoring and the TPU-KNN fold in plain torch.

Counterpart of ``cuda_knearests_tpu/mxu/scorer.py``.  Scores recast
candidate distances as ``|q|^2 + |p|^2 - 2 q.p``; :func:`block_fold` keeps
each 128-slot block's first m, selects the first k of the kept pool, and
certifies the rows whose selection is provably a true top-k set
(``mxu/topk.py``).  :func:`select_plain` is the whole selection of the
brute route -- the reference's ``solve_blocks_xla`` -- and the plain
version of the kernels ``csrc/mxu_select.cu`` and ``csrc/mxu_select_bf16.cu``
(``mxu/kernel.py``): the same arithmetic written step by step, so the f32
kernel agrees with it bit for bit on the card (the bf16 one sums q.p on
tensor cores in its own order, within the band its source states):

  * norms and ``q.p`` summed in order over axes 0..d-1, every op rounded
    on its own; score ``(qn + pn) - 2 * qp``;
  * bf16 tier: coordinates rounded to bf16, each norm term ``x*x``
    rounded to bf16 and summed in f32, the products of ``q.p`` (exact in
    f32) summed in f32;
  * ties in (score, id) order through exact int64 keys; pads, the query's
    own id (``exclude_self``) and non-finite scores are missing, and come
    out as ``(inf, -1)``.

:func:`grid_class_topk` is the grid route's MXU class scorer (the
reference's, ``cuda_knearests_tpu/mxu/scorer.py:276``): one capacity
class's self-solve through the same scores and fold, rescored in the
engine's diff arithmetic (:func:`rescore_sorted`), with NaN at column k-1
on every row the fold does not certify.  Plain torch on the grid's device;
``q.p`` is summed axis by axis like every score here, never by a matrix
product, whose TF32 rounding on the card would lie outside the band that
certifies rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.solve import pack_cells, sum_sq_diff
from ..ops.topk import pack_key, unpack_key
from .topk import (BLOCK, check_precision, dot_error_bound,
                   interleave_slots, per_block_m)

# (query, candidate) pairs per chunk of select_plain.
_PLAIN_CHUNK_PAIRS = 1 << 22

_ID_MASK = 0xFFFFFFFF
_MISSING = 2**63 - 1  # after every real key


#: Seeded faults (``KNTPU_MXU_FAULT``, read by ``mxu/solve.parse_fault``
#: and run through :func:`select_plain` only): 'drop-block' drops block
#: 0's survivors from the selection after certification (a certified yet
#: incomplete row), 'skip-certify' certifies every row, 'narrow-bound'
#: certifies bf16-scored rows with the f32 band.  Each must give a banked
#: failure in the approx fuzz campaign (``fuzz/approx.py``).
FAULTS = ("drop-block", "skip-certify", "narrow-bound")


def cert_band_precision(precision: str, fault: str | None = None) -> str:
    """The precision whose error band certifies rows: the scoring
    precision, but the f32 band under the 'narrow-bound' seeded fault
    (too narrow for bf16 scores, so boundary rows wrongly certify)."""
    check_precision(precision)
    return "f32" if fault == "narrow-bound" else precision


def score_key(s: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 keys ordering (score, id) lexicographically for signed float32
    scores and non-negative ids: the score's bits made order-preserving
    (negatives flip their magnitude bits) in the high word, the id in the
    low word.  Non-finite scores are missing (the largest key)."""
    bits = s.contiguous().view(torch.int32)
    key = torch.where(bits < 0, torch.bitwise_xor(bits, 0x7FFFFFFF),
                      bits).to(torch.int64)
    key.bitwise_left_shift_(32).bitwise_or_(ids.to(torch.int64) & _ID_MASK)
    return key.masked_fill_(~torch.isfinite(s), _MISSING)


def key_score(key: torch.Tensor) -> torch.Tensor:
    """Scores of :func:`score_key` keys; missing keys give inf."""
    hi = (key >> 32).to(torch.int32)
    bits = torch.where(hi < 0, torch.bitwise_xor(hi, 0x7FFFFFFF), hi)
    s = bits.view(torch.float32)
    return torch.where(key == _MISSING, torch.full_like(s, float("inf")), s)


def key_id(key: torch.Tensor) -> torch.Tensor:
    """Ids of :func:`score_key` keys; missing keys give -1."""
    ids = (key & _ID_MASK).to(torch.int32)
    return torch.where(key == _MISSING, torch.full_like(ids, -1), ids)


def _smallest(key: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest keys of the last axis, ascending, padded with missing
    keys when the axis is narrower."""
    width = key.shape[-1]
    if width < k:
        pad = torch.full(key.shape[:-1] + (k - width,), _MISSING,
                         dtype=torch.int64, device=key.device)
        key = torch.cat([key, pad], dim=-1)
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).values


def _cast(x: torch.Tensor, precision: str) -> torch.Tensor:
    """Scoring coordinates: bf16-rounded (held in f32) or as given."""
    return x.to(torch.bfloat16).float() if precision == "bf16" else x


def norms(x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(...,) sums of squares of (..., d) coordinates over axes 0..d-1 in
    order.  bf16: each term ``x*x`` of the bf16-rounded coordinates
    rounded to bf16, summed in f32."""
    xs = x.to(torch.bfloat16) if precision == "bf16" else x
    n = None
    for ax in range(x.shape[-1]):
        term = (xs[..., ax] * xs[..., ax]).float()
        n = term if n is None else n + term
    return n


def score_tile(q: torch.Tensor, p: torch.Tensor,
               precision: str = "f32") -> torch.Tensor:
    """One (..., Q, C) dot-form score tile ``(qn + pn) - 2 * qp`` of
    (..., Q, d) queries and (..., C, d) candidates (leading axes
    broadcast) at the scoring ``precision``, every op rounded on its own
    (never TF32)."""
    qs, ps = _cast(q, precision), _cast(p, precision)
    qp = None
    for ax in range(q.shape[-1]):
        term = qs[..., :, None, ax] * ps[..., None, :, ax]
        qp = term if qp is None else qp + term
    return ((norms(q, precision)[..., :, None]
             + norms(p, precision)[..., None, :]) - 2.0 * qp)


def block_fold(s: torch.Tensor, ids: torch.Tensor, k: int, m: int,
               err_b: torch.Tensor, fault: str | None = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The TPU-KNN fold over a scored tile.

    s:     (..., C) dot-form scores, C a BLOCK multiple; missing slots
           non-finite.
    ids:   (..., C) candidate ids aligned with ``s`` (>= 0 where finite),
           or any shape that broadcasts to it.
    err_b: (...,) per-row error bound B (topk.dot_error_bound).
    Returns (ids (..., k) int32, scores (..., k) f32 ascending by
    (score, id), certified (...,) bool): each block's first m, the first k
    of their pool, and ``kplus >= t + 2B`` with t the k-th score and kplus
    the smallest score left out (rejected by its block, or in the pool
    beyond the k-th).  ``fault`` is a seeded fault of :data:`FAULTS`."""
    pool, kplus = fold_pool(s, ids, k, m)
    sel_s = key_score(pool[..., :k])
    cert = kplus >= sel_s[..., k - 1] + 2.0 * err_b
    if fault == "skip-certify":
        cert = torch.ones_like(cert)
    if fault == "drop-block":
        # certification above saw the whole pool; the selection loses
        # block 0's survivors
        lead, g = s.shape[:-1], s.shape[-1] // BLOCK
        mm = min(int(m), BLOCK)
        rest = score_key(s, ids).reshape(lead + (g, BLOCK))[..., 1:, :]
        kept = torch.topk(rest, mm, dim=-1, largest=False,
                          sorted=True).values
        pool = _smallest(kept.reshape(lead + ((g - 1) * mm,)), k)
        sel_s = key_score(pool[..., :k])
    return key_id(pool[..., :k]), sel_s, cert


def fold_pool(s: torch.Tensor, ids: torch.Tensor, k: int, m: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selection half of :func:`block_fold` (same arguments): the
    first k + 1 keys (:func:`score_key`) of the pool of each block's first
    m, and kplus, the smallest score left out."""
    lead, c = s.shape[:-1], s.shape[-1]
    if c % BLOCK != 0:
        raise ValueError(f"candidate axis {c} is not a {BLOCK} multiple")  # kntpu-ok: bare-valueerror -- internal layout invariant (callers pad), not user input
    g = c // BLOCK
    m = min(int(m), BLOCK)
    blocks = score_key(s, ids).reshape(lead + (g, BLOCK))
    mm = min(m + 1, BLOCK)
    top = torch.topk(blocks, mm, dim=-1, largest=False, sorted=True).values
    if mm > m:  # each block's smallest rejected score
        rem = key_score(top[..., m]).amin(dim=-1)
    else:
        rem = torch.full(lead, float("inf"), device=s.device)
    pool = _smallest(top[..., :m].reshape(lead + (g * m,)), k + 1)
    return pool, torch.minimum(rem, key_score(pool[..., k]))


def score_band(s_got: torch.Tensor, s_plain: torch.Tensor,
               cid_il: torch.Tensor) -> torch.Tensor:
    """Per row, the largest |s_got - s_plain| over the real candidates
    (cid_il >= 0) of two (M, C) unmasked score tiles: 2 * delta_max, the
    band within which a fold of ``s_got`` selects the scores a fold of
    ``s_plain`` selects (order statistics move at most as far as the
    scores)."""
    diff = (s_got - s_plain).abs()
    return torch.where(cid_il[None, :] >= 0, diff, 0.0).amax(dim=1)


def check_select_args(queries, q_ids, pts_il, cid_il, k, m, d_real,
                      precision):
    """Layout rules of the selection (the kernel's and the plain
    version's): (M, d) f32 queries, (M,) int32 ids, (C, d) f32 candidates
    with C a positive BLOCK multiple, (C,) int32 ids, one device, all
    contiguous.  Returns (M, C, d)."""
    if queries.dim() != 2 or pts_il.dim() != 2:
        raise ValueError(  # kntpu-ok: bare-valueerror -- internal layout invariant of the selection (callers pad), not user input
            f"select: queries and candidates must be 2-d (M, d) and (C, d), "
            f"got {tuple(queries.shape)} and {tuple(pts_il.shape)}")
    n_q, d = queries.shape
    n_c = pts_il.shape[0]
    for name, a, dt, shape in (("queries", queries, torch.float32, (n_q, d)),
                               ("q_ids", q_ids, torch.int32, (n_q,)),
                               ("pts_il", pts_il, torch.float32, (n_c, d)),
                               ("cid_il", cid_il, torch.int32, (n_c,))):
        if a.dtype != dt or tuple(a.shape) != shape \
                or a.device != queries.device or not a.is_contiguous():
            raise ValueError(  # kntpu-ok: bare-valueerror -- internal layout invariant of the selection (callers pad), not user input
                f"select: {name} must be a contiguous {dt} tensor of shape "
                f"{shape} on {queries.device}, got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
    if d < 1 or n_c == 0 or n_c % BLOCK != 0:
        raise ValueError(  # kntpu-ok: bare-valueerror -- internal layout invariant (callers pad), not user input
            f"select: need d >= 1 and a positive multiple of {BLOCK} "
            f"candidates (callers pad), got d={d}, C={n_c}")
    for name, v in (("k", k), ("m", m), ("d_real", d_real)):
        if isinstance(v, bool) or int(v) < 1:
            raise ValueError(f"select: {name} must be >= 1, got {v}")  # kntpu-ok: bare-valueerror -- internal layout invariant of the selection (callers validate k), not user input
    check_precision(precision)
    return n_q, n_c, d


def select_plain(queries, q_ids, pts_il, cid_il, k: int, m: int,
                 d_real: int, exclude_self: bool, precision: str = "f32",
                 fault: str | None = None):
    """The brute route's selection in plain torch (same arguments and
    results as ``mxu.kernel.select``).

    queries (M, d) and candidates (C, d) f32, C a BLOCK multiple laid out
    in interleaved blocks; ``q_ids`` the id each query excludes under
    ``exclude_self``; ``cid_il`` candidate ids, -1 on pads.  Every query
    is scored against every candidate (chunked over queries), masked, and
    folded (:func:`block_fold`) with the error band of the f32 norms, d =
    ``d_real`` and ``pn_max`` the largest f32 norm of a real candidate (at
    least 0).  ``fault`` is a seeded fault of :data:`FAULTS`.  Returns
    (ids (M, k) int32, scores (M, k) f32, certified (M,) bool)."""
    n_q, n_c, _ = check_select_args(queries, q_ids, pts_il, cid_il, k, m,
                                    d_real, precision)
    k, m = int(k), int(m)
    dev = queries.device
    valid = cid_il >= 0
    pn_max = torch.clamp(torch.where(valid, norms(pts_il),
                                     float("-inf")).amax(), min=0.0)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    cert = torch.empty((n_q,), dtype=torch.bool, device=dev)
    step = max(1, _PLAIN_CHUNK_PAIRS // n_c)
    for r0 in range(0, n_q, step):
        q = queries[r0:r0 + step]
        s = score_tile(q, pts_il, precision)
        drop = ~valid[None, :]
        if exclude_self:
            drop = drop | (cid_il[None, :] == q_ids[r0:r0 + step, None])
        s = torch.where(drop, float("inf"), s)
        err_b = dot_error_bound(norms(q), pn_max, int(d_real),
                                cert_band_precision(precision, fault))
        out_i[r0:r0 + step], out_s[r0:r0 + step], cert[r0:r0 + step] = \
            block_fold(s, cid_il.expand(s.shape), k, m, err_b, fault)
    return out_i, out_s, cert


# -- the grid route's MXU class scorer ----------------------------------------

#: Ceiling on one class row's (qcap, ccap) f32 score tile, the reference's
#: byte for byte: a class past it runs its exact route.
_CLASS_TILE_BYTES = 64 << 20


def class_eligible(qcap: int, ccap: int) -> bool:
    """True when one class row's (qcap, ccap) score tile fits the chunk
    budget (ccap is a BLOCK multiple by plan construction)."""
    return ccap % BLOCK == 0 and qcap * ccap * 4 <= _CLASS_TILE_BYTES


def class_rows_chunk(n_sc: int, qcap: int, ccap: int) -> int:
    """Supercells a step of :func:`grid_class_topk`, as the reference
    chunks them: the (rows, qcap, ccap) f32 score tile within
    ``_CLASS_TILE_BYTES``."""
    return max(1, min(n_sc, _CLASS_TILE_BYTES // max(1, qcap * ccap * 4)))


def rescore_sorted(points: torch.Tensor, q: torch.Tensor,
                   sel_i: torch.Tensor, sel_s: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selected ids re-scored in the engine's diff arithmetic and
    re-sorted.  points (n, d); q (..., d) the queries; sel_i/sel_s
    (..., k) from :func:`block_fold`.  Returns ((..., k) int32 ids, -1
    pads; (..., k) f32 d2 ascending by (d2, id), inf pads): d2 is
    ``ops.solve.sum_sq_diff``'s subtract-square-accumulate over axes
    0..d-1, so the values equal the elementwise routes' bit for bit."""
    valid = torch.isfinite(sel_s)
    c = points[torch.where(valid, sel_i, 0).long()]     # (..., k, d)
    d2 = sum_sq_diff(q[..., None, :], c)[..., 0, :]
    key = torch.sort(pack_key(d2, sel_i, valid), dim=-1).values
    d2s, ids = unpack_key(key)
    return ids, d2s


def grid_class_topk(points: torch.Tensor, starts: torch.Tensor,
                    counts: torch.Tensor, own_cells: torch.Tensor,
                    cand_cells: torch.Tensor, qcap: int, k: int, ccap: int,
                    exclude_self: bool, recall_target: float,
                    precision: str = "f32", rows_chunk: int | None = None,
                    tgt: torch.Tensor | None = None,
                    out: Tuple[torch.Tensor, torch.Tensor] | None = None):
    """One capacity class's self-solve through the MXU scorer: the
    counterpart of the reference's ``grid_class_topk``.

    Per step of ``rows_chunk`` supercells (default
    :func:`class_rows_chunk`): the supercells' own points (``own_cells``,
    packed at ``qcap``) are the queries, the points of their dilated boxes
    (``cand_cells``, packed at ``ccap``, slots interleaved across 128-slot
    blocks by ``topk.interleave_slots``) the candidates; :func:`score_tile`
    scores them at ``precision``, pads and (with ``exclude_self``) the
    query's own id are masked, and :func:`block_fold` keeps each block's
    first m (``per_block_m(recall_target, k, ccap // 128)``) and
    certifies against B from the f32 norms of the uncast coordinates,
    ``pn_max`` the largest over each supercell's real candidates.
    :func:`rescore_sorted` then gives the exact d2, and every real query
    slot whose selection did not certify gets NaN at column k-1, which
    fails the box-margin certificate downstream.

    Without ``tgt``, returns new (Sc * qcap, k) d2 and int32 ids, row
    sc * qcap + slot, missing entries (inf, -1).  With ``tgt``
    ((Sc * qcap,) destination rows) and ``out`` ((rows, k) f32 d2, int32
    ids), each step's rows are copied into ``out`` at their destinations;
    returns ``out``."""
    n_sc = own_cells.shape[0]
    m = per_block_m(recall_target, k, ccap // BLOCK)
    if rows_chunk is None:
        rows_chunk = class_rows_chunk(n_sc, qcap, ccap)
    dev = points.device
    il = torch.as_tensor(interleave_slots(ccap), device=dev).long()
    if tgt is None:
        out = (torch.empty((n_sc * qcap, k), dtype=torch.float32,
                           device=dev),
               torch.empty((n_sc * qcap, k), dtype=torch.int32, device=dev))
        tgt = torch.arange(n_sc * qcap, device=dev)
    for r0 in range(0, n_sc, rows_chunk):
        rs = slice(r0, r0 + rows_chunk)
        qi, qo = pack_cells(own_cells[rs], starts, counts, qcap)
        ci, co = pack_cells(cand_cells[rs], starts, counts, ccap)
        ci, co = ci[:, il], co[:, il]
        q, c = points[qi.long()], points[ci.long()]
        s = score_tile(q, c, precision)               # (rows, qcap, ccap)
        drop = ~co[:, None, :]
        if exclude_self:
            drop = drop | (ci[:, None, :] == qi[:, :, None])
        s.masked_fill_(drop, float("inf"))
        pn_max = torch.clamp(torch.where(co, norms(c), float("-inf"))
                             .amax(dim=1, keepdim=True), min=0.0)
        err_b = dot_error_bound(norms(q), pn_max, points.shape[1],
                                cert_band_precision(precision))
        sel_i, sel_s, cert = block_fold(s, ci[:, None, :], k, m, err_b)
        ids, d2 = rescore_sorted(points, q, sel_i, sel_s)
        d2[..., k - 1] = torch.where(cert | ~qo, d2[..., k - 1],
                                     float("nan"))
        dst = tgt[r0 * qcap:(r0 + qi.shape[0]) * qcap].long()
        out[0].index_copy_(0, dst, d2.reshape(-1, k))
        out[1].index_copy_(0, dst, ids.reshape(-1, k))
    return out
