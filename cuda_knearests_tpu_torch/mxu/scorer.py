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
"""

from __future__ import annotations

from typing import Tuple

import torch

from .topk import BLOCK, check_precision, dot_error_bound

# (query, candidate) pairs per chunk of select_plain.
_PLAIN_CHUNK_PAIRS = 1 << 22

_ID_MASK = 0xFFFFFFFF
_MISSING = 2**63 - 1  # after every real key


def cert_band_precision(precision: str) -> str:
    """The precision whose error band certifies rows: the scoring
    precision (the reference's seeded 'narrow-bound' fault is not
    ported)."""
    return check_precision(precision)


def score_key(s: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 keys ordering (score, id) lexicographically for signed float32
    scores and non-negative ids: the score's bits made order-preserving
    (negatives flip their magnitude bits) in the high word, the id in the
    low word.  Non-finite scores are missing (the largest key)."""
    bits = s.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, torch.bitwise_xor(bits, 0x7FFFFFFF),
                          bits).to(torch.int64)
    key = (ordered << 32) | (ids.to(torch.int64) & _ID_MASK)
    return torch.where(torch.isfinite(s), key, torch.full_like(key, _MISSING))


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
    """(n,) sums of squares over axes 0..d-1 in order.  bf16: each term
    ``x*x`` of the bf16-rounded coordinates rounded to bf16, summed in
    f32."""
    xs = x.to(torch.bfloat16) if precision == "bf16" else x
    n = None
    for ax in range(x.shape[1]):
        term = (xs[:, ax] * xs[:, ax]).float()
        n = term if n is None else n + term
    return n


def score_tile(q: torch.Tensor, p: torch.Tensor,
               precision: str = "f32") -> torch.Tensor:
    """One (Q, C) dot-form score tile ``(qn + pn) - 2 * qp`` at the scoring
    ``precision``, every op rounded on its own (never TF32)."""
    qs, ps = _cast(q, precision), _cast(p, precision)
    qp = None
    for ax in range(q.shape[1]):
        term = qs[:, None, ax] * ps[None, :, ax]
        qp = term if qp is None else qp + term
    return ((norms(q, precision)[:, None] + norms(p, precision)[None, :])
            - 2.0 * qp)


def block_fold(s: torch.Tensor, ids: torch.Tensor, k: int, m: int,
               err_b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The TPU-KNN fold over a scored tile.

    s:     (..., C) dot-form scores, C a BLOCK multiple; missing slots
           non-finite.
    ids:   (..., C) candidate ids aligned with ``s`` (>= 0 where finite).
    err_b: (...,) per-row error bound B (topk.dot_error_bound).
    Returns (ids (..., k) int32, scores (..., k) f32 ascending by
    (score, id), certified (...,) bool): each block's first m, the first k
    of their pool, and ``kplus >= t + 2B`` with t the k-th score and kplus
    the smallest score left out (rejected by its block, or in the pool
    beyond the k-th)."""
    lead, c = s.shape[:-1], s.shape[-1]
    if c % BLOCK != 0:
        raise ValueError(f"candidate axis {c} is not a {BLOCK} multiple")
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
    sel_s = key_score(pool[..., :k])
    kplus = torch.minimum(rem, key_score(pool[..., k]))
    cert = kplus >= sel_s[..., k - 1] + 2.0 * err_b
    return key_id(pool[..., :k]), sel_s, cert


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
        raise ValueError(
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
            raise ValueError(
                f"select: {name} must be a contiguous {dt} tensor of shape "
                f"{shape} on {queries.device}, got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
    if d < 1 or n_c == 0 or n_c % BLOCK != 0:
        raise ValueError(
            f"select: need d >= 1 and a positive multiple of {BLOCK} "
            f"candidates (callers pad), got d={d}, C={n_c}")
    for name, v in (("k", k), ("m", m), ("d_real", d_real)):
        if isinstance(v, bool) or int(v) < 1:
            raise ValueError(f"select: {name} must be >= 1, got {v}")
    check_precision(precision)
    return n_q, n_c, d


def select_plain(queries, q_ids, pts_il, cid_il, k: int, m: int,
                 d_real: int, exclude_self: bool, precision: str = "f32"):
    """The brute route's selection in plain torch (same arguments and
    results as ``mxu.kernel.select``).

    queries (M, d) and candidates (C, d) f32, C a BLOCK multiple laid out
    in interleaved blocks; ``q_ids`` the id each query excludes under
    ``exclude_self``; ``cid_il`` candidate ids, -1 on pads.  Every query
    is scored against every candidate (chunked over queries), masked, and
    folded (:func:`block_fold`) with the error band of the f32 norms, d =
    ``d_real`` and ``pn_max`` the largest f32 norm of a real candidate (at
    least 0).  Returns (ids (M, k) int32, scores (M, k) f32, certified
    (M,) bool)."""
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
                                cert_band_precision(precision))
        out_i[r0:r0 + step], out_s[r0:r0 + step], cert[r0:r0 + step] = \
            block_fold(s, cid_il.expand(s.shape), k, m, err_b)
    return out_i, out_s, cert
