"""The brute route: all-points (or external-query) kNN for any d, exact or
recall-bounded.

Counterpart of ``cuda_knearests_tpu/mxu/solve.py``.  Every query is scored
against every stored point by the selection kernel (``mxu/kernel.py``:
``csrc/mxu_select.cu``, or ``csrc/mxu_select_bf16.cu`` at bf16, and
``csrc/mxu_select_split.cu`` for the k their blocks do not hold) under
the TPU-KNN per-block fold at ``recall_target``, with per-row
certificates.  The solve then follows the
one-sync discipline of ``api._finalize``: one batched fetch of the
selection (ids and certificates), exact distances computed on the host
(:func:`_host_rescore`), and one more fetch only when uncertified rows go
to the exact brute fallback.  At ``recall_target=1.0`` the fold is
exhaustive and the certificate strict about dot-form rounding, so the
answer is byte-identical to the exact elementwise path.

Everything runs on the GPU unless ``device='cpu'`` is passed.  A seeded
fault (``KNTPU_MXU_FAULT``, :func:`parse_fault`; the approx fuzz
campaign's self-test) runs the selection's plain version,
``scorer.select_plain``, on the given device instead of the kernels:
only then, and never as a fallback.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..config import resolve_precision, resolve_scorer
from ..io import validate_or_raise
from ..ops.query import brute_force_by_coords
from ..ops.solve import brute_force_by_index
from ..runtime import dispatch
from ..utils.memory import InvalidConfigError, InvalidShapeError
from ..utils.platform import resolve_device
from ..utils.profiling import annotate
from . import kernel
from .scorer import FAULTS, select_plain
from .topk import BLOCK, interleave_slots, per_block_m, recall_bound

_FAULT_ENV = "KNTPU_MXU_FAULT"


def parse_fault(spec: Optional[str] = None) -> Optional[str]:
    """The seeded-fault knob
    (``KNTPU_MXU_FAULT=drop-block|skip-certify|narrow-bound``); an unknown
    value raises, so a mistyped fault never runs a clean campaign that
    would 'prove' the detectors fire."""
    spec = os.environ.get(_FAULT_ENV, "") if spec is None else spec
    spec = (spec or "").strip()
    if not spec:
        return None
    if spec not in FAULTS:
        raise InvalidConfigError(
            f"unknown {_FAULT_ENV} value {spec!r}: expected one of {FAULTS}")
    return spec


@dataclasses.dataclass(frozen=True)
class MxuResult:
    """One brute-route solve's answer and its approximation ledger.

    neighbors/dists_sq are in original point indexing, rows ascending by
    (d2, id), -1/inf beyond the available neighbours; every row's
    distances come from the one host realization (``_host_rescore``).
    ``certified`` marks rows whose selection was proven a true top-k set;
    after refinement every row is certified and ``uncert_count`` records
    how many needed the fallback.  ``bound`` is the expected-recall lower
    bound of the (n_blocks, m) fold.  ``backend`` names the selection's
    route (``kernel.select_routed``): 'cuda' (the one-block kernel of the
    tier), 'cuda_split' (the split selection, where that kernel's launch
    gate refuses the shape), 'plain' (the plain version: on the CPU, or
    under a seeded fault) or 'elementwise' (the exact brute selection)."""

    neighbors: np.ndarray
    dists_sq: np.ndarray
    certified: np.ndarray
    uncert_count: int
    bound: float
    m: int
    n_blocks: int
    backend: str
    precision: str = "f32"


def _host_rescore(points: np.ndarray, queries: np.ndarray,
                  sel_i: np.ndarray):
    """Exact 'diff' distances and the final (d2, id) order of a fetched
    selection, in host numpy: strict IEEE float32 at every shape, one
    subtract-square-accumulate over axes 0..d-1, so every route's rows
    land on the same bits.  Returns ((m, k) int32 ids ascending by
    (d2, id), -1 pads; (m, k) f32 d2, inf pads)."""
    valid = sel_i >= 0
    c = points[np.where(valid, sel_i, 0)]           # (m, k, d)
    d2 = np.zeros(sel_i.shape, np.float32)
    for ax in range(points.shape[1]):
        diff = queries[:, None, ax] - c[..., ax]
        d2 += diff * diff
    d2 = np.where(valid, d2, np.float32(np.inf)).astype(np.float32)
    ids = np.where(valid, sel_i, -1).astype(np.int32)
    order = np.lexsort((ids, d2), axis=1)
    return (np.take_along_axis(ids, order, axis=1),
            np.take_along_axis(d2, order, axis=1))


def select_inputs(points: np.ndarray, m_q: int, exclude_self: bool):
    """The selection kernel's host inputs for (n, d) stored points and m_q
    queries: (q_ids (m_q,), pts_il (c_pad, d), cid_il (c_pad,)).
    Candidates are padded to a multiple of BLOCK and interleaved across
    blocks (topk.interleave_slots: adjacent storage slots land in different
    blocks); pads carry id -1 and zero coordinates (masked by id; far
    coordinates would overflow the dot form).  Query i excludes stored id
    i under ``exclude_self`` (the self-solve), nothing otherwise."""
    n, d = points.shape
    c_pad = -(-n // BLOCK) * BLOCK
    il = interleave_slots(c_pad)
    pts_pad = np.zeros((c_pad, d), np.float32)
    pts_pad[:n] = points
    cid = np.full((c_pad,), -1, np.int32)
    cid[:n] = np.arange(n, dtype=np.int32)
    qid = (np.arange(m_q, dtype=np.int32) if exclude_self
           else np.full((m_q,), -1, np.int32))
    return qid, pts_pad[il], cid[il]


def warm(precision: str = "auto", device=None) -> None:
    """Load the selection library that :func:`solve_general` launches at
    ``precision`` on ``device`` (nothing on the CPU), so that a later
    solve at that tier builds and loads nothing."""
    if resolve_device(device).type == "cuda":
        kernel.load(resolve_precision(precision, "mxu"))


def solve_general(points, k: int = 10, recall_target: float = 1.0,
                  exclude_self: bool = True, refine: str = "brute",
                  queries=None, interpret: bool = False,
                  scorer: str = "mxu", precision: str = "auto",
                  query_chunk: Optional[int] = None, *,
                  device=None) -> MxuResult:
    """All-points (or external-``queries``) kNN through the brute route.

    ``points`` is (n, d) for any d >= 1.  ``scorer`` picks the selection:
    'mxu' (the per-block fold of the selection kernel), 'elementwise' (the
    exact brute selection, ``ops.solve.brute_force_by_index``) or 'auto'
    (``config.resolve_scorer``).  Every row realizes its distances through
    ``_host_rescore``, so 'mxu' at ``recall_target=1.0`` is byte-identical
    to 'elementwise'.  ``refine='brute'`` resolves uncertified rows exactly
    (one more batched fetch); 'none' returns the approximation with its
    certificates.  ``precision`` is the scoring tier ('f32', 'bf16', or
    'auto' -> f32); certified rows are exact at every tier.  Runs on the
    GPU unless ``device='cpu'``; on the GPU the selection launches the
    tier's one-block kernel where its launch gate takes (d, k, m) and
    otherwise the split selection (``backend='cuda_split'``), as the
    reference sends the shapes its kernel does not hold to its XLA
    twin.

    The parameters are the reference's, in its order.  ``interpret``
    takes only False: True (the reference's Pallas interpret mode) raises
    ``InvalidConfigError``, as ``KnnConfig`` refuses it.  ``query_chunk``
    (None or <= 0: one selection launch) splits the queries into chunks
    of that many rows, one launch each; every row's selection depends on
    its own query alone, so the answer is byte-identical to the unchunked
    one."""
    if interpret:
        raise InvalidConfigError(
            "interpret=True is the reference's Pallas interpret mode; the "
            "port has no interpret mode (CPU tensors run the selection's "
            "plain version): pass interpret=False")
    if refine not in ("brute", "none"):
        raise InvalidConfigError(
            f"unknown refine {refine!r}: 'brute' or 'none'")
    scorer = resolve_scorer(scorer, recall_target, precision)
    try:
        precision = resolve_precision(precision, scorer)
    except ValueError as e:
        raise InvalidConfigError(str(e)) from e
    points = validate_or_raise(points, k=k, dims=None)
    n, d = points.shape
    self_solve = queries is None
    if self_solve:
        queries_v = points
    else:
        queries_v = validate_or_raise(queries, k=k, dims=None,
                                      what="queries")
        if queries_v.shape[1] != d:
            raise InvalidShapeError(
                f"queries are (m, {queries_v.shape[1]}) but the stored "
                f"points are (n, {d}) (input contract: one d per problem)")
        exclude_self = False
    device = resolve_device(device)
    m_q = queries_v.shape[0]
    if n == 0 or m_q == 0:
        backend = "cuda" if device.type == "cuda" else "plain"
        return MxuResult(
            neighbors=np.full((m_q, k), -1, np.int32),
            dists_sq=np.full((m_q, k), np.inf, np.float32),
            certified=np.ones((m_q,), bool), uncert_count=0, bound=1.0,
            m=0, n_blocks=0, backend=backend, precision=precision)

    pts_dev = dispatch.stage(points, device)
    q_dev = pts_dev if self_solve else dispatch.stage(queries_v, device)

    def brute(rows: np.ndarray):
        """Exact selection of the given query rows: ids only."""
        rows_dev = dispatch.stage(rows, device)
        if self_solve:
            return brute_force_by_index(pts_dev, rows_dev, k,
                                        exclude_self)[0]
        return brute_force_by_coords(pts_dev, q_dev[rows_dev.long()], k)[0]

    if scorer == "elementwise":
        (b_i,) = dispatch.fetch(brute(np.arange(m_q, dtype=np.int32)))
        ids, d2 = _host_rescore(points, queries_v, b_i)
        return MxuResult(neighbors=ids, dists_sq=d2,
                         certified=np.ones((m_q,), bool), uncert_count=0,
                         bound=1.0, m=0, n_blocks=0, backend="elementwise",
                         precision="f32")

    g = -(-n // BLOCK)
    m = per_block_m(recall_target, k, g)
    bound = recall_bound(k, g, m)
    qid, pts_il, cid_il = select_inputs(points, m_q, exclude_self)
    qid_dev = dispatch.stage(qid, device)
    cands = (dispatch.stage(pts_il, device), dispatch.stage(cid_il, device),
             k, m, d, exclude_self, precision)
    step = (int(query_chunk) if query_chunk is not None
            and int(query_chunk) > 0 else m_q)
    fault = parse_fault()
    parts = []
    with annotate("kntpu:mxu-select"):
        for r0 in range(0, m_q, step):
            args = (q_dev[r0:r0 + step], qid_dev[r0:r0 + step], *cands)
            if fault is None:
                backend, part = kernel.select_routed(*args)
            else:
                backend, part = "plain", select_plain(*args, fault=fault)
            parts.append(part)
    sel_i = torch.cat([p[0] for p in parts])
    cert_d = torch.cat([p[2] for p in parts])

    ids_sel, cert = dispatch.fetch(sel_i, cert_d)
    ids, d2 = _host_rescore(points, queries_v, ids_sel)
    cert = np.array(cert)
    n_unc = int((~cert).sum())
    if refine == "brute" and n_unc:
        bad = np.nonzero(~cert)[0].astype(np.int32)
        with annotate("kntpu:mxu-refine"):
            (b_i,) = dispatch.fetch(brute(bad))
        ids[bad], d2[bad] = _host_rescore(points, queries_v[bad], b_i)
        cert[bad] = True
    return MxuResult(neighbors=ids, dists_sq=d2, certified=cert,
                     uncert_count=n_unc, bound=bound, m=m, n_blocks=g,
                     backend=backend, precision=precision)


def knn(points, k: int = 10, recall_target: float = 1.0,
        device=None) -> np.ndarray:
    """One call: exact (or recall-bounded, with uncertified rows refined
    exactly) all-points kNN of (n, d) points, in original indexing."""
    return solve_general(points, k=k, recall_target=recall_target,
                         device=device).neighbors
