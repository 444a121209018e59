"""The brute route's selection kernels: CUDA wrappers and launch gates.

Counterpart of ``cuda_knearests_tpu/mxu/kernel.py`` (``select_pallas``).
:func:`select` takes the queries, the interleaved candidates and their ids
and returns every query's selection and certificate:

  * on CUDA tensors it launches, at f32, two prep passes and the
    register-tiled CUDA-core selection of ``csrc/mxu_select.cu`` (bit for
    bit the plain version) or, at bf16, two prep passes and the
    tensor-core selection of ``csrc/mxu_select_bf16.cu`` (norms bit for
    bit, q.p within the certification band: see that source's contract),
    or raises;
  * where those kernels' gate refuses the shape, it launches two prep
    passes and the split selection of ``csrc/mxu_select_split.cu`` (a
    two-pass radix selection over candidates rescored on each pass, or,
    at m < 128 or wide d, over a pool the fold writes to device memory;
    bit for bit the plain version at both tiers), or raises;
  * on CPU tensors it runs ``scorer.select_plain``, the same function in
    plain torch with the same per-op rounding.

The TPU kernel kept the candidate set and a (G*m, 128) pool in VMEM and
was gated on fitting it (``kernel_fits``); the reference sends the shapes
it refuses to ``solve_blocks_xla``.  The one-block kernels here stream
candidates, and queries too when d is large, and keep per-query lists in
shared memory, so their only gate is shared memory per block
(:func:`pick_launch`, :func:`pick_launch_bf16`; both accept the same (d,
k, m): every d, and k up to what a 16-row bf16 block's lists hold),
refused with a typed :class:`LaunchBudgetError`.  The split selection
keeps its lists in device memory and takes the shapes they refuse
(:func:`select_routed` names the route that ran).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import _build
from ..ops.cuda_solve import SMEM_LIMIT, KernelLaunchError
from ..utils.memory import LaunchBudgetError
from .scorer import check_select_args, norms, select_plain
from .topk import BLOCK, dot_error_bound

# Candidates per step of both selection kernels (kCols in the sources).
_COLS = 64
# f32 kernel: query rows (= threads) per block, widest first; the most
# bytes of a block's query rows kept resident in shared memory for the
# launch; axes per d-chunk of the candidates with the queries resident, and
# of both when the queries stream (wider rows stream, which leaves room for
# three blocks on an SM).
_ROWS = (128, 64, 32, 16)
_QRES_BYTES = 32 * 1024
_KC_F32_RESIDENT = 32
_KC_F32_STREAM = 16

# bf16 kernel: query rows per block, widest first (16: one warp of 16
# rows, for lists too long for 32); widest d-chunk of the candidates with
# the queries resident, and the d-chunk of both when the queries stream.
_ROWS_BF16 = (128, 64, 32, 16)
_KC_RESIDENT = 128
_KC_STREAM = 64

# Split selection.  Its direct arm (m >= BLOCK, the fold keeps every key,
# d up to _SPLIT_DIRECT_MAX_D and rows up to _SPLIT_DIRECT_MAX_KEYS, its
# 16-bit row counts) rescores the candidates on each pass of its two-pass
# selection and writes no pool: _SPLIT_DIRECT_QUERIES queries a block,
# rows of up to _SPLIT_DIRECT_SMEM_KEYS keys sorted in shared memory,
# wider ones in device scratch rows.  Its pool arm (m < BLOCK, or wider d,
# where rescoring costs more than reading 8 bytes a key) folds to a device
# pool and selects from it, rows of up to _SPLIT_SMEM_KEYS keys in shared
# memory.  _SPLIT_DIRECT_MAX_D is where the two arms' device times cross,
# linear in d between one measurement of both at d=3 (20k points, k=1,800)
# and d=128 (k=1,600) on an H100 (PERF.md, "PR 9").  A launch's pool, rem
# and scratch take at most _SPLIT_CHUNK_BYTES (the direct arm chunks only
# for scratch) and, in the pool arm, at most _SPLIT_MAX_ROWS queries (the
# fold's grid height times 8).  The constants mirror the source's
# kSmemSortKeys, kDirectQ, kDirectSmemKeys and kDirectMaxKeys.
_SPLIT_DIRECT_MAX_D = 14
_SPLIT_DIRECT_QUERIES = 4
_SPLIT_DIRECT_SMEM_KEYS = 2048
_SPLIT_DIRECT_MAX_KEYS = 32768
_SPLIT_SMEM_KEYS = 8192
_SPLIT_CHUNK_BYTES = 256 << 20
_SPLIT_MAX_ROWS = 65535 * 8
# Bins of the split selection's pass counts (kMaxPasses in the source).
SPLIT_MAX_PASSES = 16

# Kernel launches (CUDA tensors only): the f32 selection kernel, the bf16
# selection kernel, the split selection (one a call of its direct arm,
# one a chunk of queries of its pool arm), and the prep passes of each
# tier (two per selection: ``prep_launches_f32`` for the f32 tier,
# ``prep_launches`` for bf16; the split selection's count with its
# tier's).
launches = 0
launches_bf16 = 0
split_launches = 0
prep_launches = 0
prep_launches_f32 = 0


def smem_bytes(d: int, k: int, m: int, rows: int, kc: int,
               qres: bool) -> int:
    """Shared memory of one f32 selection block: the query rows (all d
    axes when resident, else two d-chunks of kc), two candidate chunks of
    ``_COLS`` columns with their norms and ids, the score tile (row
    stride rows + 4) and each row's lists of k and, when the fold can
    matter (m < k and m < BLOCK), m.  Must match ``mxu_select_smem_bytes``
    in the source."""
    mb = 0 if (m >= k or m >= BLOCK) else m
    q = rows * d if qres else 2 * rows * kc
    return 4 * (q + 2 * _COLS * kc + 4 * _COLS
                + _COLS * (rows + 4) + 2 * (k + mb) * rows)


def pick_launch(d: int, k: int, m: int) -> Tuple[int, int, bool]:
    """(query rows per block, d-chunk, queries resident) of the f32
    kernel: the widest block that fits shared memory, its queries resident
    when they take at most ``_QRES_BYTES``, else streamed with the
    candidates in d-chunks of ``_KC_F32_STREAM`` axes (narrower in a
    16-row block, the last resort).

    It accepts exactly the (d, k, m) that :func:`pick_launch_bf16`
    accepts, so a shape the brute route answers at one precision it
    answers at the other: every d, and k up to what the lists of a 16-row
    bf16 block hold (an f32 block, with no bf16 staging, needs less).
    Raises :class:`LaunchBudgetError` beyond."""
    try:
        pick_launch_bf16(d, k, m)
    except LaunchBudgetError as e:
        raise LaunchBudgetError(
            f"mxu_select at d={d}, k={k}, m={m}: the brute route's lists "
            f"do not fit one block ({e})", requested=e.requested,
            budget=e.budget, site="mxu_select") from None
    for rows in _ROWS:
        plans = ([(True, min(d, _KC_F32_RESIDENT))]
                 if rows * d * 4 <= _QRES_BYTES else [])
        kcs = (_KC_F32_STREAM,) + ((8, 4, 2, 1) if rows == _ROWS[-1]
                                   else ())
        plans += [(False, min(d, kc)) for kc in kcs]
        for qres, kc in plans:
            if smem_bytes(d, k, m, rows, kc, qres) <= SMEM_LIMIT:
                return rows, kc, qres
    need = smem_bytes(d, k, m, _ROWS[-1], 1, False)
    raise LaunchBudgetError(
        f"mxu_select at d={d}, k={k}, m={m} needs {need} bytes of shared "
        f"memory for one 16-row block, above the {SMEM_LIMIT}-byte limit "
        f"of a Hopper block", requested=need, budget=SMEM_LIMIT,
        site="mxu_select")


def pad16(d: int) -> int:
    """d rounded up to a multiple of 16: the bf16 kernel's row width (the
    k depth of one mma.sync)."""
    return -(-int(d) // 16) * 16


def smem_bytes_bf16(d: int, k: int, m: int, rows: int, kc: int,
                    qres: bool) -> int:
    """Shared memory of one bf16 selection block: the query rows (all of
    d16 when resident, else two d-chunks of kc), two candidate chunks of
    ``_COLS`` rows with their norms and ids, the score tile (row stride
    rows + 4) and each row's lists of k and, when the fold can matter, m.
    Must match ``mxu_select_bf16_smem_bytes`` in the source."""
    mb = 0 if (m >= k or m >= BLOCK) else m
    q = rows * (pad16(d) + 8) if qres else 2 * rows * (kc + 8)
    p = 2 * _COLS * (kc + 8)
    return (2 * (q + p) + 16 * _COLS + 4 * _COLS * (rows + 4)
            + 8 * (k + mb) * rows)


def pick_launch_bf16(d: int, k: int, m: int) -> Tuple[int, int, bool]:
    """(query rows per block, d-chunk, queries resident) of the bf16
    kernel: the widest block that fits shared memory, with its queries
    resident when they fit, else streamed in d-chunks of ``_KC_STREAM``.
    Raises :class:`LaunchBudgetError` when even a 16-row block's lists do
    not fit (from k = 1,715 at d=3 with m = min(k, 128))."""
    d16 = pad16(d)
    for rows in _ROWS_BF16:
        for qres, kc in ((True, min(d16, _KC_RESIDENT)),
                         (False, min(d16, _KC_STREAM))):
            if smem_bytes_bf16(d, k, m, rows, kc, qres) <= SMEM_LIMIT:
                return rows, kc, qres
    need = smem_bytes_bf16(d, k, m, _ROWS_BF16[-1], min(d16, _KC_STREAM),
                           False)
    raise LaunchBudgetError(
        f"mxu_select_bf16 at d={d}, k={k}, m={m} needs {need} bytes of "
        f"shared memory for one 16-row block, above the {SMEM_LIMIT}-byte "
        f"limit of a Hopper block", requested=need, budget=SMEM_LIMIT,
        site="mxu_select_bf16")


def launch_plan(d: int, k: int, m: int, precision: str):
    """The tier's launch plan (:func:`pick_launch` at f32,
    :func:`pick_launch_bf16` at bf16), or None where its gate refuses
    (d, k, m) and the split selection runs instead: the route of a CUDA
    selection, decided by shape alone, as the reference's ``_use_kernel``
    decides by ``kernel_fits``."""
    gate = pick_launch_bf16 if precision == "bf16" else pick_launch
    try:
        return gate(d, k, m)
    except LaunchBudgetError:
        return None


def _lib() -> ctypes.CDLL:
    lib = _build.load("mxu_select")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mxu_select_prep_launch.argtypes = [p, p, i, i, i] + [p] * 4
        lib.mxu_select_prep_launch.restype = i
        lib.mxu_select_launch.argtypes = ([p, p, p, i] + [p] * 4 + [i] * 6
                                          + [ctypes.c_float, i, i, i]
                                          + [p] * 4)
        lib.mxu_select_launch.restype = i
        lib.mxu_select_error_string.argtypes = [i]
        lib.mxu_select_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _lib_bf16() -> ctypes.CDLL:
    lib = _build.load("mxu_select_bf16")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mxu_select_bf16_prep_launch.argtypes = [p, p, i, i, i] + [p] * 5
        lib.mxu_select_bf16_prep_launch.restype = i
        lib.mxu_select_bf16_launch.argtypes = ([p] * 8 + [i] * 6
                                               + [ctypes.c_float, i, i, i]
                                               + [p] * 5)
        lib.mxu_select_bf16_launch.restype = i
        lib.mxu_select_bf16_error_string.argtypes = [i]
        lib.mxu_select_bf16_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def load(precision: str) -> None:
    """Build (if needed) and load the one-block selection library of the
    tier (``csrc/mxu_select_bf16.cu`` at bf16, else ``mxu_select.cu``)."""
    (_lib_bf16 if precision == "bf16" else _lib)()


def _lib_split() -> ctypes.CDLL:
    lib = _build.load("mxu_select_split")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mxu_select_split_launch.argtypes = (
            [i, i, p, i, p, p, p, p, i, p, p, p] + [i] * 7
            + [ctypes.c_float, p, p, p, i] + [p] * 5)
        lib.mxu_select_split_launch.restype = i
        lib.mxu_select_split_error_string.argtypes = [i]
        lib.mxu_select_split_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def prep_plain(x: torch.Tensor, ids: Optional[torch.Tensor] = None):
    """The bf16 prep pass in plain torch: (xb (rows, d16) bf16, the
    coordinates rounded to bf16 and zero padded; ns, the bf16 scoring
    norms; nf, the f32 norms; pn_max (1,) f32, the largest nf of a real id
    (>= 0), or None without ``ids``) -- the casts and
    :func:`scorer.norms` that ``select_plain`` uses."""
    rows, d = x.shape
    xb = torch.zeros((rows, pad16(d)), dtype=torch.bfloat16,
                     device=x.device)
    xb[:, :d] = x.to(torch.bfloat16)
    nf = norms(x)
    pn_max = None
    if ids is not None:
        pn_max = torch.clamp(torch.where(ids >= 0, nf, float("-inf"))
                             .amax(), min=0.0).reshape(1)
    return xb, norms(x, "bf16"), nf, pn_max


def prep(x: torch.Tensor, ids: Optional[torch.Tensor] = None):
    """The bf16 prep pass of (rows, d) f32 ``x`` (and its int32 ``ids``,
    for candidates): :func:`prep_plain`'s outputs.  CPU tensors run
    :func:`prep_plain`; CUDA tensors launch the kernel or raise."""
    global prep_launches
    if x.device.type == "cpu":
        return prep_plain(x, ids)
    rows, d = x.shape
    dev = x.device
    xb = torch.empty((rows, pad16(d)), dtype=torch.bfloat16, device=dev)
    ns = torch.empty((rows,), dtype=torch.float32, device=dev)
    nf = torch.empty((rows,), dtype=torch.float32, device=dev)
    pn_max = (torch.zeros((1,), dtype=torch.float32, device=dev)
              if ids is not None else None)
    lib = _lib_bf16()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mxu_select_bf16_prep_launch(
            x.data_ptr(), None if ids is None else ids.data_ptr(), rows, d,
            pad16(d), xb.data_ptr(), ns.data_ptr(), nf.data_ptr(),
            None if pn_max is None else pn_max.data_ptr(), stream)
    if rc != 0:
        raise KernelLaunchError(
            f"mxu_select_bf16 prep launch failed: "
            f"{lib.mxu_select_bf16_error_string(rc).decode()} (code {rc}; "
            f"rows={rows} d={d})")
    prep_launches += 1
    return xb, ns, nf, pn_max


def _ld(rows: int) -> int:
    """Columns of an axis-major operand: ``rows`` rounded up to 128, so
    every block streams whole 16-byte groups."""
    return -(-int(rows) // 128) * 128


def prep_f32_plain(x: torch.Tensor, ids: Optional[torch.Tensor] = None):
    """The f32 prep pass in plain torch: (xT (d, ld) f32, the coordinates
    axis-major with zero columns from rows to ld = rows rounded up to
    128; nf, the f32 norms; pn_max (1,) f32, the largest nf of a real id
    (>= 0), or None without ``ids``) -- the :func:`scorer.norms` that
    ``select_plain`` uses."""
    rows, d = x.shape
    xT = torch.zeros((d, _ld(rows)), dtype=torch.float32, device=x.device)
    xT[:, :rows] = x.T
    nf = norms(x)
    pn_max = None
    if ids is not None:
        pn_max = torch.clamp(torch.where(ids >= 0, nf, float("-inf"))
                             .amax(), min=0.0).reshape(1)
    return xT, nf, pn_max


def prep_f32(x: torch.Tensor, ids: Optional[torch.Tensor] = None):
    """The f32 prep pass of (rows, d) f32 ``x`` (and its int32 ``ids``,
    for candidates): :func:`prep_f32_plain`'s outputs.  CPU tensors run
    :func:`prep_f32_plain`; CUDA tensors launch the kernel or raise."""
    global prep_launches_f32
    if x.device.type == "cpu":
        return prep_f32_plain(x, ids)
    rows, d = x.shape
    dev = x.device
    ld = _ld(rows)
    xT = torch.empty((d, ld), dtype=torch.float32, device=dev)
    nf = torch.empty((rows,), dtype=torch.float32, device=dev)
    pn_max = (torch.zeros((1,), dtype=torch.float32, device=dev)
              if ids is not None else None)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mxu_select_prep_launch(
            x.data_ptr(), None if ids is None else ids.data_ptr(), rows, d,
            ld, xT.data_ptr(), nf.data_ptr(),
            None if pn_max is None else pn_max.data_ptr(), stream)
    if rc != 0:
        raise KernelLaunchError(
            f"mxu_select prep launch failed: "
            f"{lib.mxu_select_error_string(rc).decode()} (code {rc}; "
            f"rows={rows} d={d})")
    prep_launches_f32 += 1
    return xT, nf, pn_max


def select(queries: torch.Tensor, q_ids: torch.Tensor, pts_il: torch.Tensor,
           cid_il: torch.Tensor, k: int, m: int, d_real: int,
           exclude_self: bool, precision: str = "f32"):
    """Every query's selection of the per-block fold, and its certificate.

    queries (M, d) f32, q_ids (M,) int32 (the id each query excludes
    under ``exclude_self``), interleaved candidates pts_il (C, d) f32 with
    C a multiple of 128, cid_il (C,) int32 (-1 on pads); each 128-slot
    block keeps its first ``m``, ``d_real`` sizes the error band and
    ``precision`` is 'f32' or 'bf16'.  Returns (ids (M, k) int32 by
    ascending (score, id), scores (M, k) f32, certified (M,) bool);
    missing entries are (-1, inf).  :func:`select_routed` without the
    route's name."""
    return select_routed(queries, q_ids, pts_il, cid_il, k, m, d_real,
                         exclude_self, precision)[1]


def select_routed(queries: torch.Tensor, q_ids: torch.Tensor,
                  pts_il: torch.Tensor, cid_il: torch.Tensor, k: int, m: int,
                  d_real: int, exclude_self: bool, precision: str = "f32"):
    """:func:`select`'s outputs with the route that computed them:
    (route, (ids, scores, certified)).

    CPU tensors run the plain version (route 'plain') and never consult
    a gate.  CUDA tensors launch the tier's one-block kernel on the
    current stream when its gate takes (d, k, m) (:func:`launch_plan`;
    route 'cuda'), else the split selection (:func:`select_split`; route
    'cuda_split'), as the reference sends the shapes its kernel cannot
    hold to ``solve_blocks_xla``.  The route is chosen by shape before any
    launch; a failed build or launch raises, with no fallback."""
    check_select_args(queries, q_ids, pts_il, cid_il, k, m, d_real,
                      precision)
    k, m = int(k), int(m)
    d = queries.shape[1]
    device = queries.device
    if device.type == "cpu":
        return "plain", select_plain(queries, q_ids, pts_il, cid_il, k, m,
                                     d_real, exclude_self, precision)
    if device.type != "cuda":
        raise ValueError(f"select runs on CPU or CUDA tensors, got {device}")
    plan = launch_plan(d, k, m, precision)
    if plan is None:
        return "cuda_split", _launch_split(queries, q_ids, pts_il, cid_il,
                                           k, m, d_real, exclude_self,
                                           precision)
    if precision == "bf16":
        return "cuda", _launch_bf16(queries, q_ids, pts_il, cid_il, k, m,
                                    d_real, exclude_self, plan, None)
    return "cuda", _launch_f32(queries, q_ids, pts_il, cid_il, k, m, d_real,
                               exclude_self, plan)


def select_split(queries: torch.Tensor, q_ids: torch.Tensor,
                 pts_il: torch.Tensor, cid_il: torch.Tensor, k: int, m: int,
                 d_real: int, exclude_self: bool, precision: str = "f32", *,
                 arm: Optional[str] = None,
                 passes: Optional[torch.Tensor] = None):
    """:func:`select` through the split selection at any (d, k, m), the
    shapes the gate takes included: CPU tensors run the plain version,
    CUDA tensors launch the kernel or raise.  For measurements: ``arm``
    ('direct' or 'pool') overrides :func:`split_arm`, and ``passes``, a
    (SPLIT_MAX_PASSES,) int32 CUDA tensor, gains at [p] the number of
    selection blocks that made p passes over their keys."""
    check_select_args(queries, q_ids, pts_il, cid_il, k, m, d_real,
                      precision)
    if queries.device.type == "cpu":
        return select_plain(queries, q_ids, pts_il, cid_il, int(k), int(m),
                            d_real, exclude_self, precision)
    if queries.device.type != "cuda":
        raise ValueError(f"select runs on CPU or CUDA tensors, got "
                         f"{queries.device}")
    return _launch_split(queries, q_ids, pts_il, cid_il, int(k), int(m),
                         d_real, exclude_self, precision, arm, passes)


class SplitPlan(NamedTuple):
    """The split selection's geometry: its arm ('direct' or 'pool'), the
    queries of one launch, the pool keys a query (0 in the direct arm),
    the sort width n2 and whether the rows are sorted in device scratch."""
    arm: str
    rows: int
    p_len: int
    n2: int
    scratch: bool


def split_arm(d: int, k: int, m: int) -> str:
    """'direct' where the fold keeps every key (m >= BLOCK), rescoring a
    pair costs less than reading its pool key (d <= ``_SPLIT_DIRECT_MAX_D``)
    and the sort width fits its 16-bit row counts (at most
    ``_SPLIT_DIRECT_MAX_KEYS``), else 'pool'."""
    n2 = 1 << int(k).bit_length()
    return ("direct" if int(m) >= BLOCK and int(d) <= _SPLIT_DIRECT_MAX_D
            and n2 <= _SPLIT_DIRECT_MAX_KEYS else "pool")


def split_plan(n_q: int, n_c: int, d: int, k: int, m: int,
               arm: Optional[str] = None) -> SplitPlan:
    """The split selection's :class:`SplitPlan` (``arm`` defaults to
    :func:`split_arm`).  n2 is the power of two above k.  Direct arm: no
    pool, rows of n2 keys in shared memory up to
    ``_SPLIT_DIRECT_SMEM_KEYS``, one launch for all queries unless the rows
    go to scratch.  Pool arm: each 128-slot block's first min(m, 128)
    keys, rows in shared memory up to ``_SPLIT_SMEM_KEYS``.  Scratch rows
    (and the pool and rem) of a launch take at most ``_SPLIT_CHUNK_BYTES``
    (one query at least)."""
    arm = split_arm(d, k, m) if arm is None else arm
    if arm not in ("direct", "pool"):
        raise ValueError(f"split arm must be 'direct' or 'pool', got {arm!r}")
    n2 = 1 << int(k).bit_length()
    if arm == "direct" and (int(m) < BLOCK or n2 > _SPLIT_DIRECT_MAX_KEYS):
        raise ValueError(f"the direct arm keeps every key in rows of at "
                         f"most {_SPLIT_DIRECT_MAX_KEYS}: it needs m >= "
                         f"{BLOCK} and k < {_SPLIT_DIRECT_MAX_KEYS}, got "
                         f"m={m}, k={k}")
    if arm == "direct":
        scratch = n2 > _SPLIT_DIRECT_SMEM_KEYS
        rows = (max(1, min(int(n_q), _SPLIT_CHUNK_BYTES // (8 * n2)))
                if scratch else max(1, int(n_q)))
        return SplitPlan(arm, rows, 0, n2, scratch)
    g = n_c // BLOCK
    me = min(int(m), BLOCK)
    p_len = g * me
    scratch = n2 > _SPLIT_SMEM_KEYS
    row_bytes = (8 * p_len + (4 * g if me < BLOCK else 0)
                 + (8 * n2 if scratch else 0))
    rows = max(1, min(int(n_q), _SPLIT_MAX_ROWS,
                      _SPLIT_CHUNK_BYTES // row_bytes))
    return SplitPlan(arm, rows, p_len, n2, scratch)


def _launch_split(queries, q_ids, pts_il, cid_il, k: int, m: int,
                  d_real: int, exclude_self: bool, precision: str,
                  arm: Optional[str] = None,
                  passes: Optional[torch.Tensor] = None):
    """The split selection on CUDA tensors: the tier's two prep passes,
    then one launch for each chunk of queries (``split_plan``; the direct
    arm's one chunk, or the pool arm's fold and selection), one
    ``split_launches`` a launch."""
    global split_launches
    n_q, n_c = queries.shape[0], pts_il.shape[0]
    d = queries.shape[1]
    device = queries.device
    out_i, out_s, cert = _outputs(n_q, k, device)
    if n_q == 0:
        return out_i, out_s, cert
    if passes is not None and (passes.device != device
                               or passes.dtype != torch.int32
                               or tuple(passes.shape) != (SPLIT_MAX_PASSES,)):
        raise ValueError(f"passes must be a ({SPLIT_MAX_PASSES},) int32 "
                         f"tensor on {device}")
    plan = split_plan(n_q, n_c, d, k, m, arm)
    lib = _lib_split()
    bf16 = precision == "bf16"
    coef = float(dot_error_bound(1.0, 0.0, int(d_real), precision))
    if bf16:
        qx, qns, qnf, _ = prep(queries)
        px, pns, _, pn_max = prep(pts_il, cid_il)
        ldq = ldp = pad16(d)
    else:
        qx, qnf, _ = prep_f32(queries)
        px, pns, pn_max = prep_f32(pts_il, cid_il)
        qns, ldq, ldp = qnf, qx.shape[1], px.shape[1]
    rows, direct = plan.rows, plan.arm == "direct"
    g = n_c // BLOCK
    pool = (None if direct else
            torch.empty((rows, plan.p_len), dtype=torch.int64, device=device))
    rem = (torch.empty((rows, g), dtype=torch.float32, device=device)
           if not direct and m < BLOCK else None)
    scratch = (torch.empty((rows, plan.n2), dtype=torch.int64, device=device)
               if plan.scratch else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for r0 in range(0, n_q, rows):
            n_rows = min(rows, n_q - r0)
            rc = lib.mxu_select_split_launch(
                int(direct), int(bf16), qx.data_ptr(), ldq, qns.data_ptr(),
                qnf.data_ptr(), q_ids.data_ptr(), px.data_ptr(), ldp,
                pns.data_ptr(), cid_il.data_ptr(), pn_max.data_ptr(), r0,
                n_rows, n_c, d, k, m, int(bool(exclude_self)), coef,
                None if pool is None else pool.data_ptr(),
                None if rem is None else rem.data_ptr(),
                None if scratch is None else scratch.data_ptr(), plan.n2,
                out_i.data_ptr(), out_s.data_ptr(), cert.data_ptr(),
                None if passes is None else passes.data_ptr(), stream)
            if rc != 0:
                raise KernelLaunchError(
                    f"mxu_select_split launch failed: "
                    f"{lib.mxu_select_split_error_string(rc).decode()} "
                    f"(code {rc}; {plan.arm} arm, M={n_q} C={n_c} d={d} "
                    f"k={k} m={m} rows {r0}+{n_rows} n2={plan.n2})")
            split_launches += 1
    return out_i, out_s, cert


def _launch_f32(queries, q_ids, pts_il, cid_il, k: int, m: int,
                d_real: int, exclude_self: bool, plan):
    """The f32 tier on CUDA tensors: both prep passes, then the CUDA-core
    selection with launch ``plan`` (pick_launch)."""
    global launches
    n_q, n_c = queries.shape[0], pts_il.shape[0]
    d = queries.shape[1]
    device = queries.device
    out_i, out_s, cert = _outputs(n_q, k, device)
    if n_q == 0:
        return out_i, out_s, cert
    rows, kc, qres = plan
    coef = float(dot_error_bound(1.0, 0.0, int(d_real), "f32"))
    lib = _lib()
    qT, qnf, _ = prep_f32(queries)
    pT, pnf, pn_max = prep_f32(pts_il, cid_il)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mxu_select_launch(
            qT.data_ptr(), qnf.data_ptr(), q_ids.data_ptr(), qT.shape[1],
            pT.data_ptr(), pnf.data_ptr(), cid_il.data_ptr(),
            pn_max.data_ptr(), n_q, n_c, d, k, m, int(bool(exclude_self)),
            coef, rows, kc, int(qres), out_i.data_ptr(), out_s.data_ptr(),
            cert.data_ptr(), stream)
    if rc != 0:
        raise KernelLaunchError(
            f"mxu_select launch failed: "
            f"{lib.mxu_select_error_string(rc).decode()} (code {rc}; M={n_q} "
            f"C={n_c} d={d} k={k} m={m} rows={rows} kc={kc} qres={qres})")
    launches += 1
    return out_i, out_s, cert


def _outputs(n_q: int, k: int, device):
    return (torch.empty((n_q, k), dtype=torch.int32, device=device),
            torch.empty((n_q, k), dtype=torch.float32, device=device),
            torch.empty((n_q,), dtype=torch.bool, device=device))


def _launch_bf16(queries, q_ids, pts_il, cid_il, k: int, m: int,
                 d_real: int, exclude_self: bool, plan, scores):
    """The bf16 tier on CUDA tensors: both prep passes, then the
    tensor-core selection with launch ``plan`` (pick_launch_bf16);
    ``scores``, when not None, is an (M, C) f32 tensor the kernel fills
    with every score it computes."""
    global launches_bf16
    n_q, n_c = queries.shape[0], pts_il.shape[0]
    d = queries.shape[1]
    device = queries.device
    out_i, out_s, cert = _outputs(n_q, k, device)
    if n_q == 0:
        return out_i, out_s, cert
    rows, kc, qres = plan
    coef = float(dot_error_bound(1.0, 0.0, int(d_real), "bf16"))
    lib = _lib_bf16()
    qb, qns, qnf, _ = prep(queries)
    pb, pns, _, pn_max = prep(pts_il, cid_il)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mxu_select_bf16_launch(
            qb.data_ptr(), qns.data_ptr(), qnf.data_ptr(), q_ids.data_ptr(),
            pb.data_ptr(), pns.data_ptr(), cid_il.data_ptr(),
            pn_max.data_ptr(), n_q, n_c, pad16(d), k, m,
            int(bool(exclude_self)), coef, rows, kc, int(qres),
            out_i.data_ptr(), out_s.data_ptr(), cert.data_ptr(),
            None if scores is None else scores.data_ptr(), stream)
    if rc != 0:
        raise KernelLaunchError(
            f"mxu_select_bf16 launch failed: "
            f"{lib.mxu_select_bf16_error_string(rc).decode()} (code {rc}; "
            f"M={n_q} C={n_c} d={d} k={k} m={m} rows={rows} kc={kc} "
            f"qres={qres})")
    launches_bf16 += 1
    return out_i, out_s, cert


def _select_bf16_with_scores(queries, q_ids, pts_il, cid_il, k: int, m: int,
                             d_real: int, exclude_self: bool):
    """``select(..., precision='bf16')`` on CUDA tensors, plus the (M, C)
    f32 tile of every score the kernel computed, before masking: how the
    checks of the tensor-core sum measure delta_max against the plain
    tile (``scorer.score_band``).  No solve calls it."""
    n_q, n_c, d = check_select_args(queries, q_ids, pts_il, cid_il, k, m,
                                    d_real, "bf16")
    if queries.device.type != "cuda":
        raise ValueError(f"the bf16 score dump needs CUDA tensors, got "
                         f"{queries.device}")
    k, m = int(k), int(m)
    scores = torch.empty((n_q, n_c), dtype=torch.float32,
                         device=queries.device)
    out = _launch_bf16(queries, q_ids, pts_il, cid_il, k, m, d_real,
                       exclude_self, pick_launch_bf16(d, k, m), scores)
    return out + (scores,)
