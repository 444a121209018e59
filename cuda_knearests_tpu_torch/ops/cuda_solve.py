"""Kernel inputs and the supercell top-k kernels: CUDA wrappers and their
plain torch versions.

Counterpart of ``cuda_knearests_tpu/ops/pallas_solve.py``.  A capacity class
is packed once at prepare time (:func:`pack_inputs`): per supercell, its
query slots and its candidate slots, one coordinate axis per array, with
stored-point ids beside them and sentinel ids on pad slots.
:func:`supercell_topk` then selects, for every query slot, the first k
candidates of its supercell in (d2, stored id) order:

  * on CUDA tensors it launches ``csrc/supercell_topk.cu`` (or raises);
  * on CPU tensors it runs :func:`supercell_topk_plain`, the same function
    in plain torch with the same per-op rounding.

Output mode (a), ``tgt`` given, writes each slot's row straight into the
final (n, k) buffers at row ``tgt[slot]`` (pad slots carry an out-of-range
sentinel and are skipped): the reference's scatter epilogue fused into the
launch.  Mode (b) returns the raw (S, k, Q) layout of the reference's
``_kernel``.  Missing neighbours are ``(inf, -1)`` in both.

:func:`blocked_topk` (``csrc/blocked_topk.cu``, the reference's
``_kernel_blocked``) takes the same packs and modes and makes the same
selection in two stages: each 128-slot candidate block keeps its first m,
the row is the first k of that pool, and a row where some block rejected a
candidate nearer than the k-th entry (a deficit) carries NaN at column
k-1.  :func:`blocked_topk_plain` is its plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import sys
from typing import NamedTuple, Optional, Tuple

import torch

from ..runtime import dispatch
from ..utils.memory import LaunchBudgetError
from . import _build
from .solve import pack_cells
from .topk import INVALID_ID, pack_key, smallest_keys, unpack_key

# Sentinel ids of pad query / candidate slots.  Distinct negatives, so a
# pad query never "self-excludes" a pad candidate.
_PAD_Q = -2
_PAD_C = -3

# Shared memory one block may use on Hopper (H100/H200: 227 KB).
SMEM_LIMIT = 232_448
# The routing gate (pick_q_tile) keeps the arithmetic of the first class
# kernels' layout, a thread per query slot with its lists in shared
# memory: a 256-candidate tile and query slots per block, widest first.
_CAND_TILE = 256
_Q_TILES = (128, 64, 32)
# The class kernels (supercell_topk.cu, blocked_topk.cu, warp_topk.cuh):
# warps per block (kMaxWarps in the source), query slots per warp below
# which the block takes fewer warps, query slots per warp of a block's
# chunk (at most kMaxChunk = 128 slots a block), the most candidates staged
# at once (kMaxTile: 48 KB of 16-byte rows, so four 8-warp blocks -- 32
# warps -- share an SM's 228 KB; the blocked kernel stages a u16 slot
# beside each row, 18 bytes, and takes at most _BLOCKED_TILE so that four
# still fit), the list entries a lane may hold (their template
# instantiations: at most 32 * 28 = 896 a query, above the routing gate's
# 892), and their static shared memory as ptxas reports it on sm_90a (the
# bucket scan, the chunk's queries and their targets).
_TOPK_WARPS = 8
_TOPK_MIN_SLOTS_PER_WARP = 8
_TOPK_CHUNK_PER_WARP = 16
_TOPK_TILE = 3072
_BLOCKED_TILE = 2944
_LANE_ENTRIES = (1, 2, 4, 8, 16, 28)
_TOPK_STATIC_SMEM = 3232
# Fraction of the device's free memory one solve may commit to its packs
# and outputs.
_HBM_BUDGET_FRACTION = 0.8
# (query, candidate) pairs per chunk of the plain version.
_PLAIN_CHUNK_PAIRS = 1 << 24

# Kernel launches made by supercell_topk and by blocked_topk (CUDA tensors
# only), and of them the mode (b) launches.
launches = 0
blocked_launches = 0
launches_b = 0
blocked_launches_b = 0


class KernelLaunchError(RuntimeError):
    """The CUDA launch returned an error (refused or failed to start)."""


def smem_bytes(k: int, q_tile: int, m: int = 0) -> int:
    """Shared memory of one block of the per-thread-list layout: the
    candidate tile plus each thread's (d2, id) lists, of length k (and m
    for a per-block list)."""
    return 4 * _CAND_TILE * 4 + 2 * (k + m) * q_tile * 4


def pick_q_tile(k: int, qcap: int, m: int = 0) -> int:
    """Query slots per block of the per-thread-list layout: the widest
    tile (at most qcap rounded up to a warp) whose per-thread lists fit
    shared memory.  As a predicate it is the class kernels' routing gate
    (``adaptive.class_route``): :func:`topk_plan` takes exactly the (k,
    qcap, m) it accepts, k <= 892 for the one-stage kernel and k + m <=
    892 for the blocked kernel.  Raises :class:`LaunchBudgetError` when
    even one warp's lists do not fit."""
    for qt in _Q_TILES:
        if smem_bytes(k, qt, m) <= SMEM_LIMIT:
            return min(qt, max(32, -(-qcap // 32) * 32))
    site = "blocked_topk" if m else "supercell_topk"
    raise LaunchBudgetError(
        f"k={k}{f', m={m}' if m else ''} needs "
        f"{smem_bytes(k, _Q_TILES[-1], m)} bytes of shared memory for one "
        f"32-query block, above the {SMEM_LIMIT}-byte limit of a Hopper "
        f"block (largest supported k: "
        f"{(SMEM_LIMIT - smem_bytes(0, 32, m)) // (8 * 32)})",
        requested=smem_bytes(k, _Q_TILES[-1], m), budget=SMEM_LIMIT,
        site=site)


class TopkPlan(NamedTuple):
    """Launch geometry of a class kernel (``csrc/supercell_topk.cu``,
    ``csrc/blocked_topk.cu``): warps per block (one block per supercell
    and chunk of ``qchunk`` query slots, a warp owning one slot at a
    time), list entries per lane (32 * lane_entries >= k) and candidates
    staged in shared memory at once (a multiple of 32; a wider ccap
    streams in tiles of this many)."""

    warps: int
    lane_entries: int
    tile: int
    qchunk: int


def topk_plan(k: int, qcap: int, ccap: int, m: int = 0) -> TopkPlan:
    """The launch geometry of a class kernel: the one-stage kernel's, or
    with ``m`` > 0 the blocked kernel's at kept count m (the same warps,
    list width and query chunk; a tile of at most ``_BLOCKED_TILE``).  It
    takes exactly the (k, qcap, m) that :func:`pick_q_tile` takes (k <=
    892, and k + m <= 892 for the blocked kernel), and raises its
    :class:`LaunchBudgetError` beyond; every ccap runs (staged whole up to
    the tile, streamed in tiles above)."""
    pick_q_tile(k, qcap, m)
    entries = next(e for e in _LANE_ENTRIES if 32 * e >= k)
    warps = max(1, min(_TOPK_WARPS, -(-qcap // _TOPK_MIN_SLOTS_PER_WARP)))
    tile = min(_BLOCKED_TILE if m else _TOPK_TILE,
               max(32, -(-ccap // 32) * 32))
    return TopkPlan(warps, entries, tile, _TOPK_CHUNK_PER_WARP * warps)


def topk_smem_bytes(plan: TopkPlan, blocked: bool = False) -> int:
    """Shared memory of one block of a class kernel: the staged tile of
    16-byte (x, y, z, id) rows, and for the blocked kernel a u16 slot
    each.  Must match ``supercell_topk_smem_bytes`` and
    ``blocked_topk_smem_bytes`` in the sources."""
    return (18 if blocked else 16) * plan.tile


@dataclasses.dataclass(frozen=True)
class ClassPack:
    """Packed kernel inputs of one class: per-axis (S, qcap) query and
    (S, ccap) candidate coordinates, and their int32 stored-id arrays
    (``_PAD_Q`` / ``_PAD_C`` on pad slots)."""

    qx: torch.Tensor
    qy: torch.Tensor
    qz: torch.Tensor
    qid: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    cid: torch.Tensor

    def args(self):
        return (self.qx, self.qy, self.qz, self.qid,
                self.cx, self.cy, self.cz, self.cid)


def pack_inputs(points: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, own: torch.Tensor, cand: torch.Tensor,
                qcap: int, ccap: int) -> ClassPack:
    """CSR slot packing and coordinate gathers of one class, in kernel
    layout; pad slots get point-0 coordinates.  ``qid`` holds each query
    slot's stored point, so it doubles as the class's slot -> row map.

    Candidate slots are interleaved across 128-slot blocks exactly as the
    reference package packs them (slot r*G+g -> g*128+r), so the two
    packages' packs are equal; the selection does not depend on slot
    order."""
    s_total = own.shape[0]
    q_idx, q_ok = pack_cells(own, starts, counts, qcap)
    c_idx, c_ok = pack_cells(cand, starts, counts, ccap)
    g = ccap // 128
    if ccap % 128 == 0 and g > 1:
        c_idx = c_idx.reshape(s_total, 128, g).transpose(1, 2).reshape(
            s_total, ccap)
        c_ok = c_ok.reshape(s_total, 128, g).transpose(1, 2).reshape(
            s_total, ccap)
    axes = points.T
    qi, ci = q_idx.long(), c_idx.long()
    qx, qy, qz = (axes[ax][qi].contiguous() for ax in range(3))
    cx, cy, cz = (axes[ax][ci].contiguous() for ax in range(3))
    qid = torch.where(q_ok, q_idx, _PAD_Q).to(torch.int32)
    cid = torch.where(c_ok, c_idx, _PAD_C).to(torch.int32)
    return ClassPack(qx, qy, qz, qid, cx, cy, cz, cid)


def pack_bytes(n_sc: int, qcap: int, ccap: int) -> int:
    """Device bytes of one class's packed inputs and forward row map."""
    return 4 * n_sc * (4 * qcap + 4 * ccap + qcap)


_HBM_BUDGET_ENV = "KNTPU_HBM_BUDGET_BYTES"


def hbm_budget_bytes(device: torch.device, cfg=None) -> Optional[int]:
    """The device bytes one plan may commit, or None for unbounded, as the
    reference resolves it: the config's ``hbm_budget_bytes`` wins (<= 0:
    unbounded); then the ``KNTPU_HBM_BUDGET_BYTES`` environment variable
    (<= 0: unbounded; a malformed value is ignored with a line on stderr
    and leaves the budget unbounded); then a fraction of the memory free
    on ``device``: what CUDA reports free plus the cached segments of
    torch's caching allocator that no tensor uses (a large allocation that
    misses the cache releases them and retries, as the reference's budget
    counts only live buffers), but not the free fragments of a segment a
    live tensor still holds, which neither a large pack nor CUDA can take
    back; on the CPU, unbounded."""
    explicit = None if cfg is None else cfg.hbm_budget_bytes
    if explicit is not None:
        return int(explicit) if explicit > 0 else None
    raw = os.environ.get(_HBM_BUDGET_ENV)
    if raw is not None:
        try:
            value = int(float(raw))
        except (ValueError, OverflowError):
            print(f"ignoring malformed {_HBM_BUDGET_ENV}={raw!r}",
                  file=sys.stderr, flush=True)
            return None
        return value if value > 0 else None
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    pinned = torch.cuda.memory_stats(device).get(
        "inactive_split_bytes.all.current", 0)
    releasable = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device) - pinned)
    return int((free + releasable) * _HBM_BUDGET_FRACTION)


def _check(qx, qy, qz, qid, cx, cy, cz, cid, k):
    if qx.dim() != 2 or cx.dim() != 2:
        raise ValueError(
            f"supercell_topk: query and candidate arrays must be 2-d (S, Q) "
            f"and (S, C), got {tuple(qx.shape)} and {tuple(cx.shape)}")
    s_total, qcap = qx.shape
    ccap = cx.shape[1]
    for name, a, dt, cap in (("qx", qx, torch.float32, qcap),
                             ("qy", qy, torch.float32, qcap),
                             ("qz", qz, torch.float32, qcap),
                             ("qid", qid, torch.int32, qcap),
                             ("cx", cx, torch.float32, ccap),
                             ("cy", cy, torch.float32, ccap),
                             ("cz", cz, torch.float32, ccap),
                             ("cid", cid, torch.int32, ccap)):
        if a.dtype != dt or tuple(a.shape) != (s_total, cap) \
                or a.device != qx.device or not a.is_contiguous():
            raise ValueError(
                f"supercell_topk: {name} must be a contiguous {dt} tensor of "
                f"shape {(s_total, cap)} on {qx.device}, got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
    if isinstance(k, bool) or int(k) < 1:
        raise ValueError(f"supercell_topk: k must be >= 1, got {k}")
    return s_total, qcap, ccap


def _check_rows(tgt, out, s_total, qcap, k, device):
    if out is None:
        raise ValueError("supercell_topk: mode (a) needs out=(d2, ids)")
    out_d, out_i = out
    n_rows = out_d.shape[0]
    if (tgt.dtype != torch.int32 or tuple(tgt.shape) != (s_total * qcap,)
            or out_d.dtype != torch.float32 or out_i.dtype != torch.int32
            or tuple(out_d.shape) != (n_rows, k)
            or tuple(out_i.shape) != (n_rows, k)
            or not (tgt.is_contiguous() and out_d.is_contiguous()
                    and out_i.is_contiguous())
            or {tgt.device, out_d.device, out_i.device} != {device}):
        raise ValueError(
            f"supercell_topk: tgt must be contiguous int32 ({s_total * qcap},)"
            f" and out contiguous f32/int32 (n, {k}) tensors on {device}")
    return out_d, out_i, n_rows


def _plain_rows(qx, qy, qz, qid, cx, cy, cz, cid, k: int,
                exclude_self: bool, fold):
    """The plain versions' shared half: d2 = ((qx-cx)^2 + (qy-cy)^2) +
    (qz-cz)^2 with every op rounded on its own, pads and (with
    ``exclude_self``) the query's own id masked, as exact int64 (d2, id)
    keys (ops/topk.py), chunked over supercells and query slots to bound
    memory; ``fold`` turns a chunk's (s, q, C) keys into its (s, q, k)
    (d2, ids) rows.  Returns (S, Q, k) d2 and ids."""
    s_total, qcap, ccap = qx.shape[0], qx.shape[1], cx.shape[1]
    rows_d = torch.empty((s_total, qcap, k), dtype=torch.float32,
                         device=qx.device)
    rows_i = torch.empty((s_total, qcap, k), dtype=torch.int32,
                         device=qx.device)
    q_step = min(qcap, max(1, _PLAIN_CHUNK_PAIRS // max(1, ccap)))
    s_step = max(1, _PLAIN_CHUNK_PAIRS // max(1, q_step * ccap))
    for s0 in range(0, s_total, s_step):
        for q0 in range(0, qcap, q_step):
            ss, qs = slice(s0, s0 + s_step), slice(q0, q0 + q_step)
            dx = qx[ss, qs, None] - cx[ss, None, :]
            dy = qy[ss, qs, None] - cy[ss, None, :]
            dz = qz[ss, qs, None] - cz[ss, None, :]
            d2 = (dx * dx + dy * dy) + dz * dz
            c = cid[ss, None, :]
            mask = (c != _PAD_C).expand(d2.shape)
            if exclude_self:
                mask = mask & (c != qid[ss, qs, None])
            rows_d[ss, qs], rows_i[ss, qs] = fold(
                pack_key(d2, c.expand(d2.shape), mask))
    return rows_d, rows_i


def _plain_out(rows_d, rows_i, k: int, tgt, out):
    """Mode (b): the (S, k, Q) layout; mode (a): rows placed at ``tgt``."""
    if tgt is None:
        return (rows_d.transpose(1, 2).contiguous(),
                rows_i.transpose(1, 2).contiguous())
    s_total, qcap = rows_d.shape[:2]
    out_d, out_i, n_rows = _check_rows(tgt, out, s_total, qcap, k,
                                       rows_d.device)
    keep = (tgt >= 0) & (tgt < n_rows)
    rows = tgt[keep].long()
    out_d[rows] = rows_d.reshape(-1, k)[keep]
    out_i[rows] = rows_i.reshape(-1, k)[keep]
    return out_d, out_i


def supercell_topk_plain(qx, qy, qz, qid, cx, cy, cz, cid, k: int,
                         exclude_self: bool, tgt=None, out=None):
    """Plain torch version of the kernel (same arguments and results): the
    first k keys of each query slot (``_plain_rows``)."""
    _check(qx, qy, qz, qid, cx, cy, cz, cid, k)
    rows_d, rows_i = _plain_rows(
        qx, qy, qz, qid, cx, cy, cz, cid, k, exclude_self,
        lambda key: unpack_key(smallest_keys(key, k)))
    return _plain_out(rows_d, rows_i, k, tgt, out)


def _check_blocked(ccap: int, m) -> None:
    if ccap % 128 != 0 or isinstance(m, bool) or not 1 <= int(m) <= 128:
        raise ValueError(
            f"blocked_topk: needs ccap a multiple of 128 and 1 <= m <= 128, "
            f"got ccap={ccap} m={m}")


def blocked_topk_plain(qx, qy, qz, qid, cx, cy, cz, cid, k: int, m: int,
                       exclude_self: bool, tgt=None, out=None):
    """Plain torch version of the blocked kernel (same arguments and
    results): per 128-slot block the first m keys and the smallest d2 it
    rejected (rem), the first k keys of the kept pool, and NaN at column
    k-1 where some block's rem lies strictly below the k-th d2."""
    s_total, qcap, ccap = _check(qx, qy, qz, qid, cx, cy, cz, cid, k)
    _check_blocked(ccap, m)
    k, m = int(k), int(m)
    g = ccap // 128

    def fold(key):
        top = torch.topk(key.reshape(key.shape[:-1] + (g, 128)),
                         min(m + 1, 128), dim=-1, largest=False,
                         sorted=True).values
        if m < 128:
            rem = unpack_key(top[..., m])[0].amin(dim=-1)
        else:
            rem = torch.full(key.shape[:-1], float("inf"),
                             device=key.device)
        d, i = unpack_key(smallest_keys(
            top[..., :m].reshape(key.shape[:-1] + (g * m,)), k))
        t = d[..., k - 1]
        d[..., k - 1] = torch.where(rem < t, float("nan"), t)
        return d, i

    rows_d, rows_i = _plain_rows(qx, qy, qz, qid, cx, cy, cz, cid, k,
                                 exclude_self, fold)
    return _plain_out(rows_d, rows_i, k, tgt, out)


def _lib(name: str, n_int: int, n_geom: int) -> ctypes.CDLL:
    """The kernel library ``name`` with its launcher's argument types: 8
    input pointers, ``n_int`` int arguments (S, Q, C, k, ..., exclude_self),
    tgt, n_rows, the two output pointers, ``n_geom`` int launch-geometry
    arguments and the stream."""
    lib = _build.load(name)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = ([p] * 8 + [i] * n_int + [p, i, p, p]
                           + [i] * n_geom + [p])
        launch.restype = i
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _launch(name: str, args, s_total: int, qcap: int, ccap: int, k: int,
            ints, exclude_self: bool, tgt, out, geometry):
    """The CUDA half of both wrappers: allocate mode (b)'s outputs or check
    mode (a)'s, launch on the current stream, raise on a refused launch.
    ``ints`` are the kernel's extra int arguments after k, ``geometry``
    its launch-geometry ints."""
    device = args[0].device
    if device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {device}")
    if tgt is None:
        out = (torch.empty((s_total, k, qcap), dtype=torch.float32,
                           device=device),
               torch.empty((s_total, k, qcap), dtype=torch.int32,
                           device=device))
        n_rows = 0
    else:
        n_rows = _check_rows(tgt, out, s_total, qcap, k, device)[2]
    if s_total == 0 or qcap == 0:
        return out, False
    lib = _lib(name, 5 + len(ints), len(geometry))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            *(a.data_ptr() for a in args), s_total, qcap, ccap, k, *ints,
            int(bool(exclude_self)), None if tgt is None else tgt.data_ptr(),
            n_rows, out[0].data_ptr(), out[1].data_ptr(), *geometry, stream)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise KernelLaunchError(
            f"{name} launch failed: {msg} (code {rc}; S={s_total} Q={qcap} "
            f"C={ccap} k={k} {ints} geometry={tuple(geometry)})")
    return out, True


def _record(wrapper: str, args, k: int, m: int, plan: TopkPlan, tgt, out):
    """The wrapper's :class:`~..runtime.dispatch.LaunchRecord`, taken
    before it branches between its kernel and its plain version."""
    s_total, qcap = args[0].shape
    ccap = args[4].shape[1]
    if tgt is None:
        outs = ((s_total, k, qcap),) * 2
    else:
        outs = tuple(tuple(o.shape) for o in out) if out is not None else ()
    dispatch.record_launch(
        wrapper=wrapper, mode="b" if tgt is None else "a",
        kernels=(wrapper,), k=int(k), m=int(m), q_tile=plan.qchunk,
        qcap=int(qcap), ccap=int(ccap), s_total=int(s_total),
        in_dtypes=tuple(dispatch.dtype_name(a.dtype) for a in args)
        + (() if tgt is None else (dispatch.dtype_name(tgt.dtype),)),
        out_shapes=tuple(tuple(int(d) for d in o) for o in outs))


def supercell_topk(qx, qy, qz, qid, cx, cy, cz, cid, k: int,
                   exclude_self: bool, tgt: Optional[torch.Tensor] = None,
                   out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """First k candidates per query slot in (d2, stored id) order.

    Query arrays are (S, Q), candidate arrays (S, C); ``qid``/``cid`` are
    int32 stored ids with ``_PAD_Q``/``_PAD_C`` on pad slots.  Mode (a):
    with ``tgt`` (int32 (S*Q,) destination rows) and ``out`` ((n, k) f32
    d2, (n, k) int32 ids), each slot's row is written to ``out`` at row
    ``tgt[slot]``; slots whose target is outside [0, n) are skipped.
    Returns ``out``.  Mode (b), without ``tgt``: returns new (S, k, Q)
    d2 and ids.

    CPU tensors run the plain version.  CUDA tensors launch the kernel on
    the current stream, or raise: there is no fallback."""
    global launches, launches_b
    args = (qx, qy, qz, qid, cx, cy, cz, cid)
    s_total, qcap, ccap = _check(*args, k)
    k = int(k)
    plan = topk_plan(k, qcap, ccap)
    if tgt is None:
        check_raw_indexing(s_total, k, qcap)
    if dispatch.recording():
        _record("supercell_topk", args, k, 0, plan, tgt, out)
    if qx.device.type == "cpu":
        return supercell_topk_plain(*args, k, exclude_self, tgt, out)
    out, launched = _launch("supercell_topk", args, s_total, qcap, ccap, k,
                            (), exclude_self, tgt, out, plan)
    launches += launched
    launches_b += launched and tgt is None
    return out


def blocked_topk(qx, qy, qz, qid, cx, cy, cz, cid, k: int, m: int,
                 exclude_self: bool, tgt: Optional[torch.Tensor] = None,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The blocked two-stage selection (``config.blocked_topm`` gives m):
    the same arguments, modes and results as :func:`supercell_topk`,
    except that ccap must be a multiple of 128 and a deficit row carries
    NaN as its k-th d2.

    CPU tensors run the plain version.  CUDA tensors launch
    ``csrc/blocked_topk.cu`` on the current stream, or raise: there is no
    fallback."""
    global blocked_launches, blocked_launches_b
    args = (qx, qy, qz, qid, cx, cy, cz, cid)
    s_total, qcap, ccap = _check(*args, k)
    _check_blocked(ccap, m)
    k, m = int(k), int(m)
    plan = topk_plan(k, qcap, ccap, m)
    if tgt is None:
        check_raw_indexing(s_total, k, qcap)
    if dispatch.recording():
        _record("blocked_topk", args, k, m, plan, tgt, out)
    if qx.device.type == "cpu":
        return blocked_topk_plain(*args, k, m, exclude_self, tgt, out)
    out, launched = _launch("blocked_topk", args, s_total, qcap, ccap, k,
                            (m,), exclude_self, tgt, out, plan)
    blocked_launches += launched
    blocked_launches_b += launched and tgt is None
    return out


# -- the legacy single-schedule route -----------------------------------------

@dataclasses.dataclass(frozen=True)
class LegacyPack:
    """The legacy route's kernel inputs, packed once at prepare time: the
    counterpart of the reference's ``PallasPack``.

    ``pk`` packs every supercell of the plan (those past the grid's edge
    are all pads) at ``qcap``, the plan's query capacity rounded up to 128
    as the reference lays out its lanes, and ``ccap`` candidate slots;
    ``lo``/``hi`` are the (S, 3) f32 dilated-box corners.  ``inv_flat``
    (n,) is the inverse of the slot partition: stored point r lives in
    flat slot ``inv_flat[r]`` of the (S * qcap) slot axis, in supercell
    ``inv_sc[r] = inv_flat[r] // qcap``.  ``tgt`` (S * qcap,) is the
    forward map, each slot's stored point (n on pads), built from the same
    packed ids, so the two directions cannot drift apart."""

    pk: ClassPack
    lo: torch.Tensor
    hi: torch.Tensor
    inv_flat: torch.Tensor
    inv_sc: torch.Tensor
    tgt: torch.Tensor
    qcap: int
    ccap: int
    s_total: int


def legacy_pack_bytes(n: int, s_total: int, qcap: int, ccap: int, k: int,
                      epilogue: str) -> int:
    """Device bytes of the legacy pack and one solve's outputs: per
    supercell its packed slots and forward map (:func:`pack_bytes`, qcap
    rounded up to 128) and its box; per stored point ``inv_flat``,
    ``inv_sc`` and the (n, k) rows; under 'gather' also the kernel's raw
    (S, k, qcap) output."""
    q = -(-qcap // 128) * 128
    need = pack_bytes(s_total, q, ccap) + 24 * s_total + 8 * n + 8 * n * k
    if epilogue == "gather":
        need += 8 * s_total * k * q
    return need


def preflight_launch(qcap: int, ccap: int, k: int, s_total: int, n: int, *,
                     m: int = 0, epilogue: str = "scatter",
                     site: str = "prepare_pack",
                     budget: Optional[int] = None) -> None:
    """Refuse a legacy launch before anything is allocated, with the same
    :class:`LaunchBudgetError` (kind 'oom') as the adaptive plan's
    preflight: when the class kernel's launch gate refuses k (m > 0: the
    blocked kernel's k + m), or when :func:`legacy_pack_bytes` exceeds
    ``budget`` (None: unbounded).  backend='xla' runs the plain scan
    instead, on request only."""
    try:
        topk_plan(k, -(-qcap // 128) * 128, ccap, m)
    except LaunchBudgetError as e:
        raise LaunchBudgetError(
            f"{site}: the class kernel's launch gate refuses the legacy "
            f"pack: {e}; pass backend='xla' for the plain scan",
            requested=e.requested, budget=e.budget, site=site) from e
    if budget is None:
        return
    need = legacy_pack_bytes(n, s_total, qcap, ccap, k, epilogue)
    if need > budget:
        raise LaunchBudgetError(
            f"{site}: the legacy pack and its outputs need {need} bytes "
            f"(qcap={qcap}, ccap={ccap}, k={k}, supercells={s_total}, "
            f"epilogue={epilogue!r}), above the {budget}-byte budget; use "
            f"the adaptive route, lower config.supercell, or raise "
            f"config.hbm_budget_bytes / {_HBM_BUDGET_ENV}",
            requested=need, budget=budget, site=site)


def build_pack(points: torch.Tensor, starts: torch.Tensor,
               counts: torch.Tensor, plan) -> LegacyPack:
    """Pack every supercell of a legacy ``SolvePlan`` (``ops.solve``) with
    :func:`pack_inputs`, and invert its slot partition."""
    s_total = plan.n_chunks * plan.batch
    qcap = -(-plan.qcap // 128) * 128
    pk = pack_inputs(points, starts, counts,
                     plan.own_cells.reshape(s_total, -1),
                     plan.cand_cells.reshape(s_total, -1), qcap, plan.ccap)
    n = points.shape[0]
    tgt = torch.where(pk.qid >= 0, pk.qid, n).reshape(-1)
    inv = torch.zeros((n + 1,), dtype=torch.int32, device=points.device)
    inv[tgt.long()] = torch.arange(s_total * qcap, dtype=torch.int32,
                                   device=points.device)
    inv_flat = inv[:n]
    return LegacyPack(pk=pk, lo=plan.box_lo.reshape(s_total, 3),
                      hi=plan.box_hi.reshape(s_total, 3), inv_flat=inv_flat,
                      inv_sc=inv_flat // qcap, tgt=tgt.to(torch.int32),
                      qcap=qcap, ccap=int(plan.ccap), s_total=s_total)


def check_raw_indexing(s_total: int, k: int, qcap: int) -> None:
    """The reference's refusal of a raw (S, k, qcap) output past int32
    indexing, where its gather index would wrap: checked by both wrappers
    before a mode (b) launch, on either device."""
    if s_total * k * qcap > 2**31 - 1:
        raise ValueError(
            f"raw kernel output exceeds int32 indexing "
            f"({s_total * k * qcap} elements): shard the problem or "
            f"reduce k")


def launch_class(pk: ClassPack, k: int, m: int, exclude_self: bool,
                 tgt: Optional[torch.Tensor] = None,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One class-kernel launch over a pack: :func:`blocked_topk` at kept
    count ``m`` when m > 0, else :func:`supercell_topk`; mode (a) into
    ``out`` through ``tgt``, or mode (b) without them.  Returns the
    kernel's output."""
    if m:
        return blocked_topk(*pk.args(), k, m, exclude_self, tgt=tgt, out=out)
    return supercell_topk(*pk.args(), k, exclude_self, tgt=tgt, out=out)


def gather_rows(out: Tuple[torch.Tensor, torch.Tensor], inv_flat, inv_sc,
                qcap: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gather epilogue: (rows, k) d2 and ids read straight from mode
    (b)'s raw (S, k, qcap) output, row r at supercell ``inv_sc[r]``, lane
    ``inv_flat[r] % qcap``: one gather at the composed flat index
    ``inv_sc * k * qcap + lane + j * qcap``."""
    base = inv_sc.long() * (k * qcap) + (inv_flat % qcap).long()
    idx = base[:, None] + torch.arange(k, device=base.device) * qcap
    return out[0].reshape(-1)[idx], out[1].reshape(-1)[idx]


def pack_rows(pk: ClassPack, k: int, m: int, exclude_self: bool,
              epilogue: str, tgt: torch.Tensor, inv_flat: torch.Tensor,
              inv_sc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pack's (rows, k) d2 and ids, a row per entry of ``inv_flat``,
    by ``epilogue`` (:func:`launch_class` picks the kernel):
    'scatter', mode (a) into new (inf, -1) rows through the forward map
    ``tgt`` (slot -> row; pads point past the rows and are skipped);
    'gather', mode (b), then :func:`gather_rows` through the inverse maps
    ``inv_flat`` / ``inv_sc``.  The two are equal bit for bit."""
    if epilogue == "gather":
        return gather_rows(launch_class(pk, k, m, exclude_self), inv_flat,
                           inv_sc, int(pk.qx.shape[1]), k)
    rows, device = inv_flat.shape[0], pk.qx.device
    out = (torch.full((rows, k), float("inf"), dtype=torch.float32,
                      device=device),
           torch.full((rows, k), INVALID_ID, dtype=torch.int32,
                      device=device))
    return launch_class(pk, k, m, exclude_self, tgt, out)


def solve_packed(pack: LegacyPack, points: torch.Tensor, k: int,
                 exclude_self: bool, domain: float, kernel: str = "kpass",
                 epilogue: str = "scatter"):
    """The legacy route's solve over a prepared pack: one class-kernel
    launch (``blocked_topk`` when ``kernel`` is 'blocked', else
    ``supercell_topk``) by ``epilogue`` (:func:`pack_rows`: 'scatter'
    through ``tgt``, 'gather' through ``inv_flat``/``inv_sc``, equal bit
    for bit), then the certificates.  Returns ((n, k) ids, (n, k) d2,
    (n,) certified, the uncertified count), sorted indexing, on the
    pack's device.  The certificate reads each row's raw k-th d2 before
    non-finite entries become (-1, inf): a blocked deficit row's NaN
    fails it even where the margin is infinite."""
    from .solve import _margin_sq
    from ..config import blocked_topm

    m = blocked_topm(k, pack.ccap) if kernel == "blocked" else 0
    row_d, row_i = pack_rows(pack.pk, k, m, exclude_self, epilogue,
                             pack.tgt, pack.inv_flat, pack.inv_sc)
    raw_kth = row_d[:, k - 1]
    ok = torch.isfinite(row_d)
    row_i = torch.where(ok, row_i, INVALID_ID)
    row_d = torch.where(ok, row_d, float("inf"))
    inv_sc = pack.inv_sc.long()
    cert = raw_kth <= _margin_sq(points, pack.lo[inv_sc], pack.hi[inv_sc],
                                 domain)
    return row_i, row_d, cert, (~cert).sum().to(torch.int32)
