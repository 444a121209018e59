"""Kernel inputs and the supercell top-k: CUDA kernel wrapper and its plain
torch version.

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
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from ..utils.memory import LaunchBudgetError
from . import _build
from .solve import pack_cells
from .topk import pack_key, smallest_keys, unpack_key

# Sentinel ids of pad query / candidate slots.  Distinct negatives, so a
# pad query never "self-excludes" a pad candidate.
_PAD_Q = -2
_PAD_C = -3

# Shared memory one block may use on Hopper (H100/H200: 227 KB).
SMEM_LIMIT = 232_448
# Candidates per shared-memory tile; must match kTile in the source.
_CAND_TILE = 256
# Query slots per block, widest first.
_Q_TILES = (128, 64, 32)
# Fraction of the device's free memory one solve may commit to its packs
# and outputs.
_HBM_BUDGET_FRACTION = 0.8
# (query, candidate) pairs per chunk of the plain version.
_PLAIN_CHUNK_PAIRS = 1 << 24

# Kernel launches made by supercell_topk (CUDA tensors only).
launches = 0


class KernelLaunchError(RuntimeError):
    """The CUDA launch returned an error (refused or failed to start)."""


def smem_bytes(k: int, q_tile: int) -> int:
    """Shared memory of one block: the candidate tile plus each thread's
    (d2, id) list of length k."""
    return 4 * _CAND_TILE * 4 + 2 * k * q_tile * 4


def pick_q_tile(k: int, qcap: int) -> int:
    """Query slots per block: the widest tile (at most qcap rounded up to a
    warp) whose per-thread lists fit shared memory.  Raises
    :class:`LaunchBudgetError` when even one warp's lists do not fit."""
    for qt in _Q_TILES:
        if smem_bytes(k, qt) <= SMEM_LIMIT:
            return min(qt, max(32, -(-qcap // 32) * 32))
    raise LaunchBudgetError(
        f"k={k} needs {smem_bytes(k, _Q_TILES[-1])} bytes of shared memory "
        f"for one 32-query block, above the {SMEM_LIMIT}-byte limit of a "
        f"Hopper block (largest supported k: "
        f"{(SMEM_LIMIT - smem_bytes(0, 32)) // (8 * 32)})",
        requested=smem_bytes(k, _Q_TILES[-1]), budget=SMEM_LIMIT,
        site="supercell_topk")


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


def hbm_budget_bytes(device: torch.device) -> Optional[int]:
    """The memory one solve may commit on ``device``: a fraction of what
    CUDA reports free; None (unbounded) on the CPU."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return int(free * _HBM_BUDGET_FRACTION)


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


def supercell_topk_plain(qx, qy, qz, qid, cx, cy, cz, cid, k: int,
                         exclude_self: bool, tgt=None, out=None):
    """Plain torch version of the kernel (same arguments and results).

    d2 = ((qx-cx)^2 + (qy-cy)^2) + (qz-cz)^2 with every op rounded on its
    own, pads and (with ``exclude_self``) the query's own id masked, and the
    first k in (d2, id) order selected through exact int64 keys
    (ops/topk.py).  Chunked over supercells and query slots to bound
    memory."""
    s_total, qcap, ccap = _check(qx, qy, qz, qid, cx, cy, cz, cid, k)
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
            best = smallest_keys(pack_key(d2, c.expand(d2.shape), mask), k)
            rows_d[ss, qs], rows_i[ss, qs] = unpack_key(best)
    if tgt is None:
        return (rows_d.transpose(1, 2).contiguous(),
                rows_i.transpose(1, 2).contiguous())
    out_d, out_i, n_rows = _check_rows(tgt, out, s_total, qcap, k,
                                       qx.device)
    keep = (tgt >= 0) & (tgt < n_rows)
    rows = tgt[keep].long()
    out_d[rows] = rows_d.reshape(-1, k)[keep]
    out_i[rows] = rows_i.reshape(-1, k)[keep]
    return out_d, out_i


def _lib() -> ctypes.CDLL:
    lib = _build.load("supercell_topk")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.supercell_topk_launch.argtypes = [p] * 8 + [i] * 5 + [p, i, p, p,
                                                               i, p]
        lib.supercell_topk_launch.restype = i
        lib.supercell_topk_error_string.argtypes = [i]
        lib.supercell_topk_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


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
    global launches
    s_total, qcap, ccap = _check(qx, qy, qz, qid, cx, cy, cz, cid, k)
    k = int(k)
    q_tile = pick_q_tile(k, qcap)
    device = qx.device
    if device.type == "cpu":
        return supercell_topk_plain(qx, qy, qz, qid, cx, cy, cz, cid, k,
                                    exclude_self, tgt, out)
    if device.type != "cuda":
        raise ValueError(f"supercell_topk runs on CPU or CUDA tensors, got "
                         f"{device}")
    if tgt is None:
        if s_total * k * qcap > 2**31 - 1:
            raise ValueError(
                f"raw kernel output exceeds int32 indexing "
                f"({s_total * k * qcap} elements): shard the problem or "
                f"reduce k")
        out = (torch.empty((s_total, k, qcap), dtype=torch.float32,
                           device=device),
               torch.empty((s_total, k, qcap), dtype=torch.int32,
                           device=device))
        n_rows = 0
    else:
        n_rows = _check_rows(tgt, out, s_total, qcap, k, device)[2]
    if s_total == 0 or qcap == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.supercell_topk_launch(
            qx.data_ptr(), qy.data_ptr(), qz.data_ptr(), qid.data_ptr(),
            cx.data_ptr(), cy.data_ptr(), cz.data_ptr(), cid.data_ptr(),
            s_total, qcap, ccap, k, int(bool(exclude_self)),
            None if tgt is None else tgt.data_ptr(), n_rows,
            out[0].data_ptr(), out[1].data_ptr(), q_tile, stream)
    if rc != 0:
        raise KernelLaunchError(
            f"supercell_topk launch failed: "
            f"{lib.supercell_topk_error_string(rc).decode()} (code {rc}; "
            f"S={s_total} Q={qcap} C={ccap} k={k} q_tile={q_tile})")
    launches += 1
    return out
