"""The brute route's selection kernel: CUDA wrapper and launch gate.

Counterpart of ``cuda_knearests_tpu/mxu/kernel.py`` (``select_pallas``).
:func:`select` takes the queries, the interleaved candidates and their ids
and returns every query's selection and certificate:

  * on CUDA tensors it launches ``csrc/mxu_select.cu`` (or raises);
  * on CPU tensors it runs ``scorer.select_plain``, the same function in
    plain torch with the same per-op rounding.

The TPU kernel kept the candidate set and a (G*m, 128) pool in VMEM and
was gated on fitting it (``kernel_fits``); this kernel streams candidates
and keeps per-query lists, so its only gate is shared memory per block
(:func:`pick_launch`), refused with a typed :class:`LaunchBudgetError`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..ops import _build
from ..ops.cuda_solve import SMEM_LIMIT, KernelLaunchError
from ..utils.memory import LaunchBudgetError
from .scorer import check_select_args, select_plain
from .topk import BLOCK, dot_error_bound

# Threads (queries) per block, widest first.
_THREADS = (128, 64, 32)
# Candidates per shared-memory tile: divisors of BLOCK, widest first.
_TILES = (128, 64, 32, 16, 8, 4, 2, 1)
# Bytes of candidate coordinates a tile should stay within, so blocks stay
# small enough to share an SM.
_TILE_BYTES = 16 * 1024

# Kernel launches made by select (CUDA tensors only).
launches = 0


def smem_bytes(d: int, k: int, m: int, threads: int, tile: int) -> int:
    """Shared memory of one block: the threads' query coordinates, the
    candidate tile with its norms and ids, each thread's running list of
    length k and, when the per-block fold can matter (m < k and
    m < BLOCK), its block list of length m.  Must match
    ``mxu_select_smem_bytes`` in the source."""
    mb = 0 if (m >= k or m >= BLOCK) else m
    return 4 * (d * threads + tile * d + 3 * tile + 2 * (k + mb) * threads)


def pick_launch(d: int, k: int, m: int) -> Tuple[int, int]:
    """(threads per block, candidates per tile) of the widest block that
    fits shared memory, with tiles of at most ``_TILE_BYTES`` of
    coordinates where that fits.  Raises :class:`LaunchBudgetError` when
    even 32 threads with one-candidate tiles do not fit."""
    want = max(t for t in _TILES if t == 1 or t * d * 4 <= _TILE_BYTES)
    for tile in [t for t in _TILES if t <= want]:
        for threads in _THREADS:
            if smem_bytes(d, k, m, threads, tile) <= SMEM_LIMIT:
                return threads, tile
    need = smem_bytes(d, k, m, _THREADS[-1], 1)
    raise LaunchBudgetError(
        f"mxu_select at d={d}, k={k}, m={m} needs {need} bytes of shared "
        f"memory for one 32-query block, above the {SMEM_LIMIT}-byte limit "
        f"of a Hopper block", requested=need, budget=SMEM_LIMIT,
        site="mxu_select")


def _lib() -> ctypes.CDLL:
    lib = _build.load("mxu_select")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mxu_select_launch.argtypes = ([p] * 4 + [i] * 7
                                          + [ctypes.c_float, i, i]
                                          + [p] * 4)
        lib.mxu_select_launch.restype = i
        lib.mxu_select_error_string.argtypes = [i]
        lib.mxu_select_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


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
    missing entries are (-1, inf).

    CPU tensors run the plain version.  CUDA tensors launch the kernel on
    the current stream, or raise: there is no fallback."""
    global launches
    n_q, n_c, d = check_select_args(queries, q_ids, pts_il, cid_il, k, m,
                                    d_real, precision)
    k, m = int(k), int(m)
    threads, tile = pick_launch(d, k, m)
    device = queries.device
    if device.type == "cpu":
        return select_plain(queries, q_ids, pts_il, cid_il, k, m, d_real,
                            exclude_self, precision)
    if device.type != "cuda":
        raise ValueError(f"select runs on CPU or CUDA tensors, got {device}")
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=device)
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=device)
    cert = torch.empty((n_q,), dtype=torch.bool, device=device)
    if n_q == 0:
        return out_i, out_s, cert
    coef = float(dot_error_bound(1.0, 0.0, int(d_real), precision))
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mxu_select_launch(
            queries.data_ptr(), q_ids.data_ptr(), pts_il.data_ptr(),
            cid_il.data_ptr(), n_q, n_c, d, k, m, int(bool(exclude_self)),
            int(precision == "bf16"), coef, threads, tile, out_i.data_ptr(),
            out_s.data_ptr(), cert.data_ptr(), stream)
    if rc != 0:
        raise KernelLaunchError(
            f"mxu_select launch failed: "
            f"{lib.mxu_select_error_string(rc).decode()} (code {rc}; M={n_q} "
            f"C={n_c} d={d} k={k} m={m} threads={threads} tile={tile})")
    launches += 1
    return out_i, out_s, cert
