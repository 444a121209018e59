"""Counted host-boundary traffic of the one-sync solve.

Counterpart of ``cuda_knearests_tpu/runtime/dispatch.py``.  :func:`fetch` is
the one sanctioned device-to-host readback: every tensor of a call is
copied into host memory without blocking and the host then waits once, so
one call is one round trip however many tensors ride it.  :func:`stage` is
the non-blocking host-to-device upload.  A solve completes within
:data:`SYNC_BUDGET` fetches: one batched readback of the assembled rows,
plus one more when uncertified rows need the exact fallback.
The counters also carry the bytes each direction moved (``d2h_bytes``,
``h2d_bytes``), and :class:`trace_sites` records, for every ``fetch``,
``stage`` and ``ici`` call inside its window, the calling file and line
(a :class:`SiteRecord`).  With spans on, each transfer is a
``dispatch.fetch`` / ``dispatch.stage`` child span of whatever span the
caller holds open, and a fetch's wait on the device its own
``dispatch.fetch.wait`` child.  :func:`kernel_stats` reads the kernel counters:
builds and library loads (``ops/_build``) and class-kernel launches
(``ops/cuda_solve``); :func:`tuned_plan_stats` the tuned-plan store's.
:class:`record_launches` collects one :class:`LaunchRecord` per call of a
hand-kernel wrapper (``cuda_solve.supercell_topk`` / ``blocked_topk``,
``mxu.kernel.select_routed`` / ``select_split``), taken before the
wrapper branches between its kernel and its plain version, so the CPU and
the card record the same thing; :func:`signature` is the recompile-key
census the analysis engines compute over those records.

``python -m cuda_knearests_tpu_torch.runtime.dispatch [--device cpu]``
runs the sync-budget smoke (:func:`_smoke`): six solve and query routes on
a small fixture, each within :data:`SYNC_BUDGET` host round trips.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..obs import spans as _spans

SYNC_BUDGET = 2


@dataclasses.dataclass
class DispatchStats:
    """Host-boundary counters of one measurement window: blocking
    readbacks (``fetch`` calls) and the bytes they read (``d2h_bytes``),
    the bytes ``stage`` uploaded (``h2d_bytes``; an upload is traffic,
    not a sync), and ``ici_bytes``, the bytes a pod's halo exchange moved
    between chips (:func:`ici`; never a host sync)."""

    host_syncs: int = 0
    d2h_bytes: int = 0
    h2d_bytes: int = 0
    ici_bytes: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_STATS = DispatchStats()
_STATS_LOCK = threading.Lock()
# The active per-call-site trace (None = off; see trace_sites).
_SITE_TRACE: Optional[list] = None
# The active kernel-launch record (None = off; see record_launches).
_LAUNCH_TRACE: Optional[list] = None
_PACKAGE = "cuda_knearests_tpu_torch"


def reset_stats() -> None:
    """Zero the counters (the start of a measurement window).  The
    counters are one process-wide window: they attribute traffic to a
    single solve only when no other thread dispatches inside it."""
    with _STATS_LOCK:
        _STATS.host_syncs = 0
        _STATS.d2h_bytes = 0
        _STATS.h2d_bytes = 0
        _STATS.ici_bytes = 0


def stats() -> DispatchStats:
    """Snapshot of the current window's counters."""
    with _STATS_LOCK:
        return dataclasses.replace(_STATS)


def stats_dict() -> dict:
    """The current window's counters as a plain dict."""
    return stats().as_dict()


@dataclasses.dataclass(frozen=True)
class SiteRecord:
    """One traced host-boundary transfer: the source line that moved how
    many bytes, which way.  ``path`` starts at the package directory;
    ``synced`` is True for a fetch (each one is a host round trip)."""

    kind: str      # 'fetch' | 'stage' | 'ici'
    path: str
    line: int
    nbytes: int
    synced: bool


def _record_site(kind: str, nbytes: int, synced: bool) -> None:
    """Append the caller of fetch/stage/ici to the active trace."""
    frame = sys._getframe(2)
    path = frame.f_code.co_filename
    cut = path.rfind(_PACKAGE)
    if cut >= 0:
        path = path[cut:].replace(os.sep, "/")
    _SITE_TRACE.append(SiteRecord(kind=kind, path=path, line=frame.f_lineno,
                                  nbytes=int(nbytes), synced=synced))


class trace_sites:
    """Context manager that collects one :class:`SiteRecord` per
    ``fetch``, ``stage`` and ``ici`` call inside the window (``with
    trace_sites() as records: ...``).  Single-threaded windows only, as
    the counters."""

    def __enter__(self) -> list:
        global _SITE_TRACE
        self._prev = _SITE_TRACE
        _SITE_TRACE = []
        return _SITE_TRACE

    def __exit__(self, *exc) -> None:
        global _SITE_TRACE
        _SITE_TRACE = self._prev


@dataclasses.dataclass(frozen=True)
class LaunchRecord:
    """One call of a hand-kernel wrapper, as the wrapper saw it before it
    chose between its CUDA kernel and its plain version: the wrapper, its
    mode ('a' rows through a forward map, 'b' the raw (S, k, Q) layout;
    the selection's precision for the MXU wrappers), the ``csrc`` sources
    the card builds for it, k, m (the blocked kernel's or the selection's
    kept count, 0 for none), the launch tile (query slots a block, or the
    selection's rows a block; 0 for the split selection), the query,
    candidate and supercell capacities, the input dtypes and the output
    shapes."""

    wrapper: str
    mode: str
    kernels: Tuple[str, ...]
    k: int
    m: int
    q_tile: int
    qcap: int
    ccap: int
    s_total: int
    in_dtypes: Tuple[str, ...]
    out_shapes: Tuple[Tuple[int, ...], ...]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def recording() -> bool:
    """True inside a :class:`record_launches` window (the wrappers build
    their record only then)."""
    return _LAUNCH_TRACE is not None


def record_launch(**fields) -> None:
    """Append one :class:`LaunchRecord` to the active record (a no-op when
    no :class:`record_launches` window is open)."""
    if _LAUNCH_TRACE is not None:
        _LAUNCH_TRACE.append(LaunchRecord(**fields))


class record_launches:
    """Context manager that collects one :class:`LaunchRecord` per call of
    a hand-kernel wrapper inside the window (``with record_launches() as
    records: ...``).  Single-threaded windows only, as the counters."""

    def __enter__(self) -> list:
        global _LAUNCH_TRACE
        self._prev = _LAUNCH_TRACE
        _LAUNCH_TRACE = []
        return _LAUNCH_TRACE

    def __exit__(self, *exc) -> None:
        global _LAUNCH_TRACE
        _LAUNCH_TRACE = self._prev


def dtype_name(dtype) -> str:
    """'float32'-style name of a torch or numpy dtype (the reference's
    numpy spelling on both)."""
    return str(dtype).removeprefix("torch.")


def _leaves(tree: Any, out: list) -> list:
    """Every tensor or array leaf of nested tuples, lists, dicts and
    dataclasses, in order."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _leaves(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _leaves(x, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _leaves(getattr(tree, f.name), out)
    return out


def signature(tree: Any, *statics: Any) -> Tuple:
    """Recompile key of a call: every tensor or array leaf's (shape, dtype)
    plus the static arguments -- what the reference's jit keys its cache
    on.  The port compiles nothing per shape; the census is what the
    analysis engines hold stable across data (``analysis/verify.py``'s
    ``sig-data-dep``, ``analysis/contracts.py``'s ``recompile-key``)."""
    leaves = tuple((tuple(int(d) for d in leaf.shape),
                    dtype_name(leaf.dtype)) for leaf in _leaves(tree, []))
    return leaves + tuple(statics)


def kernel_stats() -> dict:
    """Process-wide kernel counters: ``kernel_builds`` (nvcc builds that
    succeeded) and ``kernel_loads`` (libraries loaded), whose sum inside a
    serving window is that window's ``recompiles``, and
    ``kernel_launches``, the class kernels' launches
    (``cuda_solve.launches + blocked_launches``; CUDA tensors only)."""
    from ..ops import _build, cuda_solve

    return {"kernel_builds": _build.builds, "kernel_loads": _build.loads,
            "kernel_launches": cuda_solve.launches
            + cuda_solve.blocked_launches}


def kernel_launches() -> dict:
    """Each hand-written kernel's launches in this process, by kernel and
    mode: ``supercell_topk`` and ``blocked_topk`` count mode (a) (rows),
    the ``_mode_b`` entries the (S, k, Q) layout, and the three MXU
    selections their own.  A wrapper counts where it launches, so a CPU
    process reports zeros."""
    from ..mxu import kernel as mk
    from ..ops import cuda_solve as cs

    return {"supercell_topk": cs.launches - cs.launches_b,
            "supercell_topk_mode_b": cs.launches_b,
            "blocked_topk": cs.blocked_launches - cs.blocked_launches_b,
            "blocked_topk_mode_b": cs.blocked_launches_b,
            "mxu_select": mk.launches, "mxu_select_bf16": mk.launches_bf16,
            "mxu_select_split": mk.split_launches}


def tuned_plan_stats() -> dict:
    """Counters of the active tuned-plan store (``tune/store.py``), or {}
    when the tuner was never activated.  Resolved through ``sys.modules``
    so importing dispatch never imports the tune package."""
    mod = sys.modules.get(_PACKAGE + ".tune.store")
    if mod is None:
        return {}
    try:
        return mod.stats_dict()
    except Exception:  # noqa: BLE001 -- stats are observability; their failure must never fail a caller
        return {}


def fetch(*tensors: torch.Tensor):
    """One batched readback: the tensors as host numpy arrays, in order.
    Each CUDA tensor's copy is queued on the current stream of its own
    device, so the host waits on that stream of every distinct device
    among them (slabs of a sharded problem live on several cards).
    Counts one host round trip per call, on every device, and the
    tensors' bytes as ``d2h_bytes``."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    with _STATS_LOCK:
        _STATS.host_syncs += 1
        _STATS.d2h_bytes += nbytes
    if _SITE_TRACE is not None:
        _record_site("fetch", nbytes, True)
    if _spans.enabled():
        # a child span: the host wait lands inside whatever span the
        # caller holds open (a solve phase, a serving batch)
        with _spans.span("dispatch.fetch", nbytes=nbytes, synced=True):
            return _read_back(tensors)
    return _read_back(tensors)


def _read_back(tensors) -> list:
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    # the host's blocked time, apart from queueing the copies and the
    # conversion to numpy
    with _spans.span("dispatch.fetch.wait"):
        for device in {t.device for t in tensors if t.is_cuda}:
            torch.cuda.current_stream(device).synchronize()  # kntpu-ok: host-sync-loop -- fetch's one wait per distinct device among its tensors: the call's single batched round trip
    return [h.numpy() for h in host]


def ici(nbytes: int) -> None:
    """Record ``nbytes`` moved between chips by a device-to-device
    exchange (``pod/halo.py``): it counts toward ``ici_bytes`` only, never
    ``host_syncs``."""
    with _STATS_LOCK:
        _STATS.ici_bytes += int(nbytes)
    if _SITE_TRACE is not None:
        _record_site("ici", int(nbytes), False)
    _spans.event("dispatch.ici", nbytes=int(nbytes))


def stage(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host-to-device upload that does not block the host; its bytes
    count as ``h2d_bytes``."""
    arr = np.ascontiguousarray(array)
    with _STATS_LOCK:
        _STATS.h2d_bytes += int(arr.nbytes)
    if _SITE_TRACE is not None:
        _record_site("stage", int(arr.nbytes), False)
    if _spans.enabled():
        with _spans.span("dispatch.stage", nbytes=int(arr.nbytes)):
            return torch.as_tensor(arr).to(device, non_blocking=True)
    return torch.as_tensor(arr).to(device, non_blocking=True)


# -- the sync-budget smoke ----------------------------------------------------

def _smoke(n: int = 4000, budget: int = SYNC_BUDGET, device=None) -> int:
    """Run the six solve and query routes on a small fixture on ``device``
    (default: the GPU) and hold each to the sync budget: the adaptive
    solve, the legacy pack solve, adaptive and chunked external queries,
    and the sharded solve and query over two slabs (two cards where there
    are two, else ``cuda:0`` twice; ``cpu`` twice on the CPU).  One JSON
    line a route; returns 0 iff every route kept the budget."""
    import json

    from .. import KnnConfig, KnnProblem
    from ..io import generate_uniform
    from ..parallel.sharded import ShardedKnnProblem, round_robin_devices
    from ..utils.platform import resolve_device

    device = resolve_device(device)
    slabs = round_robin_devices(device, 2)
    points = generate_uniform(n, seed=5)
    queries = generate_uniform(max(256, n // 16), seed=6)
    rc = 0

    def row(route: str, run) -> None:
        nonlocal rc
        reset_stats()
        run()
        s = stats()
        ok = s.host_syncs <= budget
        rc |= 0 if ok else 1
        print(json.dumps({"route": route, "budget": budget, "ok": ok,
                          "device": str(device), **s.as_dict()}),
              flush=True)

    p_a = KnnProblem.prepare(points, KnnConfig(k=8), device=device)
    row("adaptive-solve", p_a.solve)
    p_l = KnnProblem.prepare(points, KnnConfig(k=8, adaptive=False),
                             device=device)
    row("legacy-pack-solve", p_l.solve)
    row("external-query[adaptive]", lambda: p_a.query(queries))
    p_c = KnnProblem.prepare(points, KnnConfig(
        k=8, adaptive=False, query_chunk=128), device=device)
    row("external-query[chunked]", lambda: p_c.query(queries))
    sp = ShardedKnnProblem.prepare(points, config=KnnConfig(k=8),
                                   devices=slabs)
    print(json.dumps({"sharded_slabs": slabs}), flush=True)
    row("sharded-solve", sp.solve)
    row("sharded-query", lambda: sp.query(queries))
    return rc


def _main(argv=None) -> int:
    import argparse
    import json

    from ..utils.memory import NoDeviceError

    ap = argparse.ArgumentParser(
        prog="python -m cuda_knearests_tpu_torch.runtime.dispatch",
        description="the sync-budget smoke: the six routes, each within "
                    "SYNC_BUDGET host round trips")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--budget", type=int, default=SYNC_BUDGET)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    try:
        return _smoke(args.n, args.budget, device=args.device)
    except NoDeviceError as e:
        print(json.dumps({"ok": False, "error": str(e),
                          "failure_kind": e.kind}), flush=True)
        return 4


if __name__ == "__main__":
    # `python -m` runs this file as `__main__`, a different module object
    # from the `cuda_knearests_tpu_torch.runtime.dispatch` the engine
    # imports: run the canonical module's smoke, whose counters the
    # routes increment
    from cuda_knearests_tpu_torch.runtime.dispatch import _main as _canonical

    sys.exit(_canonical())
