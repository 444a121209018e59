"""kntpu-scope: device-time capture scoped to a solve window.

Counterpart of ``cuda_knearests_tpu/obs/device.py``, on ``torch.profiler``.
The span tracer sees only the host; this module adds three measured
quantities per window:

* **Device-time attribution** -- :func:`profile_window` runs a callable
  under ``torch.profiler`` (CPU activity always, CUDA activity where the
  window's device is a card) with a wall-anchored window annotation,
  parses the capture (``obs/attribution.py``) and attributes every kernel,
  copy and memset to the host span timeline, the ``kntpu:*`` named scopes
  and the kernel-library registry, each GPU event at its launch's host
  timestamp (joined by correlation id).  Zero unattributed events is an
  asserted property: the harness holds an umbrella window span open for
  the whole capture.
* **Measured device memory** -- :class:`HbmSampler` samples the memory
  through the window and :func:`hbm_fields` reconciles the window's
  measured growth against the engine's own model
  (:func:`problem_hbm_model`) into a typed ``hbm_model_ok`` verdict: the
  model must DOMINATE the growth within :data:`HBM_MODEL_HEADROOM`.  On
  the card the sampler reads torch's caching allocator: the bytes held in
  tensors (``torch.cuda.memory_allocated``), and the window's peak from
  ``torch.cuda.max_memory_allocated`` after a ``reset_peak_memory_stats``
  at the window's start -- allocated, never reserved, since the cached
  segments no tensor uses are not the solve's (source
  ``cuda_allocator``).  The CPU has no allocator statistic: there the
  sampler sums the storage bytes of the live tensors the garbage
  collector tracks (the reference's ``jax.live_arrays`` reading; source
  ``live_tensors``), once as the window opens and once as it closes and
  never in between, because each reading walks the heap and would slow
  the solve it measures.  So the CPU verdict bounds what a solve keeps,
  not its transient peak (the plain versions' chunk temporaries, which
  model the card's kernels, not the CPU's working set).
* **One merged timeline** -- attributed device events are re-expressed in
  the span event schema and spilled beside the host spans
  (``KNTPU_TRACE_DIR``), so ``obs/export.py`` emits one host+device
  Perfetto trace with no special cases.

:func:`bench_capture_fields` / :func:`bench_capture_or_skip` keep the
reference's contract for bench rows: a failed capture becomes a typed
stamp there.  :func:`profile_window` itself never swallows a failure.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import tempfile
import threading
import uuid
from typing import Callable, List, Optional

import torch

from ..utils.platform import resolve_device
from ..utils.profiling import _sync_all, annotate
from . import attribution as _attr
from . import spans as _spans

#: The umbrella span the harness holds open for the whole window -- the
#: fallback attribution target that makes zero-unattributed a guarantee.
WINDOW_SPAN = "obs.capture_window"

#: The model-dominates-measurement slack: the preflight budgets 80% of the
#: device's free memory to one plan (``cuda_solve._HBM_BUDGET_FRACTION``),
#: i.e. it reserves 1.25x headroom -- the verdict grants the measurement
#: the same factor before calling the model an underestimate.
HBM_MODEL_HEADROOM = 1.25

#: Device bytes a (query slot, candidate slot) pair of one chunk of the
#: legacy scan (``ops/solve.chunk_best``) holds at its peak: the f32
#: distance and one axis's difference, two masks, the int64 key.
_SCAN_PAIR_BYTES = 32


class CaptureError(RuntimeError):
    """A device capture could not run or produced no parseable trace."""


# one capture per process at a time: profiler sessions do not nest
_ACTIVE = threading.Lock()


def bench_capture_enabled() -> bool:
    """The bench-row gate: BENCH_DEVICE_CAPTURE=0 disables the extra
    captured solve entirely (this check is the only cost of 'off')."""
    return os.environ.get("BENCH_DEVICE_CAPTURE", "1") != "0"


# -- measured device memory ---------------------------------------------------

def _live_tensor_bytes() -> int:
    """Bytes of the distinct CPU storages of every live tensor the garbage
    collector tracks."""
    seen = {}
    for obj in gc.get_objects():
        # type(), not isinstance: some module objects warn on __class__
        if issubclass(type(obj), torch.Tensor) and obj.device.type == "cpu":
            try:
                st = obj.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
            except (RuntimeError, NotImplementedError):  # sparse, meta
                continue
    return int(sum(seen.values()))


class HbmSampler(threading.Thread):
    """Samples a device's memory footprint through a window: floor (first
    sample), peak, and the source of truth (the module docstring says
    which reading each device gets).  ``start()``/``stop()`` take one
    synchronous sample each, so floor and peak exist even if the thread
    never gets scheduled; on the card ``start()`` also resets the
    allocator's peak, ``stop()`` reads it, and the thread samples every
    ``period_s`` in between.  On the CPU only the two synchronous samples
    are taken."""

    def __init__(self, period_s: float = 0.004, device=None):
        super().__init__(daemon=True, name="kntpu-hbm-sampler")
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.period_s = max(0.001, float(period_s))
        self._halt = threading.Event()
        self.floor: Optional[int] = None
        self.peak: int = 0
        self.samples = 0
        self.source = "cuda_allocator" if self.cuda else "live_tensors"

    def _read(self) -> int:
        if self.cuda:
            return int(torch.cuda.memory_allocated(self.device))
        return _live_tensor_bytes()

    def _sample(self) -> None:
        v = self._read()
        self.samples += 1
        if self.floor is None:
            self.floor = v
        self.peak = max(self.peak, v)

    def run(self) -> None:
        while not self._halt.wait(self.period_s):
            self._sample()

    def start(self) -> None:  # type: ignore[override]
        if self.cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._sample()                  # synchronous floor sample
        if self.cuda:
            super().start()

    def stop(self) -> "HbmSampler":
        self._halt.set()
        if self.is_alive():
            self.join(timeout=5.0)
        self._sample()                  # synchronous closing sample
        if self.cuda:
            self.peak = max(self.peak, int(
                torch.cuda.max_memory_allocated(self.device)))
        return self

    def result(self) -> dict:
        return {"peak": int(self.peak), "floor": int(self.floor or 0),
                "samples": int(self.samples), "source": self.source}


def hbm_fields(sample: dict, model_bytes: Optional[int]) -> dict:
    """The measured-memory stamp and the typed ``hbm_model_ok`` verdict.

    Law: the window's measured growth (``peak - floor``: residency from
    before the window subtracts out) must not exceed the engine's modelled
    footprint times :data:`HBM_MODEL_HEADROOM`.  A systematic
    underestimate is exactly the failure the preflight model must never
    have: it would bless plans that exhaust the card.  Engines with no
    device plan to model (the oracle backend answers on the host) have
    nothing to reconcile: the verdict is vacuously true and says so."""
    peak, floor = int(sample["peak"]), int(sample["floor"])
    delta = max(0, peak - floor)
    out = {
        "hbm_measured_peak": peak,
        "hbm_measured_floor": floor,
        "hbm_window_delta_bytes": delta,
        "hbm_measured_source": sample["source"],
        "hbm_samples": int(sample["samples"]),
        "hbm_model_bytes": (int(model_bytes)
                            if model_bytes is not None else None),
        "hbm_model_headroom": HBM_MODEL_HEADROOM,
    }
    if model_bytes is None:
        out["hbm_model_ok"] = True
        out["hbm_model_note"] = ("no device-plan model for this engine "
                                 "(host-native route): nothing to "
                                 "reconcile")
        return out
    out["hbm_model_ok"] = bool(delta <= model_bytes * HBM_MODEL_HEADROOM)
    if not out["hbm_model_ok"]:
        out["hbm_model_verdict"] = (
            f"systematic underestimate: window grew {delta} bytes > "
            f"model {int(model_bytes)} * {HBM_MODEL_HEADROOM} -- the "
            f"preflight model would bless a plan this size")
    return out


def problem_hbm_model(problem) -> Optional[int]:
    """The engine's own modelled device footprint for one solve of a
    prepared single-device KnnProblem, in the preflights' terms: on the
    adaptive route ``ops/adaptive._preflight``'s per-class model (a kernel
    class's packs, a streamed or 'mxu' class's tables and one step at its
    supercells a step, ``stream_step_bytes`` / ``class_step_bytes``) plus
    the (n + 1, k) outputs and the per-point supercell map; on the legacy
    pack ``ops/cuda_solve.legacy_pack_bytes``; on the 'xla' scan its
    (n + 1, k) outputs and one chunk's pairs at ``_SCAN_PAIR_BYTES``.
    Plus the assembled (n, k) result rows.
    None when the engine has no device plan (oracle backend, or an empty
    cloud): the verdict is then vacuous."""
    from ..ops import adaptive as ad
    from ..ops.cuda_solve import legacy_pack_bytes, pack_bytes

    cfg = problem.config
    if cfg.backend == "oracle":
        return None
    k = int(cfg.k)
    if problem.aplan is not None:
        n = int(problem.aplan.n_points)
        total = (n + 1) * k * 8 + n * 4
        for cp in problem.aplan.classes:
            side = cfg.supercell + 2 * cp.radius
            if cp.route == "kernel":
                total += pack_bytes(cp.n_sc, cp.qcap, cp.ccap)
                continue
            total += ad.stream_table_bytes(cp.n_sc, cp.qcap, side)
            if cp.route == "mxu":
                total += 4 * cp.n_sc * cfg.supercell ** 3
                total += ad.class_step_bytes(cp.step_rows, cp.qcap, cp.ccap)
            else:
                total += ad.stream_step_bytes(cp.step_rows, cp.qcap,
                                              cp.ccap, k)
        if cfg.resolved_epilogue() == "gather":
            total += n * 4 + 3 * 8 * k * sum(cp.n_sc * cp.qcap
                                              for cp in problem.aplan.classes)
    elif problem.pack is not None:
        pack = problem.pack
        n = int(pack.inv_flat.shape[0])
        total = legacy_pack_bytes(n, pack.s_total, pack.qcap, pack.ccap, k,
                                  cfg.resolved_epilogue())
    elif problem.plan is not None:
        plan = problem.plan
        n = int(problem.grid.n_points)
        total = ((n + 1) * (k * 8 + 1)
                 + _SCAN_PAIR_BYTES * plan.batch * plan.qcap * plan.ccap)
    else:
        return None
    total += 2 * 4 * n * k  # assembled (n, k) ids + d2 result rows
    return int(total)


# -- the capture window -------------------------------------------------------

@dataclasses.dataclass
class WindowReport:
    """Everything one captured window measured."""

    capture_id: str
    ret: object                      # the callable's return value
    host_events: List[dict]          # span-schema events from the window
    device_events: List[_attr.DeviceEvent]
    attributed: List[_attr.Attribution]
    unattributed: List[_attr.DeviceEvent]
    outside_window: int
    decomposition: dict
    hbm: dict
    mounted: List[dict]              # span-schema device events (export)
    trace_path: Optional[str] = None  # kept only with keep_log_dir

    def fields(self) -> dict:
        """The bench-row stamp form."""
        return {"device_time_decomposition": self.decomposition,
                **self.hbm}


def profile_window(fn: Callable[[], object], *,
                   trace_id: Optional[str] = None,
                   hbm_model_bytes: Optional[int] = None,
                   log_dir: Optional[str] = None,
                   keep_log_dir: bool = False,
                   host_tracer_level: int = 1,
                   sample_period_s: float = 0.004,
                   job: str = "device",
                   device=None) -> WindowReport:
    """Run ``fn`` under a scoped ``torch.profiler`` capture on ``device``
    (default: the card; ``device='cpu'`` captures CPU activity only) and
    return the parsed, attributed, memory-reconciled report.

    The window is: profiler session -> capture-anchor ``record_function``
    (whose host wall time joins the clock axes) -> umbrella span -> ``fn``
    -> ``torch.cuda.synchronize()`` on every card, so trailing
    asynchronous work lands inside.  A capture is complete only when every
    kernel launch, copy and memset issued in the window has its device
    event; on an H100 host the profiler dropped a growing share of them in
    sessions held tens of seconds or more after the process's first one
    (all of them after ~500 s), so capture early in a process, or in a
    process of its own.  ``host_tracer_level`` >= 2 also
    records each op's Python stack.  Raises :class:`CaptureError` when a
    capture is already active in this process, the session wrote no
    trace, or it is incomplete (a launch without its device event), and
    ``ValueError`` when the trace lacks the window's anchor; whatever
    ``fn`` raises propagates."""
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    if not _ACTIVE.acquire(blocking=False):
        raise CaptureError("another device capture is active in this "
                           "process (profiler sessions do not nest)")
    own_dir = log_dir is None
    try:
        log_dir = log_dir or tempfile.mkdtemp(prefix="kntpu-devcap-")
        os.makedirs(log_dir, exist_ok=True)
        capture_id = uuid.uuid4().hex[:10]
        anchor_name = _attr.CAPTURE_PREFIX + capture_id
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        col = _spans.Collector()
        _spans.add_sink(col)
        sampler = HbmSampler(sample_period_s, device=device)
        sampler.start()
        try:
            with profile(activities=activities,
                         with_stack=host_tracer_level >= 2) as prof:
                anchor_wall = _spans.wall(_spans.now())
                with annotate(anchor_name), \
                        _spans.span(WINDOW_SPAN, force=True,
                                    trace_id=trace_id, timeline=False,
                                    capture_id=capture_id):
                    ret = fn()
                    if device.type == "cuda":
                        _sync_all()
        finally:
            sampler.stop()
            _spans.remove_sink(col)
        trace_path = os.path.join(log_dir, f"capture_{capture_id}.json")
        prof.export_chrome_trace(trace_path)
        if not os.path.exists(trace_path):
            raise CaptureError(f"the profiler wrote no trace to "
                               f"{trace_path!r}")
        doc = _attr.load_chrome_trace(trace_path)
        events, outside = _attr.rebase(_attr.chrome_events(doc),
                                       anchor_wall, capture_id)
        lost = _attr.unmatched_launches(events)
        if lost:
            launched = sum(e.kind == "launch"
                           and e.name in _attr.DEVICE_WORK_CALLS
                           for e in events)
            raise CaptureError(
                f"{len(lost)} of {launched} device-work launches in the "
                f"window have no kernel, copy or memset event (first: "
                f"{lost[0].name}, correlation {lost[0].correlation}): the "
                f"profiler dropped device events, as it does in a session "
                f"long after the process's first one")
        host = [e for e in col.events if e.get("kind") == "span"]
        attributed, unattributed = _attr.attribute(events, host)
        return WindowReport(
            capture_id=capture_id, ret=ret, host_events=host,
            device_events=events, attributed=attributed,
            unattributed=unattributed, outside_window=outside,
            decomposition=_attr.decomposition(attributed, unattributed,
                                              events=events),
            hbm=hbm_fields(sampler.result(), hbm_model_bytes),
            mounted=_attr.mount(attributed, job=job),
            trace_path=trace_path if keep_log_dir else None)
    finally:
        _ACTIVE.release()
        if own_dir and not keep_log_dir and log_dir:
            shutil.rmtree(log_dir, ignore_errors=True)


def spill_mounted_from_env(report: WindowReport, tag: str = "") -> Optional[str]:
    """When ``KNTPU_TRACE_DIR`` is set (whole-run tracing), spill the
    window's mounted device events beside the host span spills so the
    merged export shows the device lane -- same env contract as
    ``spans.start_file_trace_from_env``."""
    d = os.environ.get("KNTPU_TRACE_DIR", "")
    if not d or not report.mounted:
        return None
    safe = "".join(c if c.isalnum() or c in "-_." else "-"
                   for c in (tag or "device"))
    return _attr.write_spill(report.mounted, os.path.join(
        d, f"trace_{safe}-dev_{os.getpid()}.jsonl"))


def bench_capture_fields(fn: Callable[[], object], *,
                         hbm_model_bytes: Optional[int] = None,
                         trace_id: Optional[str] = None,
                         tag: str = "bench", device=None) -> dict:
    """One captured window as bench-row fields; a capture failure stamps
    a typed error field and NEVER kills the row -- observability must not
    take a bench row down."""
    try:
        report = profile_window(fn, trace_id=trace_id,
                                hbm_model_bytes=hbm_model_bytes,
                                device=device)
        spill_mounted_from_env(report, tag=tag)
        return report.fields()
    except Exception as e:  # noqa: BLE001 -- a failed capture is a typed stamp, never a dead bench row
        return {"device_capture_error": f"{type(e).__name__}: {e}"}


def bench_capture_or_skip(fn: Callable[[], object], *,
                          hbm_model_bytes: Optional[int] = None,
                          trace_id: Optional[str] = None,
                          tag: str = "bench",
                          solve_s: Optional[float] = None,
                          device=None) -> dict:
    """The one enabled/skip contract bench rows share: capture unless
    BENCH_DEVICE_CAPTURE=0 opts out or the measured ``solve_s`` exceeds
    the BENCH_DEVICE_CAPTURE_MAX_S wall guard (default 180 s -- the extra
    captured solve must not starve a wall budget).  Both skips stamp
    ``device_capture_skipped``, never silently."""
    if not bench_capture_enabled():
        return {"device_capture_skipped": "BENCH_DEVICE_CAPTURE=0"}
    max_s = float(os.environ.get("BENCH_DEVICE_CAPTURE_MAX_S", "180"))
    if solve_s is not None and solve_s > max_s:
        return {"device_capture_skipped":
                f"solve_s {solve_s:.1f} > BENCH_DEVICE_CAPTURE_MAX_S "
                f"{max_s:g}"}
    return bench_capture_fields(fn, hbm_model_bytes=hbm_model_bytes,
                                trace_id=trace_id, tag=tag, device=device)
