"""Engine 1: the contract checker over every solve route.

Counterpart of ``cuda_knearests_tpu/analysis/contracts.py``.  The reference
traces each route with ``jax.eval_shape`` / ``jax.make_jaxpr`` and checks
its contracts with zero program execution.  PyTorch has no abstract tracer
that passes through the port's ctypes kernels, so this engine runs each
route's *device half* on the CPU, where every kernel wrapper runs its
plain version, over the reference's fixtures: 400 points, data seeds 7 and
19, the same (k, supercell) matrix and the brute route's k x d loop.  The
reference's "zero program execution" becomes two checks, reported under
``env-backend``: no CUDA context is created (``torch.cuda.is_initialized()``
stays False) and no kernel launches (``dispatch.kernel_launches()`` does
not change).  Every fixture passes ``device='cpu'`` explicitly and the
engine mutates no environment variable, so the gate runs the same on the
card's host and on a CPU-only runner.

Checked contracts (each a rule id findings report under):

* ``route-shape``     -- every route's device outputs are exactly the
  engine result contract: (n, k) int32 neighbours, (n, k) f32 distances,
  (n,) bool certificates (+ the scalar int32 uncertified count where the
  route computes it).  A route that fails to run at all reports here too
  -- that is how a corrupted scatter row map is detected.
* ``epilogue-agree``  -- the scatter and gather epilogues of the same
  (route, config) produce byte-equal outputs, and
  ``resolve_epilogue('auto')`` resolves as documented.
* ``hbm-model``       -- the port's byte models (``cuda_solve.pack_bytes``,
  ``legacy_pack_bytes``, ``pod.stream.chip_hbm_model``) dominate the bytes
  of the tensors the launch holds, and ``preflight_launch`` agrees with
  the model (fits at the modeled bytes, refuses below them).
* ``smem-tile``       -- every kernel-routed plan's shared memory
  (``cuda_solve.topk_smem_bytes`` / ``smem_bytes`` at ``pick_q_tile``, the
  selection's ``mxu.kernel.smem_bytes`` / ``smem_bytes_bf16``) stays within
  ``SMEM_LIMIT`` and its tiles are warp-aligned (the reference's
  ``vmem-tile``; its fault keeps the name ``tile-misalign``).
* ``trace-dtype``     -- no f64 tensor anywhere in a route's device half
  (every op's outputs observed through a torch dispatch mode); int64
  appears only where :data:`CONTRACT_WAIVERS` says why.
* ``recompile-key``   -- running a route twice against one plan yields
  identical launch records, and the census of the legacy pack's
  signature across data seeds is reported (info level).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .findings import Finding

# Contract waivers: (rule, subject-key-prefix) -> reason.  The waiver
# mechanism for engine 1 -- the analog of the lint's `# kntpu-ok` markers.
CONTRACT_WAIVERS: Dict[Tuple[str, str], str] = {
    ("trace-dtype", "i64-key"): (
        "the exact (d2, id) selection keys (ops/topk.pack_key) pack a "
        "non-negative f32's bits above a 32-bit id in one int64, so one "
        "integer sort orders by (d2, id) exactly as the kernels do"),
    ("trace-dtype", "i64-index"): (
        "torch indexes and scatters with int64 index tensors (.long()); "
        "they index, they never carry point data"),
}

_FAULT_ENV = "KNTPU_ANALYSIS_FAULT"
FAULTS = ("scatter-map", "hbm-model", "tile-misalign")

_N_POINTS = 400
_SEEDS = (7, 19)  # two data seeds: census compares their signatures
_DEVICE = "cpu"
_WARP = 32


def _fault() -> Optional[str]:
    return os.environ.get(_FAULT_ENV) or None


@dataclasses.dataclass
class _Checker:
    fault: Optional[str] = None
    findings: List[Finding] = dataclasses.field(default_factory=list)

    def fail(self, rule: str, route: str, message: str, hint: str = "",
             subject: str = "") -> None:
        self.findings.append(Finding(
            rule=rule, severity="error", path=f"route:{route}", line=0,
            message=message, hint=hint, subject=subject or message))

    def info(self, rule: str, route: str, message: str,
             subject: str = "") -> None:
        self.findings.append(Finding(
            rule=rule, severity="info", path=f"route:{route}", line=0,
            message=message, subject=subject or message))

    def waive(self, rule: str, key: str, route: str, message: str) -> bool:
        """True (and records an info line) when (rule, key) is waived."""
        for (r, prefix), reason in CONTRACT_WAIVERS.items():
            if r == rule and key.startswith(prefix):
                self.info(rule, route,
                          f"waived [{key}]: {message} -- {reason}",
                          subject=f"waived:{key}")
                return True
        return False


def _points(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (1.0 + rng.random((_N_POINTS, 3)) * 998.0).astype(np.float32)


def _queries(m: int = 96) -> np.ndarray:
    """The external-query fixture (the reference's: seed 23)."""
    rng = np.random.default_rng(23)
    return (1.0 + rng.random((m, 3)) * 998.0).astype(np.float32)


# -- fixtures (prepared on the CPU, memoised per gate run) --------------------

_FIXTURES: Dict[Tuple, object] = {}


def _memo(key: Tuple, build):
    if key not in _FIXTURES:
        _FIXTURES[key] = build()
    return _FIXTURES[key]


def _key(points: np.ndarray, *rest) -> Tuple:
    return (points.shape[0], hash(points.tobytes())) + rest


def _config(k: int, supercell: int, **kw):
    from ..config import KnnConfig

    # hbm_budget_bytes=-1: unbounded, so no fixture's class routing depends
    # on the checking process's environment or device
    return KnnConfig(k=k, supercell=supercell, hbm_budget_bytes=-1, **kw)


@dataclasses.dataclass
class _Fixture:
    problem: object
    cfg: object


def legacy_fixture(points: np.ndarray, k: int, supercell: int,
                   device: str = _DEVICE) -> _Fixture:
    """The legacy (non-adaptive) pack route's prepared problem."""
    from ..api import KnnProblem

    def build():
        cfg = _config(k, supercell, adaptive=False, backend="pallas")
        return _Fixture(KnnProblem.prepare(points, cfg, device=device), cfg)
    return _memo(_key(points, "legacy", k, supercell, device), build)


def adaptive_fixture(points: np.ndarray, k: int, supercell: int,
                     device: str = _DEVICE) -> _Fixture:
    """The adaptive route's prepared problem, planned under the gather
    epilogue so both inverse maps exist (scatter reads ``tgt``)."""
    from ..api import KnnProblem

    def build():
        cfg = _config(k, supercell, epilogue="gather")
        return _Fixture(KnnProblem.prepare(points, cfg, device=device), cfg)
    return _memo(_key(points, "adaptive", k, supercell, device), build)


def mxu_fixture(points: np.ndarray, k: int, supercell: int, epilogue: str,
                recall_target: float = 0.9,
                device: str = _DEVICE) -> _Fixture:
    """The adaptive route under ``scorer='mxu'``: eligible classes route
    through the MXU tier instead of the class kernels."""
    from ..api import KnnProblem

    def build():
        cfg = _config(k, supercell, scorer="mxu", epilogue=epilogue,
                      recall_target=recall_target)
        return _Fixture(KnnProblem.prepare(points, cfg, device=device), cfg)
    return _memo(_key(points, "mxu", k, supercell, epilogue, recall_target,
                      device), build)


def sharded_fixture(points: np.ndarray, k: int, supercell: int,
                    epilogue: str, device: str = _DEVICE):
    """The sharded route over two z-slabs on ``device``."""
    from ..parallel.sharded import ShardedKnnProblem

    return _memo(_key(points, "sharded", k, supercell, epilogue, device),
                 lambda: ShardedKnnProblem.prepare(
                     points, config=_config(k, supercell, epilogue=epilogue),
                     devices=[device] * 2))


def pod_fixture(points: np.ndarray, k: int, supercell: int, epilogue: str,
                device: str = _DEVICE):
    """The pod-partitioned route over two chips on ``device``."""
    from ..pod.solve import PodKnnProblem

    return _memo(_key(points, "pod", k, supercell, epilogue, device),
                 lambda: PodKnnProblem.prepare(
                     points, config=_config(k, supercell, epilogue=epilogue),
                     mesh=[device] * 2))


def _query_half(fx: _Fixture, queries: np.ndarray, k: int, supercell: int,
                epilogue: str):
    """The legacy external query's device half: the real host bucketing,
    then one chunk's launch (``ops.query._launch_packed``)."""
    from ..ops.query import _launch_packed, bucket_queries

    p = fx.problem
    s_total = p.plan.n_chunks * p.plan.batch
    order, sc_counts, starts, q2cap, inv_flat, inv_sc = bucket_queries(
        queries, p.grid, supercell, s_total)
    qs = torch.as_tensor(queries[order], device=p.grid.device)
    return _launch_packed(qs, starts, sc_counts, inv_flat, inv_sc, p.pack,
                          p.grid.permutation, q2cap, k, p.grid.domain,
                          epilogue)


def run_route(route: str, points: np.ndarray, k: int, supercell: int,
              epilogue: str, plan_hook=None, device: str = _DEVICE):
    """One route's device half on ``device`` (the gate's: the CPU): its
    output tensors (a tuple; the sharded and pod routes concatenate their
    chips').  ``plan_hook`` (adaptive only) maps the prepared plan before
    the run."""
    from ..ops.adaptive import solve_adaptive
    from ..ops.cuda_solve import solve_packed

    if route == "legacy-pack":
        fx = legacy_fixture(points, k, supercell, device)
        p = fx.problem
        return tuple(solve_packed(p.pack, p.grid.points, k, True,
                                  p.grid.domain, "kpass", epilogue))
    if route in ("adaptive", "adaptive-mxu"):
        fx = (adaptive_fixture(points, k, supercell, device)
              if route == "adaptive"
              else mxu_fixture(points, k, supercell, epilogue,
                               device=device))
        p = fx.problem
        plan = p.aplan if plan_hook is None else plan_hook(p.aplan)
        r = solve_adaptive(p.grid, dataclasses.replace(
            fx.cfg, epilogue=epilogue), plan)
        return (r.neighbors, r.dists_sq, r.certified, r.uncert_count)
    if route == "external-query":
        return tuple(_query_half(legacy_fixture(points, k, supercell,
                                                device),
                                 _queries(), k, supercell, epilogue))
    if route in ("sharded-chip", "pod-chip"):
        prob = (sharded_fixture if route == "sharded-chip"
                else pod_fixture)(points, k, supercell, epilogue, device)
        outs = prob.solve_device()
        live = [outs[d] for d in sorted(outs) if outs[d] is not None]
        return tuple(torch.cat([o[j] for o in live]) for j in range(3))
    raise KeyError(route)


def record_route(route: str, points: np.ndarray, k: int, supercell: int,
                 epilogue: str, device: str = _DEVICE) -> list:
    """The launch records of one run of a route's device half on
    ``device`` (the card records what the CPU records: the wrappers record
    before they branch)."""
    from ..runtime import dispatch

    with dispatch.record_launches() as records:
        run_route(route, points, k, supercell, epilogue, device=device)
    return list(records)


def record_shared_launch(points: np.ndarray, k: int, supercell: int,
                         epilogue: str) -> list:
    """The shared class kernel called standalone on the legacy fixture's
    pack: mode (b) for the gather family, mode (a) for scatter."""
    from ..ops import cuda_solve
    from ..runtime import dispatch

    p = legacy_fixture(points, k, supercell).problem
    with dispatch.record_launches() as records:
        if epilogue == "gather":
            cuda_solve.supercell_topk(*p.pack.pk.args(), k, True)
        else:
            n = p.grid.n_points
            out = (torch.full((n, k), float("inf")),
                   torch.full((n, k), -1, dtype=torch.int32))
            cuda_solve.supercell_topk(*p.pack.pk.args(), k, True,
                                      tgt=p.pack.tgt, out=out)
    return list(records)


def _grown(device, run) -> Tuple[int, int]:
    """The peak growth on a CUDA ``device`` across ``run()``: of the
    allocator's blocks (``allocated_bytes``, as ``max_memory_allocated``
    reads it) and of the bytes the tensors request (``requested_bytes``).
    The first adds the caching allocator's rounding and whole reused
    blocks, so it depends on the cache's state as well as on the launch.
    The collector is off during ``run()``, so no older garbage freed there
    lowers the peak."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_stats(device)
        run()
        torch.cuda.synchronize(device)
        peak = torch.cuda.memory_stats(device)
    finally:
        if enabled:
            gc.enable()
    return tuple(int(peak[f"{kind}.all.peak"] - base[f"{kind}.all.current"])
                 for kind in ("allocated_bytes", "requested_bytes"))


def _memory_row(route: str, cell: str, ep: str, model: int, device,
                run) -> dict:
    growth, requested = _grown(device, run)
    return dict(route=route, cell=cell, ep=ep, model=model, growth=growth,
                requested=requested)


def adaptive_memory_row(problem, cfg, cell: str, device) -> dict:
    """One byte-model row for a prepared adaptive ``problem`` solved under
    ``cfg``: its plan's model (``pod.stream.class_plan_bytes``, as
    ``adaptive._preflight`` counts it) and the allocator's peak growth
    across one ``solve_adaptive`` on a CUDA ``device``."""
    from ..ops.adaptive import solve_adaptive
    from ..pod.stream import _specs, class_plan_bytes

    classes = problem.aplan.classes
    return _memory_row(
        "adaptive", cell, cfg.epilogue,
        class_plan_bytes(_specs(classes), [cp.step_rows for cp in classes],
                         cfg, problem.grid.n_points),
        device, lambda: solve_adaptive(problem.grid, cfg, problem.aplan))


def launch_memory(device, points: Optional[np.ndarray] = None
                  ) -> List[dict]:
    """The byte models against the allocator, on a CUDA ``device``: for
    every (k, supercell) cell of the matrix and both epilogues, the legacy
    solve (``legacy_pack_bytes``), the adaptive solve
    (:func:`adaptive_memory_row`) and each pod chip's solve from a cold
    ready state (``pod.stream.chip_hbm_model``), each run between
    ``reset_peak_memory_stats`` and the peak of ``memory_stats``.  One row
    a launch: {route, cell, ep, model, growth (the allocator's blocks),
    requested (the tensors' bytes)}; the model must be >= both (the
    smoke's phase 10j (d))."""
    from ..ops.cuda_solve import legacy_pack_bytes
    from ..pod.stream import chip_hbm_model

    points = _points(_SEEDS[0]) if points is None else points
    rows: List[dict] = []

    from . import equiv

    for k, supercell in equiv.MATRIX:
        cell = f"k={k},s={supercell}"
        for ep in ("gather", "scatter"):
            p = legacy_fixture(points, k, supercell, device).problem
            pk, n = p.pack, p.grid.n_points
            rows.append(_memory_row(
                "legacy-pack", cell, ep,
                legacy_pack_bytes(n, pk.s_total, p.plan.qcap, pk.ccap, k,
                                  ep),
                device, lambda: run_route("legacy-pack", points, k,
                                          supercell, ep, device=device)))
            fx = adaptive_fixture(points, k, supercell, device)
            rows.append(adaptive_memory_row(
                fx.problem, dataclasses.replace(fx.cfg, epilogue=ep), cell,
                device))
            pp = pod_fixture(points, k, supercell, ep, device)
            for d, plan in enumerate(pp.chip_plans):
                if not plan.classes:
                    continue
                pp.drop_ready(d)
                rows.append(_memory_row(
                    "pod-chip", f"{cell},chip={d}", ep,
                    chip_hbm_model(pp.meta, plan, pp.config), device,
                    lambda: _chip_solve_once(pp, d)))
    return rows


def _chip_solve_once(pp, d: int):
    from ..parallel.sharded import _chip_solve

    return _chip_solve(pp._chip_ready(d), pp.config)


# -- the contract checks ------------------------------------------------------

def _nbytes(tensors) -> int:
    from ..runtime.dispatch import _leaves

    return sum(t.numel() * t.element_size() for t in _leaves(tensors, [])
               if isinstance(t, torch.Tensor))


def _expect_result(ck: _Checker, route: str, cfg_label: str, out,
                   n: int, k: int, with_count: bool) -> None:
    """The route-shape contract: exact output arity/shape/dtype."""
    want = [((n, k), "int32"), ((n, k), "float32"), ((n,), "bool")]
    if with_count:
        want.append(((), "int32"))
    got = [(tuple(o.shape), str(o.dtype).removeprefix("torch."))
           for o in out]
    if got != want:
        ck.fail("route-shape", route,
                f"[{cfg_label}] outputs {got} != contract {want}",
                hint="the route's epilogue or certificate changed shape/"
                     "dtype; fix the route or update the contract "
                     "deliberately",
                subject=f"{route}:shape")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


class _DtypeScan(torch.utils._python_dispatch.TorchDispatchMode):
    """Every op's output dtypes inside the window: f64 outputs, and int64
    outputs by origin ('key' when ops/topk.py is on the stack, else
    'index')."""

    def __init__(self):
        super().__init__()
        self.wide: set = set()
        self.i64: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if not isinstance(o, torch.Tensor):
                continue
            if o.dtype in (torch.float64, torch.complex128):
                self.wide.add(f"{func}->{o.dtype}")
            elif o.dtype == torch.int64:
                origin = "index"
                f = sys._getframe(1)
                while f is not None:
                    if f.f_code.co_filename.endswith(
                            os.path.join("ops", "topk.py")):
                        origin = "key"
                        break
                    f = f.f_back
                self.i64[origin] = self.i64.get(origin, 0) + 1
        return out


def _check_dtypes(ck: _Checker, route: str, cfg_label: str, run) -> None:
    """trace-dtype: no f64 value anywhere in the route's device half;
    int64 only under a reasoned waiver."""
    scan = _DtypeScan()
    with scan:
        run()
    if scan.wide:
        ck.fail("trace-dtype", route,
                f"[{cfg_label}] 64-bit float ops {sorted(scan.wide)[:4]} "
                f"in the device half: silent f64 promotion doubles every "
                f"buffer and runs at a fraction of the card's f32 rate",
                hint="pin the widening input to f32/i32 before it reaches "
                     "the device (the engine's device dtype contract)",
                subject=f"{route}:dtype")
    for origin, count in sorted(scan.i64.items()):
        key = f"i64-{origin}"
        msg = f"[{cfg_label}] {count} int64 op output(s) ({origin})"
        if not ck.waive("trace-dtype", key, route, msg):
            ck.fail("trace-dtype", route, msg, subject=f"{route}:{key}")


def _check_epilogues(ck: _Checker, route: str, label: str, outs) -> None:
    if len(outs) == 2 and not all(
            a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(_bits(a), _bits(b))
            for a, b in zip(outs["gather"], outs["scatter"])):
        ck.fail("epilogue-agree", route,
                f"[{label}] scatter and gather epilogues disagree: the two "
                f"must be byte-equal",
                hint="a layout divergence here means one of the row maps "
                     "is wrong",
                subject=f"{route}:epilogue")


def _run_checked(ck: _Checker, route: str, label: str, points, k: int,
                 supercell: int, epilogue: str, n: int,
                 with_count: bool, plan_hook=None):
    try:
        out = run_route(route, points, k, supercell, epilogue, plan_hook)
    except Exception as e:  # noqa: BLE001 -- a failed route IS the finding
        ck.fail("route-shape", route,
                f"[{label},ep={epilogue}] the device half failed: "
                f"{type(e).__name__}: {e}",
                hint="a scatter/gather map or class layout no longer "
                     "matches its plan -- the drift this contract exists "
                     "to catch before a card does",
                subject=f"{route}:trace:{epilogue}")
        return None
    _expect_result(ck, route, f"{label},ep={epilogue}", out, n, k,
                   with_count)
    return out


def _check_hbm(ck: _Checker, route: str, cfg_label: str, model: int,
               actual: int, subj: str) -> int:
    """hbm-model: the byte model dominates the bytes the launch holds."""
    if ck.fault == "hbm-model":
        model = model // 4  # seeded fault: model claims 4x less
    if model < actual:
        ck.fail("hbm-model", route,
                f"[{cfg_label}] the byte model says {model} bytes, BELOW "
                f"the {actual} bytes of the tensors the launch holds: the "
                f"preflight would bless launches that do not fit",
                hint="the model must be a slight overestimate of every "
                     "buffer the launch allocates (packs + outputs)",
                subject=subj)
    return model


def _check_legacy_hbm(ck: _Checker, label: str, fx: _Fixture, k: int,
                      records: Dict[str, list]) -> None:
    from ..ops.cuda_solve import legacy_pack_bytes, preflight_launch
    from ..utils.memory import LaunchBudgetError

    route = "legacy-pack"
    p = fx.problem
    pk, n = p.pack, p.grid.n_points
    held = _nbytes((pk.pk, pk.lo, pk.hi, pk.inv_flat, pk.inv_sc, pk.tgt))
    for ep, recs in records.items():
        outs = sum(4 * int(np.prod(s)) for r in recs for s in r.out_shapes)
        if ep == "gather":
            outs += 8 * n * k  # the gathered (n, k) rows
        model = legacy_pack_bytes(n, pk.s_total, p.plan.qcap, pk.ccap, k, ep)
        model = _check_hbm(ck, route, f"{label},ep={ep}", model,
                           held + outs, f"{route}:hbm:{ep}")
        try:
            preflight_launch(p.plan.qcap, pk.ccap, k, pk.s_total, n,
                             epilogue=ep, site="analysis", budget=model)
            fits = True
        except LaunchBudgetError:
            fits = False
        if not fits:
            ck.fail("hbm-model", route,
                    f"[{label},ep={ep}] preflight_launch refuses a budget "
                    f"equal to its own model ({model} bytes): fit "
                    f"predicate and model disagree",
                    subject=f"{route}:hbm:{ep}:fits")
        try:
            preflight_launch(p.plan.qcap, pk.ccap, k, pk.s_total, n,
                             epilogue=ep, site="analysis",
                             budget=max(1, model // 2))
            refused = False
        except LaunchBudgetError:
            refused = True
        if not refused:
            ck.fail("hbm-model", route,
                    f"[{label},ep={ep}] preflight_launch accepted half its "
                    f"model's budget: the refusal arm is dead",
                    subject=f"{route}:hbm:{ep}:preflight")


def _check_class_hbm(ck: _Checker, route: str, label: str, classes) -> None:
    from ..ops.cuda_solve import pack_bytes

    for ci, cp in enumerate(classes):
        if cp.pk is None:
            continue
        held = _nbytes((cp.pk, cp.tgt))
        _check_hbm(ck, route, f"{label},class={ci}",
                   pack_bytes(cp.n_sc, cp.qcap, cp.ccap), held,
                   f"{route}:hbm:class")


def _check_pod_hbm(ck: _Checker, label: str, pp, k: int) -> None:
    from ..pod.stream import chip_hbm_model

    route = "pod-chip"
    outs = pp.solve_device()
    for d, plan in enumerate(pp.chip_plans):
        if not plan.classes:
            continue
        held = (_nbytes(pp.dev[d]) + _nbytes(pp._halo[d])
                + _nbytes(pp._chip_ready(d)) + _nbytes(outs[d]))
        _check_hbm(ck, route, f"{label},chip={d}",
                   chip_hbm_model(pp.meta, plan, pp.config), held,
                   f"{route}:hbm:chip")


def _check_tiles(ck: _Checker, route: str, cfg_label: str, *, k: int,
                 qcap: int, ccap: int, m: int) -> None:
    """smem-tile for a class kernel: the routing gate's per-thread-list
    layout and the kernel's staged tile fit SMEM_LIMIT, and the query
    block and the candidate tile are whole warps."""
    from ..ops.cuda_solve import (_TOPK_CHUNK_PER_WARP, _TOPK_STATIC_SMEM,
                                  SMEM_LIMIT, pick_q_tile, smem_bytes,
                                  topk_plan, topk_smem_bytes)

    misalign = 4 if ck.fault == "tile-misalign" else 0
    plan = topk_plan(k, qcap, ccap, m)
    q_tile = pick_q_tile(k, qcap, m) + misalign
    checks = (("gate-smem", smem_bytes(k, q_tile, m), SMEM_LIMIT),
              ("kernel-smem", topk_smem_bytes(plan, bool(m))
               + _TOPK_STATIC_SMEM, SMEM_LIMIT))
    for key, need, limit in checks:
        if need > limit:
            ck.fail("smem-tile", route,
                    f"[{cfg_label}] {key} {need} bytes > the {limit}-byte "
                    f"shared memory of a Hopper block",
                    subject=f"{route}:tile:{key}")
    # the gate's query tile and the staged candidate tile are whole warps;
    # a block's query chunk is whole warps' shares of _TOPK_CHUNK_PER_WARP
    for key, value, mult in (
            ("q-warp", q_tile, _WARP), ("c-warp", plan.tile + misalign, _WARP),
            ("q-chunk", plan.qchunk + misalign, _TOPK_CHUNK_PER_WARP)):
        if value % mult:
            ck.fail("smem-tile", route,
                    f"[{cfg_label}] {key}={value} is not a multiple of "
                    f"{mult}: the kernel's blocks are built of whole warps",
                    hint="round the tile at plan time (pick_q_tile / "
                         "topk_plan), or add a reasoned entry to "
                         "analysis.contracts.CONTRACT_WAIVERS",
                    subject=f"{route}:tile:{key}")


def _check_class_tiles(ck: _Checker, route: str, label: str, cfg,
                       classes) -> None:
    from ..ops.adaptive import class_blocked_m

    for ci, cp in enumerate(classes):
        if cp.pk is None:
            continue
        _check_tiles(ck, route, f"{label},class={ci}", k=cfg.k,
                     qcap=cp.qcap, ccap=cp.ccap,
                     m=class_blocked_m(cfg, cp.ccap, cfg.k))


def _recompile_key(ck: _Checker, route: str, label: str, points, k: int,
                   supercell: int) -> None:
    """recompile-key: the same plan, run twice, launches identically."""
    try:
        r1 = record_route(route, points, k, supercell, "scatter")
        r2 = record_route(route, points, k, supercell, "scatter")
    except Exception as e:  # noqa: BLE001 -- a failed route IS the finding
        ck.fail("recompile-key", route,
                f"[{label}] recording failed: {type(e).__name__}: {e}",
                subject=f"{route}:records")
        return
    if r1 != r2:
        ck.fail("recompile-key", route,
                f"[{label}] two runs of the same plan launch differently: "
                f"the launch depends on something outside its plan",
                subject=f"{route}:records")


def _corrupt_scatter_map(plan):
    """Seeded fault: truncate one class's forward row map -- the shape
    mismatch a drifted prepare would produce."""
    classes = list(plan.classes)
    for i, cp in enumerate(classes):
        if cp.tgt is not None and cp.pk is not None:
            classes[i] = dataclasses.replace(
                cp, tgt=cp.tgt[:max(int(cp.tgt.shape[0]) - 8, 1)])
            break
    return dataclasses.replace(plan, classes=tuple(classes))


def _check_legacy(ck: _Checker, points, k: int, supercell: int) -> None:
    from ..runtime import dispatch

    route = "legacy-pack"
    label = f"k={k},s={supercell}"
    fx = legacy_fixture(points, k, supercell)
    p = fx.problem
    n = p.grid.n_points
    outs, records = {}, {}
    for ep in ("gather", "scatter"):
        with dispatch.record_launches() as recs:
            out = _run_checked(ck, route, label, points, k, supercell, ep,
                               n, True)
        if out is not None:
            outs[ep], records[ep] = out, list(recs)
    _check_epilogues(ck, route, label, outs)
    _check_legacy_hbm(ck, label, fx, k, records)
    # solve_packed runs kernel='kpass' here, as the reference's fixture:
    # the one-stage kernel, m = 0
    _check_tiles(ck, route, label, k=k, qcap=p.pack.qcap, ccap=p.pack.ccap,
                 m=0)
    _recompile_key(ck, route, label, points, k, supercell)
    _check_dtypes(ck, route, label, lambda: run_route(
        route, points, k, supercell, "gather"))


def _check_adaptive(ck: _Checker, points, k: int, supercell: int,
                    skip_eps: Tuple[str, ...] = ()) -> None:
    route = "adaptive"
    label = f"k={k},s={supercell}"
    fx = adaptive_fixture(points, k, supercell)
    hook = _corrupt_scatter_map if ck.fault == "scatter-map" else None
    outs = {}
    for ep in ("gather", "scatter"):
        if ep in skip_eps and ck.fault != "scatter-map":
            # certified equivalent to the legacy core at this plan shape:
            # the duplicate run is collapsed (equivalence.json) -- except
            # under a seeded fault, where the detector must still fire
            continue
        out = _run_checked(ck, route, label, points, k, supercell, ep,
                           fx.problem.grid.n_points, True, hook)
        if out is not None:
            outs[ep] = out
    _check_epilogues(ck, route, label, outs)
    classes = fx.problem.aplan.classes
    _check_class_hbm(ck, route, label, classes)
    _check_class_tiles(ck, route, label, fx.cfg, classes)


def _check_query(ck: _Checker, points, k: int, supercell: int,
                 skip_eps: Tuple[str, ...] = ()) -> None:
    from ..ops.query import bucket_queries

    route = "external-query"
    label = f"k={k},s={supercell}"
    queries = _queries()
    outs = {}
    for ep in ("gather", "scatter"):
        if ep in skip_eps:
            continue
        out = _run_checked(ck, route, label, points, k, supercell, ep,
                           queries.shape[0], False)
        if out is not None:
            outs[ep] = out
    _check_epilogues(ck, route, label, outs)
    p = legacy_fixture(points, k, supercell).problem
    q2cap = bucket_queries(queries, p.grid, supercell,
                           p.plan.n_chunks * p.plan.batch)[3]
    _check_tiles(ck, route, label, k=k, qcap=q2cap, ccap=p.pack.ccap, m=0)


def _check_sharded(ck: _Checker, points, k: int, supercell: int,
                   skip_eps: Tuple[str, ...] = ()) -> None:
    route = "sharded-chip"
    label = f"k={k},s={supercell}"
    outs = {}
    for ep in ("gather", "scatter"):
        if ep in skip_eps:
            continue
        try:
            sp = sharded_fixture(points, k, supercell, ep)
        except Exception as e:  # noqa: BLE001 -- a failed prepare IS the finding
            ck.fail("route-shape", route,
                    f"[{label}] slab prepare failed: "
                    f"{type(e).__name__}: {e}", subject=f"{route}:ready")
            return
        rows = sum(int(sp._chip_inputs(d)["sids"].shape[0])
                   for d in range(sp.meta.ndev)
                   if sp.chip_plans[d].classes)
        out = _run_checked(ck, route, label, points, k, supercell, ep,
                           rows, False)
        if out is not None:
            outs[ep] = out
    _check_epilogues(ck, route, label, outs)
    sp = sharded_fixture(points, k, supercell, "scatter")
    for d in range(sp.meta.ndev):
        if sp.chip_plans[d].classes:
            _check_class_tiles(ck, route, f"{label},slab={d}", sp.config,
                               sp._chip_ready(d).plan.classes)


def _check_pod(ck: _Checker, points, k: int, supercell: int) -> None:
    route = "pod-chip"
    label = f"k={k},s={supercell}"
    outs = {}
    for ep in ("gather", "scatter"):
        try:
            pp = pod_fixture(points, k, supercell, ep)
        except Exception as e:  # noqa: BLE001 -- a failed prepare IS the finding
            ck.fail("route-shape", route,
                    f"[{label}] pod prepare failed: "
                    f"{type(e).__name__}: {e}", subject=f"{route}:ready")
            return
        live = sum(1 for c in pp.chip_plans if c.classes)
        out = _run_checked(ck, route, label, points, k, supercell, ep,
                           live * pp.meta.pcap, False)
        if out is not None:
            outs[ep] = out
    _check_epilogues(ck, route, label, outs)
    pp = pod_fixture(points, k, supercell, "scatter")
    _check_pod_hbm(ck, label, pp, k)
    for d, plan in enumerate(pp.chip_plans):
        if plan.classes:
            _check_class_tiles(ck, route, f"{label},chip={d}", pp.config,
                               pp._chip_ready(d).plan.classes)


def _check_mxu_adaptive(ck: _Checker, points, k: int,
                        supercell: int) -> None:
    """The adaptive-mxu plan shape: the same result contract and both
    epilogues byte-equal -- the coverage that makes KnnConfig.scorer =
    'mxu' a first-class citizen of the route matrix."""
    route = "adaptive-mxu"
    rt = 0.9
    label = f"k={k},s={supercell},rt={rt}"
    fx = mxu_fixture(points, k, supercell, "scatter", rt)
    mxu_classes = [cp for cp in fx.problem.aplan.classes
                   if cp.route == "mxu"]
    if not mxu_classes:
        ck.fail("route-shape", route,
                f"[{label}] scorer='mxu' produced no MXU-routed class: the "
                f"contract coverage of the MXU plan shape is vacuous",
                hint="mxu.scorer.class_eligible or build_class_specs "
                     "regressed",
                subject=f"{route}:vacuous")
        return
    outs = {}
    for ep in ("gather", "scatter"):
        out = _run_checked(ck, route, label, points, k, supercell, ep,
                           fx.problem.grid.n_points, True)
        if out is not None:
            outs[ep] = out
    _check_epilogues(ck, route, label, outs)
    _check_dtypes(ck, route, label, lambda: run_route(
        route, points, k, supercell, "scatter"))


def mxu_brute_inputs(k: int, d: int, n: int = _N_POINTS,
                     recall_target: float = 0.9):
    """(selection args, m) of one brute-route selection at dimension d over
    the 400-point fixture, laid out as ``mxu.solve.solve_general`` lays it
    out (``select_inputs``, ``per_block_m``)."""
    from ..mxu.solve import select_inputs
    from ..mxu.topk import BLOCK, per_block_m

    rng = np.random.default_rng(_SEEDS[0])
    pts = (1.0 + rng.random((n, d)) * 998.0).astype(np.float32)
    qid, pts_il, cid_il = select_inputs(pts, n, True)
    m = per_block_m(recall_target, k, -(-n // BLOCK) * BLOCK // BLOCK)
    return (torch.as_tensor(pts), torch.as_tensor(qid),
            torch.as_tensor(pts_il), torch.as_tensor(cid_il)), m


def _check_mxu_brute(ck: _Checker, k: int, d: int) -> None:
    """The brute route's selection at dimension d: selection contract,
    shared memory within the limit at both precisions, launch records
    stable."""
    from ..mxu import kernel
    from ..ops.cuda_solve import SMEM_LIMIT
    from ..runtime import dispatch

    route = "mxu-brute"
    label = f"k={k},d={d}"
    args, m = mxu_brute_inputs(k, d)
    n = args[0].shape[0]
    try:
        with dispatch.record_launches() as r1:
            out = kernel.select_routed(*args, k, m, d, True)[1]
        with dispatch.record_launches() as r2:
            kernel.select_routed(*args, k, m, d, True)
    except Exception as e:  # noqa: BLE001 -- a failed selection IS the finding
        ck.fail("route-shape", route,
                f"[{label}] the selection failed: {type(e).__name__}: {e}",
                subject=f"{route}:trace:d={d}")
        return
    want = [((n, k), "int32"), ((n, k), "float32"), ((n,), "bool")]
    got = [(tuple(o.shape), str(o.dtype).removeprefix("torch."))
           for o in out]
    if got != want:
        ck.fail("route-shape", route,
                f"[{label}] outputs {got} != selection contract {want} "
                f"(ids by ascending score, scores, certification bits)",
                subject=f"{route}:shape:d={d}")
    if list(r1) != list(r2):
        ck.fail("recompile-key", route,
                f"[{label}] two selections of the same inputs launch "
                f"differently", subject=f"{route}:records:d={d}")
    misalign = 4 if ck.fault == "tile-misalign" else 0
    for precision, pick, smem in (
            ("f32", kernel.pick_launch, kernel.smem_bytes),
            ("bf16", kernel.pick_launch_bf16, kernel.smem_bytes_bf16)):
        rows, kc, qres = pick(d, k, m)
        need = smem(d, k, m, rows, kc, qres)
        if need > SMEM_LIMIT:
            ck.fail("smem-tile", route,
                    f"[{label},{precision}] {need} bytes of shared memory "
                    f"> the {SMEM_LIMIT}-byte limit of a Hopper block",
                    subject=f"{route}:tile:{precision}:d={d}")
        if (rows + misalign) % 16:
            ck.fail("smem-tile", route,
                    f"[{label},{precision}] {rows + misalign} query rows a "
                    f"block is not a multiple of the 16-row mma tile",
                    subject=f"{route}:tile:{precision}:d={d}")


def _check_resolution(ck: _Checker) -> None:
    """epilogue-agree's static half: 'auto' resolves exactly as documented
    (scatter on both devices: the port's kernels and plain versions fuse
    it) -- the single-source rule every route reads through
    resolved_epilogue()."""
    from ..config import resolve_epilogue

    if resolve_epilogue("auto") != "scatter":
        ck.fail("epilogue-agree", "config",
                "resolve_epilogue('auto') no longer maps to scatter: the "
                "documented routing contract broke",
                subject="config:auto")


def _census(ck: _Checker, k: int, supercell: int) -> None:
    """recompile-key census: does the legacy pack's signature depend on
    data *values* (same n, different seed)?  Capacities are measured from
    occupancy, so the census reports (info) rather than gates."""
    from ..runtime.dispatch import signature

    sigs = []
    for seed in _SEEDS:
        p = legacy_fixture(_points(seed), k, supercell).problem
        sigs.append(signature(p.pack, p.plan.qcap, p.plan.ccap, k))
    route = "legacy-pack"
    if sigs[0] != sigs[1]:
        ck.info("recompile-key", route,
                f"[k={k},s={supercell}] signature varies with data values "
                f"(occupancy-measured capacities): expected for this "
                f"engine, reported so growth shows up in CI diffs",
                subject=f"{route}:census")
    else:
        ck.info("recompile-key", route,
                f"[k={k},s={supercell}] signature stable across data seeds",
                subject=f"{route}:census")


def _env_state() -> Tuple[bool, dict]:
    from ..runtime.dispatch import kernel_launches

    return torch.cuda.is_initialized(), kernel_launches()


def _check_env(ck: _Checker, before: dict) -> None:
    cuda, launches = _env_state()
    if cuda:
        ck.fail("env-backend", "env",
                "a CUDA context exists in the checking process: the "
                "contract engine must run on the CPU (every fixture passes "
                "device='cpu'); a programmatic caller that initialized "
                "CUDA should run the gate in a process of its own",
                subject="env:cuda-context")
    if launches != before:
        ck.fail("env-backend", "env",
                f"kernel launches changed during the contract run "
                f"({before} -> {launches}): the gate launched a kernel",
                subject="env:kernel-launches")


def run_contracts(fault: Optional[str] = None) -> List[Finding]:
    """Run every contract over the config matrix.  ``fault`` (or the
    KNTPU_ANALYSIS_FAULT env knob) seeds one deliberate violation -- the
    self-test hook proving each detector actually fires.

    The committed equivalence certificates (analysis/equivalence.json,
    built by the verify engine) collapse the route matrix: a route whose
    cores are certified equivalent to the legacy pack's at a plan shape
    skips its duplicate scatter run there.  A missing or stale certificate
    file collapses nothing: checking can only widen, never narrow, without
    a committed proof."""
    from .proto import FAULTS as PROTO_FAULTS
    from .verify import FAULTS as VERIFY_FAULTS

    fault = fault if fault is not None else _fault()
    if fault is not None and fault not in FAULTS:
        if fault in VERIFY_FAULTS + PROTO_FAULTS:
            fault = None  # seeded into another engine, not this one
        else:
            raise ValueError(
                f"unknown analysis fault {fault!r}: expected one of "
                f"{FAULTS + VERIFY_FAULTS + PROTO_FAULTS}")
    ck = _Checker(fault=fault)
    cuda0, before = _env_state()
    if cuda0:
        _check_env(ck, before)
        return ck.findings
    from . import equiv

    cert = equiv.load_certificates()
    pts = _points(_SEEDS[0])
    ran = collapsed = 0
    for k in (8, 50):
        for supercell in (2, 3):
            _check_legacy(ck, pts, k, supercell)
            for route, checker in (("adaptive", _check_adaptive),
                                   ("external-query", _check_query),
                                   ("sharded-chip", _check_sharded)):
                skip = ("scatter",) if equiv.covers(
                    cert, k, supercell, route, "legacy-pack") else ()
                ran += 2 - len(skip)
                collapsed += len(skip)
                checker(ck, pts, k, supercell, skip_eps=skip)
            _check_mxu_adaptive(ck, pts, k, supercell)
            _check_pod(ck, pts, k, supercell)
            ran += 6  # legacy, adaptive-mxu and pod-chip run both epilogues
    for k in (8, 50):
        for d in (3, 6):
            _check_mxu_brute(ck, k, d)
    if collapsed:
        ck.info("matrix-collapse", "equivalence",
                f"route matrix collapsed by certificate: {ran} epilogue "
                f"runs, {collapsed} skipped as certified equivalent to the "
                f"legacy core (analysis/equivalence.json)",
                subject="matrix:collapse")
    _check_resolution(ck)
    _census(ck, 8, 3)
    _check_env(ck, before)
    return ck.findings
