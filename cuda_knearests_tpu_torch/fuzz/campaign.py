"""The differential fuzz campaign: every case through every route, against
the exact oracle, with failures minimized and banked.

Counterpart of ``cuda_knearests_tpu/fuzz/campaign.py``.  One case is one
adversarial point set (regenerable from its CaseSpec).  For each route the
campaign runs the solve on ``device``, applies the tie-aware comparison
(:mod:`compare`), and on any disagreement -- mismatch, missing route,
exception, or (under case isolation) a worker's death -- records a
:class:`CaseFailure`, delta-debugs the point set to a minimal repro
(:mod:`minimize`) and banks it into the port's corpus
(``tests/corpus_torch/*.npz``).

Isolation (``runtime/supervisor.py``):

  * ``'case'`` -- each case runs in a fresh worker (job 'fuzz_case'); a
    hard death (SIGKILL, a device fault that poisons the CUDA context, a
    wedge) costs that case: the parent banks it from its spec with the
    supervisor's failure kind and the campaign continues.
  * ``'none'`` -- in-process, with per-route exception containment.
  * ``'auto'`` -- 'case' on a CUDA device, 'none' on the CPU.

Before the first case the campaign resolves the device and, on CUDA,
builds or loads every kernel (:func:`prepare_device`): a missing card or
a failed build stops the run with an error, never as banked cases.

A failure matching :data:`WAIVERS` is recorded in the manifest with its
reason but does not fail the campaign.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import CORPUS_DIR, corpus_size, safe_bank_dir
from .compare import check_route_result
from .generators import DEFAULT_KS, DEFAULT_NS, CaseSpec, draw_cases, \
    generate_case, hazard_of
from .minimize import ddmin_points
from .routes import ROUTE_NAMES, oracle_reference, parse_fault, \
    route_excludes_self, run_route, self_solve
from ..utils import watchdog
from ..utils.memory import InputContractError, classify_fault_text

# (generator, route) -> reason; '*' matches any.  Empty: every
# disagreement found is repaired and banked, none waived.
WAIVERS: Dict[Tuple[str, str], str] = {}

# The configurations beyond the four routes that :func:`check_card_rows`
# also runs: kernel='blocked', and the gather epilogue (mode (b)) of both
# class kernels.
CARD_CONFIGS: Tuple[Tuple[str, dict], ...] = (
    ("blocked", dict(kernel="blocked")),
    ("gather", dict(epilogue="gather")),
    ("blocked gather", dict(kernel="blocked", epilogue="gather")))


@dataclasses.dataclass
class CaseFailure:
    """One route's failure on one case, manifest- and corpus-ready."""

    case_id: str
    generator: str
    hazard: str
    route: str
    kind: str        # 'mismatch' | 'missing-route' | supervisor taxonomy
    reason: str
    original_n: int
    minimized_n: Optional[int] = None
    banked: Optional[str] = None
    waived: Optional[str] = None  # the waiver's reason, when one applied

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def prepare_device(device=None):
    """The campaign's device (``utils.platform.resolve_device``), with
    every kernel built or loaded when it is a GPU: a missing card raises
    ``NoDeviceError`` and a failed build ``KernelBuildError`` here, before
    any case runs."""
    from ..utils.platform import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops import _build

        _build.load_all(_build.KERNELS)
    return dev


def _waiver_for(generator: str, route: str) -> Optional[str]:
    for key in ((generator, route), (generator, "*"), ("*", route),
                ("*", "*")):
        if key in WAIVERS:
            return WAIVERS[key]
    return None


def _route_failure(points: np.ndarray, k: int, route: str,
                   n_devices: int,
                   ref: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                   device=None) -> Optional[Tuple[str, str]]:
    """(kind, reason) when ``route`` disagrees with the oracle on
    ``points``, None when it is exact.  Exceptions are contained and
    classified: a legal input must never raise.  ``ref`` is a precomputed
    oracle answer for these points and this exclusion."""
    try:
        res = run_route(route, points, k, n_devices=n_devices,
                        device=device)
    except InputContractError as e:
        # the campaign generates only legal input: a refusal is an engine
        # bug (an overzealous contract), not a bad case
        return ("invalid-input",
                f"legal input refused: {type(e).__name__}: {e}")
    except Exception as e:  # noqa: BLE001 -- containment is the job: every raise on legal input is banked as a typed failure
        kind = classify_fault_text(f"{type(e).__name__}: {e}") or "crash"
        tail = traceback.format_exc(limit=3).strip().splitlines()[-1]
        return (kind, f"route raised {type(e).__name__}: {e} ({tail})")
    if res is None:
        return ("missing-route", "route produced no result")
    ids, d2 = res
    if ref is None:
        ref = oracle_reference(points, k, route_excludes_self(route))
    mismatch = check_route_result(points, points, ids, d2, ref[1], k)
    if mismatch is not None:
        return ("mismatch", mismatch.render())
    return None


def bank_case(bank_dir: str, spec: CaseSpec, route: str, kind: str,
              reason: str, points: np.ndarray) -> str:
    """Write one failing case: what a replay needs (points, k, route) and
    the forensics (spec, hazard, kind, reason)."""
    os.makedirs(bank_dir, exist_ok=True)
    path = os.path.join(bank_dir, f"{spec.case_id()}-{route}.npz")
    np.savez_compressed(
        path,
        points=np.asarray(points, np.float32),
        k=np.int32(spec.k),
        route=np.bytes_(route.encode()),
        kind=np.bytes_(kind.encode()),
        reason=np.bytes_(reason[:2000].encode()),
        hazard=np.bytes_(hazard_of(spec.generator).encode()),
        spec_json=np.bytes_(json.dumps(spec.to_json()).encode()))
    return path


def load_banked(path: str) -> dict:
    """Inverse of :func:`bank_case`: {'points', 'k', 'route', 'kind',
    'reason', 'hazard', 'spec'}."""
    with np.load(path) as z:
        return {
            "points": np.asarray(z["points"], np.float32),
            "k": int(z["k"]),
            "route": bytes(z["route"]).decode(),
            "kind": bytes(z["kind"]).decode(),
            "reason": bytes(z["reason"]).decode(),
            "hazard": bytes(z["hazard"]).decode(),
            "spec": CaseSpec.from_json(json.loads(bytes(z["spec_json"]))),
        }


def _safe_bank_dir(bank_dir: Optional[str]) -> Optional[str]:
    """A ``KNTPU_FUZZ_FAULT`` run never banks into a real corpus
    (``fuzz.safe_bank_dir``)."""
    return safe_bank_dir(bank_dir, parse_fault() is not None,
                         "kntpu-fuzz-faulted-")


def run_case(spec: CaseSpec, routes: Sequence[str] = ROUTE_NAMES,
             bank_dir: Optional[str] = None, minimize: bool = True,
             n_devices: int = 2, max_probes: int = 48,
             device=None) -> List[CaseFailure]:
    """Run one case through every route in-process on ``device``;
    minimize and bank each unwaived failure.  Returns the failures.

    Each route and each ddmin probe is one unit of work: it beats the
    stall watchdog's heartbeat when done (``utils.watchdog``), so a
    supervised worker's case may run longer than the stall limit as long
    as every unit finishes inside it."""
    points = generate_case(spec)
    bank_dir = _safe_bank_dir(bank_dir)
    failures: List[CaseFailure] = []
    refs = {}  # exclusion -> the oracle's answer, shared across routes
    for route in routes:
        excl = route_excludes_self(route)
        if excl not in refs:
            refs[excl] = oracle_reference(points, spec.k, excl)
        got = _route_failure(points, spec.k, route, n_devices,
                             ref=refs[excl], device=device)
        watchdog.heartbeat()
        if got is None:
            continue
        kind, reason = got
        failure = CaseFailure(
            case_id=spec.case_id(), generator=spec.generator,
            hazard=hazard_of(spec.generator), route=route, kind=kind,
            reason=reason, original_n=points.shape[0],
            waived=_waiver_for(spec.generator, route))
        repro = points
        if minimize and points.shape[0] > 1 and not failure.waived:
            # keep the failure's kind while shrinking: another failure on
            # a subset is another bug
            def _still_fails(sub):
                sub_got = _route_failure(sub, spec.k, route, n_devices,
                                         device=device)
                watchdog.heartbeat()
                return sub_got is not None and sub_got[0] == kind
            repro, _probes = ddmin_points(points, _still_fails,
                                          max_probes=max_probes)
        failure.minimized_n = int(repro.shape[0])
        # a waived failure keeps reproducing: it lives in the manifest,
        # never in the replayed corpus
        if bank_dir is not None and not failure.waived:
            failure.banked = bank_case(bank_dir, spec, route, kind, reason,
                                       repro)
        failures.append(failure)
    return failures


def _bits(d2) -> np.ndarray:
    return np.ascontiguousarray(d2, np.float32).view(np.int32)


def check_card_rows(spec: CaseSpec, device, n_devices: int = 2,
                    against_cpu: bool = True) -> Tuple[int, List[str]]:
    """Hold one case's rows on ``device`` two ways: every route and every
    :data:`CARD_CONFIGS` run exact against the oracle (tie-aware), and,
    when ``against_cpu``, equal to the same run on the CPU (the kernels'
    plain versions): ids equal, d2 equal bit for bit.  Returns (runs, one
    message per disagreement)."""
    from ..config import KnnConfig

    points = generate_case(spec)
    refs = {excl: oracle_reference(points, spec.k, excl)[1]
            for excl in (True, False)}
    runs = [(r, lambda dev, r=r: run_route(r, points, spec.k, n_devices,
                                           device=dev),
             route_excludes_self(r)) for r in ROUTE_NAMES]
    runs += [(name, lambda dev, kw=kw: self_solve(
                 points, KnnConfig(k=spec.k, **kw), dev), True)
             for name, kw in CARD_CONFIGS]
    problems: List[str] = []
    for name, run, excl in runs:
        ids, d2 = run(device)
        bad = check_route_result(points, points, ids, d2, refs[excl], spec.k)
        if bad is not None:
            problems.append(f"{spec.case_id()} {name}: {bad.render()}")
        elif against_cpu:
            cids, cd2 = run("cpu")
            if not (np.array_equal(ids, cids)
                    and np.array_equal(_bits(d2), _bits(cd2))):
                problems.append(f"{spec.case_id()} {name}: rows on "
                                f"{device} differ from the CPU's")
    return len(runs), problems


def run_case_job(job: dict) -> dict:
    """The supervisor worker's entry (``runtime/worker.py`` job
    'fuzz_case'): run one case in this isolated process and frame its
    failures back."""
    spec = CaseSpec.from_json(job["spec"])
    failures = run_case(
        spec, routes=tuple(job.get("routes") or ROUTE_NAMES),
        bank_dir=job.get("bank_dir"), minimize=bool(job.get("minimize", True)),
        n_devices=int(job.get("n_devices", 2)), device=job.get("device"))
    return {"case": spec.case_id(),
            "failures": [f.to_json() for f in failures]}


def _resolve_isolation(isolation: str, device) -> str:
    """'auto' -> 'case' on a CUDA device, 'none' on the CPU."""
    if isolation not in ("auto", "case", "none"):
        raise ValueError(f"unknown isolation {isolation!r}: expected "
                         f"'auto', 'case' or 'none'")
    if isolation != "auto":
        return isolation
    return "case" if device.type == "cuda" else "none"


def run_campaign(n_cases: int = 64, seed: int = 0,
                 routes: Sequence[str] = ROUTE_NAMES,
                 bank_dir: str = CORPUS_DIR,
                 budget_s: Optional[float] = None,
                 isolation: str = "auto", n_devices: int = 2,
                 minimize: bool = True,
                 log: Optional[Callable[[str], None]] = print,
                 device=None, ns: Tuple[int, ...] = DEFAULT_NS,
                 ks: Tuple[int, ...] = DEFAULT_KS) -> dict:
    """Run the whole campaign on ``device`` (default: the GPU); returns
    the manifest (``manifest['ok']``: no unwaived failure).  ``ns`` and
    ``ks`` are the palettes ``draw_cases`` draws n and k from.

    ``budget_s`` bounds the wall time: the seeded case list is fixed, and
    an expiring budget truncates its tail (``truncated_after``)."""
    log = log or (lambda s: None)
    t0 = time.monotonic()
    dev = prepare_device(device)
    mode = _resolve_isolation(isolation, dev)
    cases = draw_cases(n_cases, seed, ns=ns, ks=ks)
    supervisor = None
    if mode == "case":
        from ..runtime.supervisor import Supervisor

        supervisor = Supervisor()
    failures: List[CaseFailure] = []
    completed = 0
    truncated_after: Optional[int] = None
    for i, spec in enumerate(cases):
        if budget_s is not None and time.monotonic() - t0 > budget_s:
            truncated_after = i
            log(f"[{i}/{len(cases)}] budget {budget_s:.0f}s exhausted; "
                f"remaining cases truncated (the case list is seeded -- "
                f"rerun with a larger budget to cover them)")
            break
        case_failures = _run_one(spec, routes, bank_dir, minimize,
                                 n_devices, supervisor, dev)
        failures.extend(case_failures)
        completed += 1
        tag = "ok" if not case_failures else \
            "FAIL " + ",".join(f"{f.route}:{f.kind}" for f in case_failures)
        log(f"[{i + 1}/{len(cases)}] {spec.case_id()} "
            f"[{spec.generator}] {tag}")
    unwaived = [f for f in failures if not f.waived]
    return {
        "ok": not unwaived,
        "requested_cases": n_cases,
        "completed_cases": completed,
        "truncated_after": truncated_after,
        "seed": seed,
        "routes": list(routes),
        "isolation": mode,
        "elapsed_s": round(time.monotonic() - t0, 3),
        "failures": [f.to_json() for f in unwaived],
        "waived": [f.to_json() for f in failures if f.waived],
        "waivers": {f"{g}/{r}": why for (g, r), why in WAIVERS.items()},
        "corpus_size": corpus_size(bank_dir),
    }


def _run_one(spec: CaseSpec, routes: Sequence[str], bank_dir: str,
             minimize: bool, n_devices: int, supervisor,
             device=None) -> List[CaseFailure]:
    if supervisor is None:
        return run_case(spec, routes=routes, bank_dir=bank_dir,
                        minimize=minimize, n_devices=n_devices,
                        device=device)
    job = {"job": "fuzz_case", "spec": spec.to_json(),
           "routes": list(routes), "bank_dir": bank_dir,
           "minimize": minimize, "n_devices": n_devices,
           "device": None if device is None else str(device)}
    row, record = supervisor.run_job(spec.case_id(), job)
    if record is None:
        return [CaseFailure(**f) for f in row.get("failures", [])]
    # the worker died (crash, timeout, oom, ...): bank the case itself --
    # its points are pure numpy from the spec, safe to rebuild here even
    # though solving them was not.  No minimization in the parent:
    # shrinking a process-killing case must itself run isolated.
    failure = CaseFailure(
        case_id=spec.case_id(), generator=spec.generator,
        hazard=hazard_of(spec.generator), route="*", kind=record.kind,
        reason=f"worker died: {record.message}", original_n=spec.n,
        minimized_n=spec.n, waived=_waiver_for(spec.generator, "*"))
    safe_dir = _safe_bank_dir(bank_dir)
    if safe_dir is not None and not failure.waived:
        failure.banked = bank_case(safe_dir, spec, "all-routes", record.kind,
                                   failure.reason, generate_case(spec))
    return [failure]


def replay_banked(path: str, device=None, n_devices: int = 2
                  ) -> Optional[Tuple[str, str]]:
    """Replay one banked case of any flavor (by its file name: ``-approx``,
    ``-fof``, ``-mutation``, ``-pod``, else a point case) on ``device``:
    None when the failure it recorded stays fixed, else (kind, reason)."""
    name = os.path.basename(path)
    if name.endswith("-approx.npz"):
        from .approx import _approx_failure, load_approx_case

        b = load_approx_case(path)
        return _approx_failure(b["points"], b["k"], b["recall_target"],
                               precision=b["spec"].precision, device=device)
    if name.endswith("-fof.npz"):
        from .fof import _fof_failure, load_fof_case

        b = load_fof_case(path)
        return _fof_failure(b["points"], b["linking_length"], device=device)
    if name.endswith("-mutation.npz"):
        from .mutation import load_mutation_case, replay_ops

        b = load_mutation_case(path)
        got = replay_ops(b["spec"], b["ops"], device=device)
        return None if got is None else got[:2]
    if name.endswith("-pod.npz"):
        from .pod import _pod_failure, load_pod_case

        b = load_pod_case(path)
        return _pod_failure(b["points"], b["k"], b["ndev"], quick=True,
                            device=device)
    b = load_banked(path)
    routes = ROUTE_NAMES if b["route"] == "all-routes" else (b["route"],)
    for route in routes:
        got = _route_failure(b["points"], b["k"], route, n_devices,
                             device=device)
        if got is not None:
            return got[0], f"{route}: {got[1]}"
    return None
