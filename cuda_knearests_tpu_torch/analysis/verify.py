"""Engine 3: the dataflow verifier (kntpu-verify) of the port.

Counterpart of ``cuda_knearests_tpu/analysis/verify.py``: the same three
static gates and the same fault names, each with a seeded-fault self-test
proving its detector fires
(``KNTPU_ANALYSIS_FAULT=sync-leak|sig-data-dep|route-diverge`` -> rc 1):

* ``sync-leak`` / ``sync-budget`` -- the static sync/transfer proof
  (:mod:`.syncflow`): every host-boundary transfer site in the package is
  discovered by AST, must be annotated into the model's vocabulary, and
  every solve window's claimed site set is proven complete against the
  static call graph; the per-window symbolic ``host_syncs`` bound is then
  proven within budget.  The bounds are reconciled EXACTLY against the
  runtime dispatch counters on the 20k fixture by
  tests/test_torch_verify.py (CPU) and by the smoke's phase 10j (card).

* ``sig-data-dep`` -- recompile-stability: each route's signature census
  (``runtime.dispatch.signature`` over its launch records, from the
  contract engine's CPU fixtures) is computed across two data seeds (same
  n, k, supercell); atoms that vary may only be *capacity-lattice* values
  (powers of two / 128-multiples) or occupancy counts (reported as info).
  A raw data value baked into a launch key gates as an error.

* ``route-diverge`` -- cross-route equivalence (:mod:`.equiv`): the
  certificates are regenerated from fresh launch records and diffed
  against the committed ``analysis/equivalence.json``; any drift, a
  missing/stale file, or a plan shape losing its pair coverage gates.
  ``--write-equivalence`` re-blesses the artifact (a reviewed action, like
  ``--write-baseline``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from . import equiv, syncflow
from .findings import Finding

FAULTS = ("sync-leak", "sig-data-dep", "route-diverge")

_FAULT_ENV = "KNTPU_ANALYSIS_FAULT"


def _fault() -> Optional[str]:
    return os.environ.get(_FAULT_ENV) or None


def _fail(findings: List[Finding], rule: str, route: str, message: str,
          hint: str = "", subject: str = "") -> None:
    findings.append(Finding(rule=rule, severity="error",
                            path=f"route:{route}", line=0, message=message,
                            hint=hint, subject=subject or message))


def _info(findings: List[Finding], rule: str, route: str, message: str,
          subject: str = "") -> None:
    findings.append(Finding(rule=rule, severity="info",
                            path=f"route:{route}", line=0, message=message,
                            subject=subject or message))


# -- gate 1: static sync/transfer proof ---------------------------------------

def check_syncflow(fault: Optional[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    sites = syncflow.discover_sites()
    if fault == "sync-leak":
        # seeded fault: a fetch added to the finalize path without an
        # annotation -- the exact shape of a regression that would smuggle
        # an uncounted host sync into a solve window
        sites = sites + [syncflow.DiscoveredSite(
            path="cuda_knearests_tpu_torch/api.py", line=0,
            qualname="api.KnnProblem._finalize", kind="fetch",
            site_id=None, in_loop=True)]

    registered = set(syncflow.NONWINDOW)
    for win in syncflow.WINDOWS.values():
        registered |= set(win.sites)

    # 1a. every sanctioned transfer is annotated; every raw readback is in
    # the registry with a reason
    for s in sites:
        if s.kind == "raw":
            if s.qualname not in syncflow.KNOWN_RAW:
                _fail(findings, "sync-leak", "discovery",
                      f"raw readback at {s.path}:{s.line} ({s.qualname}) is "
                      f"not registered in syncflow.KNOWN_RAW: an uncounted "
                      f"host sync outside the dispatch accounting layer",
                      hint="route it through runtime.dispatch.fetch (and "
                           "annotate it), or register the qualname with a "
                           "reason why it is prepare-time/extraction-only",
                      subject=f"raw:{s.qualname}")
        elif s.site_id is None:
            _fail(findings, "sync-leak", "discovery",
                  f"dispatch.{s.kind} at {s.path}:{s.line} ({s.qualname}) "
                  f"carries no '# syncflow: <site-id>' annotation: the "
                  f"dataflow proof cannot account for it"
                  + (" -- and it sits inside a loop" if s.in_loop else ""),
                  hint="name the site and claim it in a syncflow.WINDOWS "
                       "entry (or NONWINDOW with a reason)",
                  subject=f"unannotated:{s.qualname}:{s.kind}")
        elif s.site_id not in registered:
            _fail(findings, "sync-leak", "discovery",
                  f"site '{s.site_id}' ({s.path}:{s.line}) is annotated "
                  f"but claimed by no window and not in NONWINDOW: its "
                  f"syncs are proven by nothing",
                  subject=f"unclaimed:{s.site_id}")

    # 1b. the model does not claim sites that no longer exist (drift)
    discovered_ids = {s.site_id for s in sites if s.site_id}
    for name, win in syncflow.WINDOWS.items():
        for sid in win.sites:
            if sid not in discovered_ids:
                _fail(findings, "sync-leak", name,
                      f"window '{name}' claims site '{sid}' which no "
                      f"longer exists in the source tree (stale model)",
                      subject=f"stale:{name}:{sid}")

    # 1c. call-graph completeness: every dispatch site reachable from a
    # window's entry is claimed by that window (includes-closure) or is a
    # registered non-window surface
    edges, defs = syncflow.build_call_graph()
    by_qual: Dict[str, List[syncflow.DiscoveredSite]] = {}
    for s in sites:
        by_qual.setdefault(s.qualname, []).append(s)
    for name, win in syncflow.WINDOWS.items():
        missing_entries = [e for e in win.entries if e not in defs]
        if missing_entries:
            _fail(findings, "sync-leak", name,
                  f"window '{name}' entry point(s) {missing_entries} not "
                  f"found in the source tree (stale model)",
                  subject=f"entry:{name}")
            continue
        claimed = win.all_site_ids(syncflow.WINDOWS)
        reach = syncflow.reachable(win.entries, edges)
        for q in sorted(reach):
            for s in by_qual.get(q, ()):
                if s.kind == "raw":
                    continue  # checked in 1a against KNOWN_RAW
                if s.site_id in claimed:
                    continue
                if s.site_id in syncflow.NONWINDOW:
                    _info(findings, "sync-leak", name,
                          f"non-window site '{s.site_id}' reachable from "
                          f"'{name}': {syncflow.NONWINDOW[s.site_id]}",
                          subject=f"nonwindow:{name}:{s.site_id}")
                    continue
                _fail(findings, "sync-leak", name,
                      f"dispatch.{s.kind} site "
                      f"'{s.site_id or '<unannotated>'}' at "
                      f"{s.path}:{s.line} is reachable from window "
                      f"'{name}' ({' -> '.join(win.entries)}) but absent "
                      f"from its dataflow model: the proven bound would "
                      f"undercount",
                      hint="claim the site in the window's model with a "
                           "multiplicity, or break the call edge",
                      subject=f"leak:{name}:{s.site_id}:{s.qualname}")

    # 1d. symbolic budget proof
    worst = syncflow.worst_case_env()
    for name, win in syncflow.WINDOWS.items():
        if "rounds" in win.syncs:
            samples = ({"rounds": r} for r in (0, 1, 2, 7, 33, 101))
            exact = all(
                syncflow.evaluate(win.syncs, {**worst, **s})
                == syncflow.evaluate(win.budget, {**worst, **s})
                for s in samples)
            if not exact:
                _fail(findings, "sync-budget", name,
                      f"window '{name}' proves host_syncs = {win.syncs} "
                      f"but its budget is {win.budget}: the symbolic forms "
                      f"disagree", subject=f"budget:{name}")
            else:
                _info(findings, "sync-budget", name,
                      f"proved host_syncs = {win.syncs} (exact, symbolic "
                      f"in rounds)", subject=f"proved:{name}")
            continue
        bound = win.syncs_bound(worst)
        budget = syncflow.evaluate(win.budget, worst)
        if bound > budget:
            _fail(findings, "sync-budget", name,
                  f"window '{name}' proves host_syncs <= {bound} "
                  f"({win.syncs} at worst-case indicators), over its "
                  f"budget of {budget}",
                  hint="the window gained a transfer site; batch it into "
                       "an existing fetch or raise the documented budget "
                       "deliberately",
                  subject=f"budget:{name}")
        else:
            _info(findings, "sync-budget", name,
                  f"proved host_syncs <= {bound} ({win.syncs}) within "
                  f"budget {budget}", subject=f"proved:{name}")
    return findings


# -- gate 2: recompile-stability ----------------------------------------------

def _lattice(v) -> bool:
    """True for capacity-lattice values: powers of two (>= 8, the pow2
    bucket ladder's floor) or multiples of 128 (kernel lane widths)."""
    if not isinstance(v, (int, np.integer)) or isinstance(v, bool):
        return False
    v = int(v)
    return (v >= 8 and (v & (v - 1)) == 0) or (v > 0 and v % 128 == 0)


def _atoms(x, out: List) -> List:
    if isinstance(x, (tuple, list)):
        for item in x:
            _atoms(item, out)
    else:
        out.append(x)
    return out


def _record_statics(records) -> tuple:
    """A route's launch records as signature statics: per launch its
    wrapper, mode, k, m, capacities and output shapes."""
    return tuple((r.wrapper, r.mode, r.k, r.m, r.q_tile, r.qcap, r.ccap,
                  r.s_total, r.out_shapes) for r in records)


def _route_signatures(seed: int) -> Dict[str, tuple]:
    """Per-route signature census from one data seed's plans: each route's
    device half run once on the CPU under ``dispatch.record_launches``
    (the contract engine's fixtures), keyed through
    ``runtime.dispatch.signature``."""
    from ..runtime.dispatch import signature
    from .contracts import (_points, legacy_fixture, mxu_brute_inputs,
                            record_route)

    pts = _points(seed)
    k, supercell = 8, 3
    p = legacy_fixture(pts, k, supercell).problem
    out = {"legacy-pack": signature(p.pack, p.plan.qcap, p.plan.ccap, k)}
    for route, name in (("adaptive", "adaptive"),
                        ("external-query", "external-query"),
                        ("sharded-chip", "sharded-chip"),
                        ("adaptive-mxu", "adaptive-mxu"),
                        ("pod-chip", "pod-chip")):
        recs = record_route(route, pts, k, supercell, "scatter")
        out[name] = signature((), *_record_statics(recs))
    from ..mxu import kernel
    from ..runtime import dispatch

    args, m = mxu_brute_inputs(k, 3)
    with dispatch.record_launches() as recs:
        kernel.select_routed(*args, k, m, 3, True)
    out["mxu-brute"] = signature(args, *_record_statics(recs))
    return out


def check_signatures(fault: Optional[str] = None) -> List[Finding]:
    from collections import Counter

    from .contracts import _SEEDS, _points

    findings: List[Finding] = []
    sig_a = _route_signatures(_SEEDS[0])
    sig_b = _route_signatures(_SEEDS[1])
    if fault == "sig-data-dep":
        # seeded fault: a raw coordinate from the data baked into one
        # route's recompile key -- the recompile-storm precursor shape
        leak = float(_points(_SEEDS[0])[0, 0])
        sig_a["adaptive"] = sig_a["adaptive"] + (leak,)
    for route in sig_a:
        a = Counter(map(repr, _atoms(sig_a[route], [])))
        b = Counter(map(repr, _atoms(sig_b[route], [])))
        varying = list(((a - b) + (b - a)).keys())
        if not varying:
            _info(findings, "sig-stability", route,
                  "executable signature stable across data seeds",
                  subject=f"stable:{route}")
            continue
        offenders = []
        counts = []
        for rep in varying:
            try:
                v = eval(rep, {"__builtins__": {}}, {})  # noqa: S307 -- repr of signature atoms (ints/strs/floats), no names in scope
            except Exception:  # noqa: BLE001 -- unparseable atom = offender by definition
                offenders.append(rep)
                continue
            if _lattice(v):
                continue  # capacity-lattice drift: the allowed axis
            if isinstance(v, (int, np.integer)):
                counts.append(v)
            else:
                offenders.append(rep)
        if offenders:
            _fail(findings, "sig-data-dep", route,
                  f"executable signature varies across data seeds through "
                  f"NON-lattice atoms {offenders[:4]}: a raw data value is "
                  f"baked into the recompile key -- every shifting input "
                  f"would recompile",
                  hint="quantize the offending component onto the class x "
                       "capacity x k lattice (pow2/128 rounding), or drop "
                       "it from the signature",
                  subject=f"data-dep:{route}")
        elif counts:
            _info(findings, "sig-stability", route,
                  f"signature varies through occupancy counts "
                  f"{sorted(set(counts))[:4]} (prepare-time retrace, "
                  f"expected; serving-path capacities stay lattice-"
                  f"quantized)", subject=f"counts:{route}")
        else:
            _info(findings, "sig-stability", route,
                  "signature varies only on the capacity lattice "
                  "(pow2/128 buckets)", subject=f"lattice:{route}")
    return findings


# -- gate 3: cross-route equivalence ------------------------------------------

def check_equivalence(fault: Optional[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    fresh = equiv.build_certificates(fault=fault)
    committed = equiv.load_certificates()
    if committed is None:
        _fail(findings, "route-diverge", "equivalence",
              "analysis/equivalence.json is missing or has a stale "
              "schema: the route matrix has no committed certificate",
              hint="regenerate with `python -m cuda_knearests_tpu_torch"
                   ".analysis --write-equivalence` and review the diff",
              subject="equiv:missing")
        return findings
    if fresh != committed:
        diverged = []
        for fc, cc in zip(fresh["cells"], committed["cells"]):
            for fam in fc["families"]:
                if fc["families"][fam] != cc["families"].get(fam):
                    diverged.append(
                        f"k={fc['k']},s={fc['supercell']},{fam}")
            if fc.get("mxu") != cc.get("mxu"):
                diverged.append(f"k={fc['k']},s={fc['supercell']},mxu")
            if fc.get("pod") != cc.get("pod"):
                diverged.append(f"k={fc['k']},s={fc['supercell']},pod")
        _fail(findings, "route-diverge", "equivalence",
              f"regenerated certificates diverge from the committed "
              f"analysis/equivalence.json at {diverged or ['<structure>']}"
              f": a route's canonical core no longer matches its "
              f"certified twin",
              hint="if the change is intentional (a deliberate core "
                   "edit), re-bless with --write-equivalence and review "
                   "which pairs were lost; otherwise the routes have "
                   "silently diverged -- the bug this gate exists for",
              subject="equiv:diverged")
    for cell in fresh["cells"]:
        label = f"k={cell['k']},s={cell['supercell']}"
        n_pairs = {fam: len(data["pairs"])
                   for fam, data in cell["families"].items()}
        best = max(n_pairs.values(), default=0)
        if best < 2:
            _fail(findings, "route-diverge", "equivalence",
                  f"[{label}] only {best} certified route pair(s) at this "
                  f"plan shape (need >= 2): the matrix-collapse "
                  f"precondition is gone", subject=f"equiv:thin:{label}")
        else:
            _info(findings, "route-equiv", "equivalence",
                  f"[{label}] certified pairs: gather={n_pairs.get('gather', 0)}, "
                  f"scatter={n_pairs.get('scatter', 0)}; bound to shared "
                  f"launch: "
                  f"{cell['families']['gather']['bound_to_shared']}",
                  subject=f"equiv:{label}")
        mxu = cell.get("mxu") or {}
        n_cores = len(mxu.get("classes", ()))
        eps = sorted(mxu.get("trace_hashes", {}))
        if n_cores and len(eps) == 2:
            _info(findings, "route-equiv", "equivalence",
                  f"[{label}] mxu plan shape pinned: {n_cores} MXU "
                  f"class(es) + both epilogues' launch records at "
                  f"recall_target={mxu.get('recall_target')} (drift gates "
                  f"as route-diverge)", subject=f"equiv:mxu:{label}")
        else:
            _fail(findings, "route-diverge", "equivalence",
                  f"[{label}] mxu certificate section is empty or partial "
                  f"(classes={n_cores}, epilogues={eps}): the MXU plan "
                  f"shape lost its drift pin",
                  hint="the adaptive-mxu fixture stopped routing classes "
                       "to the MXU tier, or an epilogue run failed; fix "
                       "and re-bless with --write-equivalence",
                  subject=f"equiv:mxu:{label}")
        pod = cell.get("pod") or {}
        pod_eps = sorted(pod.get("trace_hashes", {}))
        if pod.get("classes") and len(pod_eps) == 2:
            _info(findings, "route-equiv", "equivalence",
                  f"[{label}] pod plan shape pinned: "
                  f"{len(pod['classes'])} class(es) over the "
                  f"ndev={pod.get('ndev')} Morton-range window (ring "
                  f"depth {pod.get('steps')}) + both epilogues' launch "
                  f"records (drift gates as route-diverge)",
                  subject=f"equiv:pod:{label}")
        else:
            _fail(findings, "route-diverge", "equivalence",
                  f"[{label}] pod certificate section is empty or partial "
                  f"(classes={len(pod.get('classes', ()))}, "
                  f"epilogues={pod_eps}): the partitioned plan shape lost "
                  f"its drift pin",
                  hint="the pod fixture stopped planning classes over the "
                       "Morton-range window, or an epilogue run failed; "
                       "fix and re-bless with --write-equivalence",
                  subject=f"equiv:pod:{label}")
    return findings


# -- the proof against the runtime counters -----------------------------------

# The runtime routes measure_windows runs, in order (ROUTE_WINDOWS names).
MEASURED_ROUTES = ("adaptive-solve", "legacy-pack-solve",
                   "external-query-adaptive", "external-query-chunked",
                   "sharded-solve", "sharded-query", "fof", "mxu-brute",
                   "serve-batch", "pod-solve", "pod-query", "tune-trial")

# Sites whose byte expression measure_windows holds exactly.
_BYTE_SITES = ("solve-final", "adaptive-query-final", "query-final",
               "query-chunk-stage", "fof-final", "mxu-final")


def window_counts(run):
    """Run ``run()`` as one measurement window: (per-site fetch counts,
    per-site stage counts, per-site bytes, ``DispatchStats``, run's result,
    unmapped transfers), every ``dispatch.trace_sites`` record resolved to
    its annotated site (:func:`syncflow.site_lookup`)."""
    from ..runtime import dispatch

    lookup = syncflow.site_lookup()
    dispatch.reset_stats()
    with dispatch.trace_sites() as records:
        out = run()
    fetches: Dict[str, int] = {}
    stages: Dict[str, int] = {}
    nbytes: Dict[str, int] = {}
    unmapped = []
    for r in records:
        sid = lookup.get((r.kind, r.path, r.line))
        if sid is None:
            unmapped.append(f"{r.kind} at {r.path}:{r.line}")
            continue
        bucket = fetches if r.kind == "fetch" else stages
        bucket[sid] = bucket.get(sid, 0) + 1
        nbytes[sid] = nbytes.get(sid, 0) + r.nbytes
    return fetches, stages, nbytes, dispatch.stats(), out, unmapped


def reconcile(route: str, fetches: Dict[str, int], host_syncs: int,
              env: Dict[str, int], nbytes: Optional[Dict[str, int]] = None
              ) -> List[str]:
    """The measured window against its proof: ``host_syncs`` and the sum
    of the fetch counts equal the window's ``syncs`` expression at
    ``env``, every fetch site is claimed by the window (includes-closure)
    and fires its multiplicity, and the byte volumes of
    :data:`_BYTE_SITES` equal their expressions.  Returns the mismatches
    (empty when the proof holds)."""
    name = syncflow.ROUTE_WINDOWS[route]
    win = syncflow.WINDOWS[name]
    proven = win.syncs_bound(env)
    bad = []
    if host_syncs != proven:
        bad.append(f"host_syncs {host_syncs} != proven {win.syncs} = "
                   f"{proven} at {env}")
    if sum(fetches.values()) != proven:
        bad.append(f"fetch sites fired {sum(fetches.values())} times, "
                   f"proven {proven}")
    specs: Dict[str, syncflow.SiteSpec] = {}

    def collect(w):
        specs.update(w.sites)
        for inc in w.includes:
            collect(syncflow.WINDOWS[inc])
    collect(win)
    for sid, count in fetches.items():
        spec = specs.get(sid)
        if spec is None or spec.kind != "fetch":
            bad.append(f"fetch site {sid!r} is not claimed by {name!r}")
        elif count != syncflow.evaluate(spec.mult, env):
            bad.append(f"{sid} fired {count}x, proven {spec.mult} = "
                       f"{syncflow.evaluate(spec.mult, env)}")
    for sid in _BYTE_SITES:
        if nbytes and sid in nbytes and sid in specs:
            want = syncflow.evaluate(specs[sid].bytes, env)
            if nbytes[sid] != want:
                bad.append(f"{sid} moved {nbytes[sid]} bytes, proven "
                           f"{specs[sid].bytes} = {want}")
    return bad


def measure_windows(points: np.ndarray, queries: np.ndarray, device,
                    k: int = 10, routes=MEASURED_ROUTES,
                    mxu_points: Optional[np.ndarray] = None,
                    chunk: int = 256) -> List[dict]:
    """Run each runtime route once on ``device`` as a measurement window
    and hold it to its proof (:func:`reconcile`): the adaptive and legacy
    solves, the adaptive and chunked (256 a chunk) external queries, the
    sharded solve and query over two slabs on ``device``, FoF at b = 12,
    the brute route (over ``mxu_points``, default ``points``), one
    serving batch after a delete and an insert (tombstones and a delta
    live), the pod solve and query over two chips on ``device`` and one
    autotuner trial.  Preparation runs outside the windows.  One row a
    route: {route, window, syncs, env, proven, measured, fetches,
    launches (kernel launches in the window, by kernel), problems}."""
    from .. import KnnConfig, KnnProblem
    from ..cluster.fof import fof_labels
    from ..mxu.solve import solve_general
    from ..parallel.sharded import ShardedKnnProblem
    from ..pod.solve import PodKnnProblem
    from ..runtime import dispatch
    from ..serve import ServeConfig, ServeDaemon
    from ..tune.search import _run_trial

    points = np.ascontiguousarray(points, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    mxu_points = points if mxu_points is None else mxu_points
    n, q = points.shape[0], queries.shape[0]
    rows: List[dict] = []

    def measure(route, run, env_of):
        before = dispatch.kernel_launches()
        fetches, stages, nbytes, st, out, unmapped = window_counts(run)
        after = dispatch.kernel_launches()
        env = env_of(fetches, stages, out)
        problems = reconcile(route, fetches, st.host_syncs, env, nbytes)
        problems += [f"untraceable {u}" for u in unmapped]
        win = syncflow.WINDOWS[syncflow.ROUTE_WINDOWS[route]]
        rows.append({
            "route": route, "window": syncflow.ROUTE_WINDOWS[route],
            "syncs": win.syncs, "env": env,
            "proven": win.syncs_bound(env), "measured": st.host_syncs,
            "fetches": fetches,
            "launches": {kn: after[kn] - before[kn] for kn in after
                         if after[kn] != before[kn]},
            "problems": problems})

    def solve_env(p):
        def env_of(fetches, stages, out):
            u = int(out.uncert_count)
            fb = int(u > 0 and p.config.fallback == "brute")
            return dict(n=n, k=k, fb=fb, u_pad=u * fb)
        return env_of

    def query_env(fetches, stages, out):
        fb = int("adaptive-query-fallback" in fetches)
        return dict(q=q, k=k, fb=fb, classes=(
            stages.get("query-class-stage", 0) - 3) // 2)

    def chunked_env(fetches, stages, out):
        return dict(q=q, k=k, chunks=-(-q // chunk), fb=int(
            "query-fallback" in fetches),
            kern=int(stages.get("query-launch-stage", 0) > 0))

    want = set(routes)
    if want & {"adaptive-solve", "external-query-adaptive"}:
        pa = KnnProblem.prepare(points, KnnConfig(k=k), device=device)
        if "adaptive-solve" in want:
            measure("adaptive-solve", pa.solve, solve_env(pa))
        if "external-query-adaptive" in want:
            measure("external-query-adaptive", lambda: pa.query(queries),
                    query_env)
    if "legacy-pack-solve" in want:
        pl = KnnProblem.prepare(points, KnnConfig(k=k, adaptive=False),
                                device=device)
        measure("legacy-pack-solve", pl.solve, solve_env(pl))
    if "external-query-chunked" in want:
        pc = KnnProblem.prepare(points, KnnConfig(
            k=k, adaptive=False, query_chunk=chunk), device=device)
        measure("external-query-chunked", lambda: pc.query(queries),
                chunked_env)
    if want & {"sharded-solve", "sharded-query"}:
        sp = ShardedKnnProblem.prepare(points, config=KnnConfig(k=k),
                                       devices=[device] * 2)
        if "sharded-solve" in want:
            measure("sharded-solve", sp.solve, lambda f, s, o: {})
        if "sharded-query" in want:
            measure("sharded-query", lambda: sp.query(queries),
                    lambda f, s, o: dict(ndev=2, classes=(s.get(
                        "query-class-stage", 0) - 6) // 2))
    if "fof" in want:
        measure("fof", lambda: fof_labels(points, 12.0, device=device),
                lambda f, s, o: dict(n=n, rounds=o.rounds))
    if "mxu-brute" in want:
        mq = mxu_points.shape[0]
        measure("mxu-brute",
                lambda: solve_general(mxu_points, k=k, recall_target=0.9,
                                      refine="brute", precision="f32",
                                      device=device),
                lambda f, s, o: dict(q=mq, k=k, fb=int(
                    "mxu-fallback" in f), u_pad=int(o.uncert_count)))
    if "serve-batch" in want:
        base = KnnProblem.prepare(points, KnnConfig(k=k, adaptive=False),
                                  device=device)
        # no warmup: the bucket ladder's warm launches are not the window
        daemon = ServeDaemon(base, ServeConfig(warmup=False))
        daemon.submit(1, "delete", np.arange(0, n, 97, dtype=np.int64))
        daemon.submit(2, "insert", queries[:64] * 0.999 + 0.5)
        daemon.drain()
        batch = queries[:64]

        def serve_run():
            daemon.submit(3, "query", batch)
            return daemon.drain()

        measure("serve-batch", serve_run, lambda f, s, o: dict(
            q=batch.shape[0], k=k, fb=int("query-fallback" in f),
            tomb=int("overlay-resolve" in f),
            delta=int("overlay-delta-final" in f), chunks=1,
            kern=int(s.get("query-launch-stage", 0) > 0)))
    if want & {"pod-solve", "pod-query"}:
        pp = PodKnnProblem.prepare(points, config=KnnConfig(k=k),
                                   mesh=[device] * 2)
        if "pod-solve" in want:
            measure("pod-solve", pp.solve, lambda f, s, o: {})
        if "pod-query" in want:
            measure("pod-query", lambda: pp.query(queries),
                    lambda f, s, o: dict(ndev=2, classes=(s.get(
                        "query-class-stage", 0) - 6) // 2))
    if "tune-trial" in want:
        measure("tune-trial",
                lambda: _run_trial(mxu_points, k, 1.0, {"scorer": "mxu"},
                                   device=device)[0],
                lambda f, s, o: dict(q=mxu_points.shape[0], k=k, fb=int(
                    "mxu-fallback" in f), u_pad=int(o.uncert_count)))
    return rows


# -- engine entry -------------------------------------------------------------

def run_verify(fault: Optional[str] = None) -> List[Finding]:
    """Run all three verifier gates.  ``fault`` (or KNTPU_ANALYSIS_FAULT)
    seeds one deliberate violation; contract-engine faults are ignored
    here (they seed engine 1)."""
    from .contracts import FAULTS as CONTRACT_FAULTS
    from .proto import FAULTS as PROTO_FAULTS

    fault = fault if fault is not None else _fault()
    if fault is not None and fault not in FAULTS:
        if fault in CONTRACT_FAULTS + PROTO_FAULTS:
            fault = None
        else:
            raise ValueError(
                f"unknown analysis fault {fault!r}: expected one of "
                f"{CONTRACT_FAULTS + FAULTS + PROTO_FAULTS}")
    findings = check_syncflow(fault)
    findings += check_signatures(fault)
    findings += check_equivalence(fault)
    return findings
