"""Host-boundary dataflow model: the static half of the sync/transfer proof.

Counterpart of ``cuda_knearests_tpu/analysis/syncflow.py``.  The port's
host-boundary traffic is countable at runtime (``runtime/dispatch.py``:
``fetch`` / ``stage`` / ``ici`` and :class:`~..runtime.dispatch.trace_sites`);
this module makes it *provable* before any program runs, in three layers:

1. **Site discovery** (:func:`discover_sites`): an AST walk over the package
   finds every call to the sanctioned transfer primitives
   (``dispatch.fetch`` / ``dispatch.stage`` / ``dispatch.ici``) and every
   raw torch readback (``.cpu()``, ``.to("cpu")``, ``.item()``,
   ``torch.cuda.synchronize``).  Each sanctioned site must carry a
   ``# syncflow: <site-id>`` annotation naming it into the model's
   vocabulary; each raw readback must be registered in :data:`KNOWN_RAW`
   with a reason (they are all prepare-time, extraction or smoke surfaces
   -- *never* inside a solve window).  An unregistered transfer is a
   ``sync-leak`` finding: a host sync ``DispatchStats.host_syncs`` does not
   count.

2. **Host-boundary dataflow graph** (:data:`WINDOWS`): each solve window
   declares which sites it reaches, each with a symbolic *multiplicity*
   and *byte volume* in the problem parameters.  A static call graph
   (:func:`build_call_graph`) walked from each window's entry point proves
   the claim set complete: a dispatch site reachable from a window's entry
   but absent from its model is a ``sync-leak``.

3. **Symbolic bounds** (:meth:`Window.syncs_bound`): the proven per-window
   ``host_syncs`` expression, the reference's for every one of the 19
   routes (:func:`proven_bounds`).  The bounds must *dominate* the runtime
   counters everywhere and *equal* them on the 20k fixture --
   tests/test_torch_verify.py reconciles them per site against
   ``dispatch.trace_sites()`` records on the CPU, and the smoke's phase 10j
   on the card.

The windows keep the reference's entries, site ids, fetch and ICI
multiplicities and ``syncs`` / ``budget`` expressions.  Where the port's
code stages a different number of arrays, or its buffers differ, the stage
multiplicity or the byte expression is the port's own, and the window's
comment says so.

Everything here is host-only ``ast`` work: no torch import, no program
execution.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG_NAME = os.path.basename(_PKG_ROOT)

# Modules the dataflow model covers: every file whose code can run inside a
# solve window.  analysis/ itself, the fuzz/bench harnesses, and the CLI
# surfaces are out of scope (they *wrap* solve windows; their own fetches
# would double-count the windows they measure).
SCOPE = ("api.py", "ops", "parallel", "cluster", "serve", "runtime", "mxu",
         "pod", "tune")

_ANNOT_RE = re.compile(r"#\s*syncflow:\s*([A-Za-z0-9_-]+)")
_DISPATCH_ALIASES = ("_dispatch", "dispatch")


@dataclasses.dataclass(frozen=True)
class DiscoveredSite:
    """One transfer call site found in the source tree."""

    path: str        # repo-relative, forward slashes
    line: int
    qualname: str    # module-dotted, e.g. 'ops.query.query_knn'
    kind: str        # 'fetch' | 'stage' | 'ici' | 'raw'
    site_id: Optional[str]   # the `# syncflow:` annotation, if any
    in_loop: bool    # lexically inside a for/while loop
    end_line: int = 0  # last line of the call (a multi-line call's span)


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """A window's claim on one site: how often it fires per window and how
    many bytes ride it, symbolically in the window parameters.  Kind
    'ici' is chip-to-chip interconnect traffic (``dispatch.ici``, the pod
    halo exchange): counted bytes, NEVER a host sync -- it contributes to
    a window's byte model but can never appear in its ``syncs``
    expression."""

    kind: str        # 'fetch' | 'stage' | 'ici'
    mult: str        # symbolic count per window, e.g. '1', 'fb', 'rounds'
    bytes: str       # symbolic byte volume per window


@dataclasses.dataclass(frozen=True)
class Window:
    """One solve window's host-boundary dataflow graph."""

    entries: Tuple[str, ...]          # call-graph roots (qualnames)
    sites: Dict[str, SiteSpec]        # site_id -> claim
    syncs: str                        # proven host_syncs expression
    budget: str                       # the budget it must stay within
    includes: Tuple[str, ...] = ()    # sub-windows reached through edges
    # the call graph cannot resolve (documented attribute dispatch)
    notes: str = ""

    def all_site_ids(self, windows: Dict[str, "Window"]) -> Set[str]:
        """This window's claimed site ids, includes-closure."""
        out = set(self.sites)
        for inc in self.includes:
            out |= windows[inc].all_site_ids(windows)
        return out

    def syncs_bound(self, env: Dict[str, int]) -> int:
        """The proven host_syncs count under ``env`` bindings."""
        return int(evaluate(self.syncs, env))


# Window parameters (the symbolic vocabulary of every expression below):
#   n        stored points            q       external queries
#   k        neighbors per row        chunks  query chunks (1 = single shot)
#   classes  class launches issued    kern    1 when the kernel route ran
#   fb       1 when the brute fallback resolved uncertified rows
#   u_pad    fallback rows (the reference pads them to a power of two;
#            the port pads nothing, so here it binds the row count itself)
#   u_q      fallback query rows (exact count, external-query routes)
#   rounds   FoF pointer-jumping rounds until convergence
#   tomb     1 when a serving row touched a deleted point
#   delta    1 when the dirty-cell bound could not prune the delta launch
#   steps    pod halo-exchange ring depth (ppermute rounds per direction)
#   hcap     pod export-block capacity (points per halo block)
#   ndev     chips in the pod mesh
#   xchg     1 on the solve that runs the (cached) pod halo exchange
#   shards   Morton-range shards in an elastic pod index (serve tier)
PARAMS = ("n", "q", "k", "chunks", "classes", "kern", "fb", "u_pad", "u_q",
          "rounds", "tomb", "delta", "steps", "hcap", "ndev", "xchg",
          "shards")

WINDOWS: Dict[str, Window] = {
    # KnnProblem.solve() -- shared by the adaptive and legacy-pack routes:
    # both assemble device-resident and read back through _finalize's one
    # batched fetch, plus one more iff uncertified rows resolve.
    "solve": Window(
        entries=("api.KnnProblem.solve",),
        sites={
            "solve-final": SiteSpec("fetch", "1", "8*n*k + n + 4"),
            "solve-fallback": SiteSpec("fetch", "fb", "8*u_pad*k"),
            "solve-fallback-stage": SiteSpec("stage", "fb", "4*u_pad"),
        },
        syncs="1 + fb", budget="2"),
    # query_adaptive: per-class launches write mode (a) rows into
    # device-resident (q, k) buffers; one batched readback, one optional
    # fallback fetch.  Port: the shared front half (adaptive.query_device,
    # also the sharded and pod queries') stages the queries, the box rows
    # and the has-class mask once, and each class its source rows and
    # slots (query_pack), so query-class-stage counts 2*classes + 3 (the
    # reference: 5*classes).  The rows land through the staged forward map
    # inside the kernel launch, so the reference's separate placement
    # upload (adaptive-query-place-stage) has no counterpart here.
    "query-adaptive": Window(
        entries=("ops.adaptive.query_adaptive",),
        sites={
            "adaptive-query-final": SiteSpec("fetch", "1", "8*q*k + q"),
            "adaptive-query-fallback": SiteSpec("fetch", "fb", "8*u_q*k"),
            "adaptive-query-fallback-stage": SiteSpec(
                "stage", "fb", "12*u_q"),
            "query-class-stage": SiteSpec("stage", "2*classes + 3", "0"),
        },
        syncs="1 + fb", budget="2"),
    # query_knn (single-shot and chunked): all chunks' results ride ONE
    # batched fetch; kernel-route uncertified rows cost one more.
    "query-chunked": Window(
        entries=("ops.query.query_knn",),
        sites={
            "query-final": SiteSpec("fetch", "1", "8*q*k + kern*q"),
            "query-fallback": SiteSpec("fetch", "fb", "8*u_q*k"),
            "query-fallback-stage": SiteSpec("stage", "fb", "12*u_q"),
            "query-launch-stage": SiteSpec("stage", "4*chunks*kern", "0"),
            "query-chunk-stage": SiteSpec("stage", "chunks", "12*q"),
        },
        syncs="1 + fb", budget="2"),
    # sharded solve: every slab collects in one batched fetch (its stored
    # ids beside its rows); uncertified rows resolve against the HOST
    # kd-tree (zero syncs).
    "sharded-solve": Window(
        entries=("parallel.sharded.ShardedKnnProblem.solve",),
        sites={"sharded-solve-final": SiteSpec("fetch", "1", "0")},
        syncs="1", budget="2"),
    # sharded query: per-slab per-class launches (adaptive.query_device,
    # the shared front half -- its stage site is claimed here too)
    # collect in one batched fetch; resolution is the host oracle.  Port:
    # the front half runs once a slab, so its three fixed stages count
    # ndev times (ndev = the slabs with queries).
    "sharded-query": Window(
        entries=("parallel.sharded.ShardedKnnProblem.query",),
        sites={
            "sharded-query-final": SiteSpec("fetch", "1", "0"),
            "query-class-stage": SiteSpec("stage", "2*classes + 3*ndev",
                                          "0"),
        },
        syncs="1", budget="2"),
    # FoF: the per-round convergence flag is the ONLY mid-solve host
    # traffic; the labels/sizes ride one final batched fetch.  The proven
    # count is exact, not just a bound: rounds + 1.  Port: three stages
    # (the neighbour-cell table, its mask, the initial labels; the
    # reference stages four).
    "fof": Window(
        entries=("cluster.fof.fof_labels",),
        sites={
            "fof-round": SiteSpec("fetch", "rounds", "rounds"),
            "fof-final": SiteSpec("fetch", "1", "8*n"),
            "fof-stage": SiteSpec("stage", "3", "0"),
        },
        syncs="rounds + 1", budget="rounds + 1"),
    # The brute route (mxu/solve.py): staged inputs + ONE batched fetch of
    # the selection (ids + certificates -- distances are a pure-host
    # epilogue over it, zero extra syncs), plus one more batched fetch iff
    # uncertified rows resolve through the exact brute fallback.  Port:
    # the stored points, the queries (unless they are the stored points),
    # the query ids and the interleaved candidates and their ids: at most
    # 5 stages (the reference: 4); the exact brute pass stages its rows
    # once per call (the elementwise baseline's one call included), so
    # mxu-fallback-stage is at most 1 + fb (the reference: 2*fb).
    "mxu-brute": Window(
        entries=("mxu.solve.solve_general",),
        sites={
            "mxu-stage": SiteSpec("stage", "5", "0"),
            "mxu-final": SiteSpec("fetch", "1", "4*q*k + q"),
            "mxu-fallback": SiteSpec("fetch", "fb", "4*u_pad*k"),
            "mxu-fallback-stage": SiteSpec("stage", "1 + fb", "0"),
        },
        syncs="1 + fb", budget="2"),
    # Serving overlay query: the base problem's query window, plus one
    # fetch iff a row touched a tombstone, plus one iff the dirty-cell
    # bound could not prune the delta launch.
    "serve-overlay-query": Window(
        entries=("serve.delta.DeltaOverlay.query",),
        includes=("query-chunked",),
        sites={
            "overlay-resolve": SiteSpec("fetch", "tomb", "8*q*k"),
            "overlay-resolve-stage": SiteSpec("stage", "tomb", "0"),
            "overlay-alive-stage": SiteSpec("stage", "2*tomb", "0"),
            "overlay-delta-final": SiteSpec("fetch", "delta", "8*q*k"),
            "overlay-delta-stage": SiteSpec("stage", "2*delta", "0"),
            "overlay-delta-query-stage": SiteSpec("stage", "delta", "12*q"),
        },
        syncs="(1 + fb) + tomb + delta", budget="4",
        notes="base.query resolves through an attribute the call graph "
              "cannot follow; declared via includes and pinned by the "
              "serve byte-identity tests"),
    # One serving batch: exactly the overlay query window (sentinel-padded
    # to the bucket capacity; padding changes bytes, never sync counts).
    "serve-batch": Window(
        entries=("serve.daemon.ServeDaemon._execute",),
        includes=("serve-overlay-query",),
        sites={},
        syncs="(1 + fb) + tomb + delta", budget="4",
        notes="_run_batch -> overlay.query is attribute dispatch; "
              "declared via includes"),
    # One fleet batch (serve/fleet): the DRR scheduler dispatches one
    # tenant's flushed batch through that tenant's OWN
    # ServeDaemon._execute -- the fleet tier adds admission, scheduling
    # and replication bookkeeping (all host-side), never a transfer site,
    # so the proven bound is exactly the serve bound.  A BROWNED tenant
    # executes through the mxu-brute window instead (solve_general at the
    # degraded tier), an either/or whose 1 + fb is dominated by the serve
    # expression.
    "fleet-batch": Window(
        entries=("serve.fleet.frontdoor.FleetDaemon._run_batch",),
        includes=("serve-batch", "mxu-brute"),
        sites={},
        syncs="(1 + fb) + tomb + delta", budget="4",
        notes="_run_batch -> tenant.daemon._execute is attribute "
              "dispatch, _execute_degraded -> solve_general is the "
              "brownout tier; both declared via includes and pinned by "
              "the fleet cache-sharing + brownout byte-identity tests "
              "(tests/test_torch_fleet.py, tests/test_torch_autoscale.py)"),
    # Replication apply: a replica applies one committed DeltaRecord
    # through the overlay's insert/delete -- pure host CSR bookkeeping.
    # ZERO host syncs: the device staging those mutations imply is LAZY,
    # claimed by the overlay query window at the replica's next query.
    "fleet-replica-apply": Window(
        entries=("serve.fleet.replica.Replica.apply",),
        sites={},
        syncs="0", budget="0",
        notes="overlay.insert/delete mutate host state only; the "
              "deferred overlay-*-stage sites belong to "
              "serve-overlay-query"),
    # CPU sidecar: tiny/degenerate tenants answer from pure host numpy --
    # no kernel launched, no dispatch layer touched, zero host syncs.
    "fleet-sidecar": Window(
        entries=("serve.fleet.sidecar.CpuSidecar.query",),
        sites={},
        syncs="0", budget="0"),
    # Pod-partitioned solve (pod/): ONE batched fetch assembles every
    # chip's rows; uncertified rows resolve against the HOST kd-tree.  The
    # halo exchange is the pod-ici site: ``xchg`` (1 on the first solve,
    # cached after) ring rounds whose exact wire volume -- per ring step
    # and direction, every link of the chip chain ships one hcap-point
    # block (16 bytes/point) -- is chip-to-chip traffic, counted in
    # ici_bytes and NEVER in host_syncs.
    "pod-solve": Window(
        entries=("pod.solve.PodKnnProblem.solve",),
        sites={
            "pod-solve-final": SiteSpec("fetch", "1", "0"),
            "pod-ici": SiteSpec("ici", "xchg",
                                "32*hcap*steps*(ndev - 1)"),
        },
        syncs="1", budget="2"),
    # Pod external query: per-chip per-class launches (the shared
    # adaptive.query_device front half) collect in one batched fetch;
    # classless/uncertified rows resolve on the host oracle.  A query on a
    # never-solved problem triggers the cached exchange, so pod-ici is
    # claimed here too.  Port: query-class-stage as in sharded-query.
    "pod-query": Window(
        entries=("pod.solve.PodKnnProblem.query",),
        sites={
            "pod-query-final": SiteSpec("fetch", "1", "0"),
            "query-class-stage": SiteSpec("stage", "2*classes + 3*ndev",
                                          "0"),
            "pod-ici": SiteSpec("ici", "xchg",
                                "32*hcap*steps*(ndev - 1)"),
        },
        syncs="1", budget="2"),
    # Halo RE-exchange (pod/reshard.py): a delete of device-resident pod
    # points restages ONLY the dirty chips' slabs (bounded by 2*ndev:
    # points + ids per chip) and re-runs the exchange IFF a dirty cell
    # sits in its owner's export block.  ZERO host syncs.
    "pod-reexchange": Window(
        entries=("pod.reshard.PodOverlay.delete",),
        sites={
            "pod-reexchange-stage": SiteSpec("stage", "2*ndev", "0"),
            "pod-reexchange-ici": SiteSpec("ici", "xchg",
                                           "32*hcap*steps*(ndev - 1)"),
        },
        syncs="0", budget="0",
        notes="the dirty-cell overlay invalidates export blocks without "
              "reading anything back: mutation-side work is pure "
              "stage + ICI"),
    # Mutating pod query: the base pod query window, plus one fetch iff
    # the dirty-cell bound could not prune the insert-delta launch.
    "pod-overlay-query": Window(
        entries=("pod.reshard.PodOverlay.query",),
        includes=("pod-query",),
        sites={
            "reshard-delta-stage": SiteSpec("stage", "2*delta", "0"),
            "reshard-delta-query-stage": SiteSpec("stage", "delta",
                                                  "12*q"),
            "reshard-delta-final": SiteSpec("fetch", "delta", "8*q*k"),
        },
        syncs="1 + delta", budget="2",
        notes="self.pp.query is attribute dispatch; declared via "
              "includes and pinned by the reshard oracle tests"),
    # Mutating pod solve: the base pod solve window plus the same pruned
    # delta merge over the alive rows.
    "pod-overlay-solve": Window(
        entries=("pod.reshard.PodOverlay.solve",),
        includes=("pod-solve",),
        sites={
            "reshard-delta-stage": SiteSpec("stage", "2*delta", "0"),
            "reshard-delta-query-stage": SiteSpec("stage", "delta",
                                                  "12*q"),
            "reshard-delta-final": SiteSpec("fetch", "delta", "8*q*k"),
        },
        syncs="1 + delta", budget="2",
        notes="self.pp.solve is attribute dispatch; declared via "
              "includes"),
    # Elastic scatter-gather query (pod/reshard.py ElasticIndex): every
    # Morton-range shard answers through its OWN serve-overlay window; the
    # merge is pure host comparisons.  The bound is the per-shard overlay
    # bound times the shard count.
    "elastic-query": Window(
        entries=("pod.reshard.ElasticIndex.query",),
        includes=("serve-overlay-query",),
        sites={},
        syncs="shards * ((1 + fb) + tomb + delta)",
        budget="4 * shards",
        notes="shard.query -> overlay.query is attribute dispatch per "
              "shard; declared via includes and pinned by the elastic "
              "byte-identity tests"),
    # One autotuner trial (tune/search.py): ONE solve_general call under
    # the candidate plan's knobs -- the trial's entire host boundary IS
    # the mxu-brute window (the timer reads host-resident results), and
    # the searcher asserts the same bound at runtime per trial from the
    # dispatch counters (sync_bound_ok on every row).
    "tune-trial": Window(
        entries=("tune.search._run_trial",),
        includes=("mxu-brute",),
        sites={},
        syncs="1 + fb", budget="2",
        notes="the search loop around trials is pure host bookkeeping; "
              "elementwise-baseline trials run the same solve_general "
              "entry"),
}

# Which model window proves each runtime route's bound -- the route names
# match the reference's and the dispatch smoke's labels.
ROUTE_WINDOWS: Dict[str, str] = {
    "adaptive-solve": "solve",
    "legacy-pack-solve": "solve",
    "external-query-adaptive": "query-adaptive",
    "external-query-chunked": "query-chunked",
    "sharded-solve": "sharded-solve",
    "sharded-query": "sharded-query",
    "fof": "fof",
    "serve-batch": "serve-batch",
    "mxu-brute": "mxu-brute",
    "fleet-batch": "fleet-batch",
    "fleet-replica-apply": "fleet-replica-apply",
    "fleet-sidecar": "fleet-sidecar",
    "pod-solve": "pod-solve",
    "pod-query": "pod-query",
    "pod-reexchange": "pod-reexchange",
    "pod-overlay-query": "pod-overlay-query",
    "pod-overlay-solve": "pod-overlay-solve",
    "elastic-query": "elastic-query",
    "tune-trial": "tune-trial",
}

# Sanctioned dispatch sites that live OUTSIDE every solve window: lazy
# reconstruction, prepare-time staging and extraction surfaces.  They may be
# reachable from window entries (solve() -> plane feed -> _host_original),
# so the reachability check reports them as info, never as leaks.  The
# port adds the three sharded ones: the reference reads the sharded census
# and permutation back raw (KNOWN_RAW), the port through dispatch.
NONWINDOW: Dict[str, str] = {
    "host-original": "checkpoint-resumed problems reconstruct original-"
                     "order host points lazily, one counted fetch, cached; "
                     "prepared problems keep the validated input by "
                     "reference (zero syncs)",
    "extract-original": "get_knearests_original(): post-solve extraction "
                        "readback of the (host-resident) result plus the "
                        "permutation -- outside the solve window by the "
                        "timing contract",
    "pod-prepare-stage": "pod prepare's streamed slab staging: each "
                         "chip's bucket rides its own counted async H2D "
                         "transfer -- prepare-time traffic, zero syncs, "
                         "outside every solve window",
    "sharded-prepare-stage": "sharded prepare's slab staging: each slab's "
                             "bucket rides its own counted async upload -- "
                             "prepare-time traffic, zero syncs",
    "sharded-prepare-census": "sharded prepare's partition census: one "
                              "counted fetch of every slab's cell counts, "
                              "prepare-time",
    "sharded-permutation": "extraction surface (multi-slab "
                           "kn_get_permutation): one counted fetch of the "
                           "slabs' stored ids",
}

# Raw readbacks (.cpu() / .to("cpu") / .item() / torch.cuda.synchronize)
# the model accepts, by enclosing qualname: all prepare-time planning reads,
# extraction surfaces, smokes or waived diagnostics -- NEVER inside a solve
# window.  A raw readback in scope but absent here is a sync-leak finding
# (an uncounted host sync).
KNOWN_RAW: Dict[str, str] = {
    "api.KnnProblem._planned": "oracle backend: kd-tree build reads the "
                               "staged points once at prepare time",
    "api.KnnProblem._prepare": "prepare-time cell-count readback: the "
                               "plan's census, inside the prepare.grid "
                               "span",
    "api.KnnProblem.get_points": "extraction surface (reference parity)",
    "api.KnnProblem.get_permutation": "extraction surface",
    "api.save_problem": "checkpointing reads the grid once",
    "ops.adaptive.build_adaptive_plan": "prepare-time cell-count readback "
                                        "when no host census is supplied",
    "ops.solve.global_schedule": "prepare-time cell-count readback when "
                                 "no host census is supplied",
    "parallel.sharded.ShardedKnnProblem.stats": "waived diagnostics "
                                                "(kntpu-ok markers)",
    "parallel.__main__.main": "the slab smoke's per-slab row dump after "
                               "solve_device, outside every solve window",
    "parallel.distributed.allgather_counts": "the multi-process census "
                                             "gather at prepare time (gloo "
                                             "collectives on host tensors)",
    "parallel.distributed.z_mesh": "mesh construction: one device count "
                                   "per process, before any solve",
    "parallel.distributed.check_process_major": "prepare-time mesh-layout "
                                                "check: one flag per "
                                                "process",
    "pod.__main__._sync": "the pod smoke's timing fence between phases",
}


def evaluate(expr: str, env: Dict[str, int]) -> int:
    """Evaluate a symbolic expression over integer bindings.  The grammar
    is +, *, //, parentheses, max(), and :data:`PARAMS` names -- enforced
    by eval'ing with empty builtins over exactly the declared vocabulary."""
    scope = {p: int(env.get(p, 0)) for p in PARAMS}
    scope["max"] = max
    return int(eval(expr, {"__builtins__": {}}, scope))  # noqa: S307 -- closed grammar over PARAMS, no attribute access


def worst_case_env(rounds: int = 64) -> Dict[str, int]:
    """Indicator variables at their maxima -- what the budget proof binds."""
    return dict(fb=1, tomb=1, delta=1, kern=1, rounds=rounds,
                chunks=8, classes=8, n=1, q=1, k=1, u_pad=1, u_q=1,
                steps=8, hcap=1, ndev=8, xchg=1, shards=4)


# -- discovery ----------------------------------------------------------------

def _scope_files() -> List[str]:
    out = []
    for entry in SCOPE:
        p = os.path.join(_PKG_ROOT, entry)
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(filenames) if f.endswith(".py"))
    return sorted(out)


def _module_name(path: str) -> str:
    rel = os.path.relpath(path, _PKG_ROOT)
    return rel[:-3].replace(os.sep, ".").removesuffix(".__init__")


class _SiteVisitor(ast.NodeVisitor):
    def __init__(self, module: str, lines: Sequence[str]):
        self.module = module
        self.lines = lines
        self.stack: List[str] = []
        self.loops = 0
        self.sites: List[DiscoveredSite] = []

    def _qual(self) -> str:
        return ".".join([self.module] + self.stack) if self.stack \
            else self.module

    def visit_ClassDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node):
        self.stack.append(node.name)
        outer_loops, self.loops = self.loops, 0
        self.generic_visit(node)
        self.loops = outer_loops
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _loopy(self, node):
        self.loops += 1
        self.generic_visit(node)
        self.loops -= 1

    visit_For = visit_While = _loopy

    def _annotation(self, node) -> Optional[str]:
        end = getattr(node, "end_lineno", node.lineno)
        for ln in range(node.lineno, end + 1):
            m = _ANNOT_RE.search(self.lines[ln - 1])
            if m:
                return m.group(1)
        return None

    def _add(self, node, kind):
        self.sites.append(DiscoveredSite(
            path=f"{_PKG_NAME}/{self.module.replace('.', '/')}.py",
            line=node.lineno, qualname=self._qual(), kind=kind,
            site_id=self._annotation(node), in_loop=self.loops > 0,
            end_line=getattr(node, "end_lineno", node.lineno)))

    def visit_Call(self, node):
        f = node.func
        if isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name) \
                    and base.id in _DISPATCH_ALIASES \
                    and f.attr in ("fetch", "stage", "ici"):
                self._add(node, f.attr)
            elif _is_raw_readback(node):
                self._add(node, "raw")
        self.generic_visit(node)


def _is_raw_readback(node: ast.Call) -> bool:
    """The port's raw host readbacks: ``x.cpu()``, ``x.to("cpu")``,
    ``x.item()`` and ``torch.cuda.synchronize(...)`` -- each a host wait
    ``dispatch.fetch`` does not count."""
    f = node.func
    if f.attr in ("cpu", "item") and not node.args:
        return True
    if f.attr == "to":
        args = list(node.args) + [kw.value for kw in node.keywords
                                  if kw.arg == "device"]
        return bool(args) and isinstance(args[0], ast.Constant) \
            and args[0].value == "cpu"
    return (f.attr == "synchronize" and isinstance(f.value, ast.Attribute)
            and f.value.attr == "cuda" and isinstance(f.value.value, ast.Name)
            and f.value.value.id == "torch")


def discover_sites() -> List[DiscoveredSite]:
    """Every transfer site in the model's scope.  ``runtime/dispatch.py``
    itself (the primitives' definitions and smoke) is excluded."""
    sites: List[DiscoveredSite] = []
    for path in _scope_files():
        mod = _module_name(path)
        if mod == "runtime.dispatch":
            continue
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        v = _SiteVisitor(mod, source.splitlines())
        v.visit(ast.parse(source))
        sites.extend(v.sites)
    return sites


# -- call graph ---------------------------------------------------------------

def _resolve_relative(module: str, node: ast.ImportFrom) -> Optional[str]:
    """'from ..ops.adaptive import x' inside parallel.sharded ->
    'ops.adaptive' (package-relative dotted module), None if external."""
    if node.level == 0:
        name = node.module or ""
        if name.startswith(_PKG_NAME):
            return name[len(_PKG_NAME) + 1:] or None
        return None
    parts = module.split(".")[: -(node.level)] if node.level <= \
        len(module.split(".")) else []
    base = ".".join(parts)
    tail = node.module or ""
    return ".".join(x for x in (base, tail) if x) or None


def build_call_graph() -> Tuple[Dict[str, Set[str]], Set[str]]:
    """(edges: qualname -> callee qualnames, all defined qualnames).

    Best-effort resolution (plain names in the defining module, ``self.x``
    within the class, imported names, module-alias attributes); edges the
    AST cannot resolve are simply absent -- windows compensate with
    explicit ``includes`` declarations."""
    defs: Set[str] = set()
    modules: Dict[str, ast.Module] = {}
    aliases: Dict[str, Dict[str, str]] = {}
    for path in _scope_files():
        mod = _module_name(path)
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        modules[mod] = tree
        amap: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                src = _resolve_relative(mod, node)
                if src is None:
                    continue
                for a in node.names:
                    amap[a.asname or a.name] = f"{src}.{a.name}"
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.startswith(_PKG_NAME + "."):
                        amap[a.asname or a.name.split(".")[-1]] = \
                            a.name[len(_PKG_NAME) + 1:]
        aliases[mod] = amap

    qual_defs: Dict[str, List[Tuple[str, ast.AST]]] = {}
    for mod, tree in modules.items():

        def collect(node, stack):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    q = ".".join([mod] + stack + [child.name])
                    defs.add(q)
                    qual_defs.setdefault(mod, []).append(
                        (".".join(stack + [child.name]), child))
                    collect(child, stack + [child.name])
                elif isinstance(child, ast.ClassDef):
                    collect(child, stack + [child.name])
                else:
                    collect(child, stack)

        collect(tree, [])

    edges: Dict[str, Set[str]] = {}
    for mod, fns in qual_defs.items():
        amap = aliases[mod]
        local = {q.split(".")[-1]: f"{mod}.{q}" for q, _ in fns}
        by_class: Dict[str, Dict[str, str]] = {}
        for q, _ in fns:
            parts = q.split(".")
            if len(parts) == 2:
                by_class.setdefault(parts[0], {})[parts[1]] = f"{mod}.{q}"
        for q, fn in fns:
            src = f"{mod}.{q}"
            out = edges.setdefault(src, set())
            cls = q.split(".")[0] if "." in q else None
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                target = None
                if isinstance(f, ast.Name):
                    target = (local.get(f.id) or amap.get(f.id))
                elif isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Name):
                    if f.value.id == "self" and cls:
                        target = by_class.get(cls, {}).get(f.attr)
                    elif f.value.id in amap:
                        target = f"{amap[f.value.id]}.{f.attr}"
                    elif f.value.id[:1].isupper():
                        # ClassName.method within this module
                        target = by_class.get(f.value.id, {}).get(f.attr)
                if target and target in defs:
                    out.add(target)
                elif target:
                    # 'mod.func' where mod resolved but func is defined
                    # under a class or re-exported: accept module-level
                    # matches only
                    tail = target.split(".")[-1]
                    tmod = target.rsplit(".", 1)[0]
                    cand = f"{tmod}.{tail}"
                    if cand in defs:
                        out.add(cand)
    return edges, defs


def reachable(entries: Iterable[str],
              edges: Dict[str, Set[str]]) -> Set[str]:
    seen: Set[str] = set()
    todo = list(entries)
    while todo:
        q = todo.pop()
        if q in seen:
            continue
        seen.add(q)
        todo.extend(edges.get(q, ()))
    return seen


def site_lookup() -> Dict[Tuple[str, str, int], str]:
    """(kind, path, line) -> site id over every line of every annotated
    call, so a traced ``dispatch.SiteRecord`` (its caller's file and line)
    resolves to its annotated site."""
    out: Dict[Tuple[str, str, int], str] = {}
    for s in discover_sites():
        if s.kind == "raw" or not s.site_id:
            continue
        for ln in range(s.line, max(s.end_line, s.line) + 1):
            out[(s.kind, s.path, ln)] = s.site_id
    return out


def proven_bounds() -> Dict[str, str]:
    """route -> proven host_syncs expression, one per runtime route."""
    return {route: WINDOWS[w].syncs for route, w in ROUTE_WINDOWS.items()}
