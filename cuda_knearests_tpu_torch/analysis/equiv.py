"""Cross-route equivalence certificates over launch records.

Counterpart of ``cuda_knearests_tpu/analysis/equiv.py``.  The reference
proves that its four kNN routes lower to the same compute core by hashing
the ``pallas_call`` equations of their jaxprs.  The port has no IR to hash:
its compute cores are the hand kernels of ``csrc/``, and every route
reaches them through a few wrappers (``ops.cuda_solve.supercell_topk`` /
``blocked_topk``, ``mxu.kernel.select_routed`` / ``select_split``).  Each
wrapper leaves one :class:`~..runtime.dispatch.LaunchRecord` per call
(:class:`~..runtime.dispatch.record_launches`), taken before it branches
between its kernel and its plain version, so a route run on the CPU
records exactly what the card launches.  This module turns those records
into the proof object:

* :func:`canonical_hash` -- a canonical form of a set of launch records.
  A core's identity is its wrapper and mode plus the sha256 of the kernel
  sources as ``ops/_build`` resolves their includes -- nothing torch
  prints, so the CPU build and the CUDA build of torch hash alike.  Two
  of the reference's normalisations still apply: with ``normalize_dims``
  the capacities (query tile, query, candidate and supercell capacities,
  output rows) are renamed to symbols in order of first appearance within
  a launch, so the same launch at two capacities normalises the same; and
  launches of independent classes hash as a multiset, independent of
  their order.

* :func:`route_cores` -- a route's cores: per launch its kernels, wrapper,
  mode, concrete hash and normalised hash, sorted.

* :func:`build_certificates` -- per plan-shape cell (k x supercell), every
  route runs its device half on the CPU over the 400-point fixture
  (``contracts``), in both epilogue families (gather <-> mode (b), scatter
  <-> mode (a)).  Its cores are *bound* to the shared launch (the class
  kernel called directly on the legacy pack must hash identically), and
  route pairs whose normalised core sets coincide are certified.  The
  ``mxu`` and ``pod`` sections pin the MXU-tier and pod plan shapes.  The
  result is the committed ``analysis/equivalence.json``; the verify engine
  regenerates and diffs it (``route-diverge``), and the contract engine
  collapses its route matrix across certified pairs.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

EQUIV_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "equivalence.json")
# The port's own schema (the reference's is 3, over jaxprs): cells over
# launch records, with the "mxu" and "pod" sections.
EQUIV_SCHEMA = 1

# The (k, supercell) plan-shape matrix -- matches contracts.run_contracts.
MATRIX: Tuple[Tuple[int, int], ...] = ((8, 2), (8, 3), (50, 2), (50, 3))

ROUTES = ("legacy-pack", "adaptive", "external-query", "sharded-chip")

_MXU_RT = 0.9  # the certificate's representative sub-1.0 recall target

# The capacity fields of a launch record: renamed to symbols under
# normalisation.  k and m stay concrete (they pick the kernel's
# instantiation, as a block shape does in the reference); the launch tile
# q_tile is a function of (k, qcap, m), so the normalised form drops it
# (a 128-slot tile beside a 128-slot capacity must not read as structure).
_CAP_FIELDS = ("s_total", "qcap", "ccap")

_SOURCE_SHA: Dict[str, str] = {}


def _sha(*parts: Any) -> str:
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]


def source_sha(kernel: str) -> str:
    """sha256 of ``csrc/<kernel>.cu`` and every ``csrc`` header it
    includes, as ``ops/_build`` resolves them (the bytes the card's nvcc
    compiles; no flag, no torch version)."""
    if kernel not in _SOURCE_SHA:
        from ..ops import _build

        h = hashlib.sha256()
        for part in _build._sources(_build._CSRC / f"{kernel}.cu", set()):
            h.update(hashlib.sha256(part).digest())
        _SOURCE_SHA[kernel] = h.hexdigest()[:16]
    return _SOURCE_SHA[kernel]


def _as_dict(rec) -> Dict[str, Any]:
    return rec if isinstance(rec, dict) else rec.as_dict()


def record_key(rec, normalize_dims: bool = False) -> Tuple:
    """The canonical key of one launch: its core identity (wrapper, mode,
    kernels and their source hashes), k, m, the capacities, the input
    dtypes and the output shapes -- capacities and every output dimension
    but the k axis renamed to symbols in order of first appearance with
    ``normalize_dims``."""
    r = _as_dict(rec)
    dims: Optional[Dict[int, str]] = {} if normalize_dims else None

    def cap(v: int):
        if dims is None:
            return int(v)
        return dims.setdefault(int(v), f"D{len(dims)}")

    kernels = tuple(r["kernels"])
    ident = (r["wrapper"], r["mode"], kernels,
             tuple(source_sha(kn) for kn in kernels))
    caps = tuple(cap(r[f]) for f in _CAP_FIELDS)
    if dims is None:
        caps += (int(r["q_tile"]),)
    outs = tuple(tuple(int(d) if j == 1 and len(shape) > 1 else cap(d)
                       for j, d in enumerate(shape))
                 for shape in r["out_shapes"])
    return (ident, int(r["k"]), int(r["m"]), caps,
            tuple(r["in_dtypes"]), outs)


def canonical_hash(records: Sequence, normalize_dims: bool = False) -> str:
    """Canonical content hash of a set of launch records (see the module
    docstring): the multiset of their :func:`record_key` hashes."""
    return _sha("launches", tuple(sorted(
        _sha(*record_key(r, normalize_dims)) for r in records)))


def route_cores(records: Sequence) -> List[Dict[str, Any]]:
    """A route's compute cores, one per launch: {kernels, wrapper, mode,
    hash (concrete), norm_hash (capacities symbolised)}, sorted for
    deterministic comparison."""
    out = []
    for rec in records:
        r = _as_dict(rec)
        out.append({"kernel": "+".join(r["kernels"]),
                    "wrapper": r["wrapper"], "mode": r["mode"],
                    "hash": canonical_hash([r]),
                    "norm_hash": canonical_hash([r], normalize_dims=True)})
    out.sort(key=lambda c: (c["kernel"], c["hash"]))
    return out


def _shared_launch_cores(points, k: int, supercell: int
                         ) -> Dict[str, List[str]]:
    """Concrete core hashes of the SHARED launch called standalone on the
    legacy fixture's pack -- the binding reference: a route core matching
    one of these provably launches the shared kernel at that shape."""
    from .contracts import record_shared_launch

    return {ep: [c["hash"] for c in route_cores(
        record_shared_launch(points, k, supercell, ep))]
        for ep in ("gather", "scatter")}


def _mxu_cell(points, k: int, supercell: int) -> Dict[str, Any]:
    """The MXU plan shape's section: the grid route under
    ``scorer='mxu'`` at recall_target 0.9.  The port's MXU tier
    (``mxu.scorer.grid_class_topk``) is plain torch with no kernel of its
    own, so this section is a drift pin: the launch-record hash of the
    route in both epilogue families (its kernel classes) and the
    MXU-routed classes' capacities."""
    from .contracts import mxu_fixture, record_route

    out: Dict[str, Any] = {"recall_target": _MXU_RT, "trace_hashes": {},
                           "classes": []}
    for ep in ("gather", "scatter"):
        out["trace_hashes"][ep] = canonical_hash(
            record_route("adaptive-mxu", points, k, supercell, ep))
    fx = mxu_fixture(points, k, supercell, "scatter", _MXU_RT)
    for cp in fx.problem.aplan.classes:
        if cp.route == "mxu":
            out["classes"].append({"qcap": int(cp.qcap),
                                   "ccap": int(cp.ccap),
                                   "radius": int(cp.radius)})
    return out


def _pod_cell(points, k: int, supercell: int) -> Dict[str, Any]:
    """The pod-partitioned plan shape's section: the launch-record hash
    of the pod's per-chip solve over two chips (both epilogue families)
    and the decomposition facts -- an edit to the partitioner that moves
    a class gates as ``route-diverge``."""
    from .contracts import pod_fixture, record_route

    out: Dict[str, Any] = {"trace_hashes": {}, "classes": []}
    for ep in ("gather", "scatter"):
        out["trace_hashes"][ep] = canonical_hash(
            record_route("pod-chip", points, k, supercell, ep))
    pp = pod_fixture(points, k, supercell, "scatter")
    out["ndev"], out["steps"] = int(pp.meta.ndev), int(pp.meta.steps)
    chip = max(pp.chip_plans, key=lambda c: len(c.classes))
    for sc in chip.classes:
        out["classes"].append({"qcap": int(sc.qcap), "ccap": int(sc.ccap),
                               "radius": int(sc.radius),
                               "route": sc.route})
    return out


def build_certificates(fault: Optional[str] = None) -> Dict[str, Any]:
    """The full certificate object (the content of equivalence.json).

    Per (k, supercell) cell and epilogue family: each route's cores, the
    shared-launch binding verdict, and the certified pairs (equal
    normalised core sets).  ``fault='route-diverge'`` perturbs one
    route's cores -- the self-test hook proving the divergence detector
    fires."""
    from .contracts import _SEEDS, _points, record_route

    points = _points(_SEEDS[0])
    cells: List[Dict[str, Any]] = []
    for k, supercell in MATRIX:
        cell: Dict[str, Any] = {"k": k, "supercell": supercell,
                                "families": {}}
        shared = _shared_launch_cores(points, k, supercell)
        for epilogue in ("gather", "scatter"):
            routes: Dict[str, List[Dict[str, Any]]] = {}
            trace_hashes: Dict[str, str] = {}
            for route in ROUTES:
                recs = record_route(route, points, k, supercell, epilogue)
                cores = route_cores(recs)
                trace_hashes[route] = canonical_hash(recs)
                if fault == "route-diverge" and route == "adaptive":
                    cores = [dict(c, hash=c["hash"] + "-faulted",
                                  norm_hash=c["norm_hash"] + "-faulted")
                             for c in cores]
                    trace_hashes[route] += "-faulted"
                routes[route] = cores
            bound = sorted(
                route for route, cores in routes.items()
                if shared[epilogue]
                and any(c["hash"] in shared[epilogue] for c in cores))
            pairs = []
            names = sorted(routes)
            for i, a in enumerate(names):
                for b in names[i + 1:]:
                    ha = {c["norm_hash"] for c in routes[a]}
                    hb = {c["norm_hash"] for c in routes[b]}
                    if ha and ha == hb:
                        pairs.append([a, b])
            cell["families"][epilogue] = {
                "cores": {r: [{kk: c[kk] for kk in
                               ("kernel", "wrapper", "mode", "hash",
                                "norm_hash")}
                              for c in cs] for r, cs in routes.items()},
                "trace_hashes": trace_hashes,
                "shared_launch": shared[epilogue],
                "bound_to_shared": bound,
                "pairs": pairs,
            }
        cell["mxu"] = _mxu_cell(points, k, supercell)
        cell["pod"] = _pod_cell(points, k, supercell)
        cells.append(cell)
    return {"schema": EQUIV_SCHEMA, "cells": cells}


def norm_hashes(cert: Dict[str, Any], k: int, supercell: int,
                epilogue: str, route: str) -> List[str]:
    """The committed normalised core hashes of one route at one cell."""
    for cell in cert.get("cells", ()):
        if cell.get("k") == k and cell.get("supercell") == supercell:
            cores = cell["families"][epilogue]["cores"].get(route, ())
            return sorted(c["norm_hash"] for c in cores)
    return []


# -- certificate persistence + queries ----------------------------------------

def save_certificates(cert: Dict[str, Any],
                      path: Optional[str] = None) -> str:
    path = path or EQUIV_PATH
    with open(path, "w") as f:
        json.dump(cert, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_certificates(path: Optional[str] = None) -> Optional[Dict]:
    """The committed certificate object, or None when absent/stale-schema
    (callers then run the FULL route matrix -- missing certificates can
    only ever widen checking, never narrow it)."""
    try:
        with open(path or EQUIV_PATH) as f:
            data = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None
    if data.get("schema") != EQUIV_SCHEMA:
        return None
    return data


def certified_pairs(cert: Optional[Dict], k: int, supercell: int,
                    epilogue: str) -> List[Tuple[str, str]]:
    """The certified route pairs of one plan-shape cell."""
    if not cert:
        return []
    for cell in cert.get("cells", ()):
        if cell.get("k") == k and cell.get("supercell") == supercell:
            fam = cell.get("families", {}).get(epilogue, {})
            return [tuple(p) for p in fam.get("pairs", ())]
    return []


def covers(cert: Optional[Dict], k: int, supercell: int, route_a: str,
           route_b: str) -> bool:
    """True when (route_a, route_b) is certified equivalent at this plan
    shape for BOTH epilogue families -- the precondition for the contract
    engine to collapse the pair's duplicate runs."""
    if not cert:
        return False
    pair = tuple(sorted((route_a, route_b)))
    for epilogue in ("gather", "scatter"):
        ps = [tuple(sorted(p)) for p in
              certified_pairs(cert, k, supercell, epilogue)]
        if pair not in ps:
            return False
    return True
