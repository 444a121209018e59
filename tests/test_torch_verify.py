"""kntpu-verify on the PyTorch port, held against the reference's model.

* the port's sync model (``analysis/syncflow.py``) has the reference's 19
  windows: the same entries, site ids, fetch and ICI multiplicities and
  ``syncs`` / ``budget`` expressions (``proven_bounds()`` equal), with the
  port's own stage multiplicities where its code stages a different number
  of arrays, each listed below with its reason;
* every dispatch site of the port is annotated and claimed, and every
  window's claims are complete against the static call graph;
* the proof equals the port's runtime counters per window on the 20k
  fixture on the CPU (``verify.measure_windows``, the same function the
  smoke's phase 10j runs on the card);
* ``canonical_hash`` normalises capacities and launch order, the
  committed certificates cover every plan shape, and each of the three
  verify faults is detected.

The reference's ``syncflow`` is AST-only (no JAX import); nothing here
runs the reference's verify engine.
"""

import numpy as np
import pytest
import torch

from cuda_knearests_tpu.analysis import syncflow as ref_syncflow
from cuda_knearests_tpu_torch.analysis import equiv, syncflow, verify

# (window, site) -> (reference multiplicity, port multiplicity, why).  The
# only places the port's model departs from the reference's; every other
# entry, site id and multiplicity is the reference's.
STAGE_MULT_DIFFS = {
    ("query-adaptive", "query-class-stage"): (
        "5*classes", "2*classes + 3",
        "the shared front half (adaptive.query_device) stages the queries, "
        "the box rows and the has-class mask once, and each class its "
        "source rows and slots"),
    ("sharded-query", "query-class-stage"): (
        "5*classes", "2*classes + 3*ndev",
        "the same front half, once a slab"),
    ("pod-query", "query-class-stage"): (
        "5*classes", "2*classes + 3*ndev",
        "the same front half, once a chip"),
    ("fof", "fof-stage"): (
        "4", "3", "the neighbour-cell table, its mask and the labels"),
    ("mxu-brute", "mxu-stage"): (
        "4", "5", "the stored points beside the interleaved candidates; "
        "4 on a self-solve"),
    ("mxu-brute", "mxu-fallback-stage"): (
        "2*fb", "1 + fb", "the exact brute pass stages its rows once a "
        "call, the elementwise baseline's one call included"),
}
@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The routes' plain versions are many small torch operations; beside
    other test processes torch's CPU thread pool oversubscribes the cores,
    so this module runs torch on two threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# Sites of the reference's model with no counterpart in the port.
SITES_GONE = {
    ("query-adaptive", "adaptive-query-place-stage"):
        "rows land through the staged forward map inside the mode (a) "
        "launch: no separate placement upload",
}


def test_windows_equal_the_reference_model():
    assert syncflow.proven_bounds() == ref_syncflow.proven_bounds()
    assert len(syncflow.WINDOWS) == len(ref_syncflow.WINDOWS) == 19
    assert syncflow.ROUTE_WINDOWS == ref_syncflow.ROUTE_WINDOWS
    assert syncflow.PARAMS == ref_syncflow.PARAMS
    for name, rw in ref_syncflow.WINDOWS.items():
        pw = syncflow.WINDOWS[name]
        assert (pw.entries, pw.includes, pw.syncs, pw.budget) == \
            (rw.entries, rw.includes, rw.syncs, rw.budget), name
        gone = {sid for (w, sid) in SITES_GONE if w == name}
        assert set(pw.sites) == set(rw.sites) - gone, name
        for sid, ps in pw.sites.items():
            rs = rw.sites[sid]
            assert ps.kind == rs.kind, (name, sid)
            if (name, sid) in STAGE_MULT_DIFFS:
                ref_mult, port_mult, _why = STAGE_MULT_DIFFS[(name, sid)]
                assert (rs.mult, ps.mult) == (ref_mult, port_mult)
                assert ps.kind == "stage"
            else:
                assert ps.mult == rs.mult, (name, sid)
            # byte volumes: the port's buffers equal the reference's
            # (u_pad binds the unpadded row count: the port pads nothing)
            assert ps.bytes == rs.bytes, (name, sid)
    assert set(ref_syncflow.NONWINDOW) <= set(syncflow.NONWINDOW)


def test_every_dispatch_site_is_annotated_and_claimed():
    sites = syncflow.discover_sites()
    kinds = [s.kind for s in sites]
    assert kinds.count("fetch") + kinds.count("stage") \
        + kinds.count("ici") >= 60
    registered = set(syncflow.NONWINDOW)
    for win in syncflow.WINDOWS.values():
        registered |= set(win.sites)
    for s in sites:
        assert s.path.startswith("cuda_knearests_tpu_torch/")
        if s.kind == "raw":
            assert s.qualname in syncflow.KNOWN_RAW, \
                f"unregistered raw readback {s.qualname} ({s.path}:{s.line})"
        else:
            assert s.site_id, \
                f"unannotated dispatch.{s.kind} at {s.path}:{s.line}"
            assert s.site_id in registered, f"unclaimed site {s.site_id}"
    # every window's claimed site exists in the source
    found = {s.site_id for s in sites if s.site_id}
    for name, win in syncflow.WINDOWS.items():
        assert set(win.sites) <= found, name


def test_raw_readbacks_are_recognised():
    import ast

    src = ("def f(t, torch):\n"
           "    a = t.cpu()\n"
           "    b = t.to('cpu')\n"
           "    c = t.item()\n"
           "    torch.cuda.synchronize()\n"
           "    d = t.to(t.device)\n"
           "    e = t.numpy().tolist()\n")
    v = syncflow._SiteVisitor("m", src.splitlines())
    v.visit(ast.parse(src))
    assert [(s.line, s.kind) for s in v.sites] == \
        [(2, "raw"), (3, "raw"), (4, "raw"), (5, "raw")]


def test_window_claims_complete_against_call_graph():
    findings = verify.check_syncflow()
    errors = [f for f in findings if f.severity == "error"]
    assert errors == [], [f.message for f in errors]
    budget = [f for f in findings if f.rule == "sync-budget"]
    assert len(budget) == 19


def test_no_raw_readback_reachable_from_a_window():
    """A raw readback inside a window is a host sync host_syncs does not
    count.  Only the two prepare-time census reads are reachable (through
    solve_adaptive / build_plan without a plan, which a prepared problem
    never takes), as in the reference."""
    edges, _defs = syncflow.build_call_graph()
    raw = {s.qualname for s in syncflow.discover_sites() if s.kind == "raw"}
    allowed = {"ops.adaptive.build_adaptive_plan",
               "ops.solve.global_schedule"}
    for name, win in syncflow.WINDOWS.items():
        reached = syncflow.reachable(win.entries, edges) & raw
        assert reached <= allowed, (name, reached - allowed)


def test_plane_feed_extraction_is_a_counted_fetch():
    """solve() with the plane feed reads the permutation back for the
    original-order table: a counted fetch at extract-original (it was a
    raw .cpu() reached from the solve window, uncounted)."""
    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.io import generate_uniform

    p = pt.KnnProblem.prepare(generate_uniform(400, seed=3),
                              pt.KnnConfig(k=6, plane_feed=True),
                              device="cpu")
    fetches, _stages, _b, stats, res, unmapped = verify.window_counts(
        p.solve)
    assert unmapped == [] and fetches.get("extract-original") == 1
    fb = int(int(res.uncert_count) > 0)
    assert stats.host_syncs == 2 + fb == sum(fetches.values())


def test_expression_grammar_is_closed():
    with pytest.raises(Exception):
        syncflow.evaluate("__import__('os')", {})
    assert syncflow.evaluate("2*classes + 3*ndev",
                             {"classes": 4, "ndev": 2}) == 14


# -- proven bound == runtime counters on the 20k fixture ----------------------

@pytest.fixture(scope="module")
def window_rows():
    from cuda_knearests_tpu_torch.io import get_dataset, generate_uniform

    pts = get_dataset("pts20K.xyz")
    queries = generate_uniform(2_000, seed=99)
    # the chunked query at 1,000 a chunk (2 chunks) and the brute route on
    # the first 2,000 points keep the plain versions' CPU time small; the
    # smoke runs 256 a chunk and the whole cloud on the card
    return {r["route"]: r for r in verify.measure_windows(
        pts, queries, "cpu", mxu_points=pts[:2_000], chunk=1_000)}


@pytest.mark.parametrize("route", verify.MEASURED_ROUTES)
def test_proof_equals_counters(window_rows, route):
    row = window_rows[route]
    assert row["problems"] == [], row
    assert row["measured"] == row["proven"] >= 1
    assert row["launches"] == {}  # the CPU runs the plain versions


def test_counted_windows_exercise_their_indicators(window_rows):
    assert window_rows["fof"]["env"]["rounds"] >= 1
    serve = window_rows["serve-batch"]["env"]
    assert serve["tomb"] == 1 and serve["delta"] == 1
    assert window_rows["mxu-brute"]["env"]["fb"] == 1
    for route in ("external-query-adaptive", "sharded-query", "pod-query"):
        assert window_rows[route]["env"]["classes"] >= 1


# -- certificates -------------------------------------------------------------

def _rec(**kw):
    base = dict(wrapper="supercell_topk", mode="a",
                kernels=("supercell_topk",), k=8, m=0, q_tile=128, qcap=88,
                ccap=512, s_total=8, in_dtypes=("float32",) * 3,
                out_shapes=((400, 8), (400, 8)))
    base.update(kw)
    return base


def test_canonical_hash_normalises_capacities_and_order():
    a = _rec()
    b = _rec(qcap=136, ccap=640, s_total=27, out_shapes=((900, 8),
                                                          (900, 8)))
    assert equiv.canonical_hash([a]) != equiv.canonical_hash([b])
    assert equiv.canonical_hash([a], True) == equiv.canonical_hash([b], True)
    # k is not a capacity, nor is the kernel
    assert equiv.canonical_hash([a], True) != \
        equiv.canonical_hash([_rec(k=9, out_shapes=((400, 9),) * 2)], True)
    assert equiv.canonical_hash([a], True) != \
        equiv.canonical_hash([_rec(wrapper="blocked_topk",
                                   kernels=("blocked_topk",))], True)
    # independent classes: order does not matter
    assert equiv.canonical_hash([a, b]) == equiv.canonical_hash([b, a])
    # a capacity's structure does: an output not sized by the supercells
    c = _rec(mode="b", out_shapes=((8, 8, 88),) * 2)
    d = _rec(mode="b", out_shapes=((9, 8, 88),) * 2)
    assert equiv.canonical_hash([c], True) != equiv.canonical_hash([d], True)


def test_core_identity_is_the_kernel_source():
    sha = equiv.source_sha("supercell_topk")
    assert sha == equiv.source_sha("supercell_topk") and len(sha) == 16
    assert sha != equiv.source_sha("blocked_topk")


# The reference certifies its pairs per Mosaic block shapes; the port's
# cores are the hand kernels, so every route that reaches supercell_topk
# pairs with every other one at every cell: 6 pairs a family (the
# reference: 3, and 1 in the k=8, s=3 scatter family, where its adaptive
# class kernel takes other block shapes; and the reference's external
# query never pairs, its kernel reading a different block layout).
PORT_PAIRS = 6


def test_committed_certificates_cover_every_plan_shape():
    cert = equiv.load_certificates()
    assert cert is not None and cert["schema"] == equiv.EQUIV_SCHEMA
    assert [(c["k"], c["supercell"]) for c in cert["cells"]] == \
        list(equiv.MATRIX)
    for cell in cert["cells"]:
        for fam in ("gather", "scatter"):
            data = cell["families"][fam]
            assert len(data["pairs"]) == PORT_PAIRS, (cell["k"], fam)
            assert "legacy-pack" in data["bound_to_shared"]
            assert set(data["cores"]) == set(equiv.ROUTES)
        assert cell["mxu"]["classes"]
        assert sorted(cell["mxu"]["trace_hashes"]) == ["gather", "scatter"]
        assert cell["pod"]["classes"] and cell["pod"]["ndev"] == 2
        for route in equiv.ROUTES:
            assert equiv.covers(cert, cell["k"], cell["supercell"], route,
                                "legacy-pack") or route == "legacy-pack"


def test_certificates_regenerate_byte_for_byte():
    findings = verify.check_equivalence()
    assert findings and not [f for f in findings if f.severity == "error"]


# -- seeded faults ------------------------------------------------------------

@pytest.mark.parametrize("fault,check", [
    ("sync-leak", verify.check_syncflow),
    ("sig-data-dep", verify.check_signatures),
    ("route-diverge", verify.check_equivalence),
])
def test_verify_fault_detected(fault, check):
    bad = [f for f in check(fault=fault) if f.severity == "error"]
    assert any(f.rule == fault for f in bad), bad


def test_signatures_clean_and_census_reported():
    findings = verify.check_signatures()
    assert [f for f in findings if f.severity == "error"] == []
    routes = {f.path for f in findings}
    assert {"route:legacy-pack", "route:adaptive", "route:mxu-brute",
            "route:pod-chip"} <= routes


def test_signature_matches_the_reference_census():
    """runtime.dispatch.signature is the reference's (shape, dtype) leaf
    census plus the statics, on torch tensors and numpy arrays alike."""
    import torch

    from cuda_knearests_tpu_torch.runtime.dispatch import signature

    tree = {"a": torch.zeros((3, 4), dtype=torch.int32),
            "b": [np.zeros((5,), np.float32)]}
    assert signature(tree, 8, "x") == (((3, 4), "int32"), ((5,), "float32"),
                                       8, "x")
