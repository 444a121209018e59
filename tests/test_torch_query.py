"""External queries of the PyTorch port against the JAX package:
``KnnProblem.query``, ``query_radius``, ``with_points``, ``get_edges`` and
``save_problem``, and the pieces they rest on (``cell_coords_host``, the
plan's ``class_of_sc`` / ``row_of_sc``).

The JAX side runs as its own tests run it on the CPU: the Pallas kernels in
interpret mode (``KnnConfig(interpret=True)``).  Integer outputs (cells,
class maps, radius counts) must be equal; neighbour rows are compared with
the reference's tie-aware comparator (RTOL 1e-4, ATOL 1e-2), because XLA's
CPU backend contracts multiply-adds and d2 may differ by an ulp.  Within
the port, routes that make the same selection (kpass and blocked, kernel
and streamed) must give equal rows.
"""

import numpy as np
import pytest
import torch

import cuda_knearests_tpu as ck
from cuda_knearests_tpu.fuzz.compare import check_route_result
from cuda_knearests_tpu.io import (generate_blue_noise, generate_clustered,
                                   generate_uniform)
from cuda_knearests_tpu.ops.gridhash import cell_coords as jcell_coords
from cuda_knearests_tpu.ops.gridhash import \
    cell_coords_host as jcell_coords_host
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.ops import adaptive, cuda_solve
from cuda_knearests_tpu_torch.ops.gridhash import cell_coords, cell_coords_host
from cuda_knearests_tpu_torch.ops.topk import translate_ids
from cuda_knearests_tpu_torch.runtime import dispatch
from cuda_knearests_tpu_torch.utils.memory import (InvalidKError,
                                                   LaunchBudgetError)


def _half_cube():
    """A cloud confined to x < 500: the supercells beyond hold no point."""
    rng = np.random.default_rng(903)
    return (rng.random((3000, 3)) * [500.0, 1000.0, 1000.0]).astype(
        np.float32)


CLOUDS = {
    "blue-k10": (lambda: generate_blue_noise(3000, seed=11), dict(k=10)),
    "uniform-k8": (lambda: generate_uniform(4000, seed=12), dict(k=8)),
    "clustered-r1": (lambda: generate_clustered(6000, seed=13),
                     dict(k=10, ring_radius=1)),
    "half-cube-k6": (_half_cube, dict(k=6)),
    # one-cell supercells: 2,715 supercells of ccap 128, where a streamed
    # step holds far less than the class's whole query pack
    "blue-s1-r1": (lambda: generate_blue_noise(8000, seed=14),
                   dict(k=8, supercell=1, ring_radius=1)),
}


def _edge_queries(dim: int) -> np.ndarray:
    """Queries on the domain's faces, edges and corners and on cell
    boundaries: every combination of seven coordinates."""
    w = np.float32(1000.0 / dim)
    vals = np.array([0.0, w, np.nextafter(w, np.float32(0)), 500.0,
                     1000.0 - w, np.nextafter(np.float32(1000), np.float32(0)),
                     1000.0], np.float32)
    g = np.stack(np.meshgrid(vals, vals, vals, indexing="ij"), -1)
    return g.reshape(-1, 3)


QUERY_SETS = {
    "uniform": lambda pts, dim: generate_uniform(300, seed=21),
    "clustered": lambda pts, dim: generate_clustered(300, seed=22),
    "stored": lambda pts, dim: pts[:400].copy(),
    "single": lambda pts, dim: generate_uniform(1, seed=23),
    "edges": lambda pts, dim: _edge_queries(dim),
}


@pytest.fixture(scope="module")
def problems():
    """Both packages' prepared problems of every cloud."""
    out = {}
    for name, (make, kw) in CLOUDS.items():
        pts = make()
        jp = ck.KnnProblem.prepare(pts, ck.KnnConfig(interpret=True, **kw))
        pp = pt.KnnProblem.prepare(pts, pt.KnnConfig(**kw), device="cpu")
        out[name] = (pts, jp, pp)
    return out


def _agree(pts, q, got, want, k):
    bad = check_route_result(pts, q, got[0], got[1], np.asarray(want[1]), k)
    assert bad is None, bad.render()


@pytest.mark.parametrize("dim", [1, 7, 10, 31, 64, 97])
def test_cell_coords_host_matches_jax(dim):
    w = np.float32(1000.0 / dim)
    edges = np.arange(dim + 1, dtype=np.float32) * w
    vals = np.concatenate([
        edges, np.nextafter(edges, np.float32(0)),
        np.nextafter(edges, np.float32(1000)),
        [0.0, np.nextafter(np.float32(1000), np.float32(0)), 1000.0],
        np.random.default_rng(dim).random(200) * 1000]).astype(np.float32)
    vals = np.clip(vals, 0, 1000)
    pts = np.stack([vals, vals[::-1], np.roll(vals, 7)], axis=1)
    got = cell_coords_host(pts, dim)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jcell_coords_host(pts, dim))
    np.testing.assert_array_equal(got, np.asarray(jcell_coords(pts, dim)))
    np.testing.assert_array_equal(
        got, cell_coords(torch.as_tensor(pts), dim).numpy())


def test_translate_ids_keeps_sentinels():
    ids = torch.tensor([[2, 0, -1], [1, -1, -1]], dtype=torch.int32)
    perm = torch.tensor([7, 5, 9], dtype=torch.int32)
    np.testing.assert_array_equal(translate_ids(ids, perm).numpy(),
                                  [[9, 7, -1], [5, -1, -1]])


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_class_maps_match_jax(problems, cloud):
    _, jp, pp = problems[cloud]
    assert pp.aplan.class_of_sc.dtype == np.int32
    np.testing.assert_array_equal(pp.aplan.class_of_sc,
                                  jp.aplan.class_of_sc)
    np.testing.assert_array_equal(pp.aplan.row_of_sc, jp.aplan.row_of_sc)
    if cloud == "half-cube-k6":
        assert (pp.aplan.class_of_sc == -1).any()


# the one-cell-supercell cloud is slow in interpret mode (a grid step a
# supercell): it takes only the queries on cell boundaries here
QUERY_CASES = [(c, q) for c in sorted(CLOUDS) for q in sorted(QUERY_SETS)
               if c != "blue-s1-r1" or q == "edges"]


@pytest.mark.parametrize("cloud,qset", QUERY_CASES)
def test_query_matches_jax(problems, cloud, qset):
    pts, jp, pp = problems[cloud]
    k = pp.config.k
    q = QUERY_SETS[qset](pts, pp.grid.dim)
    dispatch.reset_stats()
    got = pp.query(q)
    assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    _agree(pts, q, got, jp.query(q), k)
    if qset == "stored":
        # a query on a stored point finds it at d2 = 0 (no self-exclusion)
        assert (got[1][:, 0] == 0).all()
        assert (pts[got[0][:, 0]] == q).all()
    if cloud == "half-cube-k6" and qset == "uniform":
        qcls, _ = adaptive.bucket_queries(pp.grid, pp.config, pp.aplan, q)
        assert (qcls == -1).sum() > 50  # classless queries, brute-forced


def test_smaller_k_and_refusals(problems):
    pts, jp, pp = problems["blue-k10"]
    q = generate_uniform(200, seed=31)
    _agree(pts, q, pp.query(q, k=4), jp.query(q, k=4), 4)
    with pytest.raises(InvalidKError, match="exceeds the prepared k=10"):
        pp.query(q, k=11)
    with pytest.raises(InvalidKError, match="exceeds the prepared k=10"):
        pp.query_radius(q, 10.0, max_neighbors=11)
    with pytest.raises(InvalidKError):
        pp.query(q, k=0)
    # the plane feed: equal to JAX's on the rows whose ids are equal
    ids, _, planes = pp.query(q, planes=True)
    jids, _, jplanes = jp.query(q, planes=True)
    assert planes.shape == (200, 10, 4) and planes.dtype == np.float32
    same = (ids == jids).all(axis=1)
    assert same.mean() > 0.9
    np.testing.assert_array_equal(planes[same], jplanes[same])
    with pytest.raises(ValueError):
        pp.query(q[:, :2])
    with pytest.raises(ValueError):
        pp.query(q + 1000.0)


def test_empty_query_set_and_empty_cloud(problems):
    _, jp, pp = problems["blue-k10"]
    ids, d2 = pp.query(np.zeros((0, 3), np.float32))
    assert ids.shape == d2.shape == (0, 10)
    assert ids.dtype == np.int32 and d2.dtype == np.float32
    empty = np.zeros((0, 3), np.float32)
    q = generate_uniform(5, seed=32)
    p0 = pt.KnnProblem.prepare(empty, pt.KnnConfig(k=4), device="cpu")
    j0 = ck.KnnProblem.prepare(empty, ck.KnnConfig(k=4, interpret=True))
    ids, d2 = p0.query(q)
    jids, jd2 = j0.query(q)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(d2, jd2)
    assert (ids == -1).all() and np.isinf(d2).all()


def test_blocked_equals_kpass_and_jax(problems):
    pts, jp, pp = problems["blue-k10"]
    cfg = pt.KnnConfig(k=10, kernel="blocked")
    pb = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    assert all(adaptive.class_blocked_m(cfg, cp.ccap, 10)
               for cp in pb.aplan.classes)
    for q in (generate_uniform(300, seed=33), generate_clustered(300,
                                                                 seed=34)):
        got = pb.query(q)
        want = pp.query(q)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        _agree(pts, q, got, jp.query(q), 10)


def test_fallback_none_shows_kernel_answers(monkeypatch):
    """fallback='none' leaves uncertified rows as the class route answered
    them: the kernel wrapper ran once per class with queries, and its rows
    are valid and ascending -- a broken kernel could not hide behind the
    brute resolve."""
    pts = generate_uniform(9000, seed=77)
    q = generate_uniform(120, seed=5)
    pp = pt.KnnProblem.prepare(pts, pt.KnnConfig(k=6, fallback="none"),
                               device="cpu")
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    real = cuda_solve.supercell_topk
    monkeypatch.setattr(cuda_solve, "supercell_topk", counted)
    dispatch.reset_stats()
    ids, d2 = pp.query(q)
    assert dispatch.stats().host_syncs == 1
    qcls, _ = adaptive.bucket_queries(pp.grid, pp.config, pp.aplan, q)
    assert len(calls) == len(np.unique(qcls[qcls >= 0]))
    assert all(shape[1] % 128 == 0 for shape in calls)  # q2cap
    answered = (ids >= 0).all(axis=1) & np.isfinite(d2).all(axis=1)
    assert answered.mean() > 0.9
    assert (np.diff(d2[answered], axis=1) >= 0).all()
    jp = ck.KnnProblem.prepare(pts, ck.KnnConfig(k=6, interpret=True))
    _agree(pts, q[answered], (ids[answered], d2[answered]),
           jp.query(q[answered]), 6)


def test_forced_streamed_class_gives_the_same_answer(problems, monkeypatch):
    """A kernel class whose query pack and outputs exceed the memory
    budget streams its queries, a few supercells a step, and answers what
    the kernel route answers; a budget below one streamed supercell is
    refused."""
    pts, jp, pp = problems["blue-s1-r1"]
    k = pp.config.k
    q = generate_uniform(400, seed=35)
    want = pp.query(q)
    qcls, qrow = adaptive.bucket_queries(pp.grid, pp.config, pp.aplan, q)
    (b,) = adaptive.plan_queries(pp.config, pp.aplan, qcls, qrow, k, None)
    assert b.route == "kernel" and b.q2cap == 128
    cp = pp.aplan.classes[b.cls]
    out_bytes = (q.shape[0] + 1) * k * 8
    # the streamed route's capacity, its outputs, staged query indices and
    # the cell table built for the call; then one supercell's step
    q2cap = 1 << max(3, (int((b.starts[1:] - b.starts[:-1]).max())
                         - 1).bit_length())
    fixed = out_bytes + 16 * b.src.size + 4 * cp.n_sc * 3 ** 3
    per_row = (adaptive.stream_step_bytes(1, q2cap, cp.ccap, k)
               + adaptive._SLOT_SOLVE_BYTES * q2cap)
    for budget, rows in ((b.pack_bytes + out_bytes - 1, None),
                         (fixed + 3 * per_row, 3)):
        monkeypatch.setattr(adaptive, "hbm_budget_bytes",
                            lambda device, cfg=None: budget)
        (r,) = adaptive.plan_queries(pp.config, pp.aplan, qcls, qrow, k,
                                     budget)
        assert r.route == "streamed" and r.q2cap == q2cap
        assert r.step_rows == (rows or r.step_rows) < cp.n_sc
        dispatch.reset_stats()
        got = pp.query(q)
        assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    _agree(pts, q, got, jp.query(q), k)
    monkeypatch.setattr(adaptive, "hbm_budget_bytes",
                        lambda device, cfg=None: fixed + per_row - 1)
    with pytest.raises(LaunchBudgetError, match="reduce the query batch"):
        pp.query(q)


def test_query_round_trips_with_fallback_rows(problems):
    """Clustered stored points at ring_radius=1 leave query rows
    uncertified: they resolve behind a second fetch, and no more."""
    pts, jp, pp = problems["clustered-r1"]
    q = pts[::15].copy()
    dispatch.reset_stats()
    got = pp.query(q)
    assert dispatch.stats().host_syncs == 2
    _agree(pts, q, got, jp.query(q), 10)


@pytest.mark.parametrize("radius,cap", [(40.0, None), (60.0, 5),
                                        (0.0, 3)])
def test_query_radius_matches_jax(problems, radius, cap):
    pts, jp, pp = problems["blue-k10"]
    q = np.concatenate([generate_uniform(200, seed=36), pts[:20]])
    ids, d2, counts, trunc = pp.query_radius(q, radius, cap)
    jids, jd2, jcounts, jtrunc = jp.query_radius(q, radius, cap)
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(trunc, jtrunc)
    assert counts.max() > 0
    _agree(pts, q, (ids, d2), (jids, jd2), cap or 10)
    if radius == 0.0:
        assert (counts[200:] >= 1).all()  # the stored points themselves


def test_get_edges_matches_jax(problems):
    pts, jp, pp = problems["blue-k10"]
    jp.solve()
    pp.solve()
    for symmetric in (False, True):
        got = pp.get_edges(symmetric)
        want = jp.get_edges(symmetric)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(np.unique(got, axis=0),
                                      np.unique(want, axis=0))


def test_save_problem_read_back_by_both_packages(problems, tmp_path):
    pts, jp, pp = problems["clustered-r1"]
    path = str(tmp_path / "port")
    pt.save_problem(pp, path)
    loaded = pt.load_problem(path, device="cpu")
    assert loaded.config == pp.config
    for name in ("points", "permutation", "cell_starts", "cell_counts"):
        assert torch.equal(getattr(loaded.grid, name),
                           getattr(pp.grid, name)), name
    q = generate_uniform(100, seed=37)
    want = pp.query(q)
    got = loaded.query(q)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    theirs = ck.load_problem(path)
    assert theirs.config.k == pp.config.k
    assert theirs.config.ring_radius == pp.config.ring_radius
    for name in ("points", "permutation", "cell_starts", "cell_counts"):
        np.testing.assert_array_equal(
            np.asarray(getattr(theirs.grid, name)),
            getattr(pp.grid, name).numpy())
    _agree(pts, q, want, theirs.query(q), pp.config.k)


def test_with_points_reprepares_under_the_same_config(problems):
    pts, _, pp = problems["uniform-k8"]
    moved = generate_uniform(2500, seed=38)
    fresh = pp.with_points(moved)
    assert fresh.config == pp.config and fresh.device == pp.device
    want = pt.KnnProblem.prepare(moved, pp.config, device="cpu")
    q = generate_uniform(50, seed=39)
    np.testing.assert_array_equal(fresh.query(q)[0], want.query(q)[0])
    assert fresh.grid.n_points == 2500
