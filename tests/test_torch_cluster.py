"""Friends-of-friends clustering and the Voronoi plane feed of the PyTorch
port against the JAX package.

The same numpy clouds go through both packages on the CPU: JAX as
``tests/test_cluster.py`` runs it (its grid kernels in interpret mode), the
port with ``device='cpu'``.  FoF labels must pass the tie-aware partition
check of both packages (``cluster/compare.py``); where the oracle's
bracketing partitions coincide (no pair within the float32 band of the
linking length) labels, sizes, rounds, cluster count, dim and densest cell
must equal JAX's exactly.  (XLA's CPU backend may contract the distance's
multiply-adds, so a pair inside the band may link in one package and not
in the other.)  The host helpers (``fof_oracle``, ``check_fof_result``,
``bisector_planes``, ``ring_schedule``) must equal JAX's output for
output, and the plane feed must be bit-identical to JAX's on rows whose
ids are equal, and to a float64 recompute from the port's ids everywhere.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cuda_knearests_tpu as ck
from cuda_knearests_tpu.cluster import compare as jcompare
from cuda_knearests_tpu.cluster import fof as jfof
from cuda_knearests_tpu.cluster.planes import \
    bisector_planes as jbisector_planes
from cuda_knearests_tpu.io import generate_clustered, generate_uniform
from cuda_knearests_tpu.io import \
    validate_linking_length as jvalidate_linking_length
from cuda_knearests_tpu.ops.rings import ring_schedule as jring_schedule
from cuda_knearests_tpu import oracle as joracle
from cuda_knearests_tpu.utils import memory as jmemory
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch import oracle
from cuda_knearests_tpu_torch.cluster import compare
from cuda_knearests_tpu_torch.cluster import fof
from cuda_knearests_tpu_torch.cluster.planes import bisector_planes
from cuda_knearests_tpu_torch.io import validate_linking_length
from cuda_knearests_tpu_torch.ops.gridhash import build_grid
from cuda_knearests_tpu_torch.ops.rings import ring_schedule
from cuda_knearests_tpu_torch.runtime import dispatch
from cuda_knearests_tpu_torch.utils import memory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPACING_2500 = 1000.0 / 2500 ** (1.0 / 3.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A FoF round is hundreds of small torch operations; beside other
    test processes, torch's CPU thread pool oversubscribes the cores and
    each operation waits on its threads, so this module runs torch on one
    thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref_planes(sites, points, ids):
    """The plane feed recomputed in float64 from returned ids."""
    q = sites.astype(np.float64)[:, None, :]
    p = points[np.clip(ids, 0, None)].astype(np.float64)
    nn = (p - q).astype(np.float32)
    d = (((p * p).sum(-1) - (q * q).sum(-1)) / 2.0).astype(np.float32)
    ok = ids >= 0
    return np.concatenate(
        [np.where(ok[..., None], nn, np.float32(0.0)),
         np.where(ok, d, np.float32(np.inf))[..., None]], axis=-1)


def _fof_both(points, b, **kw):
    """(JAX result, port result) of one FoF solve, with the port's
    checked against both packages' comparators and its sync count."""
    want = jfof.fof_labels(points, b, **kw)
    dispatch.reset_stats()
    got = fof.fof_labels(points, b, device="cpu", **kw)
    assert got.host_syncs == dispatch.stats().host_syncs
    assert got.host_syncs == (got.rounds + 1 if points.shape[0] else 0)
    assert got.labels.dtype == np.int32 and got.sizes.dtype == np.int32
    assert got.linking_length == want.linking_length
    for check in (jcompare.check_fof_result, compare.check_fof_result):
        bad = check(points, b, got.labels, got.sizes)
        assert bad is None, bad.render()
    return want, got


def _assert_equal_where_band_empty(points, b, want, got):
    """Exact equality with JAX when no pair lies in the float32 band;
    returns whether the band was empty."""
    mand, allowed = oracle.fof_oracle(points, b, compare.fof_band(b))
    if not np.array_equal(mand, allowed):
        return False
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.sizes, want.sizes)
    np.testing.assert_array_equal(got.labels, mand)
    assert (got.rounds, got.n_clusters, got.dim, got.cell_max) == \
        (want.rounds, want.n_clusters, want.dim, want.cell_max)
    return True


# -- FoF against JAX ----------------------------------------------------------

@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("scale", [0.4, 1.0, 2.2])
def test_fof_uniform_matches_jax(seed, scale):
    pts = generate_uniform(2500, seed=seed)
    b = scale * SPACING_2500
    want, got = _fof_both(pts, b)
    assert _assert_equal_where_band_empty(pts, b, want, got)


def _two_blobs():
    rng = np.random.default_rng(0)
    a = rng.normal([200, 200, 200], 5, (60, 3))
    b = rng.normal([800, 800, 800], 5, (40, 3))
    return np.clip(np.concatenate([a, b]), 0, 999.9).astype(np.float32), 40.0


def _chain(n, scale):
    chain = np.stack([np.linspace(5, 995, n), np.full(n, 500.0),
                      np.full(n, 500.0)], 1).astype(np.float32)
    return chain, (995.0 - 5.0) / (n - 1) * scale


def _lattice(scale):
    g = np.arange(1, 9, dtype=np.float32) * 100.0
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    return np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)[:343], \
        100.0 * scale


FIXTURES = {
    "two-blobs": _two_blobs,
    "chain": lambda: _chain(300, 1.01),
    "chain-below-b": lambda: _chain(50, 0.5),
    "coincident": lambda: (np.tile(np.float32([500, 500, 500]), (70, 1)),
                           1e-3),
    "empty": lambda: (np.empty((0, 3), np.float32), 5.0),
    "one": lambda: (np.float32([[1, 2, 3]]), 5.0),
    "tie-at-radius": lambda: _lattice(1.0),
    "lattice-1.5": lambda: _lattice(1.5),
    "clustered": lambda: (generate_clustered(3000, seed=3), 6.0),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fof_fixtures_match_jax(name):
    pts, b = FIXTURES[name]()
    want, got = _fof_both(pts, b)
    exact = _assert_equal_where_band_empty(pts, b, want, got)
    assert exact or name in ("tie-at-radius", "clustered")
    if name == "tie-at-radius":
        # every nearest pair lies exactly on the radius; the coordinates
        # and b^2 are exact in float32, so both packages link them all
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.n_clusters == 1
    assert got.cluster_sizes()[0].tolist() == \
        want.cluster_sizes()[0].tolist()


def test_fof_sorted_order_is_the_grid_permutation():
    """The host twin's stable sort gives the device grid's order."""
    for pts, b in (_two_blobs(), (generate_clustered(4000, seed=5), 9.0),
                   (generate_uniform(3000, seed=6), 30.0)):
        plan = fof.plan_fof(pts, b)
        grid = build_grid(torch.as_tensor(pts), dim=plan.dim)
        np.testing.assert_array_equal(plan.order, grid.permutation.numpy())
        jcells = jfof._neighbor_cells_host(pts, plan.order, plan.dim, 1000.0)
        pcells = fof._neighbor_cells_host(pts, plan.order, plan.dim, 1000.0)
        for a, c in zip(jcells, pcells):
            np.testing.assert_array_equal(a, c)


def test_fof_grid_dim_matches_jax():
    for n, b in ((100, 1.0), (100, 33.3), (5000, 7.7), (10, 999.0),
                 (10, 5000.0), (257, 0.123), (300_000, 14.938),
                 (900_000, 10.357)):
        assert fof.fof_grid_dim(n, b) == jfof.fof_grid_dim(n, b)
    for x in (0, 1, 7, 8, 9, 13, 16, 17, 1000):
        assert fof._round_pow2(x) == jfof._round_pow2(x)
    assert (fof.MAX_ROUNDS, fof.MAX_PAIR_SLOTS) == \
        (jfof.MAX_ROUNDS, jfof.MAX_PAIR_SLOTS)


BAD_LENGTHS = [0.0, -1.0, float("nan"), float("inf"), "12", True, None,
               [1.0], -3]


@pytest.mark.parametrize("bad", BAD_LENGTHS, ids=repr)
def test_fof_linking_length_front_door_matches_jax(bad):
    pts = generate_uniform(10, seed=1)
    with pytest.raises(jmemory.InputContractError) as want:
        jfof.fof_labels(pts, bad)
    with pytest.raises(memory.InputContractError) as got:
        fof.fof_labels(pts, bad, device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__
    assert got.value.kind == want.value.kind == "invalid-input"
    with pytest.raises(memory.InvalidConfigError):
        validate_linking_length(bad)


def test_fof_linking_length_values_and_huge_b():
    for b in (2, 2.5, np.float32(7.25), 1e6):
        assert validate_linking_length(b) == jvalidate_linking_length(b)
    pts = generate_uniform(10, seed=1)
    want, got = _fof_both(pts, 1e6)
    assert got.n_clusters == want.n_clusters == 1


@pytest.mark.parametrize("bad", [np.float32([[1, 2]]),
                                 np.float32([[np.nan, 0, 0]]),
                                 np.float32([[1, 2, 1001]])],
                         ids=["shape", "nan", "domain"])
def test_fof_points_front_door_matches_jax(bad):
    with pytest.raises(jmemory.InputContractError) as want:
        jfof.fof_labels(bad, 5.0)
    with pytest.raises(memory.InputContractError) as got:
        fof.fof_labels(bad, 5.0, device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__


def test_fof_pair_budget_preflight_matches_jax(monkeypatch):
    monkeypatch.setattr(jfof, "MAX_PAIR_SLOTS", 1000)
    monkeypatch.setattr(fof, "MAX_PAIR_SLOTS", 1000)
    pts = np.tile(np.float32([500, 500, 500]), (200, 1))
    with pytest.raises(jmemory.LaunchBudgetError) as want:
        jfof.fof_labels(pts, 1.0)
    with pytest.raises(memory.LaunchBudgetError) as got:
        fof.fof_labels(pts, 1.0, device="cpu")
    for attr in ("kind", "requested", "budget", "site"):
        assert getattr(got.value, attr) == getattr(want.value, attr), attr
    assert got.value.site == "cluster.fof"


def test_fof_clustered_refused_at_default_density_like_jax():
    """The clustered 20k cloud's densest cell holds 909 points at the
    default density: both packages refuse it alike; on a finer grid both
    answer it."""
    pts = generate_clustered(20_000, seed=3)
    with pytest.raises(jmemory.LaunchBudgetError) as want:
        jfof.fof_labels(pts, 6.0)
    with pytest.raises(memory.LaunchBudgetError) as got:
        fof.fof_labels(pts, 6.0, device="cpu")
    assert (got.value.requested, got.value.budget) == \
        (want.value.requested, want.value.budget)
    want, got = _fof_both(pts, 6.0, density=0.05)
    assert got.dim == want.dim == 74 and got.cell_max == want.cell_max


def test_fof_validate_false_skips_the_front_door():
    pts = generate_uniform(500, seed=2)
    want, got = _fof_both(pts, 40.0)
    raw = pts.astype(np.float64)
    mine = fof.fof_labels(raw, 40.0, validate=False, device="cpu")
    np.testing.assert_array_equal(mine.labels, got.labels)
    theirs = jfof.fof_labels(raw, 40.0, validate=False)
    np.testing.assert_array_equal(theirs.labels, want.labels)


# -- host helpers against JAX -------------------------------------------------

@pytest.mark.parametrize("nmax", [1, 2, 3, 4])
def test_ring_schedule_matches_jax(nmax):
    got, want = ring_schedule(nmax), jring_schedule(nmax)
    for a, c in zip(got, want):
        assert a.dtype == c.dtype
        np.testing.assert_array_equal(a, c)
    assert got.nmax == want.nmax == nmax


@pytest.mark.parametrize("band", [0.0, None, 50.0])
def test_fof_oracle_matches_jax(band):
    pts = generate_uniform(600, seed=8)
    b = 1.0 * 1000.0 / 600 ** (1.0 / 3.0)
    band = compare.fof_band(b) if band is None else band
    for a, c in zip(oracle.fof_oracle(pts, b, band),
                    joracle.fof_oracle(pts, b, band)):
        assert a.dtype == c.dtype == np.int32
        np.testing.assert_array_equal(a, c)
    assert compare.fof_band(b) == jcompare.fof_band(b)
    assert oracle._fof_thresholds(b, band) == joracle._fof_thresholds(b, band)


def test_union_find_matches_jax():
    ufs = oracle.UnionFind(6), joracle.UnionFind(6)
    for uf in ufs:
        for i, j in ((0, 3), (3, 5), (1, 2)):
            uf.union(i, j)
    assert ufs[0].canonical_labels().tolist() == [0, 1, 1, 0, 4, 0]
    np.testing.assert_array_equal(ufs[0].canonical_labels(),
                                  ufs[1].canonical_labels())
    pairs = np.random.default_rng(3).integers(0, 500, (300, 2))
    ufs = oracle.UnionFind(500), joracle.UnionFind(500)
    for uf in ufs:
        for i, j in pairs:
            uf.union(int(i), int(j))
    np.testing.assert_array_equal(ufs[0].canonical_labels(),
                                  ufs[1].canonical_labels())
    assert oracle.UnionFind(0).canonical_labels().shape == (0,)


def _corruptions():
    """The labelings ``tests/test_cluster.py`` corrupts, from the port's
    own labels of the same cloud."""
    pts = generate_uniform(120, seed=7)
    b = 1.2 * 1000.0 / 120.0 ** (1.0 / 3.0)
    res = fof.fof_labels(pts, b, device="cpu")
    assert res.n_clusters >= 2 and (res.sizes > 1).any()
    lab = np.unique(res.labels[np.nonzero(res.sizes > 1)[0]])[0]
    members = np.nonzero(res.labels == lab)[0]
    noncanon = res.labels.copy()
    noncanon[members] = members[-1]
    split = res.labels.copy()
    split[members[-1]] = members[-1]
    return pts, b, {
        "exact": (res.labels, res.sizes),
        "not-canonical": (noncanon, None),
        "merged": (np.zeros_like(res.labels), None),
        "mandatory-split": (split, None),
        "label-range": (np.full(120, 120, np.int32), None),
        "shape": (res.labels[:-1], None),
        "float": (res.labels.astype(np.float32), None),
        "sizes": (res.labels, res.sizes + 1),
    }


@pytest.mark.parametrize("case", ["exact", "not-canonical", "merged",
                                  "mandatory-split", "label-range", "shape",
                                  "float", "sizes"])
def test_check_fof_result_matches_jax(case):
    pts, b, cases = _corruptions()
    labels, sizes = cases[case]
    got = compare.check_fof_result(pts, b, labels, sizes)
    want = jcompare.check_fof_result(pts, b, labels, sizes)
    if want is None:
        assert got is None
    else:
        assert got is not None
        assert (got.row, got.reason, got.detail) == \
            (want.row, want.reason, want.detail)
    if case in ("not-canonical", "mandatory-split", "label-range"):
        assert got.reason == case
    # the same check against the oracle's bracket computed apart
    mand, allowed = oracle.fof_oracle(pts, b, compare.fof_band(b))
    bracket = compare.check_fof_bracket(labels, sizes, mand, allowed)
    assert (bracket is None) == (got is None)


@pytest.mark.parametrize("k", [1, 6, 9])
def test_bisector_planes_match_jax(k):
    rng = np.random.default_rng(k)
    pts = generate_uniform(300, seed=k)
    sites = generate_uniform(50, seed=k + 100)
    ids = rng.integers(-1, 300, (50, k)).astype(np.int32)
    ids[:, -1] = -1
    got = bisector_planes(sites, pts, ids)
    want = jbisector_planes(sites, pts, ids)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _ref_planes(sites, pts, ids))
    pad = ids < 0
    assert (got[pad][:, :3] == 0).all() and np.isinf(got[pad][:, 3]).all()
    empty = bisector_planes(np.empty((0, 3), np.float32), pts,
                            np.empty((0, k), np.int32))
    assert empty.shape == (0, k, 4)


# -- the plane feed on the engine's surfaces ----------------------------------

PLANE_CLOUDS = {
    "uniform": lambda: generate_uniform(1500, seed=20),
    "clustered": lambda: generate_clustered(2000, seed=21),
    "tiny": lambda: generate_uniform(3, seed=5),
}


@pytest.mark.parametrize("kernel", ["kpass", "blocked"])
@pytest.mark.parametrize("cloud", sorted(PLANE_CLOUDS))
def test_plane_feed_matches_jax(cloud, kernel):
    pts = PLANE_CLOUDS[cloud]()
    k = 6
    jp = ck.KnnProblem.prepare(pts, ck.KnnConfig(
        k=k, plane_feed=True, kernel=kernel, interpret=True))
    pp = pt.KnnProblem.prepare(pts, pt.KnnConfig(
        k=k, plane_feed=True, kernel=kernel), device="cpu")
    want = jp.solve()
    dispatch.reset_stats()
    got = pp.solve()
    assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET
    ids, jids = pp.get_knearests_original(), jp.get_knearests_original()
    assert got.planes.shape == (pts.shape[0], k, 4)
    np.testing.assert_array_equal(got.planes, _ref_planes(pts, pts, ids))
    same = (ids == jids).all(axis=1)
    assert same.mean() > 0.9
    np.testing.assert_array_equal(got.planes[same], want.planes[same])
    dispatch.reset_stats()
    assert pp.get_planes() is got.planes
    assert dispatch.stats().host_syncs == 0
    if cloud == "tiny":
        assert (ids < 0).any()
    queries = generate_uniform(200, seed=22)
    dispatch.reset_stats()
    q_ids, q_d2, q_planes = pp.query(queries, planes=True)
    assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET
    j_ids, _, j_planes = jp.query(queries, planes=True)
    np.testing.assert_array_equal(q_planes, _ref_planes(queries, pts, q_ids))
    same = (q_ids == j_ids).all(axis=1)
    assert same.mean() > 0.9
    np.testing.assert_array_equal(q_planes[same], j_planes[same])
    np.testing.assert_array_equal(q_ids, pp.query(queries)[0])


def test_get_planes_without_plane_feed_and_empty_cloud():
    pts = generate_uniform(400, seed=23)
    pp = pt.KnnProblem.prepare(pts, pt.KnnConfig(k=4), device="cpu")
    with pytest.raises(RuntimeError, match="solve"):
        pp.get_planes()
    assert pp.solve().planes is None
    jp = ck.KnnProblem.prepare(pts, ck.KnnConfig(k=4, interpret=True))
    jp.solve()
    ids = pp.get_knearests_original()
    np.testing.assert_array_equal(pp.get_planes(),
                                  _ref_planes(pts, pts, ids))
    same = (ids == jp.get_knearests_original()).all(axis=1)
    np.testing.assert_array_equal(pp.get_planes()[same],
                                  jp.get_planes()[same])
    empty = pt.KnnProblem.prepare(np.empty((0, 3), np.float32),
                                  pt.KnnConfig(k=4, plane_feed=True),
                                  device="cpu")
    assert empty.solve().planes.shape == (0, 4, 4)
    q = generate_uniform(5, seed=24)
    _, _, planes = empty.query(q, planes=True)
    assert planes.shape == (5, 4, 4) and np.isinf(planes[..., 3]).all()


def test_plane_feed_from_jax_checkpoint(tmp_path):
    """A checkpoint resumed in the port has no host copy of the cloud: the
    plane feed fetches it once (counted) and caches it."""
    pts = generate_uniform(1200, seed=25)
    jp = ck.KnnProblem.prepare(pts, ck.KnnConfig(k=5, plane_feed=True,
                                                 interpret=True))
    jp.solve()
    path = str(tmp_path / "planes.npz")
    ck.save_problem(jp, path)
    loaded = pt.load_problem(path, device="cpu")
    assert loaded.config.plane_feed and loaded.host_points is None
    dispatch.reset_stats()
    res = loaded.solve()
    syncs = dispatch.stats().host_syncs
    assert syncs <= dispatch.SYNC_BUDGET + 1
    np.testing.assert_array_equal(loaded.host_points, pts)
    ids = loaded.get_knearests_original()
    np.testing.assert_array_equal(res.planes, _ref_planes(pts, pts, ids))
    same = (ids == jp.get_knearests_original()).all(axis=1)
    assert same.mean() > 0.9
    np.testing.assert_array_equal(loaded.get_planes()[same],
                                  jp.get_planes()[same])
    # the cached copy: the next plane feed costs no round trip
    dispatch.reset_stats()
    _, _, planes = loaded.query(pts[:50], planes=True)
    assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET
    np.testing.assert_array_equal(
        planes, _ref_planes(pts[:50], pts, loaded.query(pts[:50])[0]))


def test_host_original_costs_one_counted_fetch(tmp_path):
    pts = generate_uniform(700, seed=26)
    pp = pt.KnnProblem.prepare(pts, pt.KnnConfig(k=4), device="cpu")
    assert pp.host_points is not None
    path = str(tmp_path / "p.npz")
    pt.save_problem(pp, path)
    loaded = pt.load_problem(path, device="cpu")
    dispatch.reset_stats()
    np.testing.assert_array_equal(loaded._host_original(), pts)
    assert dispatch.stats().host_syncs == 1
    loaded._host_original()
    assert dispatch.stats().host_syncs == 1


def test_cluster_smoke_module_on_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "cuda_knearests_tpu_torch.cluster",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 4 and all('"ok": true' in ln for ln in lines)
