"""The PyTorch port's brute route against the JAX package: the bound math,
the plain version of the selection kernel, ``solve_general`` end to end,
its refusals and degraded modes, and the two repaired general-d pieces
(the brute fallbacks and the front door's ``dims``).

The JAX side runs as its own tests run it on the CPU: ``solve_blocks_xla``
(the XLA twin) and ``select_pallas`` in interpret mode.  Dot-form scores
are not bit-identical across the packages on the CPU -- XLA sums the dot
product and the norms in its own order and contracts multiply-adds, the
port sums each over axes 0..d-1 one rounded op at a time -- so selections
are compared where they are proven (certified rows) and certificates may
differ only on rows whose margin kplus - t - 2B lies inside that rounding.
Final answers at ``recall_target=1.0`` are byte-identical: both packages
realize every row's distances with the same host numpy epilogue.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_knearests_tpu import mxu as jmxu
from cuda_knearests_tpu import io as jio
from cuda_knearests_tpu.fuzz.compare import check_route_result
from cuda_knearests_tpu.fuzz.generators import _ZOO
from cuda_knearests_tpu.io import generate_blue_noise, generate_clustered
from cuda_knearests_tpu.mxu import measure as jmeasure
from cuda_knearests_tpu.mxu import topk as jtopk
from cuda_knearests_tpu.mxu.kernel import select_pallas
from cuda_knearests_tpu.mxu.scorer import solve_blocks_xla
from cuda_knearests_tpu.ops.query import brute_force_by_coords as jcoords
from cuda_knearests_tpu.ops.solve import brute_force_by_index as jindex
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch import io as pio
from cuda_knearests_tpu_torch import mxu as pmxu
from cuda_knearests_tpu_torch.mxu import kernel as pkernel
from cuda_knearests_tpu_torch.mxu import scorer as pscorer
from cuda_knearests_tpu_torch.mxu import topk as ptopk
from cuda_knearests_tpu_torch.ops.query import brute_force_by_coords
from cuda_knearests_tpu_torch.runtime import dispatch
from cuda_knearests_tpu_torch.utils import memory as pmem

CPU = "cpu"


# -- (a) the bound math is the JAX package's ----------------------------------

def test_topk_constants_bit_for_bit():
    for name in ("BLOCK", "PRECISIONS", "_EPS32", "_ERR_SAFETY",
                 "_SCORE_EPS", "_CAST_SITES"):
        assert getattr(ptopk, name) == getattr(jtopk, name), name


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_topk_math_matches_jax(precision):
    qn = np.random.default_rng(0).random(64).astype(np.float32) * 3e5
    for rt in (0.3, 0.6, 0.8, 0.9, 0.95, 0.999, 1.0):
        for k in (1, 2, 4, 10, 50, 128, 200):
            assert ptopk.bins_for(rt, k) == jtopk.bins_for(rt, k)
            for g in (1, 2, 7, 16, 157, 2344):
                m = ptopk.per_block_m(rt, k, g)
                assert m == jtopk.per_block_m(rt, k, g)
                assert ptopk.recall_bound(k, g, m) == \
                    jtopk.recall_bound(k, g, m)
    for d in (1, 3, 17, 128):
        for pn_max in (np.float32(0.0), np.float32(2.5e5)):
            np.testing.assert_array_equal(
                ptopk.dot_error_bound(qn, pn_max, d, precision),
                jtopk.dot_error_bound(qn, pn_max, d, precision))
    for n_slots in (128, 256, 1280):
        np.testing.assert_array_equal(ptopk.interleave_slots(n_slots),
                                      jtopk.interleave_slots(n_slots))
    for bad in ("fp16", "auto"):
        with pytest.raises(ValueError):
            jtopk.check_precision(bad)
        with pytest.raises(ValueError):
            ptopk.check_precision(bad)


# -- (b) select_plain against solve_blocks_xla and select_pallas ---------------

def _il_inputs(pts: np.ndarray, d_pad: int):
    """The JAX wrapper's interleaved, padded candidates and self-exclusion
    ids, with queries padded to a 128 multiple and d to ``d_pad``."""
    n, d = pts.shape
    c_pad = -(-n // 128) * 128
    il = jtopk.interleave_slots(c_pad)
    pp = np.zeros((c_pad, d_pad), np.float32)
    pp[:n, :d] = pts
    cid = np.full((c_pad,), -1, np.int32)
    cid[:n] = np.arange(n)
    qp = np.zeros((c_pad, d_pad), np.float32)
    qp[:n, :d] = pts
    qid = np.full((c_pad,), -1, np.int32)
    qid[:n] = np.arange(n)
    return pp[il], cid[il], qp, qid


def _f64_margin(pts, pts_il, cid_il, k, m, precision):
    """Per query (self-solve), kplus - t - 2B of the fold in exact f64
    scores, and B: where the two packages' f32 certificates may disagree
    (|margin| within the scores' rounding, which B bounds)."""
    p = pts_il.astype(np.float64)
    q = pts.astype(np.float64)
    s = (q * q).sum(1)[:, None] + (p * p).sum(1)[None, :] - 2.0 * q @ p.T
    s[:, cid_il < 0] = np.inf
    s[np.arange(len(q))[:, None] == cid_il[None, :]] = np.inf
    g = s.shape[1] // 128
    blocks = np.sort(s.reshape(len(q), g, 128), axis=-1)
    rem = blocks[..., m].min(-1) if m < 128 else np.full(len(q), np.inf)
    pool = np.sort(np.concatenate(
        [blocks[..., :m].reshape(len(q), -1),
         np.full((len(q), k + 1), np.inf)], axis=1), axis=1)
    pn_max = max(0.0, float((p[cid_il >= 0] ** 2).sum(1).max()))
    b = jtopk.dot_error_bound((q * q).sum(1), pn_max, pts.shape[1],
                              precision)
    with np.errstate(invalid="ignore"):
        return np.minimum(rem, pool[:, k]) - pool[:, k - 1] - 2 * b, b


def _compare_selection(name, got, want, margin, band, min_cert):
    """Certificates equal except where |kplus - t - 2B| <= 2B in exact
    arithmetic (each package's scores lie within B of the exact ones, so
    its margin within 2B of the exact margin); certified rows select the
    same id set."""
    (pi, pcert), (ji, jcert) = got, want
    differ = np.nonzero(pcert != jcert)[0]
    assert np.all(np.abs(margin[differ]) <= 2 * band[differ]), (
        f"{name}: certificates differ outside the rounding band at rows "
        f"{differ[np.abs(margin[differ]) > 2 * band[differ]][:10]}")
    both = pcert & jcert
    assert both.mean() >= min_cert, f"{name}: {both.mean()} certified"
    for r in np.nonzero(both)[0]:
        assert set(pi[r][pi[r] >= 0]) == set(ji[r][ji[r] >= 0]), (
            f"{name}: certified row {r} selects other ids")


def _cloud(kind: str, d: int) -> np.ndarray:
    """'uniform': 700 points in [0, 100]^d.  'separated': 10-point blobs
    of radius ~1e-3 at +-e_i, so a 9-NN row's gap to the next blob (~2)
    clears even the bf16 band (2B ~ 1) and rows certify at both tiers."""
    rng = np.random.default_rng(10 + d)
    if kind == "uniform":
        return (rng.random((700, d)) * 100.0).astype(np.float32)
    centers = np.concatenate([np.eye(d), -np.eye(d)])
    return (np.repeat(centers, 10, axis=0)
            + rng.normal(size=(20 * d, d)) * 1e-3).astype(np.float32)


SELECT_CASES = [  # (cloud, d, k, m, precision, least certified fraction)
    ("uniform", 3, 10, 10, "f32", 0.5), ("uniform", 3, 10, 3, "f32", 0.05),
    ("uniform", 17, 8, 8, "f32", 0.5), ("uniform", 17, 8, 2, "f32", 0.0),
    ("uniform", 3, 10, 3, "bf16", 0.0),
    ("separated", 17, 9, 9, "bf16", 0.9), ("separated", 17, 9, 3, "bf16", 0.0),
]


@pytest.mark.parametrize("case", SELECT_CASES,
                         ids=["-".join(map(str, c[:5])) for c in SELECT_CASES])
def test_select_plain_matches_jax_cores(case):
    kind, d, k, m, precision, min_cert = case
    pts = _cloud(kind, d)
    n = pts.shape[0]
    d_pad = -(-d // 8) * 8
    pts_il, cid_il, qp, qid = _il_inputs(pts, d_pad)
    pi, ps, pcert = pscorer.select_plain(
        torch.tensor(pts), torch.arange(n, dtype=torch.int32),
        torch.tensor(np.ascontiguousarray(pts_il[:, :d])),
        torch.tensor(cid_il), k, m, d, True, precision)
    pi, pcert = pi.numpy(), pcert.numpy()
    # the inf/-1 contract and ascending (score, id) rows
    assert ((pi < 0) == np.isinf(ps.numpy())).all()
    assert (np.diff(ps.numpy(), axis=1) >= 0).all()
    margin, band = _f64_margin(pts, pts_il[:, :d], cid_il, k, m, precision)
    xi, _, xcert = solve_blocks_xla(
        jnp.asarray(pts_il[:, :d]), jnp.asarray(cid_il),
        jnp.asarray(qp[:, :d]), jnp.asarray(qid), k, m, True, 128,
        None, precision)
    _compare_selection("xla", (pi, pcert),
                       (np.asarray(xi)[:n], np.asarray(xcert)[:n]),
                       margin, band, min_cert)
    ki, _, kcert = select_pallas(
        jnp.asarray(qp), jnp.asarray(qid), jnp.asarray(pts_il),
        jnp.asarray(cid_il), k, m, d, True, True, precision)
    _compare_selection("pallas", (pi, pcert),
                       (np.asarray(ki)[:n], np.asarray(kcert)[:n]),
                       margin, band, min_cert)


def test_select_plain_fold_rules():
    # every score tied (0): selection by id, and no row certifies (kplus,
    # a left-out 0, cannot clear t + 2B > 0); with m = 1 each of the three
    # blocks keeps its lowest id and the pool runs short of k
    n, k = 300, 5
    il = ptopk.interleave_slots(384)
    pts = torch.ones((384, 2))
    cid = torch.tensor(np.where(il < n, il, -1), dtype=torch.int32)
    q = torch.ones((4, 2))
    qid = torch.tensor([0, 7, -1, 299], dtype=torch.int32)
    ids, s, cert = pscorer.select_plain(q, qid, pts, cid, k, k, 2, True)
    assert ids.tolist()[1] == [0, 1, 2, 3, 4]
    assert ids.tolist()[0] == [1, 2, 3, 4, 5]
    assert float(s.abs().max()) == 0.0 and not cert.any()
    ids, s, cert = pscorer.select_plain(q, qid, pts, cid, k, 1, 2, False)
    assert ids[0].tolist() == [0, 1, 2, -1, -1]
    assert torch.isinf(s[0, 3:]).all()


def test_score_keys_order_signed_scores():
    s = torch.tensor([[-2.0, -1.0, -1.0, 0.0, 3.0, float("inf"),
                       float("nan"), -0.5]])
    ids = torch.tensor([[5, 9, 2, 1, 0, 3, 4, 8]], dtype=torch.int32)
    key = pscorer.score_key(s, ids)
    order = torch.argsort(key[0]).tolist()
    assert [int(ids[0, j]) for j in order[:6]] == [5, 2, 9, 8, 1, 0]
    assert pscorer.key_score(key).tolist()[0][:5] == [-2.0, -1.0, -1.0,
                                                      0.0, 3.0]
    assert pscorer.key_id(key)[0, 5:7].tolist() == [-1, -1]


def test_select_wrapper_rules(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from cuda_knearests_tpu_torch.ops import _build

    def tensors(device=None):
        return (torch.zeros((3, 4), device=device),
                torch.zeros((3,), dtype=torch.int32, device=device),
                torch.zeros((128, 4), device=device),
                torch.zeros((128,), dtype=torch.int32, device=device))

    z, zi, c, ci = tensors()
    with pytest.raises(ValueError, match="multiple of 128"):
        pkernel.select(z, zi, c[:100], ci[:100], 2, 2, 4, True)
    with pytest.raises(ValueError, match="cid_il"):
        pkernel.select(z, zi, c, ci.long(), 2, 2, 4, True)
    with pytest.raises(ValueError, match="precision"):
        pkernel.select(z, zi, c, ci, 2, 2, 4, True, "fp16")
    assert pkernel.pick_launch(3, 10, 10) == (128, 3, True)
    assert pkernel.pick_launch(128, 10, 10) == (128, 16, False)
    assert pkernel.pick_launch(128, 128, 127) == (64, 32, True)
    # wide rows stream in d-chunks: no d is refused
    assert pkernel.pick_launch(40_000, 10, 10) == (128, 16, False)
    with pytest.raises(pmem.LaunchBudgetError, match="232448-byte limit"):
        pkernel.pick_launch(3, 2000, 128)

    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    def no_toolkit(name):
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(pkernel, "select_plain", no_plain)
    monkeypatch.setattr(_build, "load", no_toolkit)
    before = pkernel.launches
    with FakeTensorMode():
        with pytest.raises(_build.KernelBuildError):
            pkernel.select(*tensors("cuda"), 2, 2, 4, True)
    assert pkernel.launches == before


# -- (c) solve_general at recall_target=1.0 is byte-identical to JAX -----------

def _byte_equal(a, b):
    np.testing.assert_array_equal(a.neighbors, b.neighbors)
    np.testing.assert_array_equal(a.dists_sq, b.dists_sq)
    assert a.certified.all() and b.certified.all()
    assert a.uncert_count == b.uncert_count
    assert (a.m, a.n_blocks, a.bound) == (b.m, b.n_blocks, b.bound)


def test_solve_general_byte_identity_blue_noise():
    pts = generate_blue_noise(1500, seed=41)
    p = pmxu.solve_general(pts, k=8, recall_target=1.0, device=CPU)
    assert p.backend == "plain" and p.precision == "f32"
    _byte_equal(p, jmxu.solve_general(pts, k=8, recall_target=1.0))


def test_solve_general_byte_identity_external_queries():
    pts = generate_blue_noise(3000, seed=11)
    q = (np.random.default_rng(3).random((513, 3)) * 1000.0).astype(
        np.float32)
    _byte_equal(pmxu.solve_general(pts, k=8, queries=q, device=CPU),
                jmxu.solve_general(pts, k=8, queries=q))


@pytest.mark.parametrize("d", [1, 2, 6, 17])
def test_solve_general_byte_identity_general_d(d):
    rng = np.random.default_rng(100 + d)
    pts = (rng.random((700, d)) * 50.0).astype(np.float32)
    _byte_equal(pmxu.solve_general(pts, k=6, device=CPU),
                jmxu.solve_general(pts, k=6))
    # the exact elementwise scorer lands on the same bytes
    e = pmxu.solve_general(pts, k=6, scorer="elementwise", device=CPU)
    np.testing.assert_array_equal(
        e.neighbors, jmxu.solve_general(pts, k=6, scorer="elementwise")
        .neighbors)
    assert e.backend == "elementwise"


# -- (d) the approximate tier ------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_approximate_tier_claims(precision):
    pts = generate_clustered(1024, seed=43)
    p = pmxu.solve_general(pts, k=10, recall_target=0.7, refine="none",
                           precision=precision, device=CPU)
    j = jmxu.solve_general(pts, k=10, recall_target=0.7, refine="none",
                           precision=precision)
    assert (p.m, p.n_blocks, p.bound) == (j.m, j.n_blocks, j.bound)
    assert p.precision == precision
    rows = np.nonzero(p.certified)[0]
    assert rows.size or precision == "bf16"  # the bf16 band certifies few
    assert jmeasure.certified_recall(pts, p.neighbors, rows, 10) >= 1.0
    band = jmeasure.declared_band(pts, precision=precision)
    assert jmeasure.measured_recall(pts, p.neighbors, 10,
                                    band=band) >= p.bound
    # a genuinely approximate fold (m < k) keeps its claims too
    q = pmxu.solve_general(pts, k=10, recall_target=0.3, refine="none",
                           precision=precision, device=CPU)
    assert q.m < 10 and q.bound < 1.0
    assert q.m == jmxu.solve_general(pts, k=10, recall_target=0.3,
                                     refine="none").m
    rows = np.nonzero(q.certified)[0]
    assert jmeasure.certified_recall(pts, q.neighbors, rows, 10) >= 1.0
    assert jmeasure.measured_recall(pts, q.neighbors, 10,
                                    band=band) >= q.bound


# -- (e) refusals, degraded modes, the sync budget ----------------------------

REFUSALS = [
    dict(scorer="gpu"), dict(recall_target=0.0), dict(recall_target=1.5),
    dict(scorer="elementwise", recall_target=0.9), dict(precision="fp16"),
    dict(scorer="elementwise", precision="bf16"), dict(refine="maybe"),
    dict(k=0), dict(k=2.5),
]


@pytest.mark.parametrize("kw", REFUSALS, ids=lambda kw: "-".join(
    f"{a}={b}" for a, b in kw.items()))
def test_refusals_match_jax(kw):
    pts = generate_blue_noise(200, seed=1)
    kw = dict(dict(k=4), **kw)
    with pytest.raises(ValueError) as je:
        jmxu.solve_general(pts, **kw)
    with pytest.raises(ValueError) as pe:
        pmxu.solve_general(pts, device=CPU, **kw)
    assert type(pe.value).__name__ == type(je.value).__name__


def test_reference_only_knobs_are_not_parameters():
    """The reference's runtime knobs are parameters now, in its order:
    ``interpret=True`` (Pallas interpret mode) is refused with
    ``InvalidConfigError``, as ``KnnConfig`` refuses it, and
    ``query_chunk`` splits the selection without changing a byte."""
    pts = generate_blue_noise(200, seed=1)
    with pytest.raises(pmem.InvalidConfigError, match="interpret"):
        pmxu.solve_general(pts, k=4, device=CPU, interpret=True)
    _byte_equal(pmxu.solve_general(pts, k=4, device=CPU, query_chunk=64),
                pmxu.solve_general(pts, k=4, device=CPU))


def test_queries_width_mismatch_is_refused():
    pts = np.zeros((8, 4), np.float32)
    with pytest.raises(pmem.InvalidShapeError):
        pmxu.solve_general(pts, k=2, queries=np.zeros((4, 3), np.float32),
                           device=CPU)


def test_degraded_modes_match_jax():
    pts = np.zeros((3, 7), np.float32)
    pts[:] = np.arange(3)[:, None]
    p = pmxu.solve_general(pts, k=5, device=CPU)
    _byte_equal(p, jmxu.solve_general(pts, k=5))
    assert (p.neighbors[:, 2:] == -1).all()
    assert np.isinf(p.dists_sq[:, 2:]).all()
    for shape in ((0, 9), (0, 3)):
        e = pmxu.solve_general(np.zeros(shape, np.float32), k=3, device=CPU)
        assert e.neighbors.shape == (0, 3) and e.uncert_count == 0
    q = pmxu.solve_general(pts, k=2, queries=np.zeros((0, 7)), device=CPU)
    assert q.neighbors.shape == (0, 2)
    np.testing.assert_array_equal(pmxu.knn(pts, k=5, device=CPU),
                                  p.neighbors)


@pytest.mark.parametrize("rt", [1.0, 0.6])
def test_solve_general_sync_budget(rt):
    pts = generate_blue_noise(2000, seed=5)
    dispatch.reset_stats()
    res = pmxu.solve_general(pts, k=10, recall_target=rt, device=CPU)
    expected = 1 + (1 if res.uncert_count else 0)
    assert dispatch.stats().host_syncs == expected <= dispatch.SYNC_BUDGET
    assert res.certified.all()


def test_entry_points_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = generate_blue_noise(200, seed=3)
    with pytest.raises(pmem.NoDeviceError):
        pmxu.solve_general(pts, k=4)
    with pytest.raises(pmem.NoDeviceError):
        pmxu.knn(pts, k=4)


def test_grid_route_points_general_d_at_the_brute_route():
    # the grid route's MXU tier keeps the d=3 contract too
    for kw in (dict(), dict(scorer="mxu"), dict(recall_target=0.9),
               dict(precision="bf16")):
        with pytest.raises(pmem.InputContractError, match="mxu"):
            pt.KnnProblem.prepare(np.zeros((16, 5), np.float32),
                                  pt.KnnConfig(k=4, **kw), device=CPU)


# -- (f) the repaired general-d pieces ----------------------------------------

@pytest.mark.parametrize("d", [1, 2, 6])
def test_brute_fallbacks_general_d_match_jax(d):
    rng = np.random.default_rng(40 + d)
    pts = (rng.random((900, d)) * 30.0).astype(np.float32)
    q_idx = np.array([0, 5, 17, -1, 899, 450, 42], np.int32)
    ok = q_idx >= 0
    for excl in (True, False):
        ji, jd = jindex(jnp.asarray(pts), jnp.asarray(q_idx), 7, excl,
                        tile=256)
        pi, pd = pt.brute_force_by_index(torch.tensor(pts),
                                         torch.tensor(q_idx), 7, excl,
                                         tile=256)
        assert (pi.numpy()[~ok] == -1).all()
        bad = check_route_result(pts, pts[q_idx[ok]], pi.numpy()[ok],
                                 pd.numpy()[ok], np.asarray(jd)[ok], 7)
        assert bad is None, bad.render()
    q = (rng.random((33, d)) * 30.0).astype(np.float32)
    ji, jd = jcoords(jnp.asarray(pts), jnp.asarray(q), 7, tile=256)
    pi, pd = brute_force_by_coords(torch.tensor(pts), torch.tensor(q), 7,
                                   tile=256)
    bad = check_route_result(pts, q, pi.numpy(), pd.numpy(),
                             np.asarray(jd), 7)
    assert bad is None, bad.render()


def _zoo_inputs():
    """The fuzz zoo's raw (un-normalized) clouds plus the shapes and values
    a general-d front door must refuse or accept."""
    out = []
    for name in sorted(_ZOO):
        raw = np.asarray(_ZOO[name].fn(np.random.default_rng(1), 40, 5))
        out.append((name, raw))
    out += [("d1", np.arange(6.0)[:, None]), ("d9", np.ones((4, 9))),
            ("empty-d5", np.zeros((0, 5))), ("negative-big",
                                            np.array([[-5.0, 2e6]])),
            ("nan", np.array([[np.nan, 0.0]])), ("inf", np.array([[np.inf]])),
            ("ndim1", np.zeros(5)), ("ndim3", np.zeros((2, 2, 2))),
            ("d0", np.zeros((4, 0))), ("ragged", [[1.0, 2.0], [3.0]]),
            ("text", [["a", "b"]])]
    return out


@pytest.mark.parametrize("case", _zoo_inputs(), ids=lambda c: c[0])
def test_front_door_dims_none_matches_jax(case):
    _, raw = case
    for k in (5, 0):
        try:
            want = jio.validate_or_raise(raw, k=k, dims=None)
        except ValueError as e:
            with pytest.raises(ValueError) as pe:
                pio.validate_or_raise(raw, k=k, dims=None)
            assert type(pe.value).__name__ == type(e).__name__
            assert pe.value.kind == "invalid-input"
        else:
            np.testing.assert_array_equal(
                pio.validate_or_raise(raw, k=k, dims=None), want)


# -- (g) shapes the selection kernels' gate refuses ----------------------------
# From k = 1,715 at d=3 (1,589 at d=128) no block holds a query's lists, so
# pick_launch / pick_launch_bf16 refuse; the JAX package answers such shapes
# through solve_blocks_xla, the port through the split selection on the
# card and select_plain on the CPU.

LARGE_K = 1800


@pytest.fixture(scope="module")
def large_k_cloud():
    return (np.random.default_rng(0).random((2000, 3)) * 1000).astype(
        np.float32)


def _swaps_within_band(pts, queries, got, want, precision):
    """Rows whose selected id sets differ swap only ids whose exact
    squared distances lie within 2B of each other: each package's scores
    lie within B (``dot_error_bound``) of the exact ones, so neither can
    prefer an id more than 2B farther than one it left out."""
    p64 = pts.astype(np.float64)
    pn_max = float((p64 * p64).sum(1).max())
    q64 = queries.astype(np.float64)
    band = 2.0 * np.asarray(jtopk.dot_error_bound(
        (q64 * q64).sum(1), pn_max, pts.shape[1], precision), np.float64)
    for r in np.nonzero((got != want).any(1))[0]:
        a = np.setdiff1d(got[r], want[r])
        b = np.setdiff1d(want[r], got[r])
        assert a.size == b.size
        if not a.size:
            continue
        ea = ((p64[a] - q64[r]) ** 2).sum(1)
        eb = ((p64[b] - q64[r]) ** 2).sum(1)
        assert np.abs(ea[:, None] - eb[None, :]).max() <= band[r], (
            f"row {r}: swapped ids outside the {precision} band")


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("rt", [1.0, 0.9])
def test_solve_general_gate_refused_k_matches_jax(large_k_cloud, rt,
                                                  precision):
    pts = large_k_cloud
    refine = "brute" if rt == 1.0 else "none"
    m = ptopk.per_block_m(rt, LARGE_K, -(-pts.shape[0] // 128))
    assert pkernel.launch_plan(3, LARGE_K, m, precision) is None
    p = pmxu.solve_general(pts, k=LARGE_K, recall_target=rt, refine=refine,
                           precision=precision, device=CPU)
    j = jmxu.solve_general(pts, k=LARGE_K, recall_target=rt, refine=refine,
                           precision=precision)
    assert p.backend == "plain" and j.backend == "xla"
    assert p.neighbors.shape == (pts.shape[0], LARGE_K)
    assert (p.m, p.n_blocks, p.bound) == (j.m, j.n_blocks, j.bound)
    np.testing.assert_array_equal(p.certified, j.certified)
    assert p.uncert_count == j.uncert_count
    if rt == 1.0:
        _byte_equal(p, j)
    elif precision == "f32":
        # the unrefined f32 fold selects the same rows on this cloud
        np.testing.assert_array_equal(p.neighbors, j.neighbors)
        np.testing.assert_array_equal(p.dists_sq, j.dists_sq)
    else:
        # bf16 q.p rounds in another order under XLA: no row certifies at
        # either package, and uncertified rows swap ids inside the band
        assert not p.certified.any()
        _swaps_within_band(pts, pts, p.neighbors, j.neighbors, precision)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_solve_general_gate_refused_k_general_d_matches_jax(precision):
    rng = np.random.default_rng(1)
    pts = (rng.random((1700, 128)) * 100).astype(np.float32)
    q = (rng.random((48, 128)) * 100).astype(np.float32)
    k = 1590  # one above the largest k a d=128 block holds
    assert pkernel.launch_plan(128, k - 2, 128, precision) is not None
    assert pkernel.launch_plan(128, k, 128, precision) is None
    p = pmxu.solve_general(pts, k=k, queries=q, precision=precision,
                           device=CPU)
    assert p.backend == "plain"
    _byte_equal(p, jmxu.solve_general(pts, k=k, queries=q,
                                      precision=precision))


def test_select_on_the_cpu_never_consults_the_gate(monkeypatch):
    def no_gate(*a, **k):
        raise AssertionError("the launch gate was consulted on the CPU")

    for name in ("pick_launch", "pick_launch_bf16", "launch_plan"):
        monkeypatch.setattr(pkernel, name, no_gate)
    q, qid, p, cid = (torch.tensor(a) for a in _il_inputs_small())
    for precision in ("f32", "bf16"):
        got = pkernel.select(q, qid, p, cid, LARGE_K, 128, 3, True,
                             precision)
        want = pscorer.select_plain(q, qid, p, cid, LARGE_K, 128, 3, True,
                                    precision)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _il_inputs_small():
    pts = (np.random.default_rng(2).random((300, 3)) * 100).astype(
        np.float32)
    pts_il, cid_il, _, _ = _il_inputs(pts, 3)
    return pts, np.arange(300, dtype=np.int32), pts_il, cid_il


def test_gate_refused_cuda_select_launches_the_split_kernel(monkeypatch):
    """On CUDA tensors the route is chosen by shape before any launch: a
    shape the gate refuses goes to the split selection, one it takes to
    the tier's one-block kernel, and neither gives way to the plain
    version, so without a toolkit each raises its own build error."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from cuda_knearests_tpu_torch.ops import _build

    loaded = []

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for CUDA tensors")

    def no_toolkit(name):
        loaded.append(name)
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(pkernel, "select_plain", no_plain)
    monkeypatch.setattr(_build, "load", no_toolkit)
    counts = (pkernel.launches, pkernel.launches_bf16, pkernel.split_launches,
              pkernel.prep_launches, pkernel.prep_launches_f32)
    with FakeTensorMode():
        dev = (torch.zeros((3, 3), device="cuda"),
               torch.zeros((3,), dtype=torch.int32, device="cuda"),
               torch.zeros((128, 3), device="cuda"),
               torch.zeros((128,), dtype=torch.int32, device="cuda"))
        for precision, lib in (("f32", "mxu_select"),
                               ("bf16", "mxu_select_bf16")):
            for k, m, want in ((LARGE_K, 128, "mxu_select_split"),
                               (2, 2, lib)):
                loaded.clear()
                with pytest.raises(_build.KernelBuildError):
                    pkernel.select_routed(*dev, k, m, 3, True, precision)
                assert loaded == [want], (precision, k)
            loaded.clear()
            with pytest.raises(_build.KernelBuildError):
                pkernel.select_split(*dev, 2, 2, 3, True, precision)
            assert loaded == ["mxu_select_split"]
    assert (pkernel.launches, pkernel.launches_bf16, pkernel.split_launches,
            pkernel.prep_launches, pkernel.prep_launches_f32) == counts


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_select_routed_names_the_plain_route_on_the_cpu(precision):
    q, qid, p, cid = (torch.tensor(a) for a in _il_inputs_small())
    route, got = pkernel.select_routed(q, qid, p, cid, 7, 3, 3, True,
                                       precision)
    assert route == "plain"
    want = pscorer.select_plain(q, qid, p, cid, 7, 3, 3, True, precision)
    for a, b, c in zip(got, want, pkernel.select_split(q, qid, p, cid, 7, 3,
                                                       3, True, precision)):
        assert torch.equal(a, b) and torch.equal(c, b)


@pytest.mark.parametrize("n_q,n_c,k,m", [
    (2000, 2048, 1800, 128), (300_000, 300_032, 1800, 128),
    (48, 1792, 1590, 128), (40, 9088, 8200, 128), (10, 128, 1, 1),
    (1_000_000, 1_000_064, 2000, 3),
    # the direct arm over many blocks, its rows in scratch, the pool arm
    # at m < 128 on the same shape
    (3000, 3072, 1800, 128), (300_000, 300_032, 4000, 128),
    (20_000, 20_096, 1800, 100),
    # rows wider than the direct arm's 16-bit counts take the pool arm
    (100, 40_064, 40_000, 128)])
def test_split_plan_geometry(n_q, n_c, k, m):
    """The arm split_plan picks (direct where the fold keeps every key, d
    is at most the threshold and the row at most _SPLIT_DIRECT_MAX_KEYS,
    else pool) and each arm's geometry: the
    direct arm writes no pool and launches once unless its rows go to
    scratch; the pool arm's chunks bound pool, rem and scratch."""
    max_d = pkernel._SPLIT_DIRECT_MAX_D
    for d in (1, 3, max_d, max_d + 1, 128):
        plan = pkernel.split_plan(n_q, n_c, d, k, m)
        direct = (m >= 128 and d <= max_d
                  and 1 << k.bit_length() <= pkernel._SPLIT_DIRECT_MAX_KEYS)
        assert plan.arm == pkernel.split_arm(d, k, m) == \
            ("direct" if direct else "pool")
        assert plan == pkernel.split_plan(n_q, n_c, d, k, m, plan.arm)
    for arm in ("direct", "pool") if pkernel.split_arm(3, k, m) == "direct" \
            else ("pool",):
        arm_, rows, p_len, n2, scratch = pkernel.split_plan(n_q, n_c, 3, k,
                                                            m, arm)
        assert arm_ == arm
        # the sort's width: the power of two above k, in shared memory up
        # to the source's limit for the arm
        assert n2 > k and n2 & (n2 - 1) == 0 and n2 // 2 <= k
        if arm == "direct":
            assert p_len == 0
            assert scratch == (n2 > pkernel._SPLIT_DIRECT_SMEM_KEYS)
            if scratch:
                assert 1 <= rows <= n_q
                assert rows == 1 or 8 * n2 * rows <= \
                    pkernel._SPLIT_CHUNK_BYTES
            else:
                assert rows == n_q
            continue
        me = min(m, 128)
        assert p_len == (n_c // 128) * me
        assert scratch == (n2 > pkernel._SPLIT_SMEM_KEYS)
        assert 1 <= rows <= min(n_q, pkernel._SPLIT_MAX_ROWS)
        row_bytes = 8 * p_len + (4 * (n_c // 128) if me < 128 else 0) \
            + (8 * n2 if scratch else 0)
        assert rows == 1 or rows * row_bytes <= pkernel._SPLIT_CHUNK_BYTES


def test_split_plan_refuses_an_unknown_or_unfit_arm():
    with pytest.raises(ValueError):
        pkernel.split_plan(10, 128, 3, 5, 128, "both")
    with pytest.raises(ValueError):  # m < 128: the fold drops keys
        pkernel.split_plan(10, 128, 3, 5, 100, "direct")
    with pytest.raises(ValueError):  # rows beyond 16-bit counts
        pkernel.split_plan(10, 40_064, 3, 40_000, 128, "direct")
