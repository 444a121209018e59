"""The supercell top-k: plain torch version against the Pallas kernels, and
the wrapper's device and layout rules.

On the CPU the JAX kernels run in interpret mode on packs made by the JAX
package's own ``_pack_inputs``; the port's plain version runs on the same
arrays.  Distances are compared within the reference comparator's
tolerance and ids tie-aware (``fuzz/compare.check_route_result``), not bit
for bit: XLA's CPU backend contracts multiply-adds into FMAs and torch's
separate CPU ops do not, so the two packages' float32 distances may differ
by an ulp.  On the card the kernel and its plain version round every op
alike and must agree exactly (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_knearests_tpu as ck
from cuda_knearests_tpu.fuzz.compare import check_route_result
from cuda_knearests_tpu.io import generate_blue_noise
from cuda_knearests_tpu.ops.pallas_solve import (_pack_inputs, _pallas_topk,
                                                 _pallas_topk_rows)
from cuda_knearests_tpu_torch.ops import _build
from cuda_knearests_tpu_torch.ops import cuda_solve as cs
from cuda_knearests_tpu_torch.ops.solve import _box_cell_ids, _boxes_grid
from cuda_knearests_tpu_torch.utils.memory import LaunchBudgetError

QCAP, CCAP, N_SC = 128, 1152, 4


@pytest.fixture(scope="module")
def jax_pack():
    """JAX-packed inputs of 4 supercells of a 2500-point blue-noise grid
    (radius 2), plus the stored points and per-slot query coordinates."""
    pts = generate_blue_noise(2500, seed=5)
    jg = ck.build_grid(pts)
    sc = _boxes_grid(-(-jg.dim // 3))[[0, 5, 13, 26]]
    own = _box_cell_ids(sc, 0, 0, 3, jg.dim)
    cand = _box_cell_ids(sc, -2, 2, 3, jg.dim)
    packed = _pack_inputs(jg.points, jg.cell_starts, jg.cell_counts,
                          jnp.asarray(own), jnp.asarray(cand), QCAP, CCAP)
    q_ok = packed[1]
    jargs = packed[2:]
    host = [np.array(a).reshape(N_SC, -1) for a in jargs]
    # port argument order: qx, qy, qz, qid, cx, cy, cz, cid
    qx, qy, qz, cx, cy, cz, qid, cid = (torch.tensor(a) for a in host)
    pargs = (qx, qy, qz, qid, cx, cy, cz, cid)
    queries = np.stack([host[0], host[1], host[2]], -1).reshape(-1, 3)
    return dict(points=np.array(jg.points), jargs=jargs, q_ok=q_ok,
                pargs=pargs, queries=queries,
                q_ok_host=np.array(q_ok).reshape(-1))


def _sanitize(d, i):
    d, i = np.array(d), np.array(i)
    return d, np.where(np.isfinite(d), i, -1)


@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("k", [1, 10, 50])
def test_plain_matches_pallas_raw_layout(jax_pack, k, exclude_self):
    jd, ji = _pallas_topk(*jax_pack["jargs"], QCAP, CCAP, k, exclude_self,
                          True)
    jd, ji = _sanitize(jd, ji)
    pd, pi = cs.supercell_topk(*jax_pack["pargs"], k, exclude_self)
    assert pd.shape == (N_SC, k, QCAP) and pi.dtype == torch.int32
    rows = lambda a: np.swapaxes(np.asarray(a), 1, 2).reshape(-1, k)  # noqa: E731
    bad = check_route_result(jax_pack["points"], jax_pack["queries"],
                             rows(pi), rows(pd), rows(jd), k)
    assert bad is None, bad.render()
    # the inf/-1 contract holds exactly on both sides
    np.testing.assert_array_equal(np.isinf(rows(pd)), rows(pi) < 0)


@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("k", [1, 10, 50])
def test_plain_matches_pallas_row_layout(jax_pack, k, exclude_self):
    jd, ji = _pallas_topk_rows(*jax_pack["jargs"], QCAP, CCAP, k,
                               exclude_self, True, q_ok=jax_pack["q_ok"])
    jd, ji = _sanitize(jd, ji)
    ok = jax_pack["q_ok_host"]
    n_rows = int(ok.sum())
    # scatter the valid slots to rows in reverse order, pads to the sentinel
    tgt = np.full(ok.size, n_rows, np.int32)
    tgt[ok] = np.arange(n_rows)[::-1]
    out = (torch.full((n_rows, k), float("inf")),
           torch.full((n_rows, k), -1, dtype=torch.int32))
    pd, pi = cs.supercell_topk(*jax_pack["pargs"], k, exclude_self,
                               tgt=torch.tensor(tgt), out=out)
    assert pd is out[0] and pi is out[1]
    order = tgt[ok]
    bad = check_route_result(jax_pack["points"], jax_pack["queries"][ok],
                             pi.numpy()[order], pd.numpy()[order],
                             jd[ok], k)
    assert bad is None, bad.render()


def test_plain_tie_order_is_lowest_id():
    # every candidate at the same distance: the selection is by stored id
    s, q, c, k = 1, 8, 300, 5
    zeros = lambda w: torch.zeros((s, w))  # noqa: E731
    cid = torch.tensor(np.random.default_rng(0).permutation(c)[None, :],
                       dtype=torch.int32)
    qid = torch.full((s, q), cs._PAD_Q, dtype=torch.int32)
    d, i = cs.supercell_topk(zeros(q), zeros(q), zeros(q), qid, zeros(c),
                             zeros(c), zeros(c), cid, k, True)
    np.testing.assert_array_equal(i[0, :, 0].numpy(), np.arange(k))
    assert float(d.abs().max()) == 0.0


def test_fewer_candidates_than_k_pad_inf_minus_one():
    s, q, c, k = 2, 4, 128, 10
    rng = np.random.default_rng(1)
    cid = np.full((s, c), cs._PAD_C, np.int32)
    cid[0, :3] = [7, 8, 9]                       # 3 real, one of them self
    qid = np.full((s, q), cs._PAD_Q, np.int32)
    qid[0, 0] = 8
    f = lambda w: torch.tensor(rng.random((s, w), np.float32))  # noqa: E731
    d, i = cs.supercell_topk(f(q), f(q), f(q), torch.tensor(qid), f(c), f(c),
                             f(c), torch.tensor(cid), k, True)
    got = sorted(i[0, :, 0].tolist()[:2])
    assert got == [7, 9]
    assert (i[0, 2:, 0] == -1).all() and torch.isinf(d[0, 2:, 0]).all()
    assert (i[1] == -1).all() and torch.isinf(d[1]).all()


def test_shared_memory_limit_is_a_typed_refusal():
    assert cs.pick_q_tile(10, 104) == 128
    assert cs.pick_q_tile(10, 40) == 64
    assert cs.pick_q_tile(128, 1000) == 128
    assert cs.pick_q_tile(500, 1000) == 32
    with pytest.raises(LaunchBudgetError, match="232448-byte limit"):
        cs.pick_q_tile(1000, 1000)
    z = torch.zeros((1, 8))
    ids = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(LaunchBudgetError):
        cs.supercell_topk(z, z, z, ids, z, z, z, ids, 1000, True)


def test_wrapper_never_substitutes_plain_for_cuda_tensors(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    def no_toolkit(name):
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(cs, "supercell_topk_plain", no_plain)
    monkeypatch.setattr(_build, "load", no_toolkit)
    before = cs.launches
    with FakeTensorMode():
        f = torch.zeros((2, 16), device="cuda")
        i = torch.zeros((2, 16), dtype=torch.int32, device="cuda")
        with pytest.raises(_build.KernelBuildError):
            cs.supercell_topk(f, f, f, i, f, f, f, i, 4, True)
    assert cs.launches == before
    m = torch.zeros((2, 16), device="meta")
    mi = torch.zeros((2, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cs.supercell_topk(m, m, m, mi, m, m, m, mi, 4, True)


def test_wrapper_checks_layout():
    z = torch.zeros((2, 8))
    ids = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="cid"):
        cs.supercell_topk(z, z, z, ids, z, z, z, ids.long(), 3, True)
    with pytest.raises(ValueError, match="out"):
        cs.supercell_topk(z, z, z, ids, z, z, z, ids, 3, True,
                          tgt=torch.zeros(16, dtype=torch.int32))


def test_plain_chunking_does_not_change_results(jax_pack, monkeypatch):
    whole = cs.supercell_topk(*jax_pack["pargs"], 10, True)
    # chunks of one supercell and 100 query slots, then of 3 query slots
    for pairs in (100 * CCAP, 3 * CCAP):
        monkeypatch.setattr(cs, "_PLAIN_CHUNK_PAIRS", pairs)
        chunked = cs.supercell_topk(*jax_pack["pargs"], 10, True)
        assert torch.equal(chunked[0], whole[0])
        assert torch.equal(chunked[1], whole[1])


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """A library's name hashes the source and every ``csrc`` header it
    includes, so an edited header rebuilds every library that uses it."""
    import shutil

    for f in _build._CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    names = ("mxu_select", "mxu_select_bf16", "supercell_topk")
    before = {n: _build.library_path(n) for n in names}
    header = tmp_path / "select_fold.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["mxu_select"] != before["mxu_select"]
    assert after["mxu_select_bf16"] != before["mxu_select_bf16"]
    assert after["supercell_topk"] == before["supercell_topk"]


def test_launch_plan_accepts_exactly_the_routing_gate():
    """The one-stage kernel's launch plan takes exactly the (k, qcap) that
    ``pick_q_tile`` -- the class routing gate -- takes, k <= 892 at every
    qcap, so a class routed to the kernel always launches and a refused
    one always streams; the kernel's own lists (32 * 28 = 896 entries a
    query) hold every k the gate takes.  The gate's arithmetic turns over
    only at warp multiples of qcap, so qcap runs over its edges in 1-512."""
    assert 892 < 32 * cs._LANE_ENTRIES[-1] < 893 + 32
    for qcap in (1, 31, 32, 33, 45, 104, 480, 511, 512):
        for k in range(1, 1001):
            for gate in (lambda: cs.pick_q_tile(k, qcap),
                         lambda: cs.topk_plan(k, qcap, 1152)):
                if k <= 892:
                    gate()
                else:
                    with pytest.raises(LaunchBudgetError):
                        gate()
    assert cs.topk_plan(892, 512, 1152).lane_entries == 28


@pytest.mark.parametrize("k", [1, 10, 31, 32, 33, 50, 64, 65, 128, 500, 892])
def test_launch_plan_geometry(k):
    for qcap in (1, 8, 45, 104, 14392):
        for ccap in (0, 1, 256, 1152, 3072, 3073, 24704):
            plan = cs.topk_plan(k, qcap, ccap)
            # the narrowest instantiated list that holds k
            assert plan.lane_entries == min(e for e in cs._LANE_ENTRIES
                                            if 32 * e >= k)
            assert 1 <= plan.warps <= cs._TOPK_WARPS
            assert plan.warps == cs._TOPK_WARPS or 8 * plan.warps >= qcap
            assert plan.qchunk == 16 * plan.warps
            # the staged tile: a warp multiple, the whole ccap while it
            # fits, and small enough for four blocks (32 warps) on a 228 KB
            # SM, each with its static shared memory and the 1 KB the
            # runtime reserves a block
            assert plan.tile % 32 == 0 and 32 <= plan.tile <= cs._TOPK_TILE
            assert plan.tile >= min(ccap, cs._TOPK_TILE)
            assert 4 * (cs.topk_smem_bytes(plan) + cs._TOPK_STATIC_SMEM
                        + 1024) <= 228 * 1024
