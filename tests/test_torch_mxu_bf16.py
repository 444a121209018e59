"""The bf16 tier of the brute route's selection on the CPU: the pieces of
``csrc/mxu_select_bf16.cu`` that Python reaches, and the contract that
source states for its tensor-core sum.

  (a) the prep pass's plain twin (bf16 casts and ``scorer.norms``) is what
      ``select_plain`` uses, bit for bit;
  (b) the launch gate ``pick_launch_bf16`` accepts every (d, k, m) the f32
      gate accepts, refuses typed beyond, and the wrapper never runs the
      plain version or the f32 kernel for CUDA tensors;
  (c) the band argument, on an emulation of other f32 accumulation orders
      of the exact bf16 products (chunks of 16 summed in reverse, pairwise,
      or exactly and then truncated toward zero, as the tensor cores do):
      2 * delta stays within the f32 term of B, the fold of the perturbed
      scores selects scores within 2 * delta_max of ``select_plain``'s, and
      its certified rows are true top-k sets;
  (d) the same bf16 inputs through the JAX package's ``solve_blocks_xla``
      and through ``select_plain`` and the emulated fold agree on the rows
      both certify.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_knearests_tpu.mxu import topk as jtopk
from cuda_knearests_tpu.mxu.scorer import solve_blocks_xla
from cuda_knearests_tpu_torch.mxu import kernel as pkernel
from cuda_knearests_tpu_torch.mxu import scorer as pscorer
from cuda_knearests_tpu_torch.mxu import topk as ptopk
from cuda_knearests_tpu_torch.mxu.solve import select_inputs
from cuda_knearests_tpu_torch.utils import memory as pmem

EPS32 = float(np.finfo(np.float32).eps)


def _points(kind: str, n: int, d: int, seed: int) -> np.ndarray:
    """'uniform' in [0, 100)^d; 'mixed' signs (normal, scale 50);
    'dominant': uniform with one coordinate 1000x the rest, so one product
    dwarfs the others and the small ones round away in any order."""
    rng = np.random.default_rng(seed)
    if kind == "mixed":
        x = rng.normal(size=(n, d)) * 50.0
    else:
        x = rng.random((n, d)) * 100.0
        if kind == "dominant":
            x[:, d // 2] *= 1000.0
    return x.astype(np.float32)


def _selection(pts: np.ndarray, n_q: int):
    """The self-solve's selection inputs for the first n_q points."""
    qid, pts_il, cid_il = select_inputs(pts, n_q, True)
    return (torch.tensor(pts[:n_q]), torch.tensor(qid),
            torch.tensor(pts_il), torch.tensor(cid_il))


# -- (a) the prep pass's plain twin ------------------------------------------

@pytest.mark.parametrize("d", [1, 3, 17, 128])
def test_prep_plain_is_what_select_plain_uses(d):
    pts = _points("mixed", 300, d, seed=d)
    q, _, p, cid = _selection(pts, 300)
    xb, ns, nf, pn_max = pkernel.prep_plain(p, cid)
    assert xb.dtype == torch.bfloat16 and xb.shape == (p.shape[0],
                                                       pkernel.pad16(d))
    assert torch.equal(xb[:, :d].float(), pscorer._cast(p, "bf16"))
    assert not bool(xb[:, d:].float().any())
    assert torch.equal(ns, pscorer.norms(p, "bf16"))
    assert torch.equal(nf, pscorer.norms(p))
    want = torch.clamp(torch.where(cid >= 0, pscorer.norms(p),
                                   float("-inf")).amax(), min=0.0)
    assert pn_max.shape == (1,) and torch.equal(pn_max[0], want)
    # the scores the kernel forms from these pieces, summed in order, are
    # select_plain's score tile
    qb, qns, qnf, none = pkernel.prep_plain(q)
    assert none is None and torch.equal(qnf, pscorer.norms(q))
    qp = None
    for ax in range(d):
        term = qb[:, None, ax].float() * xb[None, :, ax].float()
        qp = term if qp is None else qp + term
    assert torch.equal((qns[:, None] + ns[None, :]) - 2.0 * qp,
                       pscorer.score_tile(q, p, "bf16"))
    # the CPU wrapper is the plain twin
    for a, b in zip(pkernel.prep(p, cid), (xb, ns, nf, pn_max)):
        assert torch.equal(a, b)


def test_prep_plain_pn_max_ignores_pads_and_floors_at_zero():
    p = torch.tensor([[3.0, 4.0], [100.0, 0.0], [0.0, 0.0]])
    _, _, nf, pn_max = pkernel.prep_plain(p, torch.tensor([0, -1, 2],
                                                          dtype=torch.int32))
    assert nf.tolist() == [25.0, 10000.0, 0.0] and pn_max.tolist() == [25.0]
    _, _, _, pn_max = pkernel.prep_plain(p, torch.full((3,), -1,
                                                       dtype=torch.int32))
    assert pn_max.tolist() == [0.0]


# -- (b) the launch gate and the wrapper --------------------------------------

def test_pick_launch_bf16_accepts_everything_pick_launch_accepts():
    accepted = 0
    for d in list(range(1, 48)) + list(range(48, 1025, 11)) + [1024]:
        for k in list(range(1, 33)) + list(range(33, 513, 13)) + [512]:
            for m in sorted({1, 3, min(k, 128)}):
                try:
                    pkernel.pick_launch(d, k, m)
                except pmem.LaunchBudgetError:
                    continue
                rows, kc, qres = pkernel.pick_launch_bf16(d, k, m)
                accepted += 1
                assert rows in (128, 64, 32, 16) and kc % 16 == 0
                assert pkernel.smem_bytes_bf16(d, k, m, rows, kc, qres) \
                    <= pkernel.SMEM_LIMIT
    assert accepted > 10_000


@pytest.mark.parametrize("accepting,other", [
    ("pick_launch", "pick_launch_bf16"), ("pick_launch_bf16", "pick_launch")])
def test_f32_and_bf16_gates_accept_the_same_shapes(accepting, other):
    """Whatever one tier's gate accepts the other accepts too, over the
    grid above and around the k limit (k = 1,715 at d=3)."""
    accepted = refused = 0
    ks = (list(range(1, 33)) + list(range(33, 513, 13)) + [512]
          + list(range(1560, 1760, 7)) + [1714, 1715])
    for d in list(range(1, 48)) + list(range(48, 1025, 11)) + [1024, 40_000]:
        for k in ks:
            for m in sorted({1, 3, min(k, 128)}):
                try:
                    getattr(pkernel, accepting)(d, k, m)
                except pmem.LaunchBudgetError:
                    refused += 1
                    with pytest.raises(pmem.LaunchBudgetError):
                        getattr(pkernel, other)(d, k, m)
                    continue
                accepted += 1
                plan = getattr(pkernel, other)(d, k, m)
                size = (pkernel.smem_bytes if other == "pick_launch"
                        else pkernel.smem_bytes_bf16)
                assert size(d, k, m, *plan) <= pkernel.SMEM_LIMIT
    assert accepted > 10_000 and refused > 1_000


def test_pick_launch_bf16_shapes_and_refusal():
    assert pkernel.pick_launch_bf16(3, 10, 1) == (128, 16, True)
    assert pkernel.pick_launch_bf16(128, 10, 1) == (128, 128, True)
    assert pkernel.pick_launch_bf16(2000, 10, 1) == (128, 64, False)
    assert pkernel.pick_launch_bf16(128, 128, 127)[0] == 64
    # lists of the f32 gate's old limit fit, in one warp of 16 rows
    assert pkernel.pick_launch(1, 907, 1) == (16, 1, True)
    assert pkernel.pick_launch_bf16(1, 900, 1)[0] == 16
    with pytest.raises(pmem.LaunchBudgetError, match="232448-byte limit"):
        pkernel.pick_launch_bf16(3, 2000, 1)


def test_bf16_wrapper_rules(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from cuda_knearests_tpu_torch.ops import _build

    q, qid, p, cid = _selection(_points("uniform", 200, 5, seed=1), 50)
    got = pkernel.select(q, qid, p, cid, 4, 2, 5, True, "bf16")
    want = pscorer.select_plain(q, qid, p, cid, 4, 2, 5, True, "bf16")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the score dump of the contract checks is a CUDA-only side door
    with pytest.raises(ValueError, match="CUDA"):
        pkernel._select_bf16_with_scores(q, qid, p, cid, 4, 2, 5, True)

    def fake(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    def no_toolkit(name):
        assert name == "mxu_select_bf16"
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(pkernel, "select_plain", fake)
    monkeypatch.setattr(pkernel, "prep_plain", fake)
    monkeypatch.setattr(_build, "load", no_toolkit)
    before = (pkernel.launches, pkernel.launches_bf16, pkernel.prep_launches)
    with FakeTensorMode():
        dev = [torch.zeros((3, 4), device="cuda"),
               torch.zeros((3,), dtype=torch.int32, device="cuda"),
               torch.zeros((128, 4), device="cuda"),
               torch.zeros((128,), dtype=torch.int32, device="cuda")]
        with pytest.raises(_build.KernelBuildError):
            pkernel.select(*dev, 2, 2, 4, True, "bf16")
        with pytest.raises(_build.KernelBuildError):
            pkernel._select_bf16_with_scores(*dev, 2, 2, 4, True)
        with pytest.raises(_build.KernelBuildError):
            pkernel.prep(dev[2], dev[3])
    assert (pkernel.launches, pkernel.launches_bf16,
            pkernel.prep_launches) == before


# -- (c) the band argument on other accumulation orders -----------------------

def _trunc32(x64: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero."""
    x32 = x64.float()
    over = x32.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)),
                       x32)


def _qp_other_order(qb: torch.Tensor, pb: torch.Tensor,
                    order: str) -> torch.Tensor:
    """q.p of bf16-valued f32 rows (M, d) x (C, d) with the exact f32
    products summed in f32 in another order than axis by axis: chunks of
    16 in reverse ('reverse16'), a pairwise tree ('pairwise'), or each
    chunk of 16 summed exactly and truncated toward zero into the running
    sum ('truncate16', the tensor cores' behaviour)."""
    prod = qb[:, None, :] * pb[None, :, :]          # exact in f32
    d = prod.shape[-1]
    if order == "pairwise":
        while prod.shape[-1] > 1:
            if prod.shape[-1] % 2:
                prod = torch.cat([prod, torch.zeros_like(prod[..., :1])], -1)
            prod = prod[..., 0::2] + prod[..., 1::2]
        return prod[..., 0]
    acc = torch.zeros(prod.shape[:2])
    for c0 in range(0, d, 16):
        chunk = prod[..., c0:c0 + 16]
        if order == "reverse16":
            for j in reversed(range(chunk.shape[-1])):
                acc = acc + chunk[..., j]
        else:
            acc = _trunc32(acc.double() + chunk.double().sum(-1))
    return acc


def _qp_in_order(qb, pb):
    qp = None
    for ax in range(qb.shape[1]):
        term = qb[:, None, ax] * pb[None, :, ax]
        qp = term if qp is None else qp + term
    return qp


def _true_topk_rows(pts, rows, ids, k):
    """Per row, whether its selected ids are a true top-k set of the f32
    points in f64 (self excluded, ties allowed)."""
    p = torch.tensor(pts, dtype=torch.float64)
    d2 = ((p[rows][:, None, :] - p[None]) ** 2).sum(-1)
    d2[torch.arange(len(rows)), torch.as_tensor(rows)] = float("inf")
    kth = torch.topk(d2, k, dim=1, largest=False).values[:, -1]
    sel = ids.long()
    ok = (sel >= 0).all(1)
    got = torch.gather(d2, 1, sel.clamp(min=0))
    return ok & (got <= kth[:, None]).all(1)


@pytest.mark.parametrize("order", ["reverse16", "pairwise", "truncate16"])
@pytest.mark.parametrize("kind", ["uniform", "mixed", "dominant"])
@pytest.mark.parametrize("d", [3, 128, 1024])
def test_band_covers_other_accumulation_orders(d, kind, order):
    k, n_q = 10, 40
    pts = _points(kind, 256 if d == 1024 else 384, d, seed=d + len(kind))
    q, qid, p, cid = _selection(pts, n_q)
    qb, qns, qnf, _ = pkernel.prep_plain(q)
    pb, pns, _, pn_max = pkernel.prep_plain(p, cid)
    qb, pb = qb[:, :d].float(), pb[:, :d].float()
    qp_plain, qp_tc = _qp_in_order(qb, pb), _qp_other_order(qb, pb, order)
    f32_term = 4.0 * (d + 8) * EPS32 * (qnf + pn_max)
    delta = (qp_tc - qp_plain).abs().amax(1)
    assert bool((2 * delta <= f32_term).all())
    s_plain = (qns[:, None] + pns[None, :]) - 2.0 * qp_plain
    s_tc = (qns[:, None] + pns[None, :]) - 2.0 * qp_tc
    assert torch.equal(s_plain, pscorer.score_tile(q, p, "bf16"))
    band = pscorer.score_band(s_tc, s_plain, cid)
    err_b = ptopk.dot_error_bound(qnf, pn_max, d, "bf16")
    assert bool((band <= err_b).all())
    drop = (cid[None, :] < 0) | (cid[None, :] == qid[:, None])
    s_tc = torch.where(drop, float("inf"), s_tc)
    for m in (3, k):
        ids, sel, cert = pscorer.block_fold(s_tc, cid.expand(s_tc.shape), k,
                                            m, err_b)
        _, want, _ = pscorer.select_plain(q, qid, p, cid, k, m, d, True,
                                          "bf16")
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(sel), fin)
        diff = torch.where(fin, (sel - want).abs(), 0.0)
        assert bool((diff <= band[:, None]).all())
        rows = torch.nonzero(cert).flatten().numpy()
        if rows.size:
            assert bool(_true_topk_rows(pts, rows, ids[rows], k).all())


def test_band_is_tight_enough_to_matter():
    # the emulated orders really move scores (so (c) tests something), and
    # only by a small fraction of the f32 term
    pts = _points("mixed", 384, 128, seed=7)
    q, _, p, cid = _selection(pts, 40)
    qb, _, qnf, _ = pkernel.prep_plain(q)
    pb, _, _, pn_max = pkernel.prep_plain(p, cid)
    qb, pb = qb[:, :128].float(), pb[:, :128].float()
    f32_term = 4.0 * 136 * EPS32 * (qnf + pn_max)
    for order in ("reverse16", "pairwise", "truncate16"):
        delta = (_qp_other_order(qb, pb, order)
                 - _qp_in_order(qb, pb)).abs().amax(1)
        assert bool((delta > 0).any())
        assert float((2 * delta / f32_term).max()) < 0.25


# -- (d) against the JAX package ---------------------------------------------

def _separated(d: int, seed: int) -> np.ndarray:
    """10-point blobs of radius ~1e-3 at +-e_i: a 9-NN row's gap to the
    next blob (~2) clears the bf16 band, so rows certify."""
    rng = np.random.default_rng(seed)
    centers = np.concatenate([np.eye(d), -np.eye(d)])
    return (np.repeat(centers, 10, axis=0)
            + rng.normal(size=(20 * d, d)) * 1e-3).astype(np.float32)


@pytest.mark.parametrize("d,k,m", [(5, 9, 9), (24, 9, 9), (24, 9, 3),
                                   (40, 9, 9)])
def test_certified_rows_agree_with_jax(d, k, m):
    pts = _separated(d, seed=d)
    n = pts.shape[0]
    q, qid, p, cid = _selection(pts, n)
    pi, _, pcert = pscorer.select_plain(q, qid, p, cid, k, m, d, True, "bf16")
    # the fold over tensor-core-ordered scores
    qb, qns, qnf, _ = pkernel.prep_plain(q)
    pb, pns, _, pn_max = pkernel.prep_plain(p, cid)
    qp = _qp_other_order(qb[:, :d].float(), pb[:, :d].float(), "truncate16")
    s_tc = (qns[:, None] + pns[None, :]) - 2.0 * qp
    drop = (cid[None, :] < 0) | (cid[None, :] == qid[:, None])
    s_tc = torch.where(drop, float("inf"), s_tc)
    ti, _, tcert = pscorer.block_fold(
        s_tc, cid.expand(s_tc.shape), k, m,
        ptopk.dot_error_bound(qnf, pn_max, d, "bf16"))
    qpad = np.zeros((p.shape[0], d), np.float32)
    qpad[:n] = pts
    jq = np.full((p.shape[0],), -1, np.int32)
    jq[:n] = np.arange(n)
    ji, _, jcert = solve_blocks_xla(
        jnp.asarray(p.numpy()), jnp.asarray(cid.numpy()), jnp.asarray(qpad),
        jnp.asarray(jq), k, m, True, 128, None, "bf16")
    ji, jcert = np.asarray(ji)[:n], np.asarray(jcert)[:n]
    for ids, cert in ((pi.numpy(), pcert.numpy()), (ti.numpy(),
                                                     tcert.numpy())):
        both = cert & jcert
        assert both.mean() >= (0.9 if m == k else 0.0)
        for r in np.nonzero(both)[0]:
            assert set(ids[r]) == set(ji[r]), r
    assert jtopk.dot_error_bound(1.0, 0.0, d, "bf16") == \
        ptopk.dot_error_bound(1.0, 0.0, d, "bf16")
