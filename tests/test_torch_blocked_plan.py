"""The blocked kernel's design premise and its launch plan, on the CPU.

``csrc/blocked_topk.cu`` selects each row's exact top-k T (the one-stage
kernel's selection) and writes it as the blocked row wherever no 128-slot
candidate block holds more than m of T's entries; only the other rows are
answered block by block.  Its header proves that premise; here it is
checked on the plain versions, over lattice coordinates (exact ties),
interleaved and crowded packs, both exclude_self values and several m.
The launch plan must take exactly the shapes of the routing gate
``pick_q_tile(k, qcap, m)``, so a class routed to the blocked kernel
always launches.
"""

import numpy as np
import pytest
import torch

import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.config import blocked_topm
from cuda_knearests_tpu_torch.io import generate_blue_noise
from cuda_knearests_tpu_torch.ops import cuda_solve as cs
from cuda_knearests_tpu_torch.utils.memory import LaunchBudgetError

K = 20


def _lattice_pack(rng, n_sc=6, qcap=40, ccap=1152):
    """A random pack on a coarse lattice (many exact distance ties): per
    supercell a random number of real candidates in random slots (some
    rows with fewer than k), queries a subset of them (so exclude_self
    bites), pads with garbage coordinates and sentinel ids."""
    lattice = lambda: rng.integers(0, 24, (n_sc, ccap)).astype(  # noqa: E731
        np.float32) * 7.5
    cx, cy, cz = lattice(), lattice(), lattice()
    cid = np.full((n_sc, ccap), cs._PAD_C, np.int32)
    q = [rng.random((n_sc, qcap)).astype(np.float32) * 1000 for _ in "xyz"]
    qid = np.full((n_sc, qcap), cs._PAD_Q, np.int32)
    for s in range(n_sc):
        nc = int(rng.integers(0, ccap + 1)) if s else 6
        slots = rng.permutation(ccap)[:nc]
        cid[s, slots] = rng.permutation(1 << 20)[:nc]
        nq = min(qcap, nc)
        pick = slots[:nq]
        for a, c in zip(q, (cx, cy, cz)):
            a[s, :nq] = c[s, pick]
        qid[s, :nq] = cid[s, pick]
    return [torch.as_tensor(a) for a in (*q, qid, cx, cy, cz, cid)]


def _reorder(args, key):
    """The pack with each supercell's candidates sorted by ``key``."""
    order = torch.sort(key, dim=1, stable=True).indices
    return list(args[:4]) + [torch.gather(a, 1, order).contiguous()
                             for a in args[4:]]


@pytest.fixture(scope="module")
def packs():
    """Lattice packs as made and crowded by x, and the port's own class
    pack of a 3,000-point blue-noise cloud, as packed (slots interleaved
    across blocks) and crowded in stored-id order (grid order, so spatial
    neighbours share a block)."""
    lattice = _lattice_pack(np.random.default_rng(8))
    prob = pt.KnnProblem.prepare(generate_blue_noise(3000, seed=8),
                                 pt.KnnConfig(k=K), device="cpu")
    cp = prob.aplan.classes[0]
    real = list(cp.pk.args())
    cid = real[7]
    return {
        "lattice": lattice,
        "lattice crowded": _reorder(lattice, lattice[4]),
        "interleaved": real,
        "crowded": _reorder(real, torch.where(cid >= 0, cid, 2**30)),
    }


def _block_counts(args, ids):
    """Per query slot, the most entries of its row ``ids`` ((S, k, Q)
    stored ids, -1 where missing) that one 128-slot block holds."""
    cid = args[7]
    s_total, k, qcap = ids.shape
    flat = ids.transpose(1, 2).reshape(s_total, -1)
    srt, order = torch.sort(cid, dim=1)
    pos = torch.searchsorted(srt, flat).clamp(max=cid.shape[1] - 1)
    slot = order.gather(1, pos)
    real = flat >= 0
    assert torch.equal(cid.gather(1, slot)[real], flat[real])
    counts = torch.zeros((s_total, qcap * k, cid.shape[1] // 128),
                         dtype=torch.int64)
    counts.scatter_(2, (slot // 128)[..., None], real[..., None].long())
    return counts.reshape(s_total, qcap, k, -1).sum(2).amax(-1)


@pytest.mark.parametrize("m_of", ["blocked_topm", "1", "16", "128"])
@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("layout", ["lattice", "lattice crowded",
                                    "interleaved", "crowded"])
def test_rows_without_an_overflowing_block_are_the_exact_top_k(
        packs, layout, exclude_self, m_of):
    """Every row where no block holds more than m of the exact top-k T
    (``supercell_topk_plain``) is T exactly, with no NaN; every NaN row
    has a block holding more than m of T; at m >= k no block can."""
    args = packs[layout]
    ccap = args[4].shape[1]
    m = blocked_topm(K, ccap) if m_of == "blocked_topm" else int(m_of)
    assert m > 0
    td, ti = cs.supercell_topk_plain(*args, K, exclude_self)
    bd, bi = cs.blocked_topk_plain(*args, K, m, exclude_self)
    over = _block_counts(args, ti) > m                      # (S, Q)
    nan = torch.isnan(bd).any(1)
    clean = ~over
    assert torch.equal(bd.transpose(1, 2)[clean], td.transpose(1, 2)[clean])
    assert torch.equal(bi.transpose(1, 2)[clean], ti.transpose(1, 2)[clean])
    assert not bool((nan & clean).any())
    assert not bool(torch.isnan(bd[:, :K - 1]).any())  # NaN only at k-1
    if m >= K:
        assert not bool(over.any())
    elif m == 1 or (layout.endswith("crowded") and m_of == "blocked_topm"):
        assert bool(over.any())  # the per-block path has rows to answer


def test_launch_plan_accepts_exactly_the_routing_gate():
    """The blocked kernel's plan takes exactly the (k, qcap, m) that
    ``pick_q_tile`` -- the routing gate -- takes, k + m <= 892 at every
    qcap (its arithmetic turns over only at warp multiples of qcap, so
    qcap runs over its edges in 1-512), so a class routed to the blocked
    kernel always launches and a refused one always streams."""
    for m in (1, 6, 16):
        for qcap in (1, 31, 32, 33, 45, 104, 480, 511, 512):
            for k in range(1, 1001):
                for gate in (lambda: cs.pick_q_tile(k, qcap, m),
                             lambda: cs.topk_plan(k, qcap, 1152, m)):
                    if k + m <= 892:
                        gate()
                    else:
                        with pytest.raises(LaunchBudgetError, match="m="):
                            gate()


@pytest.mark.parametrize("k", [1, 10, 31, 32, 33, 50, 64, 65, 128, 500, 876])
def test_launch_plan_geometry(k):
    """The blocked plan shares the one-stage plan's warps, list width and
    query chunk; its staged tile (18 bytes a candidate: the row and a u16
    slot) is a warp multiple, the whole ccap while it fits, small enough
    for four blocks on a 228 KB SM, and for five at the 900k/k=10 and
    300k/k=50 class shapes (ccap 1,152 and 2,304)."""
    for m in (1, 6, 16, 128):
        if k + m > 892:
            continue
        for qcap in (1, 8, 45, 104, 14392):
            for ccap in (128, 1152, 2304, 2944, 3072, 24704):
                plan = cs.topk_plan(k, qcap, ccap, m)
                one = cs.topk_plan(k, qcap, ccap)
                assert (plan.warps, plan.lane_entries, plan.qchunk) == (
                    one.warps, one.lane_entries, one.qchunk)
                assert plan.tile % 32 == 0
                assert 32 <= plan.tile <= cs._BLOCKED_TILE
                assert plan.tile >= min(ccap, cs._BLOCKED_TILE)
                blocks = 5 if ccap <= 2304 else 4
                assert blocks * (cs.topk_smem_bytes(plan, blocked=True)
                                 + cs._TOPK_STATIC_SMEM + 1024) \
                    <= 228 * 1024
