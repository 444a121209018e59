"""The PyTorch port on an NVIDIA GPU: each CUDA kernel against its plain
version bit for bit, and GPU solves against CPU solves.

Marked ``cuda``: without a GPU each test skips.  This file imports only the
port, so on a GPU host without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

The kernels and the plain versions round every multiply and add on its
own (the kernels are built with ``--fmad=false``), so d2, scores, ids and
certificates must be equal, not close (NaN deficit flags in the same
places).  The CPU solves run the plain versions with the same arithmetic,
so GPU and CPU results must be equal too.
"""

import numpy as np
import pytest
import torch

import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.io import generate_blue_noise, generate_clustered
from cuda_knearests_tpu_torch import mxu
from cuda_knearests_tpu_torch.mxu import kernel as mk
from cuda_knearests_tpu_torch.mxu import scorer as ms
from cuda_knearests_tpu_torch.mxu.topk import interleave_slots
from cuda_knearests_tpu_torch.ops import cuda_solve as cs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel is built for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 50, 128])
def test_kernel_matches_plain_bit_for_bit(cuda_device, k):
    pts = generate_blue_noise(20_000, seed=12)
    prob = pt.KnnProblem.prepare(pts, pt.KnnConfig(k=min(k, 50)),
                                 device=cuda_device)
    cp = prob.aplan.classes[0]
    args = cp.pk.args()
    for excl in (True, False):
        before = cs.launches
        kd, ki = cs.supercell_topk(*args, k, excl)
        assert cs.launches == before + 1
        pd, pi = cs.supercell_topk_plain(*args, k, excl)
        n = prob.grid.n_points
        rows = [(torch.full((n, k), float("inf"), device=cuda_device),
                 torch.full((n, k), -1, dtype=torch.int32,
                            device=cuda_device)) for _ in range(2)]
        cs.supercell_topk(*args, k, excl, tgt=cp.tgt, out=rows[0])
        cs.supercell_topk_plain(*args, k, excl, tgt=cp.tgt, out=rows[1])
        torch.cuda.synchronize()
        assert torch.equal(ki, pi) and torch.equal(kd, pd)
        assert torch.equal(rows[0][0], rows[1][0])
        assert torch.equal(rows[0][1], rows[1][1])


@pytest.mark.cuda
def test_gpu_solve_equals_cpu_solve(cuda_device):
    pts = generate_clustered(20_000, seed=3)
    cfg = pt.KnnConfig(k=10, ring_radius=1)
    gpu = pt.KnnProblem.prepare(pts, cfg, device=cuda_device)
    cpu = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    cs.launches = 0
    g, c = gpu.solve(), cpu.solve()
    assert cs.launches == len(gpu.aplan.classes)
    assert int(g.uncert_count) == int(c.uncert_count) > 0
    np.testing.assert_array_equal(g.neighbors, c.neighbors)
    np.testing.assert_array_equal(g.dists_sq, c.dists_sq)
    np.testing.assert_array_equal(gpu.get_knearests_original(),
                                  cpu.get_knearests_original())


def _equal_nan(a, b) -> bool:
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d", [1, 3, 17, 128])
def test_select_kernel_matches_plain_bit_for_bit(cuda_device, d, precision):
    rng = np.random.default_rng(d)
    for n, lattice in ((1000, True), (1000, False), (40, False)):
        pts = (rng.integers(0, 6, (n, d)) * 2.5 if lattice
               else rng.random((n, d)) * 100).astype(np.float32)
        c_pad = -(-n // 128) * 128
        il = interleave_slots(c_pad)
        pp = np.zeros((c_pad, d), np.float32)
        pp[:n] = pts
        cid = np.where(il < n, il, -1).astype(np.int32)
        dev = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                        device=cuda_device)
        q, qid = dev(pts[:300]), dev(np.arange(min(300, n), dtype=np.int32))
        args = (q, qid, dev(pp[il]), dev(cid))
        for k in (1, 10, 50, 128):
            for m in sorted({1, 3, min(k, 128)}):
                for excl in (True, False):
                    before = mk.launches
                    got = mk.select(*args, k, m, d, excl, precision)
                    assert mk.launches == before + 1
                    want = ms.select_plain(*args, k, m, d, excl, precision)
                    torch.cuda.synchronize()
                    for g, w in zip(got, want):
                        assert torch.equal(g, w), (n, lattice, k, m, excl)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_gpu_solve_general_equals_cpu(cuda_device, precision):
    rng = np.random.default_rng(5)
    pts = (rng.random((3000, 24)) * 10).astype(np.float32)
    for rt, refine in ((1.0, "brute"), (0.6, "none")):
        mk.launches = 0
        g = mxu.solve_general(pts, k=10, recall_target=rt, refine=refine,
                              precision=precision, device=cuda_device)
        assert mk.launches == 1 and g.backend == "cuda"
        c = mxu.solve_general(pts, k=10, recall_target=rt, refine=refine,
                              precision=precision, device="cpu")
        np.testing.assert_array_equal(g.neighbors, c.neighbors)
        np.testing.assert_array_equal(g.dists_sq, c.dists_sq)
        np.testing.assert_array_equal(g.certified, c.certified)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 30])
def test_blocked_kernel_matches_plain_bit_for_bit(cuda_device, k):
    pts = generate_blue_noise(20_000, seed=12)
    prob = pt.KnnProblem.prepare(pts, pt.KnnConfig(k=k), device=cuda_device)
    cp = prob.aplan.classes[0]
    m = pt.config.blocked_topm(k, cp.ccap)
    assert m
    args = list(cp.pk.args())
    # the pack as packed, and with candidates in storage order (no
    # interleave), which crowds neighbours into blocks: deficit rows
    order = torch.sort(torch.where(args[7] >= 0, args[7], 2**30),
                       dim=1).indices
    crowded = args[:4] + [torch.gather(a, 1, order) for a in args[4:]]
    n = prob.grid.n_points
    for pack in (args, crowded):
        for excl in (True, False):
            before = cs.blocked_launches
            kd, ki = cs.blocked_topk(*pack, k, m, excl)
            assert cs.blocked_launches == before + 1
            pd, pi = cs.blocked_topk_plain(*pack, k, m, excl)
            rows = [(torch.full((n, k), float("inf"), device=cuda_device),
                     torch.full((n, k), -1, dtype=torch.int32,
                                device=cuda_device)) for _ in range(2)]
            cs.blocked_topk(*pack, k, m, excl, tgt=cp.tgt, out=rows[0])
            cs.blocked_topk_plain(*pack, k, m, excl, tgt=cp.tgt,
                                  out=rows[1])
            torch.cuda.synchronize()
            assert torch.equal(ki, pi) and _equal_nan(kd, pd)
            assert torch.equal(rows[0][1], rows[1][1])
            assert _equal_nan(rows[0][0], rows[1][0])
    assert bool(torch.isnan(kd).any())  # the crowded pack has deficits


@pytest.mark.cuda
def test_gpu_blocked_solve_equals_cpu_solve(cuda_device):
    pts = generate_blue_noise(20_000, seed=3)
    cfg = pt.KnnConfig(k=30, kernel="blocked")
    gpu = pt.KnnProblem.prepare(pts, cfg, device=cuda_device)
    cpu = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    cs.blocked_launches = 0
    g, c = gpu.solve(), cpu.solve()
    assert cs.blocked_launches == len(gpu.aplan.classes)
    assert int(g.uncert_count) == int(c.uncert_count)
    np.testing.assert_array_equal(g.neighbors, c.neighbors)
    np.testing.assert_array_equal(g.dists_sq, c.dists_sq)
