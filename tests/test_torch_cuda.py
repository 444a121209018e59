"""The PyTorch port on an NVIDIA GPU: the CUDA kernel against its plain
version bit for bit, and the GPU solve against the CPU solve.

Marked ``cuda``: without a GPU each test skips.  This file imports only the
port, so on a GPU host without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

The kernel and the plain version round every multiply and add on its own
(the kernel is built with ``--fmad=false``), so d2 and ids must be equal,
not close.  The CPU solve runs the plain version with the same arithmetic,
so the GPU and CPU results must be equal too.
"""

import numpy as np
import pytest
import torch

import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.io import generate_blue_noise, generate_clustered
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
