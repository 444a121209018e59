"""The plain reference against a float64 brute force, and the comparison
that decides ``correct``."""

import numpy as np
import pytest
import torch

from knnbench import compare, generate, reference


def _cloud(n, seed=11):
    return torch.as_tensor(generate.make_cloud(
        {"cloud": {"recipe": "uniform"}}, n, seed, 1000.0))


def _brute64(pts, q, k):
    p = pts.double()
    d = ((p[q][:, None, :] - p[None, :, :]) ** 2).sum(-1)
    d[torch.arange(len(q)), q] = float("inf")
    d = torch.sort(d, dim=1).values[:, :k]
    pad = torch.full((len(q), k - d.shape[1]), float("inf"), dtype=d.dtype)
    return torch.cat([d, pad], dim=1)


@pytest.mark.parametrize("n,k", [(2000, 10), (3000, 50), (40, 60)])
def test_matches_float64_brute_force(n, k):
    pts = _cloud(n)
    q = torch.arange(0, n, 7)
    d2, ids = reference.knn_rows(pts, q, k)
    want = _brute64(pts, q, k)
    finite = torch.isfinite(want)
    assert torch.equal(finite, torch.isfinite(d2))
    assert torch.allclose(d2[finite].double(), want[finite], rtol=2e-6,
                          atol=1e-9)
    # the ids' own float64 distances are the exact top k, tie-aware
    p = pts.double()
    got = ((p[q][:, None, :] - p[torch.where(ids >= 0, ids, 0)]) ** 2).sum(-1)
    got = torch.where(ids >= 0, got, torch.full_like(got, float("inf")))
    got = torch.sort(got, dim=1).values
    assert torch.allclose(got[finite], want[finite], rtol=2e-6, atol=1e-9)
    assert not (ids == q[:, None]).any()


def test_pair_d2_and_blocks_agree_bit_for_bit():
    pts = _cloud(2500, seed=4)
    q = torch.arange(0, 2500, 3)
    d2, ids = reference.knn_rows(pts, q, 12)
    d2_small, _ = reference.knn_rows(pts, q, 12, pair_block=5000)
    assert torch.equal(d2, d2_small)
    assert torch.equal(reference.pair_d2(pts, q, ids), d2)


def test_duplicate_coordinates_are_neighbours_the_point_is_not():
    pts = _cloud(500, seed=5)
    pts[7] = pts[3]
    d2, ids = reference.knn_rows(pts, torch.tensor([3]), 4)
    assert ids[0, 0].item() == 7 and d2[0, 0].item() == 0.0


def test_bfloat16_differs():
    pts = _cloud(2000, seed=6)
    q = torch.arange(0, 2000, 9)
    d2, _ = reference.knn_rows(pts, q, 10)
    b2, _ = reference.knn_rows(pts, q, 10, dtype=torch.bfloat16)
    assert (d2 != b2).float().mean() > 0.5


def _exact_rows(n=1500, k=8, seed=2):
    pts = _cloud(n, seed)
    perm = np.random.default_rng(seed).permutation(n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    rows = np.arange(0, n, 5)
    d2, ids = reference.knn_rows(pts, torch.as_tensor(perm[rows]), k)
    sorted_ids = np.where(ids.numpy() >= 0, inv[ids.numpy().clip(0)], -1)
    return pts, perm, rows, sorted_ids, d2.numpy(), np.ones(len(rows), bool)


def test_judge_passes_exact_rows_and_counts_each_fault():
    pts, perm, rows, ids, d2, cert = _exact_rows()
    ok = compare.judge(pts, perm, rows, ids, d2, cert, 8)
    assert all(c["value"] == 0 for c in ok.values())
    assert compare.is_correct(ok, len(rows))
    assert not compare.is_correct(ok, 0)

    bad = ids.copy()
    bad[:, -1] = ids[:, 0]                  # a repeated neighbour
    res = compare.judge(pts, perm, rows, bad, d2, cert, 8)
    assert res["id_mismatch"]["value"] >= len(rows)

    far = d2.copy()
    far[::2, 3] *= 1.0000001                 # an ulp off
    assert compare.judge(pts, perm, rows, ids, far, cert,
                         8)["d2_mismatch"]["value"] > 0

    cert2 = cert.copy()
    cert2[5] = False
    assert compare.judge(pts, perm, rows, ids, d2, cert2,
                         8)["uncertified"]["value"] == 1

    perm2 = perm.copy()
    perm2[0] = perm2[1]
    assert compare.judge(pts, perm2, rows, ids, d2, cert,
                         8)["perm_violations"]["value"] == 1

    selfish = ids.copy()
    selfish[:, 0] = rows
    res = compare.judge(pts, perm, rows, selfish, d2, cert, 8)
    assert res["id_mismatch"]["value"] >= len(rows)
    lines = compare.lines(res, len(rows))
    assert lines[0].startswith("check rows_checked")
    assert any(line.startswith("check id_mismatch") and "limit 0" in line
               for line in lines)
