"""``python -m cuda_knearests_tpu_torch.cluster [--device cpu]``: the
clustering smoke, on the GPU unless ``--device cpu`` is given.

1. **FoF against the union-find oracle**: labels of a 2,500-point uniform
   cloud at three linking lengths (sparse, percolating, dense) must pass
   the tie-aware partition check (``cluster/compare.py``), in
   ``rounds + 1`` host round trips.
2. **The plane feed**: the planes of a solve (``plane_feed=True``) and of
   ``query(planes=True)`` must equal an independent float64 recompute from
   the returned ids bit for bit, each call in at most two round trips.

Prints one JSON line per check; exits 0 when all pass, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _ref_planes(sites: np.ndarray, points: np.ndarray,
                ids: np.ndarray) -> np.ndarray:
    """The plane feed recomputed in float64 from the returned ids."""
    q = sites.astype(np.float64)[:, None, :]  # kntpu-ok: wide-dtype -- the independent f64 recompute the pin compares against, host-only
    p = points[np.clip(ids, 0, None)].astype(np.float64)  # kntpu-ok: wide-dtype -- the independent f64 recompute the pin compares against, host-only
    nn = (p - q).astype(np.float32)
    d = (((p * p).sum(-1) - (q * q).sum(-1)) / 2.0).astype(np.float32)
    ok = ids >= 0
    return np.concatenate(
        [np.where(ok[..., None], nn, np.float32(0.0)),
         np.where(ok, d, np.float32(np.inf))[..., None]], axis=-1)


def smoke(device=None, n: int = 2500) -> int:
    from .. import KnnConfig, KnnProblem
    from ..config import DOMAIN_SIZE
    from ..io import generate_uniform
    from ..runtime import dispatch
    from .compare import check_fof_result
    from .fof import fof_labels

    rc = 0
    points = generate_uniform(n, seed=11)
    spacing = DOMAIN_SIZE / float(n) ** (1.0 / 3.0)
    for regime, scale in (("sparse", 0.4), ("percolating", 1.0),
                          ("dense", 2.2)):
        res = fof_labels(points, scale * spacing, device=device)
        bad = check_fof_result(points, res.linking_length, res.labels,
                               res.sizes)
        ok = bad is None and res.host_syncs == res.rounds + 1
        rc |= 0 if ok else 1
        print(json.dumps({
            "check": f"fof-vs-oracle[{regime}]", "ok": ok, "n": n,
            "b": round(res.linking_length, 3), "clusters": res.n_clusters,
            "rounds": res.rounds, "host_syncs": res.host_syncs,
            **({} if bad is None else {"mismatch": bad.render()})}),
            flush=True)

    k = 8
    problem = KnnProblem.prepare(points, KnnConfig(k=k, plane_feed=True),
                                 device=device)
    dispatch.reset_stats()
    res = problem.solve()
    solve_syncs = dispatch.stats().host_syncs
    queries = generate_uniform(256, seed=12)
    dispatch.reset_stats()
    ids_q, _d2, planes_q = problem.query(queries, planes=True)
    query_syncs = dispatch.stats().host_syncs
    ids = problem.get_knearests_original()
    solve_ok = (np.array_equal(res.planes, _ref_planes(points, points, ids))
                and problem.get_planes() is res.planes)
    query_ok = np.array_equal(planes_q, _ref_planes(queries, points, ids_q))
    ok = (solve_ok and query_ok
          and max(solve_syncs, query_syncs) <= dispatch.SYNC_BUDGET)
    rc |= 0 if ok else 1
    print(json.dumps({"check": "plane-feed-bit-identity", "ok": ok,
                      "solve_ok": bool(solve_ok), "query_ok": bool(query_ok),
                      "solve_syncs": solve_syncs,
                      "query_syncs": query_syncs}), flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cuda_knearests_tpu_torch."
                                      "cluster", description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return smoke(ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
