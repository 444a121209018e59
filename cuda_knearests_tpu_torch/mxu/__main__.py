"""``python -m cuda_knearests_tpu_torch.mxu [--device cpu]``: the brute
route's smoke, on the GPU unless ``--device cpu`` is given.  Counterpart
of ``python -m cuda_knearests_tpu.mxu``, the same three checks:

1. **exactness pin**: ``solve_general(recall_target=1.0, scorer='mxu')``
   equals the exact elementwise selection (``scorer='elementwise'``) in
   ids and distances on the reference's 20k fixture, its first
   ``KNTPU_MXU_SMOKE_N`` points (default: all);
2. **recall bound**: a clustered cloud at ``recall_target=0.75``,
   unrefined: recall at the declared 2B band (``mxu/measure.py``) at
   least the fold's bound, and every certified row exact;
3. **general d**: a d=6 cloud at ``recall_target=1.0`` exact against a
   float64 brute force.

Prints one JSON line per check; exits 0 when all pass, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .measure import certified_recall, declared_band, measured_recall


def _row(name: str, ok: bool, **fields) -> bool:
    print(json.dumps({"check": name, "ok": bool(ok), **fields}), flush=True)
    return bool(ok)


def smoke(device=None) -> int:
    from ..io import generate_clustered, get_dataset
    from . import solve_general

    rc = 0
    n_pin = int(os.environ.get("KNTPU_MXU_SMOKE_N", "20626"))
    pts = get_dataset("pts20K.xyz")
    if n_pin < pts.shape[0]:
        pts = np.ascontiguousarray(pts[:n_pin])
    k = 10
    a = solve_general(pts, k=k, recall_target=1.0, scorer="mxu",
                      device=device)
    b = solve_general(pts, k=k, scorer="elementwise", device=device)
    ids_eq = bool(np.array_equal(a.neighbors, b.neighbors))
    d2_eq = bool(np.array_equal(a.dists_sq, b.dists_sq))
    if not _row("byte-identity", ids_eq and d2_eq, n=int(pts.shape[0]),
                k=k, ids_equal=ids_eq, dists_equal=d2_eq,
                uncert_count=int(a.uncert_count), backend=a.backend):
        rc = 1

    target = 0.75
    cl = generate_clustered(6000, seed=17)
    res = solve_general(cl, k=k, recall_target=target, refine="none",
                        device=device)
    rec = measured_recall(cl, res.neighbors, k, band=declared_band(cl))
    cert_rows = np.nonzero(res.certified)[0]
    cert_ok = (not cert_rows.size
               or certified_recall(cl, res.neighbors, cert_rows, k) >= 1.0)
    if not _row("recall-bound", rec >= res.bound and cert_ok,
                recall_target=target, bound=round(res.bound, 6),
                measured=round(rec, 6), m=res.m, n_blocks=res.n_blocks,
                certified_fraction=round(float(res.certified.mean()), 4),
                certified_rows_exact=bool(cert_ok), backend=res.backend):
        rc = 1

    rng = np.random.default_rng(23)
    d6 = (rng.random((2048, 6)) * 100.0).astype(np.float32)
    r6 = solve_general(d6, k=8, recall_target=1.0, device=device)
    rec6 = measured_recall(d6, r6.neighbors, 8)
    if not _row("general-d", rec6 >= 1.0, d=6, n=2048, k=8,
                measured=round(rec6, 6),
                certified=bool(r6.certified.all()), backend=r6.backend):
        rc = 1
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cuda_knearests_tpu_torch.mxu",
                                 description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return smoke(ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
