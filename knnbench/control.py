"""The control of the comparison: the reference in the program's place,
computed one precision below the configuration's float32 (bfloat16), and
judged by ``compare.judge`` as a run judges the program.  It has to come
out not correct; its readings are the upper ends of the limits in
``PERF.md``.  The benchmark's own runs never run it.

    python3 -m knnbench.control --workload <cell> --seeds 1 2 3

draws each seed's cloud and the rows a run would keep (the mix's
``check_rows_max``), judges them on the card, and prints one JSON line a
seed.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from . import compare, generate, reference
from . import spec as _spec


def control_checks(cell: _spec.Cell, seed: int, rows: Optional[int] = None,
                   device: str = "cuda", n_points: Optional[int] = None,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """The checks of one seed with the ``dtype`` reference standing in for
    the program (identity permutation, every row certified)."""
    cfg, traffic = cell.config, cell.traffic
    n = int(n_points or cfg["n_points"])
    k = int(cfg["k"])
    rows = int(rows or traffic["check_rows_max"])
    pts = generate.make_cloud(traffic, n, seed, cfg["domain"])
    sampler = generate.RowSampler(seed, n, traffic["check_rows_per_solve"])
    solves = -(-rows // sampler.per_solve)
    q = np.concatenate([sampler.next() for _ in range(solves)])[:rows]
    points = torch.as_tensor(pts, device=device)
    d2, ids = reference.knn_rows(points, torch.as_tensor(q, device=device),
                                 k, dtype=dtype)
    checks = compare.judge(points, np.arange(n), q, ids.cpu().numpy(),
                           d2.cpu().numpy(), np.ones(len(q), bool), k)
    return {"correct": compare.is_correct(checks, len(q)),
            "rows_checked": len(q), "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m knnbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = _spec.cell(_spec.load_benchmark(), args.workload)
    kind = torch.cuda.get_device_name(0)
    for seed in args.seeds:
        t = time.perf_counter()
        out = control_checks(cell, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": kind,
                          "seconds": time.perf_counter() - t, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
