"""One process of a multi-process sharded solve: join the group, prepare a
generated cloud over the process-major mesh, solve this process's slabs and
write each slab's rows to ``<out>/rank<r>_slab<d>.npz`` (``sids``, ``nbr``,
``d2``, ``cert`` of its real rows).

    python -m cuda_knearests_tpu_torch.parallel --rank R --world W \\
        --address localhost:PORT --out DIR [--n 20000 --seed 77 --k 8] \\
        [--slabs 2] [--device cpu] [--backend gloo]

Every process generates the same cloud (``io.generate_uniform``).  The
single-controller surfaces (``solve``, ``permutation``, ``query``) must
refuse on such a mesh; the process checks that they do.  The last line is
``WORKER_OK <rank> slabs=[...] backend=<backend>``; any failure exits
non-zero.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--address", required=True, help="host:port")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--slabs", type=int, default=1,
                    help="slabs of this process, all on --device")
    ap.add_argument("--device", default=None,
                    help="device of this process's slabs (default: "
                         "distributed.z_mesh's)")
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--epilogue", default="auto")
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)

    from ..config import KnnConfig
    from ..io import generate_uniform
    from ..ops import cuda_solve
    from . import distributed
    from .sharded import ShardedKnnProblem

    t0 = time.perf_counter()
    distributed.init_distributed(args.address, args.world, args.rank,
                                 backend=args.backend,
                                 timeout_s=args.timeout)
    try:
        devices = (None if args.device is None
                   else [torch.device(args.device)] * args.slabs)
        mesh = distributed.z_mesh(devices)
        points = generate_uniform(args.n, seed=args.seed)
        sp = ShardedKnnProblem.prepare(
            points, config=KnnConfig(k=args.k, epilogue=args.epilogue),
            mesh=mesh)
        slabs = sp.local_chips()
        for name, call in (("solve", sp.solve),
                           ("permutation", sp.permutation),
                           ("query", lambda: sp.query(points[:4]))):
            try:
                call()
            except RuntimeError as e:
                if "multi-host" not in str(e):
                    raise
            else:
                raise AssertionError(f"{name}() must refuse on a "
                                     f"multi-process mesh")
        launches = cuda_solve.launches + cuda_solve.blocked_launches
        outs = sp.solve_device()
        launches = (cuda_solve.launches + cuda_solve.blocked_launches
                    - launches)
        os.makedirs(args.out, exist_ok=True)
        for d in slabs:
            sids = sp._chip_inputs(d)["sids"].cpu().numpy()  # kntpu-ok: host-sync-loop -- the smoke's per-slab row dump after solve_device: one bounded readback per slab, outside every solve window
            real = sids >= 0
            rows = {"sids": sids[real]}
            if outs[d] is not None:
                nbr, d2, cert = (t.cpu().numpy() for t in outs[d])  # kntpu-ok: host-sync-loop -- the smoke's per-slab row dump after solve_device: one bounded readback per slab, outside every solve window
                rows.update(nbr=nbr[real], d2=d2[real], cert=cert[real])
            np.savez(os.path.join(args.out,
                                  f"rank{args.rank}_slab{d}.npz"), **rows)
        backend = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
    print(f"rank {args.rank}: prepare and solve in "
          f"{time.perf_counter() - t0:.3f} s, class-kernel launches "
          f"{launches}, prepare split {sp.prepare_seconds}", flush=True)
    print(f"WORKER_OK {args.rank} slabs={slabs} backend={backend}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
