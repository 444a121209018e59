"""Phase 10j of ``chip_smoke.py`` alone: the static gate on the card.

Builds the kernels, prepares the 900k/k=10 blue-noise problem of the
smoke's main path and runs ``chip_smoke.analysis_phase`` on it: (a) the
gate's CLI in a process of its own, beside (b) the sync proof against the
counters, (c) the certificates against the card's launch records and (d)
the byte models against the allocator.  Then it prints every (d) row,
largest growth first, as ``ROW route cell epilogue model growth requested
ratio``.  Needs one CUDA card::

    python scripts/torch_gate_card.py
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_gate_card: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.io import generate_blue_noise
    from cuda_knearests_tpu_torch.ops import _build

    card = smoke.card_line()
    print(card, flush=True)
    _build.load_all(_build.KERNELS)
    prob10, _ = smoke.prepared(generate_blue_noise(900_000, seed=900),
                               pt.KnnConfig(k=10))
    prob10.solve()
    out = smoke.analysis_phase(card, prob10)
    for r in sorted(out["memory"]["rows"], key=lambda r: -r["ratio"]):
        print("ROW", r["route"], r["cell"], r["ep"], r["model"], r["growth"],
              r["requested"], round(r["ratio"], 4), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
