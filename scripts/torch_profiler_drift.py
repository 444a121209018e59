#!/usr/bin/env python3
"""How many device events does torch.profiler keep as a process ages?

    python3 scripts/torch_profiler_drift.py [--captures 13] [--every 30]

On one CUDA device: prepares a 20,000-point blue-noise problem (k=10), then
captures one solve with ``obs.device.profile_window`` every ``--every``
seconds and prints, for each capture, the process age, the events by kind
(``exec`` = kernels, copies and memsets kept), the launch-to-start lag of
the joined events, or the ``CaptureError`` when the profiler kept fewer
device events than the window launched.  Beside them, the host clocks'
drift since the first capture (``time.time`` against ``time.monotonic``,
and ``monotonic`` against ``CLOCK_MONOTONIC_RAW``), so a loss can be told
from a host clock being slewed.  A complete capture keeps one device event
per kernel launch, copy and memset.
"""

import argparse
import collections
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--captures", type=int, default=13)
    ap.add_argument("--every", type=float, default=30.0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.io import generate_blue_noise
    from cuda_knearests_tpu_torch.obs import device as dv

    prob = pt.KnnProblem.prepare(generate_blue_noise(20_000, seed=3),
                                 pt.KnnConfig(k=10))
    prob.solve()
    t0 = time.monotonic()
    base = (time.time() - time.monotonic(),
            time.monotonic() - time.clock_gettime(time.CLOCK_MONOTONIC_RAW))
    for i in range(args.captures):
        try:
            rep = dv.profile_window(prob.solve)
            kinds = dict(collections.Counter(e.kind
                                             for e in rep.device_events))
            lag = rep.decomposition.get("launch_to_start_ms")
        except dv.CaptureError as e:
            kinds, lag = f"CaptureError: {e}", None
        realtime = (time.time() - time.monotonic() - base[0]) * 1e3
        raw = (time.monotonic() - time.clock_gettime(time.CLOCK_MONOTONIC_RAW)
               - base[1]) * 1e3
        print(f"age {time.monotonic() - t0:7.1f} s  {kinds}  launch to "
              f"start {lag} ms  realtime-monotonic {realtime:+.3f} ms  "
              f"monotonic-raw {raw:+.3f} ms", flush=True)
        if i + 1 < args.captures:
            time.sleep(args.every)
    return 0


if __name__ == "__main__":
    sys.exit(main())
