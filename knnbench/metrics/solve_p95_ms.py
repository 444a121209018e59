"""95th percentile of every window solve's latency, call to rows on the
host (host clock)."""

import numpy as np


def read(ctx):
    if not ctx.latencies_s:
        return None
    return float(np.percentile(np.asarray(ctx.latencies_s) * 1e3, 95))
