"""Lint fixture: host-sync-loop must fire in the host loop (never run)."""
import numpy as np
import torch

from cuda_knearests_tpu_torch.runtime import dispatch


def drain(chunks, out, arrays):
    for i, c in enumerate(chunks):
        out[i] = c.max().item()  # line 10: .item() per iteration
        host = c.cpu().numpy()  # line 11: readback chain per iteration
        rows = c.to("cpu").tolist()  # line 12: readback chain per iteration
        torch.cuda.synchronize()  # line 13: device wait per iteration
        (got,) = dispatch.fetch(c)  # line 14: counted round trip per iteration
        dev = np.asarray(c)  # line 15: implicit readback of a tensor
    for a in arrays:
        b = a.tolist()  # numpy may be numpy: silent
        d = a.numpy()  # numpy may be numpy: silent
        e = np.asarray([1, 2])  # a literal: silent
    return out, host, rows, got, dev, b, d, e
