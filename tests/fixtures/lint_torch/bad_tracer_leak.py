"""Lint fixture: tracer-leak must fire inside the compiled bodies (never run)."""
import functools

import numpy as np
import torch


@torch.compile
def leaky(x):
    return np.sum(x)  # line 10: np.* on a graph tensor


@torch.compile(mode="reduce-overhead")
def leaky_item(x, k):
    return x.max().item() + k  # line 15: .item() forces a value out


@torch.jit.script
def leaky_cast(x):
    return float(torch.max(x))  # line 20: float() of a torch expression


@functools.partial(torch.compile, dynamic=False)
def leaky_cpu(x):
    return x.cpu().numpy()  # line 25: readback inside the graph


def host_side_is_fine(x):
    return np.sum(x.cpu().numpy()) + x.item()  # not compiled: silent
