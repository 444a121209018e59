"""Lint fixture: every torch-aimed hazard below carries its waiver -- zero
findings."""
import numpy as np
import torch


@torch.compile
def audited_graph(x):
    return x.max().item()  # kntpu-ok: tracer-leak -- fixture: a deliberate graph break


def audited(chunks, out, tables, device):
    acc = np.asarray(out, np.float64)  # kntpu-ok: wide-dtype -- fixture: intentional host precision
    for i, c in enumerate(chunks):
        out[i] = c.max().item()  # kntpu-ok: host-sync-loop -- fixture: bounded readback
        torch.cuda.synchronize()  # kntpu-ok: host-sync-loop -- fixture: bounded fence
    staged = []
    for t in tables:
        staged.append(torch.as_tensor(t, device=device))  # kntpu-ok: jnp-in-loop -- fixture: bounded prepare staging
    return acc, staged
