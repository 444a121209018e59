"""Lint fixture: jnp-in-loop must fire in the host loop (never run)."""
import torch


def rebuild(tables, device):
    staged = []
    for t in tables:
        staged.append(torch.as_tensor(t, device=device))  # line 8: upload per iteration
        z = torch.zeros((4,), device=device)  # line 9: device alloc per iteration
        f = torch.full_like(z, 1.0, device=device)  # line 10
        h = torch.zeros((4,))  # no device=: a host tensor, silent
        staged += [z, f, h]
    return staged
