"""Multi-process bring-up and the collectives of the sharded path.

Counterpart of ``cuda_knearests_tpu/parallel/distributed.py``.  The
reference rides XLA's fabric (``shard_map`` collectives); here the
processes join a ``torch.distributed`` group and the sharded path calls
three things across it: the halo exchange at a process seam
(:func:`exchange_seams`, point-to-point), the per-slab cell counts every
process plans from (:func:`allgather_counts`), and the process-major check
of the mesh (:func:`check_process_major`).  One process needs none of
this: ``ShardedKnnProblem.prepare`` builds its own slab list.  For several:

    from cuda_knearests_tpu_torch.parallel import init_distributed, z_mesh
    init_distributed("host:port", num_processes, process_id)  # each process
    sp = ShardedKnnProblem.prepare(points, mesh=z_mesh())

NCCL is the default backend (one process per card, blocks sent card to
card); 'gloo' runs on the CPU and stages blocks of CUDA slabs through host
memory (several processes on one card, where NCCL refuses two ranks).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.memory import NoDeviceError

# Seconds a collective or the rendezvous may wait before it fails.
DEFAULT_TIMEOUT_S = 300.0
# Tags of the two directions of a seam's exchange.
_TAG_UP, _TAG_DOWN = 1, 2


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the multi-process group (``torch.distributed``), idempotently.

    ``coordinator_address`` is ``host:port`` of the rendezvous (process 0
    listens there).  With no arguments the cluster environment decides
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``, as
    ``torchrun`` sets them); without one it is a single-process no-op.  A
    second call is a no-op.  An explicit spec that fails raises.
    ``backend`` defaults to 'nccl'; pass 'gloo' for CPU processes or
    several processes on one card."""
    if dist.is_available() and dist.is_initialized():
        return
    backend = backend or "nccl"
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        env = os.environ
        if int(env.get("WORLD_SIZE", "1")) <= 1 or "RANK" not in env \
                or "MASTER_ADDR" not in env:
            return  # no cluster environment: a single-process run
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(  # kntpu-ok: bare-valueerror -- process-group setup contract, not point-input validation
            "init_distributed: give coordinator_address, num_processes and "
            "process_id together (or none of them)")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)


def world_size() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def _staged() -> bool:
    """Whether the backend moves host tensors (gloo): CUDA blocks are then
    staged through host memory."""
    return dist.get_backend() != "nccl"


def _comm_device(device: Optional[torch.device] = None) -> torch.device:
    """Where this process's collective buffers live: the host under gloo,
    its card under NCCL."""
    if _staged():
        return torch.device("cpu")
    if device is not None and device.type == "cuda":
        return device
    return torch.device("cuda", torch.cuda.current_device())


def z_mesh(devices: Optional[Sequence] = None) -> list:
    """The process-major slab list: this process's slabs on ``devices``
    (one slab each, repeats allowed), the other processes' as they give
    theirs, so that rank r owns slabs [r*L, (r+1)*L).  Default devices:
    under NCCL this process's card (``LOCAL_RANK``, else the rank modulo
    the visible cards), made current; otherwise one slab per visible CUDA
    device (:class:`NoDeviceError` without one).  Collective: every
    process of the group calls it."""
    from .sharded import Slab

    if devices is None:
        if not torch.cuda.is_available():
            raise NoDeviceError(
                "no CUDA device is available; pass z_mesh(devices=['cpu'])")
        if dist.is_initialized() and not _staged():
            local = int(os.environ.get("LOCAL_RANK",
                                       rank() % torch.cuda.device_count()))
            devices = [torch.device("cuda", local)]
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = [torch.device(dv) for dv in devices]
    if dist.is_initialized() and not _staged() and devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])
    if world_size() == 1:
        return [Slab(0, dv) for dv in devices]
    mine = torch.tensor([len(devices)], dtype=torch.int64,
                        device=_comm_device(devices[0]))
    per = [torch.empty_like(mine) for _ in range(world_size())]
    dist.all_gather(per, mine)
    mesh = []
    for p, cnt in enumerate(int(c.item()) for c in per):
        mesh += [Slab(p, devices[i] if p == rank() else None)
                 for i in range(cnt)]
    return mesh


def check_process_major(mesh: Sequence) -> None:
    """Raise on every process, together, unless each owns a contiguous run
    of slabs starting at rank * (its slab count), as :func:`z_mesh`
    builds: the exchange and the counts gather rely on it.  The flags are
    gathered first, so a bad mesh fails everywhere with the message
    instead of hanging the processes that passed."""
    r = rank()
    got = [d for d, sl in enumerate(mesh) if sl.process == r]
    want = list(range(r * len(got), (r + 1) * len(got)))
    ok = torch.tensor([int(bool(got) and got == want)], dtype=torch.int64,
                      device=_comm_device())
    flags = [torch.empty_like(ok) for _ in range(world_size())]
    dist.all_gather(flags, ok)
    bad = [p for p, f in enumerate(flags) if not int(f.item())]
    if bad:
        mine = "" if got == want and got else (
            f"; this process owns mesh positions {got}, expected {want}")
        raise ValueError(  # kntpu-ok: bare-valueerror -- mesh-topology/runtime contract, not point-input validation
            f"multi-host mesh is not process-major on process(es) "
            f"{bad}{mine}; build the mesh with "
            f"parallel.distributed.z_mesh()")


def _wire(slab: dict, side: str, device: torch.device) -> torch.Tensor:
    """A slab's ``side`` ('top' or 'bot') boundary block (pts (hcap, 3)
    f32, ids (hcap,) i32, counts (R*dim^2,) i32) as one int32 message on
    ``device``."""
    pts, ids, counts = (slab[f"{side}_{x}"] for x in ("pts", "ids",
                                                     "counts"))
    return torch.cat([pts.contiguous().view(torch.int32).reshape(-1),
                      ids, counts]).to(device)


def _unwire(msg: torch.Tensor, hcap: int, device: torch.device):
    """Inverse of :func:`_wire`, onto ``device``."""
    msg = msg.to(device)
    pts = msg[: 3 * hcap].view(torch.float32).reshape(hcap, 3)
    return pts, msg[3 * hcap: 4 * hcap], msg[4 * hcap:]


def exchange_seams(built: Dict[int, dict], meta, mesh: Sequence) -> dict:
    """The halo exchange across this process's seams: its first slab's
    bottom block goes to the previous process and its last slab's top
    block to the next, and the blocks they send back arrive, in one
    ``batch_isend_irecv`` (each block one message).  Returns
    {(slab, 'top' | 'bot'): (pts, ids, counts)}: the neighbour's top block
    for the first slab's lower halo, its bottom block for the last slab's
    upper halo, on the slab's device."""
    local = sorted(built)
    first, last = local[0], local[-1]
    dev_first = built[first]["spts"].device
    dev_last = built[last]["spts"].device
    comm = _comm_device(dev_first)
    length = 4 * meta.hcap + meta.radius * meta.dim ** 2
    ops, recv = [], {}
    if first > 0:
        peer = mesh[first - 1].process
        recv[first, "top"] = buf = torch.empty((length,), dtype=torch.int32,
                                               device=comm)
        ops += [dist.P2POp(dist.irecv, buf, peer, tag=_TAG_UP),
                dist.P2POp(dist.isend, _wire(built[first], "bot", comm),
                           peer, tag=_TAG_DOWN)]
    if last + 1 < meta.ndev:
        peer = mesh[last + 1].process
        recv[last, "bot"] = buf = torch.empty((length,), dtype=torch.int32,
                                              device=comm)
        ops += [dist.P2POp(dist.irecv, buf, peer, tag=_TAG_DOWN),
                dist.P2POp(dist.isend, _wire(built[last], "top", comm),
                           peer, tag=_TAG_UP)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return {key: _unwire(buf, meta.hcap,
                         dev_first if key[0] == first else dev_last)
            for key, buf in recv.items()}


def allgather_counts(local_counts: List[torch.Tensor], ndev: int
                     ) -> np.ndarray:
    """(ndev, zcap*dim^2) host copy of every slab's cell counts, from each
    process's own slabs (process-major, so the gathered blocks stack in
    slab order): every process plans every slab."""
    comm = _comm_device(local_counts[0].device)
    mine = torch.stack([c.to(comm) for c in local_counts])
    blocks = [torch.empty_like(mine) for _ in range(world_size())]
    dist.all_gather(blocks, mine)
    out = torch.cat(blocks).cpu().numpy()
    if out.shape[0] != ndev:
        raise ValueError(f"gathered {out.shape[0]} slabs' counts for a "  # kntpu-ok: bare-valueerror -- internal invariant of the gathered census, not input validation
                         f"{ndev}-slab mesh")
    return out
