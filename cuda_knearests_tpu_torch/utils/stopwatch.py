"""Wall-clock phase timers that wait for the device.

Counterpart of ``cuda_knearests_tpu/utils/stopwatch.py``: a context-manager
timer printing the elapsed wall time of a named phase, and :func:`timed`,
which splits a function's first call (kernel builds and library loads,
first allocations) from its steady-state calls.  CUDA launches return
before the device finishes, so :func:`block` synchronizes every CUDA
device among the tensors a call returned before the clock stops; results
on the CPU are complete when returned and are timed by the wall clock
alone.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Tuple

import torch


class Stopwatch:
    """Context-manager phase timer: prints ``[name start]`` and
    ``[name: seconds s]`` when ``verbose``; ``tick()`` gives the seconds
    since the previous tick."""

    def __init__(self, name: str = "", verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.start = time.perf_counter()
        self.last = self.start
        self.elapsed = 0.0
        if verbose and name:
            print(f"[{name} start]", flush=True)

    def tick(self) -> float:
        """Seconds since the previous tick (or the start)."""
        now = time.perf_counter()
        dt = now - self.last
        self.last = now
        return dt

    def stop(self) -> float:
        self.elapsed = time.perf_counter() - self.start
        if self.verbose and self.name:
            print(f"[{self.name}: {self.elapsed:.6f} s]", flush=True)
        return self.elapsed

    def __enter__(self) -> "Stopwatch":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def _cuda_devices(tree: Any, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _cuda_devices(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _cuda_devices(x, out)
    return out


def block(tree: Any) -> Any:
    """Wait until every CUDA tensor in ``tree`` (nested lists, tuples and
    dicts) is computed: synchronizes each CUDA device they live on.
    Returns ``tree``."""
    for device in _cuda_devices(tree, set()):
        torch.cuda.synchronize(device)
    return tree


def timed(fn: Callable[..., Any], *args: Any, warmup: int = 1, iters: int = 3,
          **kwargs: Any) -> Tuple[Any, Dict[str, float]]:
    """Run ``fn``, separating its first calls from steady state.

    Returns (result, {"warmup_s", "mean_s", "min_s"}): ``warmup_s`` is
    the first call (where kernels build and load), then ``warmup - 1``
    more untimed calls, then ``iters`` timed ones, each ending in
    :func:`block`."""
    t0 = time.perf_counter()
    out = block(fn(*args, **kwargs))
    warmup_s = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        block(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = block(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return out, {
        "warmup_s": warmup_s,
        "mean_s": sum(times) / len(times),
        "min_s": min(times),
    }
