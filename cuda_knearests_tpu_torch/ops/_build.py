"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface.  At first use it is
compiled with ``nvcc`` into ``build/`` at the root of the checkout, under a
name keyed by a hash of the source, the ``csrc`` headers it includes and
the flags, and loaded with ``ctypes``; later processes reuse the library
while none of them changed.  :func:`load_all` builds several sources at once, one ``nvcc``
process each.  Any build or load failure raises :class:`KernelBuildError`.
Nothing here runs at import time.  :data:`builds` and :data:`loads` count
the ``nvcc`` builds that succeeded and the libraries loaded in this
process: the serving daemon's "recompiles" are their sum inside its
measured window.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# --fmad=false: every multiply and add rounds on its own, as in the plain
# torch versions the kernels are held against bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: Every kernel source of ``csrc/``: what a run that may launch any of
#: them builds up front (``load_all(KERNELS)``).
KERNELS = ("supercell_topk", "blocked_topk", "mxu_select", "mxu_select_bf16",
           "mxu_select_split")

_LOCK = threading.Lock()
_LIBS: dict = {}
# nvcc's output (ptxas register / spill report) of each build this process
# ran, by source name.
BUILD_LOGS: dict = {}
# nvcc builds that succeeded, and libraries loaded, in this process.
builds = 0
loads = 0


class KernelBuildError(RuntimeError):
    """A kernel source failed to compile or its library failed to load."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found (searched PATH and CUDA_HOME): the CUDA toolkit is "
        "needed to build the package's kernels")


def _sources(path: Path, seen: set) -> list:
    """The bytes of ``path`` and, recursively, of every ``csrc`` header it
    includes with quotes."""
    if path in seen:
        return []
    seen.add(path)
    src = path.read_bytes()
    out = [src]
    for inc in re.findall(rb'^\s*#\s*include\s+"([^"]+)"', src, re.M):
        out += _sources(_CSRC / inc.decode(), seen)
    return out


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built for its current
    source and the headers it includes."""
    h = hashlib.sha256()
    for part in _sources(_CSRC / f"{name}.cu", set()):
        h.update(hashlib.sha256(part).digest())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    return load_all([name])[0]


def load_all(names) -> list:
    """The loaded libraries of ``csrc/<name>.cu`` for every name, building
    the missing ones with one ``nvcc`` process each, all started together."""
    global builds, loads
    with _LOCK:
        if all(name in _LIBS for name in names):  # no hashing on hot paths
            return [_LIBS[name] for name in names]
        started = []
        for name in names:
            out = library_path(name)
            if name in _LIBS or out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(_CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            started.append((name, out, tmp, cmd, proc))
        failed = []
        for name, out, tmp, cmd, proc in started:
            BUILD_LOGS[name] = proc.communicate()[0]
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed on {name}.cu (rc "
                              f"{proc.returncode}):\n{' '.join(cmd)}\n"
                              f"{BUILD_LOGS[name]}")
            else:
                os.replace(tmp, out)
                builds += 1
        if failed:
            raise KernelBuildError("\n".join(failed))
        for name in names:
            if name not in _LIBS:
                path = library_path(name)
                try:
                    _LIBS[name] = ctypes.CDLL(str(path))
                except OSError as e:
                    raise KernelBuildError(f"cannot load {path}: {e}") from e
                loads += 1
        return [_LIBS[name] for name in names]
