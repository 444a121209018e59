"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface.  At first use it is
compiled with ``nvcc`` into ``build/`` at the root of the checkout, under a
name keyed by a hash of the source and the flags, and loaded with
``ctypes``; later processes reuse the library while the source is
unchanged.  Any build or load failure raises :class:`KernelBuildError`.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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

_LOCK = threading.Lock()
_LIBS: dict = {}
# nvcc's output (ptxas register / spill report) of each build this process
# ran, by source name.
BUILD_LOGS: dict = {}


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


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built for its current
    source."""
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(_CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_LOGS[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise KernelBuildError(
                    f"nvcc failed on {name}.cu (rc {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{BUILD_LOGS[name]}")
            os.replace(tmp, out)
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            raise KernelBuildError(f"cannot load {out}: {e}") from e
        _LIBS[name] = lib
        return lib
