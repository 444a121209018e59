"""Typed errors of the engine: device faults and illegal input.

Counterpart of ``cuda_knearests_tpu/utils/memory.py``.  Every input-contract
class subclasses ``ValueError`` and stamps ``kind = 'invalid-input'``; device
faults stamp their own kind, so callers can key on the fault class instead
of matching messages.
"""

from __future__ import annotations

from typing import Optional


class DeviceMemoryError(RuntimeError):
    """Root of the device-fault hierarchy."""

    kind = "assertion"


class LaunchBudgetError(DeviceMemoryError):
    """A launch refused before it runs: its modelled footprint exceeds the
    device's memory budget, or its per-block state exceeds what one block's
    shared memory can hold.  ``requested``/``budget`` are bytes, ``site``
    names the launch."""

    kind = "oom"

    def __init__(self, message: str, *, requested: Optional[int] = None,
                 budget: Optional[int] = None, site: str = ""):
        super().__init__(message)
        self.requested = requested
        self.budget = budget
        self.site = site


class NoDeviceError(DeviceMemoryError):
    """An entry point was asked to run on the GPU (the default) and no CUDA
    device is present.  The engine never falls back to the CPU quietly:
    pass ``device='cpu'`` to run there on purpose."""

    kind = "no-device"


class InputContractError(ValueError):
    """Root of the illegal-input taxonomy."""

    kind = "invalid-input"


class InvalidShapeError(InputContractError):
    """Points are not a well-formed (n, 3) numeric array."""


class NonFiniteInputError(InputContractError, DeviceMemoryError):
    """NaN/inf coordinates.  Also a DeviceMemoryError, as in the reference
    package, but stamped 'invalid-input': the fix is cleaning the input."""

    kind = "invalid-input"


class DomainBoundsError(InputContractError):
    """Coordinates outside the [0, domain]^3 engine contract; run
    ``io.normalize_points`` first."""


class DegenerateExtentError(InputContractError):
    """A bounding box of no points was asked for."""


class InvalidKError(InputContractError):
    """k is not a positive integer.  k > n is not an error: rows pad
    -1/inf beyond the available neighbours."""


class CorruptInputError(InputContractError):
    """An input file that does not parse to its own declared contract."""


class InvalidConfigError(InputContractError):
    """A configuration the engine cannot honour."""
