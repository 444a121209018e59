"""Typed errors of the engine: device faults and illegal input.

Counterpart of ``cuda_knearests_tpu/utils/memory.py``.  Every input-contract
class subclasses ``ValueError`` and stamps ``kind = 'invalid-input'``; device
faults stamp their own kind, so callers can key on the fault class instead
of matching messages.  :func:`classify_fault_text` maps an error's text onto
the same kinds (``runtime.supervisor.FAILURE_KINDS``) where no typed
exception carries one.
"""

from __future__ import annotations

import re
from typing import Optional


class DeviceMemoryError(RuntimeError):
    """Root of the device-fault hierarchy."""

    kind = "assertion"


class TransportError(DeviceMemoryError):
    """A transient fault of the link to the device (connection lost or
    unavailable), not an allocation or validation failure: the one kind
    worth a bounded retry."""

    kind = "transport"


class DeviceOOMError(DeviceMemoryError):
    """An allocation the device refused at run time (CUDA out of memory):
    the same kind as a refusal before launch, found after the fact.
    Deterministic for a given launch; the fix is a smaller launch."""

    kind = "oom"


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


class InvalidRequestError(InputContractError):
    """A serving-stream request that breaks the request contract
    (``io.validate_request``): an unknown operation kind, a query or insert
    payload failing the points contract, delete ids out of range for the
    current cloud, or a request wider than the daemon's largest batch.  The
    daemon refuses the request with it instead of letting it crash a
    batch."""


class UnknownTenantError(InvalidRequestError):
    """A request named a tenant the front door does not serve.  Routing it
    to some other tenant would answer it against the wrong cloud."""


class OverQuotaError(InvalidRequestError):
    """A request exceeded its tenant's admission quota: refused, so the
    back-pressure reaches the caller instead of growing a queue."""


# Lowercased substrings of a transient transport fault in error text.
_TRANSPORT_PATTERNS = (
    "unavailable", "deadline_exceeded", "deadline exceeded",
    "connection reset", "connection refused", "failed to connect",
    "socket closed", "transport is closing", "broken pipe",
)

# Allocation exhaustion.  Anchored: 'oom' must be a word of its own, so
# 'headroom' or 'zoom' in an unrelated message does not classify as oom.
_OOM_RE = re.compile(
    r"resource[_ ]exhausted|out of memory|\boom\b|allocation failure"
    r"|failed to allocate")

# The input-contract classes' names as they appear in a traceback, and the
# canonical phrases.
_INVALID_INPUT_RE = re.compile(
    r"inputcontracterror|invalidshapeerror|nonfiniteinputerror"
    r"|domainboundserror|degenerateextenterror|invalidkerror"
    r"|corruptinputerror|invalidconfigerror|invalidrequesterror"
    r"|unknowntenanterror|overquotaerror"
    r"|input contract|request contract|unknown tenant|over quota")


def classify_fault_text(text: str) -> Optional[str]:
    """Map error text onto the failure kinds: 'transport' for a lost link,
    'invalid-input' for a typed contract refusal, 'oom' for allocation
    exhaustion, None when none matches (callers keep their own default).
    Transport wins ties, since a lost link drags allocator noise along;
    invalid-input beats oom, since a contract refusal's message may speak
    of budgets and still be a deterministic input problem."""
    low = (text or "").lower()
    if any(p in low for p in _TRANSPORT_PATTERNS):
        return "transport"
    if _INVALID_INPUT_RE.search(low):
        return "invalid-input"
    if _OOM_RE.search(low):
        return "oom"
    return None
