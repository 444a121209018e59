"""The failure taxonomy of the engine.

Counterpart of ``cuda_knearests_tpu/runtime/supervisor.py:58``.  Only
:data:`FAILURE_KINDS` is ported so far: the serving daemon maps every
contained failure onto it.  The supervisor itself (``Supervisor``, the
worker result protocol, retries and quarantine) is not ported yet.
"""

# Every failure kind a contained fault is reported as.  'invalid-input' is
# a typed input-contract refusal (``utils/memory.InputContractError``): a
# deterministic caller error, never retried.
FAILURE_KINDS = ("crash", "timeout", "oom", "transport", "assertion",
                 "invalid-input")
