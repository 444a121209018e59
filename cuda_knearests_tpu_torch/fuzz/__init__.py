"""The differential fuzz campaigns of the port.

Counterpart of ``cuda_knearests_tpu/fuzz/``: hostile inputs against the
engine's exactness promise, on the GPU unless ``device='cpu'`` is passed.

* :mod:`generators` -- the zoo of adversarial point distributions, each
  tagged with its hazard; a case is regenerable from (generator, seed, n,
  k).
* :mod:`routes` -- runners for the four solve routes (adaptive, legacy,
  query, sharded) and the seeded-fault injector (``KNTPU_FUZZ_FAULT``).
* :mod:`compare` -- the tie-aware comparison against the exact oracle.
* :mod:`minimize` -- the delta-debugging minimizer of failing cases.
* :mod:`campaign` -- the campaign (``python -m
  cuda_knearests_tpu_torch.fuzz``): every case through every route,
  failures minimized and banked into :data:`CORPUS_DIR`; under case
  isolation each case runs in a supervisor worker
  (``runtime/supervisor.py``), so a worker's death costs one case.
* :mod:`approx`, :mod:`fof`, :mod:`mutation`, :mod:`pod`, :mod:`fleet`,
  :mod:`chaos` -- the flavors: the brute route's recall bound and
  certificates, friends-of-friends, mutation streams through the delta
  overlay, the pod, multi-tenant streams through the serving fleet, and
  fault schedules against its pod tenants (ending with the mesh drill).

The port banks into ``tests/corpus_torch/``; the JAX package's
``tests/corpus/`` is read (replayed), never written.
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: Where the port's minimized failing cases are banked and replayed from
#: (``tests/test_torch_fuzz.py`` replays every entry).
CORPUS_DIR = os.path.join(_REPO_ROOT, "tests", "corpus_torch")

#: The JAX package's corpus: replayed through the port, never written.
REFERENCE_CORPUS_DIR = os.path.join(_REPO_ROOT, "tests", "corpus")


def corpus_size(corpus_dir: str | None = None) -> int:
    """Number of banked cases (``*.npz``) in ``corpus_dir`` (default
    :data:`CORPUS_DIR`).  One listdir, no torch import."""
    d = corpus_dir or CORPUS_DIR
    if not os.path.isdir(d):
        return 0
    return sum(1 for f in os.listdir(d) if f.endswith(".npz"))



def safe_bank_dir(bank_dir: str | None, faulted: bool,
                  prefix: str) -> str | None:
    """Where a campaign may bank.  The JAX package's corpus is never
    written (ValueError).  Under a seeded fault (``faulted``) the
    failures are injected and pin no engine bug, so a run aimed at
    :data:`CORPUS_DIR` banks into a fresh temporary directory instead --
    still banked, so the self-test's 'minimized, banked repro' holds."""
    if bank_dir is None:
        return None
    target = os.path.abspath(bank_dir)
    if target == os.path.abspath(REFERENCE_CORPUS_DIR):
        raise ValueError(f"{bank_dir} is the JAX package's corpus: the "
                         f"port replays it but never banks into it")
    if faulted and target == os.path.abspath(CORPUS_DIR):
        import tempfile

        return tempfile.mkdtemp(prefix=prefix)
    return bank_dir


__all__ = ["CORPUS_DIR", "REFERENCE_CORPUS_DIR", "corpus_size",
           "safe_bank_dir"]
