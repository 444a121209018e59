"""The schema-versioned tuned-plan store.

Counterpart of ``cuda_knearests_tpu/tune/store.py``: one entry per
(device kind, problem signature), the winning launch plan the searcher
measured on that hardware plus its objective provenance.  The LRU entry
bound (``KNTPU_TUNE_CACHE_CAP``, junk falls back to the default), the
hit/miss/eviction counters on a prefixed ``stats_dict`` and the single
JSON file are the reference's, so for the same records a store file is
the same bytes in both packages and either package reads the other's.

Refusal: a persisted store whose ``schema`` tag is not :data:`SCHEMA`, or
whose body does not parse, raises :class:`StaleTuneStoreError` instead of
being silently diffed, merged or dropped: a stale plan silently applied
would run the wrong launch shape with no trace.

Keying:

* :func:`plan_signature` ``(n, d, k, recall_target)``: n bucketed to the
  next power of two, so one plan covers a capacity bucket.
* :func:`device_key`: the hardware half, keyed by the device the problem
  runs on: an explicit kind wins; a CPU device gives ``'cpu'`` (as the
  reference answers on the CPU); a CUDA device gives
  ``torch.cuda.get_device_name(device)``.  Plans never cross device kinds,
  so a plan measured on the CPU never resolves for a prepare on the card,
  nor the reverse.

Activation: ``config.resolve_tuned`` consults :func:`active_store`, a
process store registered with :func:`set_default_store`, else the
``KNTPU_TUNE_STORE`` path, else nothing.  With no active store every
resolve is an exact no-op.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from typing import Optional

from ..config import DEFAULT_TUNE_CACHE_ENTRIES

#: Schema tag every persisted store carries; bump on ANY layout change.
SCHEMA = "kntpu-tuned-plans-v1"

#: Env knobs: the persisted-store path and the LRU entry cap.
STORE_ENV = "KNTPU_TUNE_STORE"
_CAP_ENV = "KNTPU_TUNE_CACHE_CAP"

#: Plan keys ``config.resolve_tuned`` may fill into a KnnConfig.  The
#: store accepts extra provenance keys (objective_s, objective_source,
#: device_kind, ...) but resolution is a closed set -- a future plan key
#: must be wired through the seam deliberately, never applied by accident.
RESOLVABLE_KEYS = ("precision", "scorer", "epilogue", "query_chunk")


class StaleTuneStoreError(RuntimeError):
    """A persisted tuned-plan store this writer refuses to read: wrong
    (or missing) schema tag, or an unparseable body.  Never silently
    diffed -- delete the file or re-search to migrate."""


def env_cache_cap() -> int:
    """KNTPU_TUNE_CACHE_CAP override for the store's entry cap (>= 1
    enforced; junk falls back to the default so a typo'd export can never
    unbound a long-lived process's store)."""
    raw = os.environ.get(_CAP_ENV, "")
    try:
        return max(1, int(raw)) if raw else DEFAULT_TUNE_CACHE_ENTRIES
    except ValueError:
        return DEFAULT_TUNE_CACHE_ENTRIES


def plan_signature(n: int, d: int, k: int, recall_target: float) -> str:
    """The problem-shape key: n bucketed to the next power of two (one
    plan per capacity bucket), exact d/k, recall target at repr
    precision.  Precision is NOT part of the key -- it is part of the
    ANSWER (the plan decides the tier)."""
    n = int(n)
    bucket = 1 << max(0, n - 1).bit_length() if n > 1 else n
    return f"n{bucket}-d{int(d)}-k{int(k)}-rt{float(recall_target):g}"


def device_key(device_kind: Optional[str] = None, *, device=None) -> str:
    """The hardware half of a store key: the caller's explicit kind, else
    the kind of ``device`` -- ``'cpu'`` for a CPU device, the card's name
    (``torch.cuda.get_device_name``) for a CUDA one, the device type for
    any other -- else this process's default device: the card where one
    is reachable, the CPU otherwise."""
    if device_kind:
        return str(device_kind)
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return str(torch.cuda.get_device_name(device))
    return device.type


class TunedPlanStore:
    """LRU-bounded (device kind, signature) -> plan mapping with optional
    single-file JSON persistence.  Thread-safe: one lock guards the table
    and the counters, which surface via stats_dict()."""

    def __init__(self, path: Optional[str] = None,
                 cap: Optional[int] = None):
        self.path = path
        self.cap = max(1, int(cap)) if cap else env_cache_cap()
        self._lock = threading.Lock()
        self._plans: "OrderedDict[str, dict]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stores = 0
        if path and os.path.exists(path):
            self._load(path)

    @staticmethod
    def _key(signature: str, device_kind: Optional[str]) -> str:
        return f"{device_key(device_kind)}|{signature}"

    def _load(self, path: str) -> None:
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            raise StaleTuneStoreError(
                f"tuned-plan store {path!r} is unreadable ({e}); delete it "
                f"or point {STORE_ENV} elsewhere -- a garbled store is "
                f"never silently dropped") from e
        schema = doc.get("schema") if isinstance(doc, dict) else None
        if schema != SCHEMA:
            raise StaleTuneStoreError(
                f"tuned-plan store {path!r} has schema {schema!r}, this "
                f"writer speaks {SCHEMA!r}; re-search to migrate (stale "
                f"plans are never silently diffed)")
        plans = doc.get("plans", {})
        if not isinstance(plans, dict) or not all(
                isinstance(v, dict) for v in plans.values()):
            raise StaleTuneStoreError(
                f"tuned-plan store {path!r} carries a malformed plans "
                f"table; re-search to migrate")
        with self._lock:
            self._plans = OrderedDict(plans)  # JSON order IS the LRU order
            while len(self._plans) > self.cap:
                self._plans.popitem(last=False)
                self.evictions += 1

    def _save_locked(self) -> None:
        """Atomic tmp+rename write (a crashed writer must never leave a
        half-store that the next reader refuses as garbled)."""
        if not self.path:
            return
        doc = {"schema": SCHEMA, "plans": dict(self._plans)}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=False)
        os.replace(tmp, self.path)

    def lookup(self, signature: str,
               device_kind: Optional[str] = None) -> Optional[dict]:
        """The stored plan for this (device, signature), or None.  A hit
        refreshes LRU recency; the counters make the zero-re-search claim
        assertable."""
        key = self._key(signature, device_kind)
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                self.misses += 1
                return None
            self._plans.move_to_end(key)
            self.hits += 1
            return dict(plan)

    def record(self, signature: str, device_kind: Optional[str],
               plan: dict) -> None:
        """Insert/refresh a winner and persist.  Evicts LRU past the cap
        (the knob a long-lived multi-tenant tuner is bounded by)."""
        if not isinstance(plan, dict):
            raise TypeError(
                f"a tuned plan is a dict of knobs, got {type(plan).__name__}")
        key = self._key(signature, device_kind)
        with self._lock:
            self._plans[key] = dict(plan)
            self._plans.move_to_end(key)
            self.stores += 1
            while len(self._plans) > self.cap:
                self._plans.popitem(last=False)
                self.evictions += 1
            self._save_locked()

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self.hits = 0
            self.misses = 0
            self.evictions = 0
            self.stores = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def stats_dict(self) -> dict:
        with self._lock:
            out = {"tune_store_hits": self.hits,
                   "tune_store_misses": self.misses,
                   "tune_store_evictions": self.evictions,
                   "tune_store_stores": self.stores,
                   "tune_store_size": len(self._plans),
                   "tune_store_cap": self.cap}
            if self.path:
                out["tune_store_path"] = self.path
            return out


# -- process-wide activation (the resolve_tuned seam's source) ----------------

_DEFAULT_STORE: Optional[TunedPlanStore] = None
_PATH_STORES: "dict[str, TunedPlanStore]" = {}
_REG_LOCK = threading.Lock()


def set_default_store(store: Optional[TunedPlanStore]) -> None:
    """Register (or, with None, clear) the process store resolve_tuned
    consults ahead of the KNTPU_TUNE_STORE env path."""
    global _DEFAULT_STORE
    with _REG_LOCK:
        _DEFAULT_STORE = store


def get_default_store() -> Optional[TunedPlanStore]:
    return _DEFAULT_STORE


def active_store() -> Optional[TunedPlanStore]:
    """The store resolution consults: the registered process store, else
    a (cached, per-path) store at the KNTPU_TUNE_STORE env path, else
    None.  The per-path cache keeps counters meaningful across repeated
    resolves in one process; a store created for a path is reused even
    if the file changes underneath (single-writer-per-process law)."""
    if _DEFAULT_STORE is not None:
        return _DEFAULT_STORE
    path = os.environ.get(STORE_ENV, "")
    if not path:
        return None
    ap = os.path.abspath(path)
    with _REG_LOCK:
        st = _PATH_STORES.get(ap)
        if st is None:
            st = TunedPlanStore(path=ap)
            _PATH_STORES[ap] = st
        return st


def lookup_plan(signature: str,
                device_kind: Optional[str] = None) -> dict:
    """config.resolve_tuned's entry: the active store's plan for this
    (device, signature), or {} when no store is active / nothing stored."""
    st = active_store()
    if st is None:
        return {}
    return st.lookup(signature, device_kind) or {}


def stats_dict() -> dict:
    """The active store's counters ({} when none), surfaced through
    dispatch.tuned_plan_stats."""
    st = active_store()
    return st.stats_dict() if st is not None else {}
