"""Declared protocol models: exhaustive small-scope state machines.

Counterpart of ``cuda_knearests_tpu/analysis/models.py``.  The models are
declared protocol, not code under port: every state machine, invariant,
mutant and law here equals the reference's, so both packages reconcile
their runtime traces against the same language.

The elastic fleet's protocols -- replication commit (DESIGN.md section
17), live Morton-range migration with atomic handover and mesh
snapshot+replay failover (section 22), DRR admission (section 17) -- are
verified *dynamically* by the chaos campaign and the SIGKILL drills,
which SAMPLE interleavings.  This module covers them: each protocol is a
small explicit state machine whose full reachable state graph is explored
by deterministic BFS, with the crash/fault event enabled at EVERY state,
checking the invariants the drills can only spot-check:

* ``replication-commit`` -- commit = primary applied AND log appended;
  only committed mutations are acked; seq stays dense; failover re-ships
  the committed tail, so zero committed mutations are ever lost.
* ``migration-handover`` -- the donor answers until ONE atomic handover;
  handover requires shipping done AND acked == committed, so a torn
  handover (receiver authoritative while missing a record) is
  unreachable; a wedged receiver aborts within ``abort_after`` pumps.
* ``mesh-snapshot-replay`` -- checksummed snapshot composed with the
  committed-tail replay reconstructs exactly the committed state, and
  replay is idempotent; a corrupt snapshot is refused, never restored.
* ``drr-admission`` -- the deficit stays bounded by quantum + max cost
  and a backlogged tenant is served within ceil(max_cost/quantum)
  rotations (the fleet's starvation bound).
* ``autoscale`` -- the sensor -> policy -> actuator loop: a breach is
  answered within its hysteresis and cooldown, the ladder never flaps,
  scale-down never compacts a tail a survivor needs.

**Small-scope argument** (DESIGN.md section 23): every state field is
bounded (<= 3 replicas, <= 2 shards, <= 6 ops, <= 3 mid-migration
mutations), so BFS terminates and covers every interleaving within the
scope.  The protocol bugs these invariants encode -- a dropped append, an
early ack, a non-atomic cut flip, a lost pending slab, a deficit that
never resets -- all manifest within two or three operations; the scope is
chosen so each KNOWN violating mutant (:data:`MUTANTS`) is caught, which
is the falsifiable form of the argument.

Everything here is pure host Python (no torch, no numpy): the explorer
runs in milliseconds inside the gate and inside a campaign manifest's
stamp (:func:`proto_stamp`).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

# Version of the protocol-model subsystem: bump on any model/invariant
# change so the chaos and fleet manifests (which stamp it) are
# traceable to the exact model set a run reconciled against.  Equal to
# the reference's: the two packages declare one model set.
PROTO_VERSION = "1.1.0"

State = tuple
ActionFn = Callable[[State], Iterable[Tuple[str, State]]]
InvariantFn = Callable[[State], Optional[str]]


@dataclasses.dataclass(frozen=True)
class Model:
    """One protocol as an explicit state machine.

    actions_fn enumerates every enabled (label, successor) pair -- labels
    are ``action`` or ``action(arg)``; the part before ``(`` must be in
    ``vocabulary``.  ``code_actions`` is the subset that corresponds to a
    source-level protocol site and must be claimed by a ``# proto:``
    annotation (proto.py's conformance pass); the rest (crash, wedge,
    ack, ...) are environment events.  ``prefix_laws`` are counting laws
    over action labels that every RUNTIME trace must satisfy at every
    prefix -- the decidable projection of "the trace is a word in the
    model's language" onto unbounded real executions.
    """

    name: str
    doc: str
    initial: State
    actions_fn: ActionFn
    invariants: Mapping[str, InvariantFn]
    vocabulary: Tuple[str, ...]
    code_actions: Tuple[str, ...]
    scope: str
    # (follower, leader): at every trace prefix count(follower) must be
    # <= count(leader) -- e.g. an ack can never outrun an append
    prefix_laws: Tuple[Tuple[str, str], ...] = ()


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant violation with its minimal action trace."""

    model: str
    invariant: str
    message: str
    trace: Tuple[str, ...]

    def render(self) -> str:
        steps = " -> ".join(self.trace) or "<initial state>"
        return (f"{self.model}: invariant '{self.invariant}' violated "
                f"after [{steps}]: {self.message}")


@dataclasses.dataclass(frozen=True)
class Exploration:
    """Result of one exhaustive BFS."""

    model: str
    n_states: int
    n_transitions: int
    violations: Tuple[Violation, ...]

    @property
    def ok(self) -> bool:
        return not self.violations


def explore(model: Model, max_states: int = 500_000) -> Exploration:
    """Deterministic exhaustive BFS over every interleaving.

    Actions are explored in sorted label order, so two runs produce
    byte-identical results (tests/test_proto.py pins this).  BFS layers
    mean the first violation found carries a minimal-length trace.  Stops
    at the first violation (the counterexample is the product); raises if
    the scope bound ``max_states`` is exceeded -- a model whose scope is
    not actually small is a modelling bug, not a result.
    """
    parent: Dict[State, Optional[Tuple[State, str]]] = {model.initial: None}
    queue: deque = deque([model.initial])

    def _trace(s: State) -> Tuple[str, ...]:
        steps: List[str] = []
        cur: Optional[State] = s
        while parent[cur] is not None:
            prev, label = parent[cur]  # type: ignore[misc]
            steps.append(label)
            cur = prev
        return tuple(reversed(steps))

    def _check(s: State) -> Optional[Violation]:
        for inv_name in sorted(model.invariants):
            msg = model.invariants[inv_name](s)
            if msg is not None:
                return Violation(model=model.name, invariant=inv_name,
                                 message=msg, trace=_trace(s))
        return None

    v = _check(model.initial)
    if v is not None:
        return Exploration(model.name, 1, 0, (v,))
    n_trans = 0
    while queue:
        s = queue.popleft()
        for label, t in sorted(model.actions_fn(s)):
            base = label.split("(", 1)[0]
            if base not in model.vocabulary:
                raise AssertionError(
                    f"model {model.name!r} emitted action {label!r} "
                    f"outside its declared vocabulary")
            n_trans += 1
            if t in parent:
                continue
            parent[t] = (s, label)
            if len(parent) > max_states:
                raise AssertionError(
                    f"model {model.name!r} exceeded {max_states} states: "
                    f"its small-scope bound is broken")
            v = _check(t)
            if v is not None:
                return Exploration(model.name, len(parent), n_trans, (v,))
            queue.append(t)
    return Exploration(model.name, len(parent), n_trans, ())


# =============================================================================
# Model 1: replication commit (serve/fleet/replica.py + tenants.py)
# =============================================================================

_R_OPS = ("m1", "m2", "m3")   # <= 3 mutations (small scope)
_R_REPLICAS = 2               # <= 2 replicas


def _replication_model(*, torn_commit: bool = False,
                       ack_before_commit: bool = False,
                       dup_append: bool = False,
                       skip_reship: bool = False) -> Model:
    """The commit law of FailoverController.mutate / Tenant
    .commit_mutation: apply on the primary, THEN append to the durable
    log (the commit point), THEN ack; ship to replicas any time after
    the append; on primary crash, failover promotes the most-caught-up
    replica and re-ships the committed tail.

    State: (applied, log, acked, rep_applied, crashed, promoted,
    reshipped) where ``log`` is the append-ordered tuple (seq = index+1)
    and ``rep_applied[r]`` is replica r's applied log prefix length
    (Replica.apply enforces dense seq, so a prefix is the only shape).

    The keyword mutants weaken exactly one guard each -- the seeded
    self-test faults and the per-invariant known-violating models
    (:data:`MUTANTS`).
    """
    initial = (frozenset(), (), frozenset(), (0,) * _R_REPLICAS,
               False, None, False)

    def actions(s: State):
        applied, log, acked, rep, crashed, promoted, reshipped = s
        out = []
        if not crashed:
            for op in _R_OPS:
                if op not in applied:
                    out.append((f"apply({op})",
                                (applied | {op}, log, acked, rep,
                                 crashed, promoted, reshipped)))
            for op in _R_OPS:
                in_log = op in log
                if op in applied and (not in_log or dup_append):
                    out.append((f"append({op})",
                                (applied, log + (op,), acked, rep,
                                 crashed, promoted, reshipped)))
            for op in _R_OPS:
                committed = op in log
                if torn_commit:
                    # mutant: the ack fires off the primary's apply alone
                    # -- the record never reached the log (the
                    # drop_from_log corruption as a *protocol*, not an
                    # injected fleet fault)
                    committed = op in applied
                if ack_before_commit:
                    committed = True
                if committed and op not in acked:
                    out.append((f"ack({op})",
                                (applied, log, acked | {op}, rep,
                                 crashed, promoted, reshipped)))
            for r in range(_R_REPLICAS):
                if rep[r] < len(log):
                    nrep = rep[:r] + (rep[r] + 1,) + rep[r + 1:]
                    out.append((f"ship(r{r})",
                                (applied, log, acked, nrep,
                                 crashed, promoted, reshipped)))
            out.append(("crash", (applied, log, acked, rep,
                                  True, promoted, reshipped)))
        elif promoted is None:
            # failover: promote the most-caught-up replica; re-ship the
            # committed tail log.since(applied_seq) unless the mutant
            # skips it (the stale-replica corruption)
            target = max(range(_R_REPLICAS), key=lambda r: (rep[r], -r))
            out.append(("failover",
                        (applied, log, acked, rep, True, target,
                         not skip_reship)))
        return out

    def inv_committed_acked(s: State) -> Optional[str]:
        applied, log, acked, rep, crashed, promoted, reshipped = s
        rogue = sorted(acked - set(log))
        if rogue:
            return (f"acked mutation(s) {rogue} are not in the committed "
                    f"log: an ack outran the commit point")
        return None

    def inv_zero_lost(s: State) -> Optional[str]:
        applied, log, acked, rep, crashed, promoted, reshipped = s
        if promoted is None:
            return None
        survives = set(log) if reshipped else set(log[:rep[promoted]])
        lost = sorted(acked - survives)
        if lost:
            return (f"acked mutation(s) {lost} are absent from the "
                    f"promoted replica's state after failover: committed "
                    f"work was lost")
        return None

    def inv_seq_dense(s: State) -> Optional[str]:
        log = s[1]
        if len(set(log)) != len(log):
            return (f"log {log} holds a duplicate record: the dense "
                    f"1-based seq law is broken")
        return None

    return Model(
        name="replication-commit",
        doc="apply -> append (commit) -> ack; ship; crash -> failover "
            "re-ships the committed tail",
        initial=initial,
        actions_fn=actions,
        invariants={
            "committed-acked": inv_committed_acked,
            "zero-lost-committed": inv_zero_lost,
            "seq-dense": inv_seq_dense,
        },
        vocabulary=("apply", "append", "ack", "ship", "crash", "failover"),
        code_actions=("apply", "append", "ship", "failover"),
        scope=f"{len(_R_OPS)} mutations x {_R_REPLICAS} replicas, crash "
              f"enabled at every state",
        prefix_laws=(("append", "apply"), ("ack", "append")),
    )


# =============================================================================
# Model 2: migration / handover (pod/reshard.py Migration + ElasticIndex)
# =============================================================================

_M_RANGE = ("k1", "k2")       # records initially in the moving range
_M_MIDMUT = ("x1",)           # <= 1 mid-migration mutation (small scope)
_M_ABORT_AFTER = 3            # abort_after_pumps


def _migration_model(*, torn_handover: bool = False,
                     lost_range: bool = False,
                     early_handover: bool = False,
                     no_abort: bool = False) -> Model:
    """The live Morton-range migration: ship committed records with a
    dense seq, route mid-migration mutations INTO the migration, and
    hand over atomically only when shipping is done and every shipped
    record is acked; a wedged receiver (delivery AND ack dropped) can
    never become ready, so the bounded pump counter aborts it with the
    cuts never flipped.

    State: (phase, to_ship, committed, delivered, acked, wedged, pumps,
    owner, mid_left).  ``owner`` is the authoritative owner of the moving
    range -- the exactly-one-owner invariant's subject.
    """
    all_keys = frozenset(_M_RANGE) | frozenset(_M_MIDMUT)
    initial = ("idle", tuple(_M_RANGE), 0, frozenset(), 0, False, 0,
               "donor", len(_M_MIDMUT))

    def actions(s: State):
        phase, to_ship, committed, delivered, acked, wedged, pumps, \
            owner, mid_left = s
        out = []
        if phase == "idle":
            out.append(("start", ("migrating", to_ship, committed,
                                  delivered, acked, wedged, pumps,
                                  owner, mid_left)))
            return out
        if phase != "migrating":
            return out
        if to_ship:
            key = to_ship[0]
            ncommitted = committed + 1
            ndelivered = delivered if wedged else delivered | {key}
            nacked = acked if wedged else acked + 1
            out.append((f"ship({key})",
                        (phase, to_ship[1:], ncommitted, ndelivered,
                         nacked, wedged, pumps, owner, mid_left)))
        if mid_left > 0:
            key = _M_MIDMUT[len(_M_MIDMUT) - mid_left]
            out.append((f"insert({key})",
                        (phase, to_ship + (key,), committed, delivered,
                         acked, wedged, pumps, owner, mid_left - 1)))
        ready = (not to_ship) and (acked == committed)
        if early_handover:
            ready = not to_ship
        npumps = pumps + 1
        if ready:
            ndelivered = delivered
            if torn_handover and delivered:
                # mutant: the final pending record is dropped at the flip
                ndelivered = delivered - {sorted(delivered)[-1]}
            if lost_range:
                ndelivered = frozenset()
            out.append(("handover",
                        ("done", to_ship, committed, ndelivered, acked,
                         wedged, npumps, "receiver", mid_left)))
        elif npumps > _M_ABORT_AFTER and not no_abort:
            out.append(("abort",
                        ("aborted", (), committed, frozenset(), acked,
                         wedged, npumps, "donor", mid_left)))
        else:
            out.append(("pump", (phase, to_ship, committed, delivered,
                                 acked, wedged, npumps, owner, mid_left)))
        if not wedged:
            out.append(("wedge", (phase, to_ship, committed, delivered,
                                  acked, True, pumps, owner, mid_left)))
        return out

    def inv_one_owner(s: State) -> Optional[str]:
        phase, owner = s[0], s[7]
        if phase in ("idle", "migrating", "aborted") and owner != "donor":
            return (f"phase {phase!r} but owner is {owner!r}: the "
                    f"receiver answered before the atomic handover")
        if phase == "done" and owner != "receiver":
            return "handover completed but the donor still owns the range"
        return None

    def inv_no_torn(s: State) -> Optional[str]:
        phase, to_ship, committed, delivered, acked = s[0], s[1], s[2], \
            s[3], s[4]
        if phase != "done":
            return None
        mid_left = s[8]
        expected = (frozenset(_M_RANGE)
                    | frozenset(_M_MIDMUT[:len(_M_MIDMUT) - mid_left]))
        missing = sorted(expected - delivered)
        if missing or acked != committed:
            return (f"receiver is authoritative but misses record(s) "
                    f"{missing} (acked={acked}, committed={committed}): "
                    f"a torn handover")
        return None

    def inv_bounded_pumps(s: State) -> Optional[str]:
        phase, pumps = s[0], s[6]
        if phase == "migrating" and pumps > _M_ABORT_AFTER:
            return (f"still migrating after {pumps} pumps (bound "
                    f"{_M_ABORT_AFTER}): a wedged migration was never "
                    f"aborted")
        return None

    return Model(
        name="migration-handover",
        doc="ship committed records (dense seq), mid-migration mutations "
            "join the stream, atomic handover only when shipped+acked, "
            "wedged receiver aborts within the pump bound",
        initial=initial,
        actions_fn=actions,
        invariants={
            "one-owner": inv_one_owner,
            "no-torn-handover": inv_no_torn,
            "bounded-pumps": inv_bounded_pumps,
        },
        vocabulary=("start", "ship", "insert", "pump", "handover",
                    "abort", "wedge"),
        code_actions=("start", "ship", "insert", "pump", "handover",
                      "abort"),
        scope=f"{len(_M_RANGE)} range records + {len(_M_MIDMUT)} "
              f"mid-migration mutation, wedge enabled at every state, "
              f"abort_after_pumps={_M_ABORT_AFTER}",
        prefix_laws=(("handover", "start"), ("abort", "start")),
    )


# =============================================================================
# Model 3: mesh snapshot + committed-tail replay (serve/fleet/elastic.py)
# =============================================================================

_S_OPS = 3    # <= 3 committed mutations (small scope)


def _snapshot_model(*, torn_snapshot: bool = False,
                    skip_replay: bool = False) -> Model:
    """The mesh failover durability law: a checksummed snapshot is
    published atomically (tmp + os.replace), a corrupt snapshot is
    REFUSED (typed CorruptInputError), and the standby's restored state
    composed with the committed-tail replay (log.since(base_seq)) equals
    the committed state exactly; replaying again changes nothing.

    State: (committed, snap_base, snap_holds, alive, standby_holds,
    standby_base, replayed).  ``snap_holds`` < ``snap_base`` models a
    torn write; the healthy model can never publish one (os.replace),
    and restore refuses it (the checksum), so the composition law only
    ever sees holds == base.
    """
    initial = (0, None, None, True, None, None, False)

    def actions(s: State):
        committed, snap_base, snap_holds, alive, standby_holds, \
            standby_base, replayed = s
        out = []
        if alive:
            if committed < _S_OPS:
                out.append(("mutate", (committed + 1, snap_base,
                                       snap_holds, alive, standby_holds,
                                       standby_base, replayed)))
            holds = committed - 1 if (torn_snapshot and committed) \
                else committed
            out.append(("snapshot", (committed, committed, holds, alive,
                                     standby_holds, standby_base,
                                     replayed)))
            out.append(("crash", (committed, snap_base, snap_holds,
                                  False, standby_holds, standby_base,
                                  replayed)))
        else:
            corrupt = snap_holds is not None and snap_holds != snap_base
            if snap_base is not None and standby_holds is None \
                    and (not corrupt or torn_snapshot):
                # healthy model: the checksum REFUSES a corrupt snapshot
                # (restore not enabled); the torn mutant restores anyway
                out.append(("restore", (committed, snap_base, snap_holds,
                                        alive, snap_holds, snap_base,
                                        replayed)))
            if standby_holds is not None:
                tail = 0 if skip_replay else committed - standby_base
                out.append(("replay", (committed, snap_base, snap_holds,
                                       alive, standby_holds + tail,
                                       committed, True)))
        return out

    def inv_complete(s: State) -> Optional[str]:
        committed, standby_holds, replayed = s[0], s[4], s[6]
        if replayed and standby_holds != committed:
            return (f"snapshot o replay reconstructed {standby_holds} "
                    f"mutation(s) but {committed} were committed: the "
                    f"composition law is broken")
        return None

    def inv_no_corrupt_restore(s: State) -> Optional[str]:
        snap_base, snap_holds, standby_holds, standby_base = \
            s[1], s[2], s[4], s[5]
        if standby_holds is None:
            return None
        if standby_base is not None and standby_holds < standby_base \
            and s[6] is False:
            return (f"standby restored {standby_holds} mutation(s) from "
                    f"a snapshot claiming base_seq={standby_base}: a "
                    f"corrupt snapshot was accepted")
        return None

    return Model(
        name="mesh-snapshot-replay",
        doc="atomic checksummed snapshot; corrupt snapshots refused; "
            "restore + committed-tail replay == committed state, "
            "idempotent",
        initial=initial,
        actions_fn=actions,
        invariants={
            "snapshot-replay-complete": inv_complete,
            "no-corrupt-restore": inv_no_corrupt_restore,
        },
        vocabulary=("mutate", "snapshot", "crash", "restore", "replay"),
        code_actions=("snapshot", "restore", "replay"),
        scope=f"{_S_OPS} committed mutations, crash enabled at every "
              f"state, snapshot republishable at any seq",
        prefix_laws=(("restore", "snapshot"), ("replay", "restore")),
    )


# =============================================================================
# Model 4: DRR admission (serve/fleet/admission.py DrrScheduler)
# =============================================================================

_D_QUANTUM = 2
_D_COSTS = (1, 3)     # enqueueable batch costs; max cost = 3
_D_TENANTS = 2
_D_BACKLOG = 2        # per-tenant queue bound (small scope)
_D_BOUND = -(-max(_D_COSTS) // _D_QUANTUM)   # ceil(max_cost / quantum)


def _drr_model(*, no_deficit_reset: bool = False,
               skip_tenant: bool = False) -> Model:
    """The deficit-round-robin fairness law: each rotation grants every
    backlogged tenant one quantum, dispatches while the head batch fits
    the deficit, and RESETS the deficit when a queue drains -- so the
    deficit stays bounded by quantum + max cost and a backlogged
    tenant's head dispatches within ceil(max_cost/quantum) rotations
    (the provable starvation bound).

    State: (queues, deficits, waits) -- ``waits[t]`` counts consecutive
    rotations tenant t was backlogged yet dispatched nothing.
    """
    initial = (((),) * _D_TENANTS, (0,) * _D_TENANTS, (0,) * _D_TENANTS)

    def actions(s: State):
        queues, deficits, waits = s
        out = []
        for t in range(_D_TENANTS):
            if len(queues[t]) < _D_BACKLOG:
                for c in _D_COSTS:
                    nq = list(queues)
                    nq[t] = queues[t] + (c,)
                    out.append((f"enqueue(t{t},c{c})",
                                (tuple(nq), deficits, waits)))
        if any(queues):
            nq, nd, nw = list(queues), list(deficits), list(waits)
            for t in range(_D_TENANTS):
                if skip_tenant and t == _D_TENANTS - 1:
                    # mutant: the unfair scheduler never visits the last
                    # tenant's queue
                    if nq[t]:
                        nw[t] += 1
                    continue
                if not nq[t]:
                    continue
                nd[t] += _D_QUANTUM
                served = 0
                q = list(nq[t])
                while q and q[0] <= nd[t]:
                    nd[t] -= q.pop(0)
                    served += 1
                nq[t] = tuple(q)
                if not q and not no_deficit_reset:
                    nd[t] = 0
                nw[t] = 0 if served else nw[t] + 1
            out.append(("rotate", (tuple(nq), tuple(nd), tuple(nw))))
        return out

    def inv_starvation(s: State) -> Optional[str]:
        waits = s[2]
        for t, w in enumerate(waits):
            if w > _D_BOUND:
                return (f"tenant t{t} was backlogged through {w} "
                        f"rotations without a dispatch (bound "
                        f"{_D_BOUND} = ceil({max(_D_COSTS)}/"
                        f"{_D_QUANTUM})): starvation")
        return None

    def inv_deficit(s: State) -> Optional[str]:
        deficits = s[1]
        cap = _D_QUANTUM + max(_D_COSTS)
        for t, d in enumerate(deficits):
            if d > cap:
                return (f"tenant t{t} deficit {d} exceeds quantum + max "
                        f"cost = {cap}: the drained-queue reset is "
                        f"missing and credit accumulates unboundedly")
        return None

    return Model(
        name="drr-admission",
        doc="quantum per rotation, dispatch while head <= deficit, "
            "deficit reset on drain => bounded deficit and bounded "
            "starvation",
        initial=initial,
        actions_fn=actions,
        invariants={
            "starvation-bound": inv_starvation,
            "deficit-bound": inv_deficit,
        },
        vocabulary=("enqueue", "rotate"),
        code_actions=("enqueue", "rotate"),
        scope=f"{_D_TENANTS} tenants, backlog <= {_D_BACKLOG}, costs "
              f"{_D_COSTS}, quantum {_D_QUANTUM}",
        prefix_laws=(),
    )


# =============================================================================
# Model 5: autoscale -- sensor -> policy -> actuator loop + brownout ladder
# =============================================================================

_A_B = 2      # hysteresis: consecutive breach/clear ticks before acting
_A_C = 2      # cooldown ticks after any actuation (C <= B => anti-flap)
_A_TIER = 2   # ladder depth: 0 exact -> 1 bf16 -> 2 lowered recall
_A_BOUND = _A_B + _A_C  # truth-ticks a condition may persist unanswered


def _autoscale_model(*, stuck_sensor: bool = False,
                     flap_policy: bool = False,
                     drop_tail: bool = False,
                     no_recovery: bool = False,
                     brown_regress: bool = False) -> Model:
    """The traffic-driven autoscale + brownout control loop
    (serve/fleet/autoscale.py): a deterministic tick samples one sensor
    bit (the class is over / under its SLO budget), hysteresis requires
    B consecutive agreeing ticks before any actuation, and every
    actuation opens a C-tick cooldown.  Breach ladder: provision a
    replica first, then step the brownout tier down, then shed; clear
    ladder: ALWAYS recover to the exact tier before de-provisioning.
    Scale-down compacts the replication log only to the remaining pool's
    applied floor, never to the committed head.

    State: (load, tier, bs, cs, bt, ct, cool, extra, committed, applied,
    compacted, since, gap, wrong) -- bs/cs are the SENSED breach/clear
    streaks the policy acts on, bt/ct the TRUE ones (they diverge only
    under the stuck-sensor mutant), ``since`` ticks since the last
    actuation, ``gap`` the minimum such spacing ever observed, ``wrong``
    a flag the brown-regress mutant sets by stepping the ladder DOWN on
    a clear signal.  The tick is enabled only when no actuation is --
    the policy is deterministic, so liveness ("the loop reacts within
    B + C ticks") is a state invariant, not a fairness assumption.
    """
    initial = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, _A_C, _A_C, 0)

    def actions(s: State):
        (load, tier, bs, cs, bt, ct, cool, extra,
         committed, applied, compacted, since, gap, wrong) = s
        out = []
        # -- environment: load flips, a mutation commits, a replica ships
        out.append(("breach" if load == 0 else "clear",
                    (1 - load, tier, bs, cs, bt, ct, cool, extra,
                     committed, applied, compacted, since, gap, wrong)))
        if committed == 0:
            out.append(("commit",
                        (load, tier, bs, cs, bt, ct, cool, extra, 1,
                         applied, compacted, since, gap, wrong)))
        if applied < committed:
            out.append(("ship",
                        (load, tier, bs, cs, bt, ct, cool, extra,
                         committed, applied + 1, compacted, since, gap,
                         wrong)))

        # -- policy: which actuation (if any) is enabled right now
        def actuate(label, breach_side, *, tier2=tier, extra2=extra,
                    compacted2=compacted, wrong2=wrong):
            nbs, nbt = (0, 0) if breach_side else (bs, bt)
            ncs, nct = (cs, ct) if breach_side else (0, 0)
            return (label, (load, tier2, nbs, ncs, nbt, nct, _A_C,
                            extra2, committed, applied, compacted2, 0,
                            min(gap, since), wrong2))

        ready = flap_policy or cool == 0
        need = 1 if flap_policy else _A_B
        acts = []
        if ready and bs >= need:
            if extra == 0:
                acts.append(actuate("scale_up", True, extra2=1))
            elif tier < _A_TIER:
                acts.append(actuate("brown_down", True, tier2=tier + 1))
            else:
                acts.append(actuate("shed", True))
        if ready and cs >= need:
            if brown_regress and tier < _A_TIER:
                # mutant: the ladder steps the WRONG direction on a
                # clear signal -- brownout is no longer monotone per
                # episode
                acts.append(actuate("brown_down", False, tier2=tier + 1,
                                    wrong2=1))
            if tier > 0 and not no_recovery:
                acts.append(actuate("brown_up", False, tier2=tier - 1))
            elif tier == 0 and extra == 1 and not no_recovery:
                target = committed if drop_tail else applied
                acts.append(actuate("scale_down", False, extra2=0,
                                    compacted2=max(compacted, target)))
        out.extend(acts)

        # -- tick: enabled only when the deterministic policy has
        # nothing to fire (see docstring)
        if not acts:
            sensed = 0 if stuck_sensor else load
            out.append(("tick",
                        (load, tier,
                         min(_A_B, bs + 1) if sensed else 0,
                         min(_A_B, cs + 1) if not sensed else 0,
                         min(_A_BOUND + 1, bt + 1) if load else 0,
                         min(_A_BOUND + 1, ct + 1) if not load else 0,
                         max(0, cool - 1), extra, committed, applied,
                         compacted, min(_A_C, since + 1), gap, wrong)))
        return out

    def inv_reaction(s: State) -> Optional[str]:
        bt = s[4]
        if bt > _A_BOUND:
            return (f"a breach persisted through {bt} ticks without any "
                    f"actuation (bound {_A_BOUND} = hysteresis {_A_B} + "
                    f"cooldown {_A_C}): the sensor->policy loop is not "
                    f"reacting")
        return None

    def inv_recovery(s: State) -> Optional[str]:
        tier, ct, extra = s[1], s[5], s[7]
        if ct > _A_BOUND and (tier > 0 or extra):
            return (f"the load cleared {ct} ticks ago yet the fleet is "
                    f"still degraded (tier {tier}, extra replicas "
                    f"{extra}): brownout does not recover to exact")
        return None

    def inv_flap(s: State) -> Optional[str]:
        gap = s[12]
        if gap < _A_C:
            return (f"two actuations fired only {gap} tick(s) apart "
                    f"(cooldown {_A_C}): oscillation is unbounded")
        return None

    def inv_tail(s: State) -> Optional[str]:
        applied, compacted = s[9], s[10]
        if compacted > applied:
            return (f"scale-down compacted the replication log to seq "
                    f"{compacted} past the remaining pool's applied "
                    f"floor {applied}: a later failover hits a gap")
        return None

    def inv_monotone(s: State) -> Optional[str]:
        if s[13]:
            return ("the ladder stepped DOWN on a clear signal: "
                    "brownout is not monotone within the episode")
        return None

    return Model(
        name="autoscale",
        doc="B-tick hysteresis + C-tick cooldown around a provision -> "
            "brownout -> shed ladder; recovery always restores the "
            "exact tier before de-provisioning, and scale-down never "
            "compacts past the applied floor",
        initial=initial,
        actions_fn=actions,
        invariants={
            "breach-reaction": inv_reaction,
            "bounded-recovery": inv_recovery,
            "anti-flap": inv_flap,
            "no-drop-tail": inv_tail,
            "brownout-monotone": inv_monotone,
        },
        vocabulary=("breach", "clear", "commit", "ship", "tick",
                    "scale_up", "scale_down", "brown_down", "brown_up",
                    "shed"),
        code_actions=("tick", "scale_up", "scale_down", "brown_down",
                      "brown_up", "shed"),
        scope=f"1 class, ladder depth {_A_TIER}, hysteresis {_A_B}, "
              f"cooldown {_A_C}, 1 elastic replica, 1 in-flight delta",
        prefix_laws=(("scale_down", "scale_up"),
                     ("brown_up", "brown_down")),
    )


# =============================================================================
# Registry + faults + mutants
# =============================================================================

def healthy_models() -> Dict[str, Model]:
    """The five shipped models (all invariants hold; proto.py explores
    every one on every gate run)."""
    return {m.name: m for m in (
        _replication_model(), _migration_model(), _snapshot_model(),
        _drr_model(), _autoscale_model())}


# Known-violating mutant models: each weakens exactly one guard and is
# provably caught by the named invariant (tests/test_proto.py explores
# every one).  The first three double as the engine's seeded self-test
# faults (KNTPU_ANALYSIS_FAULT; 'unclaimed-action' seeds the conformance
# pass instead, see proto.py).
MUTANTS: Dict[str, Tuple[Model, str]] = {
    # fault mutants (model, invariant that must catch it)
    "torn-commit": (_replication_model(torn_commit=True),
                    "committed-acked"),
    "ack-before-commit": (_replication_model(ack_before_commit=True),
                          "committed-acked"),
    # per-invariant mutants
    "skip-reship": (_replication_model(skip_reship=True),
                    "zero-lost-committed"),
    "dup-append": (_replication_model(dup_append=True), "seq-dense"),
    "torn-handover": (_migration_model(torn_handover=True),
                      "no-torn-handover"),
    "lost-range": (_migration_model(lost_range=True), "no-torn-handover"),
    "early-handover": (_migration_model(early_handover=True),
                       "no-torn-handover"),
    "no-abort": (_migration_model(no_abort=True), "bounded-pumps"),
    "torn-snapshot": (_snapshot_model(torn_snapshot=True),
                      "no-corrupt-restore"),
    "skip-replay": (_snapshot_model(skip_replay=True),
                    "snapshot-replay-complete"),
    "no-deficit-reset": (_drr_model(no_deficit_reset=True),
                         "deficit-bound"),
    "skip-tenant": (_drr_model(skip_tenant=True), "starvation-bound"),
    "stuck-sensor": (_autoscale_model(stuck_sensor=True),
                     "breach-reaction"),
    "flap-policy": (_autoscale_model(flap_policy=True), "anti-flap"),
    "scale-drop-tail": (_autoscale_model(drop_tail=True),
                        "no-drop-tail"),
    "no-recovery": (_autoscale_model(no_recovery=True),
                    "bounded-recovery"),
    "brown-regress": (_autoscale_model(brown_regress=True),
                      "brownout-monotone"),
}


def explore_all(models: Optional[Mapping[str, Model]] = None
                ) -> Dict[str, Exploration]:
    """Exhaustively explore every model (sorted order, deterministic)."""
    models = models if models is not None else healthy_models()
    return {name: explore(models[name]) for name in sorted(models)}


# =============================================================================
# Runtime trace conformance (the counterpart of syncflow's runtime
# reconciliation against dispatch.trace_sites)
# =============================================================================

def conform(trace: Sequence[Tuple[str, str]],
            models: Optional[Mapping[str, Model]] = None) -> List[str]:
    """Check a runtime (model, action) trace against the declared models.

    Returns violation strings (empty = the trace is accepted).  Two laws,
    both decidable on unbounded real executions:

    * every event's model and action must exist in the declared
      vocabulary (an unclaimed action = a protocol transition the models
      do not know about -- the runtime twin of a ``proto-leak``);
    * per model, every prefix must satisfy the declared counting laws
      (e.g. acks never outrun appends, a handover never precedes its
      start) -- the projection of "the trace is a word in the model's
      language" that survives arbitrary op counts.
    """
    models = models if models is not None else healthy_models()
    out: List[str] = []
    counts: Dict[Tuple[str, str], int] = {}
    for i, (model_name, action) in enumerate(trace):
        m = models.get(model_name)
        if m is None:
            out.append(f"event {i}: unknown model {model_name!r}")
            continue
        base = action.split("(", 1)[0]
        if base not in m.vocabulary:
            out.append(f"event {i}: action {action!r} is not in model "
                       f"{model_name!r}'s vocabulary {m.vocabulary}: an "
                       f"unclaimed protocol transition")
            continue
        counts[(model_name, base)] = counts.get((model_name, base), 0) + 1
        for follower, leader in m.prefix_laws:
            if counts.get((model_name, follower), 0) > \
                    counts.get((model_name, leader), 0):
                out.append(
                    f"event {i}: {model_name}: #{follower} "
                    f"({counts.get((model_name, follower), 0)}) outran "
                    f"#{leader} ({counts.get((model_name, leader), 0)}) "
                    f"-- the trace is not a word in the model's language")
    return out


# =============================================================================
# The stamp fuzz manifests carry
# =============================================================================

_STAMP_CACHE: Optional[bool] = None


def proto_models_ok() -> bool:
    """True iff every shipped model explores clean.  Cached per process:
    a run stamps several manifests and the exploration is pure."""
    global _STAMP_CACHE
    if _STAMP_CACHE is None:
        _STAMP_CACHE = all(e.ok for e in explore_all().values())
    return _STAMP_CACHE


def proto_stamp(trace: Optional[Sequence[Tuple[str, str]]] = None) -> dict:
    """The traceability stamp the fleet and chaos manifests carry
    (the proto twin of findings.analysis_stamp): which model set the run
    was reconciled against and whether every model explored clean -- AND,
    when the caller hands over the runtime trace it recorded
    (utils/prototrace.py), whether that trace is a word in the models'
    language.  Pure host work, milliseconds, cached."""
    ok = proto_models_ok()
    stamp = {"proto_version": PROTO_VERSION, "proto_models_ok": ok}
    if trace is not None:
        bad = conform(trace)
        stamp["proto_trace_events"] = len(trace)
        stamp["proto_trace_violations"] = bad[:4]
        stamp["proto_models_ok"] = ok and not bad
    return stamp
