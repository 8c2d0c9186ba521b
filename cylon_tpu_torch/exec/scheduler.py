"""The serving tier: many concurrent queries on one card under admission
control (port of ``cylon_tpu/exec/scheduler.py``).

:mod:`cylon_tpu_torch.exec.pipeline` runs ONE query piece by piece; this
module multiplexes many of them (a TPC-H mix is the workload it is
measured on) over the same env:

* **Admission against the memory ledger** (exec/memory.py).  Each
  submitted query declares a footprint (:func:`estimate_footprint`); a
  session starts only when the running sessions' declared footprints plus
  its own fit the budget.  Head of line: a later, smaller query never
  overtakes a waiting one (``admission_waits``).  Before a session starts,
  the ledger's coldest spillable registrations, other tenants' first,
  evict down to the budget; when nothing runs at all, the oldest pending
  session is force-admitted (serial execution instead of a deadlock).
  With a deadline (``admission_timeout_s``) a session waiting past it
  fails typed (``AdmissionTimeoutError``).

* **Cooperative interleave.**  Each admitted session runs on its own
  thread, but one BATON serializes them: exactly one session runs between
  interleave points (:func:`maybe_yield`: per piece of the pipelined
  join, per chunk of the pipelined set op, per batch of the scan join,
  and at every hash shuffle).  Every operator thus sees the
  single-threaded engine it was written for, while the device keeps
  executing the work a parked session already queued — tenant A's piece
  runs on the card while tenant B enqueues its own.  Every session
  stays on the device's default stream (the spill tier's side stream is
  shared and ordered by events), so queued work of two tenants is
  ordered as it was enqueued.

* **Policies**: ``fifo`` (arrival order), ``priority`` (highest first,
  then arrival) and ``fair`` (the least attributed seconds per weight,
  from each session's attribution scope; its grant order depends on
  wall-clock time, so it is not fixed from run to run).

* **Preemption** (``priority`` and ``fair``, with checkpoints armed): a
  blocked higher-ranked arrival flags the lowest-ranked running query;
  that tenant drains at its next checkpoint boundary
  (exec/checkpoint.drain_requested) and is requeued, and its next run
  resumes in process past its committed pieces (``requeue_capacity``
  bounds the requeues; past it ``RequeueOverflowError``).  A fleet
  resize (exec/fleet.py) drains every tenant the same way without
  requeue, for a relaunch at ``resize_target``.

* **Isolation**: each session's thread is tagged
  (``recovery.set_session``), so its recovery events carry its name,
  ``@session`` fault specs target it, its votes ride its namespace, its
  checkpoint stages are its own, and its retry ladder's depth is
  thread-local — one tenant's fault never touches another's state.

**The admission facades.**  Operators reach the ledger's admission and
eviction only through :func:`admit_allocation`, the exchange guard
through :func:`free_pressure` and the retry ladder's spill rung through
:func:`spill_retry`, so per-tenant bytes and cross-tenant evictions are
attributed in one place (the reference's lint rule TS109).

**Across processes** (a ``DistributedConfig`` world of several
processes, :meth:`QueryScheduler._multi`), every process runs the same
scheduler over the same submissions, and whatever reads a wall clock or
a process's own ledger is voted over the consensus wire
(exec/recovery.py), so the baton moves the same way everywhere and the
sessions' collectives meet in the same order: the running pick and the
admission pick with a requeued tenant pending (max ordinal), the expiry
(the max expired ordinal, one session a loop turn), the preempt victim,
the eviction count, the drain, the fleet's resize and a shape family's
clamped admission footprint (each process's own observed peaks, the max
agreed).  One process
driving every rank takes its own choices, as the reference on one
controller.  With no scheduler running, :func:`maybe_yield` is one
module-global load and the facades one thread-local read more than the
ledger calls they wrap.  ``stats()["compile"]`` is the compile tier's
block (exec/compiler.stats: the kernel libraries live, loads served by a
library already built, ``nvcc`` builds and their seconds).
"""

from __future__ import annotations

import os
import threading
import time

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..status import InvalidError, ResumableAbort
from .session import DONE, FAILED, PENDING, RUNNING, QuerySession

#: the scheduler serving this process (at most one), read by maybe_yield
_ACTIVE: "QueryScheduler | None" = None


def current_session() -> QuerySession | None:
    """The serving session running on this thread, or None: the running
    scheduler's session of the name this thread is tagged with
    (``recovery.set_session``, the one per-thread session tag)."""
    sched = _ACTIVE
    if sched is None:
        return None
    from . import recovery
    name = recovery.current_session()
    return None if name is None else sched._by_name.get(name)


def maybe_yield() -> None:
    """An interleave point.  Outside a scheduler, or on a thread that is
    no session's, nothing.  On a session's thread it hands the baton back
    to the scheduler and returns when the session is granted its next
    slice; the device work the session queued keeps running meanwhile."""
    sched = _ACTIVE
    if sched is None:
        return
    sess = current_session()
    if sess is None or sess.state != RUNNING:
        return
    sched._yield_turn(sess)


# ---------------------------------------------------------------------------
# the admission and eviction facades
# ---------------------------------------------------------------------------

def admit_allocation(env, need: int, scratch: int = 0) -> None:
    """Admission of a new resident allocation of ``need`` bytes (plus
    ``scratch`` transient bytes): the bytes are charged to the current
    session, then the ledger's admission (:func:`exec.memory.
    ensure_headroom`, at its ``spill.evict`` site) evicts the coldest
    spillable owners if the budget is short."""
    from . import memory
    sess = current_session()
    if sess is not None:
        sess.bytes_admitted += int(need)
    memory.ensure_headroom(env, need, scratch=scratch)


def free_pressure(env, need: int) -> int:
    """Evict for ``need`` bytes of headroom at a guard (the exchange's
    receive guard); the bytes freed, 0 under the budget."""
    from . import memory
    if memory.over_budget(env, int(need)):
        return memory.try_free(env, int(need))
    return 0


def spill_retry() -> int:
    """The retry ladder's spill rung: evict every spillable resident
    owner, every tenant's (a last resort, and round trips are bit-exact);
    the bytes freed."""
    from . import memory
    return memory.spill_for_retry()


# ---------------------------------------------------------------------------
# admission estimates from ANALYZE history
# ---------------------------------------------------------------------------

#: shape family -> the largest peak-ledger bytes observed for it
#: (``obs.explain_analyze(family=...)``); admission charges a session of
#: that family min(declared, observed peak x safety factor)
_FAMILY_PEAKS: dict[str, int] = {}


def note_family_peak(family: str, peak_bytes: int) -> None:
    """Record an observed peak for a shape family (max-update)."""
    prev = _FAMILY_PEAKS.get(family, 0)
    _FAMILY_PEAKS[family] = max(prev, int(peak_bytes))


def observed_peak(family: str | None) -> int | None:
    """The recorded peak of a shape family, or None."""
    if family is None:
        return None
    return _FAMILY_PEAKS.get(family)


def reset_family_history() -> None:
    _FAMILY_PEAKS.clear()


def estimate_footprint(*tables, factor: float = 2.0) -> int:
    """A query's footprint estimate over ``tables`` (Tables or
    DataFrames): their column bytes (data and validity) times ``factor``
    for the packed lane matrices and piece scratch.  Admission gates on
    it; the ledger accounts the real bytes."""
    total = 0
    for t in tables:
        t = getattr(t, "_table", t)
        for c in t.columns.values():
            for a in (c.data, c.validity):
                if a is not None:
                    total += int(a.numel()) * int(a.element_size())
    return int(total * float(factor))


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

def _fifo_key(s: QuerySession):
    return s.ordinal


def _priority_key(s: QuerySession):
    return (-s.priority, s.ordinal)


def _fair_key(s: QuerySession):
    # attributed seconds first; sessions that never entered a timed
    # region tie at 0 there, and their granted wall time breaks the tie
    return (s.attributed_s() / s.weight, s.service_s / s.weight,
            s.ordinal)


POLICIES = {"fifo": _fifo_key, "priority": _priority_key,
            "fair": _fair_key}


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

class QueryScheduler:
    """Admission-controlled concurrent query scheduler over one env::

        sched = QueryScheduler(env, policy="fair")
        a = sched.submit("tenant_a", qa, footprint_bytes=fa)
        b = sched.submit("tenant_b", qb, footprint_bytes=fb, weight=2.0)
        sched.run()                      # interleaves until all are done
        a.result, a.summary()

    ``budget_bytes`` overrides the ledger's budget for admission only;
    ``max_concurrency`` caps the sessions running at once.  :meth:`run`
    drives the baton on the calling thread and returns the sessions; a
    failed session carries its exception in ``.error``
    (``raise_errors=True`` re-raises the first)."""

    #: policies under which a higher-ranked arrival may preempt
    PREEMPTIVE_POLICIES = ("priority", "fair")

    def __init__(self, env, policy: str = "fair",
                 budget_bytes: int | None = None,
                 max_concurrency: int | None = None,
                 admission_timeout_s: float | None = None,
                 requeue_capacity: int | None = None,
                 history_safety_factor: float = 1.5,
                 fleet=None):
        if policy not in POLICIES:
            raise InvalidError(
                f"unknown scheduling policy {policy!r}; one of "
                f"{sorted(POLICIES)}")
        self.env = env
        self.policy = policy
        self._key = POLICIES[policy]
        self.budget_bytes = budget_bytes
        self.max_concurrency = max_concurrency
        #: admission deadline in seconds; None: read
        #: CYLON_TPU_TORCH_ADMISSION_TIMEOUT_S
        self.admission_timeout_s = admission_timeout_s
        #: preempt requeues allowed per run (None: any number)
        self.requeue_capacity = requeue_capacity
        #: the multiplier on a family's observed peak at admission
        self.history_safety_factor = float(history_safety_factor)
        #: an exec.fleet.ResizeController polled each loop turn
        self._fleet = fleet
        self.sessions: list[QuerySession] = []
        self._by_name: dict[str, QuerySession] = {}
        self._control = threading.Event()
        self._abort = False
        self._forced_admissions = 0
        self._scheduler_evictions = 0
        self._preempt_drained = 0
        self._preemptions = 0
        self._requeues = 0
        self._requeue_overflows = 0
        self._admission_timeouts = 0
        self._fleet_drains = 0
        self._fleet_drain = False
        #: set by a fleet drain: the world size to relaunch at (with
        #: CYLON_TPU_TORCH_RESUME=1)
        self.resize_target: int | None = None

    # -- submission --------------------------------------------------------
    def submit(self, name: str, fn, *, footprint_bytes: int = 0,
               priority: int = 0, weight: float = 1.0,
               tenant: str | None = None,
               kind: str = "query", preempt_budget: int = 2,
               shape_family: str | None = None) -> QuerySession:
        """Queue one query: ``fn`` (no arguments) runs on the session's
        thread under the baton, and its value lands in
        ``session.result``.  ``footprint_bytes`` is the estimate
        admission gates on.  ``kind="stream"`` marks a long-lived ingest
        loop, admitted and scheduled as a query is (counted as
        ``stream_sessions``)."""
        if name in self._by_name:
            raise InvalidError(f"duplicate session name {name!r}")
        sess = QuerySession(name, fn, len(self.sessions),
                            footprint_bytes=footprint_bytes,
                            priority=priority, weight=weight, tenant=tenant,
                            kind=kind, preempt_budget=preempt_budget,
                            shape_family=shape_family)
        self.sessions.append(sess)
        self._by_name[name] = sess
        return sess

    # -- the baton loop ----------------------------------------------------
    def run(self, raise_errors: bool = False) -> list[QuerySession]:
        global _ACTIVE
        if _ACTIVE is not None:
            raise InvalidError(
                "a QueryScheduler is already serving this process")
        if not self.sessions:
            return []
        self._abort = False   # a finished run's latch must not fail
        #                       sessions submitted for the next one
        _ACTIVE = self
        try:
            self._loop()
        finally:
            # abort: parked sessions wake, see _abort and raise at their
            # yield point; none may run on without the baton
            self._abort = True
            for s in self.sessions:
                if s.state == RUNNING:
                    s._grant.set()
            for s in self.sessions:
                if s._thread is not None:
                    s._thread.join(timeout=60.0)
            _ACTIVE = None
        # one outcome count per finished session and lifetime
        for s in self.sessions:
            if s.state in (DONE, FAILED) and not s._outcome_counted:
                s._outcome_counted = True
                _metrics.counter(f"sched_outcome_{s.outcome()}").inc()
        if raise_errors:
            for s in self.sessions:
                if s.error is not None:
                    raise s.error
        return list(self.sessions)

    def _loop(self) -> None:
        while True:
            # the periodic metrics snapshot (CYLON_TPU_TORCH_METRICS_JSON)
            _metrics.maybe_write_snapshot()
            if self._draining() or self._fleet_drain:
                # a SIGTERM with checkpoints armed, or a fleet resize: no
                # new admissions, pending sessions fail typed-resumable,
                # running ones drain at their own boundaries
                self._drain_pending()
            else:
                self._requeue_preempted()
                self._admit_pending()
                if self._fleet is not None and not self._fleet_drain:
                    self._fleet.maybe_resize(self)
            running = [s for s in self.sessions if s.state == RUNNING]
            if not running:
                if any(s.state == PENDING for s in self.sessions):
                    # nothing runs and the head cannot fit: serial
                    # execution instead of starvation
                    self._force_admit()
                    continue
                return
            self._grant_slice(self._pick(running))

    # -- the preemption-grace drain ----------------------------------------
    def _draining(self) -> bool:
        """Whether a SIGTERM drain gates new admissions: grace and
        checkpoints armed and a notice received; across processes the
        notice is voted (``recovery.drain_consensus``), so a SIGTERM to
        one process drains them all."""
        from . import checkpoint, preempt
        if not (preempt.armed() and checkpoint.enabled()):
            return False
        if self._multi():
            from . import recovery
            return recovery.drain_consensus(self.env, preempt.requested())
        return preempt.requested()

    def _drain_pending(self) -> None:
        from . import checkpoint, recovery
        for s in self.sessions:
            if s.state != PENDING:
                continue
            token = checkpoint.flush_for_abort(f"sched.{s.name}")
            recovery._record(f"sched.{s.name}", "preempt", "drain_pending")
            s.state = FAILED
            s.error = ResumableAbort(
                f"preemption drain: session {s.name} was queued but never "
                "admitted — nothing committed, a rerun with "
                f"CYLON_TPU_TORCH_RESUME=1 recomputes it (resume token: "
                f"{token})", token=token)
            s.finished_s = time.perf_counter()
            self._preempt_drained += 1
            _metrics.counter("sched_preempt_drained").inc()

    # -- admission ---------------------------------------------------------
    def _budget(self) -> int:
        from . import memory
        if self.budget_bytes is not None:
            return int(self.budget_bytes)
        return memory.budget_bytes(self.env)

    def _admission_footprint(self, sess: QuerySession) -> int:
        """The declared footprint, clamped by the shape family's observed
        peak: min(declared, observed peak x safety factor).  Each process
        observes its own peaks, so across processes a session with a
        shape family charges the voted (max) clamp, and every process
        admits it alike; a session without one charges its declared
        footprint everywhere, with no vote."""
        if sess.shape_family is None:
            return sess.footprint_bytes
        peak = observed_peak(sess.shape_family)
        fp = sess.footprint_bytes if peak is None else min(
            sess.footprint_bytes, int(peak * self.history_safety_factor))
        if self._multi():
            from . import recovery
            fp = recovery.footprint_consensus(self.env, fp)
        return fp

    def _fits(self, sess: QuerySession) -> bool:
        """The running sessions' declared footprints plus the
        candidate's fit the budget.  Declared, not realized: admission
        comes before a query allocates anything, and an estimate that
        was wrong is handled where the allocation happens (the ledger's
        own admission evicts)."""
        b = self._budget()
        if b <= 0:
            return True
        committed = sum(self._admission_footprint(s) for s in self.sessions
                        if s.state == RUNNING)
        return committed + self._admission_footprint(sess) <= b

    def _multi(self) -> bool:
        """Several processes vote on the schedule: a multi-process world
        (one process driving every rank of a world decides alone)."""
        return bool(getattr(self.env, "multi_process", False))

    def _evict_for(self, sess: QuerySession) -> None:
        """Clear realized residue before a session starts: evict the
        coldest spillable registrations (LRU over the shared ledger)
        until its footprint fits the budget."""
        from . import memory, recovery
        from .. import config
        if not config.SPILL_ENABLED:
            return
        b = self._budget()
        if b <= 0:
            return
        want = memory.ledger().evict_count_for(
            self._admission_footprint(sess), b)
        if self._multi():
            want = recovery.count_consensus(self.env, want)
        if want <= 0:
            return
        evicted = memory.ledger().evict_n(want)
        if evicted:
            self._scheduler_evictions += len(evicted)
            _metrics.counter("sched_evictions").inc(len(evicted))
            from ..utils.logging import log
            log.info("scheduler: evicted %s to admit session %s "
                     "(footprint %d B)", evicted, sess.name,
                     sess.footprint_bytes)

    def _admit_pending(self) -> None:
        self._expire_admissions()
        while True:
            pend = [s for s in self.sessions if s.state == PENDING]
            if not pend:
                return
            running = [s for s in self.sessions if s.state == RUNNING]
            cand = min(pend, key=self._key)
            if self._multi() and any(s.requeues for s in pend):
                # a requeued tenant's fair-share clocks are wall time and
                # differ between processes, so the head-of-line pick is
                # voted (the running pick's wire); sessions that never
                # ran tie at 0 and need no vote
                cand = self._agreed(cand, pend, "scheduler.admit",
                                    "pending")
            if (self.max_concurrency is not None
                    and len(running) >= self.max_concurrency):
                self._maybe_preempt(cand, running)
                self._note_wait(pend)
                return
            if not self._fits(cand):
                # head of line: no overtaking; a higher-ranked candidate
                # may instead drain the lowest-ranked running tenant
                self._maybe_preempt(cand, running)
                self._note_wait([cand])
                return
            self._evict_for(cand)
            self._start(cand)

    # -- the admission deadline --------------------------------------------
    def _admission_timeout(self) -> float | None:
        """The deadline: the constructor's, else
        ``CYLON_TPU_TORCH_ADMISSION_TIMEOUT_S``; None or <= 0: none."""
        t = self.admission_timeout_s
        if t is None:
            raw = os.environ.get("CYLON_TPU_TORCH_ADMISSION_TIMEOUT_S")
            if not raw:
                return None
            try:
                t = float(raw)
            except ValueError:
                return None
        return t if t > 0 else None

    def _expire_admissions(self) -> None:
        """Fail, typed, every pending session that waited past the
        deadline."""
        t = self._admission_timeout()
        if t is None:
            return
        waiting = [s for s in self.sessions
                   if s.state == PENDING and s._wait_mark is not None]
        if not waiting:
            return
        now = time.perf_counter()
        expired = [s for s in waiting if now - s._wait_mark > t]
        if self._multi():
            # wall clocks differ between processes: the max expired
            # ordinal is voted and that one session expires this turn
            # (the loop comes back for the rest); the vote is entered
            # whenever a deadline is set and a session waits, both the
            # same on every process
            from . import recovery
            want = max((s.ordinal + 1 for s in expired), default=0)
            agreed = recovery.count_consensus(self.env, want)
            expired = [s for s in waiting if s.ordinal + 1 == agreed]
        for s in expired:
            waited = now - s._wait_mark
            s.admission_wait_s += waited
            s._wait_mark = None
            s.state = FAILED
            from ..status import AdmissionTimeoutError
            s.error = AdmissionTimeoutError(
                f"session {s.name} exceeded the admission deadline "
                f"({t:g}s) after waiting {waited:.3f}s at head of line "
                "— failing typed instead of waiting unboundedly "
                "(CYLON_TPU_TORCH_ADMISSION_TIMEOUT_S / "
                "admission_timeout_s)", session=s.name, waited_s=waited)
            s.finished_s = time.perf_counter()
            self._admission_timeouts += 1
            _metrics.counter("sched_admission_timeouts").inc()
            from ..utils.logging import log
            log.warning("scheduler: admission deadline (%gs) expired for "
                        "session %s after %.3fs", t, s.name, waited)

    # -- preemption --------------------------------------------------------
    def _pick_victim(self, cand: QuerySession,
                     running: list[QuerySession]) -> QuerySession | None:
        """The lowest-ranked running query that is not draining, is
        strictly outranked by ``cand``, has preemption budget left and
        committed pieces since its last preemption (a tenant that made no
        progress is not preempted again, or arrivals could starve it)."""
        victims = [
            s for s in running
            if s.kind == "query" and s._drain_mode is None
            and self._key(cand) < self._key(s)
            and s.preemptions < s.preempt_budget
            and (s.preemptions == 0
                 or s.pieces_committed > s._progress_mark)
        ]
        if not victims:
            return None
        return max(victims, key=self._key)

    def _maybe_preempt(self, cand: QuerySession,
                       running: list[QuerySession]) -> bool:
        """Preempt for a blocked higher-ranked candidate: only under a
        preemptive policy with checkpoints armed (the drain rides the
        checkpoint boundaries).  The victim is voted
        (``recovery.preempt_consensus``) before it is flagged."""
        if self.policy not in self.PREEMPTIVE_POLICIES:
            return False
        from . import checkpoint
        if not checkpoint.enabled():
            return False
        from . import recovery
        from ..status import RankDesyncError
        victim = self._pick_victim(cand, running)
        want = 0 if victim is None else victim.ordinal + 1
        agreed = recovery.preempt_consensus(self.env, want)
        if not agreed:
            return False
        victim = next((s for s in running if s.ordinal == agreed - 1),
                      None)
        if victim is None:
            raise RankDesyncError(
                f"preempt consensus chose session ordinal {agreed - 1}, "
                "which is not running on this rank", site="sched.preempt")
        self._begin_preempt_drain(victim, cand)
        return True

    def _begin_preempt_drain(self, victim: QuerySession,
                             cand: QuerySession) -> None:
        """Flag the victim: its next ``checkpoint.drain_requested`` poll
        commits and raises ResumableAbort, and the requeue pass makes it
        PENDING again."""
        victim._drain_mode = "preempt"
        victim._progress_mark = victim.pieces_committed
        self._preemptions += 1
        _metrics.counter("sched_preemptions").inc()
        _trace.instant("sched.preempt", session=victim.name,
                       by=cand.name, policy=self.policy)
        from ..utils.logging import log
        log.info("scheduler: preempting session %s at its next "
                 "checkpoint boundary to admit %s (policy=%s)",
                 victim.name, cand.name, self.policy)

    def _requeue_preempted(self) -> None:
        """Turn finished preempt drains back into PENDING sessions whose
        next run resumes in process past their committed pieces; past
        the requeue capacity the session fails with RequeueOverflowError
        (the drain's ResumableAbort on ``__cause__``)."""
        for s in self.sessions:
            if s._drain_mode is None:
                continue
            if s.state == DONE:
                # finished before reaching a boundary: nothing to requeue
                s._drain_mode = None
                continue
            if s.state != FAILED:
                continue   # still draining
            if s._drain_mode == "fleet":
                continue   # stays failed-resumable for the relaunch
            if not isinstance(s.error, ResumableAbort):
                s._drain_mode = None   # a real failure mid-drain
                continue
            if (self.requeue_capacity is not None
                    and self._requeues >= self.requeue_capacity):
                from ..status import RequeueOverflowError
                err = RequeueOverflowError(
                    f"session {s.name} drained resumably but the "
                    f"requeue capacity ({self.requeue_capacity}) is "
                    "exhausted — relaunch with CYLON_TPU_TORCH_RESUME=1 "
                    "to resume it", session=s.name)
                err.__cause__ = s.error
                s.error = err
                s._drain_mode = None
                self._requeue_overflows += 1
                _metrics.counter("sched_requeue_overflows").inc()
                continue
            from . import checkpoint
            checkpoint.reset_session_stages(s.name)
            s._drain_mode = None
            s.preemptions += 1
            s.requeues += 1
            s._progress_mark = s.pieces_committed
            s._resume_pending = True
            s.state = PENDING
            s.error = None
            s.finished_s = None
            s._thread = None
            s._grant = threading.Event()
            self._requeues += 1
            _metrics.counter("sched_requeues").inc()
            _trace.instant("sched.requeue", session=s.name)

    # -- the fleet drain (exec/fleet.py) -----------------------------------
    def _begin_fleet_drain(self, target_world: int, reason: str) -> None:
        """Every running tenant drains at its next checkpoint boundary
        (no requeue: the resumes happen in the relaunched process),
        pending tenants fail typed-resumable, and ``resize_target`` says
        the world to relaunch at."""
        if self._fleet_drain:
            return
        self._fleet_drain = True
        self.resize_target = int(target_world)
        self._fleet_drains += 1
        _metrics.counter("sched_fleet_drains").inc()
        for s in self.sessions:
            if s.state == RUNNING and s._drain_mode is None:
                s._drain_mode = "fleet"
        _trace.instant("sched.fleet_drain", target_world=target_world,
                       reason=reason)
        from ..utils.logging import log
        log.warning("scheduler: elastic fleet drain engaged (%s) — "
                    "draining all tenants at their boundaries, relaunch "
                    "at world=%d with CYLON_TPU_TORCH_RESUME=1",
                    reason, target_world)

    def _note_wait(self, sessions) -> None:
        now = time.perf_counter()
        for s in sessions:
            if s._wait_mark is None:
                s._wait_mark = now
                s.admission_waits += 1

    def _force_admit(self) -> None:
        pend = [s for s in self.sessions if s.state == PENDING]
        cand = min(pend, key=self._key)
        if self._multi() and any(s.requeues for s in pend):
            # the admission pick's vote, for the same reason
            cand = self._agreed(cand, pend, "scheduler.admit", "pending")
        self._forced_admissions += 1
        _metrics.counter("sched_forced_admissions").inc()
        _metrics.counter("sched_admission_force_serial").inc()
        self._start(cand)
        from ..utils.logging import log
        log.warning("scheduler: nothing running and session %s "
                    "(footprint %d B) cannot fit the budget — force-"
                    "admitting; execution degrades to the ledger's own "
                    "spill tier", cand.name, cand.footprint_bytes)

    def _start(self, sess: QuerySession) -> None:
        now = time.perf_counter()
        if sess._wait_mark is not None:
            sess.admission_wait_s += now - sess._wait_mark
            sess._wait_mark = None
        sess.state = RUNNING
        sess.started_s = now
        t = threading.Thread(target=self._session_body, args=(sess,),
                             name=f"cylon-session-{sess.name}", daemon=True)
        sess._thread = t
        t.start()

    # -- the baton ---------------------------------------------------------
    def _session_body(self, sess: QuerySession) -> None:
        from ..utils import timing
        from . import recovery
        recovery.set_session(sess.name, sess.ordinal)
        if getattr(self.env, "on_cuda", False):
            # a new thread's current device is device 0 and its current
            # stream the default stream: name the env's device, and run
            # on its default stream like every other tenant
            import torch
            torch.cuda.set_device(self.env.device)
        sess._grant.wait()
        sess._grant.clear()
        sess._slice_t0 = time.perf_counter()
        try:
            if self._abort:
                from ..status import ExecutionError
                raise ExecutionError(
                    f"serving scheduler aborted before session "
                    f"{sess.name} ran")
            with timing.attribution_scope(sess.name) as scope:
                sess.timing = scope
                sess.result = sess.fn()
            sess.state = DONE
        except BaseException as e:  # noqa: BLE001 — isolated per session
            sess.error = e
            sess.state = FAILED
        finally:
            sess.service_s += time.perf_counter() - sess._slice_t0
            sess.slices += 1
            sess.finished_s = time.perf_counter()
            recovery.set_session(None, None)
            self._control.set()

    def _yield_turn(self, sess: QuerySession) -> None:
        """The session's side of the baton (on its thread).  When the
        scheduler aborts, the session fails at its yield point instead of
        running on without the baton."""
        from ..status import ExecutionError
        if self._abort:
            raise ExecutionError(
                f"serving scheduler aborted while session {sess.name} "
                "was in flight")
        t_park = time.perf_counter()
        sess.service_s += t_park - sess._slice_t0
        sess.slices += 1
        self._control.set()
        sess._grant.wait()
        sess._grant.clear()
        sess._slice_t0 = time.perf_counter()
        # the parked time is co-tenants' work: regions spanning this
        # yield net it out of this session's table and fair-share clock
        from ..utils import timing
        timing.exclude_from_scope(sess._slice_t0 - t_park)
        _trace.complete("sched.park", t_park, session=sess.name)
        if self._abort:
            raise ExecutionError(
                f"serving scheduler aborted while session {sess.name} "
                "was parked at a yield point")

    def _pick(self, running: list[QuerySession]) -> QuerySession:
        sess = min(running, key=self._key)
        if self._multi():
            # fair-share clocks are wall time and differ between
            # processes: the pick is voted (max ordinal wins)
            sess = self._agreed(sess, running, "scheduler.pick", "running")
        return sess

    def _agreed(self, mine: QuerySession, among: list[QuerySession],
                site: str, what: str) -> QuerySession:
        """The session every process takes: the max of the processes'
        choices' ordinals (``recovery.count_consensus``).  An agreed
        ordinal that is not ``what`` here means the session states
        diverged: ``RankDesyncError``."""
        from . import recovery
        from ..status import RankDesyncError
        agreed = recovery.count_consensus(self.env, mine.ordinal)
        for s in among:
            if s.ordinal == agreed:
                return s
        raise RankDesyncError(
            f"{site} consensus chose session ordinal {agreed}, which is "
            f"not {what} in this process — session states diverged",
            site=site)

    def _grant_slice(self, sess: QuerySession) -> None:
        self._control.clear()
        _trace.instant("sched.grant", session=sess.name,
                       policy=self.policy)
        sess._grant.set()
        while not self._control.wait(timeout=60.0):
            t = sess._thread
            if t is None or not t.is_alive():
                if sess.state == RUNNING:   # died without signaling
                    sess.state = FAILED
                    sess.error = RuntimeError(
                        f"session {sess.name} thread died mid-slice")
                return

    # -- reporting ---------------------------------------------------------
    def stats(self) -> dict:
        """The serving tier's counters (each session's own are in its
        ``summary()``)."""
        from . import compiler, memory
        mem = memory.stats()
        comp = compiler.stats()
        outcomes: dict[str, int] = {}
        for s in self.sessions:
            if s.state in (DONE, FAILED):
                o = s.outcome()
                outcomes[o] = outcomes.get(o, 0) + 1
        return {
            "policy": self.policy,
            "sessions": len(self.sessions),
            "stream_sessions": sum(1 for s in self.sessions
                                   if s.kind == "stream"),
            "completed": sum(1 for s in self.sessions if s.state == DONE),
            "failed": sum(1 for s in self.sessions if s.state == FAILED),
            "admission_waits": sum(s.admission_waits
                                   for s in self.sessions),
            "admission_wait_s": round(sum(s.admission_wait_s
                                          for s in self.sessions), 4),
            "forced_admissions": self._forced_admissions,
            "admission_force_serial": self._forced_admissions,
            "admission_timeouts": self._admission_timeouts,
            "scheduler_evictions": self._scheduler_evictions,
            "preempt_drained": self._preempt_drained,
            "preemptions": self._preemptions,
            "requeues": self._requeues,
            "requeue_overflows": self._requeue_overflows,
            "fleet_drains": self._fleet_drains,
            "resize_target": self.resize_target,
            "outcomes": outcomes,
            "resumable_aborts": sum(1 for s in self.sessions
                                    if isinstance(s.error, ResumableAbort)),
            "cross_session_evictions": mem["cross_session_evictions"],
            "spill_events": mem["spill_events"],
            "slices": sum(s.slices for s in self.sessions),
            "compile": {k: comp[k] for k in
                        ("programs_live", "cache_hits", "cache_misses",
                         "cache_evictions", "compile_seconds")},
        }
