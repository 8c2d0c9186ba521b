"""One tenant's query session: the unit the serving scheduler admits,
interleaves and audits (port of ``cylon_tpu/exec/session.py``;
:mod:`cylon_tpu_torch.exec.scheduler`).

A :class:`QuerySession` wraps a query thunk (any callable over the shared
env: a TPC-H query, a pipelined join into a sink) with what the serving
tier needs to run it beside other tenants:

* admission inputs: the pack-time ``footprint_bytes`` estimate checked
  against the budget before the session may start, and the
  ``priority``/``weight`` the policies read;
* isolation state: the session's own
  :class:`~cylon_tpu_torch.utils.timing.AttributionScope` (a private
  phase table) and its recovery identity
  (:func:`cylon_tpu_torch.exec.recovery.set_session` on its thread:
  tagged events, ``@session`` fault specs, namespaced votes, its own
  checkpoint stage sequence);
* serving metrics: admission waits and seconds, slices granted, service
  seconds, latency.

Each session runs on its own thread, but one session at a time holds the
scheduler's baton between interleave points, so every operator sees the
single-threaded engine it was written for.
"""

from __future__ import annotations

import threading
import time

#: session lifecycle states
PENDING = "pending"      # submitted, not yet admitted
RUNNING = "running"      # admitted; its thread is live (maybe parked)
DONE = "done"            # fn returned; ``result`` holds its value
FAILED = "failed"        # fn raised; ``error`` holds the exception


class QuerySession:
    """One submitted query's handle, made by
    :meth:`cylon_tpu_torch.exec.scheduler.QueryScheduler.submit`.  The
    scheduler owns its state transitions; callers read it."""

    #: ``query`` runs to completion; ``stream`` is a long-lived ingest
    #: loop that yields at its own points (its callers come with the
    #: streaming tier)
    KINDS = ("query", "stream")

    def __init__(self, name: str, fn, ordinal: int, *,
                 footprint_bytes: int = 0, priority: int = 0,
                 weight: float = 1.0, tenant: str | None = None,
                 kind: str = "query", preempt_budget: int = 2,
                 shape_family: str | None = None):
        if "/" in name or name != name.strip() or not name:
            raise ValueError(
                f"session name {name!r} must be a non-empty path-safe "
                "token (it namespaces checkpoint stage directories)")
        if kind not in self.KINDS:
            raise ValueError(
                f"session kind {kind!r} must be one of {self.KINDS}")
        self.name = name
        self.kind = kind
        self.fn = fn
        self.ordinal = int(ordinal)
        self.footprint_bytes = int(footprint_bytes)
        self.priority = int(priority)
        self.weight = float(weight)
        if self.weight <= 0:
            raise ValueError("session weight must be > 0")
        self.tenant = tenant or name
        #: how often this session may be preempted; past it, never again
        self.preempt_budget = int(preempt_budget)
        #: admission shape family: with a recorded peak for it
        #: (``obs.explain_analyze(family=...)``) admission charges
        #: min(declared, observed peak x safety factor)
        self.shape_family = shape_family
        self.state = PENDING
        self.result = None
        self.error: BaseException | None = None
        #: the private phase table (utils.timing.AttributionScope), set
        #: when the session's thread starts
        self.timing = None
        # serving metrics
        self.admission_waits = 0
        self.admission_wait_s = 0.0
        self.bytes_admitted = 0    # through scheduler.admit_allocation
        self.slices = 0
        self.service_s = 0.0       # granted-slice wall time
        self.submitted_s = time.perf_counter()
        self.started_s: float | None = None
        self.finished_s: float | None = None
        # preemption and requeue accounting (the scheduler's)
        self.preemptions = 0       # completed preempt-drain cycles
        self.requeues = 0
        self.pieces_committed = 0  # checkpoint pieces committed
        # the baton (the scheduler's)
        self._thread: threading.Thread | None = None
        self._grant = threading.Event()
        self._slice_t0 = 0.0
        self._wait_mark: float | None = None  # admission wait start
        #: None, "preempt" (drain, then requeue) or "fleet" (drain, stay
        #: failed-resumable for a relaunch): polled by
        #: checkpoint.drain_requested at the session's piece boundaries
        self._drain_mode: str | None = None
        #: pieces_committed at the last preemption (the no-progress guard)
        self._progress_mark = 0
        #: a requeued session's next fn run resumes in process
        #: (checkpoint.resume_requested reads it on the session's thread)
        self._resume_pending = False
        self._outcome_counted = False

    # -- derived metrics ---------------------------------------------------
    @property
    def latency_s(self) -> float | None:
        """Submit-to-finish wall seconds (None while unfinished)."""
        if self.finished_s is None:
            return None
        return self.finished_s - self.submitted_s

    def attributed_s(self) -> float:
        """Seconds of the session's timed regions (its scope), the fair
        policy's clock; granted-slice wall time before the scope
        exists."""
        if self.timing is not None:
            return self.timing.total_seconds()
        return self.service_s

    def outcome(self) -> str:
        """``completed``, ``preempted_requeued`` (finished after at least
        one preemption), ``drained_resumable`` (failed with a
        ResumableAbort: committed work survives a relaunch),
        ``failed_typed`` or ``failed_untyped``; an unfinished session
        reports its state."""
        from ..status import CylonError, ResumableAbort
        if self.state == DONE:
            return "preempted_requeued" if self.preemptions else "completed"
        if self.state == FAILED:
            if isinstance(self.error, ResumableAbort):
                return "drained_resumable"
            if isinstance(self.error, CylonError):
                return "failed_typed"
            return "failed_untyped"
        return self.state

    # -- isolation audits --------------------------------------------------
    def recovery_events(self) -> list[dict]:
        """The recovery events recorded under this session's tag (empty
        for a clean run; a co-tenant's ladder never shows here)."""
        from . import recovery
        return recovery.events_for_session(self.name)

    def phase_snapshot(self) -> dict:
        """The session's private phase table, ``{name: seconds}`` as
        ``utils.timing.snapshot`` gives it, or {} before it started."""
        return self.timing.snapshot() if self.timing is not None else {}

    def summary(self) -> dict:
        """The serving metrics of this session."""
        return {
            "name": self.name, "tenant": self.tenant, "state": self.state,
            "kind": self.kind,
            "priority": self.priority, "weight": self.weight,
            "footprint_bytes": self.footprint_bytes,
            "admission_waits": self.admission_waits,
            "admission_wait_s": round(self.admission_wait_s, 4),
            "bytes_admitted": self.bytes_admitted,
            "slices": self.slices,
            "preemptions": self.preemptions,
            "requeues": self.requeues,
            "pieces_committed": self.pieces_committed,
            "outcome": self.outcome(),
            "service_s": round(self.service_s, 4),
            "latency_s": (round(self.latency_s, 4)
                          if self.latency_s is not None else None),
            "recovery_events": self.recovery_events(),
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"QuerySession({self.name!r}, state={self.state}, "
                f"slices={self.slices})")
