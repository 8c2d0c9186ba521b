"""Trace timeline and flight recorder (port of ``cylon_tpu/obs/trace.py``):
a bounded ring of span and instant events, exported as Chrome-trace
(Perfetto) JSON.

Armed (``CYLON_TPU_TORCH_TRACE=path`` at import, or :func:`arm`), the
recorder is utils/timing's trace sink: every region lands as a complete
span ("X"), every ``bump``/``add_bytes`` as an instant ("i"); the
pipelined join adds a dispatch span per piece (``pipe.piece_dispatch``)
and the ``GroupBySink`` an async pair per chunk (``sink.chunk_inflight``,
"b"/"e"), and the recovery tier its consensus outcomes.  Every event
carries the active attribution scope's tag.

On a preemption drain, the final rung's abort flush
(exec/checkpoint.flush_for_abort) or an injected kill, :func:`postmortem`
dumps the last :data:`POSTMORTEM_EVENTS` events to
``TRACE_POSTMORTEM.json`` beside the checkpoint manifests.

Unarmed, timing pays one list load per region and nothing else runs or
writes.  Armed, events are tuples in a preallocated ring (capacity
``CYLON_TPU_TORCH_TRACE_EVENTS``, default 65536); the export runs once,
at :func:`export` or at exit.  A failed export or post-mortem write
raises ``ExecutionError``: a trace the operator asked for never vanishes
silently.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time

__all__ = ["arm", "disarm", "armed", "recorder", "instant", "complete",
           "async_begin", "async_end", "export", "postmortem", "autoarm"]

#: the active recorder
_REC: list = [None]


def armed() -> bool:
    return _REC[0] is not None


def recorder() -> "TraceRecorder | None":
    return _REC[0]


class TraceRecorder:
    """Bounded ring of ``(ts_us, dur_us, ph, name, tid, session, args)``
    events: ``dur_us`` None for instants, ``ph`` the Chrome-trace phase
    ("X", "i", "b"/"e"), timestamps in microseconds from the arming
    (``perf_counter``)."""

    __slots__ = ("capacity", "path", "t0", "_buf", "_n", "_lock",
                 "_tids", "_exported")

    def __init__(self, capacity: int = 65536, path: str | None = None):
        self.capacity = max(int(capacity), 8)
        self.path = path
        self.t0 = time.perf_counter()
        self._buf: list = [None] * self.capacity
        self._n = 0
        self._lock = threading.Lock()
        self._tids: dict[int, tuple[int, str]] = {}
        self._exported = False

    # -- recording ---------------------------------------------------------
    def _now_us(self) -> int:
        return int((time.perf_counter() - self.t0) * 1e6)

    def _tid(self) -> int:
        ident = threading.get_ident()
        ent = self._tids.get(ident)
        if ent is None:
            with self._lock:
                ent = self._tids.setdefault(
                    ident, (len(self._tids),
                            threading.current_thread().name))
        return ent[0]

    def _session(self):
        from ..utils import timing
        sc = timing._scope()
        return sc.tag if sc is not None and sc.tag else None

    def _push(self, ev: tuple) -> None:
        with self._lock:
            self._buf[self._n % self.capacity] = ev
            self._n += 1

    def span(self, name: str, t0_s: float, dur_s: float,
             args: dict | None = None) -> None:
        """One complete span from ``perf_counter`` start ``t0_s``."""
        ts = int((t0_s - self.t0) * 1e6)
        self._push((ts, max(int(dur_s * 1e6), 1), "X", name, self._tid(),
                    self._session(), args))

    def instant(self, name: str, args: dict | None = None) -> None:
        self._push((self._now_us(), None, "i", name, self._tid(),
                    self._session(), args))

    def async_begin(self, name: str, aid: int,
                    args: dict | None = None) -> None:
        self._push((self._now_us(), None, "b", name, self._tid(),
                    self._session(), dict(args or (), id=int(aid))))

    def async_end(self, name: str, aid: int) -> None:
        self._push((self._now_us(), None, "e", name, self._tid(),
                    self._session(), {"id": int(aid)}))

    # -- reading -----------------------------------------------------------
    def events(self, last: int | None = None) -> list[tuple]:
        """The recorded events oldest first; ``last`` keeps the newest
        N."""
        with self._lock:
            if self._n <= self.capacity:
                out = list(self._buf[:self._n])
            else:
                cut = self._n % self.capacity
                out = self._buf[cut:] + self._buf[:cut]
        return out if last is None else out[-int(last):]

    @property
    def dropped(self) -> int:
        """Events that fell off the ring."""
        return max(self._n - self.capacity, 0)

    # -- export ------------------------------------------------------------
    def _pid(self) -> int:
        """The process's rank: 0 under one controller (the multi-card
        transport would give each process its rank)."""
        return 0

    def chrome_trace(self) -> dict:
        """The Chrome-trace / Perfetto JSON object of the ring."""
        pid = self._pid()
        events = []
        for _ident, (tid, tname) in sorted(self._tids.items(),
                                           key=lambda kv: kv[1][0]):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        for ts, dur, ph, name, tid, sess, args in self.events():
            ev: dict = {"name": name, "ph": ph, "ts": ts,
                        "pid": pid, "tid": tid}
            if ph == "X":
                ev["dur"] = dur
            elif ph == "i":
                ev["s"] = "t"
            elif ph in ("b", "e"):
                ev["cat"] = "piece"
                ev["id"] = (args or {}).get("id", 0)
            a = dict(args) if args else {}
            if sess is not None:
                a["session"] = sess
            if a:
                ev["args"] = a
            events.append(ev)
        events.sort(key=lambda e: e.get("ts", -1))
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "recorded_events": self._n}}


def arm(path: str | None = None, capacity: int | None = None
        ) -> TraceRecorder:
    """Arm the recorder (re-arming returns the live one, with ``path``
    updated) and install it as utils/timing's trace sink."""
    rec = _REC[0]
    if rec is not None:
        if path is not None:
            rec.path = path
        return rec
    if capacity is None:
        capacity = int(os.environ.get("CYLON_TPU_TORCH_TRACE_EVENTS",
                                      "65536"))
    rec = _REC[0] = TraceRecorder(capacity=capacity, path=path)
    from ..utils import timing
    timing._TRACE[0] = rec
    return rec


def disarm() -> None:
    _REC[0] = None
    from ..utils import timing
    timing._TRACE[0] = None


def autoarm() -> None:
    """Arm from ``CYLON_TPU_TORCH_TRACE=path`` (called at package import)
    with an export at exit.  Unset: one environment read."""
    path = os.environ.get("CYLON_TPU_TORCH_TRACE")
    if not path or armed():
        return
    arm(path=path)
    atexit.register(_atexit_export)


def _atexit_export() -> None:
    rec = _REC[0]
    if rec is not None and rec.path and not rec._exported:
        try:
            export()
        except Exception:  # noqa: BLE001 — exit path: never raise
            pass


# -- module-level conveniences (one list load unarmed) ----------------------

def instant(name: str, **args) -> None:
    rec = _REC[0]
    if rec is not None:
        rec.instant(name, args or None)


def complete(name: str, t0_s: float, **args) -> None:
    """Record a span begun at ``perf_counter()`` time ``t0_s``, ending
    now."""
    rec = _REC[0]
    if rec is not None:
        rec.span(name, t0_s, time.perf_counter() - t0_s, args or None)


def async_begin(name: str, aid: int, **args) -> None:
    rec = _REC[0]
    if rec is not None:
        rec.async_begin(name, aid, args or None)


def async_end(name: str, aid: int) -> None:
    rec = _REC[0]
    if rec is not None:
        rec.async_end(name, aid)


# -- export and post-mortem --------------------------------------------------

def export(path: str | None = None) -> str | None:
    """Write the Chrome-trace JSON to ``path`` (default: the armed path);
    returns the path, or None unarmed or pathless.  ``obs.export`` is a
    fault-injection site; a write that still fails after the bounded
    transient retry (exec/recovery.retry_io) raises ``ExecutionError``."""
    rec = _REC[0]
    if rec is None:
        return None
    path = path or rec.path
    if not path:
        return None
    from ..exec import recovery
    recovery.maybe_inject("obs.export")

    def _write() -> None:
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(rec.chrome_trace(), f)
        os.replace(tmp, path)

    try:
        recovery.retry_io(_write, "obs.export")
    except OSError as e:
        from ..status import ExecutionError
        raise ExecutionError(
            f"trace export to {path!r} failed: {e}") from e
    rec._exported = True
    return path


#: newest events carried by a post-mortem dump
POSTMORTEM_EVENTS = 256


def postmortem(reason: str, dir_path: str | None = None,
               n: int = POSTMORTEM_EVENTS) -> str | None:
    """Dump the last ``n`` events, the last-region breadcrumb and the
    scope tag to ``TRACE_POSTMORTEM.json`` in ``dir_path`` (default: the
    checkpoint root when armed, else the trace path's directory).
    Returns the path written, or None unarmed or with no directory.  A
    failed write raises ``ExecutionError``."""
    rec = _REC[0]
    if rec is None:
        return None
    if dir_path is None:
        from ..exec import checkpoint
        dir_path = checkpoint.ckpt_dir()
        if dir_path is None and rec.path:
            dir_path = os.path.dirname(os.path.abspath(rec.path))
    if not dir_path:
        return None
    from ..utils import timing
    payload = {
        "reason": reason,
        "pid": os.getpid(),
        "last_region": timing.last_region(),
        "session": rec._session(),
        "dropped_events": rec.dropped,
        "events": [
            {"ts_us": ts, "dur_us": dur, "ph": ph, "name": name,
             "tid": tid, "session": sess, "args": args}
            for ts, dur, ph, name, tid, sess, args in rec.events(last=n)],
    }
    r = rec._pid()
    fname = ("TRACE_POSTMORTEM.json" if r == 0
             else f"TRACE_POSTMORTEM.rank{r}.json")
    path = os.path.join(dir_path, fname)
    try:
        os.makedirs(dir_path, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f)
    except OSError as e:
        from ..status import ExecutionError
        raise ExecutionError(
            f"trace post-mortem to {path!r} failed: {e}") from e
    return path
