"""Per-phase timers (port of ``cylon_tpu/utils/timing.py``).

:func:`region` accumulates host seconds per named phase in a process-wide
table while timing is on (``CYLON_TPU_TORCH_TIMING`` = ``async`` or
``block``, or :func:`enable`); off, it costs one flag read and one store
(the last-region breadcrumb, :func:`last_region`).  Device work is queued
asynchronously, so an ``async`` region records the host time to QUEUE its
work; ``block`` mode waits for the device at the end of every region,
which gives each phase its device time but serializes the phases'
overlap — use it for an attribution run, not a timed one.
:func:`maybe_block` waits for a tensor's device in ``block`` mode only,
and :func:`sync_region` times a deliberate host wait under ``name +
".block"``, so :func:`split_snapshot` can split a phase into its dispatch
and its wait.  :func:`bump` counts an event and :func:`add_bytes`
attributes host<->device bytes to a phase, whatever the mode.

:func:`attribution_scope` opens a private phase table for the calling
thread: inside it every region is timed (whatever the mode), bumps and
bytes land in it too, and :func:`last_region` answers from it.  The
process-wide table keeps accumulating as before.
:func:`exclude_from_scope` nets seconds that were not this thread's work
(a serving session parked at its baton) out of both tables, and
:meth:`AttributionScope.absorb` merges a scope into another (the plan
profiler's node scopes, obs/plan.py).

The bytes (``timing_bytes_<name>``) and the event counts
(``timing_event_<name>``) live in the metrics registry
(obs/metrics.py), whose snapshot carries the phase table as
``{"phases": detail()}``; with the flight recorder armed (obs/trace.py)
every region becomes a span and every bump and byte count an instant.

Regions by layer: ``shuffle.hash``/``shuffle.exchange`` (the exchange),
``join.*`` and ``pipe.*`` (the joins; ``pipe.scan_join`` and
``pipe.consume`` per batch of a streamed scan join), ``groupby.*``,
``sort.*`` (with ``sort.string_lanes``, the host-side lanes of a hashed
string key), ``setop.flags``/``unique.flags`` (a set op's or unique's
dense rank, flags and count pull), ``setop.materialize``/
``unique.materialize`` (its compaction), ``repart.targets`` (a
repartition's destinations), and the spill tier's ``spill.evict``,
``spill.upload``, ``disk.write`` and ``disk.read`` (exec/memory.py, each
with its bytes).  The retry ladder counts every recovery event as
``recovery.<site>.<kind>.<action>`` (exec/recovery.py), in
:func:`counts` and in :func:`snapshot`'s keys.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

#: None (off), "async" or "block"
_MODE = [os.environ.get("CYLON_TPU_TORCH_TIMING") or None]
#: name -> [total_seconds, call_count]
_ACCUM: dict[str, list] = {}
#: the most recently entered region ("" before the first)
_LAST_REGION = [""]
#: per-thread stack of open attribution scopes; ``.excluded`` holds the
#: thread's cumulative excluded seconds (:func:`exclude_from_scope`)
_SCOPE_TLS = threading.local()
#: the flight recorder when armed (obs/trace.arm installs it): one list
#: load per region unarmed
_TRACE: list = [None]

#: snapshot-key suffix of a deliberate host wait (sync_region)
BLOCK_SUFFIX = ".block"


def enable(mode: str | None) -> None:
    """Set the timing mode: None, ``"async"`` or ``"block"``."""
    if mode not in (None, "async", "block"):
        raise ValueError(f"timing mode {mode!r}")
    _MODE[0] = mode


class AttributionScope:
    """One thread's private phase table (:func:`attribution_scope`)."""

    __slots__ = ("tag", "last", "_accum", "_bytes", "_excluded")

    def __init__(self, tag: str = ""):
        self.tag = tag
        self.last = ""
        self._accum: dict[str, list] = {}
        self._bytes: dict[str, int] = {}
        #: seconds excluded while this scope was innermost
        self._excluded = 0.0

    def _add(self, name: str, dt: float, n: int = 1) -> None:
        acc = self._accum.setdefault(name, [0.0, 0])
        acc[0] += dt
        acc[1] += n

    def _add_bytes(self, name: str, nbytes: int) -> None:
        self._bytes[name] = self._bytes.get(name, 0) + int(nbytes)
        self._accum.setdefault(name, [0.0, 0])

    def total_seconds(self) -> float:
        return sum(v[0] for v in self._accum.values())

    def absorb(self, other: "AttributionScope") -> None:
        """Merge ``other``'s table into this one: a plan node's scope
        shadows an enclosing scope while the node runs, and its table
        joins the enclosing one at the node's exit, so that scope sees
        the same seconds with profiling on or off (obs/plan.py)."""
        for k, v in other._accum.items():
            self._add(k, v[0], v[1])
        for k, b in other._bytes.items():
            self._add_bytes(k, b)

    def detail(self) -> dict:
        """{name: {"s": seconds, "n": calls[, "b": bytes]}}."""
        return _detail(self._accum, self._bytes)

    def snapshot(self) -> dict:
        """{name: seconds}, as the module's :func:`snapshot`."""
        return {k: v[0] for k, v in self._accum.items()}

    def counts(self) -> dict:
        return {k: v[1] for k, v in self._accum.items()}

    def bytes(self) -> dict:
        return dict(self._bytes)


def _scope() -> AttributionScope | None:
    stack = getattr(_SCOPE_TLS, "stack", None)
    return stack[-1] if stack else None


def _detail(accum: dict, nbytes) -> dict:
    out = {}
    for k, v in sorted(accum.items(), key=lambda kv: -kv[1][0]):
        ent = {"s": v[0], "n": v[1]}
        if nbytes.get(k):
            ent["b"] = nbytes[k]
        out[k] = ent
    return out


def exclude_from_scope(seconds: float) -> None:
    """Mark ``seconds`` of this thread's wall time as not its work (a
    serving session parked at its baton): every region whose window holds
    them nets them out, in the innermost scope's table and in the
    process-wide one."""
    s = float(seconds)
    _SCOPE_TLS.excluded = getattr(_SCOPE_TLS, "excluded", 0.0) + s
    sc = _scope()
    if sc is not None:
        sc._excluded += s


@contextlib.contextmanager
def attribution_scope(tag: str = ""):
    """Route this thread's regions, bumps and bytes into a private
    :class:`AttributionScope` as well, until exit; nested scopes shadow.
    Yields the scope, whose table outlives the block."""
    sc = AttributionScope(tag)
    stack = getattr(_SCOPE_TLS, "stack", None)
    if stack is None:
        stack = _SCOPE_TLS.stack = []
    stack.append(sc)
    try:
        yield sc
    finally:
        stack.pop()


@contextlib.contextmanager
def region(name: str):
    sc = _scope()
    if sc is not None:
        sc.last = name
    else:
        _LAST_REGION[0] = name
    mode = _MODE[0]
    if mode is None and sc is None and _TRACE[0] is None:
        yield
        return
    t0 = time.perf_counter()
    ex0 = sc._excluded if sc is not None else 0.0
    gex0 = getattr(_SCOPE_TLS, "excluded", 0.0)
    try:
        yield
    finally:
        if mode == "block" and torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tr = _TRACE[0]
        if tr is not None:
            tr.span(name, t0, dt)
        if mode is not None:
            # excluded seconds inside this region's window are not its
            # work; the cumulative counters net nested regions alike
            gnet = getattr(_SCOPE_TLS, "excluded", 0.0) - gex0
            acc = _ACCUM.setdefault(name, [0.0, 0])
            acc[0] += max(dt - gnet, 0.0)
            acc[1] += 1
        if sc is not None:
            sc._add(name, max(dt - (sc._excluded - ex0), 0.0))


@contextlib.contextmanager
def sync_region(name: str):
    """Time a deliberate host wait under ``name + ".block"``."""
    with region(name if name.endswith(BLOCK_SUFFIX)
                else name + BLOCK_SUFFIX):
        yield


def split_snapshot(snap: dict) -> tuple[dict, dict]:
    """Split a :func:`snapshot` into ``(dispatch, block)`` maps: the
    ``.block`` regions land in ``block`` under their base name."""
    dispatch, block = {}, {}
    for k, v in snap.items():
        if k.endswith(BLOCK_SUFFIX):
            block[k[:-len(BLOCK_SUFFIX)]] = v
        else:
            dispatch[k] = v
    return dispatch, block


def maybe_block(x) -> None:
    """Wait for the device work feeding ``x`` (a tensor or a list of
    them) only in ``block`` mode, so a region can charge its device work
    to itself in an attribution run without serializing a timed one."""
    if _MODE[0] != "block":
        return
    xs = x if isinstance(x, (list, tuple)) else [x]
    devs = {t.device for t in xs if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devs:
        torch.cuda.synchronize(d)


def last_region() -> str:
    """The most recently entered region ("" before the first); inside an
    attribution scope, the scope's."""
    sc = _scope()
    return sc.last if sc is not None else _LAST_REGION[0]


def bump(name: str) -> None:
    """Count one occurrence of event ``name`` without timing it; counted
    whether timing is on or off (:func:`counts`, and the registry's
    ``timing_event_<name>``)."""
    acc = _ACCUM.setdefault(name, [0.0, 0])
    acc[1] += 1
    _EVENT_COUNTS[name] = _EVENT_COUNTS.get(name, 0) + 1
    tr = _TRACE[0]
    if tr is not None:
        tr.instant(name)
    sc = _scope()
    if sc is not None:
        sc._add(name, 0.0)


# the bytes and event counts live in the metrics registry (obs/metrics);
# the dict-like views keep the call sites as they are
from ..obs import metrics as _metrics  # noqa: E402

#: name -> bytes attributed (add_bytes)
_BYTES = _metrics.namespace("timing_bytes")
#: name -> bump() occurrences
_EVENT_COUNTS = _metrics.namespace("timing_event")


def add_bytes(name: str, nbytes: int) -> None:
    """Attribute ``nbytes`` of host<->device traffic to phase ``name``,
    whether timing is on or off (:func:`byte_counts`, and the registry's
    ``timing_bytes_<name>``)."""
    _BYTES[name] = _BYTES.get(name, 0) + int(nbytes)
    _ACCUM.setdefault(name, [0.0, 0])
    tr = _TRACE[0]
    if tr is not None:
        tr.instant(name, {"bytes": int(nbytes)})
    sc = _scope()
    if sc is not None:
        sc._add_bytes(name, nbytes)


def reset() -> None:
    """Clear the phase table, the bytes, the event counts, the last-region
    breadcrumb and this thread's excluded seconds."""
    _ACCUM.clear()
    _BYTES.clear()
    _EVENT_COUNTS.clear()
    _LAST_REGION[0] = ""
    _SCOPE_TLS.excluded = 0.0


def mode() -> str | None:
    """The timing mode: None, ``"async"`` or ``"block"``."""
    return _MODE[0]


def snapshot() -> dict:
    """{name: seconds} accumulated since the last :func:`reset`."""
    return {k: v[0] for k, v in _ACCUM.items()}


def detail() -> dict:
    """{name: {"s": seconds, "n": calls[, "b": bytes]}} since the last
    :func:`reset`, costliest first (the reference's snapshot shape)."""
    return _detail(_ACCUM, _BYTES)


def counts() -> dict:
    """{name: occurrences} of every region and event since the last
    :func:`reset`."""
    return {k: v[1] for k, v in _ACCUM.items()}


def byte_counts() -> dict:
    """{name: bytes} attributed by :func:`add_bytes` since the last
    :func:`reset`."""
    return dict(_BYTES)


_metrics.register_collector(lambda: {"phases": detail()})
