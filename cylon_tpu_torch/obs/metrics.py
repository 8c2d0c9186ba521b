"""Typed metrics registry (port of ``cylon_tpu/obs/metrics.py``): one
facade over every counter of the package.

* :class:`Counter`, :class:`Gauge` (``fn=`` computes on read) and
  :class:`Histogram` (exact quantiles up to :data:`SAMPLE_CAP` samples,
  bucket interpolation past it), registered by name through
  :func:`counter`, :func:`gauge` and :func:`histogram`; asking for a
  name under another type raises ``InvalidError``.
* :func:`group` and :func:`namespace`: dict-like views whose items are
  registry counters, so the exec modules' ``_STATS[k] += 1`` sites and
  their ``stats()`` functions keep working while the values live here.
* :func:`prometheus_text` / :func:`write_prometheus` (text exposition),
  :func:`snapshot` / :func:`write_snapshot` (JSON, with the collectors'
  sections: utils/timing's phase table), :func:`maybe_write_snapshot`
  (the periodic poll, ``CYLON_TPU_TORCH_METRICS_JSON`` and
  ``CYLON_TPU_TORCH_METRICS_INTERVAL_S``) and :func:`autoarm` (a final
  snapshot at exit when the path is set).
* :func:`bench_detail`: the counter block a bench run reports.

A counter bump is one attribute add; the unarmed snapshot poll is one
list load after the first environment read.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import threading
import time
from collections.abc import MutableMapping

__all__ = [
    "Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
    "group", "namespace", "register_collector", "snapshot",
    "prometheus_text", "write_prometheus", "maybe_write_snapshot",
    "write_snapshot", "bench_detail", "reset", "autoarm",
]


class Counter:
    """Monotonic event count (resettable between bench iterations)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):  # noqa: A002
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, v) -> None:
        """The ``_STATS[k] = 0`` reset idiom of the group views."""
        self.value = v

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Point-in-time value; ``fn`` makes it computed on read (the memory
    ledger's balance), so exposition always reads fresh."""

    __slots__ = ("name", "help", "fn", "_value")

    def __init__(self, name: str, help: str = "", fn=None):  # noqa: A002
        self.name = name
        self.help = help
        self.fn = fn
        self._value = 0

    def set(self, v) -> None:
        self._value = v

    @property
    def value(self):
        if self.fn is not None:
            try:
                return self.fn()
            except Exception:  # noqa: BLE001 — exposition must not raise
                return self._value
        return self._value

    def reset(self) -> None:
        self._value = 0


#: default histogram buckets: latency seconds, 1 ms to ~17 min
DEFAULT_BUCKETS = tuple(0.001 * (2 ** i) for i in range(21))

#: raw samples kept per histogram for exact quantiles
SAMPLE_CAP = 65536


class Histogram:
    """Streaming latency histogram.  Bucket counts serve the exposition;
    the raw samples (up to :data:`SAMPLE_CAP`) serve :meth:`percentile`,
    which equals ``np.percentile`` over the same observations.  Past the
    cap quantiles interpolate inside the containing bucket and
    :attr:`truncated` reads True."""

    __slots__ = ("name", "help", "buckets", "bucket_counts", "count",
                 "sum", "_samples", "truncated")

    def __init__(self, name: str, help: str = "",  # noqa: A002
                 buckets=DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self.bucket_counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self._samples: list[float] = []
        self.truncated = False

    def observe(self, x) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        self.bucket_counts[bisect.bisect_left(self.buckets, x)] += 1
        if len(self._samples) < SAMPLE_CAP:
            self._samples.append(x)
        else:
            self.truncated = True

    def percentile(self, p: float):
        """Quantile at percent ``p`` in [0, 100]: ``np.percentile``
        (linear) over the kept samples.  ``p`` outside the range raises
        ``InvalidError``; an empty histogram, or one that kept no sample,
        gives ``nan``."""
        p = float(p)
        if not 0.0 <= p <= 100.0:
            from ..status import InvalidError
            raise InvalidError(
                f"percentile {p!r} outside [0, 100] on {self.name!r}")
        if not self._samples:
            return float("nan")
        if not self.truncated:
            import numpy as np
            return float(np.percentile(np.asarray(self._samples, float), p))
        return self._bucket_percentile(p)

    def _bucket_percentile(self, p: float) -> float:
        target = (p / 100.0) * max(self.count - 1, 0)
        seen = 0
        lo = 0.0
        for i, n in enumerate(self.bucket_counts):
            hi = self.buckets[i] if i < len(self.buckets) else lo * 2 or 1.0
            if n and seen + n > target:
                return lo + (target - seen) / n * (hi - lo)
            seen += n
            lo = hi
        return lo

    def attainment(self, target) -> float | None:
        """Share of observations at or under ``target`` (None when
        empty)."""
        if self.count == 0:
            return None
        t = float(target)
        if not self.truncated:
            return sum(1 for x in self._samples if x <= t) / self.count
        under = sum(n for i, n in enumerate(self.bucket_counts)
                    if i < len(self.buckets) and self.buckets[i] <= t)
        return under / self.count

    @property
    def value(self):
        """The exposition view; a NaN quantile exports as None so strict
        JSON parsers read the snapshot."""
        def _j(x):
            return None if x != x else x
        return {"count": self.count, "sum": round(self.sum, 6),
                "p50": _j(self.percentile(50)),
                "p99": _j(self.percentile(99))}

    def reset(self) -> None:
        self.bucket_counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self._samples = []
        self.truncated = False


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_METRICS: dict[str, object] = {}
#: callables returning {section: payload}, merged into snapshot()
_COLLECTORS: list = []


def _get_or_make(name: str, cls, **kw):
    m = _METRICS.get(name)
    if m is None:
        with _LOCK:
            m = _METRICS.get(name)
            if m is None:
                m = _METRICS[name] = cls(name, **kw)
    if not isinstance(m, cls):
        from ..status import InvalidError
        raise InvalidError(
            f"metric {name!r} already registered as "
            f"{type(m).__name__}, requested {cls.__name__}")
    return m


def counter(name: str, help: str = "") -> Counter:  # noqa: A002
    return _get_or_make(name, Counter, help=help)


def gauge(name: str, help: str = "", fn=None) -> Gauge:  # noqa: A002
    g = _get_or_make(name, Gauge, help=help)
    if fn is not None:
        g.fn = fn
    return g


def histogram(name: str, help: str = "",  # noqa: A002
              buckets=DEFAULT_BUCKETS) -> Histogram:
    return _get_or_make(name, Histogram, help=help, buckets=buckets)


def register_collector(fn) -> None:
    """Register a callable returning ``{section: payload}`` for
    :func:`snapshot` (utils/timing's phase table)."""
    if fn not in _COLLECTORS:
        _COLLECTORS.append(fn)


def reset(prefix: str = "") -> None:
    """Zero every metric whose name starts with ``prefix``; the
    registrations (and their handles) stay."""
    with _LOCK:
        items = list(_METRICS.items())
    for name, m in items:
        if name.startswith(prefix):
            m.reset()


# ---------------------------------------------------------------------------
# dict-like views backed by registry counters
# ---------------------------------------------------------------------------

class CounterGroup(MutableMapping):
    """Fixed-key view over counters ``<prefix>_<key>``: ``_STATS[k] += 1``,
    ``dict(_STATS)`` and ``for k in _STATS`` keep working while the values
    live in the registry."""

    __slots__ = ("_keys", "_counters")

    def __init__(self, prefix: str, keys):
        self._keys = tuple(keys)
        self._counters = {k: counter(f"{prefix}_{k}") for k in self._keys}

    def __getitem__(self, k):
        return self._counters[k].value

    def __setitem__(self, k, v):
        self._counters[k].set(v)

    def __delitem__(self, k):
        raise TypeError("CounterGroup keys are fixed")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)


def group(prefix: str, keys) -> CounterGroup:
    return CounterGroup(prefix, keys)


class Namespace(MutableMapping):
    """Dynamic-key view over counters ``<prefix>_<key>``: keys appear on
    first write; ``clear()`` zeroes them (the registrations stay)."""

    __slots__ = ("_prefix", "_local")

    def __init__(self, prefix: str):
        self._prefix = prefix
        self._local: dict[str, Counter] = {}

    def _c(self, k) -> Counter:
        c = self._local.get(k)
        if c is None:
            c = self._local[k] = counter(f"{self._prefix}_{k}")
        return c

    def __getitem__(self, k):
        if k not in self._local:
            raise KeyError(k)
        return self._local[k].value

    def get(self, k, default=None):
        c = self._local.get(k)
        return default if c is None else c.value

    def __setitem__(self, k, v):
        self._c(k).set(v)

    def __delitem__(self, k):
        self._local.pop(k).reset()

    def __iter__(self):
        return iter(self._local)

    def __len__(self):
        return len(self._local)

    def clear(self) -> None:
        for c in self._local.values():
            c.reset()
        self._local.clear()


def namespace(prefix: str) -> Namespace:
    return Namespace(prefix)


# ---------------------------------------------------------------------------
# exposition: Prometheus text and JSON snapshots
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    n = _NAME_RE.sub("_", name)
    return n if not n[:1].isdigit() else "_" + n


def prometheus_text(prefix: str = "cylon_tpu_torch") -> str:
    """The registry in the Prometheus text exposition format: counters,
    gauges, and histograms as ``_bucket``/``_sum``/``_count`` series."""
    out = []
    with _LOCK:
        items = sorted(_METRICS.items())
    for name, m in items:
        pn = f"{prefix}_{_prom_name(name)}"
        if isinstance(m, Counter):
            out.append(f"# TYPE {pn} counter")
            out.append(f"{pn} {m.value}")
        elif isinstance(m, Gauge):
            out.append(f"# TYPE {pn} gauge")
            out.append(f"{pn} {m.value}")
        elif isinstance(m, Histogram):
            out.append(f"# TYPE {pn} histogram")
            acc = 0
            for i, b in enumerate(m.buckets):
                acc += m.bucket_counts[i]
                out.append(f'{pn}_bucket{{le="{b:g}"}} {acc}')
            out.append(f'{pn}_bucket{{le="+Inf"}} {m.count}')
            out.append(f"{pn}_sum {m.sum:g}")
            out.append(f"{pn}_count {m.count}")
    return "\n".join(out) + "\n"


def write_prometheus(path: str, prefix: str = "cylon_tpu_torch") -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(prometheus_text(prefix))
    os.replace(tmp, path)


def snapshot() -> dict:
    """Every metric's value as one JSON-able dict, plus the collectors'
    sections."""
    with _LOCK:
        items = sorted(_METRICS.items())
    out = {name: m.value for name, m in items}
    for fn in _COLLECTORS:
        try:
            out.update(fn())
        except Exception:  # noqa: BLE001 — a broken collector must not
            pass           # take the snapshot down
    return out


def write_snapshot(path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"ts": time.time(), "metrics": snapshot()}, f)
    os.replace(tmp, path)


#: [armed path, "" (read, off) or None (unread), next due time]
_SNAP: list = [None, 0.0]
_SNAP_WARNED = [False]


def maybe_write_snapshot() -> bool:
    """The periodic snapshot poll (``CYLON_TPU_TORCH_METRICS_JSON`` =
    path, every ``CYLON_TPU_TORCH_METRICS_INTERVAL_S`` seconds, default
    30).  Unarmed: one list load after the first environment read.  A
    failed write warns once and returns False."""
    path = _SNAP[0]
    if path is None:
        path = _SNAP[0] = os.environ.get("CYLON_TPU_TORCH_METRICS_JSON", "")
    if not path:
        return False
    now = time.monotonic()
    if now < _SNAP[1]:
        return False
    _SNAP[1] = now + float(
        os.environ.get("CYLON_TPU_TORCH_METRICS_INTERVAL_S", "30"))
    try:
        from ..exec.recovery import retry_io
        retry_io(lambda: write_snapshot(path), "obs.snapshot")
    except OSError as e:
        if not _SNAP_WARNED[0]:
            _SNAP_WARNED[0] = True
            from ..utils.logging import log
            log.warning("obs: metrics snapshot to %r failed: %s "
                        "(CYLON_TPU_TORCH_METRICS_JSON armed but "
                        "unwritable; further failures are silent)", path, e)
        return False
    return True


def _rearm_snapshots() -> None:
    """Read the environment again at the next poll."""
    _SNAP[0] = None
    _SNAP[1] = 0.0
    _SNAP_WARNED[0] = False


_AUTOARMED = [False]


def autoarm() -> None:
    """With ``CYLON_TPU_TORCH_METRICS_JSON`` set, write a final snapshot
    at exit (called at package import).  Unset: nothing happens."""
    if _AUTOARMED[0] or not os.environ.get("CYLON_TPU_TORCH_METRICS_JSON"):
        return
    _AUTOARMED[0] = True
    import atexit

    def _final_snapshot() -> None:
        path = os.environ.get("CYLON_TPU_TORCH_METRICS_JSON")
        if path:
            try:
                write_snapshot(path)
            except OSError:
                pass   # exit path: never raise
    atexit.register(_final_snapshot)


# ---------------------------------------------------------------------------
# the bench-detail collector
# ---------------------------------------------------------------------------

#: the spill counters a bench run reports (exec/memory.stats keys); the
#: reference's ``donated_bytes_reused`` has no counterpart (the port
#: donates no buffer)
BENCH_SPILL_KEYS = ("spill_events", "bytes_spilled", "peak_ledger_bytes",
                    "disk_events", "bytes_to_disk")
#: the checkpoint counters a bench run reports (exec/checkpoint.stats)
BENCH_CKPT_KEYS = ("checkpoint_events", "bytes_checkpointed",
                   "resume_fast_forwarded_pieces", "resume_resharded_pieces",
                   "resume_world_mismatch")
#: the compile tier's counters a bench run reports (exec/compiler.stats):
#: the kernel libraries live, the loads a built library served, the
#: ``nvcc`` builds and their seconds
BENCH_COMPILE_KEYS = ("programs_live", "cache_hits", "cache_misses",
                      "cache_evictions", "compile_seconds")
#: the integrity tier's counters a bench run reports (exec/integrity.
#: stats): nonzero fingerprint checks say the armed audit's cost is in
#: the number
BENCH_AUDIT_KEYS = ("conservation_checks", "fingerprint_checks",
                    "violations")


def bench_detail(*, spill_keys=BENCH_SPILL_KEYS, ckpt_keys=BENCH_CKPT_KEYS,
                 compile_keys=BENCH_COMPILE_KEYS,
                 audit_keys=BENCH_AUDIT_KEYS,
                 events: str | None = "drain", plan=None) -> dict:
    """The counter block of a bench run: the recovery events
    (``events="drain"`` empties the log, ``"keep"`` reads it, None omits
    it), the selected spill and checkpoint counters under their
    ``stats()`` names, and the ``compile`` and ``audit`` blocks.
    ``plan`` (a :class:`~cylon_tpu_torch.obs.plan.QueryPlan` or its
    dict) adds a ``plan`` section."""
    from ..exec import checkpoint, compiler, integrity, memory, recovery
    out: dict = {}
    if events == "drain":
        out["recovery_events"] = recovery.drain_events()
    elif events == "keep":
        out["recovery_events"] = recovery.recovery_events()
    mem = memory.stats()
    out.update({k: mem[k] for k in spill_keys})
    ck = checkpoint.stats()
    out.update({k: ck[k] for k in ckpt_keys})
    if compile_keys:
        comp = compiler.stats()
        out["compile"] = {k: comp[k] for k in compile_keys}
    if audit_keys:
        au = integrity.stats()
        out["audit"] = {k: au[k] for k in audit_keys}
    if plan is not None:
        out["plan"] = plan.to_dict() if hasattr(plan, "to_dict") else plan
    return out
