"""The runtime sentinel (port of ``cylon_tpu/analysis/runtime.py``),
rules RT3xx and the log CL202 reads.

What the static passes cannot see, a run counts:

* **funnel pulls (RT303)** — :func:`transfer_scope` counts the pulls the
  host funnel makes (``utils/host.host_array``, ``host_arrays``,
  ``sync_pull`` each call :func:`note_transfer`), by kind and by the
  first package frame that asked (its site), so a test or the card run
  holds an op to its budget of device→host waits;
* **kernel builds (RT301, RT302)** — ``exec/compiler.build_all`` calls
  :func:`note_build` for every library it builds; a second build of one
  source-and-flags digest in a process is RT301, more distinct digests
  than the budget RT302 (:func:`check_budgets`);
* **the collective log (CL202)** — ``parallel/transport._guarded`` calls
  :func:`note_collective` for every collective it runs, ``(site, kind,
  dtype, group size)``, and the state keeps a running sha256 over the
  entries: two processes of one world that ran the same collectives in
  the same order hold the same digest (:mod:`.collective_check`
  compares logs);
* **stray syncs on the card** — :func:`sync_scope` puts torch's CUDA
  sync debug mode at ``"warn"`` and counts each synchronizing call by
  the first ``cylon_tpu_torch`` frame under it, the funnel's own sites
  apart from the rest.  torch calls the mode a prototype that does not
  detect every synchronizing operation, so the count is a lower bound.
  It raises when the mode cannot be set: there is no fallback.

Off by default: armed by :func:`enable`, or at import when
``CYLON_TPU_TORCH_TRACECHECK=1`` (the port imports this module with the
funnel).  While off, each hook costs one truthiness check
(:data:`ACTIVE` in the funnel, ``_state`` in the transport and the
compile tier).  A :func:`transfer_scope` counts whether armed or not.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import sys
import threading
from collections import Counter
from dataclasses import dataclass, field

#: the environment switch read at import
ENV_VAR = "CYLON_TPU_TORCH_TRACECHECK"

#: RT302's default: distinct kernel libraries one process may build (the
#: two kernels and the host string hash)
DEFAULT_BUILD_BUDGET = 3

_lock = threading.Lock()
_local = threading.local()

#: the armed state, None while off
_state = None
#: the funnel's hook gate: armed, or a transfer scope open somewhere
ACTIVE = False
_scopes = [0]

#: this file and the funnel: never a pull's or a sync's site
_PKG_MARK = os.sep + "cylon_tpu_torch" + os.sep
_FUNNEL = os.path.join("utils", "host.py")
_SELF = os.path.join("analysis", "runtime.py")


@dataclass
class SentinelState:
    #: (label, source-and-flags digest) -> builds in this process
    builds: Counter = field(default_factory=Counter)
    #: (kind, site) -> funnel pulls while armed
    pulls: Counter = field(default_factory=Counter)
    #: (site, kind, dtype, group size) of every collective, in order
    log: list = field(default_factory=list)
    digest: object = field(default_factory=hashlib.sha256)


def _recompute_active() -> None:
    global ACTIVE
    ACTIVE = _state is not None or _scopes[0] > 0


def enabled() -> bool:
    return _state is not None


def enable() -> SentinelState:
    """Arm the sentinel (idempotent); returns the live state."""
    global _state
    with _lock:
        if _state is None:
            _state = SentinelState()
        _recompute_active()
    return _state


def disable() -> None:
    global _state
    with _lock:
        _state = None
        _recompute_active()


def reset() -> None:
    """Zero the counters and the log (the sentinel stays armed)."""
    st = _state
    if st is not None:
        with _lock:
            st.builds.clear()
            st.pulls.clear()
            st.log.clear()
            st.digest = hashlib.sha256()


def state() -> SentinelState | None:
    return _state


def _site(skip_funnel: bool) -> str:
    """``path:line`` of the innermost package frame above the caller
    that is neither this module nor (with ``skip_funnel``) the funnel;
    the path relative to the package (``exec/pipeline.py:753``)."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if _PKG_MARK in name and not name.endswith(_SELF) \
                and not (skip_funnel and name.endswith(_FUNNEL)):
            rel = name[name.rindex(_PKG_MARK) + len(_PKG_MARK):]
            rel = rel.replace(os.sep, "/")
            return f"{rel}:{f.f_lineno}"
        f = f.f_back
    return "<outside cylon_tpu_torch>"


class TransferLedger(Counter):
    """Funnel pulls by kind; :attr:`sites` by ``(kind, site)``."""

    def __init__(self):
        super().__init__()
        self.sites = Counter()


def note_transfer(kind: str, n: int = 1) -> None:
    """One sanctioned host pull (the funnel calls it while
    :data:`ACTIVE`)."""
    ledger = getattr(_local, "ledger", None)
    st = _state
    if ledger is None and st is None:
        return
    site = _site(skip_funnel=True)
    if ledger is not None:
        ledger[kind] += n
        ledger.sites[(kind, site)] += n
    if st is not None:
        with _lock:
            st.pulls[(kind, site)] += n


@contextlib.contextmanager
def transfer_scope():
    """Count the funnel's pulls made on this thread inside the scope.
    Yields a :class:`TransferLedger`; nested scopes shadow outer ones
    (innermost wins: per-op budgets)."""
    prev = getattr(_local, "ledger", None)
    ledger = TransferLedger()
    _local.ledger = ledger
    with _lock:
        _scopes[0] += 1
        _recompute_active()
    try:
        yield ledger
    finally:
        _local.ledger = prev
        with _lock:
            _scopes[0] -= 1
            _recompute_active()


def note_build(label: str, sig: str) -> None:
    """One kernel library built (exec/compiler.build_all, armed)."""
    st = _state
    if st is not None:
        with _lock:
            st.builds[(label, sig)] += 1


def note_collective(site: str, kind: str, dtype, group: int) -> None:
    """One collective run (parallel/transport._guarded, armed)."""
    st = _state
    if st is None:
        return
    entry = (str(site), str(kind), "" if dtype is None else str(dtype),
             int(group))
    with _lock:
        st.log.append(entry)
        st.digest.update(repr(entry).encode())


def collective_log() -> list:
    st = _state
    return [] if st is None else list(st.log)


def collective_digest() -> str | None:
    """The running sha256 of the collective log (None while off)."""
    st = _state
    if st is None:
        return None
    with _lock:
        return st.digest.copy().hexdigest()


def check_budgets(build_budget: int = DEFAULT_BUILD_BUDGET) -> list:
    """``(rule, subject, message)`` violations of the armed process:
    RT301 for a digest built twice, RT302 for more distinct digests than
    ``build_budget``."""
    st = _state
    out = []
    if st is None:
        return out
    for (label, sig), n in sorted(st.builds.items()):
        if n > 1:
            out.append(("RT301", label,
                        f"{label} built {n}x for one source-and-flags "
                        f"digest {sig} — its library is not reused"))
    if len(st.builds) > build_budget:
        out.append(("RT302", "kernels",
                    f"{len(st.builds)} distinct kernel builds in this process "
                    f"(budget {build_budget})"))
    return out


def check_transfers(ledger: Counter, budget: int, op: str) -> list:
    """RT303: ``op`` made more funnel pulls than ``budget``."""
    n = sum(ledger.values())
    if n <= budget:
        return []
    return [("RT303", op, f"{op} made {n} funnel pulls (budget {budget}): "
                          f"{dict(ledger)}")]


class SyncCounts(Counter):
    """Synchronizing calls by site; :attr:`funnel` holds the funnel's
    own (``utils/host.py``), the Counter itself every other site."""

    def __init__(self):
        super().__init__()
        self.funnel = Counter()


_SYNC_TEXT = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def sync_scope():
    """Count the synchronizing CUDA calls made inside the scope, under
    ``torch.cuda.set_sync_debug_mode("warn")`` (restored on exit).
    Yields a :class:`SyncCounts`; a sync with no package frame under it
    counts at ``<outside cylon_tpu_torch>``.  Raises ``RuntimeError``
    when the mode does not take (no fallback)."""
    import warnings

    import torch
    try:
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            # torch calls the mode a prototype that misses some syncs:
            # the count is a lower bound (PERF.md)
            warnings.filterwarnings("ignore", message="Synchronization debug")
            torch.cuda.set_sync_debug_mode("warn")
        took = torch.cuda.get_sync_debug_mode() == 1
    except (AssertionError, RuntimeError) as e:     # no CUDA build
        raise RuntimeError(f"the CUDA sync debug mode is unavailable "
                           f"({e}): the stray-sync count has no "
                           "fallback") from e
    if not took:
        torch.cuda.set_sync_debug_mode(prev)
        raise RuntimeError("torch.cuda.set_sync_debug_mode('warn') did not "
                           "take: the stray-sync count has no fallback")
    counts = SyncCounts()
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("always", message=_SYNC_TEXT)
            shown = warnings.showwarning

            def show(message, category, filename, lineno, file=None,
                     line=None):
                if _SYNC_TEXT not in str(message):
                    shown(message, category, filename, lineno, file, line)
                    return
                site = _site(skip_funnel=False)
                if site.split(":")[0] == "utils/host.py":
                    counts.funnel[site] += 1
                else:
                    counts[site] += 1

            warnings.showwarning = show
            yield counts
    finally:
        torch.cuda.set_sync_debug_mode(prev)


if os.environ.get(ENV_VAR, "") == "1":
    enable()
