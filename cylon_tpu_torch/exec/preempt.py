"""Preemption grace: SIGTERM becomes a planned drain, not a fault (port of
``cylon_tpu/exec/preempt.py``).

Spot and preemptible capacity announces a preemption with SIGTERM and a
grace budget before the hard SIGKILL.  Python's default disposition kills
the interpreter mid-piece.  With ``CYLON_TPU_TORCH_PREEMPT_GRACE_S=
<seconds>`` set (the operator's declaration of the platform's grace
budget) this module installs a SIGTERM handler that only SETS A FLAG; the
pipelined range loop polls it at its checkpoint boundaries
(``exec/checkpoint.drain_requested``), where completed-piece state is
already committed, and raises a typed
:class:`~cylon_tpu_torch.status.ResumableAbort` carrying the resume
token.  A relaunch with ``CYLON_TPU_TORCH_RESUME=1``, at the same or
another world size, fast-forwards past everything committed.

Contract:

* ``CYLON_TPU_TORCH_PREEMPT_GRACE_S`` unset: nothing is installed and
  every probe is one env read; SIGTERM keeps its default disposition.
* Grace armed but ``CYLON_TPU_TORCH_CKPT_DIR`` unset: the handler still
  only sets the flag, and no drain fires (nothing durable to resume
  from): no file is written and nothing changes.
* The drain decision goes through ``recovery.drain_consensus``: across
  the processes of a ``DistributedConfig`` world a notice to any one of
  them drains every process at the same piece boundary; one process
  driving every rank takes its local flag.

Signal handlers are main-thread-only in CPython: :func:`install` runs at
env creation (``ctx/context.CylonEnv``) and declines off the main thread.
"""

from __future__ import annotations

import os
import signal
import time

_STATE: dict = {"installed": False, "requested": False,
                "received_at": None, "prev": None}


def grace_seconds() -> float | None:
    """The declared grace budget (``CYLON_TPU_TORCH_PREEMPT_GRACE_S``),
    or None: preemption grace disarmed (the default).  Read on every
    call."""
    v = os.environ.get("CYLON_TPU_TORCH_PREEMPT_GRACE_S")
    if not v:
        return None
    try:
        return float(v)
    except ValueError:
        from ..status import InvalidError
        raise InvalidError(
            f"CYLON_TPU_TORCH_PREEMPT_GRACE_S={v!r} is not a number") \
            from None


def armed() -> bool:
    """True when a grace budget is declared: the gate every drain poll
    checks first."""
    return grace_seconds() is not None


def install() -> bool:
    """Install the flag-setting SIGTERM handler (idempotent).  True when
    the handler is active; declines when grace is disarmed or off the
    main thread (the default disposition then applies)."""
    if grace_seconds() is None:
        return False
    if _STATE["installed"]:
        return True
    try:
        prev = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:      # not the main thread
        return False
    _STATE["prev"] = prev
    _STATE["installed"] = True
    return True


def _on_sigterm(signum, frame) -> None:
    # flag only: the drain site logs with full context
    _STATE["requested"] = True
    if _STATE["received_at"] is None:
        _STATE["received_at"] = time.monotonic()
    # chain to an embedding application's own handler (SIG_DFL and
    # SIG_IGN are ints, never chained)
    prev = _STATE["prev"]
    if callable(prev):
        prev(signum, frame)


def request() -> None:
    """A programmatic preemption notice (the ``term`` injector kind sends
    a real SIGTERM instead)."""
    _on_sigterm(signal.SIGTERM, None)


def requested() -> bool:
    """True once a preemption notice has arrived in this process."""
    return bool(_STATE["requested"])


def remaining_s() -> float | None:
    """Seconds left of the grace budget, or None before a notice."""
    if _STATE["received_at"] is None:
        return None
    g = grace_seconds() or 0.0
    return g - (time.monotonic() - _STATE["received_at"])


def reset(uninstall: bool = False) -> None:
    """Clear the preemption flag; with ``uninstall=True`` also restore the
    previous SIGTERM disposition."""
    _STATE["requested"] = False
    _STATE["received_at"] = None
    if uninstall and _STATE["installed"]:
        try:
            signal.signal(signal.SIGTERM, _STATE["prev"] or signal.SIG_DFL)
        except ValueError:
            pass
        _STATE["installed"] = False
        _STATE["prev"] = None
