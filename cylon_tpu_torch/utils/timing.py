"""Per-phase timers (port of the region part of ``cylon_tpu/utils/timing.py``).

:func:`region` accumulates host seconds per named phase in a process-wide
table while timing is on (``CYLON_TPU_TORCH_TIMING`` = ``async`` or
``block``, or :func:`enable`); off, it costs one flag read.  Device work
is queued asynchronously, so an ``async`` region records the host time to
QUEUE its work; ``block`` mode waits for the device at the end of every
region, which gives each phase its device time but serializes the
phases' overlap — use it for an attribution run, not a timed one.
:func:`bump` counts an event (a route taken) whatever the mode.

Regions by layer: ``shuffle.hash``/``shuffle.exchange`` (the exchange),
``join.*`` and ``pipe.*`` (the joins), ``groupby.*``, ``sort.*`` (with
``sort.string_lanes``, the host-side lanes of a hashed string key),
``setop.flags``/``unique.flags`` (a set op's or unique's dense rank,
flags and count pull), ``setop.materialize``/``unique.materialize`` (its
compaction) and ``repart.targets`` (a repartition's destinations).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

#: None (off), "async" or "block"
_MODE = [os.environ.get("CYLON_TPU_TORCH_TIMING") or None]
#: name -> [total_seconds, call_count]
_ACCUM: dict[str, list] = {}


def enable(mode: str | None) -> None:
    """Set the timing mode: None, ``"async"`` or ``"block"``."""
    if mode not in (None, "async", "block"):
        raise ValueError(f"timing mode {mode!r}")
    _MODE[0] = mode


@contextlib.contextmanager
def region(name: str):
    mode = _MODE[0]
    if mode is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if mode == "block" and torch.cuda.is_available():
            torch.cuda.synchronize()
        acc = _ACCUM.setdefault(name, [0.0, 0])
        acc[0] += time.perf_counter() - t0
        acc[1] += 1


def bump(name: str) -> None:
    """Count one occurrence of event ``name`` without timing it; counted
    whether timing is on or off (:func:`counts`)."""
    acc = _ACCUM.setdefault(name, [0.0, 0])
    acc[1] += 1


def reset() -> None:
    _ACCUM.clear()


def snapshot() -> dict:
    """{name: seconds} accumulated since the last :func:`reset`."""
    return {k: v[0] for k, v in _ACCUM.items()}


def counts() -> dict:
    """{name: occurrences} of every region and event since the last
    :func:`reset`."""
    return {k: v[1] for k, v in _ACCUM.items()}
