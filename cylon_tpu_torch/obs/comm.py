"""Shuffle communication matrix: per-(src, dst) rows and bytes (port of
``cylon_tpu/obs/comm.py``).

The exchange's count sidecar (parallel/shuffle.count_targets) already
says which rank pair carries which rows: ``counts[s, d]`` rows go from
rank s to rank d, pulled to the host for the exchange anyway.  Armed
(``CYLON_TPU_TORCH_COMM_MATRIX=1`` or :func:`arm`), every exchange adds
its count matrix (rows and bytes) to host-side cumulative matrices, and
:func:`report` gives them with their row sums (per-source sent) and
column sums (per-destination received); the grand totals equal the
always-on registry counters ``exchange_rows_total`` and
``exchange_bytes_total`` over the same exchanges.

Unarmed and with no plan profile active, :func:`record` is never called:
the exchange checks :func:`armed` (one list load).  Recording is host
numpy over the pulled sidecar: no device work.

In a multi-process world (ctx/context.DistributedConfig)
:func:`report` allgathers every process's matrices, which must be
byte-identical (each process accumulated the same replicated count
sidecars), and raises ``RankDesyncError`` when they are not
(``cylon_tpu/obs/comm.py:164``).  The ICI/DCN tier split (``tiers``)
waits for the topology slice — ``tiers`` stays None.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["arm", "armed", "record", "reset", "report", "matrix"]

_ARMED: list = [False]

#: the environment's arming, read once at the first check (None: unread)
_ENV_ARMED: list = [None]

#: [world, rows (W, W) int64, bytes (W, W) int64, n_exchanges], or None
#: before the first record
_STATE: list = [None]

#: per-exchange log (site, rows, bytes, row_bytes), newest last, bounded
_LOG: list = []
_LOG_CAP = 256


def arm(on: bool = True) -> None:
    _ARMED[0] = bool(on)


def armed() -> bool:
    if _ARMED[0]:
        return True
    e = _ENV_ARMED[0]
    if e is None:
        e = _ENV_ARMED[0] = \
            os.environ.get("CYLON_TPU_TORCH_COMM_MATRIX") == "1"
    return e


def _rearm() -> None:
    """Read the environment again at the next :func:`armed`."""
    _ENV_ARMED[0] = None


def reset() -> None:
    _STATE[0] = None
    del _LOG[:]


def record(counts, row_bytes: int, site: str = "exchange",
           tiers: dict | None = None) -> None:
    """Add one exchange's (W, W) count matrix to the cumulative matrices
    and the bounded log.  A world change restarts the accumulation.
    ``tiers`` waits for the topology slice."""
    counts = np.asarray(counts, np.int64)
    w = counts.shape[0]
    bmat = counts * int(row_bytes)
    st = _STATE[0]
    if st is None or st[0] != w:
        st = _STATE[0] = [w, np.zeros((w, w), np.int64),
                          np.zeros((w, w), np.int64), 0]
    st[1] += counts
    st[2] += bmat
    st[3] += 1
    _LOG.append({"site": site, "rows": int(counts.sum()),
                 "bytes": int(bmat.sum()), "row_bytes": int(row_bytes)})
    if len(_LOG) > _LOG_CAP:
        del _LOG[:len(_LOG) - _LOG_CAP]


def matrix() -> tuple | None:
    """The cumulative (rows, bytes) matrices, or None before the first
    recorded exchange."""
    st = _STATE[0]
    if st is None:
        return None
    return st[1], st[2]


def report(verify_across_ranks: bool = True) -> dict | None:
    """The cumulative matrix with its row and column sums, or None when
    nothing was recorded.  ``verify_across_ranks``: in a multi-process
    world, allgather every process's matrices and raise
    ``RankDesyncError`` unless they are identical (one process driving
    every rank has nothing to compare)."""
    st = _STATE[0]
    if st is None:
        return None
    w, rows, bts, n = st
    from ..parallel import transport
    proc = transport.current()
    if verify_across_ranks and proc is not None and proc.nproc > 1:
        from ..status import RankDesyncError
        wire = np.concatenate([[np.int64(n)], rows.ravel(), bts.ravel()])
        gathered = transport.allgather_array(wire, "obs.comm")
        if not all(np.array_equal(gathered[0], g) for g in gathered[1:]):
            raise RankDesyncError(
                "comm matrix: ranks accumulated different exchange "
                "sidecars — the ranks ran different shuffles",
                site="obs.comm")
    return {
        "world": w,
        "exchanges": n,
        "rows": rows.tolist(),
        "bytes": bts.tolist(),
        "row_sums_bytes": bts.sum(axis=1).tolist(),   # per-src sent
        "col_sums_bytes": bts.sum(axis=0).tolist(),   # per-dst received
        "total_rows": int(rows.sum()),
        "total_bytes": int(bts.sum()),
        "recent": list(_LOG[-16:]),
    }
