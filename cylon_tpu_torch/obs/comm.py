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
(``cylon_tpu/obs/comm.py:164``), the tier totals and slice map
included.

On a topology of two or more slices (topo/model.py) each record carries
the exchange's ``tiers``: the slice map, the route and each tier's
padded wire bytes and messages.  :func:`report` then gains a ``tiers``
block with the reference's fields: the matrices split into the tier
inside a slice ("ici": one card's memory or NVLink) and across slices
("dcn": the network between nodes), their rows and bytes, the wire
bytes, the messages and the count of each route.  A change of topology
restarts the accumulation.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["arm", "armed", "record", "reset", "report", "matrix"]

_ARMED: list = [False]

#: the environment's arming, read once at the first check (None: unread)
_ENV_ARMED: list = [None]

#: [world, rows (W, W) int64, bytes (W, W) int64, n_exchanges, slice ids
#: (W,) or None, tier traffic totals, route counts], or None before the
#: first record
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
    and the bounded log.  ``tiers`` (a topology of two or more slices):
    ``slice_ids``, ``route`` ("flat" or "two_hop") and the padded
    ``wire_ici``/``wire_dcn`` bytes and ``msgs_ici``/``msgs_dcn``
    messages of this exchange.  A change of world or of slice map (to or
    from none included) restarts the accumulation."""
    counts = np.asarray(counts, np.int64)
    w = counts.shape[0]
    bmat = counts * int(row_bytes)
    sids = None if tiers is None \
        else np.asarray(tiers["slice_ids"], np.int32)
    st = _STATE[0]
    topo_changed = st is not None and (
        (sids is None) != (st[4] is None)
        or (sids is not None and not np.array_equal(st[4], sids)))
    if st is None or st[0] != w or topo_changed:
        st = _STATE[0] = [w, np.zeros((w, w), np.int64),
                          np.zeros((w, w), np.int64), 0, sids,
                          {"wire_ici": 0, "wire_dcn": 0,
                           "msgs_ici": 0, "msgs_dcn": 0}, {}]
    st[1] += counts
    st[2] += bmat
    st[3] += 1
    ent = {"site": site, "rows": int(counts.sum()),
           "bytes": int(bmat.sum()), "row_bytes": int(row_bytes)}
    if tiers is not None:
        for k in st[5]:
            st[5][k] += int(tiers[k])
        route = tiers["route"]
        st[6][route] = st[6].get(route, 0) + 1
        ent["route"] = route
    _LOG.append(ent)
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
    w, rows, bts, n = st[0], st[1], st[2], st[3]
    sids, traffic, routes = st[4], st[5], st[6]
    from ..parallel import transport
    proc = transport.current()
    if verify_across_ranks and proc is not None and proc.nproc > 1:
        from ..status import RankDesyncError
        tier_wire = ([np.int64(traffic[k]) for k in sorted(traffic)]
                     + (sids.astype(np.int64).tolist()
                        if sids is not None else []))
        wire = np.concatenate([[np.int64(n)], rows.ravel(), bts.ravel(),
                               np.asarray(tier_wire, np.int64)])
        gathered = transport.allgather_array(wire, "obs.comm")
        if not all(np.array_equal(gathered[0], g) for g in gathered[1:]):
            raise RankDesyncError(
                "comm matrix: ranks accumulated different exchange "
                "sidecars — the ranks ran different shuffles",
                site="obs.comm")
    out = {
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
    if sids is not None:
        # the matrices split by the slice map: the tiers' rows and bytes
        # sum to the totals above; the wire and message fields are each
        # tier's padded link volume and transfer count
        cross = sids[:, None] != sids[None, :]
        out["tiers"] = {
            "n_slices": int(len(np.unique(sids))),
            "ici_rows_matrix": np.where(cross, 0, rows).tolist(),
            "dcn_rows_matrix": np.where(cross, rows, 0).tolist(),
            "ici_rows": int(rows[~cross].sum()),
            "dcn_rows": int(rows[cross].sum()),
            "ici_bytes": int(bts[~cross].sum()),
            "dcn_bytes": int(bts[cross].sum()),
            "ici_wire_bytes": int(traffic["wire_ici"]),
            "dcn_wire_bytes": int(traffic["wire_dcn"]),
            "ici_messages": int(traffic["msgs_ici"]),
            "dcn_messages": int(traffic["msgs_dcn"]),
            "routes": dict(routes),
        }
    return out
