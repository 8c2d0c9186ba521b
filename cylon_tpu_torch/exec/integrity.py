"""The data-integrity audit tier (port of ``cylon_tpu/exec/integrity.py``).

Pages at rest are sha256-checked elsewhere (spill and disk pages,
checkpoint pages, the compile tier's kernel libraries).  This module
audits data in flight, in three layers, as the reference does:

1. **Conservation laws, always on.**  Every exchange has already pulled
   its (W, W) count matrix to the host.  :func:`conserve_exchange`
   checks that no count is negative, that the column sums equal the
   delivered per-destination counts and that the grand total equals the
   logical row total, then reconciles the running totals against the
   registry's ``exchange_rows_total``/``exchange_bytes_total`` (a
   registry reset between exchanges resyncs instead of raising).
   :func:`conserve_hops` checks the two-hop route's four identities.
   Host arithmetic only: no device work, no sync, no collective.

2. **Order-invariant fingerprints, armed by ``CYLON_TPU_TORCH_AUDIT=1``**
   (:func:`armed`, the one switch ``config.audit_armed`` also serves to
   the groupby's saturation guard).  Each valid row hashes every data
   and validity lane of every array into one u32 avalanche chain
   (``ops/hashing``'s mix), finalized twice for 64 bits; rows outside
   the mask give the XOR identity, and the XOR of every row is the
   fingerprint — invariant to row order, placement and world size, and
   bit-equal to the reference's for the same table.  Nothing is
   canonicalized: -0.0, a low mantissa bit or a validity bit changes it.
   torch has no XOR reduction, so the rows fold by halving; the u32
   chain runs in int64 under 32-bit masks (torch has no CUDA bitwise
   ops for uint32).  Across processes each process folds its own shards
   and the (2,) words are allgathered and folded on the host (NCCL has
   no XOR reduce).  The pull runs under the exchange watchdog at site
   ``audit.verify``, and every audited value is voted
   (``recovery.fingerprint_consensus``) before anyone raises or
   proceeds.

3. **Recovery.**  A violation raises a typed ``DataIntegrityError``
   (``site``, ``phase``); the ladder's ``Code.IntegrityFault`` rung
   recomputes the stage once and aborts typed on a repeat.

Unarmed, the tier costs the host arithmetic of layer 1 and one cached
list load per boundary.  The fingerprint is plain torch work, not a
kernel: the reference computes it in XLA, not in Pallas.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..obs import metrics as _metrics
from ..ops import hashing
from ..status import DataIntegrityError

_STATS = _metrics.group("audit", (
    "conservation_checks", "fingerprint_checks", "fingerprint_votes",
    "violations", "rows_reconciled", "bytes_reconciled",
    "reconcile_resyncs", "manifest_fps", "manifest_audits",
    "corruptions_injected"))

_M32 = 0xFFFFFFFF


def stats() -> dict:
    return dict(_STATS)


def reset_stats() -> None:
    """Zero the counters.  Not a registry reset: the reconcile mirror is
    re-seeded from the live exchange counters, or the next conservation
    check would see them running ahead and raise."""
    for k in _STATS:
        _STATS[k] = 0
    _STATS["rows_reconciled"] = _metrics.counter(
        "exchange_rows_total").value
    _STATS["bytes_reconciled"] = _metrics.counter(
        "exchange_bytes_total").value


def armed() -> bool:
    """True while ``CYLON_TPU_TORCH_AUDIT=1`` arms the fingerprint layer
    (cached; :func:`rearm` reads the environment again)."""
    return config.audit_armed()


def rearm() -> None:
    config.rearm_audit()


# ---------------------------------------------------------------------------
# layer 1: conservation laws, host arithmetic on the count matrix
# ---------------------------------------------------------------------------

def conserve_exchange(counts, per_dest, total: int, row_bytes: int, *,
                      site: str = "shuffle.recv",
                      phase: str = "post_exchange") -> None:
    """The always-on check of one exchange's (W, W) count matrix: every
    row a source sent is received by the destination the matrix names.
    Then the running totals reconcile against the registry counters: a
    route that moves rows without counting them (or counts rows it never
    moved) raises here; counters that went backwards (a registry reset)
    resync."""
    _STATS["conservation_checks"] += 1
    c = np.asarray(counts)
    pd = np.asarray(per_dest)
    bad = None
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        bad = f"count sidecar shape {c.shape} is not (W, W)"
    elif (c < 0).any():
        s, d = np.argwhere(c < 0)[0]
        bad = f"negative count {int(c[s, d])} at (src={s}, dst={d})"
    elif not np.array_equal(c.sum(axis=0), pd):
        col = c.sum(axis=0)
        d = int(np.argwhere(col != pd)[0][0])
        bad = (f"rows-received mismatch at dst={d}: sidecar column sum "
               f"{int(col[d])} != delivered {int(pd[d])}")
    elif int(c.sum()) != int(total):
        bad = (f"rows-sent total {int(c.sum())} != logical row total "
               f"{int(total)}")
    if bad is not None:
        _STATS["violations"] += 1
        raise DataIntegrityError(
            f"exchange conservation law violated at {site}: {bad}",
            site=site, phase=phase)
    _STATS["rows_reconciled"] += int(total)
    _STATS["bytes_reconciled"] += int(total) * int(row_bytes)
    rows_seen = _metrics.counter("exchange_rows_total").value
    bytes_seen = _metrics.counter("exchange_bytes_total").value
    if (_STATS["rows_reconciled"] == rows_seen
            and _STATS["bytes_reconciled"] == bytes_seen):
        return
    if (rows_seen < _STATS["rows_reconciled"]
            or bytes_seen < _STATS["bytes_reconciled"]):
        _STATS["rows_reconciled"] = rows_seen
        _STATS["bytes_reconciled"] = bytes_seen
        _STATS["reconcile_resyncs"] += 1
        return
    _STATS["violations"] += 1
    raise DataIntegrityError(
        f"exchange counter reconciliation failed at {site}: "
        f"exchange_rows_total={rows_seen} / exchange_bytes_total="
        f"{bytes_seen} ran ahead of the audited sidecar totals "
        f"({_STATS['rows_reconciled']} rows / "
        f"{_STATS['bytes_reconciled']} B) — a route moved or counted "
        "rows outside the audited exchange path",
        site=site, phase=phase)


def conserve_hops(counts, c1, c2, *, site: str = "topo.exchange",
                  phase: str = "post_exchange") -> None:
    """The two-hop route's identities over its hop count matrices: no
    hop count is negative, hop 1 sends what each source holds, hop 2
    delivers what each destination is owed, and every row hop 1 parks at
    a gateway leaves on hop 2."""
    _STATS["conservation_checks"] += 1
    c = np.asarray(counts)
    a = np.asarray(c1)
    b = np.asarray(c2)
    bad = None
    if (a < 0).any() or (b < 0).any():
        bad = "negative hop count"
    elif not np.array_equal(a.sum(axis=1), c.sum(axis=1)):
        bad = "hop-1 row sums != sidecar row sums (rows lost before ICI)"
    elif not np.array_equal(b.sum(axis=0), c.sum(axis=0)):
        bad = "hop-2 column sums != sidecar column sums (rows lost on DCN)"
    elif not np.array_equal(a.sum(axis=0), b.sum(axis=1)):
        bad = "gateway imbalance: hop-1 arrivals != hop-2 departures"
    if bad is not None:
        _STATS["violations"] += 1
        raise DataIntegrityError(
            f"two-hop conservation law violated at {site}: {bad}",
            site=site, phase=phase)


# ---------------------------------------------------------------------------
# layer 2: order-invariant content fingerprints (armed)
# ---------------------------------------------------------------------------

#: the per-row chain's seed and the two finalization tweaks (lo, hi)
_FP_SEED = 0x243F6A88
_FP_LO = 0xA5A5A5A5
_FP_HI = 0x3C3C3C3C


def _audit_lanes(a: torch.Tensor) -> list:
    """The exact u32 lanes of a 1-D array, as int64 tensors: bool 0/1;
    a float's bits (float64 as its two int32 halves, low word first;
    narrower floats widened to float32 first); integers as the routing
    hash splits them (``hashing._u32_lanes``).  Unlike the routing hash
    nothing is canonicalized."""
    dt = a.dtype
    if dt == torch.bool:
        return [a.to(torch.int64)]
    if dt.is_floating_point:
        if dt == torch.float64:
            pair = a.contiguous().view(torch.int32).view(-1, 2)
            return [pair[:, 0].to(torch.int64) & _M32,
                    pair[:, 1].to(torch.int64) & _M32]
        if dt != torch.float32:
            a = a.to(torch.float32)
        return [a.view(torch.int32).to(torch.int64) & _M32]
    return hashing._u32_lanes(a)


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR of the rows of ``x`` along dim 1 (torch has no XOR reduction):
    fold by halving, an odd length padded with the identity 0."""
    while x.shape[1] > 1:
        n = x.shape[1]
        if n % 2:
            x = torch.cat([x, x.new_zeros((x.shape[0], 1))], dim=1)
            n += 1
        x = x[:, :n // 2] ^ x[:, n // 2:]
    if x.shape[1] == 0:
        return x.new_zeros((x.shape[0],))
    return x[:, 0]


def _local_pair(arrays, mask: torch.Tensor) -> torch.Tensor:
    """The (2,) int64 XOR of this process's masked rows: one chain per
    row over every lane of every array (each column of a 2-D array in
    turn), finalized with the lo and hi tweaks."""
    n = mask.shape[0]
    h = torch.full((n,), _FP_SEED, dtype=torch.int64, device=mask.device)
    for a in arrays:
        cols = [a[:, j] for j in range(a.shape[1])] if a.dim() == 2 else [a]
        for s in cols:
            for lane in _audit_lanes(s):
                h = hashing._mix32(
                    h ^ ((lane + hashing._GOLD + (h << 6) + (h >> 2))
                         & _M32))
    zero = torch.zeros((), dtype=torch.int64, device=mask.device)
    lo = torch.where(mask, hashing._mix32(h ^ _FP_LO), zero)
    hi = torch.where(mask, hashing._mix32(h ^ _FP_HI), zero)
    del h
    return _xor_fold(torch.stack([lo, hi]))


def _pull_fp(pair: torch.Tensor) -> int:
    """The audit's one sync: this process's (2,) words pulled, the
    processes' words allgathered and XOR-folded, under the exchange
    watchdog at ``audit.verify`` (an injected or real hang there surfaces
    as ``RankDesyncError``)."""
    from . import recovery
    from ..parallel import transport
    stalled = recovery.injected("audit.verify") == "stall"

    def pull():
        words = pair.cpu().numpy().astype(np.int64)
        if transport.current() is not None:
            words = np.bitwise_xor.reduce(
                transport.allgather_array(words, "audit.verify"), axis=0)
        return words

    words = recovery.exchange_watchdog("audit.verify", pull,
                                       stalled=stalled)
    return (int(words[1]) << 32) | int(words[0])


def partition_fingerprint(env, arrays, *, prefix_counts=None,
                          cap: int = 0, targets=None) -> int:
    """64-bit order-invariant fingerprint of the valid rows of ``arrays``
    (this process's ``(V·cap, ...)`` blocks; pass data and validity
    arrays alike).  The mask is either ``prefix_counts`` (the global
    (W,) valid counts: the first rows of each ``cap``-row shard are
    live) or ``targets`` (the exchange's target ranks: rows with
    ``tgt < W``)."""
    from ..relational.common import live_mask
    arrs = tuple(arrays)
    if targets is not None:
        mask = targets < env.world_size
    else:
        mask = live_mask(np.asarray(prefix_counts), int(cap),
                         arrs[0].device)
    return _pull_fp(_local_pair(arrs, mask))


def table_fingerprint(table) -> int:
    """Fingerprint of a Table's content: every column's data and validity
    in sorted column-name order, masked to each shard's valid prefix.
    Invariant to the world size, so a checkpoint piece re-blocked onto
    another world fingerprints the same."""
    arrs = []
    for name in sorted(table.columns):
        col = table.columns[name]
        arrs.append(col.data)
        if col.validity is not None:
            arrs.append(col.validity)
    return partition_fingerprint(table.env, arrs,
                                 prefix_counts=table.valid_counts,
                                 cap=table.capacity)


def verify_exchange(env, tgt, cols, outs, per_dest, out_cap: int, *,
                    site: str = "shuffle.recv",
                    phase: str = "post_exchange") -> None:
    """Armed fingerprint conservation across an exchange: the XOR of the
    valid input rows (a real target) must equal that of the delivered
    rows, whatever route carried them.  The output fingerprint is voted
    first, so the raise-or-proceed decision is the same on every
    process."""
    fp_in = partition_fingerprint(env, cols, targets=tgt)
    fp_out = partition_fingerprint(env, outs, prefix_counts=per_dest,
                                   cap=out_cap)
    _STATS["fingerprint_checks"] += 1
    from . import recovery
    recovery.fingerprint_consensus(env, fp_out)
    _STATS["fingerprint_votes"] += 1
    if fp_in != fp_out:
        _STATS["violations"] += 1
        raise DataIntegrityError(
            f"fingerprint conservation violated at {site}: inputs "
            f"{fp_in:#018x} != outputs {fp_out:#018x} — a received "
            "buffer was mutated in flight",
            site=site, phase=phase)


def audit_table(table, *, site: str, phase: str) -> int:
    """Armed stage-boundary audit of a whole table (a stitched output, an
    absorbed stream batch, an assembled pipeline output): its fingerprint,
    voted.  Returns the fingerprint."""
    fp = table_fingerprint(table)
    _STATS["fingerprint_checks"] += 1
    from . import recovery
    recovery.fingerprint_consensus(table.env, fp)
    _STATS["fingerprint_votes"] += 1
    return fp


def audit_restored_table(table, recorded_fp, *, site: str = "ckpt.audit",
                         phase: str = "resume") -> None:
    """The resume audit: a restored checkpoint piece's fingerprint against
    the one its manifest recorded.  Catches what the page shas cannot (a
    rewrite whose hashes agree, a re-block fault).  A mismatch raises
    ``DataIntegrityError``, which the checkpoint layer treats as a sha
    miss: recompute, never adopt.  Unarmed, or with nothing recorded,
    nothing is checked."""
    if recorded_fp is None or not armed():
        return
    fp = table_fingerprint(table)
    _STATS["manifest_audits"] += 1
    if int(fp) != int(recorded_fp):
        _STATS["violations"] += 1
        raise DataIntegrityError(
            f"checkpoint piece content fingerprint mismatch at {site}: "
            f"manifest recorded {int(recorded_fp):#018x}, restored "
            f"content fingerprints to {fp:#018x} — refusing to adopt",
            site=site, phase=phase)


def manifest_fingerprint(table) -> int | None:
    """The fingerprint a checkpoint manifest entry records at save time:
    armed sessions only (unarmed saves record None)."""
    if not armed():
        return None
    fp = table_fingerprint(table)
    _STATS["manifest_fps"] += 1
    return fp


# ---------------------------------------------------------------------------
# the exchange.corrupt drill: flip ONE element of a delivered buffer
# ---------------------------------------------------------------------------

def flip_one(env, arrays, per_dest, out_cap: int):
    """Corrupt exactly one element of one delivered array, in place: row
    0 of the shard that received the most rows (a valid row, so the flip
    is never masked out) among this process's shards.  The first integer
    or bool array takes an XOR of bit 0; a float array (when none is
    integral) takes +1.  Returns the arrays; a zero-row exchange is left
    untouched."""
    from ..parallel.shards import span
    ranks = span(env.world_size)
    pd = np.asarray(per_dest)[ranks.start:ranks.stop]
    if pd.size == 0 or int(pd.max()) <= 0:
        return tuple(arrays)
    row = int(pd.argmax()) * int(out_cap)
    arrays = tuple(arrays)
    i = next((j for j, a in enumerate(arrays)
              if a.dtype == torch.bool or not a.dtype.is_floating_point), 0)
    a = arrays[i]
    idx = (row,) + (0,) * (a.dim() - 1)
    if a.dtype == torch.bool:
        a[idx] = ~a[idx]
    elif a.dtype.is_floating_point:
        a[idx] = a[idx] + 1
    else:
        a[idx] = a[idx] ^ 1
    _STATS["corruptions_injected"] += 1
    return arrays
