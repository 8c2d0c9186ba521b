"""The exchange: hash targets, the count sidecar and the order-preserving
all-to-all (port of ``cylon_tpu/parallel/shuffle.py``).

The reference moves rows between devices with padded ``lax.all_to_all``
rounds under ``shard_map``; the multi-round protocol (``_prep_fn``,
``_round_fn``) exists only to bound each TPU's send buffers.  Here every
shard of a :class:`~cylon_tpu_torch.ctx.context.VirtualMeshConfig` world
lives in one tensor on one device, source-major, so the all-to-all is one
device-local permutation: a STABLE sort of the global target array puts
the rows in (destination, source rank, source position) order — exactly
the reference's receive contract — and one gather per destination writes
each destination shard's rows into a zero-padded block of ``out_cap``
rows.  The targets hold values 0..W (W = padding, dropped), so they sort
as uint8 keys — one radix pass instead of four; :func:`exchange` refuses
a world of more than :data:`MAX_WORLD` ranks.

:func:`exchange` takes the env, not a mesh, so the multi-card transport
(NCCL ``all_to_all_single`` with split sizes from the count sidecar, or
peer copies under one controller) slots in behind the same interface.
:func:`skew_targets` routes a semi/anti join's probe side with its heavy
keys spread round-robin (relational/join.py); :func:`skew_split_targets`
routes the adaptive skew split's probe side (relational/skew.py).

A hash shuffle's exchange runs the receive-budget guard first
(``guard=True``, :func:`_recv_guard`): the largest destination's receive,
known from the count sidecar, above ``EXCHANGE_RECV_BUDGET_BYTES`` raises
``PredictedResourceExhausted`` before anything is allocated, and the
retry ladder streams instead.  The count pull runs under the exchange
watchdog.  Every exchange adds to the always-on registry counters
``exchange_rows_total``, ``exchange_bytes_total`` and ``exchange_count``
(host arithmetic on the pulled count matrix); with the comm matrix armed
or a plan profile active it also records its matrix (obs/plan.
record_exchange).  Not ported (ROADMAP.md): the two-hop topology route
and its tier counters, the receive buffers' ledger registration and the
integrity audit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..obs import comm as _comm
from ..obs import metrics as _metrics
from ..obs import plan as _plan
from ..ops import hashing
from ..relational.common import live_mask
from ..status import InvalidError
from ..utils.host import host_array

#: the most ranks the exchange serves: its targets 0..W must fit uint8
MAX_WORLD = 255


def hash_targets(env, key_datas, key_valids, valid_counts) -> torch.Tensor:
    """Global ``(W·cap,)`` int32 target-rank array; padding rows get
    target W (the trash destination the exchange drops).  The hash is
    elementwise, so one pass serves every shard."""
    w = len(valid_counts)
    cap = key_datas[0].shape[0] // w
    with_valids = any(v is not None for v in key_valids)
    h = hashing.hash_rows(list(key_datas),
                          list(key_valids) if with_valids else None)
    tgt = hashing.partition_targets(h, env.world_size)
    del h
    live = live_mask(valid_counts, cap, key_datas[0].device)
    return torch.where(live, tgt, torch.full((), w, dtype=torch.int32,
                                             device=tgt.device))


def skew_targets(env, h: torch.Tensor, valid_counts,
                 heavy: torch.Tensor) -> torch.Tensor:
    """Global ``(W·cap,)`` int32 targets from the row hashes ``h``, with
    the rows flagged ``heavy`` spread round-robin by global position
    instead (the build side replicates those keys, so any rank can join
    them); padding rows get target W."""
    w = len(valid_counts)
    n = h.shape[0]
    spread = (torch.arange(n, dtype=torch.int64, device=h.device) % w).to(
        torch.int32)
    tgt = torch.where(heavy, spread, hashing.partition_targets(h, w))
    live = live_mask(valid_counts, n // w, h.device)
    return torch.where(live, tgt, torch.full((), w, dtype=torch.int32,
                                             device=h.device))


def skew_split_targets(env, key_datas, key_valids, valid_counts, need_nf,
                       narrow, tuple_ops, src_off, fanout,
                       start) -> torch.Tensor:
    """Global ``(W·cap,)`` int32 targets of the adaptive skew split's probe
    side, for the plan facade (relational/skew.py), which derives every
    sidecar.  Light rows hash as usual.  Row ``j`` of heavy key ``k``, in
    global (source rank, source position) order, goes to rank
    ``(start[k] + j mod fanout[k]) mod W``: each member of the key's
    group receives a fixed-stride, order-preserving subsequence of the
    key's rows, and every source's heavy rows spread over the whole
    group.  A row is heavy when its key operands equal one of the K
    tuples' (``tuple_ops``, ops/pack.rows_cmp_splitters).  ``src_off``
    (W, K) holds each key's rows on the lower ranks; the within-key index
    is int64, since one heavy key can pass 2^31 rows.  Padding rows get
    target W."""
    from ..ops import pack
    w = len(valid_counts)
    cap = key_datas[0].shape[0] // w
    dev = key_datas[0].device
    live = live_mask(valid_counts, cap, dev)
    with_valids = any(v is not None for v in key_valids)
    h = hashing.hash_rows(list(key_datas),
                          list(key_valids) if with_valids else None)
    tgt = hashing.partition_targets(h, w)
    del h
    ko_r = pack.key_operands(list(key_datas), list(key_valids),
                             need_null_flags=need_nf, narrow32=narrow)
    _gt, eq = pack.rows_cmp_splitters(ko_r, tuple_ops)
    del ko_r, _gt
    eq &= live[:, None]
    heavy = eq.any(dim=1)
    # the first equal tuple, as the reference's argmax (bool has none)
    kidx = eq.to(torch.uint8).argmax(dim=1)
    # the heavy tuples are distinct, so a row matches one key at most: its
    # index among its key's rows on its shard is a per-shard running
    # count of that key's flags
    loc = torch.zeros(eq.shape[0], dtype=torch.int64, device=dev)
    for k in range(eq.shape[1]):
        ek = eq[:, k].view(w, cap).to(torch.int32)
        ck = (torch.cumsum(ek, 1, dtype=torch.int32) - ek).reshape(-1)
        loc = torch.where(eq[:, k], ck.to(torch.int64), loc)
        del ek, ck
    shard_of = torch.arange(w, device=dev).repeat_interleave(cap)
    soff = torch.from_numpy(np.asarray(src_off, np.int64)).to(dev)
    fan = torch.from_numpy(np.asarray(fanout, np.int64)).to(dev)
    st = torch.from_numpy(np.asarray(start, np.int64)).to(dev)
    j = soff[shard_of, kidx] + loc
    del loc, shard_of
    tgt_h = ((st[kidx] + j % fan[kidx]) % w).to(torch.int32)
    tgt = torch.where(heavy, tgt_h, tgt)
    return torch.where(live, tgt, torch.full((), w, dtype=torch.int32,
                                             device=dev))


def count_targets(env, tgt: torch.Tensor) -> np.ndarray:
    """(W, W) host count matrix: ``C[s, d]`` = rows rank s sends to rank
    d, from one compare-and-sum over the shards per destination and one
    pull (an atomic histogram, ``torch.bincount``, measured slower on the
    card and waits on the host to size its output).  The work grows as
    W²·cap (W passes over the W·cap targets); the temporary is one byte
    per row."""
    w = env.world_size
    by_src = tgt.view(w, -1)
    counts = torch.stack([(by_src == d).sum(dim=1) for d in range(w)], dim=1)
    from ..exec.recovery import exchange_watchdog
    return exchange_watchdog("exchange.counts",
                             lambda: host_array(counts)).astype(np.int64)


def _guard_applies(env) -> bool:
    """Whether the receive budget binds: on the card only (a CPU run's
    receive lives in host memory)."""
    return env.on_cuda


def _recv_guard(env, out_cap: int, row_bytes: int) -> None:
    """The receive-budget guard, decided before the exchange allocates:
    the per-destination receive ``out_cap · row_bytes`` above
    ``EXCHANGE_RECV_BUDGET_BYTES`` (where :func:`_guard_applies`) raises
    ``PredictedResourceExhausted``.
    The ledger's colder spillable owners evict first to make room for
    the receive (``scheduler.free_pressure``, the serving tier's facade
    over the ledger).  An injected kind at
    ``shuffle.recv_guard`` raises that kind."""
    from ..exec import recovery, scheduler
    from ..status import PredictedResourceExhausted
    need = int(out_cap) * int(row_bytes)
    scheduler.free_pressure(env, need)
    over = bool(_guard_applies(env)
                and need > config.EXCHANGE_RECV_BUDGET_BYTES)
    kind, armed = recovery.probe("shuffle.recv_guard")
    if (over or armed) and recovery.guard_consensus(
            env, over or kind is not None):
        if kind is not None and kind != "predicted":
            raise recovery.make_fault(kind, "shuffle.recv_guard")
        raise PredictedResourceExhausted(
            f"RESOURCE_EXHAUSTED (predicted): exchange receive allocation "
            f"{need} B at {row_bytes} B/row exceeds "
            f"CYLON_TPU_TORCH_EXCHANGE_RECV_BUDGET "
            f"({config.EXCHANGE_RECV_BUDGET_BYTES} B); one destination "
            "shard would materialize the bulk of the table",
            site="shuffle.recv_guard")


def exchange(env, tgt: torch.Tensor, counts: np.ndarray, cols: tuple,
             guard: bool = False, owner: str = "shuffle.recv"):
    """Move every array of ``cols`` (each ``(W·cap, ...)``, source-major)
    to its rows' target ranks.  Destination shard d receives its rows
    ordered by (source rank, source position) in the first
    ``counts[:, d].sum()`` rows of an ``out_cap``-row block, zeros after,
    with ``out_cap = pow2ceil(max rows any destination receives)``.
    Returns ``(new_cols, new_valid_counts)``, the counts being
    ``counts.sum(axis=0)``.  ``guard``: run the receive-budget guard
    first (hash shuffles, whose callers sit under the OOM fallbacks).
    ``owner`` labels the receive in the plan's and the comm matrix's
    exchange records (a stream append passes ``stream.recv``)."""
    w = counts.shape[0]
    if w > MAX_WORLD:
        raise InvalidError(f"the exchange sorts its targets as uint8 keys: "
                           f"world size must be at most {MAX_WORLD}, got {w}")
    per_dest = counts.sum(axis=0).astype(np.int64)
    out_cap = config.pow2ceil(int(per_dest.max()) if per_dest.size else 1)
    row_bytes = sum(c.element_size() * int(np.prod(c.shape[1:],
                                                   dtype=np.int64))
                    for c in cols)
    if guard:
        _recv_guard(env, out_cap, row_bytes)
    total = int(per_dest.sum())
    _metrics.counter("exchange_rows_total").inc(total)
    _metrics.counter("exchange_bytes_total").inc(total * row_bytes)
    _metrics.counter("exchange_count").inc()
    if _comm.armed() or _plan.active():
        _plan.record_exchange(counts, row_bytes, site=owner)
    # stable: equal targets keep their global (source-major) order
    order = torch.sort(tgt.to(torch.uint8), stable=True).indices
    starts = np.concatenate([[0], np.cumsum(per_dest)])
    outs = []
    for col in cols:
        out = torch.empty((w * out_cap,) + tuple(col.shape[1:]),
                          dtype=col.dtype, device=col.device)
        for d in range(w):
            a, b = int(starts[d]), int(starts[d + 1])
            blk = out[d * out_cap:(d + 1) * out_cap]
            torch.index_select(col, 0, order[a:b], out=blk[:b - a])
            blk[b - a:] = 0
        outs.append(out)
    return tuple(outs), per_dest
