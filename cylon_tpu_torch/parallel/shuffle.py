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

:func:`exchange` takes the env, not a mesh.  In a multi-process world
(ctx/context.DistributedConfig) each process holds its V ranks' blocks:
:func:`count_targets` counts this process's ``(V, W)`` rows and one
allgather makes the ``(W, W)`` matrix the same everywhere; the exchange
keeps the rows bound for its own ranks on the device and moves the rest
with ``all_to_all_single`` (parallel/transport.py), split sizes from the
count matrix, in the reference's bounded rounds
(:func:`exchange_block_cap`, ``cylon_tpu/parallel/shuffle.py:330``).
Destination d still receives its rows in (global source rank, source
position) order, so the result is bit-equal to the one-process world's.
:func:`skew_targets` routes a semi/anti join's probe side with its heavy
keys spread round-robin (relational/join.py); :func:`skew_split_targets`
routes the adaptive skew split's probe side (relational/skew.py).

A hash shuffle's exchange runs the receive-budget guard first
(``guard=True``, :func:`_recv_guard`): the largest destination's receive,
known from the count sidecar, above ``EXCHANGE_RECV_BUDGET_BYTES`` raises
``PredictedResourceExhausted`` before anything is allocated, and the
retry ladder streams instead.  The count pull runs under the exchange
watchdog.  Every exchange that delivers adds to the always-on registry
counters ``exchange_rows_total``, ``exchange_bytes_total`` and
``exchange_count`` (host arithmetic on the pulled count matrix); with
the comm matrix armed
or a plan profile active it also records its matrix (obs/plan.
record_exchange).  After the route delivers, every exchange runs the
integrity tier (exec/integrity.py): the ``exchange.corrupt`` drill, the
always-on conservation laws over the count matrix and, armed
(``CYLON_TPU_TORCH_AUDIT=1``), the fingerprint of the inputs against
the outputs.

On a topology of two or more slices (topo/model.py) every exchange also
adds to the tier counters (``exchange_ici_*``/``exchange_dcn_*``: rows,
bytes, padded wire bytes and messages inside and across slices), and
under a hierarchical plan it runs the voted two-hop route
(topo/exchange.two_hop), whose hops drive this module's engine
(:func:`_move`) with their own count matrices.  With one slice the
route lookup is one cached dict lookup, and nothing else changes.  Not
ported (ROADMAP.md): the receive buffers' ledger registration.
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
from .. import topo as _topo
from ..utils.host import host_array
from . import transport
from .shards import local_world, span

#: the most ranks the exchange serves: its targets 0..W must fit uint8
MAX_WORLD = 255


def hash_targets(env, key_datas, key_valids, valid_counts) -> torch.Tensor:
    """Global ``(W·cap,)`` int32 target-rank array; padding rows get
    target W (the trash destination the exchange drops).  The hash is
    elementwise, so one pass serves every shard."""
    w = len(valid_counts)
    cap = key_datas[0].shape[0] // local_world(w)
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
    cap = n // local_world(w)
    first = span(w).start * cap
    spread = ((torch.arange(n, dtype=torch.int64, device=h.device) + first)
              % w).to(torch.int32)
    tgt = torch.where(heavy, spread, hashing.partition_targets(h, w))
    live = live_mask(valid_counts, cap, h.device)
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
    ranks = span(w)
    v = len(ranks)
    cap = key_datas[0].shape[0] // v
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
        ek = eq[:, k].view(v, cap).to(torch.int32)
        ck = (torch.cumsum(ek, 1, dtype=torch.int32) - ek).reshape(-1)
        loc = torch.where(eq[:, k], ck.to(torch.int64), loc)
        del ek, ck
    shard_of = torch.arange(ranks.start, ranks.stop,
                            device=dev).repeat_interleave(cap)
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
    per row.  In a distributed world each process counts its own ``(V,
    W)`` rows and one allgather makes the matrix whole."""
    w = env.world_size
    by_src = tgt.view(local_world(w), -1)
    counts = torch.stack([(by_src == d).sum(dim=1) for d in range(w)], dim=1)
    if transport.current(w) is not None:
        return transport.allgather_counts(counts)
    from ..exec.recovery import exchange_watchdog
    return exchange_watchdog("exchange.counts",
                             lambda: host_array(counts)).astype(np.int64)


def _guard_applies(env) -> bool:
    """Whether the receive budget binds: on the card only (a CPU run's
    receive lives in host memory)."""
    return env.on_cuda


def _recv_guard(env, out_cap: int, row_bytes: int, hplan=None,
                hprep=None) -> None:
    """The receive-budget guard, decided before the exchange allocates:
    the per-destination receive ``out_cap · row_bytes`` above
    ``EXCHANGE_RECV_BUDGET_BYTES`` (where :func:`_guard_applies`) raises
    ``PredictedResourceExhausted``.  Under a two-hop plan the need is
    the gateway buffers and the final ones together
    (topo/exchange.recv_guard_bytes).
    The ledger's colder spillable owners evict first to make room for
    the receive (``scheduler.free_pressure``, the serving tier's facade
    over the ledger).  An injected kind at
    ``shuffle.recv_guard`` raises that kind."""
    from ..exec import recovery, scheduler
    from ..status import PredictedResourceExhausted
    if hplan is not None:
        from ..topo import exchange as _topo_exchange
        need = _topo_exchange.recv_guard_bytes(hplan, hprep, out_cap,
                                               row_bytes)
    else:
        need = int(out_cap) * int(row_bytes)
    scheduler.free_pressure(env, need)
    over = bool(_guard_applies(env)
                and need > config.EXCHANGE_RECV_BUDGET_BYTES)
    kind, armed = recovery.probe("shuffle.recv_guard")
    if (over or armed) and recovery.guard_consensus(
            env, over or kind is not None):
        if kind is not None and kind != "predicted":
            raise recovery.make_fault(kind, "shuffle.recv_guard")
        hop1 = ("" if hplan is None else
                f" (two-hop route: {out_cap} final rows + "
                f"{hprep.cap1} gateway rows incl. the target "
                "sidecar — both tiers live at once)")
        raise PredictedResourceExhausted(
            f"RESOURCE_EXHAUSTED (predicted): exchange receive allocation "
            f"{need} B at {row_bytes} B/row{hop1} exceeds "
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
    # the topology route: one cached lookup, None on one slice
    hplan = _topo.hier_plan(env)
    hprep = None
    if hplan is not None:
        from ..topo import exchange as _topo_exchange
        hprep = _topo_exchange.prepare(hplan, counts)
    if guard:
        _recv_guard(env, out_cap, row_bytes, hplan, hprep)
    total = int(per_dest.sum())
    topo_t = _topo.topology(env)
    tiers = None
    if topo_t.n_slices > 1:
        tiers = _tier_counters(topo_t, counts, row_bytes, hplan, hprep)
    if _comm.armed() or _plan.active():
        _plan.record_exchange(counts, row_bytes, site=owner, tiers=tiers)
    if hplan is not None:
        _topo.ensure_adopted(env, hplan)
        outs, _pd = _topo_exchange.two_hop(env, hplan, tgt, counts,
                                           tuple(cols), out_cap, prep=hprep)
    else:
        outs = _move(env, tgt, counts, cols, out_cap)
    # counted once the route has delivered, so a route that raises (an
    # OOM the ladder retries, a desync) leaves the registry in step with
    # the conservation tier's mirror of it
    _metrics.counter("exchange_rows_total").inc(total)
    _metrics.counter("exchange_bytes_total").inc(total * row_bytes)
    _metrics.counter("exchange_count").inc()
    # the integrity tier (exec/integrity.py), on every route: the
    # corruption drill first (so the audit below is what catches it),
    # the always-on conservation laws, then, armed, the fingerprint of
    # the valid input rows against the delivered ones
    from ..exec import integrity, recovery
    if recovery.maybe_inject("exchange.corrupt",
                             intercept=("corrupt",)) == "corrupt":
        recovery._record("exchange.corrupt", "corrupt", "flipped")
        outs = integrity.flip_one(env, outs, per_dest, out_cap)
    integrity.conserve_exchange(counts, per_dest, total, row_bytes,
                                site=owner)
    if integrity.armed():
        integrity.verify_exchange(env, tgt, cols, outs, per_dest, out_cap,
                                  site=owner)
    return outs, per_dest


def _tier_counters(topo_t, counts: np.ndarray, row_bytes: int, hplan,
                   hprep) -> dict:
    """Add one exchange to the always-on tier counters of a topology of
    two or more slices, whatever the route: payload rows and bytes inside
    ("ici") and across ("dcn") slices, and each tier's padded wire bytes
    and messages (topo/exchange.tier_traffic).  Returns the comm
    matrix's ``tiers`` record."""
    from ..topo import exchange as _topo_exchange
    route = "two_hop" if hplan is not None else "flat"
    ici_rows, dcn_rows = _topo.tier_split(counts, topo_t)
    traffic = _topo_exchange.tier_traffic(topo_t, counts, row_bytes, route,
                                          prep=hprep)
    for name, value in (("ici_rows", ici_rows), ("dcn_rows", dcn_rows),
                        ("ici_bytes", ici_rows * row_bytes),
                        ("dcn_bytes", dcn_rows * row_bytes),
                        ("ici_wire_bytes", traffic["wire_ici"]),
                        ("dcn_wire_bytes", traffic["wire_dcn"]),
                        ("ici_messages", traffic["msgs_ici"]),
                        ("dcn_messages", traffic["msgs_dcn"])):
        _metrics.counter(f"exchange_{name}_total").inc(value)
    return {"slice_ids": topo_t.slice_ids(), "route": route, **traffic}


def _move(env, tgt: torch.Tensor, counts: np.ndarray, cols: tuple,
          out_cap: int, group=None) -> tuple:
    """The exchange engine under one count matrix: every array of
    ``cols`` to its rows' targets, destination d's rows in (source rank,
    source position) order in an ``out_cap``-row block.  In one process
    a stable sort and one gather per destination; across processes
    :func:`_exchange_procs` (on ``group``, a two-hop route's subgroup,
    when given)."""
    w = counts.shape[0]
    per_dest = counts.sum(axis=0).astype(np.int64)
    # stable: equal targets keep their global (source-major) order
    order = torch.sort(tgt.to(torch.uint8), stable=True).indices
    proc = transport.current(w)
    if proc is not None and proc.nproc > 1:
        return _exchange_procs(proc, order, counts, cols, out_cap, group)
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
    return tuple(outs)


def exchange_block_cap(total: int, w: int) -> int:
    """Per-(source, destination) block bound of one all-to-all round:
    about twice the uniform stream, floored so small tables take one
    round (the reference's ``cylon_tpu/parallel/shuffle.py:330``)."""
    uniform = -(-int(total) // max(w * w, 1))
    return config.pow2ceil(max(2 * uniform, 8192))


def _exchange_procs(proc, order: torch.Tensor, counts: np.ndarray,
                    cols: tuple, out_cap: int, group=None) -> tuple:
    """The exchange of a multi-process world.  ``order`` sorts this
    process's rows by destination (stable, so local source order stays
    within one).  Rows bound for this process's own ranks are gathered
    on the device; the others go to their process with
    ``all_to_all_single``, the stream from process p to process q cut
    into rounds of at most one block.  Each local destination d then
    takes, process by process, the rows of p's sources: (global source
    rank, source position) order.  With ``group`` (a two-hop route's
    hop, parallel/transport.hop_groups) only its member processes take
    part, ``counts`` being the hop's matrix, whose rows from this process
    all go to members, and the rounds are sized by
    topo/exchange.hop_block."""
    v, me = proc.local, proc.pid
    members = tuple(range(proc.nproc)) if group is None else group.members
    p_n = len(members)
    mi = members.index(me)
    w = counts.shape[0]
    mine = slice(me * v, (me + 1) * v)
    # this process's rows per destination, and their offsets in `order`
    csend = counts[mine].sum(axis=0)
    sstart = np.concatenate([[0], np.cumsum(csend)]).astype(np.int64)
    # rows from member p's sources to member q's ranks
    pair = counts.reshape(proc.nproc, v, proc.nproc, v).sum(axis=(1, 3))
    pair = pair[np.ix_(members, members)]
    cross = pair.copy()
    np.fill_diagonal(cross, 0)
    max_c = int(cross.max(initial=0))
    if group is None:
        block = config.pow2ceil(min(max(max_c, 1), exchange_block_cap(
            int(cross.sum()), p_n)))
    else:
        from ..topo.exchange import hop_block
        block, _r = hop_block(cross, int(cross.sum()), p_n, p_n)
    rounds = -(-max_c // block) if max_c else 0
    # where destination d's rows sit in the stream from member p: the
    # sender orders by destination, then by its own source rank
    from_p = counts.reshape(proc.nproc, v, w).sum(axis=1)[
        list(members)][:, mine]                                # (P, V)
    soff = np.concatenate([np.zeros((p_n, 1), np.int64),
                           np.cumsum(from_p, axis=1)], axis=1)
    transport.STATS["exchanges"] += 1
    outs = []
    for col in cols:
        rest = tuple(col.shape[1:])
        streams = [None] * p_n
        for qi in range(p_n):
            if qi != mi:
                streams[qi] = torch.empty((int(pair[qi, mi]),) + rest,
                                          dtype=col.dtype, device=col.device)
        for r in range(rounds):
            lo = r * block
            send_n = [0 if qi == mi else int(min(max(cross[mi, qi] - lo, 0),
                                                 block))
                      for qi in range(p_n)]
            recv_n = [0 if qi == mi else int(min(max(cross[qi, mi] - lo, 0),
                                                 block))
                      for qi in range(p_n)]
            idx = torch.cat([order[int(sstart[q * v]) + lo:
                                   int(sstart[q * v]) + lo + send_n[qi]]
                             for qi, q in enumerate(members)])
            got = transport.all_to_all_rows(col.index_select(0, idx),
                                            send_n, recv_n, group=group)
            del idx
            at = 0
            for qi in range(p_n):
                if recv_n[qi]:
                    streams[qi][lo:lo + recv_n[qi]] = got[at:at + recv_n[qi]]
                    at += recv_n[qi]
            del got
        out = torch.empty((v * out_cap,) + rest, dtype=col.dtype,
                          device=col.device)
        for i in range(v):
            d = me * v + i
            blk = out[i * out_cap:(i + 1) * out_cap]
            at = 0
            for qi in range(p_n):
                if qi == mi:
                    a, b = int(sstart[d]), int(sstart[d + 1])
                    torch.index_select(col, 0, order[a:b],
                                       out=blk[at:at + b - a])
                    at += b - a
                else:
                    a, b = int(soff[qi, i]), int(soff[qi, i + 1])
                    blk[at:at + b - a] = streams[qi][a:b]
                    at += b - a
            blk[at:] = 0
        del streams
        outs.append(out)
    return tuple(outs)
