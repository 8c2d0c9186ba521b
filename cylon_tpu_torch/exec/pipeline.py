"""Range-partitioned pipelined join and its streaming groupby sink, and the
chunked set operation (port of ``cylon_tpu/exec/pipeline.py``).

At world size W > 1 both sides hash-shuffle ONCE first (build side, then
probe side), so equal keys share a shard; every step below then runs on
each shard alone, with W·(R-1) splitters, (W, R) range geometry and one
pow2 piece capacity per range taken over the shards.  The join tiles
over KEY RANGES of the once-sorted build side:

  1. sort the build side (``right``) once by key;
  2. snap R-1 evenly spaced positions forward to key-group starts, so a
     key's whole build run lives in one range; the key operands at those
     positions are the splitters;
  3. give every probe row (``left``) its range id — how many splitters
     compare ``<=`` its key tuple, the splitter probe (K2,
     ``ops/splitter_probe.py``) — and stable-sort the probe side by it once;
  4. pack both sorted sides into lane matrices and join range piece pairs,
     contiguous windows of the two, each with the ordinary two-phase join.

Each piece's sort scratch and output are 1/R of the monolith's, which is
how a join larger than the card's memory runs at all.  A key's matches
never leave its range, so a :class:`GroupBySink` keyed on the join keys
sees each group in exactly one piece: its per-piece partials are the
final groups.  With a sink, piece joins defer and the sink aggregates
each piece's sorted state through the fused pushdown (relational/fused.py,
whose run-start gather is K1).  ``n_chunks == 1`` equals the monolithic
join.

The setup phases (build sort, range bounds, probe targets, probe sort)
chain on device tensors with no host wait in between; their two host
sidecars — the range boundaries and the per-range probe counts — come back
in ONE batched pull after the probe sort (:func:`_pull_phase_outputs`,
where a fault of any queued phase surfaces typed).  The splitters stay
on the device: K2 reads them from device memory.

The packed sources are spillable ledger owners (exec/memory.py): when
the budget cannot hold both, the colder evicts to pinned host memory and
each piece uploads its window alone, on a side stream.  Piece r+1's
windows are uploaded while piece r computes (:class:`_PieceFuture`; the
depth is :func:`memory.prefetch_depth`'s), and a typed fault raised while
preparing a piece ahead is held until that piece is consumed, so the
retry ladder sees faults in the same order either way.

Every ``how`` of the reference streams: ranges partition the KEY space,
so a key's rows on both sides meet in one piece, and an unmatched row of
either side is unmatched in its piece too.  A left join runs every range
with probe rows, a right join every range with build rows, an outer join
both.  Only inner pieces defer; the others materialize, and a sink takes
the sort-based groupby over them.

:func:`pipelined_set_op` streams one side of a set operation through
row chunks (:func:`chunk_table`) against the other side shuffled once,
and takes one distinct pass over the partials.
:func:`pipelined_scan_join` streams a scan's batches (an iterator of
Tables, ``io.scan_parquet_dist``) against a resident build side shuffled
once.

With ``CYLON_TPU_TORCH_CKPT_DIR`` set, the range loop is a durable
checkpoint stage (exec/checkpoint.py): each completed piece — a sinkless
piece output, or a ``GroupBySink``'s partial at its adoption — is saved
and committed, a resume (``CYLON_TPU_TORCH_RESUME=1``) starts the loop
past the committed prefix (or re-shards a whole stage committed at
another world or process layout), and with a preemption grace armed a
SIGTERM drains at the next piece boundary.

Each entry opens its plan node (obs/plan.py: ``pipelined_join`` with its
route, ranges and piece caps, ``pipelined_set_op``,
``pipelined_scan_join``); with the flight recorder armed each piece adds
a dispatch span and each sink chunk an in-flight pair.

Each piece boundary of the range loop, each chunk of the set op and each
batch of the scan join is an interleave point of the serving tier
(:func:`_interleave`, exec/scheduler.py): there a scheduled session hands
the card to the next tenant while its queued work keeps running.  A
chunk's and a batch's copies are admitted through the scheduler's
facade (``scheduler.admit_allocation``).
"""

from __future__ import annotations

import time
from collections.abc import Sequence

import numpy as np
import torch

from .. import config
from ..core.column import Column
from ..core.dtypes import LogicalType, np_dtype_of
from ..core.table import Table
from ..obs import plan as _plan
from ..obs import trace as _trace
from ..ops import pack
from ..ops import splitter_probe
from ..parallel.shards import map_shards, shard
from ..relational.common import (PAD_L, check_same_env, col_arrays,
                                 live_mask, narrow32_flags, promote_key_pair)
from ..relational.join import join_tables
from ..relational.piece import PieceSource
from ..relational.repart import concat_tables, shuffle_table
from ..relational.sort import local_sort_table
from ..status import (CheckpointCorruptError, CylonError, CylonIOError,
                      InvalidError)
from ..utils import timing
from ..utils.host import host_arrays
from . import checkpoint, memory, scheduler


def _interleave() -> None:
    """The serving tier's interleave point: a session scheduled by
    exec/scheduler.py hands the baton to the next tenant here, its queued
    device work still running.  It is also the periodic metrics-snapshot
    poll of entries that run no scheduler (one list load when unarmed).
    Outside a scheduler, one module-global load."""
    from ..obs import metrics
    metrics.maybe_write_snapshot()
    scheduler.maybe_yield()


class _LazyChunks(Sequence):
    """Chunk views of one table made on access: ``chunks[i]`` slices chunk
    i when it is read, so a streaming consumer holds one chunk's copies
    at a time.  Reading a chunk again slices it again."""

    def __init__(self, table: Table, n_chunks: int, step: int):
        self._table = table
        self._n = int(n_chunks)
        self._step = int(step)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> Table:
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        from ..parallel.shards import local_world
        t = self._table
        cap, step = t.capacity, self._step
        v = local_world(t.env.world_size)     # this process's row blocks
        start = i * step

        def window(x):
            if x is None:
                return None
            rest = tuple(x.shape[1:])
            return x.view((v, cap) + rest)[:, start:start + step] \
                .reshape((v * step,) + rest)

        # each shard keeps the part of its live prefix inside the window
        vc = np.clip(t.valid_counts - start, 0, step).astype(np.int64)
        cols = {n: Column(window(c.data), c.type, window(c.validity),
                          c.dictionary, bounds=c.bounds)
                for n, c in t.columns.items()}
        return Table(cols, t.env, vc)


def chunk_table(table: Table, n_chunks: int) -> Sequence:
    """Split each shard's rows into ``n_chunks`` contiguous windows of
    ``ceil(cap / n_chunks)`` rows (the table is repadded first when they
    do not tile its capacity); chunk i is a Table of every shard's i-th
    window, so the chunks in order cover the table shard by shard.  A
    lazy sequence: a chunk's copy is made when it is read."""
    if n_chunks <= 1:
        return [table]
    from ..relational.repart import repad_table
    cap = max(table.capacity, 1)
    step = -(-cap // n_chunks)
    if step * n_chunks != table.capacity:
        table = repad_table(table, step * n_chunks)
    return _LazyChunks(table, n_chunks, step)


def pipelined_set_op(a: Table, b: Table, op: str, n_chunks: int = 4):
    """A set operation with ``a`` streamed in row chunks: the resident side
    ``b`` shuffles once, each chunk of ``a`` shuffles inside the loop (so
    ``a`` is never held shuffled in full), and one distinct pass combines
    the per-chunk partials:

    * union: ``unique(concat(unique(chunk_i)..., unique(b)))``;
    * subtract: each chunk minus the resident ``b``, then distinct over
      the chunks (a row may recur in several chunks);
    * intersect: as subtract, keeping the rows ``b`` holds.

    Extra memory at the peak is the partials (each at most one chunk)
    plus the final pass's input."""
    from ..relational.setops import (_align_schemas, _set_operation_impl,
                                     unique_table)
    if op not in ("union", "intersect", "subtract"):
        raise InvalidError(f"unknown set op {op!r}")
    env = check_same_env(a, b)
    with _plan.node("pipelined_set_op", kind=op,
                    n_chunks=int(n_chunks)) as pn:
        if pn:
            pn.set(rows_in=a.row_count + b.row_count)
        a, b = _align_schemas(a, b)
        names = a.column_names
        if env.world_size > 1 and op != "union":
            b = shuffle_table(b, names)     # the resident side, once
        parts = []
        for chunk in chunk_table(a, n_chunks):
            _interleave()   # a chunk boundary: the serving interleave point
            # each chunk's copy is admitted on the ledger: under pressure
            # the cold spillable owners evict to host memory
            scheduler.admit_allocation(env, memory.table_nbytes(chunk))
            if op == "union":
                # unique_table shuffles the chunk itself
                parts.append(unique_table(chunk))
            else:
                if env.world_size > 1:
                    chunk = shuffle_table(chunk, names)
                parts.append(_set_operation_impl(chunk, b, op,
                                                 assume_colocated=True))
            del chunk
        if op == "union":
            parts.append(unique_table(b))
        combined = concat_tables(parts) if len(parts) > 1 else parts[0]
        del parts
        res = unique_table(combined)
        if pn:
            pn.set(rows_out=res.row_count)
        return res


class GroupBySink:
    """Streaming groupby consumer for :func:`pipelined_join`.

    Each joined piece is partially aggregated and released; ``finalize``
    combines the partials.  Ops decompose through public aggregations of
    their partials: sum/count/min/max/mean/var/std (mean = sum & count;
    var/std = sum & count & sumsq).

    Usage::

        sink = GroupBySink("k", [("a", "sum"), ("b", "mean")])
        pipelined_join(lt, rt, "k", "k", n_chunks=6, sink=sink)
        out = sink.finalize()
    """

    _DECOMP = {"sum": ("sum",), "count": ("count",), "min": ("min",),
               "max": ("max",), "mean": ("sum", "count"),
               "var": ("sum", "count", "sumsq"),
               "std": ("sum", "count", "sumsq")}
    _COMBINE = {"sum": "sum", "count": "sum", "min": "min", "max": "max",
                "sumsq": "sum"}

    def __init__(self, by, aggs, ddof: int = 1):
        self.by = [by] if isinstance(by, str) else list(by)
        self.aggs = list(aggs)
        self.ddof = int(ddof)
        for col, op, *_ in self.aggs:
            if op not in self._DECOMP:
                raise InvalidError(
                    f"GroupBySink does not support {op!r}; supported: "
                    f"{sorted(self._DECOMP)}")
        # one partial aggregation per distinct (col, intermediate op)
        self._chunk_aggs = sorted({(c, i) for c, op, *_ in self.aggs
                                   for i in self._DECOMP[op]})
        self._parts: list[Table] = []
        self._regs: list = []      # ledger registrations of the partials
        self._pending = []         # dispatched fused pieces, meta unread
        self._disjoint = False
        self._ckpt = None          # durable checkpoint Stage
        self._adopted = 0          # partials adopted = checkpoint index

    def mark_key_disjoint(self) -> None:
        """Caller guarantee: no group key occurs in more than one piece
        (a range-partitioned pipeline keyed on the join keys), so the
        partials are the final groups and only concatenate."""
        self._disjoint = True

    def __call__(self, chunk: Table) -> None:
        """Consume one piece.  A deferred inner-join piece takes the fused
        pushdown through begin/resolve: the NEXT piece's work is queued
        before the previous piece's meta is read (one deep)."""
        from ..relational.fused import try_begin_join_groupby
        from ..relational.groupby import _normalize_aggs, groupby_aggregate
        # a trace span per piece from its arrival to its partial's
        # adoption (one piece later for a deferred piece): the overlap of
        # dispatch and consume on the timeline
        _trace.async_begin("sink.chunk_inflight",
                           self._adopted + len(self._pending))
        specs = _normalize_aggs(list(self._chunk_aggs))
        h = try_begin_join_groupby(chunk, self.by, specs, 1)
        if h is not None:
            self._pending.append(h)
            while len(self._pending) > 1:
                self._adopt(self._pending.pop(0).resolve())
            return None
        self.flush_pending()
        self._adopt(groupby_aggregate(chunk, self.by, list(self._chunk_aggs)))
        return None

    def attach_checkpoint(self, stage) -> None:
        """Arm durable checkpoints (exec/checkpoint.py): each adopted
        partial is saved and committed.  Partials are adopted in
        consumption order (the pending queue is FIFO), so the adoption
        counter is the piece index."""
        self._ckpt = stage

    def restore_partial(self, part: Table) -> None:
        """Adopt a partial restored from a checkpoint without saving it
        again: bit-identical to the partial the interrupted process
        computed, so ``finalize`` equals an uninterrupted run's."""
        self._parts.append(part)
        self._regs.append(memory.register_table("sink_part", part))
        self._adopted += 1

    def _adopt(self, part: Table) -> None:
        """Keep one piece's partial, accounted in the ledger until
        ``finalize`` releases it, and checkpoint it when armed."""
        self._parts.append(part)
        self._regs.append(memory.register_table("sink_part", part))
        if self._ckpt is not None:
            self._ckpt.save_piece(self._adopted, part)
        _trace.async_end("sink.chunk_inflight", self._adopted)
        self._adopted += 1

    def absorb(self, chunk: Table) -> None:
        """The consume path under the streaming view's name: one
        micro-batch per call (``stream/view.py``)."""
        self(chunk)

    def flush_pending(self) -> None:
        """Resolve every dispatched piece now."""
        while self._pending:
            self._adopt(self._pending.pop(0).resolve())

    def compact(self) -> None:
        """Fold the adopted partials into one, for unbounded streams: the
        combine groupby's intermediates, renamed back to the partial
        schema, are a partial themselves (re-summing summed
        intermediates is the same fold), so with exact partial sums a
        compacted sink's snapshot is bit-equal to the uncompacted one.
        A no-op for 0 or 1 partials and for key-disjoint sinks, whose
        partials are already the final groups.  The folded partial's
        ledger registration replaces the partials'."""
        from ..relational.groupby import groupby_aggregate
        self.flush_pending()
        if len(self._parts) <= 1 or self._disjoint:
            return
        names = [f"{c}_{i}" for c, i in self._chunk_aggs]
        comb = groupby_aggregate(
            concat_tables(self._parts), self.by,
            [(n, self._COMBINE[i]) for n, (_, i) in zip(names,
                                                         self._chunk_aggs)])
        folded = comb.rename({f"{n}_{self._COMBINE[i]}": n for n, (_, i)
                              in zip(names, self._chunk_aggs)}).project(
            self.by + names)
        for reg in self._regs:
            memory.release(reg)
        self._parts = [folded]
        self._regs = [memory.register_table("sink_part", folded)]

    def snapshot(self) -> Table:
        """The finalized aggregate over every piece consumed so far,
        leaving the partials adopted."""
        return self._combine(drain=False)

    def finalize(self) -> Table:
        return self._combine(drain=True)

    def _combine(self, drain: bool) -> Table:
        from ..relational.groupby import combine_sink_partials
        self.flush_pending()
        if not self._parts:
            raise InvalidError("GroupBySink saw no chunks")
        partial = concat_tables(self._parts)
        if drain:
            self._parts = []
            for reg in self._regs:
                memory.release(reg)
            self._regs = []
        return combine_sink_partials(partial, self.by, self.aggs,
                                     self._chunk_aggs, self._COMBINE,
                                     ddof=self.ddof,
                                     disjoint=self._disjoint)


# ---------------------------------------------------------------------------
# range-partitioned pipelined join
# ---------------------------------------------------------------------------

def _range_bounds(n: int, by_datas, by_valids, n_ranges: int,
                  narrow: tuple, need_nf: tuple):
    """One shard's range boundaries over its SORTED build side (``n``
    live rows):
    candidate positions r*n/R snapped forward to the next key-group start,
    so a key's whole run stays in one range, capped at n; plus the
    splitter key operands at those positions.  A boundary at n must read
    as "+infinity" so probe rows never route into the empty trailing
    ranges: each operand reads one explicit sentinel slot past the end
    (liveness = the pad key), since at exact capacity (n == cap) there is
    no padding row to serve.

    The reference takes the next group start with a reverse ``cummin``;
    torch's CUDA ``cummin`` is a slow scan-with-indices kernel, and a
    ``nonzero`` of the group starts would wait on the host.  Instead: the
    prefix count of group starts, ``csum``, is non-decreasing, so the next
    start at or after c is the first position where ``csum`` reaches
    (starts strictly before c) + 1 — one sorted search, no host wait."""
    cap = by_datas[0].shape[0]
    dev = by_datas[0].device
    mask = live_mask([n], cap, dev)
    ko = pack.key_operands(list(by_datas), list(by_valids), row_mask=mask,
                           pad_key=PAD_L, need_null_flags=need_nf,
                           narrow32=narrow)
    del mask
    first = pack.neighbor_flags(ko.ops, ko.kinds) != 0
    first[:1] = True
    csum = torch.cumsum(first, 0, dtype=torch.int32)
    cand = (torch.arange(1, n_ranges, dtype=torch.int64, device=dev)
            * n) // n_ranges
    cand = cand.clamp(0, cap - 1)
    before = csum[cand] - first[cand].to(torch.int32)
    del first
    nxt = torch.searchsorted(csum, before + 1)   # == cap: no start left
    del csum
    b = nxt.clamp_max(n)
    sel = b.clamp_max(cap - 1)
    sops = []
    for j, op in enumerate(ko.ops):
        sent = torch.full((), PAD_L if j == 0 else 0, dtype=op.dtype,
                          device=dev)
        sops.append(torch.where(b < cap, op[sel], sent))
    return b.to(torch.int32), tuple(sops)


def _probe_targets(n: int, by_datas, by_valids, sops: tuple, n_ranges: int,
                   narrow: tuple, need_nf: tuple) -> torch.Tensor:
    """Per-row range id of one shard's probe side: the count of that
    shard's splitters <= the row's key (>= because splitters are group STARTS of the sorted build),
    by the splitter probe (K2, :mod:`..ops.splitter_probe`).  Dead rows
    get id R, so a stable sort by id puts them last."""
    cap = by_datas[0].shape[0]
    mask = live_mask([n], cap, by_datas[0].device)
    ko = pack.key_operands(list(by_datas), list(by_valids), row_mask=mask,
                           pad_key=PAD_L, need_null_flags=need_nf,
                           narrow32=narrow)
    tgt = splitter_probe.count_ge_splitters(ko.ops, sops)
    del ko
    return torch.where(mask, tgt, n_ranges).to(torch.int32)


def _range_counts(sorted_ids: torch.Tensor, n_ranges: int) -> torch.Tensor:
    """One shard's per-range live probe counts from its range-id column
    AFTER its sort: live rows hold ids in [0, R) ascending and dead rows
    id R after them, so the column is non-decreasing and R+1 sorted
    searches bound every range.  (The reference scatter-adds the ids
    before the sort; ``torch.bincount`` would wait on the host to size its
    output, and an atomic scatter-add sends every row to one of R+1
    addresses.)"""
    edges = torch.arange(n_ranges + 1, dtype=sorted_ids.dtype,
                         device=sorted_ids.device)
    return torch.diff(torch.searchsorted(sorted_ids, edges))


def _pull_phase_outputs(devs: list, world: int):
    """THE pre-loop host wait: one batched pull of the queued setup
    phases' outputs (range boundaries, per-range probe counts).  A fault
    raised by any of those phases surfaces here, classified onto the
    fault taxonomy; ``pipe.phase_sync`` is its injector site."""
    from .recovery import classify, maybe_inject
    maybe_inject("pipe.phase_sync")
    try:
        return host_arrays(devs, world=world)
    except Exception as e:  # noqa: BLE001 — re-raised typed when a fault
        fault = classify(e)
        if fault is None:
            raise
        raise fault from e


class _PieceFuture:
    """One range piece's windows, prepared ahead of their consumption (for
    a host-resident source, the window uploads).  A typed fault raised
    while preparing (a piece-cap overflow, an injected spill fault) is
    held and raised when the piece is consumed — where the schedule
    without prefetch raises it; a foreign exception raises at once."""

    __slots__ = ("_pieces", "_fault")

    def __init__(self, thunk):
        self._pieces = self._fault = None
        try:
            self._pieces = thunk()
        except CylonError as e:
            self._fault = e

    def get(self):
        if self._fault is not None:
            raise self._fault
        return self._pieces


def pipelined_join(left: Table, right: Table, left_on, right_on,
                   how: str = "inner", n_chunks: int = 4,
                   suffixes=("_x", "_y"), sink=None):
    """Range-partitioned streaming join (module docstring): ``right`` is
    the build side, sorted once; ``left`` streams through ``n_chunks``
    key ranges.  ``how``: inner, left, right or outer.  At world size
    W > 1 both sides hash-shuffle once first.

    ``sink``: the downstream operator.  When given, each piece's join
    (deferred when inner) is passed to ``sink(piece)`` and released, and
    the list of sink results is returned; peak memory is one piece's
    state.  Without a sink the pieces are concatenated into one Table,
    key-grouped."""
    if how not in ("inner", "left", "right", "outer"):
        raise InvalidError(
            "pipelined_join supports how in ('inner','left','right','outer')")
    with _plan.node("pipelined_join", how=how, n_chunks=int(n_chunks),
                    sink=(type(sink).__name__ if sink is not None
                          else None)) as pn:
        if pn:
            pn.set(rows_in=left.row_count + right.row_count)
            # the probe side's heavy hitters (analyze runs): the right
            # table of a right join, as on the skew route
            probe, probe_on = ((right, right_on) if how == "right"
                               else (left, left_on))
            po = [probe_on] if isinstance(probe_on, str) else list(probe_on)
            _plan.profile_keys(pn, probe, po)
        res = _pipelined_join_impl(left, right, left_on, right_on, how,
                                   n_chunks, suffixes, sink, pn)
        if pn and type(res) is Table:
            pn.set(rows_out=res.row_count)
        return res


def _pipelined_join_impl(left: Table, right: Table, left_on, right_on,
                         how: str, n_chunks: int, suffixes, sink, pn):
    env = check_same_env(left, right)
    left_on = [left_on] if isinstance(left_on, str) else list(left_on)
    right_on = [right_on] if isinstance(right_on, str) else list(right_on)

    # promote once so every piece shares dictionaries/dtypes with the build
    lkey, rkey = [], []
    for ln, rn in zip(left_on, right_on):
        a, b = promote_key_pair(left.column(ln), right.column(rn))
        lkey.append(a)
        rkey.append(b)
    lwork = left.with_columns(dict(zip(left_on, lkey)))
    rwork = right.with_columns(dict(zip(right_on, rkey)))

    if (isinstance(sink, GroupBySink) and left_on == right_on
            and list(sink.by) == list(left_on)):
        # ranges partition the join-key space: a groupby sink keyed on the
        # join keys sees each group in exactly one piece
        sink.mark_key_disjoint()

    w = env.world_size
    if w > 1:
        with timing.region("join.shuffle"):
            rwork = shuffle_table(rwork, right_on)   # build side: ONCE
            lwork = shuffle_table(lwork, left_on)    # probe side: ONCE

    n_ranges = max(int(n_chunks), 1)
    if n_ranges == 1 or rwork.row_count == 0 or lwork.row_count == 0:
        # The reference materializes here and its sink runs the sort-based
        # groupby.  With a sink the port's inner join defers instead, so a
        # sink keyed on the join keys takes the fused pushdown and never
        # materializes the join: same groups, same order, integer sums
        # bit-equal (float sums may differ in association order).  Other
        # join types materialize, as in the reference.
        if pn:
            pn.annotate(route="monolithic")
        res = join_tables(lwork, rwork, left_on, right_on, how=how,
                          suffixes=suffixes, assume_colocated=True,
                          allow_defer=sink is not None)
        return [sink(res)] if sink is not None else res

    with timing.region("pipe.build_sort"):
        rsorted = local_sort_table(rwork, right_on)
        # the hash shuffle co-located equal keys and the per-shard sort
        # makes them contiguous: together that is grouped_by's contract
        rsorted.grouped_by = tuple(right_on)
    del rwork

    l_keys = [lwork.column(n) for n in left_on]
    r_keys = [rsorted.column(n) for n in right_on]
    need_nf = tuple((a.validity is not None) or (b.validity is not None)
                    for a, b in zip(l_keys, r_keys))
    narrow = narrow32_flags(l_keys, r_keys)
    key_dtypes = tuple(np_dtype_of(c.data).name for c in r_keys)

    n_r = np.asarray(rsorted.valid_counts, np.int64)
    r_datas, r_valids = col_arrays(r_keys)
    with timing.region("pipe.bounds"):
        # (W·(R-1),) boundaries and splitter operands, shard-major
        res = map_shards(lambda r: _range_bounds(
            int(n_r[r]), [shard(d, w, r) for d in r_datas],
            [shard(v, w, r) for v in r_valids], n_ranges, narrow, need_nf),
            w)
        b_dev, sops = res
    del r_datas, r_valids, r_keys, res

    n_l = np.asarray(lwork.valid_counts, np.int64)
    l_datas, l_valids = col_arrays(l_keys)
    with timing.region("pipe.targets"):
        # K2 once per shard, each against its own shard's splitters
        tgt = map_shards(lambda r: _probe_targets(
            int(n_l[r]), [shard(d, w, r) for d in l_datas],
            [shard(v, w, r) for v in l_valids],
            tuple(shard(o, w, r) for o in sops), n_ranges, narrow, need_nf),
            w)
    del sops, l_datas, l_valids, l_keys

    tmp = "__range__"
    while tmp in lwork.column_names:
        tmp += "_"
    ltab = lwork.with_columns(
        {tmp: Column(tgt, LogicalType.INT32, None, bounds=(0, n_ranges))})
    del lwork, tgt
    with timing.region("pipe.probe_sort"):
        lsorted = local_sort_table(ltab, [tmp])
        ids = lsorted.column(tmp).data
        pc_dev = map_shards(lambda r: _range_counts(shard(ids, w, r),
                                                    n_ranges), w)
        del ids
    del ltab

    with timing.region("pipe.phase_sync"):
        # THE pre-loop host wait: every setup phase above was queued with
        # no pull in between; one batched pull brings both back
        b_host, pc_host = _pull_phase_outputs([b_dev, pc_dev], w)
    b = np.asarray(b_host, np.int64).reshape(w, n_ranges - 1)
    pcounts = np.asarray(pc_host, np.int64).reshape(w, n_ranges)
    bb = np.concatenate([np.zeros((w, 1), np.int64), b, n_r[:, None]],
                        axis=1)
    r_starts = bb[:, :-1]
    r_lens = np.diff(bb, axis=1)
    l_starts = np.concatenate([np.zeros((w, 1), np.int64),
                               np.cumsum(pcounts, axis=1)], axis=1)[:, :-1]

    # every per-range pow2 piece capacity is known up front: one over the
    # shards per range
    caps_l = [config.pow2ceil(max(int(pcounts[:, r].max()), 1))
              for r in range(n_ranges)]
    caps_r = [config.pow2ceil(max(int(r_lens[:, r].max()), 1))
              for r in range(n_ranges)]
    if pn:
        # the piece geometry EXPLAIN prints: every piece is a packed
        # window and the setup phases queue with no host wait between
        # them; the port donates no buffer
        pn.annotate(route="range_pipeline", n_ranges=n_ranges,
                    max_cap_l=max(caps_l), max_cap_r=max(caps_r),
                    packed=True, overlap=True, donate=False)

    # piece-cap sizing consults the ledger: admission of the packed
    # sources folds in the sort operands of the largest piece pair, on
    # every shard
    scratch = pack.sort_operand_nbytes(key_dtypes, need_nf, narrow,
                                       (max(caps_l) + max(caps_r)) * w)
    with timing.region("pipe.pack"):
        src_l = PieceSource(lsorted, max(caps_l), drop=(tmp,),
                            scratch_bytes=scratch)
        src_r = PieceSource(rsorted, max(caps_r), scratch_bytes=scratch)
    del lsorted, rsorted
    if pn:
        pn.annotate(spilled=bool(src_l.spilled or src_r.spilled))

    def qualifies(r) -> bool:
        # a range runs when the join can emit rows there
        any_l = pcounts[:, r].sum() > 0
        any_r = r_lens[:, r].sum() > 0
        return {"inner": any_l and any_r, "left": any_l, "right": any_r,
                "outer": any_l or any_r}[how]

    live_ranges = [r for r in range(n_ranges) if qualifies(r)]

    # the durable checkpoint stage (exec/checkpoint.py): armed only when
    # CYLON_TPU_TORCH_CKPT_DIR is set; otherwise no file, region or vote
    stage = None
    if (checkpoint.enabled() and live_ranges
            and (sink is None or isinstance(sink, GroupBySink))):
        # the consumption mode is part of the plan: a sink stage keeps
        # partial aggregates, a sinkless one piece outputs.  The base
        # token names the workload and holds nothing of the layout (the
        # global row totals guard against changed inputs); the full token
        # folds in the world, the piece capacities and the range counts
        mode = (("nosink", tuple(suffixes)) if sink is None else
                ("sink", tuple(sink.by), tuple(sink._chunk_aggs),
                 sink.ddof))
        base = checkpoint.plan_token(
            "pipelined_join", how, tuple(left_on), tuple(right_on),
            n_ranges, mode, int(pcounts.sum()), int(r_lens.sum()))
        token = checkpoint.plan_token(
            base, w, tuple(caps_l), tuple(caps_r),
            tuple(int(x) for x in pcounts.sum(axis=0)),
            tuple(int(x) for x in r_lens.sum(axis=0)))
        stage = checkpoint.open_stage(env, "pipelined_join", token,
                                      base_token=base)
        if pn:
            pn.annotate(ckpt=True)
        if sink is not None:
            sink.attach_checkpoint(stage)
    start, outs, adopted_whole = 0, [], False
    if stage is not None and checkpoint.resume_requested():
        start, outs, adopted_whole = _resume_stage(stage, env, sink,
                                                   len(live_ranges))

    def make_pieces(r):
        # window descriptors: the slice and unpack run inside the join (a
        # host-resident source uploads its window here)
        return (src_l.packed(l_starts[:, r], pcounts[:, r], caps_l[r]),
                src_r.packed(r_starts[:, r], r_lens[:, r], caps_r[r]))

    def prefetch_ok(r) -> bool:
        # upload piece r's windows while the piece before it computes,
        # when a source is host-resident and the budget holds two window
        # pairs; resident sources make free descriptors, so none is made
        # early
        if not (src_l.spilled or src_r.spilled):
            return False
        pair = w * (caps_l[r] * memory.spec_row_bytes(src_l.spec)
                    + caps_r[r] * memory.spec_row_bytes(src_r.spec))
        return memory.prefetch_depth(env, pair) > 1

    def piece_future(r):
        return _PieceFuture(lambda: make_pieces(r))

    with timing.region("pipe.piece_loop"):
        # a fast-forwarded piece gets no future: nothing of it uploads
        nxt = (piece_future(live_ranges[start])
               if start < len(live_ranges) else None)
        for i in range(start, len(live_ranges)):
            # a dispatch span per piece on the trace timeline (armed
            # runs), beside the sink's in-flight span
            trace_armed = _trace.armed()
            t_disp = time.perf_counter() if trace_armed else 0.0
            piece_l, piece_r = nxt.get()
            nxt = None
            if i + 1 < len(live_ranges) and prefetch_ok(live_ranges[i + 1]):
                nxt = piece_future(live_ranges[i + 1])
            with timing.region("pipe.piece_join"):
                res_r = join_tables(piece_l, piece_r, left_on, right_on,
                                    how=how, suffixes=suffixes,
                                    assume_colocated=True,
                                    allow_defer=sink is not None)
            if trace_armed:
                _trace.complete("pipe.piece_dispatch", t_disp,
                                piece=int(live_ranges[i]))
            del piece_l, piece_r
            with timing.region("pipe.consume"):
                outs.append(sink(res_r) if sink is not None else res_r)
            if stage is not None and sink is None:
                # a sinkless piece boundary: the piece output is the
                # completed-piece state (a GroupBySink saves its partials
                # as it adopts them)
                stage.save_piece(i, res_r)
            del res_r
            if stage is not None and checkpoint.drain_requested(env):
                # a preemption notice, agreed: settle the sink's pending
                # piece (its partial commits), drop a piece prepared
                # ahead, and leave through the typed drain
                if sink is not None:
                    sink.flush_pending()
                nxt = None
                checkpoint.drain_abort("pipelined_join")
            if nxt is None and i + 1 < len(live_ranges):
                nxt = piece_future(live_ranges[i + 1])
            # a piece boundary: the serving tier's interleave point, with
            # piece r's consume (and r+1's windows) in flight on the card
            # while another tenant enqueues its own piece
            _interleave()
        if not outs:
            # no range qualified (an inner join with no overlapping
            # keys): one empty piece pair keeps the output schema path
            # uniform (deferred under a sink, as on the n_chunks == 1
            # route above)
            zeros = [0] * w
            piece_l = src_l.packed(zeros, zeros, 1)
            piece_r = src_r.packed(zeros, zeros, 1)
            res_r = join_tables(piece_l, piece_r, left_on, right_on,
                                how=how, suffixes=suffixes,
                                assume_colocated=True,
                                allow_defer=sink is not None)
            outs.append(sink(res_r) if sink is not None else res_r)
    if stage is not None:
        # mark the stage complete (one more commit) once every consumed
        # piece is durable: a resume at another world adopts only whole
        # stages
        if sink is not None:
            sink.flush_pending()
        stage.mark_complete()
    if sink is not None:
        return outs
    out = concat_tables(outs)
    from . import integrity
    if integrity.armed():
        # the armed audit: the assembled output's fingerprint, voted at
        # the stage boundary
        integrity.audit_table(out, site="pipe.stitch",
                              phase="post_pipeline")
    if left_on == right_on and not adopted_whole:
        # pieces are key-grouped, in key-range order, and keys co-located:
        # the per-shard concatenation keeps the grouped contract.  Pieces
        # adopted across a world change were re-blocked in global order
        # and keep neither
        out.grouped_by = tuple(left_on)
    return out


def _resume_stage(stage, env, sink, n_live: int):
    """The resume of a checkpointed stage: restore the committed prefix
    (a plain fast-forward) or re-shard a whole stage committed at another
    world, vote the prefix every rank adopts, and hand the restored pieces
    to the sink (or keep them as piece outputs).  Returns ``(start, outs,
    adopted_whole)``: the first piece to compute, the outputs so far and
    whether a re-sharded stage was adopted whole (then it is re-committed
    in this world's layout and nothing is left to compute)."""
    from .recovery import ckpt_resume_consensus
    restored: list = []
    foreign = stage.foreign is not None
    if stage.resuming:
        while len(restored) < n_live and stage.has_piece(len(restored)):
            try:
                restored.append(stage.load_piece(len(restored)))
            except CheckpointCorruptError as e:
                checkpoint.corrupt_fallback(stage, len(restored), e)
                break
    elif foreign and stage.foreign_complete:
        try:
            restored = stage.load_foreign_pieces()
        except CheckpointCorruptError as e:
            checkpoint.corrupt_fallback(stage, 0, e)
            restored = []
    start = ckpt_resume_consensus(env, len(restored))
    # armed: the voted prefix's fingerprints against the manifests', then
    # the pieces before the first miss voted again
    start = checkpoint.audit_restored(stage, restored, start)
    adopted_whole = False
    if foreign:
        # all or nothing: old-layout pieces cannot splice into a
        # new-layout loop (foreign restores are not counted yet)
        if start != len(restored) or not restored:
            start, restored = 0, []
        else:
            checkpoint.note_reshard(start)
            adopted_whole = True
            # the first commit after a re-shard rewrites the adopted state
            # in this world's layout, so a second resume here is a plain
            # fast-forward and the old world's dirs read as stale
            stage.begin_rewrite()
            for i, tbl in enumerate(restored):
                stage.save_piece(i, tbl)
            stage.mark_complete()
            start = n_live
    elif len(restored) > start:
        checkpoint.unrestore(len(restored) - start)
    outs: list = []
    for tbl in restored[:(len(restored) if adopted_whole else start)]:
        if sink is not None:
            sink.restore_partial(tbl)
            outs.append(None)       # a GroupBySink call returns None too
        else:
            outs.append(tbl)
    return start, outs, adopted_whole


# ---------------------------------------------------------------------------
# streamed scan join
# ---------------------------------------------------------------------------

def pipelined_scan_join(scan, build: Table, scan_on, build_on,
                        how: str = "inner", suffixes=("_x", "_y"),
                        sink=None):
    """Join a stream of scan batches (any iterable of Tables on the build
    side's world, such as ``io.scan_parquet_dist``) against a resident
    ``build`` table.  The build side is promoted and (at W > 1) shuffled
    once; each batch is admitted on the ledger, registered, shuffled,
    joined with the resident build and consumed — ``sink(result)`` when a
    sink is given (the join defers, so a ``GroupBySink`` takes the fused
    pushdown), then released.  The scan side never sits in memory whole.

    Batches partition the scan's rows and every scan row's matches lie in
    the resident build, so ``inner`` and ``left`` (left = the scan side)
    are complete per batch; ``right`` and ``outer`` would need unmatched
    build rows tracked across batches and raise ``InvalidError``, as do
    dictionary-coded keys (strings, decimals: their codes are per batch
    and cannot hash-colocate with the once-shuffled build).  Returns the
    list of sink results, or the batches' joins concatenated."""
    if how not in ("inner", "left"):
        raise InvalidError(
            "pipelined_scan_join supports how in ('inner','left'): "
            "right/outer need cross-batch unmatched-build bookkeeping — "
            "materialize the read and use pipelined_join instead")
    scan_on = [scan_on] if isinstance(scan_on, str) else list(scan_on)
    build_on = [build_on] if isinstance(build_on, str) else list(build_on)
    with _plan.node("pipelined_scan_join", how=how,
                    sink=(type(sink).__name__ if sink is not None
                          else None)) as pn:
        env = build.env
        w = env.world_size
        bwork = None
        outs: list = []
        rows_in = 0
        n_batches = 0
        for batch in scan:
            _interleave()   # a batch boundary: the serving interleave point
            n_batches += 1
            rows_in += batch.row_count
            check_same_env(batch, build)
            # promotion against the already promoted build columns is
            # batch-independent for numeric keys: the build promotes once
            bk = [batch.column(n) for n in scan_on]
            rk = [(build if bwork is None else bwork).column(n)
                  for n in build_on]
            pairs = [promote_key_pair(a, b) for a, b in zip(bk, rk)]
            if any(p.dictionary is not None for pair in pairs for p in pair):
                raise InvalidError(
                    "pipelined_scan_join: dictionary-encoded join keys "
                    "are per-batch-coded and cannot hash-colocate "
                    "against a once-shuffled build — materialize the "
                    "read and use pipelined_join")
            batch = batch.with_columns(
                {n: p for n, (p, _) in zip(scan_on, pairs)})
            if bwork is None:
                bwork = build.with_columns(
                    {n: p for n, (_, p) in zip(build_on, pairs)})
                if w > 1:
                    with timing.region("join.shuffle"):
                        bwork = shuffle_table(bwork, build_on)   # ONCE
                memory.register_table("scan_build", bwork)
            scheduler.admit_allocation(env, memory.table_nbytes(batch))
            reg = memory.register_table("scan_batch", batch)
            if w > 1:
                with timing.region("join.shuffle"):
                    batch = shuffle_table(batch, scan_on)
            with timing.region("pipe.scan_join"):
                res = join_tables(batch, bwork, scan_on, build_on, how=how,
                                  suffixes=suffixes, assume_colocated=True,
                                  allow_defer=sink is not None)
            del batch
            with timing.region("pipe.consume"):
                outs.append(sink(res) if sink is not None else res)
            del res
            memory.release(reg)
        if n_batches == 0:
            raise CylonIOError("pipelined_scan_join: the scan yielded "
                               "no batches")
        if pn:
            pn.set(rows_in=rows_in + build.row_count)
            pn.annotate(route="scan_pushdown", n_batches=n_batches)
        if sink is not None:
            return outs
        out = concat_tables(outs) if len(outs) > 1 else outs[0]
        if pn:
            pn.set(rows_out=out.row_count)
        return out
