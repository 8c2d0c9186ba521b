"""The adaptive skew-split join: plan, split exchange, stitch and the
heavy-partial combine (port of ``cylon_tpu/relational/skew.py``).

Under plain hash partitioning a heavy key lands whole on one rank, and
with W ranks on one card the largest shard sets every shard's padded
capacity.  The remedy is a deterministic plan:

1. **Detect**: :func:`~cylon_tpu_torch.relational.common.sample_key_rows`
   (evenly spaced per-shard positions, shard-weighted) feeds the weighted
   Misra-Gries sketch (obs/sketch.py); hash classes whose estimated share
   exceeds ``max(SKEW_GLOBAL_FACTOR / W, SKEW_SPLIT_SHARE)`` become heavy
   keys, each named by its FULL sampled key tuple (values and validity
   bits), so every later predicate runs in sort-operand space
   (``ops/pack.key_operands`` + ``rows_cmp_splitters``) and agrees bit for
   bit with the join sort's own order.
2. **Plan**: each heavy key gets a contiguous rank group anchored at its
   hash-home rank, fan-out ``ceil(share · W · SKEW_FANOUT_FACTOR)``
   clamped to [2, W] and to its exact row count.  Global row ``j`` of
   the key goes to member ``j mod fanout``: each member's rows are a
   fixed-stride subsequence of the key's rows in global (source rank,
   source position) order, so every row's position in the unsplit plan
   stays closed-form.
3. **Stitch**: after the local join, each output row's position in the
   UNSPLIT plan's global order comes from host-known plan scalars plus K
   operand comparisons per row, and ``repart.place_by_global_pos`` puts
   the rows on an even order-preserving layout: the output is bit- and
   order-equal to the unsplit hash plan on balanced shards.

A groupby never pays for the stitch: aggregation cannot observe row order
or placement, so it takes the pre-stitch table (:func:`consume_unstitched`);
the fused join→groupby pushdown combines the heavy keys' per-member
partial rows instead (:func:`combine_heavy_partials`).

Every predicate here runs over this process's ``(V·cap,)`` row blocks at
once: the comparisons are elementwise, and the per-shard quantities
(counts, running indices) are reductions over the ``(V, cap)`` view.

:func:`adopt` votes the plan hash (``exec/recovery.skew_plan_consensus``)
before the split exchange starts, across every process of a
multi-process world (one process driving every rank takes its own
plan), and counts the split in
``timing.counts()["join.skew_split"]`` and the registry's
``skew_split_joins``/``skew_split_keys``; the route's choices land on
the open plan node (obs/plan.py).  Armed (``CYLON_TPU_TORCH_AUDIT=1``),
the stitched output's fingerprint is voted (exec/integrity.audit_table,
site ``skew.stitch``).
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch

from .. import config
from ..core.column import Column
from ..core.table import Table
from ..ops import pack
from ..parallel.shards import local_world, span
from ..status import ExecutionError
from ..utils import timing
from ..utils.host import host_arrays
from .common import col_arrays, fits_int32, live_mask

__all__ = ["SkewPlan", "StitchState", "consume_unstitched", "detect",
           "heavy_counts", "heavy_flag", "finalize_or_none", "adopt",
           "split_exchange", "stitch_join_output", "last_plan",
           "record_plan", "combine_heavy_partials", "group_member_mask"]

#: thread-local record of the most recently adopted plan
_TLS = threading.local()


def record_plan(plan) -> None:
    _TLS.last = plan


def last_plan():
    """The most recently adopted :class:`SkewPlan` on this thread (None
    when the last eligible join ran unsplit)."""
    return getattr(_TLS, "last", None)


class StitchState:
    """The materialized skew join's deferred-merge handle
    (``DeferredTable.op_state``): the SPLIT-layout output plus what the
    stitch needs to rebuild the unsplit plan's global row order.  A
    groupby takes ``pre`` directly (:func:`consume_unstitched`); any
    other access materializes through the stitch."""

    __slots__ = ("pre", "plan", "how", "un_counts", "key_out_names")

    def __init__(self, pre: Table, plan, how: str, un_counts,
                 key_out_names):
        self.pre = pre
        self.plan = plan
        self.how = how
        self.un_counts = un_counts
        self.key_out_names = tuple(key_out_names)


def consume_unstitched(table, include_deferred: bool = False):
    """Hand an order-insensitive consumer (relational/groupby.py) the
    PRE-stitch table when ``table`` is a stitch-deferred skew join; an
    aggregation depends on the row multiset only.  ``include_deferred``
    (after the fused pushdown declined) also takes a still-deferred skew
    inner join through its ``pre_thunk``, the split-layout output without
    the stitch.  Any other table comes back unchanged."""
    st = getattr(table, "op_state", None)
    from ..obs import plan as _plan
    if isinstance(st, StitchState):
        _plan.annotate(skew_stitch_elided=True)
        timing.bump("skew.stitch_elided")
        return st.pre
    if include_deferred and not getattr(table, "materialized", True):
        pre_thunk = getattr(st, "pre_thunk", None)
        if getattr(st, "skew_plan", None) is not None \
                and pre_thunk is not None:
            _plan.annotate(skew_stitch_elided=True)
            timing.bump("skew.stitch_elided")
            return pre_thunk()
    return table


# ---------------------------------------------------------------------------
# the plan object
# ---------------------------------------------------------------------------

class SkewPlan:
    """The split decision for one join: K heavy key tuples with their
    contiguous rank groups and order-preserving chunk bounds.
    :func:`detect` fills the sampled estimate, :meth:`finalize` replaces
    it with exact counts and drops the keys the replication guard
    rejects."""

    __slots__ = ("world", "key_names", "values", "valids", "hashes",
                 "shares", "home", "start", "fanout", "n_probe", "n_build",
                 "chunk", "src_off", "lt", "_hash")

    def __init__(self, world: int, key_names: tuple, values: list,
                 valids: list, hashes: np.ndarray, shares: np.ndarray,
                 home: np.ndarray, fanout: np.ndarray):
        self.world = int(world)
        self.key_names = tuple(key_names)
        self.values = values          # per key column: (K,) value array
        self.valids = valids          # per key column: (K,) bool array
        self.hashes = hashes          # (K,) uint32 routing hashes
        self.shares = shares          # (K,) estimated probe share
        self.home = home              # (K,) int32 hash-home rank
        self.start = home.copy()      # contiguous group anchored at home
        self.fanout = fanout          # (K,) int32 (estimate until finalize)
        self.n_probe = None           # (K,) exact probe rows (finalize)
        self.n_build = None           # (K,) exact build rows (finalize)
        self.chunk = None             # (K, W) per-member chunk rows
        self.src_off = None           # (W, K) within-key source offsets
        self.lt = None                # (K, K) operand order: lt[i,j]=ti<tj
        self._hash = None

    def __len__(self) -> int:
        return len(self.hashes)

    def _take(self, keep: np.ndarray) -> None:
        self.values = [v[keep] for v in self.values]
        self.valids = [v[keep] for v in self.valids]
        for name in ("hashes", "shares", "home", "start", "fanout"):
            setattr(self, name, getattr(self, name)[keep])

    def finalize(self, probe_wk: np.ndarray, ltmat: np.ndarray,
                 build_wk: np.ndarray, build_total: int) -> bool:
        """Swap the sampled estimate for EXACT per-source counts, clamp the
        fan-outs, apply the per-key replication guard and derive the chunk
        bounds.  Returns False when nothing is left to split.  Host
        arithmetic only."""
        from .repart import even_partition_counts
        w = self.world
        n_probe = probe_wk.sum(axis=0).astype(np.int64)
        n_build = build_wk.sum(axis=0).astype(np.int64)
        # replication guard: replicating a key whose BUILD side is itself
        # huge recreates the blow-up the split avoids
        guard = (n_build > config.SKEW_GUARD_ROWS) \
            & (n_build * w > config.SKEW_GUARD_RATIO * max(build_total, 1))
        keep = (n_probe > 0) & ~guard
        if not keep.any():
            return False
        self._take(keep)
        probe_wk = probe_wk[:, keep]
        ltmat = ltmat[keep][:, keep]
        n_probe, n_build = n_probe[keep], n_build[keep]
        self.n_probe, self.n_build, self.lt = n_probe, n_build, ltmat
        self.fanout = np.minimum(
            np.minimum(self.fanout.astype(np.int64), n_probe),
            w).astype(np.int32)
        self.fanout = np.maximum(self.fanout, 1).astype(np.int32)
        k = len(self.hashes)
        self.chunk = np.zeros((k, w), np.int64)
        for i in range(k):
            f = int(self.fanout[i])
            self.chunk[i, :f] = even_partition_counts(int(n_probe[i]), f)
        self.src_off = np.concatenate(
            [np.zeros((1, k), np.int64),
             np.cumsum(probe_wk, axis=0)[:-1].astype(np.int64)])
        self._hash = None
        return True

    def plan_hash(self) -> int:
        """Canonical 64-bit plan identity: a sha256 over every field that
        shapes the split, byte for byte the reference's, so equal plans
        hash equal in both packages."""
        if self._hash is None:
            h = hashlib.sha256()
            h.update(repr((self.world, self.key_names,
                           tuple(str(v.dtype) for v in self.values))
                          ).encode())
            for v in self.values + self.valids:
                h.update(np.ascontiguousarray(v).tobytes())
            for a in (self.hashes, self.home, self.start, self.fanout,
                      self.n_probe, self.n_build, self.chunk):
                h.update(np.ascontiguousarray(a).tobytes())
            self._hash = int.from_bytes(h.digest()[:8], "big")
        return self._hash

    def summary(self) -> dict:
        """The JSON-friendly decision record."""
        return {
            "keys": int(len(self.hashes)),
            "fanout": [int(f) for f in self.fanout],
            "home": [int(d) for d in self.home],
            "share_est": [round(float(s), 4) for s in self.shares],
            "rows_probe": [int(n) for n in self.n_probe]
            if self.n_probe is not None else None,
            "rows_build": [int(n) for n in self.n_build]
            if self.n_build is not None else None,
            "plan_hash": format(self.plan_hash(), "016x"),
        }

    def operand_statics(self, cols) -> tuple:
        """(need_nf, narrow) per key column for operand comparisons between
        ``cols``' rows and this plan's tuples: null flags whenever either
        side can hold nulls; narrow lanes only when BOTH the column's
        bounds and the tuples' values fit int32 (the tuples come from the
        probe side, ``cols`` may be the build side or the join output — a
        narrowed wide tuple would alias an unrelated narrow key)."""
        need_nf = tuple((c.validity is not None) or bool((~tv).any())
                        for c, tv in zip(cols, self.valids))
        narrow = tuple(fits_int32(c) and _tuple_fits_i32(v, tv)
                       for c, v, tv in zip(cols, self.values, self.valids))
        return need_nf, narrow

    def tuple_ops(self, need_nf: tuple, narrow: tuple, device):
        """The K heavy tuples' key operands on ``device``."""
        tdatas = [torch.from_numpy(np.array(v)).to(device)
                  for v in self.values]
        tvalids = [torch.from_numpy(np.array(v, bool)).to(device)
                   for v in self.valids]
        return pack.key_operands(tdatas, tvalids, need_null_flags=need_nf,
                                 narrow32=narrow)


def _tuple_fits_i32(v: np.ndarray, tv: np.ndarray) -> bool:
    """Every VALID entry of this 64-bit integer tuple-value array fits
    int32 (null slots may hold anything)."""
    if v.dtype.itemsize != 8 or v.dtype.kind not in ("i", "u"):
        return False
    live = v[tv]
    if live.size == 0:
        return True
    return int(live.min()) >= -(1 << 31) \
        and int(live.max()) <= (1 << 31) - 1


def _compare(table: Table, key_names, plan: SkewPlan):
    """(gt, eq) ``(W·cap, K)`` bool: each row's key tuple against the K
    heavy tuples in operand space (gt: the tuple sorts before the row),
    with the row liveness."""
    cols = [table.column(n) for n in key_names]
    datas, valids = col_arrays(cols)
    need_nf, narrow = plan.operand_statics(cols)
    dev = datas[0].device
    ko_t = plan.tuple_ops(need_nf, narrow, dev)
    ko_r = pack.key_operands(list(datas), list(valids),
                             need_null_flags=need_nf, narrow32=narrow)
    gt, eq = pack.rows_cmp_splitters(ko_r, ko_t.ops)
    live = live_mask(table.valid_counts, table.capacity, dev)
    return gt, eq, live


# ---------------------------------------------------------------------------
# detection — MG sketch over the splitter sample
# ---------------------------------------------------------------------------

def detect(probe: Table, key_names, env) -> SkewPlan | None:
    """Heavy-hitter detection on the (promoted) probe side.  Returns an
    un-finalized :class:`SkewPlan` or None.  One sample gather and one
    host pull."""
    from ..obs.sketch import MisraGries
    from ..ops.hashing import partition_of
    from .common import sample_key_rows

    # every eligible join starts here: clear the record so last_plan()
    # never reports a previous join's plan when this one runs unsplit
    record_plan(None)
    w = env.world_size
    if not config.SKEW_SPLIT or w <= 1:
        return None
    total = int(probe.valid_counts.sum())
    if total < w * 64:   # too small to be worth a split
        return None
    sampled = sample_key_rows(probe, list(key_names))
    if sampled is None:
        return None
    values, valids, hashes, weights, _total = sampled
    mg = MisraGries(k=max(4 * config.SKEW_MAX_KEYS, 8))
    mg.update(hashes, weights)
    thresh = max(config.SKEW_GLOBAL_FACTOR / w, config.SKEW_SPLIT_SHARE)
    heavy = [(hv, sh) for hv, sh, _err in mg.shares() if sh > thresh]
    if not heavy:
        return None
    heavy = heavy[:config.SKEW_MAX_KEYS]
    idx, shares = [], []
    for hv, sh in heavy:
        pos = np.nonzero(hashes == hv)[0]
        if pos.size == 0:
            continue
        idx.append(int(pos[0]))
        shares.append(float(sh))
    if not idx:
        return None
    idx = np.asarray(idx, np.int64)
    shares = np.asarray(shares, np.float64)
    hv = hashes[idx].astype(np.uint32)
    home = np.asarray([partition_of(int(h), w) for h in hv], np.int32)
    fanout = np.clip(np.ceil(shares * w * config.SKEW_FANOUT_FACTOR), 2,
                     w).astype(np.int32)
    return SkewPlan(w, tuple(key_names),
                    [np.ascontiguousarray(v[idx]) for v in values],
                    [np.ascontiguousarray(v[idx]) for v in valids],
                    hv, shares, home, fanout)


def adopt(plan: SkewPlan, env) -> None:
    """Vote the finalized plan's hash (``exec/recovery.
    skew_plan_consensus``) before the split's first exchange, then record
    the plan (:func:`last_plan`) and count the split join
    (``timing.counts()["join.skew_split"]``, and the registry's
    ``skew_split_joins`` and ``skew_split_keys``)."""
    from ..exec.recovery import skew_plan_consensus
    from ..obs import metrics as _metrics
    skew_plan_consensus(env, plan.plan_hash())
    record_plan(plan)
    timing.bump("join.skew_split")
    _metrics.counter("skew_split_joins").inc()
    _metrics.counter("skew_split_keys").inc(len(plan))


def split_exchange(probe: Table, probe_on, build: Table, build_on,
                   plan: SkewPlan):
    """Run the split's exchanges:

    * **probe**: one exchange with the salted order-preserving targets
      (:func:`parallel.shuffle.skew_split_targets`);
    * **build**: light rows hash-shuffle; heavy rows are replicated
      (``allgather_table``), filtered to the ranks of their key's group and
      appended AFTER the light block, so every shard's per-key row order
      is the global (source, position) order the unsplit exchange would
      have delivered.

    Returns ``(probe_out, build_out)``."""
    from ..parallel import shuffle as shf
    from ..parallel.collectives import allgather_table
    from .repart import (concat_tables, exchange_by_targets, filter_table,
                         shuffle_table)

    env = probe.env
    cols = [probe.column(n) for n in probe_on]
    datas, valids = col_arrays(cols)
    need_nf, narrow = plan.operand_statics(cols)
    ko_t = plan.tuple_ops(need_nf, narrow, datas[0].device)
    with timing.region("skew.split_targets"):
        tgt = shf.skew_split_targets(
            env, datas, valids, probe.valid_counts, need_nf, narrow,
            ko_t.ops, plan.src_off, plan.fanout, plan.start)
        counts = shf.count_targets(env, tgt)
    probe_out = exchange_by_targets(probe, tgt, counts)
    del tgt

    with timing.region("skew.build_split"):
        flag = heavy_flag(build, build_on, plan)
        build_light = filter_table(build, ~flag)
        build_heavy = filter_table(build, flag)
        del flag
        bh_all = allgather_table(build_heavy)
        keep = heavy_flag(bh_all, build_on, plan,
                          member=group_member_mask(plan))
        bh_mine = filter_table(bh_all, keep)
    build_out = concat_tables([shuffle_table(build_light, build_on),
                               bh_mine])
    return probe_out, build_out


def finalize_or_none(plan: SkewPlan, probe: Table, probe_on,
                     build: Table, build_on) -> SkewPlan | None:
    """Exact-count finalization: per-source probe counts, the operand
    order among the tuples and the build counts, then
    :meth:`SkewPlan.finalize`.  Returns the plan or None."""
    probe_wk, ltmat = heavy_counts(probe, probe_on, plan, with_lt=True)
    build_wk, _ = heavy_counts(build, build_on, plan)
    if not plan.finalize(probe_wk, ltmat, build_wk,
                         int(build.valid_counts.sum())):
        return None
    return plan


def heavy_counts(table: Table, key_names, plan: SkewPlan,
                 with_lt: bool = False):
    """(W, K) exact per-source row counts of each heavy tuple in
    ``table``, plus (``with_lt``) the (K, K) operand order among the
    tuples, ``lt[i, j] = t_i < t_j``.  One host pull."""
    w, k = table.env.world_size, len(plan)
    gt, eq, live = _compare(table, key_names, plan)
    del gt
    eq &= live[:, None]
    counts = eq.view(local_world(w), -1, k).sum(dim=1)
    del eq
    lt = None
    if with_lt:
        cols = [table.column(n) for n in key_names]
        need_nf, narrow = plan.operand_statics(cols)
        ko_t = plan.tuple_ops(need_nf, narrow, live.device)
        gtt, _ = pack.rows_cmp_splitters(ko_t, ko_t.ops)
        lt = host_arrays([gtt.T])[0]
    # the per-source counts are row-sharded: every process's, gathered
    return host_arrays([counts], world=w)[0].astype(np.int64), lt


def heavy_flag(table: Table, key_names, plan: SkewPlan, member=None):
    """Per-row bool flags: the row's key is heavy (``member=None``), or
    heavy AND its rank belongs to the key's group (``member`` a (K, W)
    bool mask, :func:`group_member_mask`).  Padding rows are False."""
    w, k = table.env.world_size, len(plan)
    _gt, eq, live = _compare(table, key_names, plan)
    del _gt
    if member is not None:
        sp = span(w)
        mine = torch.from_numpy(np.ascontiguousarray(
            member.T[sp.start:sp.stop])).to(eq.device)      # (V, K)
        eq = eq.view(len(sp), -1, k) & mine[:, None, :]
    return eq.reshape(-1, k).any(dim=1) & live


def group_member_mask(plan: SkewPlan) -> np.ndarray:
    """(K, W) bool: rank w serves key k's group (contiguous mod W from the
    key's home anchor)."""
    k, w = len(plan), plan.world
    m = np.zeros((k, w), bool)
    for i in range(k):
        for j in range(int(plan.fanout[i])):
            m[i, (int(plan.start[i]) + j) % w] = True
    return m


# ---------------------------------------------------------------------------
# the fused pushdown's heavy-partial combine (relational/fused.py)
# ---------------------------------------------------------------------------

def combine_heavy_partials(out: Table, by, res_names, plan: SkewPlan):
    """Merge a fused join→groupby pushdown's heavy-key PARTIAL rows into
    the unsplit plan's one row per key.

    Under a plan a heavy key's probe rows span its rank group, so the
    fused result holds one partial row per member; for sum, count and
    sumsq (additive in the probe chunks) the combine sums each key's
    member rows onto the row on its HOME rank and drops the others.  The
    per-shard group sets, row order and values are then the unsplit
    fused plan's — exact for integer accumulators; a float sum folds the
    member partials in rank order and may differ from one shard's single
    pass in the low bits, deterministically."""
    from .repart import filter_table

    env = out.env
    w, k = plan.world, len(plan)
    vals = [out.column(n) for n in res_names]
    with timing.region("skew.partial_combine"):
        _gt, eq, live = _compare(out, by, plan)
        del _gt
        eq &= live[:, None]
        sp = span(w)
        eq3 = eq.view(len(sp), -1, k)
        parts = [torch.where(eq3, c.data.view(len(sp), -1, 1),
                             torch.zeros((), dtype=c.data.dtype,
                                         device=c.data.device)).sum(
                                             dim=1, dtype=c.data.dtype)
                 for c in vals]
        # rank-order host fold: deterministic
        combined = [np.ascontiguousarray(p.sum(axis=0))
                    for p in host_arrays(parts, world=w)]
        heavy = eq.any(dim=1)
        kidx = eq.to(torch.uint8).argmax(dim=1)
        my = torch.arange(sp.start, sp.stop,
                          device=eq.device).repeat_interleave(eq3.shape[1])
        home = torch.from_numpy(plan.home.astype(np.int64)).to(eq.device)
        is_home = heavy & (home[kidx] == my)
        keep = live & (~heavy | is_home)
        del eq, eq3, my
        newcols = dict(out.columns)
        for n, c, tot in zip(res_names, vals, combined):
            tot_t = torch.from_numpy(tot).to(c.data.device)
            d = torch.where(is_home, tot_t[kidx], c.data)
            # bounds dropped: the totals may leave the partials' range
            newcols[n] = Column(d, c.type, c.validity, c.dictionary)
        patched = Table(newcols, env, np.asarray(out.valid_counts, np.int64))
        res = filter_table(patched, keep)
    res.grouped_by = tuple(by)
    from ..obs import plan as _plan
    _plan.annotate(skew_partials_combined=len(plan))
    timing.bump("skew.partial_combine")
    return res


# ---------------------------------------------------------------------------
# stitch: every output row's position in the UNSPLIT plan's order
# ---------------------------------------------------------------------------

def stitch_join_output(out: Table, key_out_names, plan: SkewPlan,
                       how: str, un_counts: np.ndarray | None) -> Table:
    """Merge the split join's output back into the UNSPLIT hash plan's
    global row order (bit- and order-equal), on the even order-preserving
    layout (``repart.place_by_global_pos``).

    ``key_out_names``: the output columns holding the PROBE side's key
    values.  ``un_counts``: per-shard appended unmatched-right counts of
    an outer join (None: zeros).  Each shard's output is its main zone
    (the merge-ordered rows, key-sorted) followed by zone B (an outer
    join's unmatched right rows).  A row's unsplit position:

    * light main row at shard r, slot p:
      ``segoff[r] + p + Σ_{t_j < key} coefA[r, j]`` (remove the heavy
      slices sorting before it, insert the full heavy blocks homed at r
      that sort before it);
    * heavy row of key j, offset ``within`` in its run: the member holds
      probe rows ``m, m+f, m+2f, …`` of the key, each giving ``per_row``
      output rows, so with ``i = within // per_row`` and ``b = within mod
      per_row`` it sits at ``coefH[r, j] + i · fanout_j · per_row_j + b``;
    * zone-B row: ``segoff[r] + seg_a[r] + (p - main[r])``.

    The run offset is closed-form: the key's run starts after the main
    rows whose key sorts before its tuple."""
    from .repart import place_by_global_pos

    env = out.env
    w, k = plan.world, len(plan)
    out_counts = np.asarray(out.valid_counts, np.int64)
    total = int(out_counts.sum())
    un = np.zeros(w, np.int64) if un_counts is None \
        else np.asarray(un_counts, np.int64)
    main = out_counts - un

    per_row = plan.n_build if how == "inner" \
        else np.maximum(plan.n_build, 1)
    out_k = (plan.n_probe * per_row).astype(np.int64)      # (K,) blocks
    # slice_size[r, j]: heavy output rows of key j at member shard r
    ordinal = (np.arange(w)[:, None] - plan.start[None, :]) % w   # (W, K)
    in_group = ordinal < plan.fanout[None, :]
    chunk_rows = np.where(
        in_group, plan.chunk[np.arange(k)[None, :],
                             np.clip(ordinal, 0, w - 1)], 0)
    slice_size = chunk_rows * per_row[None, :]
    # member ordinal m holds probe rows m, m+f, m+2f... of the key: its
    # first output row sits at block offset m · per_row
    slice_off = np.where(in_group, np.clip(ordinal, 0, w - 1), 0) \
        * per_row[None, :]

    light_main = main - slice_size.sum(axis=1)
    home_mat = (plan.home[None, :] == np.arange(w)[:, None])      # (W, K)
    seg = light_main + home_mat @ out_k + un                      # (W,)
    if int(seg.sum()) != total:
        raise ExecutionError(
            f"skew stitch accounting diverged: unsplit segments sum to "
            f"{int(seg.sum())} rows but the split output holds {total} — "
            "plan counts and join output disagree")
    segoff = np.concatenate([[0], np.cumsum(seg)[:-1]]).astype(np.int64)

    cap = out.capacity
    with timing.region("skew.stitch_count"):
        gt, eq, live = _compare(out, key_out_names, plan)
        dev = live.device
        sp = span(w)
        p = torch.arange(cap, dtype=torch.int64, device=dev).repeat(len(sp))
        main_t = torch.from_numpy(main).to(dev)
        my = torch.arange(sp.start, sp.stop,
                          device=dev).repeat_interleave(cap)
        zone_a = p < main_t[my]
        za = zone_a[:, None]
        jlt_d = (gt & za).view(len(sp), cap, k).sum(dim=1)
        jeq_d = (eq & za).view(len(sp), cap, k).sum(dim=1)
        jlt, jeq = (a.astype(np.int64)
                    for a in host_arrays([jlt_d, jeq_d], world=w))
        del za, jlt_d, jeq_d
    # light rows at the HOME shard sorting after key j's tuple (remove the
    # other heavy keys' slices the joint count included: key j' at shard
    # d counts against tuple k iff t_k < t_j', i.e. lt[k, j'])
    light_lt = jlt - slice_size @ plan.lt.T.astype(np.int64)
    # the key's block base in the UNSPLIT plan: its home segment's offset
    # + the light rows sorting BEFORE it there + the full blocks of heavy
    # keys also homed there that sort before it
    light_before = light_main[plan.home] - light_lt[plan.home,
                                                    np.arange(k)]
    block_base = (segoff[plan.home] + light_before
                  + ((plan.lt & (plan.home[:, None] == plan.home[None, :]))
                     .T @ out_k))
    coef_a = (-slice_size + home_mat * out_k[None, :]).astype(np.int64)
    coef_h = (block_base[None, :] + slice_off).astype(np.int64)
    # first slot of key j's run in shard r's main zone
    run0 = (main[:, None] - jlt - jeq).astype(np.int64)

    def dev64(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    with timing.region("skew.stitch_pos"):
        zone_b = live & ~zone_a
        heavy = eq.any(dim=1) & live & ~zone_b
        kidx = eq.to(torch.uint8).argmax(dim=1)
        del eq
        ca = dev64(coef_a)
        corr = torch.where(gt, ca[my], 0).sum(dim=1)
        del gt, ca
        pos_light = dev64(segoff)[my] + p + corr
        del corr
        pr_t = dev64(np.maximum(per_row, 1))[kidx]
        within = p - dev64(run0)[my, kidx]
        i = torch.div(within, pr_t, rounding_mode="floor")
        b = within - i * pr_t
        pos_heavy = dev64(coef_h)[my, kidx] + i * (
            dev64(plan.fanout)[kidx] * pr_t) + b
        del pr_t, within, i, b
        pos_b = dev64(segoff + seg - un)[my] + (p - main_t[my])
        pos = torch.where(zone_b, pos_b,
                          torch.where(heavy, pos_heavy, pos_light))
        pos = torch.where(live, pos, torch.full((), total, dtype=torch.int64,
                                                device=dev))
        del pos_b, pos_heavy, pos_light, heavy, zone_b, zone_a, kidx, my, p
    with timing.region("skew.stitch_place"):
        stitched = place_by_global_pos(out, pos, total)
    from ..exec import integrity
    if integrity.armed():
        # the armed audit: the stitched table's fingerprint, voted, so a
        # corrupted or misplaced stitch surfaces typed at this boundary
        integrity.audit_table(stitched, site="skew.stitch",
                              phase="post_stitch")
    return stitched
