"""Table-level groupby-aggregate, local and distributed (port of
``cylon_tpu/relational/groupby.py``).

Routes, in the reference's order:

* the fused join→groupby pushdown (relational/fused.py) for an
  unmaterialized inner join grouped by its keys;
* **combine → shuffle → final** for associative ops at world size W > 1:
  each shard pre-combines its rows into per-group intermediates
  (``INTER_NAMES``), the intermediate table (columns ``__i{i}_{name}``)
  is shrunk to its group count and hash-shuffled on the keys, and each
  shard combines again and finalizes;
* the **raw route** for the rest: non-associative ops at W > 1 shuffle
  their rows first, then one single-phase pass per shard;
* the **grouped fast path** (part of the raw route), taken when
  ``table.grouped_by == by`` (join or sort output): boundary flags give
  the group ids, no shuffle, no rank sort.

Group identity is a dense rank instead of a hash map.  A non-grouped
shard either sorts its rows by key and reduces the runs (the *sort path*:
every cumsum-able op, the min/max counts and the representative keys come
from ``ops/groupby.grouped_reduce``'s one prefix-difference gather) or
dense-ranks the keys and scatter-reduces every op in source order (the
*scatter path*).  :func:`_plan_vspec` chooses, with the reference's cost
constants, so both packages reduce in the same association order.  The
reference's ``_pad_ladder``, ``pad_lanes`` and ``gather_parts`` exist
only to dodge XLA:TPU compiler crashes and have no counterpart.

Every dispatch pulls its group counts once (one batched pull over the
shards); a large first sight dispatches at ``_FIRST_SEG_CAP`` segments
and redispatches at the true bucket, and ``_SEG_CACHE`` remembers the
bucket per call site.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.column import Column, HashedStrings
from ..core.dtypes import (LogicalType, from_numpy_dtype, np_dtype_of,
                           physical_np_dtype, torch_dtype)
from ..core.table import Table
from ..obs import plan as _plan
from ..ops import groupby as gbk
from ..ops import lanes, pack
from ..ops.sort import take_data
from ..parallel.shards import map_shards, shard
from ..status import InvalidError
from ..utils import timing
from ..utils.host import host_array
from .common import PAD_L, BoundedCache, col_arrays, live_mask, narrow32_flags
from .repart import shuffle_table

_VALID_OPS = gbk.ASSOCIATIVE | gbk.NON_ASSOCIATIVE

#: callsite-signature -> last observed group-count bucket
_SEG_CACHE = BoundedCache()

#: optimistic first-dispatch segment space for large-capacity groupbys with
#: no hysteresis prediction yet; a mispredict is detected through the
#: returned group count and redispatched at the true bucket
_FIRST_SEG_CAP = 512

#: dispatches of the sort-based groupby's first phase (raw or combine) and
#: how many of them were redispatches at a larger segment space
COUNTS = {"dispatches": 0, "redispatches": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


#: intermediate columns per op, in the reference's order
INTER_NAMES = {
    "sum": ("sum",),
    "sumsq": ("sumsq",),
    "count": ("count",),
    "min": ("count", "min"),
    "max": ("count", "max"),
    "mean": ("count", "sum"),
    "var": ("count", "sum", "sumsq"),
    "std": ("count", "sum", "sumsq"),
}


def _normalize_aggs(aggs):
    """aggs: list of (value_col, op) or (value_col, op, q). Returns list of
    (col, op, q, out_name)."""
    out, seen = [], set()
    for a in aggs:
        col, op = a[0], a[1]
        q = a[2] if len(a) > 2 else 0.5
        if op == "median":
            op, q = "quantile", 0.5
        if op not in _VALID_OPS:
            raise InvalidError(f"unknown aggregation {op!r}")
        name = f"{col}_{a[1]}"
        if op == "quantile" and a[1] == "quantile" and len(a) > 2:
            name = f"{col}_quantile_{q:g}"
        if name in seen:
            raise InvalidError(f"duplicate aggregation output {name!r}")
        seen.add(name)
        out.append((col, op, float(q), name))
    return out


# ---------------------------------------------------------------------------
# per-shard pieces (world-1 functions; map_shards runs them per rank)
# ---------------------------------------------------------------------------

def _group_keys(by_datas, by_valids, n_live: int, grouped: bool = False,
                narrow: tuple | None = None):
    """Dense group ids of one shard: ``(gids, n_groups, mask, first)``.
    Padding rows get id ``cap``.  ``grouped``: equal keys are already
    contiguous, so the ids come from boundary flags (``first`` marks each
    group's first row); otherwise a dense rank (``first`` is None)."""
    cap = by_datas[0].shape[0]
    mask = live_mask([n_live], cap, by_datas[0].device)
    if grouped:
        gids, n_groups, first = pack.grouped_gids(list(by_datas),
                                                  list(by_valids), mask,
                                                  narrow)
        return gids, n_groups, mask, first
    ko = pack.key_operands(list(by_datas), list(by_valids), row_mask=mask,
                           pad_key=PAD_L, narrow32=narrow)
    gids, _ = pack.dense_rank(ko)
    del ko
    n_groups = pack.count_groups(gids, mask)
    return torch.where(mask, gids, cap), n_groups, mask, None


def _value_mask(mask, val, valid):
    """Row mask for an aggregation payload: live AND valid AND (floats)
    not NaN — pandas ``skipna=True``."""
    vmask = mask if valid is None else (mask & valid)
    if val.dtype.is_floating_point:
        vmask = vmask & ~torch.isnan(val)
    return vmask


def _plan_vspec(val_cols, by_cols, narrow, n_inters: int = 1):
    """Sort-path eligibility, with the reference's cost model: a LaneSpec
    over (value columns ++ key columns) when riding the rank sort (about
    1.7 ns/row per lane, f64 columns through one side gather) is priced
    below per-op segment scatters (about 12 ns/row per intermediate plus
    the gid scatter), else None.  The constants were measured on a TPU;
    whether this card would choose otherwise is open (PERF.md)."""
    cand = lanes.plan_lanes(
        tuple(np_dtype_of(c.data).name for c in val_cols + by_cols),
        tuple(c.validity is not None for c in val_cols + by_cols),
        narrow32_flags(val_cols) + tuple(narrow))
    n_side = sum(1 for c in cand.cols if not c.lanes)
    sort_ns = 1.7 * (cand.n_lanes + (1 if n_side else 0))
    if n_side:
        sort_ns += 15.5 * (1 + 0.2 * (n_side - 1))
    scatter_ns = 12.0 * max(n_inters, 1) + 8.8
    return cand if sort_ns <= scatter_ns else None


def _rep_keys(by_datas, by_valids, gids, seg_cap: int):
    """Representative key row per group (its first source row)."""
    rep = gbk.group_first_index(gids, seg_cap)
    safe = rep.clamp(0, by_datas[0].shape[0] - 1).long()
    return (tuple(take_data(d, safe) for d in by_datas),
            tuple(None if v is None else v[safe] for v in by_valids))


def _sort_state(n_live: int, by_datas, by_valids, val_datas, val_valids,
                narrow):
    """THE SORT PATH of a non-grouped shard: one stable lexicographic sort
    of the key operands (padding last), every key and value column
    gathered at the permutation, so the shard becomes run-contiguous.
    Returns ``(gids, n_groups, mask, first, by_datas, by_valids,
    val_datas, val_valids)`` with the columns replaced by their sorted
    versions."""
    cap = by_datas[0].shape[0]
    dev = by_datas[0].device
    mask = live_mask([n_live], cap, dev)
    ko = pack.key_operands(list(by_datas), list(by_valids), row_mask=mask,
                           pad_key=PAD_L, narrow32=narrow)
    words = pack.sort_words(ko)
    del ko
    perm = pack.lex_sort_perm(words)
    first = pack.neighbor_flags([w[perm] for w, _ in words],
                                [k for _, k in words]) != 0
    del words
    first[:1] = True
    first &= mask
    gid = torch.cumsum(first, 0, dtype=torch.int32) - 1
    n_groups = pack.count_groups(gid, mask)
    gids = torch.where(mask, gid, cap)
    del gid

    def take(xs):
        return tuple(None if x is None else take_data(x, perm) for x in xs)

    return (gids, n_groups, mask, first, take(by_datas), take(by_valids),
            take(val_datas), take(val_valids))


def _runs_reduce(ops, val_datas, vmasks, gids, first, mask, n_live: int,
                 seg_cap: int, by_datas, by_valids, narrow, vnarrow):
    """Per-op intermediate dicts + representative keys of a run-contiguous
    (grouped or freshly sorted) shard: every cumsum-able intermediate and
    the min/max counts ride ``grouped_reduce``'s one prefix-difference
    gather; only the min/max extrema take segment scatters.  Ops outside
    CUMSUMMABLE/min/max get no entry."""
    starts = gbk.grouped_starts(gids, first, mask, n_live, seg_cap)
    batch = []
    for i, op in enumerate(ops):
        if op in gbk.CUMSUMMABLE:
            batch.append((op, i))
        elif op in ("min", "max"):
            batch.append(("count", i))
    inters_b, key_out, kval_out, _ = gbk.grouped_reduce(
        [b[0] for b in batch], [val_datas[b[1]] for b in batch],
        [vmasks[b[1]] for b in batch], starts, n_live, list(by_datas),
        list(by_valids), seg_cap, key_narrow=narrow,
        value_narrow=[bool(vnarrow[b[1]]) if vnarrow else False
                      for b in batch])
    del starts
    inters: dict = {}
    for (op, i), d in zip(batch, inters_b):
        inters.setdefault(i, {}).update(d)
    for i, op in enumerate(ops):
        if op == "min":
            inters[i]["min"] = gbk.seg_min(val_datas[i], gids, seg_cap,
                                           vmasks[i])
        elif op == "max":
            inters[i]["max"] = gbk.seg_max(val_datas[i], gids, seg_cap,
                                           vmasks[i])
    return inters, key_out, kval_out


def _combine_fn(ops: tuple, seg_cap: int, narrow: tuple, sort_path: bool,
                val_map: tuple, n_live: int, by_datas, by_valids,
                uval_datas, uval_valids):
    """Phase 1 on one shard: group the keys, reduce each (col, op) into
    its intermediates of length ``seg_cap`` (groups in key order, then
    empty slots), and the representative keys.  Returns ``(key_out,
    kval_out, inter_out, n_groups)``."""
    if sort_path:
        (gids, n_groups, mask, first, by_datas, by_valids, uval_datas,
         uval_valids) = _sort_state(n_live, by_datas, by_valids, uval_datas,
                                    uval_valids, narrow)
    else:
        gids, n_groups, mask, first = _group_keys(by_datas, by_valids,
                                                  n_live, False, narrow)
    val_datas = tuple(uval_datas[j] for j in val_map)
    val_valids = tuple(uval_valids[j] for j in val_map)
    vmasks = [_value_mask(mask, val_datas[i], val_valids[i])
              for i in range(len(ops))]
    if first is not None:
        inters, key_out, kval_out = _runs_reduce(
            ops, val_datas, vmasks, gids, first, mask, n_live, seg_cap,
            by_datas, by_valids, narrow, ())
    else:
        key_out, kval_out = _rep_keys(by_datas, by_valids, gids, seg_cap)
        inters = {i: gbk.combine_locally(op, val_datas[i], gids, seg_cap,
                                         vmasks[i])
                  for i, op in enumerate(ops)}
    inter_out = tuple(tuple(inters[i][k] for k in INTER_NAMES[op])
                      for i, op in enumerate(ops))
    return key_out, kval_out, inter_out, n_groups


def _final_fn(ops: tuple, seg_cap: int, ddof: int, narrow: tuple,
              n_live: int, by_datas, by_valids, inter_by_op):
    """Phase 2 on one shard: reduce the shuffled intermediates under the
    new key grouping and finalize each op.  The intermediates ride the
    one key sort; every sum-like intermediate (sum/sumsq/count) comes out
    of the prefix-difference gather, min/max take segment scatters.
    Returns ``(key_out, kval_out, res_d, res_v, n_groups)``."""
    flat_arrs, flat_kinds = [], []
    for i, op in enumerate(ops):
        for nm, arr in zip(INTER_NAMES[op], inter_by_op[i]):
            flat_arrs.append(arr)
            flat_kinds.append("sum" if nm in ("sum", "sumsq", "count")
                              else nm)
    (gids, n_groups, mask, first, s_by, s_byv, s_arrs, _) = _sort_state(
        n_live, by_datas, by_valids, tuple(flat_arrs),
        (None,) * len(flat_arrs), narrow)
    del flat_arrs
    starts = gbk.grouped_starts(gids, first, mask, n_live, seg_cap)
    sum_idx = [j for j, k in enumerate(flat_kinds) if k == "sum"]
    inters_b, key_out, kval_out, _ = gbk.grouped_reduce(
        ["sum"] * len(sum_idx), [s_arrs[j] for j in sum_idx],
        [mask] * len(sum_idx), starts, n_live, list(s_by), list(s_byv),
        seg_cap, key_narrow=narrow)
    del starts
    red_flat = [None] * len(flat_kinds)
    for j, d in zip(sum_idx, inters_b):
        red_flat[j] = d["sum"]
    for j, k in enumerate(flat_kinds):
        if k == "min":
            red_flat[j] = gbk.seg_min(s_arrs[j], gids, seg_cap, mask)
        elif k == "max":
            red_flat[j] = gbk.seg_max(s_arrs[j], gids, seg_cap, mask)
    res_d, res_v = [], []
    k = 0
    for op in ops:
        inter = {}
        for nm in INTER_NAMES[op]:
            inter[nm] = red_flat[k]
            k += 1
        if "count" in inter:
            inter["count"] = inter["count"].to(torch.int64)
        d, v = gbk.finalize(op, inter, ddof)
        res_d.append(d)
        res_v.append(v)
    return key_out, kval_out, tuple(res_d), tuple(res_v), n_groups


def _raw_fn(specs: tuple, seg_cap: int, ddof: int, grouped: bool,
            narrow: tuple, vnarrow: tuple, sort_path: bool, val_map: tuple,
            n_live: int, by_datas, by_valids, uval_datas, uval_valids):
    """Single phase on one shard over co-located raw rows: non-associative
    ops, the local route and the grouped fast path.  ``sort_path``
    (non-grouped shards only) sorts the key and value columns first;
    ``vnarrow[i]`` (rows·max|v| fits int32, from the column bounds) lets
    the run reduction narrow an integer sum prefix to one lane.  Returns
    ``(key_out, kval_out, res_d, res_v, n_groups)``."""
    if sort_path:
        (gids, n_groups, mask, first, by_datas, by_valids, uval_datas,
         uval_valids) = _sort_state(n_live, by_datas, by_valids, uval_datas,
                                    uval_valids, narrow)
    else:
        gids, n_groups, mask, first = _group_keys(by_datas, by_valids,
                                                  n_live, grouped, narrow)
    val_datas = tuple(uval_datas[j] for j in val_map)
    val_valids = tuple(uval_valids[j] for j in val_map)
    vmasks = [_value_mask(mask, val_datas[i], val_valids[i])
              for i in range(len(specs))]
    batched: dict = {}
    if first is not None:
        batched, key_out, kval_out = _runs_reduce(
            tuple(op for op, _ in specs), val_datas, vmasks, gids, first,
            mask, n_live, seg_cap, by_datas, by_valids, narrow, vnarrow)
    else:
        key_out, kval_out = _rep_keys(by_datas, by_valids, gids, seg_cap)
    res_d, res_v = [], []
    for i, (op, q) in enumerate(specs):
        if op in gbk.ASSOCIATIVE:
            inter = batched[i] if i in batched else gbk.combine_locally(
                op, val_datas[i], gids, seg_cap, vmasks[i])
            d, v = gbk.finalize(op, inter, ddof)
        elif op == "nunique":
            ko = pack.key_operands([val_datas[i]], [val_valids[i]])
            d = gbk.nunique(ko, gids, seg_cap, vmasks[i])
            v = None
        else:  # quantile
            d, v = gbk.quantile(val_datas[i], gids, seg_cap, q, vmasks[i])
        res_d.append(d)
        res_v.append(v)
    return key_out, kval_out, tuple(res_d), tuple(res_v), n_groups


def _per_shard(fn, valid_counts, *cols):
    """Run ``fn(n_live, *shard views of cols)`` on every rank, the results
    stacked shard-major (each leaf at its rank-0 length; the group count
    as one row per rank)."""
    vc = np.asarray(valid_counts, np.int64)
    w = len(vc)

    def views(x, r):
        if isinstance(x, (tuple, list)):
            return tuple(views(y, r) for y in x)
        return shard(x, w, r)

    return map_shards(lambda r: fn(int(vc[r]), *views(cols, r)), w)


def _dispatch(call, pred_key, cap_full: int):
    """Dispatch ``call(seg_cap)`` at the predicted segment space, pull the
    per-shard group counts once, and redispatch at the true bucket when
    they exceed it.  Returns ``(result, n_groups)``."""
    pred = _SEG_CACHE.get(pred_key)
    if pred is not None and pred < cap_full:
        seg_cap = pred
    elif pred is None and cap_full > _FIRST_SEG_CAP:
        seg_cap = _FIRST_SEG_CAP
    else:
        seg_cap = cap_full
    res = call(seg_cap)
    COUNTS["dispatches"] += 1
    n_groups = host_array(res[-1]).astype(np.int64).reshape(-1)
    ng_cap = min(config.pow2ceil(int(n_groups.max()) if n_groups.size
                                 else 1), cap_full)
    if ng_cap > seg_cap:
        res = call(ng_cap)
        COUNTS["dispatches"] += 1
        COUNTS["redispatches"] += 1
        n_groups = host_array(res[-1]).astype(np.int64).reshape(-1)
    _SEG_CACHE.put(pred_key, ng_cap)
    return res, n_groups


# ---------------------------------------------------------------------------
# table-level assembly
# ---------------------------------------------------------------------------

def _shrink(table: Table, n_rows: np.ndarray) -> Table:
    """Slice each shard's dense row prefix down to one pow2 cap over the
    shards, ``pow2ceil(max n_rows)``: shard r's rows then start at
    ``r·new_cap`` (a view at world size 1, one copy above it)."""
    cap = table.capacity
    new_cap = config.pow2ceil(int(n_rows.max()) if n_rows.size else 1)
    if new_cap >= cap:
        return table
    w = table.env.world_size

    def cut(x):
        if x is None:
            return None
        return x.view(w, cap)[:, :new_cap].reshape(w * new_cap)

    cols = {n: Column(cut(c.data), c.type, cut(c.validity), c.dictionary)
            for n, c in table.columns.items()}
    return Table(cols, table.env, n_rows)


def _result_types(specs, val_cols):
    """Logical type + dictionary of each aggregation result column."""
    types, dicts = [], []
    for (c, op, _, _), col in zip(specs, val_cols):
        if op in ("count", "nunique"):
            types.append(LogicalType.INT64)
            dicts.append(None)
        elif col.type == LogicalType.STRING:  # min/max of strings = codes
            types.append(LogicalType.STRING)
            dicts.append(col.dictionary)
        else:
            src = physical_np_dtype(col.type)
            types.append(from_numpy_dtype(gbk.np_result_dtype(op, src)))
            dicts.append(None)
    return types, dicts


def _result_table(env, by_names, by_cols, key_out, kval_out, res_names,
                  res_d, res_v, res_types, res_dicts, n_groups) -> Table:
    cols = {}
    for n, c, d, v in zip(by_names, by_cols, key_out, kval_out):
        cols[n] = Column(d, c.type, v, c.dictionary)
    for n, d, v, t, dc in zip(res_names, res_d, res_v, res_types, res_dicts):
        phys = torch_dtype(physical_np_dtype(t))
        if d.dtype != phys:  # f64 accumulators -> declared result dtype
            d = d.to(phys)
        # result names are `{col}_{op}`, so the op suffix is derivable here
        gbk.guard_saturation(n.rsplit("_", 1)[-1], d, column=n)
        cols[n] = Column(d, t, v, dc)
    return Table(cols, env, np.asarray(n_groups, np.int64))


def combine_sink_partials(partial: Table, by, aggs, chunk_aggs,
                          combine_ops, ddof: int = 1,
                          disjoint: bool = False) -> Table:
    """Fold a table of per-piece partial aggregates (the concatenation of
    an ``exec/pipeline.GroupBySink``'s partials) into the final aggregate
    table.  ``chunk_aggs``: the sorted distinct (col, intermediate op)
    pairs the sink keeps; ``combine_ops``: intermediate op -> combining
    op.  ``disjoint``: the partials' key sets are pairwise disjoint (a
    sink keyed on the range-partitioned join keys), so the partials ARE
    the final groups and pass through renamed; otherwise one groupby over
    the partials combines them.  Derived ops (mean/var/std) finalize from
    the summed (count, sum[, sumsq]) intermediates with
    :func:`cylon_tpu_torch.ops.groupby.finalize`, as the reference
    does."""
    if disjoint:
        comb = partial

        def part(col, i):
            return comb.column(f"{col}_{i}")
    else:
        comb = groupby_aggregate(
            partial, by, [(f"{c}_{i}", combine_ops[i]) for c, i in chunk_aggs])

        def part(col, i):
            return comb.column(f"{col}_{i}_{combine_ops[i]}")

    cols = {n: comb.column(n) for n in by}
    for col, op, *_ in aggs:
        name = f"{col}_{op}"
        if op in ("mean", "var", "std"):
            s = part(col, "sum").data
            inter = {"count": part(col, "count").data,
                     "sum": s if s.dtype.is_floating_point
                     else s.to(torch_dtype(np.float64))}
            if op != "mean":
                inter["sumsq"] = part(col, "sumsq").data
            d, v = gbk.finalize(op, inter, ddof)
            cols[name] = Column(d, from_numpy_dtype(np_dtype_of(d)), v)
        else:
            # sum/count/min/max ARE their own intermediate: pass through.
            # The armed overflow guard runs here because the pass-through
            # never reaches _result_table's guard
            c = part(col, op)
            gbk.guard_saturation(op, c.data, column=name,
                                 site="groupby.combine")
            cols[name] = c
    out = Table(cols, partial.env, np.asarray(comb.valid_counts, np.int64))
    out.grouped_by = None  # combine order is piece-partial order
    return out


def groupby_aggregate(table: Table, by, aggs, ddof: int = 1) -> Table:
    """Group ``table`` by key columns ``by`` and aggregate.

    aggs: list of (value_col, op[, q]) with op in sum/count/min/max/mean/
    var/std/sumsq/nunique/quantile/median.  Returns the key columns + one
    column per agg named ``{col}_{op}`` (``{col}_quantile_{q:g}`` for an
    explicit quantile), one row per group, each shard's groups in key
    order, ``grouped_by = by``.  Null keys form their own group.

    A device OOM retries as a chunked streaming aggregation (a
    ``GroupBySink`` over ``chunk_table(table, n)``, n = 4 then 16) under
    the retry ladder (exec/recovery.run_with_recovery), when every op
    decomposes through public partials (sum/count/min/max/mean/var/std)."""
    from ..core.table import DeferredTable
    from ..exec.pipeline import GroupBySink, chunk_table
    from .common import run_with_oom_fallback
    from .skew import consume_unstitched

    def fallback(nc):
        _plan.annotate(route="chunked_sink", n_chunks=nc)
        sink = GroupBySink(by, aggs, ddof=ddof)
        for ch in chunk_table(table, nc):
            sink(ch)
        return sink.finalize()

    by_l = [by] if isinstance(by, str) else list(by)
    with _plan.node("groupby", by=tuple(by_l),
                    aggs=tuple((a[0], a[1]) for a in aggs
                               if isinstance(a, (list, tuple))
                               and len(a) >= 2)) as pn:
        # a stitch-deferred skew join hands over its split layout: an
        # aggregation cannot observe row order or placement, so the
        # stitch never runs for a join → groupby
        table = consume_unstitched(table)
        if pn:
            # a deferred input stays untouched: its counts or a key
            # sample would force the materialization the fused pushdown
            # avoids
            if not isinstance(table, DeferredTable):
                pn.set(rows_in=table.row_count)
                _plan.profile_keys(pn, table, by_l)
            else:
                pn.annotate(deferred_input=True)
        res = run_with_oom_fallback(
            lambda: _groupby_attempt(table, by, aggs, ddof),
            can_fallback=all(a[1] in GroupBySink._DECOMP for a in aggs),
            fallback=fallback, label="groupby", env=table.env)
        if pn and type(res) is Table:
            pn.set(rows_out=res.row_count)
        return res


def _groupby_attempt(table, by, aggs, ddof: int) -> Table:
    from ..exec.recovery import maybe_inject
    maybe_inject("groupby.device_oom")   # the device-OOM test point
    by = [by] if isinstance(by, str) else list(by)
    specs = _normalize_aggs(aggs)
    from .skew import consume_unstitched
    # an unmaterialized inner join grouped by its keys aggregates off the
    # pre-expansion state; it must run before any column access below,
    # which would materialize the join
    from .fused import try_join_groupby_pushdown
    pushed = try_join_groupby_pushdown(table, by, specs, ddof)
    if pushed is not None:
        _plan.annotate(route="fused_pushdown")
        return pushed
    # a deferred skew join the pushdown declined: its split layout too
    table = consume_unstitched(table, include_deferred=True)
    return _groupby_aggregate_impl(table, by, specs, ddof)


def _groupby_aggregate_impl(table: Table, by: list, specs, ddof: int) -> Table:
    env = table.env
    by_cols = [table.column(n) for n in by]
    val_cols = [table.column(c) for c, _, _, _ in specs]
    for n, col in zip(by, by_cols):
        if col.type == LogicalType.LIST:
            raise InvalidError(
                f"groupby on list passthrough column {n!r} is not "
                "supported (codes are row ids, not value-equal)")
    for (c, op, _, _), col in zip(specs, val_cols):
        if col.type == LogicalType.LIST and op != "count":
            raise InvalidError(
                f"agg {op!r} not valid for list passthrough column {c!r}")
        if col.type == LogicalType.STRING and op not in ("count", "nunique",
                                                         "min", "max"):
            raise InvalidError(f"agg {op!r} not valid for string column {c!r}")
        if (col.type == LogicalType.STRING and op in ("min", "max")
                and isinstance(col.dictionary, HashedStrings)):
            raise InvalidError(
                f"agg {op!r} on high-cardinality hashed string column "
                f"{c!r}: hashed codes carry no lexical order")
    res_types, res_dicts = _result_types(specs, val_cols)
    res_names = [n for _, _, _, n in specs]
    all_assoc = all(op in gbk.ASSOCIATIVE for _, op, _, _ in specs)
    distributed = env.world_size > 1
    # grouped fast path: equal keys contiguous per shard AND co-located
    # across shards (join/sort/groupby output)
    grouped = (table.grouped_by is not None
               and tuple(by) == tuple(table.grouped_by))
    narrow = narrow32_flags(by_cols)
    uniq_names = list(dict.fromkeys(c for c, _, _, _ in specs))
    val_map = tuple(uniq_names.index(c) for c, _, _, _ in specs)

    if distributed and all_assoc and not grouped:
        _plan.annotate(route="combine_shuffle")
        return _combine_route(table, by, by_cols, specs, uniq_names,
                              val_map, narrow, ddof, res_names, res_types,
                              res_dicts)

    # non-associative ops (or local, or grouped input): co-locate raw rows
    _plan.annotate(route="grouped_fastpath" if grouped else "raw")
    work = table.project(list(dict.fromkeys(by + uniq_names)))
    if distributed and not grouped:
        # the one groupby route a heavy key can pile onto one rank: every
        # row of a group must meet (quantile, median, nunique)
        _plan.annotate(skew_vulnerable=True)
        work = shuffle_table(work, by)
    by_datas, by_valids = col_arrays([work.column(n) for n in by])
    uval_cols = [work.column(c) for c in uniq_names]
    uval_datas, uval_valids = col_arrays(uval_cols)
    spec_t = tuple((op, q) for _, op, q, _ in specs)
    cap_full = max(work.capacity, 1)

    def sum_fits_i32(col: Column) -> bool:
        b = col.bounds
        if b is None or np_dtype_of(col.data).kind not in ("i", "u"):
            return False
        return max(abs(int(b[0])), abs(int(b[1]))) * cap_full < (1 << 31)

    vnarrow = tuple(sum_fits_i32(work.column(c)) for c, _, _, _ in specs)
    sort_path = False
    if not grouped:
        n_inters = sum(len(INTER_NAMES[op]) for _, op, _, _ in specs
                       if op in gbk.ASSOCIATIVE)
        sort_path = _plan_vspec(uval_cols, [work.column(n) for n in by],
                                narrow, max(n_inters, 1)) is not None
    seg_key = (env.serial, spec_t, tuple(by), grouped, narrow, ddof,
               cap_full, int(work.valid_counts.sum()))

    def raw_call(sc):
        return _per_shard(
            lambda n_live, *a: _raw_fn(spec_t, sc, ddof, grouped, narrow,
                                       vnarrow, sort_path, val_map, n_live,
                                       *a),
            work.valid_counts, by_datas, by_valids, uval_datas, uval_valids)

    with timing.region("groupby.raw"):
        (key_out, kval_out, res_d, res_v, _), n_groups = _dispatch(
            raw_call, seg_key, cap_full)
    out = _result_table(env, by, by_cols, key_out, kval_out, res_names, res_d,
                        res_v, res_types, res_dicts, n_groups)
    out = _shrink(out, n_groups)
    out.grouped_by = tuple(by)
    return out


def _combine_route(table, by, by_cols, specs, uniq_names, val_map, narrow,
                   ddof, res_names, res_types, res_dicts) -> Table:
    """Associative ops at W > 1: local pre-combine, the intermediates'
    hash shuffle, the final combine."""
    env = table.env
    by_datas, by_valids = col_arrays(by_cols)
    uval_cols = [table.column(c) for c in uniq_names]
    uval_datas, uval_valids = col_arrays(uval_cols)
    ops_t = tuple(op for _, op, _, _ in specs)
    cap_full = max(table.capacity, 1)
    sort_path = _plan_vspec(uval_cols, by_cols, narrow,
                            sum(len(INTER_NAMES[op]) for op in ops_t)) \
        is not None

    def combine_call(sc):
        return _per_shard(
            lambda n_live, *a: _combine_fn(ops_t, sc, narrow, sort_path,
                                           val_map, n_live, *a),
            table.valid_counts, by_datas, by_valids, uval_datas, uval_valids)

    seg_key = ("combine-seg", env.serial, ops_t, tuple(by), narrow,
               cap_full, int(table.valid_counts.sum()))
    with timing.region("groupby.combine"):
        (key_out, kval_out, inter_out, _), n_groups = _dispatch(
            combine_call, seg_key, cap_full)
        # the intermediate table: keys + flat intermediate columns
        cols = {}
        for n, c, d, v in zip(by, by_cols, key_out, kval_out):
            cols[n] = Column(d, c.type, v, c.dictionary)
        inames_by_op = []
        for i, op in enumerate(ops_t):
            inames = []
            for iname, arr in zip(INTER_NAMES[op], inter_out[i]):
                cn = f"__i{i}_{iname}"
                cols[cn] = Column(arr, from_numpy_dtype(np_dtype_of(arr)))
                inames.append(cn)
            inames_by_op.append(inames)
        inter_table = _shrink(Table(cols, env, n_groups), n_groups)
        del cols, key_out, kval_out, inter_out
    with timing.region("groupby.shuffle"):
        shuffled = shuffle_table(inter_table, by)
        del inter_table
    with timing.region("groupby.final"):
        s_by_datas, s_by_valids = col_arrays([shuffled.column(n)
                                              for n in by])
        inter_by_op = tuple(tuple(shuffled.column(cn).data for cn in inames)
                            for inames in inames_by_op)
        fin_cap = max(shuffled.capacity, 1)
        (key2, kval2, res_d, res_v, ng2) = _per_shard(
            lambda n_live, *a: _final_fn(ops_t, fin_cap, ddof, narrow,
                                         n_live, *a),
            shuffled.valid_counts, s_by_datas, s_by_valids, inter_by_op)
        del shuffled, inter_by_op
        ng2 = host_array(ng2).astype(np.int64).reshape(-1)
        out = _result_table(env, by, by_cols, key2, kval2, res_names, res_d,
                            res_v, res_types, res_dicts, ng2)
        out = _shrink(out, ng2)
    out.grouped_by = tuple(by)
    return out
