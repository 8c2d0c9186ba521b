"""Table-level groupby-aggregate (port of the fused-route subset of
``cylon_tpu/relational/groupby.py``), at any world size: every shard
aggregates its own co-located groups.

This slice serves a groupby through the fused join→groupby pushdown
(relational/fused.py).  A groupby the pushdown declines — a plain table,
a materialized join, a non-pushdown op — raises ``NotImplementedError``:
the sort-based groupby is slice 5 of ROADMAP.md Queue 1.
"""

from __future__ import annotations

import numpy as np

from .. import config
from ..core.column import Column
from ..core.dtypes import (LogicalType, from_numpy_dtype, np_dtype_of,
                           physical_np_dtype, torch_dtype)
from ..core.table import Table
from ..ops import groupby as gbk
from ..status import InvalidError

_VALID_OPS = gbk.ASSOCIATIVE | gbk.NON_ASSOCIATIVE

#: optimistic first-dispatch segment space for large-capacity groupbys with
#: no hysteresis prediction yet; a mispredict is detected through the
#: returned group count and redispatched at the true bucket
_FIRST_SEG_CAP = 512


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
    table.  ``disjoint``: the partials' key sets are pairwise disjoint (a
    sink keyed on the range-partitioned join keys), so the partials ARE
    the final groups and pass through renamed; derived ops (mean/var/std)
    finalize from the summed (count, sum[, sumsq]) intermediates with
    :func:`cylon_tpu_torch.ops.groupby.finalize`, as the reference does.
    The non-disjoint combine needs the sort-based groupby (slice 5)."""
    if not disjoint:
        raise NotImplementedError(
            "combining overlapping GroupBySink partials needs the "
            "sort-based groupby, slice 5 of ROADMAP.md Queue 1")

    def part(col, i):
        return partial.column(f"{col}_{i}")

    cols = {n: partial.column(n) for n in by}
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
    out = Table(cols, partial.env, np.asarray(partial.valid_counts,
                                              np.int64))
    out.grouped_by = None  # combine order is piece-partial order
    return out


def groupby_aggregate(table: Table, by, aggs, ddof: int = 1) -> Table:
    """Group ``table`` by key columns ``by`` and aggregate.

    aggs: list of (value_col, op[, q]).  Returns key columns + one column
    per agg named ``{col}_{op}``.  This slice answers through the fused
    join→groupby pushdown only."""
    by = [by] if isinstance(by, str) else list(by)
    specs = _normalize_aggs(aggs)
    from .fused import try_join_groupby_pushdown
    pushed = try_join_groupby_pushdown(table, by, specs, ddof)
    if pushed is not None:
        return pushed
    raise NotImplementedError(
        "cylon_tpu_torch serves groupby_aggregate only through the fused "
        "join->groupby pushdown (an unmaterialized inner join grouped by "
        "its keys with sum/count/mean/var/std/sumsq); the sort-based "
        "groupby is slice 5 of ROADMAP.md Queue 1")
