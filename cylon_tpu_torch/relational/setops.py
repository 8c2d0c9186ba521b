"""Table-level set operations, unique and equals (port of
``cylon_tpu/relational/setops.py``).

Rows are dense-ranked per shard (ops/pack.py) — one table's for
:func:`unique_table`, both tables' together for :func:`set_operation` —
so a group id is a row value, and membership and first occurrence become
segment reductions (ops/setops.py).  The flagged rows compact in row
order at one ``pow2ceil`` capacity over the shards, whose counts come
back in one pull.  At W > 1 the tables first hash-shuffle on the compared
columns, so equal rows share a shard; the exchange's (source rank, source
position) receive order makes keep="first"/"last" pick the globally
first or last occurrence.  In a multi-process world each process flags
and compacts its own ranks' blocks; the per-rank counts are gathered
whole, and ``equals`` agrees its answer with one all-reduce.

Timing regions (utils/timing.py): ``unique.flags`` / ``setop.flags``
(the dense rank, the flags and the count pull), ``unique.materialize`` /
``setop.materialize`` (the compaction), inside the shuffle's own
``shuffle.hash`` and ``shuffle.exchange``.

A device OOM in :func:`set_operation` retries through the chunked
``exec.pipelined_set_op`` at 4 and then 16 chunks, under the retry
ladder (``relational/common.run_with_oom_fallback``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.dtypes import LogicalType
from ..core.table import Table
from ..ops import pack
from ..ops import setops as setk
from ..ops.pack import SIGNED_VIEW
from ..ops.sort import compact_by_flag, take_data
from ..parallel import transport
from ..parallel.shards import local_world, map_shards, shard
from ..status import CylonTypeError, InvalidError
from ..utils import timing
from ..utils.host import host_array
from .common import (PAD_L, check_same_env, col_arrays, live_mask,
                     narrow32_flags, promote_key_pair, rebuild_like)
from .repart import compact_rows, repad_table, repartition, shuffle_table


def _shard_counts(flags: torch.Tensor, w: int) -> np.ndarray:
    """Each rank's flagged rows, the (W,) host vector (every process's
    local ranks gathered in a multi-process world)."""
    return host_array(flags.view(local_world(w), -1).sum(dim=1),
                      world=w).astype(np.int64)


# ---------------------------------------------------------------------------
# unique (drop_duplicates)
# ---------------------------------------------------------------------------

def unique_table(table: Table, subset=None, keep: str = "first") -> Table:
    """Drop duplicate rows, compared on the ``subset`` columns (default
    all), keeping each value's first or last occurrence in global row
    order."""
    subset = list(subset) if subset is not None else table.column_names
    if keep not in ("first", "last"):
        raise InvalidError("keep must be 'first' or 'last'")
    for n in subset:
        if table.column(n).type == LogicalType.LIST:
            raise InvalidError(
                f"unique on list passthrough column {n!r} is not supported "
                "(codes are row ids, not value-equal)")
    from ..obs import plan as _plan
    with _plan.node("unique", subset=tuple(subset), keep=keep) as pn:
        if pn:
            pn.set(rows_in=table.row_count)
        res = _unique_impl(table, subset, keep)
        if pn:
            pn.set(rows_out=res.row_count)
        return res


def _unique_impl(table: Table, subset: list, keep: str) -> Table:
    env = table.env
    if env.world_size > 1:
        table = shuffle_table(table, subset)
    w, cap = env.world_size, table.capacity
    key_cols = [table.column(n) for n in subset]
    key_datas, key_valids = col_arrays(key_cols)
    narrow = narrow32_flags(key_cols)
    vc = np.asarray(table.valid_counts, np.int64)

    def flags(r):
        mask = live_mask(vc[r:r + 1], cap, env.device)
        ko = pack.key_operands([shard(d, w, r) for d in key_datas],
                               [shard(v, w, r) for v in key_valids],
                               row_mask=mask, pad_key=PAD_L, narrow32=narrow)
        gids, _ = pack.dense_rank(ko)
        del ko
        return setk.unique_flags(gids, mask, keep)

    with timing.region("unique.flags"):
        keep_rows = map_shards(flags, w, cap=cap)
        counts = _shard_counts(keep_rows, w)
    with timing.region("unique.materialize"):
        return compact_rows(table, keep_rows, counts)


# ---------------------------------------------------------------------------
# union / intersect / subtract (distinct semantics, like the reference)
# ---------------------------------------------------------------------------

def _align_schemas(a: Table, b: Table):
    """The same column names in the same order, each pair promoted to one
    comparable type (string dictionaries unified)."""
    if a.column_names != b.column_names:
        raise InvalidError(
            f"set op schema mismatch: {a.column_names} vs {b.column_names}")
    cols_a, cols_b = {}, {}
    for n in a.column_names:
        cols_a[n], cols_b[n] = promote_key_pair(a.column(n), b.column(n))
    return (Table(cols_a, a.env, a.valid_counts),
            Table(cols_b, b.env, b.valid_counts))


def set_operation(a: Table, b: Table, op: str,
                  assume_colocated: bool = False) -> Table:
    """union / intersect / subtract of two tables' rows with distinct-row
    semantics.  At W > 1 both tables shuffle on the full row first;
    ``assume_colocated=True`` skips the shuffle and the schema alignment
    (the pipelined set op aligns and shuffles the resident side once).
    A device OOM streams ``a`` through ``pipelined_set_op``."""
    from .common import run_with_oom_fallback
    for t in (a, b):
        for n in t.column_names:
            if t.column(n).type == LogicalType.LIST:
                raise InvalidError(
                    f"set op on a table with list passthrough column {n!r} "
                    "is not supported (rows are compared by value)")

    def fb(nc):
        from ..exec.pipeline import pipelined_set_op
        return pipelined_set_op(a, b, op, n_chunks=nc)

    from ..obs import plan as _plan
    with _plan.node("set_op", kind=op,
                    colocated=bool(assume_colocated)) as pn:
        if pn:
            pn.set(rows_in=a.row_count + b.row_count)
        res = run_with_oom_fallback(
            lambda: _set_operation_impl(a, b, op, assume_colocated),
            can_fallback=not assume_colocated, fallback=fb, label="set_op",
            env=a.env)
        if pn and type(res) is Table:
            pn.set(rows_out=res.row_count)
        return res


def _set_operation_impl(a: Table, b: Table, op: str,
                        assume_colocated: bool = False) -> Table:
    if op not in ("union", "intersect", "subtract"):
        raise InvalidError(f"unknown set op {op!r}")
    env = check_same_env(a, b)
    if not assume_colocated:
        a, b = _align_schemas(a, b)
    names = a.column_names
    if env.world_size > 1 and not assume_colocated:
        a = shuffle_table(a, names)
        b = shuffle_table(b, names)
    w, dev = env.world_size, env.device
    cap_a, cap_b = a.capacity, b.capacity
    a_cols = [a.column(n) for n in names]
    b_cols = [b.column(n) for n in names]
    a_datas, a_valids = col_arrays(a_cols)
    b_datas, b_valids = col_arrays(b_cols)
    vca = np.asarray(a.valid_counts, np.int64)
    vcb = np.asarray(b.valid_counts, np.int64)
    # the two tables' operand structures must match: a null-flag operand
    # for a column when EITHER side is nullable, one narrowing for both
    need_nf = tuple((av is not None) or (bv is not None)
                    for av, bv in zip(a_valids, b_valids))
    narrow = narrow32_flags(a_cols, b_cols)

    def flags(r):
        mask_a = live_mask(vca[r:r + 1], cap_a, dev)
        mask_b = live_mask(vcb[r:r + 1], cap_b, dev)
        ko_a = pack.key_operands([shard(d, w, r) for d in a_datas],
                                 [shard(v, w, r) for v in a_valids],
                                 row_mask=mask_a, pad_key=PAD_L,
                                 need_null_flags=need_nf, narrow32=narrow)
        ko_b = pack.key_operands([shard(d, w, r) for d in b_datas],
                                 [shard(v, w, r) for v in b_valids],
                                 row_mask=mask_b, pad_key=PAD_L,
                                 need_null_flags=need_nf, narrow32=narrow)
        gids, _ = pack.dense_rank(pack.concat_keyops(ko_a, ko_b))
        del ko_a, ko_b
        side_is_b = torch.cat([torch.zeros(cap_a, dtype=torch.bool,
                                           device=dev),
                               torch.ones(cap_b, dtype=torch.bool,
                                          device=dev)])
        return setk.set_op_flags(gids, side_is_b, op,
                                 torch.cat([mask_a, mask_b]))

    with timing.region("setop.flags"):
        out_rows = map_shards(flags, w, cap=cap_a + cap_b)
        counts = _shard_counts(out_rows, w)
    out_cap = config.pow2ceil(int(counts.max()) if counts.size else 1)
    n_cat = cap_a + cap_b

    def materialize(r):
        idx, _ = compact_by_flag(shard(out_rows, w, r), out_cap)
        # padding slots read row 0 of the concatenation, as the
        # reference's clipped gather does
        safe = idx.clamp(0, max(n_cat - 1, 0)).long()
        out_d, out_v = [], []
        for da, va, db, vb in zip(a_datas, a_valids, b_datas, b_valids):
            out_d.append(take_data(torch.cat([shard(da, w, r),
                                              shard(db, w, r)]), safe))
            if va is None and vb is None:
                out_v.append(None)
            else:
                va_ = shard(va, w, r) if va is not None \
                    else torch.ones(cap_a, dtype=torch.bool, device=dev)
                vb_ = shard(vb, w, r) if vb is not None \
                    else torch.ones(cap_b, dtype=torch.bool, device=dev)
                out_v.append(torch.cat([va_, vb_])[safe])
        return out_d, out_v

    with timing.region("setop.materialize"):
        out_d, out_v = map_shards(materialize, w, cap=out_cap)
    return rebuild_like([(n, a.column(n)) for n in names], out_d, out_v,
                        counts, env)


# ---------------------------------------------------------------------------
# equals
# ---------------------------------------------------------------------------

def equals(a: Table, b: Table, ordered: bool = True) -> bool:
    """Table equality: the same column names, row count and rows, in
    global order (``ordered=False``: as multisets, both sorted on every
    column first).  ``b`` is repartitioned to ``a``'s row counts and
    both repadded to one capacity before the row compare.  Null equals
    null, NaN equals NaN, -0.0 equals 0.0."""
    check_same_env(a, b)
    if a.column_names != b.column_names:
        return False
    if a.row_count != b.row_count:
        return False
    if a.row_count == 0:
        return True
    try:
        a, b = _align_schemas(a, b)
    except CylonTypeError:
        # no common type: the schemas cannot be compared
        return False
    names = a.column_names
    if not ordered:
        from .sort import sort_table
        a = sort_table(a, names)
        b = sort_table(b, names)
    if not np.array_equal(a.valid_counts, b.valid_counts):
        b = repartition(b, tuple(int(x) for x in a.valid_counts))
    if a.capacity != b.capacity:
        common = max(a.capacity, b.capacity)
        a = repad_table(a, common)
        b = repad_table(b, common)
    w = a.env.world_size
    bad = torch.zeros(a.capacity * local_world(w), dtype=torch.bool,
                      device=a.env.device)
    for n in names:
        ca, cb = a.column(n), b.column(n)
        da, db = ca.data, cb.data
        kind = "f" if da.dtype.is_floating_point else "i"
        if da.dtype in SIGNED_VIEW:
            # torch's CUDA compares have no uint16/32/64 kernel
            da = da.view(SIGNED_VIEW[da.dtype])
            db = db.view(SIGNED_VIEW[db.dtype])
        differ = ~pack.op_eq(da, db, kind)
        if ca.validity is not None or cb.validity is not None:
            va = ca.validity if ca.validity is not None \
                else torch.ones_like(differ)
            vb = cb.validity if cb.validity is not None \
                else torch.ones_like(differ)
            differ = (va != vb) | (differ & va)
        bad |= differ
    bad &= live_mask(a.valid_counts, a.capacity, a.env.device)
    # every process answers for its own ranks' rows: the max agrees
    return not transport.all_reduce_max(int(bool(bad.any())),
                                        "setops.equals")
