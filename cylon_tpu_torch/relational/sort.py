"""Local sort of a table (port of ``local_sort_table`` of
``cylon_tpu/relational/sort.py``).

Only :func:`local_sort_table` is ported: the pipelined join sorts its
build side by key and its probe side by range id with it, each shard on
its own (no exchange).  The
distributed sample sort and the hashed-string lexical sort are slice 8 of
ROADMAP.md Queue 1.
"""

from __future__ import annotations

import numpy as np

from ..core.column import Column
from ..core.table import Table
from ..ops import pack
from ..ops.sort import sort_permutation, take_data
from ..parallel.shards import map_shards, shard
from ..status import InvalidError
from .common import PAD_L, live_mask, narrow32_flags


def _norm_dirs(by, ascending):
    if isinstance(ascending, bool):
        return tuple(not ascending for _ in by)
    if len(ascending) != len(by):
        raise InvalidError("ascending must match by length")
    return tuple(not a for a in ascending)


def local_sort_table(table: Table, by, ascending=True,
                     nulls_position: str = "last") -> Table:
    """Stable sort of each shard's rows by ``by``, no exchange.  Padding
    rows sort last (the liveness operand), so the live rows stay each
    shard's prefix.  Column bounds survive: the sort permutes each
    shard's full padded row set, so each column's value multiset is
    unchanged.  Like the reference, ``grouped_by`` is left for the caller
    to set."""
    by = [by] if isinstance(by, str) else list(by)
    descendings = _norm_dirs(by, ascending)
    npos = pack.NULL_FIRST if nulls_position == "first" else pack.NULL_LAST
    by_cols = [table.column(n) for n in by]
    narrow = narrow32_flags(by_cols)
    vc = np.asarray(table.valid_counts, np.int64)
    w, cap, dev = table.env.world_size, table.capacity, table.env.device
    items = list(table.columns.items())

    def one(r):
        mask = live_mask(vc[r:r + 1], cap, dev)
        ko = pack.key_operands([shard(c.data, w, r) for c in by_cols],
                               [shard(c.validity, w, r) for c in by_cols],
                               row_mask=mask, descendings=list(descendings),
                               nulls_position=npos, pad_key=PAD_L,
                               narrow32=narrow)
        del mask
        perm = sort_permutation(ko)
        del ko
        return [(take_data(shard(c.data, w, r), perm),
                 None if c.validity is None
                 else take_data(shard(c.validity, w, r), perm))
                for _, c in items]

    sorted_cols = map_shards(one, w)
    cols = {n: Column(d, c.type, v, c.dictionary, bounds=c.bounds)
            for (n, c), (d, v) in zip(items, sorted_cols)}
    return Table(cols, table.env, table.valid_counts)
