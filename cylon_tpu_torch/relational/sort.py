"""Local sort of a table (port of the world-1 part of
``cylon_tpu/relational/sort.py``).

Only :func:`local_sort_table` is ported: the pipelined join sorts its
build side by key and its probe side by range id with it.  The
distributed sample sort and the hashed-string lexical sort are slice 8 of
ROADMAP.md Queue 1.
"""

from __future__ import annotations

import numpy as np

from ..core.column import Column
from ..core.table import Table
from ..ops import pack
from ..ops.sort import sort_permutation, take_data
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
    """Stable sort of the table's rows by ``by`` (no exchange: world 1).
    Padding rows sort last (the liveness operand), so the live rows stay
    the prefix.  Column bounds survive: the sort permutes the full padded
    row set, so each column's value multiset is unchanged.  Like the
    reference, ``grouped_by`` is left for the caller to set."""
    by = [by] if isinstance(by, str) else list(by)
    descendings = _norm_dirs(by, ascending)
    npos = pack.NULL_FIRST if nulls_position == "first" else pack.NULL_LAST
    by_cols = [table.column(n) for n in by]
    vc = np.asarray(table.valid_counts, np.int64)
    dev = table.env.device
    mask = live_mask(vc, table.capacity, dev)
    ko = pack.key_operands([c.data for c in by_cols],
                           [c.validity for c in by_cols], row_mask=mask,
                           descendings=list(descendings),
                           nulls_position=npos, pad_key=PAD_L,
                           narrow32=narrow32_flags(by_cols))
    del mask
    perm = sort_permutation(ko)
    del ko
    cols = {}
    for n, c in table.columns.items():
        v = None if c.validity is None else take_data(c.validity, perm)
        cols[n] = Column(take_data(c.data, perm), c.type, v, c.dictionary,
                         bounds=c.bounds)
    return Table(cols, table.env, table.valid_counts)
