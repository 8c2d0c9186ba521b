"""Set-semantic kernels: unique, union, intersect, subtract (port of
``cylon_tpu/ops/setops.py``).

Rows of one table, or of both tables of a set operation, are dense-ranked
together (ops/pack.py), so a group id is a row value; membership and
first occurrence then become segment reductions over int32 row indices:
``scatter_reduce_`` with ``amin``/``amax`` (``include_self=False``) into
an ``(n + 1,)`` buffer, masked rows routed to group ``n``, as the
reference's ``segment_min``/``segment_max`` do.  The outputs are per-row
flags; compaction is the caller's (``ops/sort.compact_by_flag``).
"""

from __future__ import annotations

import torch


def _segment(vals: torch.Tensor, g: torch.Tensor, reduce: str) -> torch.Tensor:
    """Per-group ``amin``/``amax`` of int32 ``vals`` over ``n + 1`` groups
    (``n = len(vals)``); a group with no row keeps 0, which no caller
    reads (every row reads its own, non-empty group)."""
    out = torch.zeros(vals.shape[0] + 1, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, g.long(), vals, reduce, include_self=False)


def unique_flags(gids: torch.Tensor, mask=None, keep: str = "first"):
    """Flag the kept occurrence of each distinct row: the first (or, with
    ``keep="last"``, the last) row of each group.  ``gids``: the dense
    rank of every row; masked rows are never flagged."""
    n = gids.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=gids.device)
    g = gids if mask is None else torch.where(mask, gids, n)
    rep = _segment(idx, g, "amax" if keep == "last" else "amin")
    flag = rep[g.long()] == idx
    return flag if mask is None else flag & mask


def set_op_flags(gids_cat: torch.Tensor, side_is_b: torch.Tensor, op: str,
                 mask=None):
    """Flags over the concatenated rows of A then B selecting the output
    rows of a set operation with distinct semantics:

    * union: the first occurrence of each group (A's rows come first in
      the concatenation, so an A row wins);
    * intersect: the first A row of each group that B also holds;
    * subtract: the first A row of each group that B does not hold."""
    n = gids_cat.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=gids_cat.device)
    g = gids_cat if mask is None else torch.where(mask, gids_cat, n)
    if op == "union":
        first_any = _segment(idx, g, "amin")
        flag = first_any[g.long()] == idx
        return flag if mask is None else flag & mask
    a_row = ~side_is_b if mask is None else ~side_is_b & mask
    b_row = side_is_b if mask is None else side_is_b & mask
    in_b = _segment(b_row.to(torch.int32), g, "amax")[g.long()] > 0
    # the first A row of each group (n when the group has no A row)
    first_a = _segment(torch.where(a_row, idx, n), g, "amin")[g.long()]
    if op == "intersect":
        flag = (first_a == idx) & in_b
    elif op == "subtract":
        flag = (first_a == idx) & ~in_b
    else:
        raise ValueError(f"unknown set op {op}")
    return flag & a_row
