"""Key canonicalization into sort operands (port of ``cylon_tpu/ops/pack.py``).

Every key column becomes one or more **sort operands** whose lexicographic
order is the requested row order, exactly as in the reference:

* int64/uint64 -> (hi, lo) operand pair; one int32 operand when host-known
  bounds fit int32 (``narrow``);
* int8/16/32, bool -> one int32 operand;
* float32 -> one uint32 operand via the IEEE total-order bit flip (after
  NaN/-0.0 canonicalization);
* float64 -> one f64 operand (kind ``'f'``);
* a nullable column adds a null-flag operand in front; a row mask adds a
  leading liveness operand (padding sorts last, with a per-table pad key).

Representation: a signed 32-bit operand is an int32 tensor; an unsigned
32-bit operand (the ``lo`` half, uint32 columns, flipped float32 bits) is
an int64 tensor holding the value in [0, 2^32) — the reference's uint32
values exactly, and sortable on the card, where uint32 is not.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NULL_FIRST = 0
NULL_LAST = 2

_LO32 = 0xFFFFFFFF

#: torch's CUDA ``where``, compares and gathers have no uint16/32/64
#: kernels: those run on a signed view of the same width
SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
               torch.uint64: torch.int64}


def sort_operand_nbytes(dtypes, need_nf, narrow, rows: int,
                        row_mask: bool = True) -> int:
    """Host-side size of the operand set :func:`key_operands` builds for
    ``rows`` rows — the per-piece sort scratch the pipeline's admission
    folds in (exec/memory.py).  Counts the reference's operand widths
    (liveness + per-column null flag + one or two 32-bit value operands;
    an f64 key stays one 8-byte operand), so both packages size pieces
    alike."""
    per_row = 4 if row_mask else 0
    for dt, nf, nw in zip(dtypes, need_nf, narrow):
        if nf:
            per_row += 4
        d = np.dtype(dt)
        if d.kind == "f" and d.itemsize == 8:
            per_row += 8
        elif d.itemsize == 8 and d.kind in ("i", "u") and not nw:
            per_row += 8
        else:
            per_row += 4
    return per_row * int(rows)


class KeyOps(NamedTuple):
    """Lexicographic sort operands + per-operand kind ('i' int-like, 'f'
    float64 — needs NaN-aware equality)."""

    ops: tuple
    kinds: tuple

    @property
    def n(self):
        return self.ops[0].shape[0]


def _canon_float(x: torch.Tensor) -> torch.Tensor:
    """-0.0 -> +0.0 and every NaN -> one positive quiet NaN."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    return torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)


def _sort_value(x: torch.Tensor, descending: bool,
                narrow: bool = False) -> list:
    """One key column -> list of (operand, kind) pairs (module docstring)."""
    dt = x.dtype
    if dt == torch.bool:
        v = x.to(torch.int32)
        return [((-v if descending else v), "i")]
    if not dt.is_floating_point:
        if narrow and dt.itemsize == 8:
            x = x.to(torch.int32)
        unsigned = x.dtype in (torch.uint8, torch.uint16, torch.uint32,
                               torch.uint64)
        # ~x = -x-1: strictly decreasing, total, no overflow.  torch has
        # no bitwise not for uint16/32/64, so an unsigned column's images
        # are complemented below instead, within their width: the
        # reference's ~x on the unsigned type, bit for bit.
        if descending and not unsigned:
            x = ~x
        if x.dtype.itemsize <= 4:
            if x.dtype == torch.uint32:
                ops = [x.view(torch.int32).to(torch.int64) & _LO32]
            else:
                ops = [x.to(torch.int32)]
        else:
            xi = x.view(torch.int64) if x.dtype == torch.uint64 else x
            if x.dtype == torch.uint64:
                hi = (xi >> 32) & _LO32        # unsigned hi: zero-extended
            else:
                hi = (xi >> 32).to(torch.int32)  # signed hi keeps the sign
            ops = [hi, xi & _LO32]
        if descending and unsigned:
            ones = (1 << min(8 * x.dtype.itemsize, 32)) - 1
            ops = [op ^ ones for op in ops]
        return [(op, "i") for op in ops]
    v = -x if descending else x
    v = _canon_float(v)
    if dt == torch.float32:
        u = v.view(torch.int32).to(torch.int64) & _LO32
        flip = torch.where((u >> 31) != 0, _LO32, 0x80000000)
        return [(u ^ flip, "i")]
    return [(v.to(torch.float64), "f")]


def key_operands(datas, validities=None, row_mask=None, descendings=None,
                 nulls_position: int = NULL_LAST, pad_key: int = 4,
                 need_null_flags=None, narrow32=None) -> KeyOps:
    """Lexicographic sort operands for a key tuple (reference semantics):
    per nullable column a null-flag operand (valid 1, null 0 or 2) then
    the packed value operand(s); a leading liveness operand when
    ``row_mask`` is given, padding rows taking ``pad_key``.
    ``need_null_flags`` forces/suppresses the null flags so two tables
    ranked together get the same operand structure."""
    ops, kinds = [], []
    n = datas[0].shape[0]
    dev = datas[0].device
    if row_mask is not None:
        ops.append(torch.where(row_mask, 0, pad_key).to(torch.int32))
        kinds.append("i")
    for i, d in enumerate(datas):
        desc = bool(descendings[i]) if descendings is not None else False
        v = validities[i] if validities is not None else None
        need_nf = (v is not None) if need_null_flags is None \
            else bool(need_null_flags[i])
        if need_nf:
            if v is None:
                nf = torch.ones(n, dtype=torch.int32, device=dev)
            else:
                nf = torch.where(v, 1, nulls_position).to(torch.int32)
                sv = d.view(SIGNED_VIEW.get(d.dtype, d.dtype))
                d = torch.where(v, sv, torch.zeros_like(sv)).view(d.dtype)
            ops.append(nf)
            kinds.append("i")
        nrw = bool(narrow32[i]) if narrow32 is not None else False
        for val, kind in _sort_value(d, desc, narrow=nrw):
            ops.append(val)
            kinds.append(kind)
    return KeyOps(tuple(ops), tuple(kinds))


def concat_keyops(a: KeyOps, b: KeyOps) -> KeyOps:
    assert a.kinds == b.kinds
    return KeyOps(tuple(torch.cat([x, y]) for x, y in zip(a.ops, b.ops)),
                  a.kinds)


def op_neq(a, b, kind: str):
    if kind == "f":
        return (a != b) & ~(torch.isnan(a) & torch.isnan(b))
    return a != b


def op_gt(a, b, kind: str):
    if kind == "f":
        return (a > b) | (torch.isnan(a) & ~torch.isnan(b))
    return a > b


def op_eq(a, b, kind: str):
    if kind == "f":
        return (a == b) | (torch.isnan(a) & torch.isnan(b))
    return a == b


def neighbor_flags(sorted_ops, kinds) -> torch.Tensor:
    """int32 flags: row i != row i-1 under the key tuple (row 0 -> 0)."""
    n = sorted_ops[0].shape[0]
    neq = torch.zeros(n, dtype=torch.int32, device=sorted_ops[0].device)
    for op, kind in zip(sorted_ops, kinds):
        neq[1:] |= op_neq(op[1:], op[:-1], kind).to(torch.int32)
    return neq


def dense_rank(keyops: KeyOps):
    """Rank rows by their key tuple: ``(gids, n_groups)`` with ``gids[i]``
    the 0-based dense rank of row i's key (ids ordered like the keys) and
    ``n_groups`` a 0-dim int32 device tensor.  One stable lexicographic
    sort (:func:`lex_sort_perm`), boundary flags over the sorted words,
    a prefix sum and one scatter back to source order."""
    n = keyops.n
    dev = keyops.ops[0].device
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    words = sort_words(keyops)
    perm = lex_sort_perm(words)
    flags = neighbor_flags([w[perm] for w, _ in words],
                           [k for _, k in words])
    gid_sorted = torch.cumsum(flags, 0, dtype=torch.int32)
    del flags
    gids = torch.empty(n, dtype=torch.int32, device=dev)
    gids[perm] = gid_sorted
    return gids, gid_sorted[-1] + 1


def row_neq_prev(datas, validities=None, narrow32=None) -> torch.Tensor:
    """(n,) bool: row i's key tuple differs from row i-1's (row 0 ->
    False).  Null-aware (null == null, null != value) and float-total
    (NaN == NaN, -0.0 == 0.0): the dense rank's equality, computed on
    adjacent rows of an already-grouped table (no sort).  ``narrow32[i]``
    compares a 64-bit integer column as int32."""
    n = datas[0].shape[0]
    dev = datas[0].device
    neq = torch.zeros(max(n - 1, 0), dtype=torch.bool, device=dev)
    for i, d in enumerate(datas):
        if d.dtype.is_floating_point:
            d = _canon_float(d)
            kind = "f"
        else:
            if narrow32 is not None and bool(narrow32[i]) \
                    and d.dtype.itemsize == 8:
                d = d.to(torch.int32)
            kind = "i"
        dn = op_neq(d[1:], d[:-1], kind)
        v = validities[i] if validities is not None else None
        if v is not None:
            dn = (v[1:] != v[:-1]) | (dn & v[1:] & v[:-1])
        neq = neq | dn
    return torch.cat([torch.zeros(min(n, 1), dtype=torch.bool, device=dev),
                      neq])


def grouped_gids(datas, validities, mask, narrow32=None):
    """Dense group ids of an already-grouped shard (equal keys
    contiguous): boundary flags and a prefix sum, no sort.  Returns
    ``(gids, n_groups, first)``; padding rows get id ``n`` (the caller
    routes them), ``first`` marks each group's first live row and
    ``n_groups`` is a 0-dim int32 device tensor."""
    n = datas[0].shape[0]
    bnd = row_neq_prev(datas, validities, narrow32)
    bnd[:1] = True
    bnd &= mask
    gid = torch.cumsum(bnd, 0, dtype=torch.int32) - 1
    return torch.where(mask, gid, n), count_groups(gid, mask), bnd


def count_groups(gid, mask) -> torch.Tensor:
    """0-dim int32 device tensor: one more than the largest live group id
    (0 when no row is live)."""
    if not gid.numel():
        return torch.zeros((), dtype=torch.int32, device=gid.device)
    return (torch.where(mask, gid, -1).max() + 1).to(torch.int32)


def rows_cmp_splitters(keyops: KeyOps, splitter_ops: tuple):
    """(gt, eq) (n, S) bool pairs: row i's key tuple strictly greater than
    / equal to splitter j's under the operand order.  The skew split
    (relational/skew.py) names its heavy keys and ranks rows against
    them with it, so membership and order agree bit for bit with the
    join sort's own key order (float canonicalization, null flags and
    narrow lanes included)."""
    n = keyops.n
    s = splitter_ops[0].shape[0]
    dev = keyops.ops[0].device
    gt = torch.zeros((n, s), dtype=torch.bool, device=dev)
    eq = torch.ones((n, s), dtype=torch.bool, device=dev)
    for op, sop, kind in zip(keyops.ops, splitter_ops, keyops.kinds):
        a = op[:, None]
        b = sop[None, :]
        gt = gt | (eq & op_gt(a, b, kind))
        eq = eq & op_eq(a, b, kind)
    return gt, eq


def rows_gt_splitters(keyops: KeyOps, splitter_ops: tuple) -> torch.Tensor:
    """(n, S) bool: row i's key tuple strictly greater than splitter j's
    (the sample sort's range assignment: a row's destination is the
    number of splitters strictly below it)."""
    gt, _ = rows_cmp_splitters(keyops, splitter_ops)
    return gt


def rows_ge_splitters(keyops: KeyOps, splitter_ops: tuple) -> torch.Tensor:
    """(n, S) bool: row i's key tuple >= splitter j's.  The range-
    partitioned pipeline's splitters are key-GROUP STARTS of the sorted
    build side, so a probe key equal to splitter j belongs to the range j
    opens.  Unsigned operands (int64 holding [0, 2^32)) compare as their
    values, which is the reference's uint32 order."""
    gt, eq = rows_cmp_splitters(keyops, splitter_ops)
    return gt | eq


def sort_words(keyops: KeyOps) -> tuple:
    """Fold the operands into the fewest sort keys with the same
    lexicographic order: two adjacent 32-bit operands pack into one int64
    word (hi = first operand, lo = second), an f64 operand stays its own
    key.  Returns ((key, kind), ...), first key most significant.

    Each 32-bit operand maps to an order-preserving unsigned value ``o``
    (int32: v + 2^31; unsigned: v); a pair packs as ((o0 - 2^31) << 32) |
    o1, whose signed int64 order is the pair's lexicographic order, and
    whose equality is the pair's equality."""
    def ordered(op):
        return op.to(torch.int64) + (1 << 31) if op.dtype == torch.int32 \
            else op

    words, pend = [], None
    for op, kind in zip(keyops.ops, keyops.kinds):
        if kind == "f":
            if pend is not None:
                words.append((ordered(pend), "i"))
                pend = None
            words.append((op, "f"))
        elif pend is None:
            pend = op
        else:
            words.append((((ordered(pend) - (1 << 31)) << 32)
                          | ordered(op), "i"))
            pend = None
    if pend is not None:
        words.append((ordered(pend), "i"))
    return tuple(words)


def lex_sort_perm(words) -> torch.Tensor:
    """Stable lexicographic sort permutation (int64) over ``sort_words``
    output: LSD composition — a stable sort on the least significant key,
    then on each more significant key gathered through the running
    permutation.  Ties keep their input order, as the reference's
    ``lax.sort(..., is_stable=True)`` does."""
    perm = None
    for key, _kind in reversed(words):
        k = key if perm is None else key[perm]
        _, p = torch.sort(k, stable=True)
        del k
        perm = p if perm is None else perm[p]
    return perm
