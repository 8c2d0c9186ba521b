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

import torch

NULL_FIRST = 0
NULL_LAST = 2

_LO32 = 0xFFFFFFFF


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
        # ~x = -x-1: strictly decreasing, total, no overflow
        if descending:
            x = ~x
        if x.dtype.itemsize <= 4:
            if x.dtype == torch.uint32:
                return [(x.view(torch.int32).to(torch.int64) & _LO32, "i")]
            return [(x.to(torch.int32), "i")]
        xi = x.view(torch.int64) if x.dtype == torch.uint64 else x
        if x.dtype == torch.uint64:
            hi = (xi >> 32) & _LO32            # unsigned hi: zero-extended
        else:
            hi = (xi >> 32).to(torch.int32)    # signed hi keeps the sign
        return [(hi, "i"), (xi & _LO32, "i")]
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
                d = torch.where(v, d, torch.zeros_like(d))
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


def neighbor_flags(sorted_ops, kinds) -> torch.Tensor:
    """int32 flags: row i != row i-1 under the key tuple (row 0 -> 0)."""
    n = sorted_ops[0].shape[0]
    neq = torch.zeros(n, dtype=torch.int32, device=sorted_ops[0].device)
    for op, kind in zip(sorted_ops, kinds):
        neq[1:] |= op_neq(op[1:], op[:-1], kind).to(torch.int32)
    return neq


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
