"""Table-level sort: the local multi-key sort and the distributed sample
sort (port of ``cylon_tpu/relational/sort.py``).

:func:`sort_table` at world size W > 1 is the reference's sample sort:
sample each shard's key operands at evenly spaced positions (after a
local sort first with ``method="regular"``), pick W - 1 splitters on the
host from the W·m samples (one batched pull), send each row to the number
of splitters strictly below it, exchange the rows in (source rank, source
position) order (relational/repart.exchange_by_targets) and sort each
shard locally.  At world size 1 it is one local sort.  The output is
globally sorted, so ``grouped_by = by``.

:func:`local_sort_table` sorts each shard on its own (the pipelined join
sorts its build side by key and its probe side by range id with it).

A hashed (high-cardinality) string key has codes that do not order like
its strings: :func:`sort_table` first rewrites it into value-stable
prefix lanes (:func:`_expand_hashed_string_keys`), sorts on those and
drops them.  A sorted-dictionary key sorts on its codes directly.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.column import Column, HashedStrings
from ..core.dtypes import LogicalType
from ..core.table import Table
from ..ops import pack
from ..ops.sort import sort_permutation, take_data
from ..parallel import shuffle
from ..parallel.shards import map_shards, shard, span
from ..status import InvalidError
from ..utils import timing
from ..utils.host import host_array, host_arrays
from .common import (PAD_L, col_arrays, live_mask, narrow32_flags,
                     sample_positions)
from .repart import exchange_by_targets


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


def _sample_fn(vc, w: int, cap: int, m: int, by_datas, by_valids,
               descendings, npos, narrow):
    """Every shard's key operands (no liveness operand) at ``m`` evenly
    spaced positions of its live prefix, pulled in one batch: ``(W·m,)``
    host arrays per operand, and the ``(W·m,)`` liveness of the samples
    (a shard with no live row contributes none).  In a multi-process
    world each process samples its own shards and the pull gathers the
    others' samples, so every process picks the same splitters."""
    ranks = span(w)
    pos = np.concatenate([sample_positions(int(vc[r]), m, cap)
                          + (r - ranks.start) * cap
                          for r in ranks]).astype(np.int64)
    idx = torch.from_numpy(pos).to(by_datas[0].device)
    datas = [take_data(d, idx) for d in by_datas]
    valids = [None if v is None else v[idx] for v in by_valids]
    ko = pack.key_operands(datas, valids, descendings=list(descendings),
                           nulls_position=npos, narrow32=narrow)
    live = np.repeat(np.asarray(vc) > 0, m)
    return host_arrays(list(ko.ops), world=w), live


def _pick_splitters(sample_ops, live, w: int):
    """Host-side splitter selection: sort the W·m sampled operand rows
    (live first), take W - 1 evenly spaced rows of the live prefix.  Any
    choice of sample rows gives a correct partition (rows meet the
    splitters on the device under the same total order); the choice only
    affects balance, so numpy's NaN-last lexsort serves."""
    n_live = int(live.sum())
    cols = [~live] + list(sample_ops)
    order = np.lexsort(tuple(reversed(cols)))
    take = [order[min(max((n_live * j) // w, 0), max(n_live - 1, 0))]
            for j in range(1, w)]
    take = np.asarray(take, np.int64)
    return tuple(o[take] for o in sample_ops)


def _target_fn(vc, cap: int, by_datas, by_valids, splitters, descendings,
               npos, narrow) -> torch.Tensor:
    """Per-row destination rank (int32) = the number of splitters strictly
    below the row; padding rows get W.  Elementwise, so one pass serves
    every shard."""
    w = len(vc)
    dev = by_datas[0].device
    ko = pack.key_operands(list(by_datas), list(by_valids),
                           descendings=list(descendings),
                           nulls_position=npos, narrow32=narrow)
    sops = tuple(torch.from_numpy(np.ascontiguousarray(s)).to(dev)
                 for s in splitters)
    tgt = pack.rows_gt_splitters(ko, sops).sum(dim=1, dtype=torch.int32)
    del ko
    return torch.where(live_mask(vc, cap, dev), tgt,
                       torch.full((), w, dtype=torch.int32, device=dev))


#: most u32 order lanes per hashed string key (64 prefix bytes); beyond
#: them the key sorts on the dense rank of its distinct values instead
MAX_ORDER_LANES = 16


def _value_lanes(vs: np.ndarray, device) -> np.ndarray:
    """``(len(vs), L)`` uint32 order lanes of distinct string values, in
    ``vs``'s order: the first ceil(D / 4) big-endian byte lanes and the
    byte length, or past :data:`MAX_ORDER_LANES` lanes one lane of the
    dense rank.  D is fixed by the values in bytewise order — the order
    the reference takes from pyarrow's ``sort_indices``.  Values of at
    most 64 bytes find that order on ``device``: all their bytes as
    lanes and then the length sort lexicographically as bytewise order
    does (the length tells 'ab' from 'ab\\0').  Longer values sort on
    the host as Python ``str``, whose code point order is UTF-8 byte
    order."""
    from .. import native
    bufs = native.utf8_buffers(vs)
    lens = np.diff(bufs[1]).astype(np.uint32)[:, None]
    full = max(-(-int(lens.max(initial=0)) // 4), 1)
    every = None
    if full <= MAX_ORDER_LANES:
        every = native.prefix_lanes(None, full, buffers=bufs)
        keys = (np.concatenate([every, lens], axis=1)
                ^ np.uint32(0x80000000)).view(np.int32)
        mat = torch.from_numpy(np.ascontiguousarray(keys.T)).to(device)
        order = host_array(pack.lex_sort_perm(pack.sort_words(
            pack.KeyOps(tuple(mat), ("i",) * len(mat)))))
        del mat
    else:
        listed = vs.tolist()  # tracecheck: off[TS101] — vs is numpy
        order = np.asarray(sorted(range(len(listed)),
                                  key=listed.__getitem__), np.int64)
        del listed
    depth = native.max_adjacent_lcp(None, buffers=bufs, order=order) + 1
    n_lanes = -(-depth // 4)
    if n_lanes > MAX_ORDER_LANES:
        ranks = np.empty((len(vs), 1), np.uint32)
        ranks[order, 0] = np.arange(len(vs), dtype=np.uint32)
        return ranks
    head = every[:, :n_lanes] if every is not None \
        else native.prefix_lanes(None, n_lanes, buffers=bufs)
    return np.concatenate([head, lens], axis=1)


def _expand_hashed_string_keys(table: Table, by: list, ascending):
    """Rewrite hashed-string sort keys into value-stable big-endian byte
    lanes, so the numeric sort gives lexical order.

    Per hashed key: its store's distinct values in bytewise order fix the
    depth D (one more than the longest common prefix of two adjacent
    distinct values) at which every distinct value differs; each row's
    first D bytes become ceil(D / 4) int32 lane columns (u32 big-endian,
    sign-flipped), then one length lane, since zero fill cannot tell a
    real trailing NUL from the end ('ab' and 'ab\\0').  Equal lane tuples
    mean equal values, so the output is grouped by the original keys.
    Past :data:`MAX_ORDER_LANES` lanes the key becomes one lane of the
    dense rank of its distinct values.

    A multi-process world refuses this sort with ``InvalidError``, as
    the reference does under several controllers
    (``cylon_tpu/relational/sort.py:224``): per-process value stores
    cannot bound the common prefix across processes.

    Returns ``(table2, by2, ascending2, original_by)``, or None when no
    key is hashed."""
    from .. import native
    by_cols = [table.column(n) for n in by]
    if not any(isinstance(c.dictionary, HashedStrings) for c in by_cols):
        return None
    env = table.env
    if env.multi_process:
        raise InvalidError(
            "sort on a hashed string key across several processes: each "
            "process's value store holds only its own strings, so the "
            "byte-lane depth cannot be bounded globally; sort on a "
            "non-hashed key or in one process")
    descend = _norm_dirs(by, ascending)
    w, cap = env.world_size, table.capacity
    vc = np.asarray(table.valid_counts, np.int64)
    live = np.zeros(w * cap, bool)
    for i in range(w):
        live[i * cap:i * cap + int(vc[i])] = True
    new_by, new_asc, add_cols = [], [], {}
    for n, c, desc in zip(by, by_cols, descend):
        if not isinstance(c.dictionary, HashedStrings):
            new_by.append(n)
            new_asc.append(not desc)
            continue
        hs, vs = c.dictionary._lookup()
        lanes = _value_lanes(np.asarray(vs, dtype=object), c.data.device)
        n_lanes = lanes.shape[1]
        codes = host_array(c.data)
        cu = codes.view(np.uint64) if codes.dtype == np.int64 \
            else codes.astype(np.uint64)
        if len(hs):
            idx = np.clip(np.searchsorted(hs, cu), 0, len(hs) - 1)
            ok = live if c.validity is None \
                else live & host_array(c.validity)
            if bool((hs[idx][ok] != cu[ok]).any()):
                raise InvalidError(
                    f"sort on string column {n!r}: some rows' codes are "
                    "missing from the column's value store")
            row_lanes = lanes[idx]
        else:
            row_lanes = np.zeros((len(cu), n_lanes), np.uint32)
        mat = (row_lanes ^ np.uint32(0x80000000)).view(np.int32)
        # one upload for all of this key's lanes, lane-major so each
        # lane column is a contiguous row
        placed = torch.from_numpy(np.ascontiguousarray(mat.T)).to(
            c.data.device)
        for li in range(n_lanes):
            lane_host = mat[:, li]
            name = f"__strord_{n}_{li}"
            while name in table:
                name += "_"
            bounds = ((int(lane_host.min()), int(lane_host.max()))
                      if lane_host.size else None)
            add_cols[name] = Column(placed[li], LogicalType.INT32,
                                    c.validity, bounds=bounds)
            new_by.append(name)
            new_asc.append(not desc)
    return table.with_columns(add_cols), new_by, new_asc, list(by)


def sort_table(table: Table, by, ascending=True,
               nulls_position: str = "last", num_samples: int = 0,
               method: str = "initial") -> Table:
    """Sort ``table`` globally by key columns ``by`` (stable within each
    shard; ``ascending`` a bool or one per key; nulls ``"first"`` or
    ``"last"``).

    ``method``: ``"initial"`` samples the unsorted shards, range-
    partitions and sorts once; ``"regular"`` sorts each shard first and
    samples the sorted runs (evenly spaced positions of a sorted shard
    are its exact quantiles), then sorts again after the exchange.
    ``num_samples`` per shard, 0 for ``config.sort_samples(W)``."""
    by = [by] if isinstance(by, str) else list(by)
    if not by:
        raise InvalidError("sort needs at least one key column")
    for n in by:
        if table.column(n).type == LogicalType.LIST:
            raise InvalidError(
                f"sort on list passthrough column {n!r} is not supported "
                "(codes are row ids, not value-ordered)")
    if method not in ("initial", "regular"):
        raise InvalidError("sort method must be 'initial' or 'regular'")
    from ..obs import plan as _plan
    with _plan.node("sort", by=tuple(by), method=method) as pn:
        if pn:
            pn.set(rows_in=table.row_count, rows_out=table.row_count)
        return _sort_table_impl(table, by, ascending, nulls_position,
                                num_samples, method, pn)


def _sort_table_impl(table: Table, by: list, ascending, nulls_position: str,
                     num_samples: int, method: str, pn) -> Table:
    env = table.env
    with timing.region("sort.string_lanes"):
        expanded = _expand_hashed_string_keys(table, by, ascending)
    if expanded is not None:
        table2, by2, asc2, orig_by = expanded
        out = sort_table(table2, by2, asc2, nulls_position, num_samples,
                         method)
        synth = set(by2) - set(orig_by)
        res = Table({n: c for n, c in out.columns.items()
                     if n not in synth}, env, out.valid_counts)
        # equal lane tuples are equal values: grouped by the original keys
        res.grouped_by = tuple(orig_by)
        return res
    descendings = _norm_dirs(by, ascending)
    npos = pack.NULL_FIRST if nulls_position == "first" else pack.NULL_LAST
    w = env.world_size
    if w > 1 and table.row_count > 0:
        if method == "regular":
            # quantile-exact splitter samples come from the SORTED shards
            with timing.region("sort.local"):
                table = local_sort_table(table, by, ascending,
                                         nulls_position)
        by_cols = [table.column(n) for n in by]
        by_datas, by_valids = col_arrays(by_cols)
        narrow = narrow32_flags(by_cols)
        vc = np.asarray(table.valid_counts, np.int64)
        cap = table.capacity
        if num_samples <= 0:
            num_samples = config.sort_samples(w)
        m = min(max(cap, 1), num_samples)
        if pn:
            # a key profile from the splitter sample's positions, so a
            # skewed sort key is named before the range exchange piles
            # it onto one rank (analyze runs only)
            from ..obs import plan as _plan
            pn.annotate(route="sample_sort", num_samples=m,
                        splitters=w - 1)
            _plan.profile_keys(pn, table, by)
        with timing.region("sort.sample"):
            sample_ops, live = _sample_fn(vc, w, cap, m, by_datas,
                                          by_valids, descendings, npos,
                                          narrow)
            splitters = _pick_splitters(sample_ops, live, w)
            tgt = _target_fn(vc, cap, by_datas, by_valids, splitters,
                             descendings, npos, narrow)
        with timing.region("sort.exchange"):
            counts = shuffle.count_targets(env, tgt)
            table = exchange_by_targets(table, tgt, counts)
            del tgt
    with timing.region("sort.local"):
        out = local_sort_table(table, by, ascending, nulls_position)
    # globally sorted by the keys: equal keys contiguous per shard and,
    # through the range partition, co-located across shards
    out.grouped_by = tuple(by)
    return out
