"""Shuffle, repartition, slice, head, tail, row filter and row-wise
assembly (port of ``cylon_tpu/relational/repart.py``).

The hash shuffle packs a table's laneable columns into ONE 32-bit lane
matrix (ops/lanes.py) plus f64 side arrays, moves them through the
exchange (parallel/shuffle.py) and unpacks them on the receiving shards,
as the reference does.  :func:`repartition` moves rows through the same
exchange with order-preserving targets: each source sends every
destination a contiguous global range, and the exchange's (source rank,
source position) receive order puts the rows back in global order.
:func:`slice_table`, :func:`head` and :func:`tail` keep each rank's
overlap with a global row range where it is.

:func:`place_by_global_pos` places rows on the even layout by global
positions its caller computed (the skew stitch, relational/skew.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.column import Column, PassthroughValues
from ..core.dtypes import LogicalType
from ..core.table import Table
from ..ctx.context import CylonEnv
from ..obs import plan as _plan
from ..ops import lanes
from ..ops import sort as sortk
from ..parallel import shuffle
from ..parallel.shards import map_shards, shard
from ..status import InvalidError
from ..utils import timing
from ..utils.host import host_array
from .common import (build_table, col_arrays, live_mask, promote_key_pair,
                     rescale_decimals_many,
                     rebuild_like, table_lane_spec, unify_dictionaries_many)


def _flatten_for_exchange(table: Table):
    """Table columns -> the exchange payload tuple + a rebuild recipe:
    every laneable column (data and bit-packed validity) in ONE
    ``(W·cap, L)`` int32 lane matrix, f64 columns as side arrays."""
    items = list(table.columns.items())
    cols = [c for _, c in items]
    spec = table_lane_spec(cols)
    flat = []
    if spec.n_lanes:
        flat.append(lanes.pack_lanes(spec, [c.data for c in cols],
                                     [c.validity for c in cols]))
    for c, cl in zip(cols, spec.cols):
        if not cl.lanes:
            flat.append(c.data)
    recipe = (spec, tuple((name, c.type, c.dictionary, c.bounds)
                          for name, c in items))
    return tuple(flat), recipe


def _rebuild(recipe, new_flat, valid_counts, env: CylonEnv) -> Table:
    """Inverse of :func:`_flatten_for_exchange` on the exchanged arrays;
    bounds widen to include 0 (the rows are a permutation of the input
    values plus zero padding)."""
    spec, metas = recipe
    if spec.n_lanes:
        datas, valids = lanes.unpack_lanes(spec, new_flat[0])
        side = iter(new_flat[1:])
    else:
        datas = valids = (None,) * len(spec.cols)
        side = iter(new_flat)
    cols = {}
    for (name, t, dc, b), cl, d, v in zip(metas, spec.cols, datas, valids):
        if not cl.lanes:
            d = next(side)
        nb = (min(b[0], 0), max(b[1], 0)) if b is not None else None
        cols[name] = Column(d, t, v, dc, bounds=nb)
    return Table(cols, env, np.asarray(valid_counts, np.int64))


def shuffle_table(table: Table, key_names,
                  owner: str = "shuffle.recv") -> Table:
    """Redistribute rows so equal keys land on the same shard (hash
    partitioning): rank ``partition_targets(hash_rows(keys), W)`` receives
    every row whose keys hash to it, in (source rank, source position)
    order.  At world size 1 the table itself.  ``owner`` labels the
    receive on the plan node and in the exchange records (stream appends
    pass ``stream.recv``).  Every distributed operator
    shuffles, so this is the serving tier's interleave point of the
    monolithic plans (exec/scheduler.maybe_yield; nothing outside a
    scheduler)."""
    from ..exec import scheduler
    scheduler.maybe_yield()
    env = table.env
    if env.world_size == 1:
        return table
    with _plan.node("shuffle", keys=tuple(key_names), owner=owner) as pn:
        if pn:
            pn.set(rows_in=table.row_count, rows_out=table.row_count)
        with timing.region("shuffle.hash"):
            keys = [table.column(n) for n in key_names]
            datas, valids = col_arrays(keys)
            tgt = shuffle.hash_targets(env, datas, valids,
                                       table.valid_counts)
            counts = shuffle.count_targets(env, tgt)
        # hash shuffles run under the join/groupby/set-op OOM fallbacks:
        # the receive-budget guard may refuse a receive before it is
        # allocated
        return exchange_by_targets(table, tgt, counts, guard=True,
                                   owner=owner)


def exchange_by_targets(table: Table, tgt, counts: np.ndarray,
                        guard: bool = False,
                        owner: str = "shuffle.recv") -> Table:
    """Exchange with caller-computed per-row targets; ``guard``: run the
    exchange's receive-budget guard; ``owner``: the receive's label."""
    with timing.region("shuffle.exchange"):
        flat, recipe = _flatten_for_exchange(table)
        new_flat, new_valid = shuffle.exchange(table.env, tgt, counts, flat,
                                               guard=guard, owner=owner)
        del flat
        return _rebuild(recipe, new_flat, new_valid, table.env)


def even_partition_counts(total: int, w: int) -> np.ndarray:
    """``total`` global rows split as evenly as possible over ``w``
    partitions, the earlier partitions taking the remainder (the
    reference's ``DivideRowsEvenly``)."""
    total, w = int(total), int(w)
    base = total // w
    extra = total - base * w
    return np.asarray([base + (1 if i < extra else 0) for i in range(w)],
                      np.int64)


def _order_preserving_targets(table: Table,
                              dest_counts: np.ndarray) -> torch.Tensor:
    """Per-row destination ranks (int32, the table's row layout) that give
    global row i to the destination whose cumulative range holds i: a
    sorted search of the int64 global positions against the destinations'
    last positions.  Padding rows get W."""
    env = table.env
    w, cap, dev = env.world_size, table.capacity, env.device
    vc = np.asarray(table.valid_counts, np.int64)
    offs = np.concatenate([[0], np.cumsum(vc)[:-1]]).astype(np.int64)
    bounds = torch.from_numpy(np.cumsum(dest_counts).astype(np.int64)
                              - 1).to(dev)
    # int64 global positions: past 2^31 rows in total they outgrow int32
    gpos = (torch.from_numpy(offs).to(dev)[:, None]
            + torch.arange(cap, dtype=torch.int64, device=dev)).reshape(-1)
    t = torch.searchsorted(bounds, gpos).clamp_(0, w - 1).to(torch.int32)
    return torch.where(live_mask(vc, cap, dev), t,
                       torch.full((), w, dtype=torch.int32, device=dev))


def place_by_global_pos(table: Table, pos: torch.Tensor,
                        total: int) -> Table:
    """Redistribute ``table``'s rows onto the even order-preserving layout
    (:func:`even_partition_counts`) by their caller-computed GLOBAL row
    positions ``pos`` (int64, the table's row layout; padding rows carry
    the ``total`` sentinel), which must be a permutation of
    ``[0, total)``.  Destination d owns positions ``[dof[d], dof[d] +
    dest[d])``; its rows arrive in (source rank, source position) order
    and land at their own slots ``pos - dof[d]``, so the result reads back
    in position order — the merge half of the skew stitch (relational/
    skew.stitch_join_output).  Raises :class:`InvalidError` when the
    received counts are not the even layout, or when a destination's
    positions are not its own range once each (a repeated position whose
    counts still match)."""
    env = table.env
    w = env.world_size
    total = int(total)
    if total == 0 or not table.column_count:
        return table
    dev = env.device
    dest = even_partition_counts(total, w)
    bounds = torch.from_numpy(np.cumsum(dest).astype(np.int64) - 1).to(dev)
    with timing.region("place.targets"):
        t = torch.searchsorted(bounds, pos).clamp_(0, w - 1).to(torch.int32)
        tgt = torch.where(live_mask(table.valid_counts, table.capacity, dev),
                          t, torch.full((), w, dtype=torch.int32, device=dev))
        del t
        counts = shuffle.count_targets(env, tgt)
    with timing.region("place.exchange"):
        flat, recipe = _flatten_for_exchange(table)
        new_flat, new_valid = shuffle.exchange(env, tgt, counts,
                                               flat + (pos,))
        del flat, tgt
    if not np.array_equal(np.asarray(new_valid, np.int64), dest):
        raise InvalidError(
            f"place_by_global_pos: received counts {list(new_valid)} do "
            f"not match the even layout {list(dest)} — positions are not "
            "a permutation of the claimed total")
    with timing.region("place.sort"):
        out_cap = new_flat[0].shape[0] // w
        dof = torch.from_numpy(np.concatenate([[0], np.cumsum(dest)[:-1]])
                               .astype(np.int64)).to(dev)
        # received row q of destination d belongs at slot d·out_cap +
        # pos - dof[d]; a padding row keeps its own slot.  When the slots
        # are a permutation, one scatter of the row numbers inverts it and
        # one gather per array puts every shard in position order (the
        # clamp and the identity start keep every index in range even
        # for positions that break the contract).  A repeated slot leaves
        # another unwritten, whose identity entry then fails slot[inv] ==
        # q: one compare and one pull find it
        q = torch.arange(w * out_cap, dtype=torch.int64, device=dev)
        d = q // out_cap
        slot = torch.where(live_mask(new_valid, out_cap, dev),
                           d * out_cap + (new_flat[-1] - dof[d]).clamp(
                               0, out_cap - 1), q)
        del d
        inv = q.clone()
        inv[slot] = q
        if not bool(torch.equal(slot[inv], q)):
            raise InvalidError(
                "place_by_global_pos: positions are not a permutation of "
                "the claimed total — a destination received a repeated "
                "position")
        del q, slot
        sorted_flat = [a[inv] for a in new_flat[:-1]]
        del inv, new_flat
    return _rebuild(recipe, sorted_flat, new_valid, env)


def repartition(table: Table, rows_per_partition=None) -> Table:
    """Redistribute the rows keeping their global order: rank r ends with
    ``rows_per_partition[r]`` rows (default: the even split).  The count
    matrix is computed on the host: source s's global range intersected
    with each destination's."""
    env = table.env
    w = env.world_size
    total = table.row_count
    if rows_per_partition is None:
        dest = even_partition_counts(total, w)
    else:
        dest = np.asarray(rows_per_partition, np.int64)
        if dest.shape != (w,) or dest.sum() != total:
            raise InvalidError(
                f"rows_per_partition must hold {w} counts summing to {total}")
    if w == 1 or not table.column_count:
        return table
    if np.array_equal(dest, table.valid_counts):
        return table
    with _plan.node("repartition", order_preserving=True) as pn:
        if pn:
            pn.set(rows_in=total, rows_out=total)
        with timing.region("repart.targets"):
            tgt = _order_preserving_targets(table, dest)
        vc = np.asarray(table.valid_counts, np.int64)
        soff = np.concatenate([[0], np.cumsum(vc)[:-1]])
        dof = np.concatenate([[0], np.cumsum(dest)[:-1]])
        lo, hi = soff[:, None], (soff + vc)[:, None]
        counts = np.maximum(0, np.minimum(hi, dof + dest)
                            - np.maximum(lo, dof)).astype(np.int64)
        return exchange_by_targets(table, tgt, counts)


def repad_table(table: Table, new_cap: int) -> Table:
    """Change the per-shard capacity without moving rows: each shard keeps
    its first ``new_cap`` rows or gains zero rows (the valid prefixes
    must fit).  Bounds widen to include the padding's 0."""
    cap = table.capacity
    if new_cap == cap:
        return table
    if int(table.valid_counts.max(initial=0)) > new_cap:
        raise InvalidError(f"valid rows exceed new capacity {new_cap}")
    w = table.env.world_size

    def repad(d):
        blocks = d.view((w, cap) + tuple(d.shape[1:]))
        if new_cap <= cap:
            out = blocks[:, :new_cap]
        else:
            out = torch.cat([blocks, blocks.new_zeros(
                (w, new_cap - cap) + tuple(d.shape[1:]))], dim=1)
        return out.reshape((w * new_cap,) + tuple(d.shape[1:]))

    cols = {}
    for n, c in table.columns.items():
        b = c.bounds
        if b is not None and new_cap > cap:
            b = (min(b[0], 0), max(b[1], 0))
        cols[n] = Column(repad(c.data), c.type,
                         None if c.validity is None else repad(c.validity),
                         c.dictionary, bounds=b)
    return Table(cols, table.env, table.valid_counts)


def slice_table(table: Table, offset: int, length: int) -> Table:
    """The global row range ``[offset, offset + length)``, distribution
    kept: each rank keeps its overlap with the range, at one capacity
    ``pow2ceil(max kept)`` (the reference's DistributedSlice)."""
    env = table.env
    cap, dev = table.capacity, env.device
    vc = np.asarray(table.valid_counts, np.int64)
    offs = np.concatenate([[0], np.cumsum(vc)[:-1]]).astype(np.int64)
    lo, hi = int(offset), int(offset) + int(length)
    kept = np.clip(np.minimum(offs + vc, hi) - np.maximum(offs, lo), 0, None)
    gpos = (torch.from_numpy(offs).to(dev)[:, None]
            + torch.arange(cap, dtype=torch.int64, device=dev)).reshape(-1)
    keep = live_mask(vc, cap, dev) & (gpos >= lo) & (gpos < hi)
    return compact_rows(table, keep, kept)


def head(table: Table, n: int) -> Table:
    return slice_table(table, 0, n)


def tail(table: Table, n: int) -> Table:
    total = table.row_count
    n = min(n, total)
    return slice_table(table, total - n, n)


def filter_table(table: Table, flag: torch.Tensor) -> Table:
    """Keep the rows whose bool ``flag`` (the table's row layout) is set.
    Row order is preserved and every row stays on its shard; the output
    capacity is one ``pow2ceil`` over the shards' kept counts, pulled in
    one wait."""
    w = table.env.world_size
    keep = flag & live_mask(table.valid_counts, table.capacity, flag.device)
    counts = host_array(keep.view(w, -1).sum(dim=1)).astype(np.int64)
    return compact_rows(table, keep, counts)


def compact_rows(table: Table, keep: torch.Tensor,
                 counts: np.ndarray) -> Table:
    """The rows flagged in ``keep`` (live rows only), each shard's in row
    order at one capacity ``pow2ceil(max counts)``; ``counts`` are the
    host per-shard flag counts.  The kept columns gather as one lane
    matrix plus f64 side arrays."""
    env = table.env
    w = env.world_size
    out_cap = config.pow2ceil(int(counts.max()) if counts.size else 1)
    items = list(table.columns.items())
    datas, valids = col_arrays([c for _, c in items])
    spec = table_lane_spec([c for _, c in items])

    def one(r):
        idx, _ = sortk.compact_by_flag(shard(keep, w, r), out_cap)
        return lanes.gather_columns(spec, [shard(d, w, r) for d in datas],
                                    [shard(v, w, r) for v in valids], idx)

    out_d, out_v = map_shards(one, w, cap=out_cap)
    return rebuild_like(items, out_d, out_v, counts, env)


def concat_tables(tables: list[Table]) -> Table:
    """Row-wise concatenation, per shard: shard r holds the live rows of
    every table's shard r in input order, in one ``pow2ceil`` capacity
    over the shards with a zero tail (the reference's per-rank local
    Merge).  String dictionaries are unified and numeric types promoted
    column-wise; bounds merge (with 0, since the output tail is
    padding)."""
    if not tables:
        raise InvalidError("concat of zero tables")
    if len(tables) == 1:
        return tables[0]
    env = tables[0].env
    names = tables[0].column_names
    for t in tables[1:]:
        if t.column_names != names:
            raise InvalidError(f"concat schema mismatch: {t.column_names} "
                               f"vs {names}")
    col_sets = []
    for n in names:
        cs = [t.column(n) for t in tables]
        if cs[0].type == LogicalType.STRING:
            cs = unify_dictionaries_many(cs)
        elif all(c.type == LogicalType.LIST for c in cs):
            # one value store; later tables' codes shift by the lengths
            # of the stores before them
            vals = [c.dictionary.values for c in cs]
            offs = np.cumsum([0] + [len(v) for v in vals[:-1]])
            merged = PassthroughValues(np.concatenate(vals))
            hi = max(len(merged) - 1, 0)
            cs = [Column(c.data + int(o), LogicalType.LIST, c.validity,
                         merged, bounds=(0, hi))
                  for c, o in zip(cs, offs)]
        elif all(c.type == LogicalType.DECIMAL for c in cs):
            cs = rescale_decimals_many(cs)
        elif len({c.type for c in cs}) > 1:
            for i in range(1, len(cs)):
                cs[0], cs[i] = promote_key_pair(cs[0], cs[i])
            # pairwise promotion converges on cs[0]'s final type; bring
            # every earlier column to it in a second sweep
            cs = [cs[0]] + [promote_key_pair(cs[0], c)[1] for c in cs[1:]]
        col_sets.append(cs)
    w = env.world_size
    vcs = np.stack([np.asarray(t.valid_counts, np.int64) for t in tables])
    totals = vcs.sum(axis=0)
    out_cap = config.pow2ceil(int(totals.max()))

    def one_shard(r):
        outs = []
        for cs in col_sets:
            n = [int(v) for v in vcs[:, r]]
            outs.append(torch.cat([shard(c.data, w, r)[:k]
                                   for c, k in zip(cs, n)]))
            if any(c.validity is not None for c in cs):
                dev = cs[0].data.device
                outs.append(torch.cat([
                    shard(c.validity, w, r)[:k] if c.validity is not None
                    else torch.ones(k, dtype=torch.bool, device=dev)
                    for c, k in zip(cs, n)]))
            else:
                outs.append(None)
        return outs

    flat = map_shards(one_shard, w, cap=out_cap)
    out_d, out_v = flat[0::2], flat[1::2]
    bounds = []
    for cs in col_sets:
        bs = [c.bounds for c in cs]
        bounds.append((min(min(b[0] for b in bs), 0),
                       max(max(b[1] for b in bs), 0))
                      if all(b is not None for b in bs) else None)
    return build_table(names, out_d, out_v, [cs[0].type for cs in col_sets],
                       [cs[0].dictionary for cs in col_sets],
                       totals, env, bounds=bounds)
