"""Shuffle, row filter and row-wise assembly (port of the hash shuffle,
``filter_table`` and ``concat_tables`` of
``cylon_tpu/relational/repart.py``).

The hash shuffle packs a table's laneable columns into ONE 32-bit lane
matrix (ops/lanes.py) plus f64 side arrays, moves them through the
exchange (parallel/shuffle.py) and unpacks them on the receiving shards,
as the reference does.  Repartition, slice, head and tail are slice 8 of
ROADMAP.md Queue 1.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.column import Column
from ..core.dtypes import LogicalType
from ..core.table import Table
from ..ctx.context import CylonEnv
from ..ops import lanes
from ..ops import sort as sortk
from ..parallel import shuffle
from ..parallel.shards import map_shards, shard
from ..status import InvalidError
from ..utils import timing
from ..utils.host import host_array
from .common import (build_table, col_arrays, live_mask, promote_key_pair,
                     rebuild_like, table_lane_spec, unify_dictionaries)


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


def shuffle_table(table: Table, key_names) -> Table:
    """Redistribute rows so equal keys land on the same shard (hash
    partitioning): rank ``partition_targets(hash_rows(keys), W)`` receives
    every row whose keys hash to it, in (source rank, source position)
    order.  At world size 1 the table itself."""
    env = table.env
    if env.world_size == 1:
        return table
    with timing.region("shuffle.hash"):
        keys = [table.column(n) for n in key_names]
        datas, valids = col_arrays(keys)
        tgt = shuffle.hash_targets(env, datas, valids, table.valid_counts)
        counts = shuffle.count_targets(env, tgt)
    return exchange_by_targets(table, tgt, counts)


def exchange_by_targets(table: Table, tgt, counts: np.ndarray) -> Table:
    """Exchange with caller-computed per-row targets."""
    with timing.region("shuffle.exchange"):
        flat, recipe = _flatten_for_exchange(table)
        new_flat, new_valid = shuffle.exchange(table.env, tgt, counts, flat)
        del flat
        return _rebuild(recipe, new_flat, new_valid, table.env)


def filter_table(table: Table, flag: torch.Tensor) -> Table:
    """Keep the rows whose bool ``flag`` (the table's row layout) is set.
    Row order is preserved and every row stays on its shard; the output
    capacity is one ``pow2ceil`` over the shards' kept counts, pulled in
    one wait."""
    env = table.env
    w = env.world_size
    keep = flag & live_mask(table.valid_counts, table.capacity, flag.device)
    counts = host_array(keep.view(w, -1).sum(dim=1)).astype(np.int64)
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
        if cs[0].type == LogicalType.STRING or len({c.type for c in cs}) > 1:
            unify = unify_dictionaries if cs[0].type == LogicalType.STRING \
                else promote_key_pair
            for i in range(1, len(cs)):
                cs[0], cs[i] = unify(cs[0], cs[i])
            # pairwise unification converges on cs[0]'s final form; bring
            # every earlier column to it in a second sweep
            cs = [cs[0]] + [unify(cs[0], c)[1] for c in cs[1:]]
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
