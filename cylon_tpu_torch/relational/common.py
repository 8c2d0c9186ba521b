"""Shared plumbing for the table-level operators (port of the subset of
``cylon_tpu/relational/common.py`` the join, groupby, sort and set ops
read): the bounded prediction cache, per-shard liveness masks, sample
positions, int32-narrowing flags, lane specs, string-dictionary
unification (sorted or hashed), key promotion with the decimal rescale
and the list-key refusal, result-table assembly,
the filter flag of a bool column, the same-world check, and the
operators' OOM fallback (:func:`run_with_oom_fallback`)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.column import Column, DecimalScale, HashedStrings
from ..core.dtypes import LogicalType, np_dtype_of, physical_np_dtype
from ..core.table import Table
from ..ctx.context import CylonEnv
from ..status import CylonTypeError, InvalidError

#: distinct pad keys per table so padding rows never rank-equal across tables
PAD_L, PAD_R = 4, 5


class BoundedCache(dict):
    """Bounded FIFO mapping for callsite -> capacity-prediction caches:
    the oldest entry is evicted at ``maxlen``."""

    def __init__(self, maxlen: int = 512):
        super().__init__()
        self.maxlen = maxlen

    def put(self, key, value) -> None:
        if key not in self and len(self) >= self.maxlen:
            self.pop(next(iter(self)))
        self[key] = value


def run_with_oom_fallback(primary, can_fallback: bool, fallback, label: str,
                          env=None):
    """``primary()`` under the retry ladder (exec/recovery.
    run_with_recovery): an OOM retries ``fallback(4)`` then
    ``fallback(16)`` — the operator's chunked route on the same device —
    after the spill rung for a predicted one; a capacity overflow takes
    one cap-halving step.  Shared by ``join_tables``,
    ``groupby_aggregate`` and ``set_operation``.  The operators' one entry
    to the ladder, under the reference's name so its counterpart is found
    (``cylon_tpu/relational/common.py``); the OOM test itself is
    exec/recovery.is_oom, the one place that reads runtime error text."""
    from ..exec.recovery import run_with_recovery
    return run_with_recovery(primary, can_fallback, fallback, label, env=env)


def live_mask(vc, cap: int, device) -> torch.Tensor:
    """Row liveness of a W-shard layout, ``W = len(vc)``: in each
    ``cap``-row shard r the first ``vc[r]`` rows are real, the rest
    padding.  A ``(W·cap,)`` bool tensor; one rank's counts give its
    shard's ``(cap,)`` mask."""
    pos = torch.arange(cap, device=device)
    vc = np.asarray(vc).reshape(-1)
    if len(vc) == 1:
        return pos < int(vc[0])
    return torch.cat([pos < int(v) for v in vc])


def sample_positions(n: int, m: int, cap: int) -> np.ndarray:
    """``m`` evenly spaced in-range row positions (int32) over a live
    prefix of ``n`` rows, computed with the reference's float32 stride
    (``max(n, 1) / m``, then ``arange(m) * stride`` truncated), so both
    packages sample the same rows.  Host-side: ``n`` is a host count."""
    stride = np.float32(max(int(n), 1)) / np.float32(m)
    idx = (np.arange(m, dtype=np.float32) * stride).astype(np.int32)
    return np.clip(idx, 0, cap - 1)


def valid_flag(col: Column) -> torch.Tensor:
    """Boolean filter payload of a bool column with null rows forced False
    (a null predicate never selects a row)."""
    flag = col.data
    if col.validity is not None:
        flag = flag & col.validity
    return flag


def fits_int32(c: Column) -> bool:
    """Host-known: this 64-bit integer column's bounds fit int32, so it may
    sort and travel as one 32-bit lane instead of a (hi, lo) pair."""
    dt = np_dtype_of(c.data)
    if dt.itemsize != 8 or dt.kind not in ("i", "u"):
        return False
    return c.bounds is not None and c.bounds[0] >= -(1 << 31) \
        and c.bounds[1] <= (1 << 31) - 1


def narrow32_flags(*col_lists) -> tuple:
    """Per key column: True when every listed column's bounds fit int32."""
    n = len(col_lists[0])
    return tuple(all(fits_int32(cl[i]) for cl in col_lists)
                 for i in range(n))


def table_lane_spec(cols: list[Column]):
    """LaneSpec over a column list (bounds-narrowed)."""
    from ..ops import lanes
    return lanes.plan_lanes(
        tuple(np_dtype_of(c.data).name for c in cols),
        tuple(c.validity is not None for c in cols),
        narrow32_flags(cols))


def col_arrays(cols: list[Column]):
    """Parallel (datas, valids) tuples; valids entries may be None."""
    return tuple(c.data for c in cols), tuple(c.validity for c in cols)


def to_hashed_strings(c: Column) -> Column:
    """Re-code a sorted-dictionary string column into hashed-codes space
    (codes = stable 64-bit value hashes, ``core.column.HashedStrings``),
    so it can meet a hashed column in a join, set op or concat."""
    if isinstance(c.dictionary, HashedStrings):
        return c
    from .. import native
    vals = np.asarray(c.dictionary, dtype=object)
    hashes = native.hash_strings(vals) if len(vals) \
        else np.zeros(0, np.uint64)
    if len(vals):
        remap = torch.from_numpy(hashes.view(np.int64)).to(c.data.device)
        data = remap[c.data.clamp(0, len(vals) - 1).long()]
    else:
        data = torch.zeros(c.data.shape, dtype=torch.int64,
                           device=c.data.device)
    return Column(data, LogicalType.STRING, c.validity,
                  HashedStrings(hashes, vals))


def unify_dictionaries(a: Column, b: Column) -> tuple[Column, Column]:
    """Re-code two dictionary-encoded string columns into one shared sorted
    dictionary (code order stays lexical order).  When either side is
    hashed, both land in hashed-codes space: the codes already compare
    across columns (one hash function), only the decode lookups merge."""
    if isinstance(a.dictionary, HashedStrings) \
            or isinstance(b.dictionary, HashedStrings):
        ah, bh = to_hashed_strings(a), to_hashed_strings(b)
        merged = ah.dictionary.merged_with(bh.dictionary)
        return (Column(ah.data, LogicalType.STRING, ah.validity, merged),
                Column(bh.data, LogicalType.STRING, bh.validity, merged))
    if a.dictionary is b.dictionary or (
            len(a.dictionary) == len(b.dictionary)
            and np.array_equal(a.dictionary, b.dictionary)):
        return a, b
    merged = np.unique(np.concatenate([a.dictionary, b.dictionary]))

    def recode(c: Column) -> Column:
        m = torch.from_numpy(np.searchsorted(merged, c.dictionary)
                             .astype(np.int32)).to(c.data.device)
        codes = m[c.data.clamp(0, max(len(c.dictionary) - 1, 0)).long()]
        return Column(codes, LogicalType.STRING, c.validity, merged)

    return recode(a), recode(b)


def unify_dictionaries_many(cols: list[Column]) -> list[Column]:
    """N-way :func:`unify_dictionaries` (concat, the pipelined set op's
    partials): one merged sorted dictionary, or hashed-codes space when
    any column is hashed."""
    if any(isinstance(c.dictionary, HashedStrings) for c in cols):
        hashed = [to_hashed_strings(c) for c in cols]
        merged = hashed[0].dictionary
        for h in hashed[1:]:
            merged = merged.merged_with(h.dictionary)
        return [Column(h.data, LogicalType.STRING, h.validity, merged)
                for h in hashed]
    dicts = [c.dictionary for c in cols]
    if all(d is dicts[0] or np.array_equal(d, dicts[0]) for d in dicts[1:]):
        return list(cols)
    merged = np.unique(np.concatenate(dicts))
    out = []
    for c in cols:
        m = torch.from_numpy(np.searchsorted(merged, c.dictionary)
                             .astype(np.int32)).to(c.data.device)
        out.append(Column(m[c.data.clamp(0, max(len(c.dictionary) - 1, 0))
                            .long()], LogicalType.STRING, c.validity,
                          merged))
    return out


def promote_key_pair(a: Column, b: Column) -> tuple[Column, Column]:
    """Make a cross-table key pair comparable: unify string dictionaries,
    rescale decimals to a common scale, or promote numerics to a common
    logical type.  A list column is never a key."""
    if LogicalType.LIST in (a.type, b.type):
        raise CylonTypeError(
            "list passthrough columns cannot be keys (codes are row ids, "
            "not value-equal); they carry through joins as payload only")
    if (a.type == LogicalType.STRING) != (b.type == LogicalType.STRING):
        raise CylonTypeError(f"cannot join {a.type} with {b.type}")
    if a.type == LogicalType.STRING:
        return unify_dictionaries(a, b)
    if (a.type == LogicalType.DECIMAL) != (b.type == LogicalType.DECIMAL):
        raise CylonTypeError(
            f"cannot join {a.type} with {b.type}; rescale explicitly")
    if a.type == LogicalType.DECIMAL:
        return rescale_decimal_pair(a, b)
    if a.type == b.type:
        return a, b
    common = np.promote_types(physical_np_dtype(a.type),
                              physical_np_dtype(b.type))
    if common.name not in LogicalType._value2member_map_:
        raise CylonTypeError(f"no common key type for {a.type}/{b.type}")
    lt = LogicalType(common.name)
    return a.cast(lt), b.cast(lt)


def rescale_decimal_pair(a: Column, b: Column) -> tuple[Column, Column]:
    """Bring two DECIMAL columns to one scale (the larger): the scaled
    ints then compare and join exactly."""
    a, b = rescale_decimals_many([a, b])
    return a, b


def rescale_decimals_many(cs: list[Column]) -> list[Column]:
    """Bring N DECIMAL columns to ONE common scale, the largest, in one
    pass, with a precision that covers every column's rescaled digits
    (past 18 digits :class:`DecimalScale` raises).  One pass matters:
    pairwise promotion would leave middle columns at a stale scale under
    the final dictionary."""
    scales = [c.dictionary for c in cs]
    if all(s == scales[0] for s in scales[1:]):
        return list(cs)
    scale = max(s.scale for s in scales)
    target = DecimalScale(max(s.precision + scale - s.scale for s in scales),
                          scale)

    def up(c: Column, own: DecimalScale) -> Column:
        f = 10 ** (scale - own.scale)
        bounds = ((c.bounds[0] * f, c.bounds[1] * f)
                  if c.bounds is not None else None)
        return Column(c.data * f if f != 1 else c.data, LogicalType.DECIMAL,
                      c.validity, target, bounds=bounds)

    return [up(c, s) for c, s in zip(cs, scales)]


def build_table(names, out_datas, out_valids, types, dicts,
                valid_counts: np.ndarray, env: CylonEnv,
                bounds=None) -> Table:
    """Assemble an output Table from kernel results; ``bounds`` (parallel to
    names) keeps host-known integer bounds for downstream narrowing."""
    cols = {}
    for i, (name, d, v, t, dc) in enumerate(
            zip(names, out_datas, out_valids, types, dicts)):
        b = bounds[i] if bounds is not None else None
        cols[name] = Column(d, t, v, dc, bounds=b)
    return Table(cols, env, np.asarray(valid_counts, np.int64))


def rebuild_like(items, out_datas, out_valids, valid_counts,
                 env: CylonEnv) -> Table:
    """:func:`build_table` with the schema (name, type, dictionary) of
    existing ``(name, Column)`` pairs, for ops that permute or filter the
    rows of one table.  Bounds are not carried, as in the reference."""
    return build_table([n for n, _ in items], out_datas, out_valids,
                       [c.type for _, c in items],
                       [c.dictionary for _, c in items], valid_counts, env)


def check_same_env(a: Table, b: Table) -> CylonEnv:
    """The env two tables share: the same env, or one of the same device
    and world size (their shards line up)."""
    if a.env is not b.env and (a.env.device != b.env.device
                               or a.env.world_size != b.env.world_size):
        raise InvalidError("tables belong to different worlds: "
                           f"{a.env!r} and {b.env!r}")
    return a.env


def _key_value_repr(col: Column, vals: np.ndarray):
    """Host naming of sampled key values: numerics as they are, sorted
    dictionary string codes as their strings, hashed-string codes as
    codes (stable but opaque)."""
    if col.type == LogicalType.STRING:
        d = col.dictionary
        if isinstance(d, np.ndarray) and len(d):
            return d[np.clip(vals.astype(np.int64), 0, len(d) - 1)]
    return vals


def sample_keys(table: Table, key_names: list, m: int | None = None,
                with_hashes: bool = False):
    """Sample ``table``'s key columns for the heavy-hitter profiler
    (obs/plan.key_profile): ``(values, weights, total_rows)``, the
    sampled key identities (the values of a single key column, the row
    hashes of a composite key), each shard's live row count split over
    its samples, and the global live row count; ``with_hashes`` appends
    the routing hash of each sample.  The rows are
    :func:`sample_key_rows`' (the reference's positions).  None for an
    empty table."""
    sampled = sample_key_rows(table, key_names, m=m)
    if sampled is None:
        return None
    vals, _valids, hashes, weights, total = sampled
    if len(key_names) == 1:
        values = np.asarray(_key_value_repr(table.column(key_names[0]),
                                            vals[0]))
    else:
        values = hashes
    out = (values, np.asarray(weights, np.float64), total)
    if with_hashes:
        out += (hashes.astype(np.uint32),)
    return out


def sample_key_rows(table: Table, key_names: list, m: int | None = None):
    """Shard-weighted sample of FULL key tuples for the skew-split
    detector (relational/skew.py): ``(values, valids, hashes, weights,
    total_rows)``.  ``values``/``valids`` are per-key-column host arrays
    of the sampled data and validity bits (so a heavy tuple, nulls
    included, can go back to the device as an operand-space constant),
    ``hashes`` the routing hash (ops/hashing.hash_rows) of each sampled
    row as uint32, and ``weights`` each shard's live row count split
    evenly over its ``m`` samples.  The rows are the reference's:
    :func:`sample_positions` over each shard's live prefix.  None for an
    empty table.  One gather of W·m rows and one host pull."""
    from .. import config
    from ..ops import hashing
    from ..utils.host import host_arrays

    total = int(table.valid_counts.sum())
    if total == 0:
        return None
    w = table.env.world_size
    if m is None:
        m = config.SKEW_SAMPLE
    m = min(max(int(table.capacity), 1), int(m))
    cols = [table.column(n) for n in key_names]
    cap = table.capacity
    vc = np.asarray(table.valid_counts, np.int64)
    datas, valids = col_arrays(cols)
    dev = datas[0].device
    pos = np.concatenate([r * cap + sample_positions(int(vc[r]), m, cap)
                          for r in range(w)]).astype(np.int64)
    idx = torch.from_numpy(pos).to(dev)
    sd = [d[idx] for d in datas]
    sv = [torch.ones(len(pos), dtype=torch.bool, device=dev)
          if v is None else v[idx] for v in valids]
    # the hash is elementwise: hashing the sampled rows alone gives the
    # sampled rows' hashes
    outs = host_arrays(sd + sv + [hashing.hash_rows(sd, sv)])
    nk = len(cols)
    vals, vls, hashes = outs[:nk], outs[nk:2 * nk], outs[-1]
    keep = np.repeat(vc > 0, m)
    if not keep.any():
        return None
    per_shard_w = np.repeat(np.where(vc > 0, vc / max(m, 1), 0.0), m)
    return ([v[keep] for v in vals], [v[keep] for v in vls],
            hashes[keep].astype(np.uint32), per_shard_w[keep], total)
