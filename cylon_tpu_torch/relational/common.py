"""Shared plumbing for the table-level operators (port of the world-1 subset
of ``cylon_tpu/relational/common.py``): the bounded prediction cache,
liveness masks, int32-narrowing flags, lane specs, key promotion and
result-table assembly."""

from __future__ import annotations

import numpy as np
import torch

from ..core.column import Column
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


def live_mask(vc, cap: int, device) -> torch.Tensor:
    """Row-liveness mask of one rank's shard: the first ``vc[0]`` of its
    ``cap`` rows are real, the rest padding."""
    return torch.arange(cap, device=device) < int(vc[0])


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


def unify_dictionaries(a: Column, b: Column) -> tuple[Column, Column]:
    """Re-code two dictionary-encoded string columns into one shared sorted
    dictionary (code order stays lexical order)."""
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


def promote_key_pair(a: Column, b: Column) -> tuple[Column, Column]:
    """Make a cross-table key pair comparable: unify string dictionaries or
    promote numerics to a common logical type."""
    if (a.type == LogicalType.STRING) != (b.type == LogicalType.STRING):
        raise CylonTypeError(f"cannot join {a.type} with {b.type}")
    if a.type == LogicalType.STRING:
        return unify_dictionaries(a, b)
    if a.type == b.type:
        return a, b
    common = np.promote_types(physical_np_dtype(a.type),
                              physical_np_dtype(b.type))
    if common.name not in LogicalType._value2member_map_:
        raise CylonTypeError(f"no common key type for {a.type}/{b.type}")
    lt = LogicalType(common.name)
    return a.cast(lt), b.cast(lt)


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


def check_same_env(a: Table, b: Table) -> CylonEnv:
    if a.env is not b.env and a.env.device != b.env.device:
        raise InvalidError("tables live on different devices")
    return a.env
