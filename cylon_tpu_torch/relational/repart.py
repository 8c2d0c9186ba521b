"""Row-wise table assembly (port of the world-1 ``concat_tables`` of
``cylon_tpu/relational/repart.py``).  Repartition, slice, head, tail and
filter are slice 8 of ROADMAP.md Queue 1."""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.dtypes import LogicalType
from ..core.table import Table
from ..status import InvalidError
from .common import build_table, promote_key_pair, unify_dictionaries


def concat_tables(tables: list[Table]) -> Table:
    """Row-wise concatenation: the live rows of each table in input order,
    in a ``pow2ceil`` capacity with a zero tail.  String dictionaries are
    unified and numeric types promoted column-wise; bounds merge (with 0,
    since the output tail is padding)."""
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
    vcs = [int(t.valid_counts[0]) for t in tables]
    total = sum(vcs)
    out_cap = config.pow2ceil(total)
    out_d, out_v = [], []
    for cs in col_sets:
        d0 = cs[0].data
        data = torch.zeros(out_cap, dtype=d0.dtype, device=d0.device)
        torch.cat([c.data[:vc] for c, vc in zip(cs, vcs)], out=data[:total])
        out_d.append(data)
        if any(c.validity is not None for c in cs):
            v = torch.zeros(out_cap, dtype=torch.bool, device=d0.device)
            torch.cat([c.validity[:vc] if c.validity is not None
                       else torch.ones(vc, dtype=torch.bool,
                                       device=d0.device)
                       for c, vc in zip(cs, vcs)], out=v[:total])
            out_v.append(v)
        else:
            out_v.append(None)
    bounds = []
    for cs in col_sets:
        bs = [c.bounds for c in cs]
        bounds.append((min(min(b[0] for b in bs), 0),
                       max(max(b[1] for b in bs), 0))
                      if all(b is not None for b in bs) else None)
    return build_table(names, out_d, out_v, [cs[0].type for cs in col_sets],
                       [cs[0].dictionary for cs in col_sets],
                       np.asarray([total], np.int64), env, bounds=bounds)
