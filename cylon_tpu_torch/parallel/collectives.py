"""Table collectives (port of ``allgather_table`` of
``cylon_tpu/parallel/collectives.py``).

On a :class:`~cylon_tpu_torch.ctx.context.VirtualMeshConfig` world every
shard lives in one tensor on one device, so the all-gather is a
device-local copy: each shard's live prefix, in rank order, fills one
block, and the block is repeated W times.  The result is a replicated
table in the row-sharded layout, as in the reference.  Gather, bcast and
allreduce come with the multi-card transport (ROADMAP.md, slice 3's
remainder).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.table import Table
from .shards import shard


def allgather_table(table: Table) -> Table:
    """Every shard receives every row: each shard's valid prefix is the
    full global row set in (source rank, source position) order, at
    capacity ``pow2ceil(total)`` with a zero tail."""
    from ..relational.repart import _flatten_for_exchange, _rebuild
    env = table.env
    w = env.world_size
    if w == 1:
        return table
    vc = np.asarray(table.valid_counts, np.int64)
    total = int(vc.sum())
    out_cap = config.pow2ceil(max(total, 1))
    flat, recipe = _flatten_for_exchange(table)
    new = []
    for col in flat:
        block = col.new_zeros((out_cap,) + tuple(col.shape[1:]))
        torch.cat([shard(col, w, r)[:int(vc[r])] for r in range(w)],
                  out=block[:total])
        new.append(block.repeat((w,) + (1,) * (col.dim() - 1)))
    del flat
    return _rebuild(recipe, new, np.full(w, total, np.int64), env)
