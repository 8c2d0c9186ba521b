"""Table and column collectives (port of ``cylon_tpu/parallel/
collectives.py``): all-gather, gather, bcast and allreduce.

On a :class:`~cylon_tpu_torch.ctx.context.VirtualMeshConfig` world every
shard lives in one tensor on one device, so each collective is a
device-local copy or reduction:

* :func:`allgather_table`: each shard's live prefix, in rank order,
  fills one block, and the block is repeated W times — a replicated table
  in the row-sharded layout, as in the reference;
* :func:`gather_table`: a :func:`~cylon_tpu_torch.relational.repart.
  repartition` that puts every row on the root;
* :func:`bcast_table`: the root's block (its live prefix and its
  padding) repeated into every shard's block;
* :func:`allreduce`: each shard's padding masked with the op's identity,
  then one reduction over the ``(W, cap)`` view, returned to the host.

In a multi-process world (ctx/context.DistributedConfig) each process
holds its V ranks' blocks and the collectives cross processes through
parallel/transport.py: the allgather gathers every process's live rows,
the bcast broadcasts the root's block from its process, and the
allreduce reduces each process's ``(V, cap)`` view and then across
processes (``cylon_tpu/parallel/collectives.py:197``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.column import Column
from ..core.table import Table
from ..status import InvalidError
from . import transport
from .shards import local_world, shard, span

_REDUCERS = {"sum": "sum", "min": "amin", "max": "amax"}


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
    ranks = span(w)
    proc = transport.current(w)
    new = []
    for col in flat:
        block = col.new_zeros((out_cap,) + tuple(col.shape[1:]))
        mine = torch.cat([shard(col, w, r)[:int(vc[r])] for r in ranks])
        if proc is not None and proc.nproc > 1:
            mine = _gather_live(proc, mine, vc)
        block[:total] = mine
        del mine
        new.append(block.repeat((len(ranks),) + (1,) * (col.dim() - 1)))
    del flat
    return _rebuild(recipe, new, np.full(w, total, np.int64), env)


def _gather_live(proc, mine: torch.Tensor, vc: np.ndarray) -> torch.Tensor:
    """Every process's live rows (``mine``: its ranks' live prefixes in
    rank order), in process order: one allgather of blocks padded to the
    largest process's row count."""
    per = np.asarray(vc, np.int64).reshape(proc.nproc, proc.local).sum(1)
    m = max(int(per.max()), 1)
    pad = mine.new_zeros((m,) + tuple(mine.shape[1:]))
    pad[:mine.shape[0]] = mine
    g = transport.allgather_tensor(pad, "collectives.allgather")
    return torch.cat([g[p, :int(per[p])] for p in range(proc.nproc)])


def _check_root(root: int, w: int) -> None:
    if root < 0 or root >= w:
        raise InvalidError(f"root {root} out of range for world {w}")


def gather_table(table: Table, root: int = 0) -> Table:
    """Every row onto shard ``root``, in global order (the other shards
    end empty)."""
    from ..relational.repart import repartition
    w = table.env.world_size
    _check_root(root, w)
    dest = [0] * w
    dest[root] = table.row_count
    return repartition(table, tuple(dest))


def bcast_table(table: Table, root: int = 0) -> Table:
    """Shard ``root``'s rows onto every shard: each shard's block becomes
    a copy of the root's, and every shard holds the root's row count."""
    from ..relational.repart import _flatten_for_exchange, _rebuild
    env = table.env
    w = env.world_size
    if w == 1:
        return table
    _check_root(root, w)
    flat, recipe = _flatten_for_exchange(table)
    ranks = span(w)
    proc = transport.current(w)
    new = []
    for col in flat:
        if proc is not None and proc.nproc > 1:
            cap = col.shape[0] // len(ranks)
            blk = shard(col, w, root) if root in ranks \
                else col.new_zeros((cap,) + tuple(col.shape[1:]))
            blk = transport.broadcast(blk.contiguous(), root // proc.local)
        else:
            blk = shard(col, w, root)
        new.append(blk.repeat((len(ranks),) + (1,) * (col.dim() - 1)))
    del flat
    n_root = int(table.valid_counts[root])
    return _rebuild(recipe, new, np.full(w, n_root, np.int64), env)


def _identity(op: str, dtype: torch.dtype):
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def allreduce(column_or_array, op: str = "sum", valid_counts=None,
              world: int | None = None) -> np.ndarray:
    """Reduce each shard's row block elementwise across the shards and
    return the result as a host array of the column's dtype.  Accepts a
    Column or a ``(W·cap,)`` tensor.

    ``valid_counts`` (per-shard live row counts) masks each shard's
    padding with the op's identity (and gives W); without it every slot
    counts, and ``world`` gives W (default 1).  A position live on no
    shard yields the identity."""
    if op not in _REDUCERS:
        raise InvalidError(f"allreduce op must be one of {set(_REDUCERS)}")
    arr = (column_or_array.data if isinstance(column_or_array, Column)
           else column_or_array)
    w = (len(valid_counts) if valid_counts is not None
         else int(world or 1))
    v = local_world(w)
    cap = arr.shape[0] // v
    x = arr.view(v, cap)
    if valid_counts is not None:
        sp = span(w)
        vc = torch.as_tensor(np.asarray(valid_counts, np.int64)[
            sp.start:sp.stop]).to(x.device)
        live = (torch.arange(cap, device=x.device)[None, :] < vc[:, None])
        x = torch.where(live, x, torch.full((), _identity(op, x.dtype),
                                            dtype=x.dtype, device=x.device))
    proc = transport.current(w)
    if proc is not None and proc.nproc > 1:
        # every process's V rows, then one reduction over the W rows in
        # rank order, as one process reduces them
        x = transport.allgather_rows(x.contiguous(),
                                     "collectives.allreduce")
    if op == "sum":
        res = x.sum(dim=0, dtype=x.dtype)
    else:
        res = getattr(x, _REDUCERS[op])(dim=0)
    from ..utils.host import host_array
    return host_array(res)
