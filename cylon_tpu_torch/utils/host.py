"""Device→host pulls (port of ``cylon_tpu/utils/host.py``).

Every pull of a device tensor to the host goes through this module, so the
places where the host waits for the device are few and named.  A CUDA
tensor's ``.cpu()`` waits for the work that feeds it; :func:`sync_pull`
waits for all queued work on the tensor's device.

In a multi-process world (ctx/context.DistributedConfig) a row-sharded
tensor holds only this process's V rank blocks: :func:`host_array` and
:func:`host_arrays` given the world size allgather the other processes'
blocks, so the host sees the whole ``(W·rows, ...)`` array, as the
reference's ``multihost_utils.process_allgather`` gives it
(``cylon_tpu/utils/host.py:33``).  :func:`host_shard_blocks` returns
only this process's blocks, with no collective.

Each pull is noted for the runtime sentinel (analysis/runtime.py,
RT303) while it is active: one check of ``ACTIVE`` otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..analysis import runtime as _sentinel


def _gathered(x: np.ndarray, world: int | None) -> np.ndarray:
    """A pulled row block made whole across the processes of a
    ``world``-rank multi-process world (itself otherwise)."""
    from ..parallel import transport
    proc = None if world is None else transport.current(world)
    if x is None or proc is None or proc.nproc == 1:
        return x
    g = transport.allgather_array(x, "host.allgather")
    return g.reshape((g.shape[0] * g.shape[1],) + g.shape[2:])


def host_array(x, world: int | None = None) -> np.ndarray:
    """A tensor (or numpy array, passed through) as a host numpy array.
    ``world``: ``x`` is row-sharded over a world of that size, and a
    multi-process world gathers every process's blocks."""
    if x is None or isinstance(x, np.ndarray):
        return x
    if _sentinel.ACTIVE:
        _sentinel.note_transfer("host_array")
    return _pull(x, world)


def _pull(x: torch.Tensor, world: int | None) -> np.ndarray:
    return _gathered(x.detach().cpu().numpy(), world)


def _host(x, world: int | None):
    return x if x is None or isinstance(x, np.ndarray) else _pull(x, world)


def host_arrays(xs, world: int | None = None) -> list:
    """:func:`host_array` over a list; ``None`` entries pass through.  The
    copies are queued non-blocking into pinned buffers and waited on once,
    so N pulls cost one device round trip."""
    if _sentinel.ACTIVE and any(isinstance(x, torch.Tensor) for x in xs):
        _sentinel.note_transfer("host_arrays")
    cuda = [x for x in xs if isinstance(x, torch.Tensor) and x.is_cuda]
    if not cuda:
        return [_host(x, world) for x in xs]
    staged = {}
    for x in cuda:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x.detach(), non_blocking=True)
        staged[id(x)] = buf
    torch.cuda.synchronize(cuda[0].device)
    return [_gathered(staged[id(x)].numpy(), world) if id(x) in staged
            else _host(x, world) for x in xs]


def sync_pull(x) -> None:
    """Wait until everything feeding tensor ``x`` has run."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        if _sentinel.ACTIVE:
            _sentinel.note_transfer("sync_pull")
        torch.cuda.synchronize(x.device)


def host_shard_blocks(x: torch.Tensor, w: int, out=None) -> list:
    """Copy a ``(W·rows, ...)`` tensor — W shards, each a row block — to
    host memory and return its W row blocks (views of one host tensor).
    In a multi-process world ``x`` holds this process's V blocks: they
    fill the local ranks' entries and the others stay ``None``, with no
    collective.
    From the card the copy lands in pinned memory (``out`` when given, a
    pinned tensor of ``x``'s shape and dtype, reused across pulls) and is
    waited on; on the CPU it is a copy.  The spill tier's eviction pull
    (exec/memory.py)."""
    if _sentinel.ACTIVE:
        _sentinel.note_transfer("host_shards")
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
    out.copy_(x.detach(), non_blocking=x.is_cuda)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    from ..parallel.shards import span
    sp = span(w)
    v = len(sp)
    blocks = list(out.chunk(v, dim=0)) if x.shape[0] else [out] * v
    if v == w:
        return blocks
    res = [None] * w
    res[sp.start:sp.stop] = blocks
    return res
