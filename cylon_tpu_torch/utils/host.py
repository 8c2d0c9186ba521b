"""Device→host pulls (port of ``cylon_tpu/utils/host.py``).

Every pull of a device tensor to the host goes through this module, so the
places where the host waits for the device are few and named.  A CUDA
tensor's ``.cpu()`` waits for the work that feeds it; :func:`sync_pull`
waits for all queued work on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch


def host_array(x) -> np.ndarray:
    """A tensor (or numpy array, passed through) as a host numpy array."""
    if x is None or isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().numpy()


def host_arrays(xs) -> list:
    """:func:`host_array` over a list; ``None`` entries pass through.  The
    copies are queued non-blocking into pinned buffers and waited on once,
    so N pulls cost one device round trip."""
    cuda = [x for x in xs if isinstance(x, torch.Tensor) and x.is_cuda]
    if not cuda:
        return [host_array(x) for x in xs]
    staged = {}
    for x in cuda:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x.detach(), non_blocking=True)
        staged[id(x)] = buf
    torch.cuda.synchronize(cuda[0].device)
    return [staged[id(x)].numpy() if id(x) in staged else host_array(x)
            for x in xs]


def sync_pull(x) -> None:
    """Wait until everything feeding tensor ``x`` has run."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def host_shard_blocks(x: torch.Tensor, w: int, out=None) -> list:
    """Copy a ``(W·rows, ...)`` tensor — W shards, each a row block — to
    host memory and return its W row blocks (views of one host tensor).
    From the card the copy lands in pinned memory (``out`` when given, a
    pinned tensor of ``x``'s shape and dtype, reused across pulls) and is
    waited on; on the CPU it is a copy.  The spill tier's eviction pull
    (exec/memory.py)."""
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
    out.copy_(x.detach(), non_blocking=x.is_cuda)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return list(out.chunk(w, dim=0)) if x.shape[0] else [out] * w
