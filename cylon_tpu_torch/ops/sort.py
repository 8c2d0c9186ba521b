"""Multi-key sort, gather and compaction kernels (port of
``cylon_tpu/ops/sort.py``).

The reference sorts with ONE multi-operand ``lax.sort``; torch has no such
call, so the operands fold into int64 words and sort LSD-composed
(``pack.sort_words`` / ``pack.lex_sort_perm``), which is the same stable
lexicographic order.
"""

from __future__ import annotations

import torch

from .pack import SIGNED_VIEW, KeyOps, lex_sort_perm, sort_words


def sort_permutation(keyops: KeyOps) -> torch.Tensor:
    """Stable argsort (int64) of rows under a lexicographic operand list."""
    return lex_sort_perm(sort_words(keyops))


def take_data(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows; ``idx`` must be in bounds (a permutation/selection).
    An unsigned column gathers through its signed view (``SIGNED_VIEW``):
    torch's CUDA gather has no uint16/32/64 kernel."""
    sv = SIGNED_VIEW.get(data.dtype)
    if sv is None:
        return data[idx]
    return data.view(sv)[idx].view(data.dtype)


def take_with_nulls(data: torch.Tensor, validity, idx: torch.Tensor):
    """Gather rows where ``idx == -1`` yields a null (the null side of an
    outer join): the index clamps into range and the validity is
    ``idx >= 0`` (and the source's).  Returns ``(data, validity)``."""
    n = data.shape[0]
    safe = idx.clamp(0, max(n - 1, 0)).long()
    v = idx >= 0
    if validity is not None:
        v = v & validity[safe]
    return data[safe], v


def compact_by_flag(flag: torch.Tensor, out_cap: int):
    """Indices (int32) of the rows with ``flag`` set, in row order, padded
    to ``out_cap`` with -1; plus their count (a 0-dim int32 tensor).
    Sort-free: a flagged row's output position is the exclusive prefix
    sum of the flags, written by one scatter.  Every other row writes to
    a slot of its own past ``out_cap`` (the reference drops them), so no
    two rows write one address."""
    n = flag.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=flag.device)
    fi = flag.to(torch.int32)
    pos = torch.cumsum(fi, 0, dtype=torch.int32) - fi
    total = fi.sum(dtype=torch.int32)
    slot = torch.where(flag & (pos < out_cap), pos, out_cap + idx)
    out = torch.full((out_cap + n,), -1, dtype=torch.int32,
                     device=flag.device)
    return out.scatter_(0, slot.long(), idx)[:out_cap], total
