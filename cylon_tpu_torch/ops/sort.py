"""Multi-key sort and gather kernels (port of ``cylon_tpu/ops/sort.py``).

The reference sorts with ONE multi-operand ``lax.sort``; torch has no such
call, so the operands fold into int64 words and sort LSD-composed
(``pack.sort_words`` / ``pack.lex_sort_perm``), which is the same stable
lexicographic order.
"""

from __future__ import annotations

import torch

from .pack import KeyOps, lex_sort_perm, sort_words


def sort_permutation(keyops: KeyOps) -> torch.Tensor:
    """Stable argsort (int64) of rows under a lexicographic operand list."""
    return lex_sort_perm(sort_words(keyops))


def take_data(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows; ``idx`` must be in bounds (a permutation/selection)."""
    return data[idx]
