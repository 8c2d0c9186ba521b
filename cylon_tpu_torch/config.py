"""Configuration for cylon_tpu_torch: the subset of ``cylon_tpu/config.py``
that the join→fused-groupby path reads, under ``CYLON_TPU_TORCH_*``
environment names.

PyTorch holds int64/float64 natively, so there is no x64 switch: device
columns always keep their 64-bit types.
"""

from __future__ import annotations

import os


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v not in ("0", "false", "False", "")


#: Shape-family canonicalization at ingest: a world-1 table's capacity is
#: padded to its ``pow2ceil`` bucket with a masked tail, exactly as the
#: reference does (``cylon_tpu/exec/compiler.family_cap``), so both
#: packages hold the same capacities and padding.  ``=0`` keeps the exact
#: row count.
SHAPE_FAMILIES = _env_flag("CYLON_TPU_TORCH_SHAPE_FAMILIES", True)

#: Defer inner-join output materialization so a same-key groupby can
#: consume the pre-expansion sorted state (relational/fused.py); any other
#: access materializes transparently.
DEFER_JOIN = _env_flag("CYLON_TPU_TORCH_DEFER_JOIN", True)

#: Route large dense grouped-reduce gathers through the windowed-gather
#: CUDA kernel (ops/windowed_gather.py) on the card; span overflows
#: redispatch the plain gather.
WINDOWED_GATHER = _env_flag("CYLON_TPU_TORCH_WINDOWED_GATHER", True)


def audit_armed() -> bool:
    """``CYLON_TPU_TORCH_AUDIT=1`` arms the int64 saturation guard on
    groupby results (ops/groupby.guard_saturation).  Read on every call so
    tests can arm it with ``monkeypatch.setenv``."""
    return os.environ.get("CYLON_TPU_TORCH_AUDIT", "") not in ("", "0")


def pow2ceil(n: int) -> int:
    """Bucket a dynamic capacity to the next 2^(b-5) step for n in
    (2^(b-1), 2^b] (exact powers of two up to 16Ki): 16 steps per octave,
    worst-case overshoot 6.25%.  Same buckets as the reference, so both
    packages pick identical capacities."""
    n = max(int(n), 1)
    if n <= 16384:
        return 1 << (n - 1).bit_length()
    step = 1 << ((n - 1).bit_length() - 5)
    return -(-n // step) * step


def family_cap(n: int) -> int:
    """The canonical row capacity of a world-1 ingest of ``n`` rows: its
    ``pow2ceil`` bucket while shape families are on, else ``n``."""
    n = int(n)
    if n <= 0 or not SHAPE_FAMILIES:
        return max(n, 0)
    return pow2ceil(n)
