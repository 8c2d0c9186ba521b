"""Row hashing for hash partitioning (port of ``cylon_tpu/ops/hashing.py``).

Bit-identical to the reference's pure-uint32 murmur3-finalizer pipeline,
so a hash shuffle sends every row to the same rank in both packages:

* every key column splits into one or two u32 lanes — 64-bit integers
  as (lo, hi), in that order; signed integers narrower than 64 bits
  sign-extend to int32 and reinterpret; floats canonicalize -0.0 to +0.0
  and every NaN to one NaN, float64 DOWNCAST to float32, then bitcast;
  bool is 0/1;
* the reference's float steps run under XLA's flush-to-zero arithmetic,
  and the port states it explicitly: a subnormal compares equal to 0
  (so it canonicalizes to +0.0), and a float64 whose float32 image is
  tiny — below 2^-126 once rounded with an unbounded exponent, i.e.
  ``|x| < 2^-126 - 2^-151`` — downcasts to a zero of its own sign;
* a null row's lane is ``0xDEADBEEF``, so null == null;
* the seed is ``0x9E3779B9``.

torch has no usable uint32 ``+``, ``>>`` or ``%``, so the arithmetic runs
in int64 holding [0, 2^32): every product and sum is masked back to 32
bits, and int64 wraparound of a product keeps its low 32 bits intact.
The hashes come back as int64 tensors holding u32 values.  Plain
PyTorch: the reference hashes in XLA, not in a Pallas kernel.
"""

from __future__ import annotations

import torch

_GOLD = 0x9E3779B9
_M32 = 0xFFFFFFFF
_NULL_LANE = 0xDEADBEEF
#: the smallest normal float32 / float64: below them XLA reads a zero
_F32_MIN = 2.0 ** -126
_F64_MIN = 2.0 ** -1022
#: float64 magnitudes whose float32 image is tiny (flushed to zero)
_F32_TINY = 2.0 ** -126 - 2.0 ** -151


def _mix32(z: torch.Tensor) -> torch.Tensor:
    """murmur3's fmix32 over int64 tensors holding u32 values."""
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & _M32
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & _M32
    return z ^ (z >> 16)


def _u32_lanes(x: torch.Tensor) -> list:
    """One or two int64 tensors holding the column's u32 lanes,
    equal-preserving (module docstring)."""
    dt = x.dtype
    if dt == torch.bool:
        return [x.to(torch.int64)]
    if dt.is_floating_point:
        zero = {torch.float32: _F32_MIN, torch.float64: _F64_MIN}.get(dt)
        x = torch.where(x == 0 if zero is None else x.abs() < zero, 0.0, x)
        x = torch.where(torch.isnan(x), float("nan"), x)
        y = x.to(torch.float32)
        if dt == torch.float64:
            y = torch.where(x.abs() < _F32_TINY,
                            torch.copysign(torch.zeros((), device=y.device),
                                           y), y)
        return [y.view(torch.int32).to(torch.int64) & _M32]
    if dt.itemsize == 8:
        xi = x.view(torch.int64) if dt == torch.uint64 else x
        return [xi & _M32, (xi >> 32) & _M32]
    if dt in (torch.uint8, torch.uint16, torch.uint32):
        return [x.to(torch.int64)]
    # signed narrower ints: sign-extend, then the int32 bits as u32
    return [x.to(torch.int64) & _M32]


def hash_rows(datas, validities=None, seed: int = _GOLD) -> torch.Tensor:
    """Combined avalanche hash of each row's key tuple: an int64 tensor
    holding the reference's u32 values.  Nulls hash to a fixed lane."""
    n = datas[0].shape[0]
    h = torch.full((n,), seed & _M32, dtype=torch.int64,
                   device=datas[0].device)
    for i, d in enumerate(datas):
        v = validities[i] if validities is not None else None
        for lane in _u32_lanes(d):
            if v is not None:
                lane = torch.where(v, lane, _NULL_LANE)
            h = _mix32(h ^ ((lane + _GOLD + (h << 6) + (h >> 2)) & _M32))
    return h


def partition_targets(h: torch.Tensor, world: int) -> torch.Tensor:
    """Row -> destination rank in [0, world) as int32: the mask for a
    power-of-two world, else the unsigned modulo."""
    if (world & (world - 1)) == 0:
        return (h & (world - 1)).to(torch.int32)
    return (h % world).to(torch.int32)


def partition_of(h: int, world: int) -> int:
    """Host mirror of :func:`partition_targets` for ONE u32 hash."""
    h = int(h) & _M32
    if (world & (world - 1)) == 0:
        return h & (world - 1)
    return h % world
