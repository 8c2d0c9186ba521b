"""Splitter probe — the pipelined join's per-row range assignment
(counterpart of ``cylon_tpu/ops/pallas_probe.py``, TPU kernel K2).

The range-partitioned pipeline (exec/pipeline.py) gives every probe row its
key-range id: the number of the build side's key-group splitters that
compare ``<=`` the row's key tuple.  The contract, kept bit-for-bit from
the TPU kernel: for K parallel ``(cap,)`` key operands and K parallel
``(S,)`` splitter operands, ``out[r]`` (int32) counts the splitters ``j``
whose tuple is lexicographically ``<=`` row ``r``'s — exactly
``sum(pack.rows_ge_splitters(ops, sops), axis=1)``.

Operands are the port's key operands (ops/pack.py): int32 tensors holding
signed values, int64 tensors holding unsigned 32-bit values in [0, 2^32)
(the reference's uint32 operands), and float64 tensors, the ``'f'``
operand of an f64 key (NaNs equal to each other and above +inf, -0.0 equal
to +0.0).  The TPU kernel takes int kinds only and the reference keeps XLA
for ``'f'``; the CUDA kernel takes all three, so every key structure runs
it.

On a CUDA tensor :func:`count_ge_splitters` launches the hand-written
kernel ``kernels/splitter_probe.cu``; on a CPU tensor it runs
:func:`count_ge_splitters_plain`.  There is no other fallback: a build or
launch failure raises :class:`~cylon_tpu_torch.status.KernelError`.
"""

from __future__ import annotations

import ctypes

import torch

from ..status import InvalidError, KernelError
from .pack import KeyOps, rows_ge_splitters

#: ``launches`` counts kernel launches (never plain-version calls).  Reset
#: with :func:`reset_counts`.
COUNTS = {"launches": 0}

_WIDTH_CODE = {torch.int32: 0, torch.int64: 1, torch.float64: 2}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _kinds(ops) -> tuple:
    """The operand kinds of ops/pack.py: a float64 operand is ``'f'``."""
    return tuple("f" if o.dtype == torch.float64 else "i" for o in ops)


def count_ge_splitters_plain(ops: tuple, sops: tuple) -> torch.Tensor:
    """Plain-torch version: the (cap, S) comparison matrix summed per row."""
    ge = rows_ge_splitters(KeyOps(tuple(ops), _kinds(ops)), tuple(sops))
    return ge.sum(dim=1, dtype=torch.int32)


def _launch(ops: tuple, sops: tuple) -> torch.Tensor:
    if not ops or len(ops) != len(sops):
        raise InvalidError("need K >= 1 row operands and K splitter operands")
    dev = ops[0].device
    cap = ops[0].shape[0]
    n_split = sops[0].shape[0]
    for o, so in zip(ops, sops):
        if o.dim() != 1 or o.shape[0] != cap or o.device != dev:
            raise InvalidError("row operands must be 1-D, equal-length, on "
                               "one device")
        if so.dim() != 1 or so.shape[0] != n_split or so.device != dev:
            raise InvalidError("splitter operands must be 1-D, equal-length, "
                               "on the rows' device")
        if o.dtype not in _WIDTH_CODE or so.dtype != o.dtype:
            raise InvalidError(f"operand types {o.dtype}/{so.dtype}: the "
                               "kernel takes int32, int64 (u32) or float64 "
                               "operands, the same type for rows and "
                               "splitters")
    if n_split < 1:
        raise InvalidError("the probe needs at least one splitter")
    ops = tuple(o.contiguous() for o in ops)
    sops = tuple(s.contiguous() for s in sops)
    codes = [_WIDTH_CODE[o.dtype] for o in ops]
    wide = any(c == 2 for c in codes)
    desc_host = torch.tensor(
        [o.data_ptr() for o in ops] + [s.data_ptr() for s in sops]
        + codes + codes, dtype=torch.int64).pin_memory()
    # a pinned, non-blocking upload: the descriptor rides the stream like
    # any kernel, and the splitters stay in device memory — no host wait
    desc = desc_host.to(dev, non_blocking=True)
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    from .. import kernels
    fn = kernels.load("splitter_probe").cylon_count_ge_splitters
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(desc.data_ptr(), len(ops), cap, n_split, int(wide),
            out.data_ptr(), stream)
    if rc != 0:
        smem = 16 * len(ops) + len(ops) * n_split * (8 if wide else 4)
        raise KernelError(
            f"splitter_probe launch failed: cudaError {rc} (K={len(ops)} "
            f"operands x S={n_split} splitters take {smem} bytes of shared "
            "memory)")
    COUNTS["launches"] += 1
    return out


def count_ge_splitters(ops: tuple, sops: tuple) -> torch.Tensor:
    """(cap,) int32: per row, how many splitter tuples compare ``<=`` the
    row's operand tuple (module docstring).  A CUDA tensor launches the
    kernel; a CPU tensor takes :func:`count_ge_splitters_plain`."""
    dev = ops[0].device
    if dev.type == "cuda":
        return _launch(tuple(ops), tuple(sops))
    if dev.type == "cpu":
        return count_ge_splitters_plain(ops, sops)
    raise InvalidError(f"no splitter probe for device {dev}")
