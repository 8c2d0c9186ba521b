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

A launch is two steps: :func:`prepare` checks the operands, picks the
kernel's path (:func:`plan`) and uploads the descriptor; :func:`run`
launches on a prepared probe.  The main path's operands, one or two int32
columns, take :data:`VARIANT_PACKED`: each row's two images form one
64-bit key, so a splitter costs one compare per row.  Every other mix takes
:data:`VARIANT_GENERAL`, a lexicographic count over one row per operand:
an int32 operand's own row where the images are 32-bit, else an image row
that a first kernel writes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..status import InvalidError, KernelError
from .pack import KeyOps, rows_ge_splitters

#: ``launches`` counts kernel launches (never plain-version calls): one a
#: call, two when the general path writes image rows first.  Reset with
#: :func:`reset_counts`.
COUNTS = {"launches": 0}

#: width codes of the descriptor, per operand dtype
_WIDTH_CODE = {torch.int32: 0, torch.int64: 1, torch.float64: 2}
#: the kernel's two paths (kernels/splitter_probe.cu): one or two int32
#: operands as one 64-bit key; every other mix counted lexicographically on
#: 32-bit images, or 64-bit ones when some operand is f64
VARIANT_PACKED, VARIANT_GENERAL = 0, 1
#: rows per vector load group: image rows are padded to it
GROUP = 4


class Plan(NamedTuple):
    """Host-side choices of one launch (:func:`plan`)."""
    variant: int       # VARIANT_PACKED or VARIANT_GENERAL
    k: int
    cap: int
    n_split: int
    vec: bool          # every row operand 16-byte aligned
    image_bytes: int   # bytes per image (0: the packed path)
    image_rows: int    # operands the general path writes an image row for
    image_stride: int  # elements between consecutive image rows
    desc: tuple        # 5K int64 entries (module docstring of the kernel)


class Probe(NamedTuple):
    """A prepared launch: the plan, the descriptor on the device and every
    tensor its pointers name (kept alive with it)."""
    plan: Plan
    desc: torch.Tensor
    ops: tuple
    sops: tuple
    images: torch.Tensor | None


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


def check_operands(ops: tuple, sops: tuple) -> None:
    """Raise :class:`InvalidError` unless ``ops``/``sops`` are K >= 1
    parallel 1-D row operands and K splitter operands (S >= 1) on one
    device, each pair of one type the kernel takes."""
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


def admits(variant: int, ops: tuple) -> bool:
    """Whether ``variant`` can count these row operands: the packed key
    holds one or two int32 operands, the general path every mix."""
    if variant == VARIANT_PACKED:
        return len(ops) <= 2 and all(o.dtype == torch.int32 for o in ops)
    return variant == VARIANT_GENERAL


def plan(ops: tuple, sops: tuple, image_ptr: int = 0,
         variant: int | None = None) -> Plan:
    """The launch's host-side choices, a pure function of the operands'
    types, lengths and addresses: the path (by default
    :data:`VARIANT_PACKED` where it :func:`admits` them, else
    :data:`VARIANT_GENERAL`), whether 16-byte loads serve every row
    operand, the image width, which operands get an image row (all of them
    with 64-bit images, else the non-int32 ones) and the rows' layout, and
    the descriptor.  ``image_ptr`` is the address of the image rows (0
    while they are not allocated yet)."""
    check_operands(ops, sops)
    k, cap, n_split = len(ops), ops[0].shape[0], sops[0].shape[0]
    if variant is None:
        variant = VARIANT_PACKED if admits(VARIANT_PACKED, ops) \
            else VARIANT_GENERAL
    elif not admits(variant, ops):
        raise InvalidError(f"kernel variant {variant} cannot count operands "
                           f"of types {[str(o.dtype) for o in ops]}")
    codes = [_WIDTH_CODE[o.dtype] for o in ops]
    rows = [o.data_ptr() for o in ops]
    count_rows, n_images, stride, image_bytes = list(rows), 0, 0, 0
    if variant == VARIANT_GENERAL:
        image_bytes = 8 if _WIDTH_CODE[torch.float64] in codes else 4
        stride = -(-cap // GROUP) * GROUP
        for i, code in enumerate(codes):
            if image_bytes == 8 or code != _WIDTH_CODE[torch.int32]:
                count_rows[i] = image_ptr + n_images * stride * image_bytes
                n_images += 1
    desc = tuple(rows + [s.data_ptr() for s in sops] + codes + codes
                 + count_rows)
    return Plan(variant, k, cap, n_split, all(p % 16 == 0 for p in rows),
                image_bytes, n_images, stride if n_images else 0, desc)


def splitter_bytes(p: Plan) -> int:
    """Shared memory the count kernel holds the splitter images in."""
    if p.variant == VARIANT_PACKED:
        return 8 * p.n_split
    return p.k * p.n_split * p.image_bytes


def prepare(ops: tuple, sops: tuple, variant: int | None = None) -> Probe:
    """Check the CUDA operands, plan the launch (``variant`` as
    :func:`plan`), allocate the image rows it needs and upload its
    descriptor (pinned, non-blocking: no host wait)."""
    ops = tuple(o.contiguous() for o in ops)
    sops = tuple(s.contiguous() for s in sops)
    p = plan(ops, sops, variant=variant)
    images = None
    if p.image_rows:
        images = torch.empty(p.image_rows * p.image_stride * p.image_bytes,
                             dtype=torch.uint8, device=ops[0].device)
        p = plan(ops, sops, images.data_ptr(), p.variant)
    desc_host = torch.tensor(p.desc, dtype=torch.int64).pin_memory()
    # the descriptor rides the stream like any kernel, and the splitters
    # stay in device memory
    desc = desc_host.to(ops[0].device, non_blocking=True)
    return Probe(p, desc, ops, sops, images)


def run(probe: Probe) -> torch.Tensor:
    """Launch the kernel on a prepared probe: the (cap,) int32 counts."""
    p = probe.plan
    dev = probe.ops[0].device
    out = torch.empty(p.cap, dtype=torch.int32, device=dev)
    from .. import kernels
    fn = kernels.load("splitter_probe").cylon_count_ge_splitters
    rc = fn(probe.desc.data_ptr(), p.k, p.cap, p.n_split, int(p.vec),
            p.image_bytes, int(p.image_rows > 0), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(
            f"splitter_probe launch failed: cudaError {rc} (K={p.k} "
            f"operands x S={p.n_split} splitters take {splitter_bytes(p)} "
            "bytes of shared memory)")
    COUNTS["launches"] += 2 if p.image_rows else 1
    return out


def count_ge_splitters(ops: tuple, sops: tuple) -> torch.Tensor:
    """(cap,) int32: per row, how many splitter tuples compare ``<=`` the
    row's operand tuple (module docstring).  A CUDA tensor launches the
    kernel; a CPU tensor takes :func:`count_ge_splitters_plain`."""
    dev = ops[0].device
    if dev.type == "cuda":
        return run(prepare(tuple(ops), tuple(sops)))
    if dev.type == "cpu":
        return count_ge_splitters_plain(ops, sops)
    raise InvalidError(f"no splitter probe for device {dev}")
