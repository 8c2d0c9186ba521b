"""32-bit lane matrices: move many columns in ONE gather (port of
``cylon_tpu/ops/lanes.py``).

Every laneable column is split into 32-bit lanes, stacked into one
``(n, L)`` matrix, moved by one gather or carried as sort payload, and
unpacked after:

  * int64/uint64/datetime64 -> 2 lanes (hi, lo), or 1 sign-carrying lane
    when host-known bounds fit int32 (``narrow``);
  * int32/uint32/float32/int16/int8/string codes/bool -> 1 lane;
  * validity masks -> bit-packed, 32 columns per lane;
  * float64 -> no lane (a side column moved as a raw f64 tensor), as in
    the reference, so both packages plan identical layouts.

Lanes are held as ``torch.int32`` tensors carrying the reference's uint32
bit patterns (torch's uint32 arithmetic is incomplete).  Bitcasts
round-trip exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.dtypes import torch_dtype

_LO32 = 0xFFFFFFFF


class ColLanes(NamedTuple):
    """Static description of one column's slot in the lane matrix."""
    dtype: str       # numpy dtype name of the column data
    lanes: tuple     # lane indices (1 or 2 entries; 64-bit = (hi, lo));
                     # empty tuple = non-laneable (f64 side column)
    valid_bit: int   # bit position in the validity lane block, or -1
    narrow: bool = False  # 64-bit int whose bounds fit int32: ONE lane


class LaneSpec(NamedTuple):
    cols: tuple          # tuple[ColLanes]
    n_lanes: int         # total lanes incl. validity lanes
    valid_lane0: int     # first validity lane index (== n_lanes if none)


def plan_lanes(dtypes, has_valid, narrow=None) -> LaneSpec:
    """Static lane layout for columns of ``dtypes`` (numpy dtype names);
    ``has_valid[i]`` marks nullable columns, ``narrow[i]`` packs a 64-bit
    integer column as one lane.  float64 columns get no lanes."""
    cols = []
    lane = 0
    vbit = 0
    for i, (dt, hv) in enumerate(zip(dtypes, has_valid)):
        ndt = np.dtype(dt)
        nrw = bool(narrow[i]) if narrow is not None else False
        nrw = nrw and ndt.itemsize == 8 and ndt.kind in ("i", "u")
        if ndt.itemsize == 8 and np.issubdtype(ndt, np.floating):
            lanes = ()
        else:
            width = 1 if (ndt.itemsize < 8 or nrw) else 2
            lanes = tuple(range(lane, lane + width))
            lane += width
        cols.append(ColLanes(dt, lanes, vbit if hv else -1, nrw))
        if hv:
            vbit += 1
    valid_lane0 = lane
    n_valid_lanes = (vbit + 31) // 32
    return LaneSpec(tuple(cols), lane + n_valid_lanes, valid_lane0)


def _to_lanes(x: torch.Tensor, narrow: bool = False) -> list:
    """Column tensor -> list of int32 lane tensors (hi, lo for 64-bit
    ints; f64 never reaches here)."""
    dt = x.dtype
    if dt == torch.bool:
        return [x.to(torch.int32)]
    if dt.itemsize == 8:
        if narrow:  # bounds fit int32: one sign-carrying lane
            return [x.to(torch.int32)]
        xi = x.view(torch.int64) if dt == torch.uint64 else x.to(torch.int64)
        # .to(int32) keeps the low 32 bits: hi = bits 32..63 whether the
        # shift is arithmetic or logical
        return [(xi >> 32).to(torch.int32), (xi & _LO32).to(torch.int32)]
    if dt.is_floating_point:  # f32 (f16/bf16 widened first)
        return [x.to(torch.float32).view(torch.int32)]
    if dt == torch.uint32:
        return [x.view(torch.int32)]
    return [x.to(torch.int32)]


def _from_lanes(lanes, dtype: str, narrow: bool = False) -> torch.Tensor:
    dt = np.dtype(dtype)
    tdt = torch_dtype(dt)
    if dt == np.bool_:
        return lanes[0] != 0
    if dt.itemsize == 8:
        if narrow:
            x = lanes[0].to(torch.int64)
        else:
            hi, lo = lanes
            x = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & _LO32)
        return x.view(tdt) if tdt == torch.uint64 else x.to(tdt)
    if np.issubdtype(dt, np.floating):
        return lanes[0].view(torch.float32).to(tdt)
    if dt == np.uint32:
        return lanes[0].view(torch.uint32)
    if np.issubdtype(dt, np.signedinteger):
        return lanes[0].to(tdt)
    return (lanes[0].to(torch.int64) & _LO32).to(tdt)


def pack_lanes(spec: LaneSpec, datas, valids) -> torch.Tensor:
    """(n, spec.n_lanes) int32 lane matrix from parallel column tensors
    (laneless f64 columns contribute only their validity bit)."""
    n = datas[0].shape[0]
    dev = datas[0].device
    lanes = [None] * spec.n_lanes
    n_valid_lanes = spec.n_lanes - spec.valid_lane0
    vlanes = [torch.zeros(n, dtype=torch.int32, device=dev)
              for _ in range(n_valid_lanes)]
    for col, d, v in zip(spec.cols, datas, valids):
        if col.lanes:
            for li, arr in zip(col.lanes, _to_lanes(d, col.narrow)):
                lanes[li] = arr
        if col.valid_bit >= 0:
            vb = torch.ones(n, dtype=torch.int32, device=dev) if v is None \
                else v.to(torch.int32)
            slot = col.valid_bit // 32
            vlanes[slot] = vlanes[slot] | (vb << (col.valid_bit % 32))
    for i, vl in enumerate(vlanes):
        lanes[spec.valid_lane0 + i] = vl
    return torch.stack(lanes, dim=1)


def unpack_lanes(spec: LaneSpec, mat: torch.Tensor):
    """Inverse of :func:`pack_lanes`: (datas, valids) tuples — laneless
    (f64) columns yield None data; valids entries are None for columns
    planned without validity."""
    datas, valids = [], []
    for col in spec.cols:
        if col.lanes:
            datas.append(_from_lanes([mat[:, li] for li in col.lanes],
                                     col.dtype, col.narrow))
        else:
            datas.append(None)
        if col.valid_bit >= 0:
            vl = mat[:, spec.valid_lane0 + col.valid_bit // 32]
            valids.append(((vl >> (col.valid_bit % 32)) & 1) != 0)
        else:
            valids.append(None)
    return tuple(datas), tuple(valids)


def gather_laneless(spec: LaneSpec, datas, take) -> dict:
    """{col_index: gathered data} for ONLY the laneless (f64) columns of
    ``spec``, by take index (entries < 0 select row 0)."""
    idxs = [i for i, c in enumerate(spec.cols) if not c.lanes]
    if not idxs:
        return {}
    n = datas[idxs[0]].shape[0]
    sel = take.clamp(0, max(n - 1, 0)).long()
    if len(idxs) == 1:
        return {idxs[0]: datas[idxs[0]][sel]}
    fmat = torch.stack([datas[i] for i in idxs], dim=1)[sel]
    return {i: fmat[:, j] for j, i in enumerate(idxs)}


def gather_columns(spec: LaneSpec, datas, valids, take):
    """Move whole rows by index: ONE (n, L) lane-matrix gather for every
    laneable column + validity, plus one f64 gather for the laneless
    columns.  ``take`` entries < 0 select row 0 (callers mask them)."""
    if not spec.cols:
        return (), ()
    n = datas[0].shape[0]
    sel = take.clamp(0, max(n - 1, 0)).long()
    if spec.n_lanes:
        mat = pack_lanes(spec, datas, valids)
        out_d, out_v = unpack_lanes(spec, mat[sel])
        out_d, out_v = list(out_d), list(out_v)
    else:
        out_d = [None] * len(spec.cols)
        out_v = [None] * len(spec.cols)
    for i, d in gather_laneless(spec, datas, take).items():
        out_d[i] = d
    return tuple(out_d), tuple(out_v)
