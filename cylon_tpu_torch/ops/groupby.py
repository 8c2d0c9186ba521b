"""Groupby kernels (port of the grouped-input subset of
``cylon_tpu/ops/groupby.py``).

* :func:`grouped_reduce` — the grouped-input fast path the fused
  join→groupby runs: per-group sums are differences of prefix sums at the
  run starts, so every cumsum-able aggregate and the representative keys
  share ONE gather of a stacked 32-bit lane matrix (plus one f64 side
  gather for float accumulators, which have no lanes).  With
  ``use_window`` the lane gather goes through the windowed-gather kernel
  (ops/windowed_gather.py).
* The MapReduce stages the slice needs: :func:`combine_locally` (with the
  segment ops under it) and :func:`finalize`.
* :func:`guard_saturation`, the armed int64 overflow guard.

Integer accumulators are int64 and float accumulators float64, as in the
reference with x64 on.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from . import lanes as lanes_mod

#: ops whose intermediates are plain segment reductions
ASSOCIATIVE = {"sum", "count", "min", "max", "mean", "var", "std", "sumsq"}
#: ops that must see raw values
NON_ASSOCIATIVE = {"nunique", "quantile", "median"}
#: ops whose grouped-input fast path avoids scatter reductions entirely
CUMSUMMABLE = {"sum", "count", "mean", "var", "std", "sumsq"}

_I64 = torch.int64
_F64 = torch.float64


# ---------------------------------------------------------------------------
# segment reductions (masked rows route to one trash segment, sliced off)
# ---------------------------------------------------------------------------

def _route(gids, num_segments, mask):
    """(effective gids, total segments): masked rows -> trash segment."""
    if mask is None:
        return gids, num_segments
    return torch.where(mask, gids, num_segments), num_segments + 1


def _ident(kind: str, dt: torch.dtype):
    if kind == "sum":
        return 0
    if dt.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    if dt == torch.bool:
        return kind == "min"
    info = torch.iinfo(dt)
    return info.max if kind == "min" else info.min


def _seg_apply(kind: str, values, g, ns: int, out_len: int):
    """Segment reduce over ROUTED gids ``g`` (trash segment included in
    ``ns``), returning the first ``out_len`` segments; empty segments hold
    the reduction identity."""
    g = g.long()
    if kind == "sum":
        acc = torch.zeros(ns, dtype=values.dtype, device=values.device)
        return acc.index_add_(0, g, values)[:out_len]
    src = values.to(torch.int32) if values.dtype == torch.bool else values
    acc = torch.full((ns,), _ident(kind, values.dtype), dtype=src.dtype,
                     device=values.device)
    red = "amin" if kind == "min" else "amax"
    out = acc.scatter_reduce_(0, g, src, red)[:out_len]
    return out.bool() if values.dtype == torch.bool else out


def seg_sum(values, gids, num_segments, mask=None):
    g, ns = _route(gids, num_segments, mask)
    return _seg_apply("sum", values, g, ns, num_segments)


def seg_count(values, gids, num_segments, mask=None):
    g, ns = _route(gids, num_segments, mask)
    ones = torch.ones(gids.shape[0], dtype=_I64, device=gids.device)
    return _seg_apply("sum", ones, g, ns, num_segments)


def seg_min(values, gids, num_segments, mask=None):
    g, ns = _route(gids, num_segments, mask)
    return _seg_apply("min", values, g, ns, num_segments)


def seg_max(values, gids, num_segments, mask=None):
    g, ns = _route(gids, num_segments, mask)
    return _seg_apply("max", values, g, ns, num_segments)


# ---------------------------------------------------------------------------
# grouped-run reductions
# ---------------------------------------------------------------------------

_GROUPED_NEEDS = {"sum": ("sum",), "count": ("count",),
                  "sumsq": ("sumsq",),
                  "mean": ("sum", "count"),
                  "var": ("sum", "sumsq", "count"),
                  "std": ("sum", "sumsq", "count")}


def grouped_reduce(ops, values_list, vmasks, starts, n_live, key_datas,
                   key_valids, seg_cap: int, key_narrow=None,
                   value_narrow=None, use_window: int = 0):
    """Grouped-input fast path, fully batched.

    For contiguous runs, group g's sum over x is PS[starts[g+1]] -
    PS[starts[g]], with PS the zero-padded exclusive prefix of x and slots
    past the last group holding ``n_live`` — so ONE (seg_cap, L) gather of
    the stacked prefix lanes at ``starts`` plus a consecutive diff serves
    every op.  int64 prefixes split into (hi, lo) lanes; counts, and sums
    proven narrow by ``value_narrow[i]``, take one lane.  Key columns and
    their validity ride the same gather; ``key_narrow[i]`` rides a 64-bit
    key as one lane.

    ``use_window`` (a window size, 0 = off) routes the lane gather through
    ops/windowed_gather.  Returns ``(inter dicts per op, key_out tuple,
    kval_out tuple, win_ok)``; win_ok is a 0-dim bool tensor, False when a
    window overflowed (results are then garbage and the dispatch layer
    reruns with use_window=0)."""
    n = key_datas[0].shape[0]
    dev = key_datas[0].device

    u32_cols: list = []    # (n+1,) int32 lane tensors
    f64_cols: list = []    # (n+1,) f64 tensors (side channel)
    recipes: list = []     # (kind, slot, name, space, lane_ids, meta)

    def prefix_lanes(src, islot, name):
        if src.dtype.is_floating_point:
            ps = torch.cat([torch.zeros(1, dtype=_F64, device=dev),
                            torch.cumsum(src.to(_F64), 0)])
            f64_cols.append(ps)
            recipes.append(("prefix", islot, name, "f64",
                            (len(f64_cols) - 1,), None))
            return
        ps = torch.cat([torch.zeros(1, dtype=_I64, device=dev),
                        torch.cumsum(src, 0, dtype=_I64)])
        narrow = name == "count" or (
            name == "sum" and value_narrow is not None
            and bool(value_narrow[islot]))
        ls = lanes_mod._to_lanes(ps, narrow)   # 1 lane narrow, else (hi, lo)
        del ps
        u32_cols.extend(ls)
        recipes.append(("prefix", islot, name, "u32",
                        tuple(range(len(u32_cols) - len(ls),
                                    len(u32_cols))),
                        ("int64", narrow)))

    def pass_lanes(src, kind, kslot):
        """Passthrough (gathered at start, no diff): key data / validity."""
        ext = torch.cat([src, src[-1:]])
        dt = ext.dtype
        dt_name = str(dt).replace("torch.", "")
        if dt == _F64:
            f64_cols.append(ext)
            recipes.append((kind, kslot, None, "f64",
                            (len(f64_cols) - 1,), ("float64", False)))
            return
        nrw = key_narrow is not None and kind == "key" \
            and bool(key_narrow[kslot]) and dt.itemsize == 8 \
            and not dt.is_floating_point
        ls = lanes_mod._to_lanes(ext, nrw)
        u32_cols.extend(ls)
        recipes.append((kind, kslot, None, "u32",
                        tuple(range(len(u32_cols) - len(ls),
                                    len(u32_cols))), (dt_name, nrw)))

    for i, op in enumerate(ops):
        vm = vmasks[i] if vmasks[i] is not None \
            else torch.ones(n, dtype=torch.bool, device=dev)
        v = values_list[i]
        f = v.to(_F64) if (op in ("mean", "var", "std", "sumsq")
                           or v.dtype.is_floating_point) else v
        for name in _GROUPED_NEEDS[op]:
            if name == "count":
                src = vm.to(torch.int32)
            elif name == "sum":
                src = torch.where(vm, f, torch.zeros((), dtype=f.dtype,
                                                     device=dev))
            else:
                src = torch.where(vm, f * f, torch.zeros((), dtype=f.dtype,
                                                         device=dev))
            prefix_lanes(src, i, name)
            del src
    for ki, (d, v) in enumerate(zip(key_datas, key_valids)):
        pass_lanes(d, "key", ki)
        if v is not None:
            pass_lanes(v, "kval", ki)

    tail_at = min(int(n_live), n)
    starts_l = starts.long()

    def gather_pair(cols):
        mat = torch.stack(cols, dim=1)                 # (n+1, L)
        g = mat[starts_l]                              # THE gather
        # "next start" of slot seg_cap-1 is n_live (PS there = full total)
        g_next = torch.cat([g[1:], mat[tail_at:tail_at + 1]], dim=0)
        return g, g_next

    win_ok = torch.ones((), dtype=torch.bool, device=dev)
    windowed = False
    if use_window and u32_cols:
        from . import windowed_gather as wg
        windowed = wg.supported(n + 1, seg_cap, len(u32_cols), use_window)
    g_u = gn_u = g_f = gn_f = None
    if windowed:
        # lane-major stack: rows are lanes, so the kernel reads each lane
        # row at the run starts
        mat_t = torch.stack(u32_cols, dim=0)
        u32_cols.clear()
        g_u, win_ok = wg.windowed_take_t(mat_t, starts, use_window)
        gn_u = torch.cat([g_u[:, 1:], mat_t[:, tail_at:tail_at + 1]], dim=1)
        del mat_t
    elif u32_cols:
        g_u, gn_u = gather_pair(u32_cols)
        u32_cols.clear()
    if f64_cols:
        g_f, gn_f = gather_pair(f64_cols)
        f64_cols.clear()

    def ucol(li, at_next: bool):
        src = gn_u if at_next else g_u
        return src[li] if windowed else src[:, li]

    def prefix_recon(lane_ids, meta, at_next: bool):
        """Gathered prefix lanes -> accumulator value (i64/f64)."""
        if meta is None:  # f64 side channel
            return (gn_f if at_next else g_f)[:, lane_ids[0]]
        dt_name, nrw = meta
        return lanes_mod._from_lanes([ucol(li, at_next) for li in lane_ids],
                                     dt_name, nrw)

    inters = [dict() for _ in ops]
    key_out = [None] * len(key_datas)
    kval_out = [None] * len(key_datas)
    for kind, slot, name, space, lane_ids, meta in recipes:
        if kind == "prefix":
            d = prefix_recon(lane_ids, meta, True) \
                - prefix_recon(lane_ids, meta, False)
            if name == "count":
                d = d.to(_I64)
            inters[slot][name] = d
        else:
            dt_name, nrw = meta
            if space == "f64":
                v = g_f[:, lane_ids[0]]
            else:
                v = lanes_mod._from_lanes([ucol(li, False)
                                           for li in lane_ids],
                                          dt_name, nrw)
            if kind == "key":
                key_out[slot] = v
            else:  # validity lanes are always planned as bool
                kval_out[slot] = v
    return inters, tuple(key_out), tuple(kval_out), win_ok


# ---------------------------------------------------------------------------
# MapReduce stages (reference mapreduce.hpp:56-76)
# ---------------------------------------------------------------------------

def combine_locally(op: str, values, gids, num_segments, mask=None):
    """Stage 1: per-group intermediates on local rows, each of length
    ``num_segments``."""
    if op == "sum":
        return {"sum": seg_sum(values, gids, num_segments, mask)}
    if op == "count":
        return {"count": seg_count(values, gids, num_segments, mask)}
    if op == "min":
        return {"min": seg_min(values, gids, num_segments, mask),
                "count": seg_count(values, gids, num_segments, mask)}
    if op == "max":
        return {"max": seg_max(values, gids, num_segments, mask),
                "count": seg_count(values, gids, num_segments, mask)}
    if op == "mean":
        f = values.to(_F64)
        return {"sum": seg_sum(f, gids, num_segments, mask),
                "count": seg_count(values, gids, num_segments, mask)}
    if op in ("var", "std"):
        f = values.to(_F64)
        return {"sum": seg_sum(f, gids, num_segments, mask),
                "sumsq": seg_sum(f * f, gids, num_segments, mask),
                "count": seg_count(values, gids, num_segments, mask)}
    if op == "sumsq":
        f = values.to(_F64)
        return {"sumsq": seg_sum(f * f, gids, num_segments, mask)}
    raise ValueError(f"op {op} has no associative decomposition")


def finalize(op: str, inter: dict, ddof: int = 1):
    """Stage 5: intermediates -> (result_values, result_validity|None)."""
    cnt = inter.get("count")
    if op in ("sum", "sumsq", "count"):
        return inter[op], None
    if op in ("min", "max"):
        return inter[op], (cnt > 0) if cnt is not None else None
    if op == "mean":
        c = cnt.clamp_min(1).to(inter["sum"].dtype)
        return inter["sum"] / c, cnt > 0
    if op in ("var", "std"):
        c = cnt.clamp_min(1).to(inter["sum"].dtype)
        mean = inter["sum"] / c
        var = (inter["sumsq"] / c - mean * mean).clamp_min(0.0)
        denom = (cnt - ddof).clamp_min(1).to(var.dtype)
        var = var * (c / denom)
        ok = cnt > ddof
        return (torch.sqrt(var) if op == "std" else var), ok
    raise ValueError(f"unknown associative op {op}")


def np_result_dtype(op: str, src: np.dtype) -> np.dtype:
    if op in ("count", "nunique"):
        return np.dtype(np.int64)
    if op in ("mean", "var", "std", "sumsq", "quantile", "median"):
        # float32 in -> float32 out (pandas parity); everything else f64
        return (np.dtype(np.float32) if src == np.dtype(np.float32)
                else np.dtype(np.float64))
    return np.dtype(src)


#: int64 accumulators past this magnitude count as saturated (headroom for
#: one more combine doubling; the +-rail form avoids abs(INT64_MIN))
SATURATION_RAIL = 1 << 62


def guard_saturation(op: str, data, *, column=None,
                     site: str = "groupby.finalize") -> None:
    """Armed overflow guard (``CYLON_TPU_TORCH_AUDIT=1``): an int64
    ``sum``/``count`` past the rail raises
    :class:`~cylon_tpu_torch.status.NumericOverflowError` instead of
    publishing a wrapped answer.  Unarmed: one env read."""
    if not config.audit_armed() or op not in ("sum", "count"):
        return
    if not isinstance(data, torch.Tensor) or data.dtype != _I64 \
            or not data.numel():
        return
    hi, lo = int(data.max()), int(data.min())
    if hi > SATURATION_RAIL or lo < -SATURATION_RAIL:
        from ..status import NumericOverflowError
        raise NumericOverflowError(
            f"groupby {op} accumulator saturated int64 (|value| > 2**62; "
            f"max={hi}, min={lo}): the aggregate has wrapped or is one "
            "combine away from wrapping — aborting instead of returning "
            "a silently wrong answer", site=site, column=column)
