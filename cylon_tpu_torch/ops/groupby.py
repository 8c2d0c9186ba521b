"""Groupby kernels (port of ``cylon_tpu/ops/groupby.py``).

* Segment reductions (``seg_sum``/``seg_count``/``seg_min``/``seg_max``):
  masked rows route to one trash segment and ids past the segment space
  are dropped, as the reference's segment ops drop them, so a dispatch
  at too small a segment space stays in bounds (its group count then
  triggers the redispatch).  Empty segments hold the reduction identity.
* :func:`grouped_reduce` — the grouped-input fast path: per-group sums
  are differences of prefix sums at the run starts
  (:func:`grouped_starts`), so every cumsum-able aggregate and the
  representative keys share ONE gather of their 32-bit lanes (plus one
  f64 side gather for float accumulators, which have no lanes).  With
  ``use_window`` the lane gather goes through the windowed-gather kernel
  (ops/windowed_gather.py), which takes the lanes by pointer, unstacked;
  only the fused join→groupby asks for it.
* The MapReduce stages: :func:`combine_locally`,
  :func:`reduce_intermediates` and :func:`finalize`.
* The non-associative ops on raw values: :func:`nunique` and
  :func:`quantile`; and :func:`group_first_index`.
* :func:`guard_saturation`, the armed int64 overflow guard.

Integer accumulators are int64 and float accumulators float64, as in the
reference with x64 on (its ``_ftype`` is float64 there, for float32 input
too; results are cast to the declared dtype afterwards).

Float sums on the card add in one fixed order (:func:`cumsum_f64`, and
``index_put_`` with ``accumulate`` in the segment sum, which sorts its
indices), so a query gives the same float bits on every run — what the
serving tier's promise of an answer equal to the solo run needs.  torch's
1-D CUDA ``cumsum`` and ``index_add_`` combine float partials in an order
that varies from run to run.  On the CPU both keep torch's sequential
order, the reference's.  :func:`grouped_reduce` scans all its float
prefixes in one batched call, so the fixed order costs the host no more
launches than a ``cumsum`` per column did.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import config
from . import lanes as lanes_mod
from .pack import SIGNED_VIEW

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


#: the int64 sign bit: flipping it maps uint64 order onto int64 order
_SIGN64 = -(1 << 63)


def _order_image(values: torch.Tensor) -> torch.Tensor:
    """An exact int64 image of unsigned values with the same order (torch
    has no min/max scatter for uint16/32/64): zero-extended, or for
    uint64 the bits with the sign bit flipped."""
    if values.dtype == torch.uint64:
        return values.view(torch.int64) ^ _SIGN64
    return values.to(torch.int64)


def _from_image(img: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    if dt == torch.uint64:
        return (img ^ _SIGN64).view(torch.uint64)
    return img.to(dt)


#: rows per block of :func:`cumsum_f64`'s scan on the card
SCAN_BLOCK = 1024


def cumsum_f64(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last dimension of a float tensor
    (each row of a 2-D one its own scan), in one fixed order on the card
    (:func:`_blocked_cumsum` at :data:`SCAN_BLOCK`).  On the CPU,
    ``torch.cumsum``, sequential along each row."""
    if not x.is_cuda:
        return torch.cumsum(x, -1)
    return _blocked_cumsum(x, SCAN_BLOCK)


def _blocked_cumsum(x: torch.Tensor, block: int) -> torch.Tensor:
    """Inclusive prefix sums along the last dimension of ``x``: each
    block of ``block`` elements is scanned along the inner dimension of a
    ``(..., blocks, block)`` view (a scan per row, whose order does not
    vary on the card), then gets the prefix of the block totals before
    it, computed the same way."""
    n = int(x.shape[-1])
    m = -(-n // block)               # the blocks that hold elements
    # at least two rows: a one-row view would take the 1-D device scan
    nb = max(2, m)
    lead = tuple(x.shape[:-1])
    inner = torch.cumsum(F.pad(x, (0, nb * block - n)).view(
        *lead, nb, block), -1)
    if m > 1:
        # the exclusive prefix of the block totals, zero past the last
        offs = _blocked_cumsum(inner[..., :m - 1, -1], block)
        inner += F.pad(offs, (1, nb - m)).unsqueeze(-1)
    return inner.view(*lead, nb * block)[..., :n]


def _seg_apply(kind: str, values, g, ns: int, out_len: int):
    """Segment reduce over ROUTED gids ``g`` (trash segment included in
    ``ns``), returning the first ``out_len`` segments; empty segments hold
    the reduction identity.  Ids at or past ``ns`` are dropped (one more
    slot takes them)."""
    g = torch.where(g < ns, g, ns).long()
    dt = values.dtype
    if kind == "sum":
        acc = torch.zeros(ns + 1, dtype=dt, device=values.device)
        if values.is_cuda and dt.is_floating_point:
            # the sorted accumulation: one order on every run
            return acc.index_put_((g,), values, accumulate=True)[:out_len]
        return acc.index_add_(0, g, values)[:out_len]
    ident = torch.full((), _ident(kind, dt), dtype=dt)
    if dt == torch.bool:
        src, ident = values.to(torch.int32), ident.to(torch.int32)
    elif dt in SIGNED_VIEW:
        src, ident = _order_image(values), _order_image(ident)
    else:
        src = values
    acc = ident.to(values.device).expand(ns + 1).clone()
    red = "amin" if kind == "min" else "amax"
    out = acc.scatter_reduce_(0, g, src, red)[:out_len]
    if dt == torch.bool:
        return out.bool()
    return _from_image(out, dt) if dt in SIGNED_VIEW else out


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

def grouped_starts(gids, first, mask, n_live: int, seg_cap: int):
    """First live row position (int32) of each group id of a grouped
    input (each group one contiguous run in the live prefix, ids counting
    the run starts).  Slots past the last group hold ``n_live``: both the
    empty-group sentinel and the "next start" of the final group, so every
    run extent is a consecutive difference of this one array.

    The reference scatters each run start to its id.  Here group g's
    start is the first position where the running count of run starts
    reaches g + 1: one sorted search, with no scatter of the other rows
    into a trash slot (on the card, millions of writes to one address
    serialize).  ``gids`` is the reference's argument, not needed."""
    del gids
    csum = torch.cumsum(first & mask, 0, dtype=torch.int32)
    q = torch.arange(1, seg_cap + 1, dtype=torch.int32, device=csum.device)
    return torch.searchsorted(csum, q).clamp_max(int(n_live)).to(torch.int32)


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
    the prefix lanes at ``starts`` plus a consecutive diff serves
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
    f64_srcs: list = []    # (f64_cols slot, source) of the float prefixes

    def prefix_lanes(src, islot, name):
        if src.dtype.is_floating_point:
            # its slot now, its prefix from the one batched scan below
            f64_srcs.append((len(f64_cols), src.to(_F64)))
            f64_cols.append(None)
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
        # one more row, as the prefix lanes have (zero on an empty shard)
        ext = torch.cat([src, src[-1:] if n else src.new_zeros(1)])
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
    if f64_srcs:
        # every float prefix in one scan, the zero row in front
        slots = [slot for slot, _ in f64_srcs]
        stacked = torch.stack([x for _, x in f64_srcs])
        f64_srcs.clear()
        ps = F.pad(cumsum_f64(stacked), (1, 0))
        del stacked
        for j, slot in enumerate(slots):
            f64_cols[slot] = ps[j]
        del ps
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
        # the kernel reads the lanes by pointer: no (L, n+1) stack
        g_u, win_ok = wg.windowed_take_t(u32_cols, starts, use_window)
        tail = torch.cat([c[tail_at:tail_at + 1] for c in u32_cols])
        gn_u = torch.cat([g_u[:, 1:], tail[:, None]], dim=1)
        u32_cols.clear()
        del tail
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


_REDUCERS = {"sum": seg_sum, "sumsq": seg_sum, "count": seg_sum,
             "min": seg_min, "max": seg_max}


def reduce_intermediates(inter: dict, gids, num_segments, mask=None):
    """Stage 4: combine shuffled intermediates keyed by new group ids.
    min/max of empty pre-groups carry the identity; their count of 0 keeps
    them out of the final validity."""
    return {k: _REDUCERS[k](v, gids, num_segments, mask)
            for k, v in inter.items()}


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root.  The card's float64 ``sqrt`` is
    IEEE-exact; torch's vectorized CPU one (SLEEF, within 0.5001 ulp) is
    not, so on the host numpy's takes its place."""
    if x.device.type == "cpu":
        # a CPU tensor: the view waits for nothing
        return torch.from_numpy(np.sqrt(x.numpy()))  # tracecheck: off[TS101]
    return torch.sqrt(x)


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
        # sumsq/c − mean² as one fused multiply-add, as XLA contracts it:
        # with exact sums the variance then equals the reference's bit
        # for bit (a streaming view's contract)
        var = torch.addcmul(inter["sumsq"] / c, -mean, mean).clamp_min(0.0)
        denom = (cnt - ddof).clamp_min(1).to(var.dtype)
        var = var * (c / denom)
        ok = cnt > ddof
        return (_sqrt(var) if op == "std" else var), ok
    raise ValueError(f"unknown associative op {op}")


# ---------------------------------------------------------------------------
# non-associative ops on raw (co-located) values
# ---------------------------------------------------------------------------

def nunique(value_keyops, gids, num_segments, mask=None):
    """Distinct count (int32) per group: sort the (gid, value operands)
    tuples, count the boundaries per segment.  ``value_keyops`` is a
    :class:`~cylon_tpu_torch.ops.pack.KeyOps` over the value column; the
    mask drops padding and null rows (pandas drops nulls).  Any order of
    equal tuples gives the same count, so one stable sort serves."""
    from .pack import KeyOps, lex_sort_perm, neighbor_flags, sort_words
    g, ns = _route(gids, num_segments, mask)
    words = sort_words(KeyOps((g.to(torch.int32),) + tuple(value_keyops.ops),
                              ("i",) + tuple(value_keyops.kinds)))
    perm = lex_sort_perm(words)
    neq = neighbor_flags([w[perm] for w, _ in words], [k for _, k in words])
    neq[:1] = 1
    return _seg_apply("sum", neq, g[perm], ns, num_segments)


def _total_order_f64(v: torch.Tensor) -> torch.Tensor:
    """int64 image of float64 values whose signed order is the IEEE total
    order (-0.0 before +0.0, NaN last): the order of the reference's
    ``lax.sort`` on floats."""
    b = v.view(torch.int64)
    return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)


def quantile(values, gids, num_segments, q: float, mask=None):
    """Per-group quantile with linear interpolation, computed in float64:
    sort (gid, value), then index each group's sorted run through the
    count prefix sums.  Returns ``(values, validity)``."""
    from .pack import lex_sort_perm
    f = values.to(_F64)
    g, ns = _route(gids, num_segments, mask)
    v = f if mask is None else torch.where(
        mask, f, torch.full((), float("inf"), dtype=f.dtype, device=f.device))
    perm = lex_sort_perm(((g.to(_I64), "i"), (_total_order_f64(v), "i")))
    v_s = v[perm]
    del perm
    ones = torch.ones(g.shape[0], dtype=_I64, device=g.device)
    cnt_all = _seg_apply("sum", ones, g, ns, ns)
    offs_all = torch.cat([torch.zeros(1, dtype=_I64, device=g.device),
                          torch.cumsum(cnt_all, 0)[:-1]])
    cnt, offs = cnt_all[:num_segments], offs_all[:num_segments]
    posf = torch.full((), q, dtype=f.dtype, device=f.device) \
        * (cnt - 1).clamp_min(0).to(f.dtype)
    lo = torch.floor(posf).to(_I64)
    hi = torch.ceil(posf).to(_I64)
    frac = posf - lo.to(f.dtype)
    n = v_s.shape[0]
    if n == 0:      # an empty shard: every group is empty (count 0)
        v_s = v_s.new_zeros(1)

    def take(i):
        return v_s[(offs + i).clamp(0, max(n - 1, 0))]

    vlo, vhi = take(lo), take(hi)
    return vlo + (vhi - vlo) * frac, cnt > 0


def group_first_index(gids, num_segments, mask=None):
    """Representative (first) source-row index (int32) per group; empty
    groups hold the int32 maximum."""
    n = gids.shape[0]
    g, ns = _route(gids, num_segments, mask)
    idx = torch.arange(n, dtype=torch.int32, device=gids.device)
    return _seg_apply("min", idx, g, ns, num_segments)


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
