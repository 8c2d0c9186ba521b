"""Table-level inner join at world size 1 (port of the inner, world-1 subset
of ``cylon_tpu/relational/join.py``).

The local kernel is the two-phase single-sort merge of ``ops/join.py``:

* phase 1 runs THE one stable sort of both sides' key operands, with each
  side's 32-bit lane matrix riding the sort as payload, and returns the
  exact output count plus the sorted state;
* the host picks a ``pow2ceil`` capacity;
* phase 2 expands the carried geometry into output rows.

With ``DEFER_JOIN`` on, phase 1 runs SLIM and the result is a
:class:`~cylon_tpu_torch.core.table.DeferredTable` carrying a
:class:`~cylon_tpu_torch.relational.fused.JoinState`: a groupby on the
join keys aggregates straight off the sorted state (relational/fused.py);
any other access rebuilds the carry from the held state with scans alone
and materializes.

Other join types, the hash shuffle and the skew route are later slices
(ROADMAP.md Queue 1, slices 3 and 4).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.column import Column
from ..core.table import DeferredTable, Table
from ..ops import join as joink
from ..ops import lanes
from ..ops import pack
from ..status import InvalidError
from ..utils.host import host_array
from .common import (PAD_L, PAD_R, build_table, check_same_env, col_arrays,
                     live_mask, narrow32_flags, promote_key_pair,
                     table_lane_spec)


def _live_cat(vcl, vcr, cap_l: int, cap_r: int, device):
    """Concat-row liveness for (left ++ right)."""
    return torch.cat([live_mask(vcl, cap_l, device),
                      live_mask(vcr, cap_r, device)])


def _sorted_state(vcl, vcr, l_datas, l_valids, r_datas, r_valids,
                  narrow: tuple, payloads: tuple = (),
                  all_live: bool = False):
    """Single-sort join state (bnd, idx_s, live_cat, sorted payloads).
    The null-flag presence per key column is the union of both sides', so
    both build identical operand lists.  ``all_live=True`` drops the
    liveness operand and gather."""
    cap_l, cap_r = l_datas[0].shape[0], r_datas[0].shape[0]
    dev = l_datas[0].device
    mask_l = None if all_live else live_mask(vcl, cap_l, dev)
    mask_r = None if all_live else live_mask(vcr, cap_r, dev)
    need_nf = tuple((lv is not None) or (rv is not None)
                    for lv, rv in zip(l_valids, r_valids))
    ko_l = pack.key_operands(list(l_datas), list(l_valids), row_mask=mask_l,
                             pad_key=PAD_L, need_null_flags=need_nf,
                             narrow32=narrow)
    ko_r = pack.key_operands(list(r_datas), list(r_valids), row_mask=mask_r,
                             pad_key=PAD_R, need_null_flags=need_nf,
                             narrow32=narrow)
    bnd, idx_s, pl_s = joink.join_sort_state(ko_l, ko_r, payloads)
    live_cat = None if all_live else torch.cat([mask_l, mask_r])
    return bnd, idx_s, live_cat, pl_s


def _count(vcl, vcr, l_datas, l_valids, r_datas, r_valids, lg, rg,
           narrow: tuple, lspec=None, rspec=None, all_live: bool = False,
           slim: bool = False):
    """Phase 1: sort once; return the exact count + carried state.

    With ``lspec``/``rspec`` that side's lane matrix RIDES THE SORT as
    payload (left lanes first, then right lanes), so phase 2 needs no
    gather of the input columns.  ``slim`` returns only what the fused
    consumer needs: (total, idx_s, bnd, payloads)."""
    cap_l = l_datas[0].shape[0]
    cap_r = r_datas[0].shape[0]
    dev = l_datas[0].device
    payloads = ()
    if lspec is not None:
        lmat = lanes.pack_lanes(lspec, *lg)
        zr = torch.zeros(cap_r, dtype=torch.int32, device=dev)
        payloads += tuple(torch.cat([lmat[:, j], zr])
                          for j in range(lspec.n_lanes))
        del lmat
    if rspec is not None:
        rmat = lanes.pack_lanes(rspec, *rg)
        zl = torch.zeros(cap_l, dtype=torch.int32, device=dev)
        payloads += tuple(torch.cat([zl, rmat[:, j]])
                          for j in range(rspec.n_lanes))
        del rmat
    bnd, idx_s, live, pl_s = _sorted_state(
        vcl, vcr, l_datas, l_valids, r_datas, r_valids, narrow, payloads,
        all_live)
    del payloads
    n, carry = joink.join_carry(bnd, idx_s, live, cap_l, "inner")
    if slim:
        return n, idx_s, bnd, pl_s
    return n, carry, pl_s


def _materialize(carry, pl_s, out_cap: int, cap_l: int, plan: tuple,
                 lspec, rspec, l_cols, r_cols, carry_emit: bool,
                 carry_match: bool):
    """Phase 2.  ``plan`` entries: ("l", i, needs_valid) — output column =
    left lane-matrix column i; ("r", j, needs_valid) — right column j.
    ``carry_emit``/``carry_match``: that side's lanes arrived sorted as
    phase-1 payload (laneless f64 columns gather by take index)."""
    l_f64 = any(not c.lanes for c in lspec.cols)
    r_f64 = any(not c.lanes for c in rspec.cols)
    n_e = lspec.n_lanes if carry_emit else 0
    pl_e, pl_m = pl_s[:n_e], pl_s[n_e:]
    tk = joink.join_take(joink.JoinCarry(*carry), cap_l, "inner", out_cap,
                         extra=pl_e, carry_emit=carry_emit,
                         carry_match=carry_match,
                         emit_idx=carry_emit and l_f64,
                         match_idx=carry_match and r_f64)
    if carry_emit:
        ldat, lval = lanes.unpack_lanes(lspec, torch.stack(tk.extra, dim=1))
        l_ok = tk.valid
        if l_f64:
            ldat = list(ldat)
            for i, d in lanes.gather_laneless(lspec, l_cols[0],
                                              tk.l_take).items():
                ldat[i] = d
    else:
        ldat, lval = lanes.gather_columns(lspec, *l_cols, tk.l_take)
        l_ok = tk.l_take >= 0
    if carry_match:
        smat = torch.stack(pl_m, dim=1)          # (N, Lr) sorted lanes
        rrows = smat[tk.mpos.clamp(0, smat.shape[0] - 1).long()]
        rdat, rval = lanes.unpack_lanes(rspec, rrows)
        r_ok = tk.matched
        if r_f64:
            rdat = list(rdat)
            for i, d in lanes.gather_laneless(rspec, r_cols[0],
                                              tk.r_take).items():
                rdat[i] = d
    else:
        rdat, rval = lanes.gather_columns(rspec, *r_cols, tk.r_take)
        r_ok = tk.r_take >= 0
    return _plan_outputs(plan, ldat, lval, l_ok, rdat, rval, r_ok)


def _plan_outputs(plan, ldat, lval, l_ok, rdat, rval, r_ok):
    """Assemble the output (datas, valids) from per-side columns."""
    out_d, out_v = [], []
    for side, i, needs_valid in plan:
        datas, vals, ok = ((ldat, lval, l_ok) if side == "l"
                           else (rdat, rval, r_ok))
        d = datas[i]
        v = None if not needs_valid else (ok if vals[i] is None
                                          else ok & vals[i])
        out_d.append(d)
        out_v.append(v)
    return tuple(out_d), tuple(out_v)


def join_tables(left: Table, right: Table, left_on, right_on,
                how: str = "inner", suffixes=("_x", "_y"),
                coalesce_keys: bool = True,
                allow_defer: bool | None = None) -> Table:
    """Inner-join two tables on ``left_on``/``right_on`` (world size 1).

    Returns a DeferredTable (fused-consumer state + lazy materialization)
    when ``DEFER_JOIN`` is on and the output columns ride the sort, else a
    materialized Table.  Output rows come in sorted-merge order, key
    groups contiguous, left rows in source order within a group."""
    if how != "inner":
        raise NotImplementedError(
            f"join how={how!r}: cylon_tpu_torch joins inner only so far; "
            "left/right/outer/semi/anti are slice 4 of ROADMAP.md Queue 1")
    env = check_same_env(left, right)
    left_on = [left_on] if isinstance(left_on, str) else list(left_on)
    right_on = [right_on] if isinstance(right_on, str) else list(right_on)
    if len(left_on) != len(right_on) or not left_on:
        raise InvalidError("left_on/right_on must be equal-length, non-empty")

    lkey_cols, rkey_cols = [], []
    for ln, rn in zip(left_on, right_on):
        a, b = promote_key_pair(left.column(ln), right.column(rn))
        lkey_cols.append(a)
        rkey_cols.append(b)
    lwork = left.with_columns(dict(zip(left_on, lkey_cols)))
    rwork = right.with_columns(dict(zip(right_on, rkey_cols)))

    l_datas, l_valids = col_arrays(lkey_cols)
    r_datas, r_valids = col_arrays(rkey_cols)
    narrow = narrow32_flags(lkey_cols, rkey_cols)
    vcl = np.asarray(lwork.valid_counts, np.int32)
    vcr = np.asarray(rwork.valid_counts, np.int32)

    # ---- output plan -----------------------------------------------------
    coalesce = coalesce_keys and left_on == right_on
    key_set_l, key_set_r = set(left_on), set(right_on)
    overlap = (set(lwork.column_names) & set(rwork.column_names)) - (
        key_set_l if coalesce else set())
    l_cols_list: list[Column] = []
    r_cols_list: list[Column] = []

    def lane_col(side_list, col) -> int:
        side_list.append(col)
        return len(side_list) - 1

    plan, names, types, dicts, bounds = [], [], [], [], []
    for n in lwork.column_names:
        col = lwork.column(n)
        if coalesce and n in key_set_l:
            rcol = rwork.column(right_on[left_on.index(n)])
            bounds.append(None if col.bounds is None or rcol.bounds is None
                          else (min(col.bounds[0], rcol.bounds[0]),
                                max(col.bounds[1], rcol.bounds[1])))
            # every inner-join output row has a live left key: one lane set
            plan.append(("l", lane_col(l_cols_list, col),
                         col.validity is not None))
        else:
            plan.append(("l", lane_col(l_cols_list, col),
                         col.validity is not None))
            bounds.append(col.bounds)
            n = n + suffixes[0] if n in overlap else n
        names.append(n)
        types.append(col.type)
        dicts.append(col.dictionary)
    for n in rwork.column_names:
        if coalesce and n in key_set_r:
            continue
        col = rwork.column(n)
        plan.append(("r", lane_col(r_cols_list, col), col.validity is not None))
        names.append(n + suffixes[1] if n in overlap else n)
        types.append(col.type)
        dicts.append(col.dictionary)
        bounds.append(col.bounds)

    lspec = table_lane_spec(l_cols_list)
    rspec = table_lane_spec(r_cols_list)

    # ride a side's lanes through the sort when it has a laneable column
    # and few lanes (f64 columns keep take-index gathers: carry-LITE)
    def _can_carry(spec, col_list, budget: int) -> bool:
        return bool(col_list and any(c.lanes for c in spec.cols)
                    and spec.n_lanes <= budget)

    carry_match = _can_carry(rspec, r_cols_list, 8)
    carry_emit = _can_carry(lspec, l_cols_list, 6)
    l_cols = (tuple(c.data for c in l_cols_list),
              tuple(c.validity for c in l_cols_list))
    r_cols = (tuple(c.data for c in r_cols_list),
              tuple(c.validity for c in r_cols_list))
    all_live = bool((vcl == lwork.capacity).all()
                    and (vcr == rwork.capacity).all())
    count_args = (vcl, vcr, l_datas, l_valids, r_datas, r_valids,
                  l_cols, r_cols, narrow,
                  lspec if carry_emit else None,
                  rspec if carry_match else None, all_live)
    cap_l, cap_r = lwork.capacity, rwork.capacity

    if allow_defer is None:
        allow_defer = True
    defer = (config.DEFER_JOIN and carry_emit and carry_match and coalesce
             and allow_defer)
    if defer:
        n_dev, idx_s_s, bnd_s, pl_s = _count(*count_args, slim=True)
        counts = host_array(n_dev).astype(np.int64).reshape(1)
        out_cap = config.pow2ceil(int(counts.max()))

        def thunk():
            # the slim state holds the sorted payloads and (idx_s, bnd);
            # the carry rebuilds from scans alone — no second sort
            live = None if all_live else _live_cat(vcl, vcr, cap_l, cap_r,
                                                   env.device)
            _, carry = joink.join_carry(bnd_s, idx_s_s, live, cap_l, "inner")
            out_d, out_v = _materialize(carry, pl_s, out_cap, cap_l,
                                        tuple(plan), lspec, rspec, l_cols,
                                        r_cols, carry_emit, carry_match)
            return {nme: Column(d, t, v, dc, bounds=b)
                    for nme, d, v, t, dc, b in
                    zip(names, out_d, out_v, types, dicts, bounds)}

        from .fused import JoinState
        state = JoinState(
            vcl=vcl, vcr=vcr, idx_s=idx_s_s, bnd=bnd_s, pl_s=pl_s,
            lspec=lspec, rspec=rspec, plan=tuple(plan),
            names=tuple(names), types=tuple(types), dicts=tuple(dicts),
            key_names=tuple(left_on), cap_l=cap_l, cap_r=cap_r,
            all_live=all_live)
        out = DeferredTable(
            env, counts, out_cap, thunk,
            (tuple(names), tuple(types), tuple(dicts),
             tuple(bool(e[-1]) for e in plan)),
            op_state=state)
        out.grouped_by = tuple(left_on)
        return out

    n_dev, carry, pl_s = _count(*count_args)
    counts = host_array(n_dev).astype(np.int64).reshape(1)
    out_cap = config.pow2ceil(int(counts.max()))
    out_d, out_v = _materialize(carry, pl_s, out_cap, cap_l, tuple(plan),
                                lspec, rspec, l_cols, r_cols, carry_emit,
                                carry_match)
    out = build_table(names, out_d, out_v, types, dicts, counts, env,
                      bounds=bounds)
    if coalesce:
        # join output rows are key-grouped (sorted merge order)
        out.grouped_by = tuple(left_on)
    return out
