"""Table-level joins (port of ``cylon_tpu/relational/join.py``): every
join type of the reference — inner, left, right, outer, semi and anti —
and the N-way ``join_tables_multi``.

At world size W > 1 the sides are first co-located
(:func:`_shuffle_for_join`): both hash-shuffle on the join keys
(relational/repart.shuffle_table), or a small side is replicated to every
shard and the other stays in place (the broadcast route), or, when the
probe side holds a heavy key, the adaptive skew split (relational/
skew.py) spreads it over a rank group for inner/left/right/outer joins,
and for semi and anti joins the heavy keys' build rows replicate and
their probe rows spread round-robin.  Then every
shard runs the local kernel (parallel/shards.map_shards), the two-phase
single-sort merge of ``ops/join.py``:

* phase 1 runs THE one stable sort of both sides' key operands, with each
  side's 32-bit lane matrix riding the sort as payload (inner and left
  joins), and returns the exact output count plus the sorted state;
* the host picks ONE ``pow2ceil`` capacity over the shards' counts;
* phase 2 expands the carried geometry into output rows; an outer join
  appends each shard's unmatched right rows after its merge-ordered rows.

Semi and anti joins expand nothing: one matched flag per left row over
the sorted state, then ``repart.filter_table``.

With ``DEFER_JOIN`` on, an inner join's phase 1 runs SLIM and the result
is a :class:`~cylon_tpu_torch.core.table.DeferredTable` carrying a
:class:`~cylon_tpu_torch.relational.fused.JoinState`: a groupby on the
join keys aggregates straight off the sorted state (relational/fused.py);
any other access rebuilds the carry from the held state with scans alone
and materializes.  Every other join type materializes.

Under a skew plan the output stitches back into the unsplit hash plan's
global row order on first access (``skew.stitch_join_output``); a
groupby takes the split layout as it is (``skew.consume_unstitched``),
and the fused pushdown combines the heavy keys' partial rows.

The packed-piece entry joins two :class:`~cylon_tpu_torch.relational.
piece.PackedPiece` windows of the pipelined join (exec/pipeline.py) with
the same kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.column import Column
from ..core.table import DeferredTable, Table
from ..obs import plan as _plan
from ..ops import join as joink
from ..ops import lanes
from ..ops import pack
from ..parallel.collectives import allgather_table
from ..parallel.shards import map_shards, shard
from ..status import InvalidError
from ..utils import timing
from ..utils.host import host_array
from .common import (PAD_L, PAD_R, build_table, check_same_env, col_arrays,
                     live_mask, narrow32_flags, promote_key_pair,
                     table_lane_spec)
from . import skew as skewmod
from .piece import PackedPiece
from .repart import (concat_tables, even_partition_counts,
                     exchange_by_targets, filter_table, shuffle_table)

HOW = ("inner", "left", "right", "outer", "semi", "anti")


def _shard_cols(cols, w: int, r: int):
    """Rank r's views of a (datas, valids) column pair of tuples."""
    return tuple(tuple(shard(x, w, r) for x in part) for part in cols)


def _live_cat(vcl, vcr, cap_l: int, cap_r: int, device):
    """Concat-row liveness for (left ++ right) of one shard."""
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


def _count(vcl, vcr, l_datas, l_valids, r_datas, r_valids, narrow: tuple,
           how: str, lmat=None, rmat=None, all_live: bool = False,
           slim: bool = False):
    """Phase 1: sort once; return the exact count + carried state.

    ``lmat``/``rmat``: that side's (rows, L) lane matrix RIDES THE SORT as
    payload (left lanes first, then right lanes), so phase 2 needs no
    gather of the input columns.  ``slim`` returns only what the fused
    consumer needs: (total, idx_s, bnd, payloads)."""
    cap_l = l_datas[0].shape[0]
    cap_r = r_datas[0].shape[0]
    dev = l_datas[0].device
    payloads = ()
    if lmat is not None:
        zr = torch.zeros(cap_r, dtype=torch.int32, device=dev)
        payloads += tuple(torch.cat([lmat[:, j], zr])
                          for j in range(lmat.shape[1]))
    if rmat is not None:
        zl = torch.zeros(cap_l, dtype=torch.int32, device=dev)
        payloads += tuple(torch.cat([zl, rmat[:, j]])
                          for j in range(rmat.shape[1]))
    del lmat, rmat
    bnd, idx_s, live, pl_s = _sorted_state(
        vcl, vcr, l_datas, l_valids, r_datas, r_valids, narrow, payloads,
        all_live)
    del payloads
    n, carry = joink.join_carry(bnd, idx_s, live, cap_l, how)
    if slim:
        return n, idx_s, bnd, pl_s
    return n, carry, pl_s


def _col_source(spec, cols):
    """One side's input rows as (gather_rows, gather_f64) by take index,
    from full columns ``cols`` = (datas, valids)."""
    return (lambda take: lanes.gather_columns(spec, *cols, take),
            lambda take: lanes.gather_laneless(spec, cols[0], take))


def _window_source(spec, mat, f64w, cap: int):
    """One side's input rows as (gather_rows, gather_f64) by take index,
    from a packed piece's window: whole rows of the lane matrix, unpacked
    only at the output rows."""
    def gather_f64(take):
        datas = [None] * len(spec.cols)
        wins = iter(f64w)
        for i, c in enumerate(spec.cols):
            if not c.lanes:
                datas[i] = next(wins)
        return lanes.gather_laneless(spec, datas, take)

    def gather_rows(take):
        if spec.n_lanes:
            rows = mat[take.clamp(0, cap - 1).long()]
            datas, valids = lanes.unpack_lanes(spec, rows)
            datas, valids = list(datas), list(valids)
        else:
            datas = [None] * len(spec.cols)
            valids = [None] * len(spec.cols)
        for i, d in gather_f64(take).items():
            datas[i] = d
        return tuple(datas), tuple(valids)

    return gather_rows, gather_f64


def _materialize(carry, pl_s, how: str, out_cap: int, cap_l: int,
                 plan: tuple, lspec, rspec, l_src, r_src, carry_emit: bool,
                 carry_match: bool):
    """Phase 2.  ``plan`` entries: ("l", i, needs_valid) — output column =
    left column i; ("r", j, needs_valid) — right column j; ("k", i, j,
    needs_valid) — left column i where the left row exists, else right
    column j (an outer join's coalesced key).  ``l_src`` /
    ``r_src``: each side's (gather_rows, gather_f64) by take index
    (:func:`_col_source`, :func:`_window_source`).
    ``carry_emit``/``carry_match``: that side's lanes arrived sorted as
    phase-1 payload (laneless f64 columns gather by take index)."""
    l_f64 = any(not c.lanes for c in lspec.cols)
    r_f64 = any(not c.lanes for c in rspec.cols)
    n_e = lspec.n_lanes if carry_emit else 0
    pl_e, pl_m = pl_s[:n_e], pl_s[n_e:]
    tk = joink.join_take(joink.JoinCarry(*carry), cap_l, how, out_cap,
                         extra=pl_e, carry_emit=carry_emit,
                         carry_match=carry_match,
                         emit_idx=carry_emit and l_f64,
                         match_idx=carry_match and r_f64)
    if carry_emit:
        ldat, lval = lanes.unpack_lanes(lspec, torch.stack(tk.extra, dim=1))
        l_ok = tk.valid
        if l_f64:
            ldat = list(ldat)
            for i, d in l_src[1](tk.l_take).items():
                ldat[i] = d
    else:
        ldat, lval = l_src[0](tk.l_take)
        l_ok = tk.l_take >= 0
    if carry_match:
        smat = torch.stack(pl_m, dim=1)          # (N, Lr) sorted lanes
        rrows = smat[tk.mpos.clamp(0, smat.shape[0] - 1).long()]
        rdat, rval = lanes.unpack_lanes(rspec, rrows)
        r_ok = tk.matched
        if r_f64:
            rdat = list(rdat)
            for i, d in r_src[1](tk.r_take).items():
                rdat[i] = d
    else:
        rdat, rval = r_src[0](tk.r_take)
        r_ok = tk.r_take >= 0
    return _plan_outputs(plan, ldat, lval, l_ok, rdat, rval, r_ok)


def _plan_outputs(plan, ldat, lval, l_ok, rdat, rval, r_ok):
    """Assemble the output (datas, valids) from per-side columns."""
    def side_out(datas, vals, ok, i, needs_valid):
        if not needs_valid:
            return datas[i], None
        return datas[i], (ok if vals[i] is None else ok & vals[i])

    out_d, out_v = [], []
    for entry in plan:
        if entry[0] == "k":
            _, i, j, needs_valid = entry
            dl, vl = side_out(ldat, lval, l_ok, i, True)
            dr, vr = side_out(rdat, rval, r_ok, j, True)
            out_d.append(torch.where(l_ok, dl, dr))
            out_v.append(torch.where(l_ok, vl, vr) if needs_valid else None)
        else:
            side, i, needs_valid = entry
            d, v = side_out(*((ldat, lval, l_ok) if side == "l"
                              else (rdat, rval, r_ok)), i, needs_valid)
            out_d.append(d)
            out_v.append(v)
    return tuple(out_d), tuple(out_v)


# ---------------------------------------------------------------------------
# co-location at W > 1: the hash plan, the broadcast route, the adaptive
# skew split and the semi/anti heavy-key spread
# ---------------------------------------------------------------------------

def _key_hashes(table: Table, key_names) -> torch.Tensor:
    """The routing hash of every row's key tuple (ops/hashing.hash_rows),
    the predicate both heavy-key detection and the spread use."""
    from ..ops import hashing
    datas, valids = col_arrays([table.column(n) for n in key_names])
    return hashing.hash_rows(list(datas), list(valids))


def _heavy_keys(table: Table, key_names, env):
    """Host-side heavy-hitter estimate from a small device sample: key
    HASHES whose weighted global share exceeds SKEW_GLOBAL_FACTOR/W (one
    key holding a full shard's worth of rows).  Returns an int64 array
    of u32 hashes or None.  A hash collision only widens the spread to a
    light key: both sides flag with the same predicate."""
    from .common import sample_positions
    w = env.world_size
    total = int(table.valid_counts.sum())
    if total < w * 64:      # too small to skew: no device sample
        return None
    m, cap = config.SKEW_SAMPLE, table.capacity
    vc = np.asarray(table.valid_counts, np.int64)
    h = _key_hashes(table, key_names)
    pos = np.concatenate([r * cap + sample_positions(int(vc[r]), m, cap)
                          for r in range(w)]).astype(np.int64)
    vals = host_array(h[torch.from_numpy(pos).to(h.device)]).reshape(w, m)
    del h
    shares: dict = {}
    for s in range(w):
        if not vc[s]:
            continue
        lv = vals[s]
        # each shard's sample weighs its true row share
        weight = float(vc[s]) / total / lv.size
        uniq, cnt = np.unique(lv, return_counts=True)
        keep = cnt / lv.size > config.SKEW_MIN_SHARE
        for u, c in zip(uniq[keep], cnt[keep]):
            shares[u] = shares.get(u, 0.0) + c * weight
    thresh = config.SKEW_GLOBAL_FACTOR / w
    heavy = [(u, sh) for u, sh in shares.items() if sh > thresh]
    if not heavy:
        return None
    heavy.sort(key=lambda x: -x[1])
    return np.asarray([u for u, _ in heavy[:config.SKEW_MAX_KEYS]],
                      np.int64)


def _heavy_flag(h: torch.Tensor, heavy) -> torch.Tensor:
    """Per-row flag: the row hash ``h`` is one of the ``heavy`` hashes."""
    flag = torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
    for hh in heavy:
        flag |= h == int(hh)
    return flag


def _shuffle_for_join(lwork: Table, rwork: Table, left_on, right_on,
                      how: str, env):
    """Co-locate equal keys across the W shards.  Returns ``(lwork, rwork,
    split)``; ``split`` is False (the hash plan), True when the output
    will not be co-located by key and has no plan (the broadcast route or
    the semi/anti spread), which turns off ``grouped_by`` and the
    deferred join, or the finalized :class:`~.skew.SkewPlan`, which the
    caller stitches.

    * Broadcast: a side of at most ``BROADCAST_JOIN_ROWS`` rows, facing
      one at least 4x its size, replicates to every shard and the big
      side does not move.  Only a side whose unmatched rows are never
      emitted may replicate: the right side for inner/left/semi/anti,
      the left side for inner/right.  A side of 0 rows always qualifies.
    * Skew split (inner/left/right/outer, ``SKEW_SPLIT`` armed): the
      probe side (the right table of a right join, else the left) is
      sampled; a finalized plan splits each heavy key's probe rows over
      its rank group and replicates its build rows to that group
      (``skew.split_exchange``).
    * Semi/anti spread: when the probe (left) side's sample shows a heavy
      key, the build rows of the heavy keys replicate, the other build
      rows hash, and the probe's heavy rows spread round-robin — unless
      the build side is itself heavy on those keys (the replication
      guard), when both sides hash.
    * Otherwise both sides hash-shuffle."""
    from ..parallel import shuffle as shf
    bc = config.BROADCAST_JOIN_ROWS
    if (how in ("inner", "left", "semi", "anti")
            and rwork.row_count <= bc
            and lwork.row_count >= 4 * max(rwork.row_count, 1)):
        timing.bump("join.broadcast")
        _plan.annotate(route="broadcast", broadcast_side="right")
        return lwork, allgather_table(rwork), True
    if (how in ("inner", "right")
            and lwork.row_count <= bc
            and rwork.row_count >= 4 * max(lwork.row_count, 1)):
        timing.bump("join.broadcast")
        _plan.annotate(route="broadcast", broadcast_side="left")
        return allgather_table(lwork), rwork, True

    if how in ("inner", "left", "right", "outer") and config.SKEW_SPLIT:
        if how == "right":
            probe, probe_on, build, build_on = rwork, right_on, lwork, left_on
        else:
            probe, probe_on, build, build_on = lwork, left_on, rwork, right_on
        with timing.region("skew.detect"):
            plan = skewmod.detect(probe, probe_on, env)
        if plan is not None:
            with timing.region("skew.finalize"):
                plan = skewmod.finalize_or_none(plan, probe, probe_on,
                                                build, build_on)
        if plan is not None:
            skewmod.adopt(plan, env)
            _plan.annotate(route="skew_split", skew_plan=plan.summary())
            with timing.region("skew.split_exchange"):
                probe_out, build_out = skewmod.split_exchange(
                    probe, probe_on, build, build_on, plan)
            if how == "right":
                return build_out, probe_out, plan
            return probe_out, build_out, plan
        _plan.annotate(skew_split_armed=True, skew_split_keys=0)

    if how in ("semi", "anti"):
        heavy = _heavy_keys(lwork, left_on, env)
        if heavy is not None:
            flag = _heavy_flag(_key_hashes(rwork, right_on), heavy)
            build_heavy = filter_table(rwork, flag)
            if (build_heavy.row_count * env.world_size
                    > config.SKEW_GUARD_RATIO * max(rwork.row_count, 1)
                    and build_heavy.row_count > config.SKEW_GUARD_ROWS):
                _plan.annotate(route="hash", skew_guard_fallback=True)
                return (shuffle_table(lwork, left_on),
                        shuffle_table(rwork, right_on), False)
            _plan.annotate(route="skew_split", heavy_keys=int(len(heavy)))
            build_light = filter_table(rwork, ~flag)
            build_out = concat_tables([shuffle_table(build_light, right_on),
                                       allgather_table(build_heavy)])
            h = _key_hashes(lwork, left_on)
            tgt = shf.skew_targets(env, h, lwork.valid_counts,
                                   _heavy_flag(h, heavy))
            del h
            counts = shf.count_targets(env, tgt)
            return exchange_by_targets(lwork, tgt, counts), build_out, True
    return (shuffle_table(lwork, left_on), shuffle_table(rwork, right_on),
            False)


def _semi_flag(vcl, vcr, l_datas, l_valids, r_datas, r_valids, narrow,
               all_live: bool, anti: bool) -> torch.Tensor:
    """One shard's per-left-row keep flag of a SEMI (ANTI) join: the left
    row's key run in the sorted state holds a (no) live right row.  No
    output expansion: the output is a filter of the left table.  Null
    keys match null keys, as in the other join types."""
    cap_l = l_datas[0].shape[0]
    bnd, idx_s, live_cat, _ = _sorted_state(
        vcl, vcr, l_datas, l_valids, r_datas, r_valids, narrow, (), all_live)
    n = bnd.shape[0]
    dev = bnd.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    side_r = idx_s >= cap_l
    if live_cat is None:
        lefts_b = ~side_r
        rights = side_r.to(torch.int32)
    else:
        live = live_cat[idx_s.long()]
        lefts_b = (~side_r) & live
        rights = (side_r & live).to(torch.int32)
    runs = joink.runs_of(bnd.bool() | (pos == 0))
    s_r = joink.cumsum32(rights)
    matched = (joink.at_run_end(s_r, runs)
               - joink.at_run_start(s_r - rights, runs)) > 0
    keep = (matched ^ anti) & lefts_b
    # idx_s is a permutation of the concat rows: one scatter, no collision
    flag = torch.empty(n, dtype=torch.bool, device=dev)
    flag[idx_s.long()] = keep
    return flag[:cap_l]


def _semi_anti(env, lwork: Table, rwork: Table, keys_l, keys_r, narrow,
               how: str) -> Table:
    """Semi/anti join over co-located sides: per-shard matched flags, then
    one filter of the left table."""
    w = env.world_size
    vcl = np.asarray(lwork.valid_counts, np.int32)
    vcr = np.asarray(rwork.valid_counts, np.int32)
    all_live = bool((vcl == lwork.capacity).all()
                    and (vcr == rwork.capacity).all())
    with timing.region("join.semi"):
        flag = map_shards(lambda r: _semi_flag(
            vcl[r:r + 1], vcr[r:r + 1], *_shard_cols(keys_l, w, r),
            *_shard_cols(keys_r, w, r), narrow, all_live, how == "anti"), w)
    return filter_table(lwork, flag)


def join_tables(left: Table, right: Table, left_on, right_on,
                how: str = "inner", suffixes=("_x", "_y"),
                coalesce_keys: bool = True,
                assume_colocated: bool = False,
                allow_defer: bool | None = None) -> Table:
    """Join two tables on ``left_on``/``right_on``; ``how`` is one of
    :data:`HOW`.

    An inner join returns a DeferredTable (fused-consumer state + lazy
    materialization) when ``DEFER_JOIN`` is on, the output columns ride
    the sort and the sides are co-located by key; every other join is a
    materialized Table.  At world size W > 1 the sides co-locate first
    (:func:`_shuffle_for_join`).  Each shard's output rows come in
    sorted-merge order, key groups contiguous, left rows in source order
    within a group; an outer join appends the shard's unmatched right
    rows.  Semi and anti joins return the kept left rows in their shard
    order.  ``grouped_by`` is the join keys when they coalesce and the
    sides were co-located by key.

    ``assume_colocated``: the caller guarantees equal keys already share
    a shard on both sides (the pipelined join passes it), so the shuffle
    is skipped.  ``left``/``right`` may be :class:`~cylon_tpu_torch.relational.
    piece.PackedPiece` window descriptors instead of Tables (the pipelined
    range loop): the window slice and key unpack then run inside the
    join; pieces have no fallback (they are the streaming decomposition).

    A device OOM retries through the range-partitioned pipeline
    (exec/pipeline.pipelined_join) at 4 and then 16 ranges, under the
    retry ladder (exec/recovery.run_with_recovery): each range's sort
    scratch and output are a fraction of the monolith's.  Ranges
    partition the key space, so the fallback holds for inner, left,
    right and outer joins with coalesced keys."""
    from .common import run_with_oom_fallback
    if how not in HOW:
        raise InvalidError(f"how must be one of {HOW}, got {how!r}")
    if isinstance(left, PackedPiece) or isinstance(right, PackedPiece):
        # one node per piece: the window caps are the piece geometry
        with _plan.node(
                "join.piece", how=how,
                cap_l=int(getattr(left, "piece_cap", 0)),
                cap_r=int(getattr(right, "piece_cap", 0))) as pn:
            if pn:
                pn.set(rows_in=int(getattr(left, "lens", np.zeros(1)).sum()
                                   + getattr(right, "lens",
                                             np.zeros(1)).sum()))
            res = _join_packed_entry(left, right, left_on, right_on, how,
                                     suffixes, coalesce_keys, allow_defer)
            if pn and type(res) is Table:
                pn.set(rows_out=res.row_count)
            return res

    def fallback(nc):
        from ..exec.pipeline import pipelined_join
        return pipelined_join(left, right, left_on, right_on, how=how,
                              n_chunks=nc, suffixes=suffixes)

    lo = [left_on] if isinstance(left_on, str) else list(left_on)
    ro = [right_on] if isinstance(right_on, str) else list(right_on)
    with _plan.node(
            "join", how=how, left_on=tuple(lo), right_on=tuple(ro),
            route=("colocated" if assume_colocated
                   or left.env.world_size == 1 else "hash")) as pn:
        if pn:
            pn.set(rows_in=left.row_count + right.row_count)
            _plan.profile_keys(pn, left, lo)
        res = run_with_oom_fallback(
            lambda: _join_tables_impl(left, right, left_on, right_on, how,
                                      suffixes, coalesce_keys,
                                      assume_colocated, allow_defer),
            can_fallback=(not assume_colocated and coalesce_keys
                          and how not in ("semi", "anti")),
            fallback=fallback, label="join", env=left.env)
        if pn and type(res) is Table:
            pn.set(rows_out=res.row_count)
        return res


def _join_tables_impl(left: Table, right: Table, left_on, right_on,
                      how: str, suffixes, coalesce_keys: bool,
                      assume_colocated: bool, allow_defer) -> Table:
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
    w = env.world_size
    split = False
    if w > 1 and not assume_colocated:
        with timing.region("join.shuffle"):
            lwork, rwork, split = _shuffle_for_join(lwork, rwork, left_on,
                                                    right_on, how, env)
        lkey_cols = [lwork.column(n) for n in left_on]
        rkey_cols = [rwork.column(n) for n in right_on]
    skew_plan = split if isinstance(split, skewmod.SkewPlan) else None

    l_datas, l_valids = col_arrays(lkey_cols)
    r_datas, r_valids = col_arrays(rkey_cols)
    narrow = narrow32_flags(lkey_cols, rkey_cols)
    keys_l, keys_r = (l_datas, l_valids), (r_datas, r_valids)
    if how in ("semi", "anti"):
        # output ⊆ left rows: one matched-flag pass + filter, no plan and
        # no expansion
        return _semi_anti(env, lwork, rwork, keys_l, keys_r, narrow, how)
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
            # the coalesced key needs both sides only for an outer join:
            # every inner/left output row has a live left key, every
            # right one a live right key
            if how in ("inner", "left"):
                plan.append(("l", lane_col(l_cols_list, col),
                             col.validity is not None))
            elif how == "right":
                plan.append(("r", lane_col(r_cols_list, rcol),
                             rcol.validity is not None))
            else:
                plan.append(("k", lane_col(l_cols_list, col),
                             lane_col(r_cols_list, rcol),
                             col.validity is not None
                             or rcol.validity is not None))
        else:
            plan.append(("l", lane_col(l_cols_list, col),
                         col.validity is not None
                         or how in ("right", "outer")))
            bounds.append(col.bounds)
            n = n + suffixes[0] if n in overlap else n
        names.append(n)
        types.append(col.type)
        dicts.append(col.dictionary)
    for n in rwork.column_names:
        if coalesce and n in key_set_r:
            continue
        col = rwork.column(n)
        plan.append(("r", lane_col(r_cols_list, col),
                     col.validity is not None or how in ("left", "outer")))
        names.append(n + suffixes[1] if n in overlap else n)
        types.append(col.type)
        dicts.append(col.dictionary)
        bounds.append(col.bounds)

    lspec = table_lane_spec(l_cols_list)
    rspec = table_lane_spec(r_cols_list)

    # ride a side's lanes through the sort (inner and left joins) when it
    # has a laneable column and few lanes (f64 columns keep take-index
    # gathers: carry-LITE)
    def _can_carry(spec, col_list, budget: int) -> bool:
        return bool(how in ("inner", "left") and col_list
                    and any(c.lanes for c in spec.cols)
                    and spec.n_lanes <= budget)

    carry_match = _can_carry(rspec, r_cols_list, 8)
    carry_emit = _can_carry(lspec, l_cols_list, 6)
    l_cols = (tuple(c.data for c in l_cols_list),
              tuple(c.validity for c in l_cols_list))
    r_cols = (tuple(c.data for c in r_cols_list),
              tuple(c.validity for c in r_cols_list))
    all_live = bool((vcl == lwork.capacity).all()
                    and (vcr == rwork.capacity).all())
    cap_l, cap_r = lwork.capacity, rwork.capacity

    def count(slim: bool):
        def one(r):
            (ld, lv), (rd, rv) = (_shard_cols(keys_l, w, r),
                                  _shard_cols(keys_r, w, r))
            lc, rc = _shard_cols(l_cols, w, r), _shard_cols(r_cols, w, r)
            return _count(vcl[r:r + 1], vcr[r:r + 1], ld, lv, rd, rv, narrow,
                          how,
                          lanes.pack_lanes(lspec, *lc) if carry_emit
                          else None,
                          lanes.pack_lanes(rspec, *rc) if carry_match
                          else None, all_live, slim)
        return map_shards(one, w)

    def materialize(carry_of, pl_s, out_cap: int):
        def one(r):
            return _materialize(
                carry_of(r), tuple(shard(p, w, r) for p in pl_s), how,
                out_cap, cap_l,
                tuple(plan), lspec, rspec,
                _col_source(lspec, _shard_cols(l_cols, w, r)),
                _col_source(rspec, _shard_cols(r_cols, w, r)),
                carry_emit, carry_match)
        return map_shards(one, w, cap=out_cap)

    if allow_defer is None:
        allow_defer = True
    # the broadcast route and the semi/anti spread leave equal keys on
    # several shards with no plan to restore them: no fused pushdown and
    # no grouped_by there.  A skew plan defers like the hash plan: the
    # fused consumer combines the heavy keys' partials, any other access
    # materializes through the stitch.
    defer = (config.DEFER_JOIN and how == "inner" and carry_emit
             and carry_match and coalesce and allow_defer
             and (skew_plan is not None or not split))
    if defer:
        with timing.region("join.sort_count"):
            n_dev, idx_s_s, bnd_s, pl_s = count(slim=True)
            counts = host_array(n_dev).astype(np.int64).reshape(w)
        out_cap = config.pow2ceil(int(counts.max()))

        def materialize_cols():
            # the slim state holds the sorted payloads and (idx_s, bnd);
            # the carry rebuilds from scans alone — no second sort
            def carry_of(r):
                live = None if all_live else _live_cat(
                    vcl[r:r + 1], vcr[r:r + 1], cap_l, cap_r, env.device)
                return joink.join_carry(shard(bnd_s, w, r),
                                        shard(idx_s_s, w, r), live, cap_l,
                                        how)[1]
            with timing.region("join.materialize"):
                out_d, out_v = materialize(carry_of, pl_s, out_cap)
            return {nme: Column(d, t, v, dc, bounds=b)
                    for nme, d, v, t, dc, b in
                    zip(names, out_d, out_v, types, dicts, bounds)}

        # a deferred materialization OOMs outside join_tables' ladder: it
        # takes the same chunked fallback, whose whole Table the
        # DeferredTable adopts
        from .common import run_with_oom_fallback

        def fb(nc):
            from ..exec.pipeline import pipelined_join
            return pipelined_join(left, right, left_on, right_on, how=how,
                                  n_chunks=nc, suffixes=suffixes)

        def split_table():
            return Table(materialize_cols(), env, counts)

        def pre_table():
            # the SPLIT-layout output without the stitch, for a groupby
            # the fused pushdown declined (skew.consume_unstitched)
            return run_with_oom_fallback(split_table, True, fb,
                                         "deferred-join materialize",
                                         env=env)

        def mat():
            if skew_plan is None:
                return materialize_cols()
            with timing.region("join.skew_stitch"):
                return skewmod.stitch_join_output(
                    split_table(), list(left_on), skew_plan, how, None)

        def thunk():
            return run_with_oom_fallback(mat, True, fb,
                                         "deferred-join materialize",
                                         env=env)

        from .fused import JoinState
        if skew_plan is not None:
            total = int(counts.sum())
            d_counts = even_partition_counts(total, w)
            d_cap = config.pow2ceil(int(d_counts.max()) if total else 1)
        else:
            d_counts, d_cap = counts, out_cap
        state = JoinState(
            vcl=vcl, vcr=vcr, idx_s=idx_s_s, bnd=bnd_s, pl_s=pl_s,
            lspec=lspec, rspec=rspec, plan=tuple(plan),
            names=tuple(names), types=tuple(types), dicts=tuple(dicts),
            key_names=tuple(left_on), cap_l=cap_l, cap_r=cap_r,
            all_live=all_live, skew_plan=skew_plan,
            pre_thunk=pre_table if skew_plan is not None else None)
        out = DeferredTable(
            env, d_counts, d_cap, thunk,
            (tuple(names), tuple(types), tuple(dicts),
             tuple(bool(e[-1]) for e in plan)),
            op_state=state)
        # a split layout is not co-located (heavy keys span their rank
        # groups), and the stitched one is the even layout
        out.grouped_by = None if skew_plan is not None else tuple(left_on)
        return out

    with timing.region("join.sort_count"):
        n_dev, carry, pl_s = count(slim=False)
        counts = host_array(n_dev).astype(np.int64).reshape(w)
    out_cap = config.pow2ceil(int(counts.max()))
    with timing.region("join.materialize"):
        out_d, out_v = materialize(
            lambda r: joink.JoinCarry(*(shard(c, w, r) for c in carry)),
            pl_s, out_cap)
    out = build_table(names, out_d, out_v, types, dicts, counts, env,
                      bounds=bounds)
    if skew_plan is not None:
        return _stitch_deferred(out, carry, skew_plan, how, coalesce,
                                left_on, right_on, overlap, suffixes,
                                (tuple(names), tuple(types), tuple(dicts),
                                 tuple(bool(e[-1]) for e in plan)))
    if coalesce and not split:
        # join output rows are key-grouped per shard (sorted merge order)
        # and keys co-located across shards (hash shuffle)
        out.grouped_by = tuple(left_on)
    return out


def _stitch_deferred(pre: Table, carry, skew_plan, how: str, coalesce: bool,
                     left_on, right_on, overlap, suffixes, meta):
    """A materialized skew join's result: a DeferredTable on the even
    layout whose first data access runs the stitch
    (``skew.stitch_join_output``) and whose ``op_state`` hands a groupby
    the split-layout table ``pre`` instead (``skew.StitchState``)."""
    env = pre.env
    w = env.world_size
    un_counts = None
    if how == "outer":
        # each shard's appended unmatched-right rows (the carry's `un`
        # flags): the stitch's zone B
        un_counts = host_array(carry[5].view(w, -1).sum(
            dim=1, dtype=torch.int64)).astype(np.int64)
    if coalesce:
        key_out = list(left_on)
    elif how == "right":
        key_out = [n + suffixes[1] if n in overlap else n for n in right_on]
    else:
        key_out = [n + suffixes[0] if n in overlap else n for n in left_on]
    total = pre.row_count
    dest = even_partition_counts(total, w)

    def stitch_thunk():
        with timing.region("join.skew_stitch"):
            return skewmod.stitch_join_output(pre, key_out, skew_plan, how,
                                              un_counts)

    dt = DeferredTable(env, dest,
                       config.pow2ceil(int(dest.max()) if total else 1),
                       stitch_thunk, meta,
                       op_state=skewmod.StitchState(pre, skew_plan, how,
                                                    un_counts, key_out))
    dt.grouped_by = None
    return dt


def join_tables_multi(tables: list, ons: list, how: str = "inner",
                      suffixes=("_x", "_y")) -> Table:
    """N-way join on ONE shared key set: every table is co-partitioned
    once (one hash shuffle each, or a broadcast for a small right-side
    table), then the chain runs as local co-located joins, so no
    intermediate result is shuffled again.

    ``ons[i]``: the key column name(s) of ``tables[i]`` (every key set of
    the same length; values compare pairwise-promoted).  ``how`` applies
    to every step: inner or left."""
    if len(tables) < 2 or len(tables) != len(ons):
        raise InvalidError("join_tables_multi needs >= 2 tables with one "
                           "key set each")
    if how not in ("inner", "left"):
        raise InvalidError("join_tables_multi supports how in "
                           "('inner','left') — chain others manually")
    ons = [[o] if isinstance(o, str) else list(o) for o in ons]
    if len({len(o) for o in ons}) != 1:
        raise InvalidError("all key sets must have the same length")
    env = tables[0].env
    # promote every table's keys to ONE representation before the
    # shuffles (the routing hash depends on the physical dtype and on the
    # string dictionary): pairwise promotion converges on cols[0], and a
    # second sweep brings the middles to the final form
    tables = list(tables)
    for ki in range(len(ons[0])):
        cols = [t.column(ons[i][ki]) for i, t in enumerate(tables)]
        for j in range(1, len(cols)):
            cols[0], cols[j] = promote_key_pair(cols[0], cols[j])
        cols = [cols[0]] + [promote_key_pair(cols[0], c)[1]
                            for c in cols[1:]]
        tables = [t.with_columns({ons[i][ki]: c})
                  for i, (t, c) in enumerate(zip(tables, cols))]
    bc = config.BROADCAST_JOIN_ROWS
    big = max(t.row_count for t in tables)
    shuffled = []
    for i, (t, on) in enumerate(zip(tables, ons)):
        if env.world_size == 1:
            shuffled.append(t)
        elif (i > 0 and t.row_count <= bc
                and big >= 4 * max(t.row_count, 1)):
            # only right-side tables may replicate: a replicated left
            # accumulator would emit its matches once per shard
            shuffled.append(allgather_table(t))
        else:
            shuffled.append(shuffle_table(t, on))
    acc = shuffled[0]
    acc_on = list(ons[0])
    for t, on in zip(shuffled[1:], ons[1:]):
        # track the accumulated left key names through the suffixes: equal
        # key name sets coalesce onto the left names; otherwise a left key
        # colliding with a right column takes suffixes[0]
        coalesce = acc_on == on
        overlap = (set(acc.column_names) & set(t.column_names)) \
            - (set(acc_on) if coalesce else set())
        acc = join_tables(acc, t, acc_on, on, how=how, suffixes=suffixes,
                          assume_colocated=True, allow_defer=False)
        acc_on = [n if (coalesce or n not in overlap) else n + suffixes[0]
                  for n in acc_on]
        missing = [n for n in acc_on if n not in acc.column_names]
        if missing:
            raise InvalidError(
                f"accumulated join key column(s) {missing} disappeared "
                "after suffix renaming — choose non-colliding suffixes "
                "or rename the payload columns before join_tables_multi")
    acc.grouped_by = None
    return acc


# ---------------------------------------------------------------------------
# packed-piece entry: joins that consume PackedPiece window descriptors
# (relational/piece.py), the range-partitioned pipeline's fast path.  The
# window slice and the key unpack run inside the join, keys first; the
# payload lanes ride the phase-1 sort and unpack only at the output rows.
# The materialize-then-join path (PackedPiece.to_table + the colocated
# join) is the reference these are exactly equal to.
# ---------------------------------------------------------------------------

def _window_keys(spec, mat, f64w, key_idx: tuple):
    """Unpack ONLY the key columns of a window."""
    fpos = {i: j for j, i in enumerate(
        i for i, c in enumerate(spec.cols) if not c.lanes)}
    datas, valids = [], []
    for i in key_idx:
        if spec.cols[i].lanes:
            d, v = lanes.unpack_column(spec, mat, i)
        else:
            d = f64w[fpos[i]]
            v = lanes.unpack_column(spec, mat, i)[1] if spec.n_lanes \
                else None
        datas.append(d)
        valids.append(v)
    return datas, valids


def _fits32_meta(dtype, bounds) -> bool:
    """fits_int32 over piece metadata (dtype name + host bounds)."""
    dt = np.dtype(dtype)
    if dt.itemsize != 8 or dt.kind not in ("i", "u"):
        return False
    return bounds is not None and bounds[0] >= -(1 << 31) \
        and bounds[1] <= (1 << 31) - 1


def _same_dictionary(a, b) -> bool:
    if a is b:
        return True
    if a is None or b is None:
        return False
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return len(a) == len(b) and bool(np.array_equal(a, b))
    return False  # a hashed-string lookup: the same object only


def _packed_keys_compatible(pl: PackedPiece, pr: PackedPiece,
                            left_on, right_on) -> bool:
    """Packed joins cannot promote keys inside the lanes — the pipeline
    promotes BEFORE packing.  Any residual mismatch (dtype, dictionary)
    takes the materialized path, which promotes like any other join."""
    for ln, rn in zip(left_on, right_on):
        i, j = pl.column_names.index(ln), pr.column_names.index(rn)
        if pl.spec.cols[i].dtype != pr.spec.cols[j].dtype:
            return False
        if pl.meta[i][1] != pr.meta[j][1]:
            return False
        dl, dr = pl.meta[i][2], pr.meta[j][2]
        if (dl is not None or dr is not None) \
                and not _same_dictionary(dl, dr):
            return False
    return True


class _LazyCounts:
    """A dispatched, not yet pulled device count: shared by a
    DeferredTable's ``counts_thunk`` and its materialize thunk, so the
    host waits at most once, and only when someone needs the counts."""

    __slots__ = ("_dev", "value")

    def __init__(self, dev):
        self._dev = dev
        self.value = None

    def __call__(self) -> np.ndarray:
        if self.value is None:
            self.value = host_array(self._dev).astype(np.int64).reshape(-1)
            self._dev = None
        return self.value


def _packed_statics(pl: PackedPiece, pr: PackedPiece, left_on, right_on,
                    how: str, suffixes, coalesce_keys: bool):
    """Every static input of the packed join, from the pieces' metadata
    alone."""
    names_l, names_r = pl.column_names, pr.column_names
    kil = tuple(names_l.index(n) for n in left_on)
    kir = tuple(names_r.index(n) for n in right_on)
    need_nf = tuple((pl.spec.cols[i].valid_bit >= 0)
                    or (pr.spec.cols[j].valid_bit >= 0)
                    for i, j in zip(kil, kir))
    narrow = tuple(_fits32_meta(pl.spec.cols[i].dtype, pl.meta[i][3])
                   and _fits32_meta(pr.spec.cols[j].dtype, pr.meta[j][3])
                   for i, j in zip(kil, kir))
    coalesce = coalesce_keys and list(left_on) == list(right_on)
    key_set_l, key_set_r = set(left_on), set(right_on)
    overlap = (set(names_l) & set(names_r)) - (
        key_set_l if coalesce else set())
    plan, names, types, dicts, bounds = [], [], [], [], []
    for i, (n, t, dc, nb) in enumerate(pl.meta):
        has_v = pl.spec.cols[i].valid_bit >= 0
        if coalesce and n in key_set_l:
            j = kir[left_on.index(n)]
            rnb = pr.meta[j][3]
            rv = pr.spec.cols[j].valid_bit >= 0
            bounds.append(None if nb is None or rnb is None
                          else (min(nb[0], rnb[0]), max(nb[1], rnb[1])))
            if how in ("inner", "left"):
                plan.append(("l", i, has_v))
            elif how == "right":
                plan.append(("r", j, rv))
            else:
                plan.append(("k", i, j, has_v or rv))
        else:
            plan.append(("l", i, has_v or how in ("right", "outer")))
            bounds.append(nb)
            n = n + suffixes[0] if n in overlap else n
        names.append(n)
        types.append(t)
        dicts.append(dc)
    for j, (n, t, dc, nb) in enumerate(pr.meta):
        if coalesce and n in key_set_r:
            continue
        rv = pr.spec.cols[j].valid_bit >= 0
        plan.append(("r", j, rv or how in ("left", "outer")))
        names.append(n + suffixes[1] if n in overlap else n)
        types.append(t)
        dicts.append(dc)
        bounds.append(nb)

    def can_carry(spec) -> bool:
        return how in ("inner", "left") and any(c.lanes for c in spec.cols)

    carry_emit = can_carry(pl.spec) and pl.spec.n_lanes <= 6
    carry_match = can_carry(pr.spec) and pr.spec.n_lanes <= 8
    all_live = bool((pl.lens == pl.piece_cap).all()
                    and (pr.lens == pr.piece_cap).all())
    return (kil, kir, need_nf, narrow, coalesce, tuple(plan), tuple(names),
            tuple(types), tuple(dicts), tuple(bounds), carry_emit,
            carry_match, all_live)


def _join_packed_impl(pl: PackedPiece, pr: PackedPiece, left_on, right_on,
                      how: str, suffixes, coalesce_keys: bool,
                      allow_defer: bool) -> Table:
    env = pl.env
    if pr.env is not env and (pr.env.device != env.device
                              or pr.env.world_size != env.world_size):
        raise InvalidError("pieces belong to different CylonEnvs")
    (kil, kir, need_nf, narrow, coalesce, plan, names, types, dicts,
     bounds, carry_emit, carry_match, all_live) = _packed_statics(
        pl, pr, left_on, right_on, how, suffixes, coalesce_keys)
    w = env.world_size
    cap_l, cap_r = pl.piece_cap, pr.piece_cap
    vcl = np.asarray(pl.lens, np.int32)
    vcr = np.asarray(pr.lens, np.int32)

    def count(slim: bool):
        def one(r):
            mat_l, f64_l = pl.window(r)
            mat_r, f64_r = pr.window(r)
            l_datas, l_valids = _window_keys(pl.spec, mat_l, f64_l, kil)
            r_datas, r_valids = _window_keys(pr.spec, mat_r, f64_r, kir)
            return _count(vcl[r:r + 1], vcr[r:r + 1], l_datas, l_valids,
                          r_datas, r_valids, narrow, how,
                          mat_l if carry_emit else None,
                          mat_r if carry_match else None, all_live, slim)
        return map_shards(one, w)

    def materialize(carry_of, pl_s, out_cap: int):
        def one(r):
            mat_l, f64_l = pl.window(r)
            mat_r, f64_r = pr.window(r)
            return _materialize(
                carry_of(r), tuple(shard(p, w, r) for p in pl_s), how,
                out_cap, cap_l, plan, pl.spec, pr.spec,
                _window_source(pl.spec, mat_l, f64_l, cap_l),
                _window_source(pr.spec, mat_r, f64_r, cap_r),
                carry_emit, carry_match)
        return map_shards(one, w, cap=out_cap)

    defer = (config.DEFER_JOIN and how == "inner" and carry_emit
             and carry_match and coalesce and allow_defer)
    if defer:
        with timing.region("join.sort_count"):
            n_dev, idx_s_s, bnd_s, pl_s = count(slim=True)
        # the counts stay ON DEVICE: the next piece's work can be queued
        # before this piece's host wait, and a fused consumer that drains
        # the state never pulls them at all
        holder = _LazyCounts(n_dev)

        def materialize_cols():
            out_cap = config.pow2ceil(int(holder().max()))

            def carry_of(r):
                live = None if all_live else _live_cat(
                    vcl[r:r + 1], vcr[r:r + 1], cap_l, cap_r, env.device)
                return joink.join_carry(shard(bnd_s, w, r),
                                        shard(idx_s_s, w, r), live, cap_l,
                                        how)[1]
            with timing.region("join.materialize"):
                out_d, out_v = materialize(carry_of, pl_s, out_cap)
            return {nme: Column(d, t, v, dc, bounds=b)
                    for nme, d, v, t, dc, b in
                    zip(names, out_d, out_v, types, dicts, bounds)}

        from .fused import JoinState
        state = JoinState(
            vcl=vcl, vcr=vcr, idx_s=idx_s_s, bnd=bnd_s, pl_s=pl_s,
            lspec=pl.spec, rspec=pr.spec, plan=plan, names=names,
            types=types, dicts=dicts, key_names=tuple(left_on),
            cap_l=cap_l, cap_r=cap_r, all_live=all_live)
        out = DeferredTable(
            env, None, None, materialize_cols,
            (names, types, dicts, tuple(bool(e[-1]) for e in plan)),
            op_state=state, counts_thunk=holder)
        out.grouped_by = tuple(left_on)
        return out

    with timing.region("join.sort_count"):
        n_dev, carry, pl_s = count(slim=False)
        counts = host_array(n_dev).astype(np.int64).reshape(w)
    out_cap = config.pow2ceil(int(counts.max()))
    with timing.region("join.materialize"):
        out_d, out_v = materialize(
            lambda r: joink.JoinCarry(*(shard(c, w, r) for c in carry)),
            pl_s, out_cap)
    out = build_table(names, out_d, out_v, types, dicts, counts, env,
                      bounds=bounds)
    if coalesce:
        # pieces are key-grouped (sorted windows): the same grouped
        # contract as the monolithic join
        out.grouped_by = tuple(left_on)
    return out


def _join_packed_entry(left, right, left_on, right_on, how: str, suffixes,
                       coalesce_keys: bool, allow_defer: bool):
    left_on = [left_on] if isinstance(left_on, str) else list(left_on)
    right_on = [right_on] if isinstance(right_on, str) else list(right_on)
    if len(left_on) != len(right_on) or not left_on:
        raise InvalidError("left_on/right_on must be equal-length, non-empty")
    pl = left if isinstance(left, PackedPiece) else None
    pr = right if isinstance(right, PackedPiece) else None
    if (pl is not None and pr is not None
            and how in ("inner", "left", "right", "outer")
            and _packed_keys_compatible(pl, pr, left_on, right_on)):
        from ..exec.recovery import maybe_inject
        maybe_inject("join.piece_cap")   # the cap-overflow test point
        return _join_packed_impl(pl, pr, left_on, right_on, how, suffixes,
                                 coalesce_keys, bool(allow_defer))
    # a piece joined with a Table, or keys the lanes cannot promote:
    # materialize the window(s) and take the colocated path
    lt = pl.to_table() if pl is not None else left
    rt = pr.to_table() if pr is not None else right
    return join_tables(lt, rt, left_on, right_on, how=how,
                       suffixes=suffixes, coalesce_keys=coalesce_keys,
                       assume_colocated=True, allow_defer=allow_defer)
