"""Fused join→groupby: aggregate through the join without materializing it
(port of ``cylon_tpu/relational/fused.py``).

When a groupby's keys are exactly an inner join's keys and every
aggregation is multiplicity-algebraic, the per-group answer comes from the
join's pre-expansion sorted state: over the join output, group g holds
the L_g × R_g cross product, so

  sum(c_left)   = S_g(c) · R_g          count(c_left) = C_g(c) · R_g
  mean(c_left)  = S_g(c) / C_g(c)       var/std: moments scale by R_g

with S/C the masked sum/count of c over the group's left rows of the
sorted state (symmetrically with L_g for right columns).  S, C, L and R
all come out of ``ops/groupby.grouped_reduce`` — prefix sums and ONE
gather at the run starts.

Dispatch keeps the reference's discipline: a first sight of a large state
dispatches at a small segment space, and the returned group count and the
windowed gather's ``ok`` flag (pulled together, one host wait) trigger a
redispatch at the right size, or without the window after a span
overflow.  ``_SEG_CACHE`` remembers the outcome per call site.  The
reference's ``_pad_ladder``, ``pad_lanes`` and ``gather_parts`` exist only
to dodge XLA:TPU compiler crashes and have no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..core.dtypes import LogicalType
from ..core.table import DeferredTable, Table
from ..ctx.context import CylonEnv, VirtualMeshConfig
from ..ops import groupby as gbk
from ..ops import lanes
from ..ops import windowed_gather as wg
from ..ops.join import at_run_end, at_run_start, cumsum32, runs_of
from ..parallel.shards import map_shards, shard
from ..utils.host import host_array
from .common import BoundedCache

#: ops whose join pushdown is exact multiplicity algebra
PUSHDOWN_OPS = {"sum", "count", "mean", "var", "std", "sumsq"}

#: callsite-signature -> (kept-group bucket, windowed allowed, window)
_SEG_CACHE = BoundedCache()

_I32 = torch.int32


class JoinState(NamedTuple):
    """Pre-expansion inner-join state a DeferredTable carries for the fused
    consumer (built in relational/join.py).  Per-shard arrays are W
    blocks of N = cap_l + cap_r rows, shard-major."""
    vcl: np.ndarray          # (W,) left valid counts per shard
    vcr: np.ndarray          # (W,) right valid counts per shard
    idx_s: torch.Tensor      # (W·N,) int32 shard-local concat-row index
    bnd: torch.Tensor        # (W·N,) int32 key-boundary flags
    pl_s: tuple              # sorted payload lanes: left lanes ++ right lanes
    lspec: lanes.LaneSpec
    rspec: lanes.LaneSpec
    plan: tuple              # output plan entries parallel to names
    names: tuple
    types: tuple
    dicts: tuple
    key_names: tuple         # join-key output column names (== left_on)
    cap_l: int
    cap_r: int
    all_live: bool
    #: the finalized skew plan (relational/skew.SkewPlan) when the join
    #: took the skew split: a heavy key's rows span its rank group, so
    #: the fused rows of those keys are per-member PARTIALS that
    #: ``skew.combine_heavy_partials`` folds.  None for the hash plan.
    skew_plan: object = None
    #: with ``skew_plan``: materializes the SPLIT-layout join output
    #: without the stitch, for a groupby the pushdown declines
    #: (``skew.consume_unstitched``)
    pre_thunk: object = None

    @staticmethod
    def from_reference_state(fields, device) -> "JoinState":
        """Carry a ``cylon_tpu`` JoinState across without importing it.

        ``fields`` maps the reference field names to plain values: ``vcl``,
        ``vcr`` (one count per rank), ``idx_s``, ``bnd`` and ``pl_s`` as
        the reference's global (W·N,) host arrays (uint32 lanes keep their
        bits), ``lspec``/``rspec`` as plain tuples
        ``(cols, n_lanes, valid_lane0)`` with each col ``(dtype, lanes,
        valid_bit, narrow)``, ``types`` as logical-type names, the rest as
        the reference holds them.  ``device`` is a device name or a
        :class:`CylonEnv`."""
        dev = device.device if isinstance(device, CylonEnv) \
            else torch.device(device)

        def t32(a):
            return torch.from_numpy(np.array(a).view(np.int32)).to(dev)

        def spec(s):
            cols, n_lanes, v0 = s
            return lanes.LaneSpec(
                tuple(lanes.ColLanes(str(d), tuple(int(x) for x in ls),
                                     int(vb), bool(nw))
                      for d, ls, vb, nw in cols), int(n_lanes), int(v0))

        return JoinState(
            vcl=np.asarray(fields["vcl"], np.int32),
            vcr=np.asarray(fields["vcr"], np.int32),
            idx_s=t32(fields["idx_s"]), bnd=t32(fields["bnd"]),
            pl_s=tuple(t32(p) for p in fields["pl_s"]),
            lspec=spec(fields["lspec"]), rspec=spec(fields["rspec"]),
            plan=tuple(tuple(e) for e in fields["plan"]),
            names=tuple(fields["names"]),
            types=tuple(LogicalType(t) for t in fields["types"]),
            dicts=tuple(fields["dicts"]),
            key_names=tuple(fields["key_names"]),
            cap_l=int(fields["cap_l"]), cap_r=int(fields["cap_r"]),
            all_live=bool(fields["all_live"]))

    def deferred_table(self, env: CylonEnv | None = None) -> DeferredTable:
        """A DeferredTable over this state alone, for driving the fused
        stage by itself: reading its columns raises (it has no join
        inputs to materialize from).  ``env`` defaults to a world of
        ``len(vcl)`` ranks on the state's device."""
        def no_inputs():
            raise NotImplementedError(
                "a DeferredTable built from a bare JoinState cannot "
                "materialize: it holds no join inputs")
        w = len(self.vcl)
        env = env or CylonEnv(VirtualMeshConfig(w), device=self.idx_s.device)
        return DeferredTable(
            env, np.zeros(w, np.int64), 1, no_inputs,
            (self.names, self.types, self.dicts,
             tuple(bool(e[-1]) for e in self.plan)),
            op_state=self)


def _col_entry(state: JoinState, name: str):
    """(side, lane-col-index) of output column ``name`` in the carried
    state; None when the column is not a plain carried l/r column."""
    try:
        i = state.names.index(name)
    except ValueError:
        return None
    e = state.plan[i]
    if e[0] in ("l", "r"):
        return e[0], e[1]
    return None


def fused_shard(vcl, vcr, idx_s, bnd, pl_s, n_l: int, all_live: bool,
                lspec, rspec, vspecs: tuple, key_cols: tuple,
                key_narrow: tuple, seg_cap: int, ddof: int,
                use_window: int = 0):
    """One rank's fused join+groupby (the reference's ``per_shard``):
    ``vcl``/``vcr`` hold that rank's one count each.

    ``vspecs``: per aggregation (side, lane_col_idx, op); ``key_cols``:
    left lane-col index per groupby key.  Live rows form a sorted PREFIX
    (the liveness operand sorts padding last), so liveness is a position
    compare.  Returns (key_out, kval_out, res_d, res_v, meta) with meta =
    [n_groups, win_ok] as one int32 tensor (one host pull)."""
    N = bnd.shape[0]
    dev = bnd.device
    # live rows are the sorted prefix [0, n_live); empty run-start slots
    # hold n_live (the reference holds N — see the note at `starts`)
    n_live = N if all_live else int(vcl[0]) + int(vcr[0])
    pos = torch.arange(N, dtype=_I32, device=dev)
    side_r = idx_s >= n_l
    if all_live:
        live = torch.ones(N, dtype=torch.bool, device=dev)
    else:
        live = pos < n_live
    lefts_b = ~side_r & live
    rights_b = side_r & live
    del side_r
    lefts = lefts_b.to(_I32)
    rights = rights_b.to(_I32)
    first = bnd.bool() | (pos == 0)
    runs = runs_of(first)
    s_l = cumsum32(lefts)
    s_r = cumsum32(rights)
    # own group's left/right count, per position: prefix at the group's
    # end minus the exclusive prefix at its start
    l_grp = at_run_end(s_l, runs) - at_run_start(s_l - lefts, runs)
    r_grp = at_run_end(s_r, runs) - at_run_start(s_r - rights, runs)
    del lefts, rights, s_r, runs
    keep = (l_grp > 0) & (r_grp > 0) & live
    del l_grp, r_grp, live
    kstart = first & keep
    del first
    kgid = cumsum32(kstart.to(_I32)) - 1
    n_groups = (torch.where(keep, kgid, -1).max() + 1).to(_I32)
    # Empty slots point at n_live, not N as in the reference: every masked
    # lane is 0 past n_live, so the prefix sums there equal those at N and
    # the live results are identical, but the windowed gather's tile that
    # holds the last run start and the first empty slot no longer spans
    # the masked tail — with N it overflows whenever the tables carry a
    # masked tail, and the whole dispatch reruns without the window.
    starts = torch.full((seg_cap,), n_live, dtype=_I32, device=dev)
    sel = kstart & (kgid < seg_cap)
    starts[kgid[sel].long()] = pos[sel]
    del kstart, kgid, sel, pos

    nl_lanes = lspec.n_lanes
    ldat, lval = lanes.unpack_lanes(lspec, torch.stack(pl_s[:nl_lanes], 1))
    rdat, rval = lanes.unpack_lanes(rspec, torch.stack(pl_s[nl_lanes:], 1))

    def value_of(side, ci):
        d = ldat[ci] if side == "l" else rdat[ci]
        v = lval[ci] if side == "l" else rval[ci]
        vm = (lefts_b if side == "l" else rights_b) & keep
        if v is not None:
            vm = vm & v
        if d.dtype.is_floating_point:
            vm = vm & ~torch.isnan(d)
        return d, vm

    ops_list, vals, masks = [], [], []
    for side, ci, op in vspecs:
        d, vm = value_of(side, ci)
        ops_list.append(op)
        vals.append(d)
        masks.append(vm)
    # the two multiplicity counts ride the same batched pass
    ops_list += ["count", "count"]
    vals += [s_l, s_l]
    masks += [lefts_b & keep, rights_b & keep]
    del lefts_b, rights_b, keep

    key_datas = [ldat[ci] for ci in key_cols]
    key_valids = [lval[ci] for ci in key_cols]
    del ldat, lval, rdat, rval
    inters, key_out, kval_out, wok = gbk.grouped_reduce(
        ops_list, vals, masks, starts, n_live, key_datas, key_valids, seg_cap,
        key_narrow=key_narrow, use_window=use_window)
    del vals, masks, key_datas, key_valids
    l_cnt = inters[-2]["count"]
    r_cnt = inters[-1]["count"]

    res_d, res_v = [], []
    for i, (side, ci, op) in enumerate(vspecs):
        mult = r_cnt if side == "l" else l_cnt
        inter = inters[i]
        if op in ("sum", "sumsq"):
            s = inter[op]
            d, v = s * mult.to(s.dtype), None
        elif op == "count":
            d, v = inter["count"] * mult, None
        elif op == "mean":
            d, v = gbk.finalize("mean", inter, ddof)
        else:  # var/std: moments scale by mult; ddof sees the full count
            scaled = {k: (a * mult.to(a.dtype) if k != "count"
                          else a * mult) for k, a in inter.items()}
            d, v = gbk.finalize(op, scaled, ddof)
        res_d.append(d)
        res_v.append(v)
    meta = torch.stack([n_groups, wok.to(_I32)])
    return key_out, kval_out, tuple(res_d), tuple(res_v), meta


def _win_size(env: CylonEnv, sc: int, dens: float) -> int:
    """Windowed-gather request for a dispatch at segment space ``sc`` (0 =
    plain): on the card only, measured group density above the coverage
    floor, segment space big enough for the plain gather to hurt."""
    if not (env.on_cuda and config.WINDOWED_GATHER):
        return 0
    if dens < wg.MIN_DENSITY or sc < (1 << 20):
        return 0
    return wg.pick_window(dens)


class _PendingFused:
    """A DISPATCHED fused join+groupby whose meta (group count, window
    flag) has not been pulled yet.  :meth:`resolve` pulls it, redispatches
    on a segment-space or window mispredict and builds the result Table.
    The split lets a caller queue the next piece's work before waiting on
    this one's meta (``exec/pipeline.GroupBySink``)."""

    __slots__ = ("_fn",)

    def __init__(self, fn):
        self._fn = fn

    def resolve(self):
        return self._fn()


def try_join_groupby_pushdown(table: Table, by: list, specs: list,
                              ddof: int):
    """Fused path when ``table`` is an unmaterialized inner-join result and
    the groupby reduces to multiplicity algebra over its sorted state.
    Returns the result Table, or None to take another path."""
    h = try_begin_join_groupby(table, by, specs, ddof)
    return h.resolve() if h is not None else None


def try_begin_join_groupby(table: Table, by: list, specs: list, ddof: int):
    """Dispatch the fused join+groupby without waiting for its meta pull.
    Returns a :class:`_PendingFused`, or None when the fused path does not
    apply."""
    if not isinstance(table, DeferredTable) or table.materialized:
        return None
    state = table.op_state
    if not isinstance(state, JoinState):
        return None
    if tuple(by) != state.key_names:
        return None
    # under a skew plan the heavy keys' fused rows are partials, which
    # combine only for ops whose finalized value is additive in the probe
    # chunks; mean/var/std take the materialize path (unstitched)
    if state.skew_plan is not None and any(
            op not in ("sum", "count", "sumsq") for _, op, _q, _n in specs):
        return None
    vspecs = []
    for col, op, _q, _name in specs:
        if op not in PUSHDOWN_OPS:
            return None
        ent = _col_entry(state, col)
        if ent is None:
            return None
        # string value columns carry dictionary CODES in the lanes
        if (state.types[state.names.index(col)] == LogicalType.STRING
                and op != "count"):
            return None
        spec = state.lspec if ent[0] == "l" else state.rspec
        if not spec.cols[ent[1]].lanes:
            return None   # f64 column: not in the sorted lanes
        vspecs.append((ent[0], ent[1], op))
    key_cols, key_narrow = [], []
    for k in by:
        ent = _col_entry(state, k)
        if ent is None or ent[0] != "l" \
                or not state.lspec.cols[ent[1]].lanes:
            return None
        key_cols.append(ent[1])
        key_narrow.append(bool(state.lspec.cols[ent[1]].narrow))

    env = table.env
    from .groupby import _FIRST_SEG_CAP, _result_table, _result_types, _shrink

    class _C:  # stand-in with .type/.dictionary for _result_types
        def __init__(self, t, dc):
            self.type, self.dictionary = t, dc

    val_cols = [_C(state.types[state.names.index(c)],
                   state.dicts[state.names.index(c)]) for c, _, _, _ in specs]
    res_types, res_dicts = _result_types(specs, val_cols)
    by_cols = [_C(state.types[state.names.index(k)],
                  state.dicts[state.names.index(k)]) for k in by]
    res_names = [n for _, _, _, n in specs]

    cap_total = state.cap_l + state.cap_r
    sig = (env.serial, tuple(by), tuple(vspecs), state.cap_l, state.cap_r,
           int(state.vcl.sum()), int(state.vcr.sum()), ddof)

    w = env.world_size

    def call(sc, win):
        # every shard at one segment space and one window; K1 launches
        # once per shard when the window is on
        def one(r):
            return fused_shard(
                state.vcl[r:r + 1], state.vcr[r:r + 1],
                shard(state.idx_s, w, r), shard(state.bnd, w, r),
                tuple(shard(p, w, r) for p in state.pl_s), state.cap_l,
                state.all_live, state.lspec, state.rspec, tuple(vspecs),
                tuple(key_cols), tuple(key_narrow), sc, ddof, win)
        return map_shards(one, w)

    # first sight of a large state: dispatch at a modest segment space;
    # the returned n_groups detects a mispredict.  A span overflow
    # (win_ok False) disables the window for this call site.
    pred = _SEG_CACHE.get(sig)
    pred_seg, win_allowed, win = pred if pred is not None else (None, True, 0)
    if pred_seg is not None and pred_seg < cap_total:
        seg_cap = pred_seg
    elif pred_seg is None and cap_total > _FIRST_SEG_CAP:
        seg_cap = _FIRST_SEG_CAP
    else:
        seg_cap = config.pow2ceil(cap_total)
    if not win_allowed:
        win = 0
    res = call(seg_cap, win)     # queued; meta not pulled yet

    def _resolve():
        nonlocal res, seg_cap, win, win_allowed
        live = np.asarray(state.vcl, np.int64) + np.asarray(state.vcr,
                                                            np.int64)
        for _ in range(3):
            meta = host_array(res[4], world=w).astype(np.int64).reshape(
                -1, 2)
            n_groups = meta[:, 0]
            ng_cap = config.pow2ceil(int(n_groups.max())
                                     if n_groups.size else 1)
            wok = (not win) or bool(np.all(meta[:, 1]))
            if ng_cap <= seg_cap and wok:
                break
            if not wok:
                win_allowed = False
                wg.COUNTS["redispatches"] += 1
            seg_cap = max(seg_cap, ng_cap)
            dens = float((n_groups / np.maximum(live, 1)).min()) \
                if n_groups.size else 0.0
            win = _win_size(env, seg_cap, dens) if win_allowed else 0
            res = None   # free the stale result before the redispatch
            res = call(seg_cap, win)
        _SEG_CACHE.put(sig, (ng_cap, win_allowed, win))
        key_out, kval_out, res_d, res_v = res[0], res[1], res[2], res[3]
        out = _result_table(env, by, by_cols, key_out, kval_out, res_names,
                            res_d, res_v, res_types, res_dicts, n_groups)
        out = _shrink(out, n_groups)
        if state.skew_plan is not None:
            # sum each heavy key's member rows onto its home rank's row:
            # the unsplit fused plan's table, layout and all
            from .skew import combine_heavy_partials
            return combine_heavy_partials(out, list(by), res_names,
                                          state.skew_plan)
        out.grouped_by = tuple(by)
        return out

    return _PendingFused(_resolve)
