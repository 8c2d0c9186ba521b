"""Local join kernel: single-sort merge + scan geometry (port of
``cylon_tpu/ops/join.py``).

  1. ``join_sort_state``: ONE stable lexicographic sort of the
     concatenated (left ++ right) key operands.  Stability puts left rows
     before right rows inside every equal-key run, so the sorted order
     encodes the merge.
  2. ``join_carry``: per-position geometry from prefix sums and values
     read at each key run's first or last position.
  3. ``join_take``: output expansion — a sorted search finds the emitting
     row that owns each output slot, then ONE stacked gather gives every
     slot its geometry and carried lanes.

All per-position arrays are int32, as in the reference, so both packages
produce bit-equal state.  The multi-operand ``lax.sort`` has no single
torch call: operands fold into int64 words and sort LSD-composed
(``pack.sort_words`` / ``pack.lex_sort_perm``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .pack import KeyOps, concat_keyops, lex_sort_perm, neighbor_flags, sort_words

_I32 = torch.int32


def cumsum32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum (wraps like the reference's int32 scan)."""
    return torch.cumsum(x, 0, dtype=_I32)


class Runs(NamedTuple):
    """Geometry of the key runs of a sorted state."""
    gid: torch.Tensor     # (n,) int32 run id of each position
    starts: torch.Tensor  # (n_runs,) int64 first position of each run
    ends: torch.Tensor    # (n_runs,) int64 last position of each run


def runs_of(first: torch.Tensor) -> Runs:
    """Run geometry of boundary flags ``first`` (``first[0]`` set).  Sizing
    the run arrays waits for the device once."""
    n = first.shape[0]
    gid = cumsum32(first.to(_I32)) - 1
    starts = torch.nonzero(first).squeeze(1)
    ends = torch.cat([starts[1:] - 1, starts.new_full((min(n, 1),), n - 1)])
    return Runs(gid, starts, ends)


# The reference broadcasts a value from each run's first (last) position
# over the run with a forward cummax (reverse cummin) of the masked values,
# which is exact because the values it broadcasts are non-decreasing from
# run to run; on the TPU the scan spares a gather.  On the card torch's
# cummax/cummin track an index and run a slow scan-with-indices kernel
# (measured in PERF.md), while gathers are cheap, so the port reads the
# value at the run's start (end) directly: the same numbers.

def at_run_start(x: torch.Tensor, runs: Runs) -> torch.Tensor:
    """``x`` at the first position of each position's run — the reference's
    ``cummax(where(first, x, 0))`` for ``x >= 0`` non-decreasing over run
    starts."""
    return x[runs.starts][runs.gid]


def at_run_end(x: torch.Tensor, runs: Runs) -> torch.Tensor:
    """``x`` at the last position of each position's run — the reference's
    reverse ``cummin(where(last, x, INT32_MAX))`` for ``x`` non-decreasing
    over run ends."""
    return x[runs.ends][runs.gid]


class JoinCarry(NamedTuple):
    """Per-sorted-position state carried from count to materialize phase.
    All (n_l + n_r,) int32 tensors."""
    offs: torch.Tensor    # exclusive prefix sum of eff (output offset)
    eff: torch.Tensor     # output rows this position emits
    cnt: torch.Tensor     # match count of the position's group (other side)
    mstart: torch.Tensor  # sorted position where this row's matches start
    idx_s: torch.Tensor   # concat-row index at this sorted position
    un: torch.Tensor      # outer only: 1 = unmatched right row (else zeros)


def join_sort_state(ko_l: KeyOps, ko_r: KeyOps, payloads: tuple = ()):
    """THE sort: stable lexicographic sort of the concatenated key tuples.

    Returns ``(bnd, idx_s, sorted_payloads)``: ``idx_s[p]`` is the concat-
    row index at sorted position p (values < n_l are left rows); ``bnd[p]``
    = 1 iff position p starts a new key group (p=0 -> 0).  ``payloads``
    are (n_l+n_r,) tensors carried through the sort."""
    cat = concat_keyops(ko_l, ko_r)
    words = sort_words(cat)
    del cat
    perm = lex_sort_perm(words)
    bnd = neighbor_flags([w[perm] for w, _ in words], [k for _, k in words])
    del words
    sorted_payloads = tuple(p[perm] for p in payloads)
    return bnd, perm.to(_I32), sorted_payloads


def join_carry(bnd, idx_s, live_cat, n_l: int, how: str) -> tuple:
    """Phase-1 geometry: ``(total, JoinCarry)`` with ``total`` the exact
    output row count (0-dim int32 tensor).  ``live_cat=None`` asserts
    every concat row is live and skips the liveness gather."""
    n = bnd.shape[0]
    dev = bnd.device
    pos = torch.arange(n, dtype=_I32, device=dev)
    side = idx_s >= n_l
    if live_cat is None:
        lefts = (~side).to(_I32)
        rights = side.to(_I32)
    else:
        live = live_cat[idx_s.long()]
        lefts = ((~side) & live).to(_I32)
        rights = (side & live).to(_I32)
    runs = runs_of(bnd.bool() | (pos == 0))

    s_l = cumsum32(lefts)
    s_r = cumsum32(rights)

    emit_right = how == "right"
    keep_unmatched = how in ("left", "right", "outer")
    need_fwd = emit_right or how == "outer"

    if need_fwd:
        # S_l exclusive at the group start, broadcast forward
        b_l = at_run_start(s_l - lefts, runs)

    if emit_right:
        cnt = s_l - b_l
        mstart = at_run_start(pos, runs)
        emits = rights != 0
    else:
        # S_l/S_r at the group END, broadcast backward
        e_l = at_run_end(s_l, runs)
        e_r = at_run_end(s_r, runs)
        t_l = e_l - (s_l - lefts)            # lefts in [p .. end]
        cnt = e_r - (s_r - rights)           # rights in [p .. end]
        mstart = pos + t_l                   # first right position of group
        emits = lefts != 0

    eff = torch.where(emits, cnt.clamp_min(1) if keep_unmatched else cnt,
                      0).to(_I32)
    csum = cumsum32(eff)
    offs = csum - eff
    total = csum[-1] if n > 0 else torch.zeros((), dtype=_I32, device=dev)

    if how == "outer":
        grp_l = s_l - b_l
        un = ((rights != 0) & (grp_l == 0)).to(_I32)
        total = total + un.sum(dtype=_I32)
    else:
        un = torch.zeros(n, dtype=_I32, device=dev)
    return total, JoinCarry(offs, eff, cnt, mstart, idx_s, un)


class JoinTake(NamedTuple):
    """Phase-2 expansion state, all (out_cap,) tensors over output slots
    (see the reference for the outer-join ``valid`` caveat)."""
    total: torch.Tensor   # 0-dim int32: exact output rows
    valid: torch.Tensor   # bool: slot holds a main-emission output row
    matched: torch.Tensor  # bool: slot's match-side row exists
    mpos: torch.Tensor    # int32: sorted position of the match-side row
    l_take: object        # left row index or -1; None if suppressed
    r_take: object        # right row index or -1; None if suppressed
    extra: tuple          # carried emit-side lanes at the owning row


def _set_drop(dst: torch.Tensor, index: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
    """``dst.at[index].set(src, mode="drop")`` for indices that are unique
    inside [0, len(dst)): every other element writes to a slot of its own
    past the end, sliced off (no host wait for a mask, and no two writes
    to one address)."""
    m, n = dst.shape[0], index.shape[0]
    keep = (index >= 0) & (index < m)
    slot = torch.where(keep, index.long(),
                       m + torch.arange(n, device=index.device))
    ext = torch.cat([dst, dst.new_empty(n)])
    return ext.scatter_(0, slot, src.to(dst.dtype))[:m]


def join_take(carry: JoinCarry, n_l: int, how: str, out_cap: int,
              extra: tuple = (), carry_emit: bool = False,
              carry_match: bool = False, emit_idx: bool = False,
              match_idx: bool = False) -> JoinTake:
    """Phase-2 materialization over ``out_cap`` output slots (>= phase 1's
    total).  Specialization knobs as in the reference: ``carry_emit``
    (emit-side lanes arrive in ``extra``), ``carry_match`` (match-side
    lanes ride the sorted payload, gathered by the caller at ``mpos``),
    ``emit_idx``/``match_idx`` (keep the take array beside carried lanes
    for the f64 side columns)."""
    offs, eff, cnt, mstart, idx_s, un = carry
    n = offs.shape[0]
    dev = offs.device
    pos = torch.arange(n, dtype=_I32, device=dev)
    total_main = (offs[-1] + eff[-1]) if n > 0 \
        else torch.zeros((), dtype=_I32, device=dev)

    # emitting rows have strictly increasing offs, so the owner of slot k
    # is the last emitting row with offs <= k (slots before the first one
    # get row 0) — the reference's scatter + cummax fill, as a search
    emit = eff > 0
    e_offs, e_pos = offs[emit], pos[emit]
    k = torch.arange(out_cap, dtype=_I32, device=dev)
    if e_pos.numel():
        j = torch.searchsorted(e_offs, k, right=True) - 1
        p_of_k = torch.where(j >= 0, e_pos[j.clamp_min(0)], 0).long()
    else:
        p_of_k = torch.zeros(out_cap, dtype=torch.int64, device=dev)

    need_cnt = how != "inner"
    need_own_idx = (not carry_emit) or emit_idx
    meta_cols = [offs, mstart]
    if need_cnt:
        meta_cols.append(cnt)
    if need_own_idx:
        meta_cols.append(idx_s)
    meta_cols.extend(extra)
    meta = torch.stack(meta_cols, dim=1)[p_of_k]    # THE (out, M) gather
    rel = k - meta[:, 0]
    valid = k < total_main
    matched = valid if how == "inner" else valid & (rel < meta[:, 2])
    mpos = (meta[:, 1] + rel).clamp(0, max(n - 1, 0))
    ci = 2 + int(need_cnt)
    own_idx = meta[:, ci] if need_own_idx else None
    extra_out = tuple(meta[:, ci + int(need_own_idx) + j]
                      for j in range(len(extra)))
    m_idx = None if (carry_match and not match_idx) else idx_s[mpos.long()]

    l_take = r_take = None
    if how == "right":
        if need_own_idx:
            r_take = torch.where(valid, own_idx - n_l, -1).to(_I32)
        if m_idx is not None:
            l_take = torch.where(matched, m_idx, -1).to(_I32)
    else:
        if need_own_idx:
            l_take = torch.where(valid, own_idx, -1).to(_I32)
        if m_idx is not None:
            r_take = torch.where(matched, m_idx - n_l, -1).to(_I32)

    total = total_main
    if how == "outer":
        unpos = cumsum32(un) - un
        slot = torch.where(un > 0, total_main + unpos, out_cap)
        r_take = _set_drop(r_take, slot, idx_s - n_l)
        total = total_main + un.sum(dtype=_I32)
    return JoinTake(total, valid, matched, mpos, l_take, r_take, extra_out)
