"""The two-hop exchange (port of ``cylon_tpu/topo/exchange.py``).

One logical exchange, with the flat route's inputs and outputs, runs as
two hops on a two-tier fabric:

* **hop 1, inside the slice**: every row goes to its destination's
  gateway, the rank of its own slice whose local index is the final
  destination's (model.gateway_of); the final target rides along as
  one int32 column;
* **hop 2, across slices**: only ranks of the same local index
  exchange, so each rank sends one aggregated message to each other
  slice: the cross-slice message count is exactly 1/R of the flat
  route's (:func:`tier_traffic`), R being the ranks per slice.

**Order.** Ranks are numbered slice-major.  Hop 1's receive order at
gateway (s, j) is (local source i, source position); hop 2's stable
per-target order keeps it and puts the source slices in ascending order,
which composes to (global source rank s·R + i, source position): the
flat route's order.  The result is bit-equal, capacities included.

Each hop is the port's own exchange engine driven by that hop's count
matrix (parallel/shuffle._move): in one process the device-local stable
sort and gather; across processes ``_exchange_procs`` on the hop's
process subgroup (parallel/transport.hop_groups) in bounded rounds sized
by :func:`hop_block`.  Both hop matrices are host arithmetic on the
count matrix the exchange already pulled (:func:`hop_counts`): the route
adds no host sync.  :class:`HopPrep` checks the four conservation
identities on every exchange through the integrity tier
(exec/integrity.conserve_hops), which counts them and raises
``DataIntegrityError``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config


# ---------------------------------------------------------------------------
# host arithmetic: the hops' count matrices from the exchange's
# ---------------------------------------------------------------------------

def hop_counts(counts: np.ndarray, n_slices: int) -> tuple:
    """(C1, C2): the two hops' (W, W) count matrices from the exchange's
    count matrix C.

    ``C1[(s,i), (s,j)] = Σ_D C[(s,i), (D,j)]``: source (s, i) sends its
    rows bound for any rank of local index j to gateway (s, j); every
    cell of C1 lies inside a slice.

    ``C2[(s,j), (D,j)] = Σ_i C[(s,i), (D,j)]``: gateway (s, j) forwards
    slice s's rows for (D, j); every cell of C2 joins ranks of one local
    index (its diagonal stays inside the slice, the rest crosses)."""
    c = np.asarray(counts, np.int64)
    w = c.shape[0]
    s_, r_ = int(n_slices), w // int(n_slices)
    c4 = c.reshape(s_, r_, s_, r_)           # [s, i, D, j]
    c1 = np.zeros((w, w), np.int64)
    c2 = np.zeros((w, w), np.int64)
    m1 = c4.sum(axis=2)                      # [s, i, j]
    m2 = c4.sum(axis=1)                      # [s, D, j]
    for s in range(s_):
        c1[s * r_:(s + 1) * r_, s * r_:(s + 1) * r_] = m1[s]
        for d in range(s_):
            c2[s * r_ + np.arange(r_), d * r_ + np.arange(r_)] = m2[s, d]
    return c1, c2


def hop_block(counts_hop: np.ndarray, total: int, w: int,
              group: int) -> tuple[int, int]:
    """(block, rounds) of one hop: the flat route's sizing with ``w·group``
    cells in place of ``w²`` (about twice the uniform stream, floored for
    small tables), the rounds bounding each round's send memory."""
    max_c = int(counts_hop.max()) if counts_hop.size else 1
    uniform = -(-int(total) // max(w * group, 1))
    cap = config.pow2ceil(max(2 * uniform, 8192))
    block = config.pow2ceil(min(max(max_c, 1), cap))
    rounds = -(-max_c // block) if max_c else 1
    return block, max(rounds, 1)


class HopPrep:
    """One exchange's two-hop schedule, derived once: both hop count
    matrices, their blocks and rounds, the rows each gateway receives and
    the gateway capacity."""

    __slots__ = ("c1", "c2", "block1", "rounds1", "block2", "rounds2",
                 "per_gw", "cap1")

    def __init__(self, plan, counts: np.ndarray):
        w = counts.shape[0]
        total = int(counts.sum()) if counts.size else 0
        self.c1, self.c2 = hop_counts(counts, plan.n_slices)
        self.block1, self.rounds1 = hop_block(self.c1, total, w,
                                              plan.ranks_per_slice)
        self.block2, self.rounds2 = hop_block(self.c2, total, w,
                                              plan.n_slices)
        #: rows each gateway receives (C1's column sums): hop 2's valid
        #: counts
        self.per_gw = self.c1.sum(axis=0)
        #: the gateways' receive capacity (pow2): a gateway gathers its
        #: whole slice's rows for one local index
        self.cap1 = config.pow2ceil(int(self.per_gw.max())
                                    if self.per_gw.size else 1)
        from ..exec import integrity
        integrity.conserve_hops(counts, self.c1, self.c2)


def prepare(plan, counts: np.ndarray) -> HopPrep:
    """The two-hop schedule of one exchange (:class:`HopPrep`), which the
    guard, the tier counters and :func:`two_hop` share."""
    return HopPrep(plan, counts)


def recv_guard_bytes(plan, prep: HopPrep, out_cap: int,
                     row_bytes: int) -> int:
    """The two-hop route's peak receive in bytes: the gateway buffers
    (payload plus the 4-byte target column) are still alive, as hop 2's
    inputs, while the final buffers fill, so the peak is their sum."""
    return prep.cap1 * (int(row_bytes) + 4) + out_cap * int(row_bytes)


def tier_traffic(plan, counts: np.ndarray, row_bytes: int, route: str,
                 prep: HopPrep | None = None,
                 flat_block_rounds: tuple | None = None) -> dict:
    """Each tier's padded wire bytes and (source, destination, round)
    message count for one exchange on ``route``, as the reference's
    padded all-to-all rounds count them.  Cross-slice payload is the
    same on both routes; the two-hop route's gain is the cross-slice
    message count, W·(S−1) per round instead of W·(W−R): exactly 1/R.

    ``route == "flat"``: W² cells at the flat block
    (``flat_block_rounds`` passes the flat route's (block, rounds));
    otherwise hop 1 (inside the slice) and hop 2 (its diagonal inside,
    the rest across) at ``prep``'s blocks."""
    w = counts.shape[0]
    s_, r_ = plan.n_slices, plan.ranks_per_slice
    total = int(counts.sum()) if counts.size else 0
    rb = int(row_bytes)
    if route == "flat":
        if flat_block_rounds is not None:
            block, rounds = flat_block_rounds
        else:
            from ..parallel.shuffle import exchange_block_cap
            max_c = int(counts.max()) if counts.size else 1
            block = config.pow2ceil(min(max(max_c, 1),
                                        exchange_block_cap(total, w)))
            rounds = -(-max_c // block) if max_c else 1
        rounds = max(int(rounds), 1)
        return {"wire_ici": w * r_ * block * rounds * rb,
                "wire_dcn": w * (w - r_) * block * rounds * rb,
                "msgs_ici": w * r_ * rounds,
                "msgs_dcn": w * (w - r_) * rounds}
    p = prep if prep is not None else HopPrep(plan, counts)
    return {"wire_ici": (w * r_ * p.block1 * p.rounds1
                         + w * 1 * p.block2 * p.rounds2) * rb,
            "wire_dcn": w * (s_ - 1) * p.block2 * p.rounds2 * rb,
            "msgs_ici": w * r_ * p.rounds1 + w * 1 * p.rounds2,
            "msgs_dcn": w * (s_ - 1) * p.rounds2}


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

_HOP_STATS = ("bytes_sent", "staging_s", "wire_s")


def _hop(env, hop: int, tgt, counts, cols, cap, group):
    """One hop through the exchange engine, its transport bytes and
    seconds added to ``transport.STATS["hop<n>_*"]``."""
    from ..parallel import shuffle as shf
    from ..parallel import transport
    before = [transport.STATS[k] for k in _HOP_STATS]
    outs = shf._move(env, tgt, counts, cols, cap, group)
    for k, b, name in zip(_HOP_STATS, before,
                          ("bytes", "staging_s", "wire_s")):
        transport.STATS[f"hop{hop}_{name}"] += transport.STATS[k] - b
    return outs


def two_hop(env, plan, tgt: torch.Tensor, counts: np.ndarray, cols: tuple,
            out_cap: int, prep: HopPrep | None = None):
    """Run one exchange on the voted two-hop route: hop 1 inside the
    slice with the final target as an extra int32 column, then hop 2
    across slices.  Returns what the flat route returns: ``(outs, per-
    destination counts)``, the same values, order and pow2 capacities.
    ``tgt`` is this process's ``(V·cap,)`` int32 targets (W: padding);
    ``counts`` the replicated (W, W) count matrix."""
    from ..parallel import transport
    from ..parallel.shards import span
    from ..relational.common import live_mask
    from ..utils import timing

    w = counts.shape[0]
    r_ = plan.ranks_per_slice
    p = prep if prep is not None else HopPrep(plan, counts)
    timing.bump("exchange.two_hop")
    if p.rounds1 > 1 or p.rounds2 > 1:
        timing.bump("exchange.multiround")
    proc = transport.current(w)
    g1 = g2 = None
    if proc is not None and proc.nproc > 1:
        g1, g2 = transport.hop_groups(plan.n_slices, r_)

    # hop 1: each row to its destination's gateway in its own slice; the
    # trash target W passes through
    ranks = span(w)
    cap = tgt.shape[0] // len(ranks)
    dev = tgt.device
    src = torch.arange(ranks.start, ranks.stop, dtype=torch.int32,
                       device=dev).repeat_interleave(cap)
    gate = (src // r_) * r_ + tgt.clamp(0, w - 1) % r_
    tgt1 = torch.where(tgt < w, gate, torch.full((), w, dtype=torch.int32,
                                                 device=dev))
    del src, gate
    outs1 = _hop(env, 1, tgt1, p.c1, tuple(cols) + (tgt,), p.cap1, g1)
    del tgt1

    # hop 2: a gateway's first per_gw rows go to their carried target,
    # its padding to the trash target
    carried = outs1[-1]
    tgt2 = torch.where(live_mask(p.per_gw, p.cap1, dev),
                       carried.clamp(0, w - 1),
                       torch.full((), w, dtype=torch.int32, device=dev))
    del carried
    outs = _hop(env, 2, tgt2, p.c2, outs1[:-1], out_cap, g2)
    return outs, counts.sum(axis=0).astype(np.int64)
