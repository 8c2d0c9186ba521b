"""Packed piece handles: window views over a lane-packed resident table
(port of ``cylon_tpu/relational/piece.py``).

The range-partitioned pipeline (exec/pipeline.py) packs each resident
sorted table ONCE into a 32-bit lane matrix (plus f64 side arrays), each
shard padded by the largest piece capacity; every range piece is then,
on every shard, a contiguous window ``[start, start + piece_cap)`` of
that shard's block.  A
:class:`PackedPiece` is a host-side descriptor of such a window: making
one costs no device work.  ``join_tables`` accepts it in place of a Table
(relational/join.py packed entry) and slices and unpacks the window
itself — the keys first, the payload lanes riding the join's sort — so no
piece is ever unpacked into full columns and re-packed.

The source owns the arrays and every piece aliases them; pieces never
outlive the source.  :meth:`PackedPiece.to_table` materializes a window:
the reference the packed join is held equal to.

The packed arrays are a spillable ledger registration (exec/memory.py):
under memory pressure they evict to host memory, and a host-resident
source uploads each piece's window alone (``memory.upload_window``), the
uploaded arrays being the window itself.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.column import Column
from ..core.table import Table
from ..ops import lanes
from ..parallel.shards import map_shards
from ..status import CapacityOverflowError


class PackedPiece:
    """Per shard r, a window ``[starts[r], starts[r] + piece_cap)`` of
    shard r's block of a :class:`PieceSource`'s packed arrays, of which
    the first ``lens[r]`` rows are live.  ``meta`` entries are ``(name,
    LogicalType, dictionary, bounds)`` parallel to ``spec.cols``."""

    __slots__ = ("env", "spec", "meta", "arrs", "starts", "lens",
                 "piece_cap", "ready")

    def __init__(self, env, spec, meta, arrs, starts, lens, piece_cap: int,
                 ready=None):
        self.env = env
        self.spec = spec
        self.meta = meta
        self.arrs = arrs
        #: an uploaded window's copy event: the consumer's stream waits on
        #: it at the first read (:meth:`window`)
        self.ready = ready
        self.starts = np.asarray(starts, np.int64)
        self.lens = np.asarray(lens, np.int64)
        self.piece_cap = int(piece_cap)
        if int(self.lens.max(initial=0)) > self.piece_cap:
            raise CapacityOverflowError(
                f"piece window of {int(self.lens.max())} live rows exceeds "
                f"the pow2 piece cap {self.piece_cap}",
                site="join.piece_cap")

    @property
    def column_names(self) -> list[str]:
        return [n for n, _, _, _ in self.meta]

    @property
    def valid_counts(self) -> np.ndarray:
        return self.lens

    @property
    def row_count(self) -> int:
        return int(self.lens.sum())

    @property
    def capacity(self) -> int:
        return self.piece_cap

    def window(self, r: int = 0):
        """Shard r's (lane-matrix window | None, tuple of f64 windows):
        views of the source's arrays, no copy."""
        if self.ready is not None:
            torch.cuda.current_stream(self.arrs[0].device).wait_event(
                self.ready)
            self.ready = None
        block = self.arrs[0].shape[0] // self.env.world_size
        s, cap = r * block + int(self.starts[r]), self.piece_cap
        has_mat = self.spec.n_lanes > 0
        mat = lanes.slice_lanes(self.spec, self.arrs[0], s, cap) \
            if has_mat else None
        f64w = tuple(a[s:s + cap] for a in self.arrs[int(has_mat):])
        return mat, f64w

    def to_table(self) -> Table:
        """Materialize the windows into a plain Table (slice + full
        unpack, per shard) — the reference the packed consumers are equal
        to."""
        def one(r):
            mat, f64w = self.window(r)
            if mat is not None:
                datas, valids = lanes.unpack_lanes(self.spec, mat)
                datas, valids = list(datas), list(valids)
            else:
                datas = [None] * len(self.spec.cols)
                valids = [None] * len(self.spec.cols)
            wins = iter(f64w)
            for i, c in enumerate(self.spec.cols):
                if not c.lanes:
                    datas[i] = next(wins).clone()
            return datas, valids

        datas, valids = map_shards(one, self.env.world_size)
        cols = {}
        for (n, t, dc, nb), d, v in zip(self.meta, datas, valids):
            cols[n] = Column(d, t, v, dc, bounds=nb)
        return Table(cols, self.env, self.lens)


class PieceSource:
    """Range-piece provider over a resident sorted table: its columns pack
    into ONE lane matrix (plus f64 side arrays), each shard's block padded
    by ``pad`` rows so every window fits; each piece is then a host-side :class:`PackedPiece`
    descriptor.  The caller drops its reference to the table: the packed
    arrays carry everything.

    Admission goes straight to the ledger (exec/memory.ensure_headroom),
    which evicts colder spillable owners when the budget is short; the
    reference routes it through the serving tier's scheduler (slice 13).
    ``scratch_bytes`` folds the piece join's transient sort operands into
    that decision.  The packed arrays register as spillable: while they
    are host-resident each piece uploads its window alone."""

    def __init__(self, table: Table, pad: int, drop: tuple = (),
                 scratch_bytes: int = 0):
        from ..exec import memory
        from .common import table_lane_spec
        self.env = table.env
        items = [(n, c) for n, c in table.columns.items() if n not in drop]
        cols = [c for _, c in items]
        self.spec = table_lane_spec(cols)
        self.meta = tuple(
            (n, c.type, c.dictionary,
             (min(c.bounds[0], 0), max(c.bounds[1], 0))
             if c.bounds is not None else None)
            for n, c in items)
        w, cap = self.env.world_size, table.capacity
        rows = cap + int(pad)          # per shard
        memory.ensure_headroom(self.env,
                               w * rows * memory.spec_row_bytes(self.spec),
                               scratch=int(scratch_bytes))
        dev = self.env.device
        arrs = []
        if self.spec.n_lanes:
            mat = torch.zeros((w * rows, self.spec.n_lanes),
                              dtype=torch.int32, device=dev)
            mat.view(w, rows, -1)[:, :cap] = lanes.pack_lanes(
                self.spec, [c.data for c in cols],
                [c.validity for c in cols]).view(w, cap, -1)
            arrs.append(mat)
        for c, cl in zip(cols, self.spec.cols):
            if not cl.lanes:
                side = torch.zeros(w * rows, dtype=c.data.dtype, device=dev)
                side.view(w, rows)[:, :cap] = c.data.view(w, cap)
                arrs.append(side)
        self._reg = memory.register("piece_src", tuple(arrs),
                                    spillable=True, world=w, anchor=self)

    @property
    def arrs(self) -> tuple | None:
        """The device arrays while resident, None while spilled."""
        from ..exec import memory
        return memory.device_arrays(self._reg)

    @property
    def spilled(self) -> bool:
        return self._reg.spilled

    def packed(self, starts, lens, piece_cap: int | None = None
               ) -> PackedPiece:
        from ..exec import memory
        lens = np.asarray(lens, np.int64)
        if piece_cap is None:
            piece_cap = config.pow2ceil(max(int(lens.max(initial=0)), 1))
        memory.touch(self._reg)
        if not self._reg.spilled:
            return PackedPiece(self.env, self.spec, self.meta, self.arrs,
                               starts, lens, piece_cap)
        # host-resident: upload this window alone, byte-identical to the
        # resident slice; the uploaded arrays ARE the window, so every
        # shard's window starts at row 0
        w = self.env.world_size
        arrs, ready = memory.upload_window(
            self._reg, np.asarray(starts, np.int64), int(piece_cap))
        return PackedPiece(self.env, self.spec, self.meta, arrs,
                           np.zeros(w, np.int64), lens, piece_cap,
                           ready=ready)
