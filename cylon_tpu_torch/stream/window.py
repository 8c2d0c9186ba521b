"""Event-time tumbling windows with an agreed watermark, and the spill
tier's retirement of closed windows (port of
``cylon_tpu/stream/window.py``).

Rows carry an event time; window ``w`` covers ``[origin + w·window,
origin + (w+1)·window)``, and the WATERMARK, the largest event time seen
less the allowed lateness, decides when a window is complete.  Each rank
advances its own watermark from its shards' event times, so a close is a
collective decision: every rank votes the windows it can close and the
agreed minimum closes (``exec/recovery.watermark_consensus``), so every
rank closes the same window at the same step.

A closed window's buffered rows join the build side current at the close
(a slowly-changing small table, which the broadcast route replicates, so
the shuffled probe rows do not move again); the result is emitted and
the buffers retire through the spill tier, device → host → released
(``exec/memory.evict_release``).  While open, a window's buffers are
spillable ledger registrations: under pressure a cold window evicts to
host memory like a cold packed source and comes back bit-exact at its
close.

Late rows (in an already closed window) are dropped and counted
(``drop``) or land in the oldest open window (``clamp``).

The event-time bounds of a buffered sub-batch (:func:`event_bounds`) and
the per-window split of a batch are host waits, one per sub-batch, as in
the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.column import Column
from ..core.table import Table
from ..relational.join import join_tables
from ..relational.repart import concat_tables, shuffle_table
from ..status import InvalidError
from ..parallel.shards import local_counts
from ..utils.host import host_array
from .table import _as_table

#: event-time identities of an empty shard (the min and max folds')
_T_MAX = np.int64(2**62)
_T_MIN = np.int64(-(2**62))


def event_bounds(table: Table, time_col: str) -> tuple[int, int]:
    """(min, max) event time over a table's live rows, or the identities
    ``(2^62, -2^62)`` when it has none: one masked ``(W, cap)`` amin and
    amax over each shard's live prefix, then one pull.  In a
    multi-process world the bounds are this process's shards' (no
    collective): the watermark vote agrees across processes
    (``cylon_tpu/stream/window.py:55``)."""
    data = table.column(time_col).data
    if data.numel() == 0:
        return int(_T_MAX), int(_T_MIN)
    vc = local_counts(table.valid_counts).astype(np.int64)
    t = data.to(torch.int64).view(len(vc), -1)
    vc = torch.as_tensor(vc, device=t.device)
    live = torch.arange(t.shape[1], device=t.device)[None, :] < vc[:, None]
    lo = torch.where(live, t, int(_T_MAX)).amin(dim=1)
    hi = torch.where(live, t, int(_T_MIN)).amax(dim=1)
    bounds = host_array(torch.stack([lo, hi]))
    return int(bounds[0].min()), int(bounds[1].max())


class _WindowBuffer:
    """One micro-batch's rows of one open window.  The column arrays live
    only in a spillable window-lifetime ledger registration (beside a
    host recipe to rebuild the Table), so an eviction under pressure, or
    the close's retirement, really drops the device references."""

    __slots__ = ("env", "reg", "_names", "_types", "_dicts", "_bounds",
                 "_has_valid", "_valid_counts", "rows")

    def __init__(self, table: Table, env, owner: str):
        from ..exec import memory
        self.env = env
        arrays, self._names, self._types = [], [], []
        self._dicts, self._bounds, self._has_valid = [], [], []
        for name, c in table.columns.items():
            self._names.append(name)
            self._types.append(c.type)
            self._dicts.append(c.dictionary)
            self._bounds.append(c.bounds)
            self._has_valid.append(c.validity is not None)
            arrays.append(c.data)
            if c.validity is not None:
                arrays.append(c.validity)
        self._valid_counts = np.asarray(table.valid_counts, np.int64)
        self.rows = int(table.row_count)
        self.reg = memory.register_window(owner, arrays,
                                          world=env.world_size)

    def table(self) -> Table:
        """The buffered rows as a Table, uploaded again first when
        pressure evicted this window while it was open (bit-exact)."""
        from ..exec import memory
        memory.touch(self.reg)
        arrays = memory.device_arrays(self.reg)
        if arrays is None:
            arrays = memory.readmit(self.reg)
        it = iter(arrays)
        cols = {}
        for i, name in enumerate(self._names):
            data = next(it)
            valid = next(it) if self._has_valid[i] else None
            cols[name] = Column(data, self._types[i], valid,
                                self._dicts[i], bounds=self._bounds[i])
        return Table(cols, self.env, self._valid_counts)


class TumblingWindowJoin:
    """A windowed, as-of join of an event-time stream against a
    slowly-changing small build side.

    Usage::

        wj = TumblingWindowJoin(env, key="k", time_col="t", window=100,
                                build=dims, build_on="k", lateness=50)
        wj.append(batch)          # buffered by window; watermark advances
        closed = wj.watermark()   # the vote; closes the ready windows
        wj.closed                 # [(window_id, joined Table), ...]
        wj.pop_closed()           # hand off the results (and their bytes)

    ``window``: the tumbling width in event-time units; ``lateness``: the
    allowed out-of-orderness taken off the largest event time seen;
    ``late_policy``: ``"drop"`` or ``"clamp"``; ``origin``: where window
    ordinals start; ``emit``: an optional ``emit(window_id, table)`` per
    close.  ``set_build`` swaps the build side: a window joins the
    version current at ITS close."""

    def __init__(self, env, key, time_col: str, window: int, build,
                 build_on, *, lateness: int = 0,
                 late_policy: str = "drop", name: str = "wjoin",
                 how: str = "inner", origin: int = 0, emit=None):
        if late_policy not in ("drop", "clamp"):
            raise InvalidError(
                f"late_policy {late_policy!r} must be 'drop' or 'clamp'")
        if int(window) <= 0:
            raise InvalidError("window width must be positive")
        self.env = env
        self.key = [key] if isinstance(key, str) else list(key)
        self.time_col = str(time_col)
        self.window = int(window)
        #: window ordinals count from here, so absolute timestamps keep
        #: the vote's deltas small
        self.origin = int(origin)
        self.build_on = [build_on] if isinstance(build_on, str) \
            else list(build_on)
        self.lateness = int(lateness)
        self.late_policy = late_policy
        self.name = str(name)
        self.how = how
        self.emit = emit
        self.build = _as_table(build, env)
        #: open window id -> its buffers
        self._open: dict[int, list[_WindowBuffer]] = {}
        #: windows [0, _closed_through) are closed: the agreed count
        self._closed_through = 0
        self._local_wm = int(_T_MIN)   # this rank's monotone watermark
        self.closed: list[tuple[int, Table]] = []
        self._closed_regs: list = []   # ledger entries of the results
        self.windows_closed = 0
        self.late_dropped = 0
        self.late_clamped = 0
        self.rows_buffered = 0

    # -- build side (as-of) ------------------------------------------------
    def set_build(self, build) -> None:
        """Swap the build side; windows closed from now on join it."""
        self.build = _as_table(build, self.env)

    # -- ingest ------------------------------------------------------------
    def append(self, batch) -> None:
        """Buffer one micro-batch into its event-time windows: the host
        rows split by window id, each sub-batch hash-shuffles on the join
        key, is admitted through the scheduler and registers as a
        spillable window-lifetime allocation; its device time column then
        advances this rank's watermark."""
        from ..exec import recovery, scheduler
        from ..exec.memory import table_nbytes
        from ..utils import timing
        scheduler.maybe_yield()
        recovery.maybe_inject("stream.append")
        cols = self._host_columns(batch)
        times = np.asarray(cols[self.time_col], np.int64)
        if times.size == 0:
            return
        wid = (times - self.origin) // self.window
        if (wid < 0).any():
            # no window before the origin ever existed or closed: such
            # rows are invalid input, not late ones
            raise InvalidError(
                f"{self.name}: {int((wid < 0).sum())} event(s) before "
                f"the stream origin {self.origin} — window ordinals are "
                "counted from `origin`; construct the join with an "
                "origin at or below the earliest event time")
        late = wid < self._closed_through
        if late.any():
            if self.late_policy == "drop":
                self.late_dropped += int(late.sum())
                keep = ~late
                cols = {k: np.asarray(v)[keep] for k, v in cols.items()}
                wid = wid[keep]
            else:   # clamp: into the oldest window still open
                self.late_clamped += int(late.sum())
                wid = np.maximum(wid, self._closed_through)
        if wid.size == 0:
            return
        with timing.region("stream.window_append"):
            for w in np.unique(wid):
                sel = wid == w
                sub = {k: np.asarray(v)[sel] for k, v in cols.items()}
                tbl = Table.from_pydict(sub, self.env)
                if self.env.world_size > 1:
                    tbl = shuffle_table(tbl, self.key, owner="stream.recv")
                scheduler.admit_allocation(self.env, table_nbytes(tbl))
                _lo, hi = event_bounds(tbl, self.time_col)
                buf = _WindowBuffer(tbl, self.env,
                                    f"{self.name}.w{int(w)}")
                del tbl     # the registration holds the only device refs
                self._open.setdefault(int(w), []).append(buf)
                self.rows_buffered += buf.rows
                self._local_wm = max(self._local_wm,
                                     int(hi) - self.lateness)

    def _host_columns(self, batch) -> dict:
        if isinstance(batch, dict):
            return dict(batch)
        table = batch if isinstance(batch, Table) \
            else getattr(batch, "_table", None)
        if isinstance(table, Table):
            return table.to_pydict()
        return {str(k): batch[k].to_numpy() for k in batch.columns}

    # -- watermark and close -----------------------------------------------
    def local_watermark(self) -> int:
        return self._local_wm

    def closable_count(self) -> int:
        """This rank's vote: how many windows [0, n) its watermark has
        passed (window w closes at wm >= origin + (w+1)·window)."""
        rel = self._local_wm - self.origin
        if self._local_wm == int(_T_MIN) or rel < 0:
            return self._closed_through
        return max(int(rel) // self.window, self._closed_through)

    def watermark(self) -> int:
        """Agree the watermark and close every ready window; returns the
        agreed count of closed windows (the watermark is ``origin +
        count·window``).  The vote carries the DELTA of newly closable
        windows, clamped to the wire's ``2^20 − 1``, and repeats while
        the agreed delta saturates (a rank-uniform condition), so a jump
        of billions of windows votes in rounds.  Windows nothing was
        buffered into are skipped."""
        from ..exec import recovery, scheduler
        scheduler.maybe_yield()
        recovery.maybe_inject("stream.watermark")
        wire_max = (1 << 20) - 1
        while True:
            delta = min(self.closable_count() - self._closed_through,
                        wire_max)
            agreed_delta = recovery.watermark_consensus(self.env, delta)
            agreed = self._closed_through + agreed_delta
            for wid in sorted(w for w in self._open if w < agreed):
                self._close(wid)
            self._closed_through = agreed
            if agreed_delta < wire_max:
                return agreed

    def _close(self, wid: int) -> None:
        """Close one window: its buffers concatenated, joined to the
        current build side, the result emitted, then the buffers retired
        through the spill tier (the balance drains by their bytes)."""
        from ..exec import memory
        from ..obs import plan as _plan
        from ..utils import timing
        bufs = self._open.pop(wid)
        with _plan.node("stream.window_close", stream=self.name,
                        window=int(wid), how=self.how) as pn, \
                timing.region("stream.window_close"):
            parts = [b.table() for b in bufs]
            probe = concat_tables(parts) if len(parts) > 1 else parts[0]
            if pn:
                pn.set(rows_in=probe.row_count)
            out = join_tables(probe, self.build, self.key, self.build_on,
                              how=self.how, allow_defer=False)
            if pn:
                pn.set(rows_out=out.row_count)
            del probe, parts
            for b in bufs:
                memory.evict_release(b.reg)
        # a result waiting in `closed` is resident state: accounted until
        # pop_closed() (anchored to the table)
        self._closed_regs.append(
            memory.register_table(f"{self.name}.closed", out))
        self.closed.append((wid, out))
        self.windows_closed += 1
        timing.bump("stream.window_closed")
        if self.emit is not None:
            self.emit(wid, out)

    def pop_closed(self) -> list[tuple[int, Table]]:
        """Hand off the emitted results and release their ledger entries:
        a stream that closes windows forever pops them (or consumes them
        through ``emit=`` and pops)."""
        from ..exec import memory
        out, self.closed = self.closed, []
        for reg in self._closed_regs:
            memory.release(reg)
        self._closed_regs = []
        return out

    def release(self) -> int:
        """Retire the stream's end: the emitted results are handed off as
        by :meth:`pop_closed` (and dropped), and the windows still open
        retire through the spill tier as a close's buffers do, device →
        host → released, without a join (the end of a stream closes
        nothing).  Returns the open buffers' bytes retired."""
        from ..exec import memory
        self.pop_closed()
        retired = 0
        for bufs in self._open.values():
            for b in bufs:
                retired += memory.evict_release(b.reg)
        self._open.clear()
        return retired

    def stats(self) -> dict:
        return {"name": self.name, "windows_closed": self.windows_closed,
                "open_windows": len(self._open),
                "closed_through": self._closed_through,
                "late_dropped": self.late_dropped,
                "late_clamped": self.late_clamped,
                "rows_buffered": self.rows_buffered,
                "local_watermark": self._local_wm}
