"""StreamTable: the append-only distributed ingest table (port of
``cylon_tpu/stream/table.py``).

One micro-batch append is: the serving tier's interleave point → the
``stream.append`` injector probe → host batch → device Table → hash
shuffle on the stream key (the exchange every operator uses, its receive
labelled ``stream.recv``) → the scheduler's admission → one more chunk,
then the subscribers.  The chunks are ordinary Tables: ``snapshot()`` is
their concatenation, and no chunk is sliced or copied until a consumer
reads it.

Across the processes of a ``DistributedConfig`` world ingest is SPMD:
every process appends the same global batch, uploads its own ranks'
rows, and after the shuffle keeps the rows its ranks own; the admission
and the ledger count this process's bytes.
"""

from __future__ import annotations

import numpy as np

from ..core.table import Table
from ..relational.repart import concat_tables, shuffle_table
from ..status import InvalidError


def _as_table(batch, env) -> Table:
    """One micro-batch as a Table: a Table, a port ``DataFrame``, a dict
    of numpy arrays, or a pandas DataFrame (pandas is the caller's)."""
    if isinstance(batch, Table):
        return batch
    inner = getattr(batch, "_table", None)
    if isinstance(inner, Table):
        return inner
    if isinstance(batch, dict):
        return Table.from_pydict(batch, env)
    return Table.from_pandas(batch, env)


class StreamTable:
    """Append-only distributed table fed by micro-batches.

    Usage::

        st = StreamTable(env, key="k", name="orders")
        view = IncrementalView(st, "k", [("v", "sum"), ("v", "mean")])
        st.append({"k": k, "v": v})  # shuffled, admitted, absorbed
        view.read()                  # a consistent snapshot, ingest live

    ``key``: the hash-shuffle column(s), so equal keys land on one shard
    on arrival.  Each append registers its bytes in the memory ledger
    under a ``<name>.chunk`` owner (anchored to the chunk, so collecting
    it drains the balance) and is admitted through the scheduler, so
    under budget pressure cold tenants (or cold stream windows) evict
    first."""

    def __init__(self, env, key, name: str = "stream"):
        self.env = env
        self.key = [key] if isinstance(key, str) else list(key)
        self.name = str(name)
        self.chunks: list[Table] = []
        self._regs: list = []
        self._subscribers: list = []
        self.rows_appended = 0
        self.bytes_appended = 0
        self.batches_appended = 0

    def subscribe(self, consumer) -> None:
        """``consumer(batch_table)`` is called with every appended
        (shuffled) batch: how an ``IncrementalView`` rides the ingest."""
        self._subscribers.append(consumer)

    def append(self, batch) -> Table:
        """Ingest one micro-batch; returns the shuffled device batch (the
        unit the subscribers absorbed)."""
        from ..exec import memory, recovery, scheduler
        from ..obs import plan as _plan
        from ..utils import timing
        # the streaming session's interleave point: one append per slice
        scheduler.maybe_yield()
        recovery.maybe_inject("stream.append")
        with _plan.node("stream.append", stream=self.name,
                        keys=tuple(self.key)) as pn, \
                timing.region("stream.append"):
            tbl = _as_table(batch, self.env)
            if self.env.world_size > 1:
                tbl = shuffle_table(tbl, self.key, owner="stream.recv")
            nbytes = memory.table_nbytes(tbl)
            if pn:
                pn.set(rows_in=tbl.row_count, rows_out=tbl.row_count,
                       batch=self.batches_appended)
            # ingest state counts against the budget like any tenant's
            scheduler.admit_allocation(self.env, nbytes)
            self._regs.append(
                memory.register_table(f"{self.name}.chunk", tbl))
            self.chunks.append(tbl)
        self.rows_appended += int(tbl.row_count)
        self.bytes_appended += nbytes
        self.batches_appended += 1
        timing.bump("stream.batch_appended")
        for consumer in self._subscribers:
            consumer(tbl)
        return tbl

    def snapshot(self) -> Table:
        """Every row appended so far as one Table (per shard in append
        order: the batch recompute's input)."""
        if not self.chunks:
            raise InvalidError(f"stream {self.name!r} has no batches")
        return concat_tables(self.chunks) if len(self.chunks) > 1 \
            else self.chunks[0]

    def release(self) -> None:
        """Drop the chunks and drain their ledger balance."""
        from ..exec import memory
        for reg in self._regs:
            memory.release(reg)
        self._regs = []
        self.chunks = []

    def stats(self) -> dict:
        return {"name": self.name, "batches": self.batches_appended,
                "rows": self.rows_appended,
                "bytes": self.bytes_appended,
                "valid_counts": (np.asarray(self.chunks[-1].valid_counts)
                                 .tolist() if self.chunks else [])}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"StreamTable({self.name!r}, batches="
                f"{self.batches_appended}, rows={self.rows_appended})")
