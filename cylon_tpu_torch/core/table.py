"""Device-resident Table (port of ``cylon_tpu/core/table.py``).

Layout, as in the reference: every column is ONE tensor of length
``W·cap`` on the env's device, W the env's world size; shard r is the row
block ``[r·cap, (r+1)·cap)``, whose first ``valid_counts[r]`` rows are
real and the rest padding.  Global row order is the concatenation of the
shards' live prefixes in rank order.  World-1 ingest pads the capacity to
its ``pow2ceil`` bucket with a masked tail (``config.family_cap``); a
W-rank ingest splits the rows into W contiguous blocks of ``ceil(n / W)``
and pads each to one ``pow2ceil`` capacity, so a port table holds exactly
the layout of the reference table built from the same rows.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from .. import config
from ..ctx.context import CylonEnv, LocalConfig, VirtualMeshConfig
from ..status import CylonKeyError, InvalidError
from .column import Column
from .dtypes import Field, LogicalType

_default_env: CylonEnv | None = None


def default_env() -> CylonEnv:
    global _default_env
    if _default_env is None:
        _default_env = CylonEnv(LocalConfig())
    return _default_env


class Table:
    def __init__(self, cols: Mapping[str, Column], env: CylonEnv | None,
                 valid_counts: np.ndarray | None = None):
        self._cols: dict[str, Column] = dict(cols)
        self._env = env or default_env()
        #: key columns this table is known to be GROUPED by: equal keys are
        #: contiguous (set by the join output; None elsewhere)
        self.grouped_by: tuple | None = None
        n = None
        for c in self._cols.values():
            if n is None:
                n = len(c)
            elif len(c) != n:
                raise InvalidError("column length mismatch")
        n = n or 0
        w = self._env.world_size
        if valid_counts is None:
            if n % w:
                raise InvalidError(f"rows {n} not divisible by world {w}")
            valid_counts = np.full(w, n // w, dtype=np.int64)
        self._valid = np.asarray(valid_counts, dtype=np.int64)
        if self._valid.shape != (w,):
            raise InvalidError("valid_counts must have one entry per rank")

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_pydict(data: Mapping[str, np.ndarray],
                    env: CylonEnv | None = None) -> "Table":
        env = env or default_env()
        cols = {k: Column.from_numpy(np.asarray(v)) for k, v in data.items()}
        return _ingest(cols, env)

    @staticmethod
    def from_pandas(df, env: CylonEnv | None = None) -> "Table":
        """From a pandas DataFrame (the caller brings pandas; this package
        never imports it)."""
        cols = {}
        for k in df.columns:
            s = df[k]
            npdt = getattr(s.dtype, "numpy_dtype", None)
            if npdt is not None and npdt.kind in "iufb" and s.isna().any():
                mask = np.asarray(s.isna(), bool)
                col = Column.from_numpy(s.to_numpy(dtype=npdt, na_value=0))
                cols[str(k)] = Column(col.data, col.type, ~mask,
                                      col.dictionary, bounds=col.bounds)
            elif npdt is not None and npdt.kind in "iufb":
                cols[str(k)] = Column.from_numpy(s.to_numpy(dtype=npdt))
            else:
                cols[str(k)] = Column.from_numpy(s.to_numpy())
        return _ingest(cols, env or default_env())

    @staticmethod
    def from_arrow(at, env: CylonEnv | None = None) -> "Table":
        """From a pyarrow.Table by direct buffer conversion
        (core/arrow_interop.py); pyarrow is the caller's."""
        from .arrow_interop import table_from_arrow
        return table_from_arrow(at, env)

    @staticmethod
    def from_numpy(names, arrays, env: CylonEnv | None = None) -> "Table":
        return Table.from_pydict(dict(zip(names, arrays)), env)

    @staticmethod
    def from_host_columns(cols: Mapping[str, Column],
                          env: CylonEnv | None = None) -> "Table":
        """Place already-typed HOST columns (numpy data and validity,
        logical type, dictionary and bounds kept) onto the env — the
        dtype-faithful ingest, a nullable numeric column included."""
        return _ingest(dict(cols), env or default_env())

    @staticmethod
    def from_reference_state(cols: Mapping[str, tuple], valid_counts,
                             device, capacity: int | None = None) -> "Table":
        """Carry a table across from ``cylon_tpu`` without importing it.

        ``cols`` maps a name to ``(data, validity|None, logical-type name,
        dictionary|None, bounds|None)`` as host arrays — the live rows
        ``cylon_tpu.Table.host_columns()`` returns (shard prefixes in rank
        order) plus the reference ``Column``'s fields.  ``valid_counts``
        are the reference table's per-rank counts; their number is the
        world size.  ``device`` is a device name or a :class:`CylonEnv`
        of that world size.  With ``capacity`` (the reference table's
        per-shard capacity) each rank's rows land at its own shard, as
        the reference holds them — a shuffled table is no contiguous
        split, so it is never re-split; without it the rows go through
        this package's own ingest."""
        vc = np.asarray(valid_counts, np.int64).reshape(-1)
        env = device if isinstance(device, CylonEnv) \
            else CylonEnv(VirtualMeshConfig(len(vc)), device=device)
        if env.world_size != len(vc):
            raise InvalidError(f"{len(vc)} valid counts for a world of "
                               f"{env.world_size}")
        host = {}
        for name, (data, valid, tname, dictionary, bounds) in cols.items():
            data = np.asarray(data)
            if len(data) != int(vc.sum()):
                raise InvalidError(
                    f"column {name!r} holds {len(data)} rows, valid_counts "
                    f"say {int(vc.sum())}")
            host[name] = Column(
                data, LogicalType(tname),
                None if valid is None else np.asarray(valid, bool),
                None if dictionary is None else np.asarray(dictionary,
                                                           dtype=object),
                bounds=None if bounds is None else (int(bounds[0]),
                                                    int(bounds[1])))
        if capacity is None:
            return _ingest(host, env)
        return _place_shards(host, env, vc, int(capacity))

    # -- schema ------------------------------------------------------------
    @property
    def env(self) -> CylonEnv:
        return self._env

    @property
    def columns(self) -> dict[str, Column]:
        return self._cols

    @property
    def column_names(self) -> list[str]:
        return list(self.columns)

    @property
    def row_count(self) -> int:
        return int(self.valid_counts.sum())

    @property
    def valid_counts(self) -> np.ndarray:
        return self._valid

    @property
    def capacity(self) -> int:
        """Per-shard padded capacity."""
        cols = self.columns
        return len(next(iter(cols.values()))) // self._env.world_size \
            if cols else 0

    @property
    def column_count(self) -> int:
        return len(self.column_names)

    @property
    def schema(self) -> list[Field]:
        return [Field(k, c.type, c.validity is not None)
                for k, c in self.columns.items()]

    def column(self, name: str) -> Column:
        try:
            return self.columns[name]
        except KeyError:
            raise CylonKeyError(f"no column {name!r}; have {self.column_names}")

    def __contains__(self, name: str) -> bool:
        return name in self.column_names

    # -- projections (host-side metadata, no device work) -------------------
    def project(self, names: Iterable[str]) -> "Table":
        return Table({n: self.column(n) for n in names}, self._env,
                     self.valid_counts)

    def drop(self, names: Iterable[str]) -> "Table":
        drop = set(names)
        return Table({k: v for k, v in self.columns.items()
                      if k not in drop}, self._env, self.valid_counts)

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self.columns.items()},
                     self._env, self.valid_counts)

    def with_columns(self, extra: Mapping[str, Column]) -> "Table":
        cols = dict(self.columns)
        cols.update(extra)
        return Table(cols, self._env, self.valid_counts)

    # -- host pulls --------------------------------------------------------
    def host_columns(self) -> dict:
        """{name: (data, validity|None)} host arrays of the live rows in
        global order (the shards' live prefixes in rank order), in one
        batched pull."""
        from ..utils.host import host_arrays
        w, cap, vc = self._env.world_size, self.capacity, self.valid_counts
        blocks = [(r * cap, r * cap + int(vc[r])) for r in range(w)]

        def live(x):
            return x[:blocks[0][1]] if w == 1 else x

        flat = []
        for c in self.columns.values():
            flat.append(live(c.data))
            flat.append(None if c.validity is None else live(c.validity))
        pulled = host_arrays(flat)
        if w > 1:
            pulled = [None if x is None
                      else np.concatenate([x[a:b] for a, b in blocks])
                      for x in pulled]
        return {k: (pulled[2 * i], pulled[2 * i + 1])
                for i, k in enumerate(self.columns)}

    def host_column(self, name: str):
        """``(data, validity|None)`` host arrays of one column's live rows
        in global order."""
        c = self.column(name)
        one = Table({name: c}, self._env, self.valid_counts)
        return one.host_columns()[name]

    def to_pydict(self) -> dict:
        """{name: decoded numpy array} of the live rows in global order
        (strings decoded, nulls as NaN/None)."""
        n = self.row_count
        out = {}
        for k, (data, valid) in self.host_columns().items():
            c = self.column(k)
            out[k] = Column(data, c.type, valid, c.dictionary).to_numpy(n)
        return out

    def to_pandas(self):
        """pandas DataFrame of the live rows; pandas is imported only here."""
        from ..status import require
        return require("pandas").DataFrame(self.to_pydict())

    def to_arrow(self):
        """pyarrow.Table of the live rows (core/arrow_interop.py)."""
        from .arrow_interop import table_to_arrow
        return table_to_arrow(self)

    def to_pylist(self) -> list[dict]:
        """One ``{column: value}`` dict per live row, in global order;
        numbers as Python scalars, nulls as None (NaN in float columns),
        datetimes as numpy datetime64."""
        cols = {k: (list(v) if v.dtype.kind in "Mm" else v.tolist())
                for k, v in self.to_pydict().items()}
        return [dict(zip(cols, vals)) for vals in zip(*cols.values())]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Table(rows={self.row_count}, cols={self.column_names}, "
                f"cap={self.capacity}, device={self._env.device})")


class DeferredTable(Table):
    """A Table whose columns materialize on first data access.

    An upstream operator (join) hands its pre-materialization state
    (``op_state``) to a compatible downstream consumer (the groupby
    pushdown, relational/fused.py) without paying for the intermediate
    table; any other access runs ``thunk()`` -> dict[str, Column], or a
    whole Table whose layout the DeferredTable adopts.  Column
    names, counts and capacity answer from ``meta`` = (names, types, dicts,
    has_nulls) and do not materialize."""

    def __init__(self, env, valid_counts, capacity: int | None, thunk, meta,
                 op_state=None, counts_thunk=None):
        """``counts_thunk`` (with ``valid_counts=None``): the output counts
        are still on the device — the producer dispatched its count phase
        without pulling it, so the next operator's work can be queued
        before this one's host wait (the pipelined piece loop).  The first
        read of ``valid_counts``/``row_count``/``capacity`` pulls; a fused
        consumer that drains ``op_state`` never does."""
        if valid_counts is None and counts_thunk is None:
            raise InvalidError("DeferredTable needs valid_counts or "
                               "counts_thunk")
        super().__init__({}, env, np.zeros((env or default_env()).world_size,
                                           np.int64)
                         if valid_counts is None else valid_counts)
        self._counts_thunk = counts_thunk if valid_counts is None else None
        self._cap = None if capacity is None else int(capacity)
        self._meta = meta
        self._thunk = thunk
        self.op_state = op_state

    @property
    def valid_counts(self) -> np.ndarray:
        if self._counts_thunk is not None:
            th, self._counts_thunk = self._counts_thunk, None
            self._valid = np.asarray(th(), np.int64).reshape(
                self._env.world_size)
        return self._valid

    @property
    def columns(self) -> dict[str, Column]:
        if self._thunk is not None:
            thunk, self._thunk = self._thunk, None
            # drop the fused-consumer state BEFORE materializing: it pins
            # N-long device buffers the thunk does not read
            self.op_state = None
            out = thunk()
            if isinstance(out, Table):
                # the producer rebuilt the rows on another layout (the
                # skew stitch's even layout): adopt its counts, capacity
                # and grouping with its columns
                self._cols = dict(out.columns)
                self._valid = out.valid_counts
                self._cap = out.capacity
                self.grouped_by = out.grouped_by
            else:
                self._cols = dict(out)
        return self._cols

    @property
    def materialized(self) -> bool:
        return self._thunk is None

    @property
    def column_names(self) -> list[str]:
        return list(self._meta[0])

    @property
    def schema(self) -> list[Field]:
        """From the producer's metadata: reading it never materializes."""
        return [Field(n, t, bool(hn)) for n, t, hn in
                zip(self._meta[0], self._meta[1], self._meta[3])]

    @property
    def capacity(self) -> int:
        if self._cap is None:
            self._cap = config.pow2ceil(int(self.valid_counts.max()))
        return self._cap


def _place(host: np.ndarray, env: CylonEnv) -> torch.Tensor:
    host = np.ascontiguousarray(host)
    if not host.flags.writeable:   # an Arrow buffer's view
        host = host.copy()
    return torch.from_numpy(host).to(env.device)


def _ingest(cols: dict[str, Column], env: CylonEnv) -> Table:
    """Ingest dispatch: at world size 1, exact placement when the row count
    is already its own family bucket; otherwise :func:`_distribute`."""
    n = len(next(iter(cols.values()))) if cols else 0
    if env.world_size == 1 and config.family_cap(n) == n:
        out = {k: Column(_place(np.asarray(c.data), env), c.type,
                         None if c.validity is None
                         else _place(np.asarray(c.validity), env),
                         c.dictionary, bounds=c.bounds)
               for k, c in cols.items()}
        return Table(out, env)
    return _distribute(cols, env)


def _distribute(cols: dict[str, Column], env: CylonEnv) -> Table:
    """Split host-built columns into W contiguous row blocks of
    ``ceil(n / W)`` rows (the last ranks may get fewer), pad each to one
    ``pow2ceil`` capacity with zeros masked by ``valid_counts``, and place
    them on the device (``cylon_tpu/core/table.py:420``)."""
    n = len(next(iter(cols.values()))) if cols else 0
    w = env.world_size
    chunk = -(-n // w)
    cap = config.pow2ceil(chunk)
    # the capacity bucket, a pure function of (rows, world), on the open
    # plan node (a no-op without a profile)
    from ..obs.plan import annotate
    annotate(shape_family=int(cap), ingest_rows=int(n))
    vc = np.asarray([max(0, min(chunk, n - r * chunk)) for r in range(w)],
                    np.int64)
    return _place_shards(cols, env, vc, cap)


def _place_shards(cols: dict[str, Column], env: CylonEnv, vc: np.ndarray,
                  cap: int) -> Table:
    """Place live rows given in global order so that rank r's ``vc[r]``
    rows fill the prefix of its ``cap``-row shard, zeros after; bounds
    widen to include the padding's 0."""
    w = env.world_size
    if int(vc.max(initial=0)) > cap:
        raise InvalidError(f"a shard of {int(vc.max())} rows exceeds the "
                           f"capacity {cap}")
    offs = np.concatenate([[0], np.cumsum(vc)])
    out = {}
    for k, c in cols.items():
        host = np.asarray(c.data)
        padded = np.zeros((w * cap,) + host.shape[1:], host.dtype)
        vhost = None if c.validity is None else np.asarray(c.validity)
        vpad = None if vhost is None else np.zeros(w * cap, bool)
        for r in range(w):
            m = int(vc[r])
            padded[r * cap:r * cap + m] = host[offs[r]:offs[r] + m]
            if vpad is not None:
                vpad[r * cap:r * cap + m] = vhost[offs[r]:offs[r] + m]
        b = c.bounds
        if b is not None:
            b = (min(b[0], 0), max(b[1], 0))
        out[k] = Column(_place(padded, env), c.type,
                        None if vpad is None else _place(vpad, env),
                        c.dictionary, bounds=b)
    return Table(out, env, vc)
