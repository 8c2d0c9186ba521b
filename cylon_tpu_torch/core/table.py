"""Device-resident Table (port of ``cylon_tpu/core/table.py``).

Layout, as in the reference at world size 1: every column is a tensor of
the same length ``cap`` on the env's device; the first ``valid_counts[0]``
rows are real, the rest is padding.  Ingest pads the capacity to its
``pow2ceil`` bucket with a masked tail (``config.family_cap``), so a port
table holds exactly the capacity and padding of the reference table built
from the same rows.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .. import config
from ..ctx.context import CylonEnv, LocalConfig
from ..status import CylonKeyError, InvalidError
from .column import Column
from .dtypes import LogicalType

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
        if valid_counts is None:
            valid_counts = np.full(1, n or 0, dtype=np.int64)
        self._valid = np.asarray(valid_counts, dtype=np.int64)
        if self._valid.shape != (1,):
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
    def from_reference_state(cols: Mapping[str, tuple], valid_counts,
                             device) -> "Table":
        """Carry a table across from ``cylon_tpu`` without importing it.

        ``cols`` maps a name to ``(data, validity|None, logical-type name,
        dictionary|None, bounds|None)`` as host arrays — the live rows
        ``cylon_tpu.Table.host_columns()`` returns plus the reference
        ``Column``'s fields.  ``valid_counts`` are the reference table's
        per-rank counts (world 1 here).  ``device`` is a device name or a
        :class:`CylonEnv`.  The rows go through this package's own ingest,
        so the capacity and masked tail equal the reference's."""
        env = device if isinstance(device, CylonEnv) \
            else CylonEnv(LocalConfig(), device=device)
        vc = np.asarray(valid_counts, np.int64).reshape(-1)
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
        return _ingest(host, env)

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
        cols = self.columns
        return len(next(iter(cols.values()))) if cols else 0

    def column(self, name: str) -> Column:
        try:
            return self.columns[name]
        except KeyError:
            raise CylonKeyError(f"no column {name!r}; have {self.column_names}")

    def with_columns(self, extra: Mapping[str, Column]) -> "Table":
        cols = dict(self.columns)
        cols.update(extra)
        return Table(cols, self._env, self.valid_counts)

    # -- host pulls --------------------------------------------------------
    def host_columns(self) -> dict:
        """{name: (data, validity|None)} host arrays of the live rows, in
        one batched pull."""
        from ..utils.host import host_arrays
        n = int(self.valid_counts[0])
        flat = []
        for c in self.columns.values():
            flat.append(c.data[:n])
            flat.append(None if c.validity is None else c.validity[:n])
        pulled = host_arrays(flat)
        return {k: (pulled[2 * i], pulled[2 * i + 1])
                for i, k in enumerate(self.columns)}

    def to_pydict(self) -> dict:
        """{name: decoded numpy array} of the live rows (strings decoded,
        nulls as NaN/None)."""
        n = int(self.valid_counts[0])
        out = {}
        for k, (data, valid) in self.host_columns().items():
            c = self.column(k)
            out[k] = Column(data, c.type, valid, c.dictionary).to_numpy(n)
        return out

    def to_pandas(self):
        """pandas DataFrame of the live rows; pandas is imported only here."""
        import pandas as pd
        return pd.DataFrame(self.to_pydict())

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Table(rows={self.row_count}, cols={self.column_names}, "
                f"cap={self.capacity}, device={self._env.device})")


class DeferredTable(Table):
    """A Table whose columns materialize on first data access.

    An upstream operator (join) hands its pre-materialization state
    (``op_state``) to a compatible downstream consumer (the groupby
    pushdown, relational/fused.py) without paying for the intermediate
    table; any other access runs ``thunk()`` -> dict[str, Column].  Column
    names, counts and capacity answer from ``meta`` = (names, types, dicts,
    has_nulls) and do not materialize."""

    def __init__(self, env, valid_counts, capacity: int, thunk, meta,
                 op_state=None):
        super().__init__({}, env, valid_counts)
        self._cap = int(capacity)
        self._meta = meta
        self._thunk = thunk
        self.op_state = op_state

    @property
    def columns(self) -> dict[str, Column]:
        if self._thunk is not None:
            thunk, self._thunk = self._thunk, None
            # drop the fused-consumer state BEFORE materializing: it pins
            # N-long device buffers the thunk does not read
            self.op_state = None
            self._cols = dict(thunk())
        return self._cols

    @property
    def materialized(self) -> bool:
        return self._thunk is None

    @property
    def column_names(self) -> list[str]:
        return list(self._meta[0])

    @property
    def capacity(self) -> int:
        return self._cap


def _place(host: np.ndarray, env: CylonEnv) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(host)).to(env.device)


def _ingest(cols: dict[str, Column], env: CylonEnv) -> Table:
    """World-1 ingest: exact placement when the row count is already its
    own family bucket, else :func:`_distribute` pads to the bucket."""
    n = len(next(iter(cols.values()))) if cols else 0
    if config.family_cap(n) == n:
        out = {k: Column(_place(np.asarray(c.data), env), c.type,
                         None if c.validity is None
                         else _place(np.asarray(c.validity), env),
                         c.dictionary, bounds=c.bounds)
               for k, c in cols.items()}
        return Table(out, env)
    return _distribute(cols, env)


def _distribute(cols: dict[str, Column], env: CylonEnv) -> Table:
    """Pad host-built columns to the ``pow2ceil`` capacity (zeros, masked
    by ``valid_counts``) and place them on the device."""
    n = len(next(iter(cols.values()))) if cols else 0
    cap = config.pow2ceil(n)
    out = {}
    for k, c in cols.items():
        host = np.asarray(c.data)
        padded = np.zeros((cap,) + host.shape[1:], host.dtype)
        padded[:n] = host
        v = None
        if c.validity is not None:
            vpad = np.zeros(cap, bool)
            vpad[:n] = np.asarray(c.validity)
            v = _place(vpad, env)
        # padding rows are zeros — covered by widening bounds to include 0
        b = c.bounds
        if b is not None:
            b = (min(b[0], 0), max(b[1], 0))
        out[k] = Column(_place(padded, env), c.type, v, c.dictionary, bounds=b)
    return Table(out, env, np.asarray([n], np.int64))
