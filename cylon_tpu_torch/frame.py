"""DataFrame: the pandas-like entry point (port of ``cylon_tpu/frame.py``).

Every operator takes ``env: CylonEnv = None``: ``None`` runs it on the
frame's own env, an env moves the frame there first (a host copy of its
columns) and runs it on that world.  Column math and filters go through
:class:`~cylon_tpu_torch.series.Series`; ``loc``/``iloc`` through
``indexing/indexer.py``.  A label index is one column or several, kept in
the physical table (``drop=True`` hides it from the visible columns).

pandas is touched only when the caller hands in a pandas frame or asks for
one (``to_pandas``, a multi-level ``index``) and by the file writers;
pyarrow only by ``to_arrow`` and the Parquet writer.  Unlike the
reference, the host-side conveniences build no pandas objects:
``iterrows`` yields ``(label, {column: value})``, the frame reductions
(``sum`` ...) return ``{column: value}`` and ``to_string`` formats the
rows itself.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from .core.column import Column
from .core.table import Table
from .ctx.context import CylonEnv
from .relational.common import valid_flag
from .relational.groupby import groupby_aggregate
from .relational.join import join_tables
from .relational.repart import (concat_tables, filter_table, head,
                                repad_table, repartition, shuffle_table,
                                slice_table, tail)
from .relational.setops import equals, set_operation, unique_table
from .relational.sort import sort_table
from .series import Series
from .status import CylonKeyError, CylonTypeError, InvalidError, require

__all__ = ["DataFrame", "GroupByDataFrame", "concat", "read_pandas"]


def _resolve_env(df_env: CylonEnv, env: CylonEnv | None) -> CylonEnv:
    return env if env is not None else df_env


def _native(v):
    """A numpy scalar as a Python scalar (datetimes stay numpy)."""
    if isinstance(v, np.generic) and v.dtype.kind in "biufc":
        return v.item()
    return v


class DataFrame:
    """Columnar distributed dataframe over a (virtual) device mesh."""

    def __init__(self, data: Any = None, env: CylonEnv | None = None,
                 _table: Table | None = None):
        self._index: str | tuple | None = None  # label index column(s)
        self._index_drop: bool = True           # pandas set_index drop
        if _table is not None:
            self._table = _table
            return
        if data is None:
            data = {}
        if isinstance(data, Table):
            self._table = data
        elif isinstance(data, DataFrame):
            self._table = data._table
        elif isinstance(data, Mapping):
            self._table = Table.from_pydict(
                {k: np.asarray(v) for k, v in data.items()}, env)
        elif isinstance(data, (list, tuple)):
            # a list of columns, named "0", "1", ...
            self._table = Table.from_pydict(
                {f"{i}": np.asarray(c) for i, c in enumerate(data)}, env)
        elif type(data).__module__.split(".")[0] == "pandas" \
                and type(data).__name__ == "DataFrame":
            self._table = Table.from_pandas(data, env)
        else:
            raise InvalidError(f"cannot build DataFrame from {type(data)}")

    # -- construction helpers ----------------------------------------------
    @staticmethod
    def from_table(table: Table) -> "DataFrame":
        return DataFrame(_table=table)

    @property
    def table(self) -> Table:
        return self._table

    @property
    def env(self) -> CylonEnv:
        return self._table.env

    def _to_env(self, env: CylonEnv) -> "DataFrame":
        """This frame on another env: its live columns copied through the
        host (types, validity, dictionaries and bounds kept), the index
        with them."""
        if env is self._table.env:
            return self
        t = self._table
        cols = {}
        for name, (data, valid) in t.host_columns().items():
            c = t.column(name)
            cols[name] = Column(data, c.type, valid, c.dictionary,
                                bounds=c.bounds)
        out = DataFrame(_table=Table.from_host_columns(cols, env))
        out._index, out._index_drop = self._index, self._index_drop
        return out

    def _index_cols(self) -> list:
        """The index column names: [] (a range index), one, or several (a
        multi-index)."""
        if self._index is None:
            return []
        if isinstance(self._index, tuple):
            return list(self._index)
        return [self._index]

    def _wrap(self, table: Table, keep_index: bool = False) -> "DataFrame":
        out = DataFrame(_table=table)
        idx = self._index_cols()
        if keep_index and idx and all(c in table.column_names for c in idx):
            out._index = self._index
            out._index_drop = self._index_drop
        return out

    def _hidden(self) -> set:
        """Columns of the physical table that are not visible (an index
        set with ``drop=True``)."""
        if self._index is not None and self._index_drop:
            return set(self._index_cols())
        return set()

    def _visible_table(self) -> Table:
        hid = self._hidden()
        return self._table.drop(hid) if hid else self._table

    # -- schema / introspection --------------------------------------------
    @property
    def columns(self) -> list[str]:
        hid = self._hidden()
        return [c for c in self._table.column_names if c not in hid]

    @property
    def shape(self) -> tuple[int, int]:
        return (self._table.row_count, len(self.columns))

    @property
    def dtypes(self) -> dict[str, str]:
        hid = self._hidden()
        return {f.name: f.type.value for f in self._table.schema
                if f.name not in hid}

    def __len__(self) -> int:
        return self._table.row_count

    def __contains__(self, name: str) -> bool:
        return name in self._table and name not in self._hidden()

    def __repr__(self) -> str:  # pragma: no cover
        return (f"DataFrame(rows={len(self)}, columns={self.columns}, "
                f"world={self.env.world_size})")

    # -- index ---------------------------------------------------------------
    @property
    def loc(self):
        from .indexing.indexer import LocIndexer
        return LocIndexer(self)

    @property
    def iloc(self):
        from .indexing.indexer import ILocIndexer
        return ILocIndexer(self)

    @property
    def index(self):
        """The row labels: positions, the index column's values, or (a
        multi-index) a pandas ``MultiIndex``."""
        if self._index is None:
            return np.arange(len(self))
        idx = self._index_cols()
        if len(idx) == 1:
            return self._col_series(idx[0]).to_numpy()
        return require("pandas").MultiIndex.from_arrays(
            [self._col_series(c).to_numpy() for c in idx], names=idx)

    def _labels(self) -> list:
        """The row labels as host values (tuples for a multi-index),
        without pandas."""
        idx = self._index_cols()
        if not idx:
            return list(range(len(self)))
        cols = [self._col_series(c).to_numpy() for c in idx]
        if len(cols) == 1:
            return [_native(v) for v in cols[0]]
        return [tuple(_native(v) for v in t) for t in zip(*cols)]

    def set_index(self, name, drop: bool = True) -> "DataFrame":
        """Use column ``name`` (or a list of them, a multi-index) as the
        row labels.  ``drop=True`` (pandas' default) hides the column(s)
        from the visible columns; they stay in the table for ``loc``."""
        names = [name] if isinstance(name, str) else list(name)
        if not names:
            raise CylonKeyError("set_index needs at least one column")
        for n in names:
            if n not in self._table:
                raise CylonKeyError(f"no column {n!r}")
        out = DataFrame(_table=self._table)
        out._index = names[0] if len(names) == 1 else tuple(names)
        out._index_drop = bool(drop)
        return out

    def reset_index(self) -> "DataFrame":
        """The index back to ordinary columns (metadata only: the columns
        never left the table)."""
        return DataFrame(_table=self._table)

    # -- materialization -----------------------------------------------------
    def to_pydict(self) -> dict:
        """{column: list} of the visible columns' live rows in global
        order."""
        cols = self._table.project(self.columns).to_pydict()
        return {k: list(v) for k, v in cols.items()}

    def to_dict(self) -> dict:
        """{column: list of Python values} (pandas' ``to_dict("list")``)."""
        return {k: [_native(v) for v in vals]
                for k, vals in self.to_pydict().items()}

    def to_numpy(self) -> np.ndarray:
        """(rows, columns) array of the visible columns; numeric columns
        promote to one dtype, strings or nulls make it object."""
        cols = list(self._table.project(self.columns).to_pydict().values())
        if not cols:
            return np.empty((0, 0))
        return np.column_stack(cols)

    def to_pandas(self):
        df = self._table.to_pandas()
        idx = self._index_cols()
        if idx:
            df = df.set_index(idx if len(idx) > 1 else idx[0],
                              drop=self._index_drop)
            if not self._index_drop and len(idx) == 1:
                df.index.name = idx[0]
        return df

    def to_arrow(self):
        return self._table.to_arrow()

    def to_csv(self, path, **kw) -> None:
        from .io import write_csv
        write_csv(self._table, path, **kw)

    def to_parquet(self, path, **kw) -> None:
        from .io import write_parquet
        write_parquet(self._table, path, **kw)

    def to_json(self, path, **kw) -> None:
        from .io import write_json
        write_json(self._table, path, **kw)

    def to_string(self) -> str:
        """The rows as fixed-width text: the index (or positions) first,
        then the visible columns, right-aligned."""
        labels = self._labels()
        cols = self.to_pydict()
        head = [self._index if isinstance(self._index, str) else ""] \
            + list(cols)
        rows = [[str(lb)] + [str(_native(cols[c][i])) for c in cols]
                for i, lb in enumerate(labels)]
        widths = [max([len(h)] + [len(r[j]) for r in rows])
                  for j, h in enumerate(head)]
        lines = [" ".join(x.rjust(w) for x, w in zip(r, widths))
                 for r in [head] + rows]
        return "\n".join(lines)

    def show(self, n: int = 10) -> None:
        """Print the first ``n`` rows."""
        print(self.head(n).to_string())

    # -- column access / mutation --------------------------------------------
    def _col_series(self, name: str) -> Series:
        """A column as a Series, index-hidden or not (loc reads the
        index)."""
        return Series(name, self._table.column(name), self.env,
                      self._table.valid_counts)

    def __getitem__(self, key):
        if isinstance(key, str):
            if key in self._hidden():
                raise CylonKeyError(
                    f"{key!r} is the index (set_index drop=True)")
            return self._col_series(key)
        if isinstance(key, (list, tuple)) and all(isinstance(k, str)
                                                  for k in key):
            return self._wrap(self._table.project(key))
        if isinstance(key, Series):
            if key.dtype.value != "bool":
                raise InvalidError("filter mask must be a bool series")
            return self._wrap(filter_table(self._table,
                                           valid_flag(key.column)),
                              keep_index=True)
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            if step != 1:
                raise InvalidError("slice step not supported")
            return self._wrap(slice_table(self._table, start, stop - start),
                              keep_index=True)
        raise CylonKeyError(f"cannot index DataFrame with {key!r}")

    def __setitem__(self, name: str, value):
        """A new or replaced column: a Series of this frame's layout (kept
        on the device), a scalar or a host array of ``len(self)`` values."""
        if not isinstance(name, str):
            raise CylonKeyError("column name must be a string")
        if isinstance(value, Series):
            # equal capacity is not enough: a column of a differently
            # partitioned frame would misalign rows across shards
            from .parallel.shards import local_world
            if (value.column.data.shape[0]
                    != self._table.capacity
                    * local_world(self.env.world_size)
                    or not np.array_equal(value.valid_counts,
                                          self._table.valid_counts)):
                raise InvalidError("series layout mismatch")
            col = value.column
        elif np.isscalar(value) or isinstance(value, (int, float, bool, str)):
            col = self._ingest_column(np.full(len(self), value))
        else:
            arr = np.asarray(value)
            if arr.shape[0] != len(self):
                raise InvalidError(
                    f"column length {arr.shape[0]} != rows {len(self)}")
            col = self._ingest_column(arr)
        self._table = self._table.with_columns({name: col})

    def _ingest_column(self, arr: np.ndarray) -> Column:
        """A host array as a column of this table's shard layout."""
        tmp = Table.from_pydict({"__c": arr}, self.env)
        tmp = repartition(tmp, tuple(int(x)
                                     for x in self._table.valid_counts))
        return repad_table(tmp, self._table.capacity).column("__c")

    def drop(self, columns: Iterable[str]) -> "DataFrame":
        if isinstance(columns, str):
            columns = [columns]
        return self._wrap(self._table.drop(columns))

    def rename(self, columns: Mapping[str, str]) -> "DataFrame":
        return self._wrap(self._table.rename(columns))

    def add_prefix(self, prefix: str) -> "DataFrame":
        """Every visible column renamed to ``prefix + name``."""
        return self.rename({c: prefix + c for c in self.columns})

    def add_suffix(self, suffix: str) -> "DataFrame":
        return self.rename({c: c + suffix for c in self.columns})

    # -- relational operators ------------------------------------------------
    def merge(self, right: "DataFrame", how: str = "inner", on=None,
              left_on=None, right_on=None, suffixes=("_x", "_y"),
              env: CylonEnv | None = None) -> "DataFrame":
        """pandas.merge: the join keys are coalesced into the left names;
        with neither ``on`` nor ``left_on``/``right_on`` the common
        visible columns are the keys.  A hidden index takes no part."""
        env = _resolve_env(self.env, env)
        lhs, rhs = self._to_env(env), right._to_env(env)
        if on is not None:
            left_on = right_on = on
        if left_on is None or right_on is None:
            common = [c for c in lhs.columns if c in set(rhs.columns)]
            if not common:
                raise InvalidError("no common columns to merge on")
            left_on = right_on = common
        return self._wrap(join_tables(
            lhs._visible_table(), rhs._visible_table(), left_on, right_on,
            how=how, suffixes=suffixes, coalesce_keys=True))

    def join(self, other: "DataFrame", how: str = "left", on=None,
             lsuffix: str = "l", rsuffix: str = "r",
             env: CylonEnv | None = None) -> "DataFrame":
        """Key join with suffixed overlapping columns, keys kept apart."""
        env = _resolve_env(self.env, env)
        lhs, oth = self._to_env(env), other._to_env(env)
        if on is None:
            raise InvalidError("join requires on= key column(s)")
        on = [on] if isinstance(on, str) else list(on)
        return self._wrap(join_tables(
            lhs._visible_table(), oth._visible_table(), on, on, how=how,
            suffixes=(lsuffix, rsuffix), coalesce_keys=False))

    def sort_values(self, by, ascending=True, nulls_position: str = "last",
                    env: CylonEnv | None = None,
                    method: str = "initial") -> "DataFrame":
        """Global sort; ``method`` "initial" (sample first) or "regular"
        (local sort first, quantile-exact splitters)."""
        env = _resolve_env(self.env, env)
        return self._wrap(sort_table(
            self._to_env(env)._table, by, ascending=ascending,
            nulls_position=nulls_position, method=method), keep_index=True)

    def groupby(self, by, env: CylonEnv | None = None) -> "GroupByDataFrame":
        env = _resolve_env(self.env, env)
        by = [by] if isinstance(by, str) else list(by)
        return GroupByDataFrame(self._to_env(env), by)

    def drop_duplicates(self, subset=None, keep: str = "first",
                        env: CylonEnv | None = None) -> "DataFrame":
        """Distinct rows on ``subset`` (default every visible column),
        keeping each value's first or last occurrence."""
        env = _resolve_env(self.env, env)
        d = self._to_env(env)
        if subset is None:
            subset = d.columns
        return d._wrap(unique_table(d._table, subset, keep), keep_index=True)

    def _set_op(self, other: "DataFrame", op: str,
                env: CylonEnv | None) -> "DataFrame":
        env = _resolve_env(self.env, env)
        return self._wrap(set_operation(self._to_env(env)._table,
                                        other._to_env(env)._table, op))

    def union(self, other: "DataFrame",
              env: CylonEnv | None = None) -> "DataFrame":
        """Distinct rows of either frame."""
        return self._set_op(other, "union", env)

    def intersect(self, other: "DataFrame",
                  env: CylonEnv | None = None) -> "DataFrame":
        """Distinct rows of this frame that ``other`` also holds."""
        return self._set_op(other, "intersect", env)

    def subtract(self, other: "DataFrame",
                 env: CylonEnv | None = None) -> "DataFrame":
        """Distinct rows of this frame that ``other`` does not hold."""
        return self._set_op(other, "subtract", env)

    def shuffle(self, on, env: CylonEnv | None = None) -> "DataFrame":
        """Hash-partition the rows on ``on``: equal keys share a rank."""
        env = _resolve_env(self.env, env)
        on = [on] if isinstance(on, str) else list(on)
        return self._wrap(shuffle_table(self._to_env(env)._table, on))

    def repartition(self, rows_per_partition=None,
                    env: CylonEnv | None = None) -> "DataFrame":
        """Redistribute the rows in their global order: the even split, or
        ``rows_per_partition[r]`` rows on rank r."""
        env = _resolve_env(self.env, env)
        return self._wrap(repartition(self._to_env(env)._table,
                                      rows_per_partition))

    def head(self, n: int = 5) -> "DataFrame":
        return self._wrap(head(self._table, n), keep_index=True)

    def tail(self, n: int = 5) -> "DataFrame":
        return self._wrap(tail(self._table, n), keep_index=True)

    def equals(self, other: "DataFrame", ordered: bool = True) -> bool:
        """The same columns and rows (in global order, or as multisets
        with ``ordered=False``)."""
        return equals(self._table, other._to_env(self.env)._table,
                      ordered=ordered)

    def isin(self, other: "DataFrame") -> bool:
        """Row-subset test: every row of this frame appears in ``other``."""
        diff = set_operation(self._table, other._to_env(self.env)._table,
                             "subtract")
        return diff.row_count == 0

    # -- missing data ----------------------------------------------------------
    def _rebuild_cols(self, newcols: dict) -> "DataFrame":
        """A table of per-column results with the hidden index columns
        re-attached, so the index survives elementwise ops."""
        for h in self._hidden():
            newcols[h] = self._table.column(h)
        return self._wrap(Table(newcols, self._table.env,
                                self._table.valid_counts), keep_index=True)

    def isna(self) -> "DataFrame":
        """Boolean frame: True where a value is null or NaN."""
        return self._rebuild_cols(
            {c: self[c].isna().column for c in self.columns})

    def notna(self) -> "DataFrame":
        return self._rebuild_cols(
            {c: self[c].notna().column for c in self.columns})

    isnull = isna
    notnull = notna

    def where(self, cond: "DataFrame | Series", other=None) -> "DataFrame":
        """Keep values where ``cond`` holds; elsewhere ``other`` (null
        when None).  ``cond`` is a bool frame or one bool Series applied
        to every column row-wise (pandas' ``where(cond, axis=0)``)."""
        cols = {}
        for name in self.columns:
            col = self._table.column(name)
            c_ser = cond[name] if isinstance(cond, DataFrame) else cond
            flag = valid_flag(c_ser.column)
            if other is None:
                v = flag if col.validity is None else (col.validity & flag)
                cols[name] = Column(col.data, col.type, v, col.dictionary)
            else:
                s = Series(name, col, self.env, self._table.valid_counts)
                cols[name] = s._fill_where(~flag, other).column
        return self._rebuild_cols(cols)

    def dropna(self, how: str = "any", subset=None) -> "DataFrame":
        """Drop the rows with a missing value in any (all) of ``subset``'s
        columns."""
        if how not in ("any", "all"):
            raise InvalidError("how must be 'any' or 'all'")
        keep = None
        for c in (list(subset) if subset is not None else self.columns):
            ok = self[c].notna()
            keep = ok if keep is None else (
                (keep & ok) if how == "any" else (keep | ok))
        if keep is None:
            return self
        return self._wrap(filter_table(self._table, valid_flag(keep.column)),
                          keep_index=True)

    def fillna(self, value) -> "DataFrame":
        """Missing values (nulls and float NaNs) replaced with ``value``;
        a column whose type cannot hold ``value`` (a string column and a
        numeric fill) is left as it is."""
        cols = {}
        hidden = self._hidden()
        for name, c in self._table.columns.items():
            if name in hidden or (c.validity is None
                                  and not c.data.dtype.is_floating_point):
                cols[name] = c
                continue
            s = Series(name, c, self.env, self._table.valid_counts)
            try:
                cols[name] = s.fillna(value).column
            except CylonTypeError:
                cols[name] = c
        return self._wrap(Table(cols, self._table.env,
                                self._table.valid_counts), keep_index=True)

    # -- elementwise frame arithmetic ----------------------------------------
    def _colwise(self, fn) -> "DataFrame":
        return self._rebuild_cols({c: fn(self[c]).column
                                   for c in self.columns})

    def _frame_op(self, other, op_name: str) -> "DataFrame":
        if isinstance(other, DataFrame):
            if other.columns != self.columns:
                raise InvalidError("frame op requires identical columns")
            return self._colwise(
                lambda s: getattr(s, op_name)(other[s.name]))
        return self._colwise(lambda s: getattr(s, op_name)(other))

    def __add__(self, o):
        return self._frame_op(o, "__add__")

    def __sub__(self, o):
        return self._frame_op(o, "__sub__")

    def __mul__(self, o):
        return self._frame_op(o, "__mul__")

    def __truediv__(self, o):
        return self._frame_op(o, "__truediv__")

    def __neg__(self):
        return self._colwise(lambda s: -s)

    def __abs__(self):
        return self._colwise(abs)

    def abs(self) -> "DataFrame":
        return self._colwise(abs)

    # -- row-wise host access ----------------------------------------------------
    def applymap(self, func) -> "DataFrame":
        """``func`` over every value of the visible columns, on the host
        (arbitrary Python); the index columns are not mapped.  The result
        is ingested again, its dtypes inferred from the values."""
        hidden = self._hidden()
        host = self._table.to_pydict()
        mapped = {k: (v if k in hidden
                      else np.asarray([func(_native(x)) for x in v]))
                  for k, v in host.items()}
        out = DataFrame(mapped, env=self.env)
        if self._index is None:
            return out
        return out.set_index(self._index_cols(), drop=self._index_drop)

    def iterrows(self):
        """``(label, {column: value})`` per row, on the host."""
        cols = self.to_pydict()
        for i, lb in enumerate(self._labels()):
            yield lb, {k: _native(v[i]) for k, v in cols.items()}

    def itertuples(self, index: bool = True, name: str = "Cylon"):
        """One namedtuple per row (``Index`` first when ``index``)."""
        cols = self.to_pydict()
        fields = (["Index"] if index else []) + list(cols)
        Row = namedtuple(name, fields, rename=True)
        for i, lb in enumerate(self._labels()):
            vals = [_native(v[i]) for v in cols.values()]
            yield Row(*(([lb] if index else []) + vals))

    def row(self, i: int):
        """One global row as a :class:`~cylon_tpu_torch.core.row.Row`."""
        from .core.row import Row
        return Row(self, i)

    # -- reductions over all columns -------------------------------------------
    def _agg_all(self, op: str) -> dict:
        """{column: the Series reduction} over the visible columns that
        support ``op``."""
        out = {}
        for name in self.columns:
            try:
                out[name] = getattr(self[name], op)()
            except CylonTypeError:
                continue
        return out

    def sum(self):
        return self._agg_all("sum")

    def min(self):
        return self._agg_all("min")

    def max(self):
        return self._agg_all("max")

    def count(self):
        return self._agg_all("count")

    def mean(self):
        return self._agg_all("mean")


class GroupByDataFrame:
    """Deferred groupby: the terminal aggregation methods run
    ``groupby_aggregate``."""

    def __init__(self, df: DataFrame, by: list[str]):
        self._df = df
        self._by = by
        self._value_cols = [c for c in df.columns if c not in set(by)]

    def __getitem__(self, cols) -> "GroupByDataFrame":
        cols = [cols] if isinstance(cols, str) else list(cols)
        for c in cols:
            if c not in self._df.columns:
                raise CylonKeyError(f"no column {c!r}")
        g = GroupByDataFrame(self._df, self._by)
        g._value_cols = cols
        return g

    def _run(self, aggs) -> DataFrame:
        return DataFrame(_table=groupby_aggregate(self._df._table, self._by,
                                                  aggs))

    def _all(self, op: str) -> DataFrame:
        from .core.dtypes import LogicalType
        # types from the schema, NOT column(): a column read would
        # materialize a deferred join and forfeit the fused pushdown
        types = {f.name: f.type for f in self._df._table.schema}
        aggs = [(c, op) for c in self._value_cols
                if types[c] != LogicalType.STRING
                or op in ("count", "nunique", "min", "max")]
        if not aggs:
            raise InvalidError(f"no columns support {op!r}")
        out = self._run(aggs)
        # pandas-style: result columns keep the value column name
        return out.rename({f"{c}_{op}": c for c, _ in aggs})

    def sum(self) -> DataFrame:
        return self._all("sum")

    def count(self) -> DataFrame:
        return self._all("count")

    def min(self) -> DataFrame:
        return self._all("min")

    def max(self) -> DataFrame:
        return self._all("max")

    def mean(self) -> DataFrame:
        return self._all("mean")

    def var(self) -> DataFrame:
        return self._all("var")

    def std(self) -> DataFrame:
        return self._all("std")

    def nunique(self) -> DataFrame:
        return self._all("nunique")

    def median(self) -> DataFrame:
        return self._all("median")

    def quantile(self, q: float = 0.5) -> DataFrame:
        out = self._run([(c, "quantile", q) for c in self._value_cols])
        ren = {f"{c}_quantile_{q:g}": c for c in self._value_cols}
        return out.rename({k: v for k, v in ren.items() if k in out.columns})

    def agg(self, spec) -> DataFrame:
        """pandas ``.agg`` spellings: one op name ('sum'), a list of op
        names applied to every value column, {'col': 'sum' | ['sum',
        'mean']}, or an explicit [(col, op), ...] list."""
        if isinstance(spec, str):
            return self._all(spec)
        if isinstance(spec, Mapping):
            aggs = [(col, op) for col, ops in spec.items()
                    for op in ([ops] if isinstance(ops, str) else list(ops))]
        elif spec and all(isinstance(a, str) for a in spec):
            aggs = [(c, op) for c in self._value_cols for op in spec]
        else:
            aggs = [tuple(a) for a in spec]
        if not aggs:
            raise InvalidError("no aggregations specified")
        return self._run(aggs)


def concat(objs: Sequence[DataFrame],
           env: CylonEnv | None = None) -> DataFrame:
    """Row-wise concatenation, per shard."""
    if not objs:
        raise InvalidError("concat of nothing")
    env = _resolve_env(objs[0].env, env)
    return DataFrame(_table=concat_tables([o._to_env(env)._table
                                           for o in objs]))


def read_pandas(df, env: CylonEnv | None = None) -> DataFrame:
    return DataFrame(df, env=env)
