"""DataFrame: the pandas-like entry point (port of the subset of
``cylon_tpu/frame.py`` that the README Quickstart and BASELINE
configuration 3 use).

Every operator takes ``env: CylonEnv = None``: ``None`` runs it on the
frame's own env, an env moves the frame there first (a host copy of its
columns) and runs it on that world.  pandas is touched only when the
caller hands in a pandas frame or asks for one (``to_pandas``).

Not ported yet: the Series (a single-column ``df["a"]`` raises
``NotImplementedError`` naming slice 9 of ROADMAP.md Queue 1), the index,
filters, IO and the rest of the API breadth (slice 9).
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from .core.column import Column
from .core.table import Table
from .ctx.context import CylonEnv
from .relational.groupby import groupby_aggregate
from .relational.join import join_tables
from .relational.repart import (concat_tables, head, repartition,
                                shuffle_table, tail)
from .relational.setops import equals, set_operation, unique_table
from .relational.sort import sort_table
from .status import CylonKeyError, InvalidError

__all__ = ["DataFrame", "GroupByDataFrame", "concat", "read_pandas"]


def _resolve_env(df_env: CylonEnv, env: CylonEnv | None) -> CylonEnv:
    return env if env is not None else df_env


class DataFrame:
    """Columnar distributed dataframe over a (virtual) device mesh."""

    def __init__(self, data: Any = None, env: CylonEnv | None = None,
                 _table: Table | None = None):
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
        host (types, validity, dictionaries and bounds kept)."""
        if env is self._table.env:
            return self
        t = self._table
        cols = {}
        for name, (data, valid) in t.host_columns().items():
            c = t.column(name)
            cols[name] = Column(data, c.type, valid, c.dictionary,
                                bounds=c.bounds)
        return DataFrame(_table=Table.from_host_columns(cols, env))

    # -- schema / introspection --------------------------------------------
    @property
    def columns(self) -> list[str]:
        return self._table.column_names

    @property
    def shape(self) -> tuple[int, int]:
        return (self._table.row_count, self._table.column_count)

    @property
    def dtypes(self) -> dict[str, str]:
        return {f.name: f.type.value for f in self._table.schema}

    def __len__(self) -> int:
        return self._table.row_count

    def __contains__(self, name: str) -> bool:
        return name in self._table

    def __repr__(self) -> str:  # pragma: no cover
        return (f"DataFrame(rows={len(self)}, columns={self.columns}, "
                f"world={self.env.world_size})")

    # -- materialization -----------------------------------------------------
    def to_pydict(self) -> dict:
        """{column: list} of the live rows in global order."""
        return {k: list(v) for k, v in self._table.to_pydict().items()}

    def to_numpy(self) -> np.ndarray:
        """(rows, columns) array of the live rows; numeric columns promote
        to one dtype, strings or nulls make it object."""
        cols = list(self._table.to_pydict().values())
        if not cols:
            return np.empty((0, 0))
        return np.column_stack(cols)

    def to_pandas(self):
        return self._table.to_pandas()

    # -- column access -------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, (list, tuple)) and all(isinstance(k, str)
                                                  for k in key):
            return DataFrame(_table=self._table.project(key))
        if isinstance(key, str):
            if key not in self._table:
                raise CylonKeyError(f"no column {key!r}")
            raise NotImplementedError(
                "a single column is a Series, which cylon_tpu_torch does not "
                "have yet: slice 9 of ROADMAP.md Queue 1; select a list of "
                "columns instead")
        raise CylonKeyError(f"cannot index DataFrame with {key!r}")

    def drop(self, columns: Iterable[str]) -> "DataFrame":
        if isinstance(columns, str):
            columns = [columns]
        return DataFrame(_table=self._table.drop(columns))

    def rename(self, columns: Mapping[str, str]) -> "DataFrame":
        return DataFrame(_table=self._table.rename(columns))

    # -- relational operators ------------------------------------------------
    def merge(self, right: "DataFrame", how: str = "inner", on=None,
              left_on=None, right_on=None, suffixes=("_x", "_y"),
              env: CylonEnv | None = None) -> "DataFrame":
        """pandas.merge: the join keys are coalesced into the left names;
        with neither ``on`` nor ``left_on``/``right_on`` the common
        columns are the keys."""
        env = _resolve_env(self.env, env)
        lhs, rhs = self._to_env(env), right._to_env(env)
        if on is not None:
            left_on = right_on = on
        if left_on is None or right_on is None:
            common = [c for c in lhs.columns if c in set(rhs.columns)]
            if not common:
                raise InvalidError("no common columns to merge on")
            left_on = right_on = common
        return DataFrame(_table=join_tables(
            lhs._table, rhs._table, left_on, right_on, how=how,
            suffixes=suffixes, coalesce_keys=True))

    def join(self, other: "DataFrame", how: str = "left", on=None,
             lsuffix: str = "l", rsuffix: str = "r",
             env: CylonEnv | None = None) -> "DataFrame":
        """Key join with suffixed overlapping columns, keys kept apart."""
        env = _resolve_env(self.env, env)
        lhs, oth = self._to_env(env), other._to_env(env)
        if on is None:
            raise InvalidError("join requires on= key column(s)")
        on = [on] if isinstance(on, str) else list(on)
        return DataFrame(_table=join_tables(
            lhs._table, oth._table, on, on, how=how,
            suffixes=(lsuffix, rsuffix), coalesce_keys=False))

    def sort_values(self, by, ascending=True, nulls_position: str = "last",
                    env: CylonEnv | None = None,
                    method: str = "initial") -> "DataFrame":
        """Global sort; ``method`` "initial" (sample first) or "regular"
        (local sort first, quantile-exact splitters)."""
        env = _resolve_env(self.env, env)
        return DataFrame(_table=sort_table(
            self._to_env(env)._table, by, ascending=ascending,
            nulls_position=nulls_position, method=method))

    def groupby(self, by, env: CylonEnv | None = None) -> "GroupByDataFrame":
        env = _resolve_env(self.env, env)
        by = [by] if isinstance(by, str) else list(by)
        return GroupByDataFrame(self._to_env(env), by)

    def drop_duplicates(self, subset=None, keep: str = "first",
                        env: CylonEnv | None = None) -> "DataFrame":
        """Distinct rows on ``subset`` (default every column), keeping
        each value's first or last occurrence."""
        env = _resolve_env(self.env, env)
        d = self._to_env(env)
        if subset is None:
            subset = d.columns
        return DataFrame(_table=unique_table(d._table, subset, keep))

    def _set_op(self, other: "DataFrame", op: str,
                env: CylonEnv | None) -> "DataFrame":
        env = _resolve_env(self.env, env)
        return DataFrame(_table=set_operation(self._to_env(env)._table,
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
        return DataFrame(_table=shuffle_table(self._to_env(env)._table, on))

    def repartition(self, rows_per_partition=None,
                    env: CylonEnv | None = None) -> "DataFrame":
        """Redistribute the rows in their global order: the even split, or
        ``rows_per_partition[r]`` rows on rank r."""
        env = _resolve_env(self.env, env)
        return DataFrame(_table=repartition(self._to_env(env)._table,
                                            rows_per_partition))

    def head(self, n: int = 5) -> "DataFrame":
        return DataFrame(_table=head(self._table, n))

    def tail(self, n: int = 5) -> "DataFrame":
        return DataFrame(_table=tail(self._table, n))

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
