"""Row and Scalar (port of ``cylon_tpu/core/row.py``).

A Row is a host-side view of one global row of a DataFrame, pulled on
first access (a row access is host-facing by nature); a Scalar is one
typed value with its logical type.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..status import CylonKeyError, InvalidError
from .dtypes import LogicalType


class Scalar:
    """One typed value; ``value`` is a Python/numpy scalar or None (null)."""

    __slots__ = ("value", "type")

    def __init__(self, value: Any, type: LogicalType):
        self.value = value
        self.type = type

    @property
    def is_null(self) -> bool:
        return self.value is None or (
            isinstance(self.value, float) and np.isnan(self.value))

    def __repr__(self) -> str:  # pragma: no cover
        return f"Scalar({self.value!r}, {self.type.value})"

    def __eq__(self, other) -> bool:
        o = other.value if isinstance(other, Scalar) else other
        if self.is_null:
            return o is None
        return bool(self.value == o)

    def __hash__(self):
        return hash((self.value, self.type))


def _native(v):
    """A numpy scalar as the Python scalar pandas' records would hold; a
    float NaN as None."""
    if isinstance(v, np.generic) and v.dtype.kind in "biuf":
        v = v.item()
    if isinstance(v, float) and np.isnan(v):
        return None
    return v


class Row:
    """One global row of a DataFrame; its values are pulled to the host on
    first access and cached."""

    __slots__ = ("_df", "_i", "_values")

    def __init__(self, df, i: int):
        n = len(df)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise InvalidError(f"row {i} out of range for {n} rows")
        self._df = df
        self._i = i
        self._values: dict | None = None

    def _load(self) -> dict:
        if self._values is None:
            # a one-row slice of the visible columns (a drop=True index
            # column stays hidden here, as on the frame)
            from ..relational.repart import slice_table
            one = slice_table(self._df.table, self._i, 1).to_pydict()
            self._values = {k: _native(one[k][0])
                            for k in self._df.columns if k in one}
        return self._values

    @property
    def columns(self) -> list[str]:
        return self._df.columns

    def __getitem__(self, name: str):
        vals = self._load()
        if name not in vals:
            raise CylonKeyError(f"no column {name!r}")
        return vals[name]

    def scalar(self, name: str) -> Scalar:
        col = self._df.table.column(name)
        return Scalar(self[name], col.type)

    def to_dict(self) -> dict:
        return dict(self._load())

    def __iter__(self):
        return iter(self._load().values())

    def __repr__(self) -> str:  # pragma: no cover
        return f"Row({self._i}, {self._load()!r})"
