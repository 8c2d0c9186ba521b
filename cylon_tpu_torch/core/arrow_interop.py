"""pyarrow Table/Array <-> host Columns (port of
``cylon_tpu/core/arrow_interop.py``).

Each Arrow column's buffers convert directly, with no pandas round trip:

* numeric, bool and temporal: ``fill_null`` + ``to_numpy`` on the combined
  chunk, validity from ``is_valid()``; timestamps, dates and durations as
  ns-resolution int64;
* strings (utf8, large_utf8, dictionary): ``dictionary_encode``, then
  re-coded onto a SORTED value table, so code order is lexical order;
* decimal128 of precision <= 18: the low 64-bit limb of each value is its
  unscaled integer (exact); wider decimals fall back to float64;
* lists: a host passthrough column (int32 row codes into the values).

pyarrow is imported inside these functions only: the package itself never
needs it, and without it a call raises ``CylonIOError``.
"""

from __future__ import annotations

import numpy as np

from ..status import CylonTypeError, require
from .column import Column, DecimalScale, HashedStrings, PassthroughValues
from .dtypes import LogicalType, from_numpy_dtype, physical_np_dtype


def _sorted_dictionary(indices: np.ndarray, values: np.ndarray):
    """Re-code onto a sorted unique dictionary (code order == lexical)."""
    uniq, remap = np.unique(values, return_inverse=True)
    codes = remap.astype(np.int32)[np.clip(indices, 0, len(values) - 1)] \
        if len(values) else indices.astype(np.int32)
    return codes, uniq


def column_from_arrow(arr) -> Column:
    """pyarrow Array/ChunkedArray -> host Column."""
    pa = require("pyarrow")
    pc = require("pyarrow.compute")

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = arr.type

    validity = None
    if arr.null_count:
        validity = np.asarray(arr.is_valid())

    if pa.types.is_dictionary(t):
        if not pa.types.is_string(t.value_type):
            return column_from_arrow(arr.cast(t.value_type))
        idx = np.asarray(arr.indices.fill_null(0))
        vals = np.asarray(arr.dictionary, dtype=object)
        vals = np.asarray([v if isinstance(v, str) else str(v)
                           for v in vals], dtype=object)
        codes, uniq = _sorted_dictionary(idx, vals)
        return Column(codes, LogicalType.STRING, validity, uniq)

    if pa.types.is_string(t) or pa.types.is_large_string(t):
        enc = pc.dictionary_encode(arr.fill_null(""))
        idx = np.asarray(enc.indices.fill_null(0))
        vals = np.asarray(enc.dictionary, dtype=object)
        codes, uniq = _sorted_dictionary(idx, vals)
        return Column(codes, LogicalType.STRING, validity, uniq)

    if pa.types.is_timestamp(t) or pa.types.is_date(t):
        arr = arr.cast(pa.timestamp("ns"))
        data = np.asarray(arr.fill_null(0).cast(pa.int64()))
        return Column(data, LogicalType.DATE64, validity)
    if pa.types.is_duration(t):
        arr = arr.cast(pa.duration("ns"))
        data = np.asarray(arr.fill_null(0).cast(pa.int64()))
        return Column(data, LogicalType.TIMEDELTA, validity)

    if pa.types.is_boolean(t):
        data = np.asarray(arr.fill_null(False))
        return Column(data, LogicalType.BOOL, validity)

    if pa.types.is_null(t):
        # an all-empty column (a CSV column with no values): all-null f64
        n = len(arr)
        return Column(np.zeros(n, np.float64), LogicalType.FLOAT64,
                      np.zeros(n, bool))

    if pa.types.is_decimal(t):
        if pa.types.is_decimal128(t) and t.precision <= 18:
            # the unscaled integer is decimal128's two's-complement
            # storage; for p <= 18 it lives in the low limb
            raw = np.frombuffer(arr.buffers()[1], np.int64)
            data = raw.reshape(-1, 2)[arr.offset:arr.offset + len(arr),
                                      0].copy()
            if validity is not None:
                data[~validity] = 0   # null slots hold undefined storage
            bounds = ((int(data.min()), int(data.max()))
                      if data.size else None)
            return Column(data, LogicalType.DECIMAL, validity,
                          DecimalScale(t.precision, t.scale), bounds=bounds)
        # p > 18 or decimal256: float64, as in the reference
        arr = arr.cast(pa.float64())
        t = arr.type

    if pa.types.is_list(t) or pa.types.is_large_list(t) \
            or pa.types.is_fixed_size_list(t):
        vals = np.asarray(arr.to_pylist(), dtype=object)
        codes = np.arange(len(vals), dtype=np.int32)
        return Column(codes, LogicalType.LIST, validity,
                      PassthroughValues(vals),
                      bounds=(0, max(len(vals) - 1, 0)))

    if pa.types.is_integer(t) or pa.types.is_floating(t):
        filled = arr.fill_null(0) if arr.null_count else arr
        data = np.asarray(filled)
        lt = from_numpy_dtype(data.dtype)
        data = data.astype(physical_np_dtype(lt), copy=False)
        bounds = None
        if data.dtype.kind in ("i", "u") and data.size:
            bounds = (int(data.min()), int(data.max()))
        return Column(data, lt, validity, bounds=bounds)

    raise CylonTypeError(f"unsupported arrow type {t}")


def table_from_arrow(at, env=None):
    """pyarrow.Table -> Table on ``env``."""
    from .table import Table
    cols = {name: column_from_arrow(at.column(name))
            for name in at.column_names}
    return Table.from_host_columns(cols, env)


def table_to_arrow(table):
    """Table -> pyarrow.Table with the columns' own types."""
    pa = require("pyarrow")
    arrays, names = [], []
    hosts = table.host_columns()
    for name, c in table.columns.items():
        data, valid = hosts[name]
        mask = ~valid if valid is not None else None
        if c.type == LogicalType.STRING:
            if isinstance(c.dictionary, HashedStrings):
                arr = pa.array(c.dictionary.take(data), type=pa.string(),
                               mask=mask)
            else:
                idx = pa.array(data.astype(np.int32), mask=mask)
                arr = pa.DictionaryArray.from_arrays(
                    idx, pa.array(c.dictionary.astype(object))
                ).dictionary_decode()
        elif c.type == LogicalType.DATE64:
            arr = pa.array(data, type=pa.timestamp("ns"), mask=mask)
        elif c.type == LogicalType.TIMEDELTA:
            arr = pa.array(data, type=pa.duration("ns"), mask=mask)
        elif c.type == LogicalType.DECIMAL:
            sc = c.dictionary
            # a tight ingested precision can be below the scale
            # ([0.01, 0.02] -> (1, 2)); Arrow needs precision >= scale
            arr = pa.array(sc.to_decimal(data),
                           type=pa.decimal128(max(sc.precision, sc.scale, 1),
                                              sc.scale), mask=mask)
        elif c.type == LogicalType.LIST:
            arr = pa.array(list(c.dictionary.take(data)), mask=mask)
        else:
            arr = pa.array(data, mask=mask)
        arrays.append(arr)
        names.append(name)
    return pa.Table.from_arrays(arrays, names=names)
