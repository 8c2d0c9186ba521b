"""Column: data, validity, dictionary and host-known bounds (port of
``cylon_tpu/core/column.py``).

Physical layout as in the reference: a fixed-width tensor plus an optional
boolean validity tensor (True = valid).  Strings are dictionary-encoded:
int32 codes on the device, a sorted value table on the host, so code order
is lexical order.  Above the crossover (``config.STRING_HASH_MIN_ROWS``
rows and a sampled distinct ratio of ``config.STRING_HASH_RATIO``) a
string column takes hashed codes instead: int64 value hashes on the
device, a :class:`HashedStrings` lookup on the host.  Decimals of
precision <= 18 are their unscaled int64 values (:class:`DecimalScale`
rides the dictionary slot); list cells stay on the host and the device
holds int32 row codes into them (:class:`PassthroughValues`).  A host
column (before ingest) holds numpy arrays; the ``Table`` factories move
it onto the env's device.
"""

from __future__ import annotations

import decimal
from typing import Optional

import numpy as np
import torch

from ..status import CylonTypeError, InvalidError
from .dtypes import LogicalType, from_numpy_dtype, physical_np_dtype, torch_dtype


def _is_null_scalar(v) -> bool:
    """What ``pd.isna`` calls a scalar null, without pandas: None, a float
    or complex NaN, a decimal NaN, NaT (numpy's or pandas') and pd.NA."""
    if v is None:
        return True
    if isinstance(v, (float, complex, np.floating, np.complexfloating)):
        return v != v
    if isinstance(v, (np.datetime64, np.timedelta64)):
        return bool(np.isnat(v))
    if isinstance(v, decimal.Decimal):
        return v.is_nan()
    return type(v).__name__ in ("NAType", "NaTType")


def _null_cell(v) -> bool:
    """:func:`_is_null_scalar` of one object cell; a list or array cell is
    a value, never a null."""
    if isinstance(v, (list, np.ndarray)):
        return False
    return _is_null_scalar(v)


def _as_str(v) -> str:
    """One non-null object cell as a string value: nested values and
    decimals mixed with strings are refused (the reference's ``as_str``),
    bytes decode as UTF-8, anything else is ``str(v)``."""
    if isinstance(v, (list, tuple, dict, np.ndarray)):
        raise CylonTypeError(
            "struct/mixed nested columns are not supported on the device "
            "layout; explode or serialize them before ingest")
    if isinstance(v, decimal.Decimal):
        raise CylonTypeError(
            "mixed decimal/str column; cast uniformly before ingest")
    if isinstance(v, (bytes, np.bytes_)):
        return v.decode("utf-8", "replace")
    return str(v)


class HashedStrings:
    """The 'dictionary' of a high-cardinality string column: its device
    codes are stable 64-bit value hashes (the int64 bit pattern of
    ``native.hash_strings``) instead of sorted-dictionary indices.

    It rides the ``Column.dictionary`` slot, so every rebuild site carries
    it along.  Equality of codes is value equality up to 64-bit hash
    collisions, so joins, groupbys, set ops and unique are exact up to
    them; code order is NOT value order, so a groupby min/max on such a
    column raises, and a sort on it goes through value-stable prefix
    lanes (relational/sort.py).  Decoding goes through a lazily built
    hash -> value lookup over the source values."""

    __slots__ = ("_hashes", "_values", "_sorted")

    def __init__(self, hashes: np.ndarray, values: np.ndarray):
        self._hashes = hashes      # uint64, aligned with _values
        self._values = values      # object array of the source strings
        self._sorted = None

    def _lookup(self):
        """(unique hashes ascending, their values), built once."""
        if self._sorted is None:
            order = np.argsort(self._hashes)
            hs = self._hashes[order]
            vs = self._values[order]
            keep = np.concatenate([[True], hs[1:] != hs[:-1]])
            self._sorted = (hs[keep], vs[keep])
        return self._sorted

    def take(self, codes: np.ndarray) -> np.ndarray:
        """Decode int64-bit-pattern codes to their string values."""
        hs, vs = self._lookup()
        u = np.asarray(codes).astype(np.int64).view(np.uint64)
        if len(hs) == 0:
            return np.asarray([""] * len(u), dtype=object)
        idx = np.clip(np.searchsorted(hs, u), 0, len(hs) - 1)
        return vs[idx]

    def hash_values(self, values) -> np.ndarray:
        """int64-bit-pattern codes of new values."""
        from .. import native
        return native.hash_strings(np.asarray(values, dtype=object)) \
            .view(np.int64)

    def merged_with(self, other: "HashedStrings") -> "HashedStrings":
        return HashedStrings(
            np.concatenate([self._hashes, other._hashes]),
            np.concatenate([self._values, other._values]))

    def __len__(self):
        """The number of distinct values."""
        return len(self._lookup()[0])


def hashed_codes(values: np.ndarray):
    """``(codes int64, HashedStrings)`` of a host object array of str."""
    from .. import native
    hashes = native.hash_strings(values)
    return hashes.view(np.int64), HashedStrings(hashes, values)


class DecimalScale:
    """DECIMAL column metadata, riding the ``Column.dictionary`` slot: the
    device data is the UNSCALED int64 (value · 10^scale), exact for
    precision <= 18.  Equality and order of the scaled ints equal those
    of the decimals at a common scale, so joins, groupbys, sorts and
    filters run on the physical column."""

    __slots__ = ("precision", "scale")

    def __init__(self, precision: int, scale: int):
        if precision > 18:
            raise CylonTypeError(
                f"decimal precision {precision} > 18 does not fit int64")
        self.precision = int(precision)
        self.scale = int(scale)

    def __eq__(self, other):
        return (isinstance(other, DecimalScale)
                and other.precision == self.precision
                and other.scale == self.scale)

    def __hash__(self):
        return hash((DecimalScale, self.precision, self.scale))

    def __repr__(self):  # pragma: no cover
        return f"DecimalScale({self.precision}, {self.scale})"

    def to_decimal(self, data: np.ndarray) -> np.ndarray:
        return np.asarray(
            [decimal.Decimal(int(v)).scaleb(-self.scale) for v in data],
            dtype=object)


class PassthroughValues:
    """The host value store of a LIST column: the device data is int32 row
    codes into it.  Codes travel through joins, filters and exchanges as
    string codes do; they are row ids, not values, so a list column is
    never a key."""

    __slots__ = ("values",)

    def __init__(self, values: np.ndarray):
        self.values = np.asarray(values, dtype=object)

    def take(self, codes: np.ndarray) -> np.ndarray:
        n = len(self.values)
        if n == 0:
            return np.asarray([None] * len(codes), dtype=object)
        return self.values[np.clip(codes, 0, n - 1)]

    def __len__(self):
        return len(self.values)


class Column:
    __slots__ = ("data", "validity", "type", "dictionary", "bounds")

    def __init__(self, data, type: LogicalType, validity=None,
                 dictionary: Optional[np.ndarray] = None,
                 bounds: Optional[tuple] = None):
        self.data = data
        self.type = type
        self.validity = validity  # bool array, True = valid; None = all valid
        self.dictionary = dictionary  # host np.ndarray for STRING codes
        #: host-known (lo, hi) value bounds for integer columns, or None.
        #: Any subset/permutation of the values keeps them valid; ops that
        #: create new values drop them.  int64 keys within int32 range sort
        #: and travel as ONE 32-bit lane (ops/pack.py, ops/lanes.py).
        self.bounds = bounds
        if type == LogicalType.STRING and dictionary is None:
            raise InvalidError("STRING column requires a dictionary")
        if type == LogicalType.DECIMAL and not isinstance(dictionary,
                                                          DecimalScale):
            raise InvalidError("DECIMAL column requires a DecimalScale")
        if type == LogicalType.LIST and not isinstance(dictionary,
                                                       PassthroughValues):
            raise InvalidError("LIST column requires PassthroughValues")

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_numpy(arr: np.ndarray, type: LogicalType | None = None) -> "Column":
        """Build a HOST column from a numpy array (no device is touched).
        Encodes strings, decimals and lists; NaN stays a float payload."""
        arr = np.asarray(arr)
        if arr.dtype.kind in ("U", "S", "O"):
            return Column._encode_strings(arr)
        lt = type or from_numpy_dtype(arr.dtype)
        phys = physical_np_dtype(lt)
        if arr.dtype.kind == "M":
            arr = arr.astype("datetime64[ns]").astype("int64", copy=False)
        elif arr.dtype.kind == "m":
            arr = arr.astype("timedelta64[ns]").astype("int64", copy=False)
        arr = arr.astype(phys, copy=False)
        bounds = None
        if arr.dtype.kind in ("i", "u") and arr.size:
            bounds = (int(arr.min()), int(arr.max()))
        return Column(arr, lt, bounds=bounds)

    @staticmethod
    def _decimal_from_objects(arr: np.ndarray, mask: np.ndarray) -> "Column":
        """Object array of ``decimal.Decimal`` -> scaled-int64 DECIMAL
        column at the largest scale of its values, with the tight
        precision (the digit count of the largest unscaled value)."""
        vals = [v for v, m in zip(arr, mask) if not m]
        try:
            # TypeError also covers non-finite Decimals, whose exponent
            # is a str
            scale = max((-v.as_tuple().exponent for v in vals), default=0)
        except (AttributeError, TypeError) as e:
            raise CylonTypeError(
                "mixed or non-finite decimal column; cast uniformly "
                "before ingest") from e
        scale = max(scale, 0)
        data = np.zeros(len(arr), np.int64)
        for i, (v, m) in enumerate(zip(arr, mask)):
            if not m:
                try:
                    data[i] = int(decimal.Decimal(v).scaleb(scale))
                except (decimal.InvalidOperation, TypeError,
                        ValueError) as e:
                    raise CylonTypeError(
                        "mixed decimal column; cast uniformly before "
                        "ingest") from e
        validity = ~mask if mask.any() else None
        bounds = ((int(data.min()), int(data.max())) if len(data) else None)
        max_abs = int(np.abs(data).max()) if len(data) else 0
        prec = max(len(str(max_abs)), 1)
        return Column(data, LogicalType.DECIMAL, validity,
                      DecimalScale(prec, scale), bounds=bounds)

    @staticmethod
    def _list_passthrough(arr: np.ndarray, mask: np.ndarray) -> "Column":
        """Object array of lists -> LIST column (row codes into the
        values; a payload, never a key)."""
        codes = np.arange(len(arr), dtype=np.int32)
        validity = ~mask if mask.any() else None
        return Column(codes, LogicalType.LIST, validity,
                      PassthroughValues(arr),
                      bounds=(0, max(len(arr) - 1, 0)))

    @staticmethod
    def _encode_strings(arr: np.ndarray) -> "Column":
        """An object or string array.  The first non-null cell decides the
        kind, as in the reference: a list makes a LIST column, a
        ``Decimal`` a DECIMAL column, anything else strings.  Every
        non-null cell of a string column is checked: a nested value or a
        decimal raises ``CylonTypeError``, bytes decode, other values
        become ``str(v)``.  Strings take a sorted dictionary (the
        reference's ``pd.factorize(sort=True)``, done with ``np.unique``),
        so codes order like the strings; above the crossover, hashed codes
        (:class:`HashedStrings`), decided as the reference decides: at
        least ``STRING_HASH_MIN_ROWS`` rows, and a distinct ratio of at
        least ``STRING_HASH_RATIO`` among every ``n // 65536``-th value
        (at most 65536 of them).  Nulls are what ``pd.isna`` calls null
        (:func:`_is_null_scalar`); their codes are those of the empty
        string."""
        if arr.dtype.kind == "S":
            arr = np.char.decode(arr, "utf-8")
        if arr.dtype == object:
            # cells of exact type str need no test: the per-cell Python
            # work is on the others only (type() and == run in C)
            odd = np.nonzero(np.frompyfunc(type, 1, 1)(arr) != str)[0]
            mask = np.zeros(len(arr), bool)
            mask[odd] = [_null_cell(arr[i]) for i in odd]
            first = np.argmin(mask) if len(arr) else 0
            probe = None if len(arr) == 0 or mask[first] else arr[first]
            if isinstance(probe, (list, np.ndarray)):
                return Column._list_passthrough(arr, mask)
            if isinstance(probe, decimal.Decimal):
                return Column._decimal_from_objects(arr, mask)
            values = arr.copy()
            for i in odd:
                values[i] = "" if mask[i] else _as_str(arr[i])
        else:
            mask = np.zeros(len(arr), bool)
            values = arr.astype(object)
        validity = ~mask if mask.any() else None
        from .. import config
        n = len(values)
        if n >= config.STRING_HASH_MIN_ROWS:
            samp = values[::max(n // 65536, 1)][:65536]
            if len(np.unique(samp)) >= config.STRING_HASH_RATIO * len(samp):
                codes, lookup = hashed_codes(values)
                return Column(codes, LogicalType.STRING, validity, lookup)
        dictionary, codes = np.unique(values, return_inverse=True)
        return Column(codes.astype(np.int32), LogicalType.STRING, validity,
                      np.asarray(dictionary, dtype=object))

    # -- properties --------------------------------------------------------
    def __len__(self) -> int:
        return int(self.data.shape[0])

    @property
    def has_nulls(self) -> bool:
        return self.validity is not None

    def with_data(self, data, validity="__same__") -> "Column":
        v = self.validity if validity == "__same__" else validity
        return Column(data, self.type, v, self.dictionary)

    # -- materialization ---------------------------------------------------
    def to_numpy(self, n: int | None = None) -> np.ndarray:
        """Decode to a host array of the first ``n`` rows (the valid
        prefix); nulls become NaN (floats) or None (object)."""
        from ..utils.host import host_array
        data = host_array(self.data)[: n if n is not None else len(self)]
        valid = (host_array(self.validity)[: len(data)]
                 if self.validity is not None else None)
        if self.type == LogicalType.DECIMAL:
            out = self.dictionary.to_decimal(data)
            if valid is not None:
                out[~valid] = None
            return out
        if self.type == LogicalType.LIST:
            out = np.asarray(self.dictionary.take(data), dtype=object)
            if valid is not None:
                out = out.copy()
                out[~valid] = None
            return out
        if self.type == LogicalType.STRING:
            if isinstance(self.dictionary, HashedStrings):
                out = self.dictionary.take(data)
            elif len(self.dictionary):
                out = self.dictionary[np.clip(data, 0,
                                              len(self.dictionary) - 1)]
            else:
                out = np.full(len(data), "", object)
            out = np.asarray(out).astype(object)
            if valid is not None:
                out[~valid] = None
            return out
        if self.type == LogicalType.DATE64:
            out = data.astype("datetime64[ns]")
        elif self.type == LogicalType.TIMEDELTA:
            out = data.astype("timedelta64[ns]")
        else:
            out = data.astype(np.dtype(self.type.value), copy=False)
        if valid is not None:
            if out.dtype.kind == "f":
                out = out.copy()
                out[~valid] = np.nan
            else:
                out = out.astype(object)
                out[~valid] = None
        return out

    def cast(self, lt: LogicalType) -> "Column":
        """The physical values converted to ``lt``'s device dtype; the
        dictionary is not carried (a DECIMAL casts to its unscaled
        integers, as in the reference)."""
        if self.type == LogicalType.STRING or lt == LogicalType.STRING:
            raise CylonTypeError("cast to/from string not supported on device")
        phys = physical_np_dtype(lt)
        keep = (self.bounds is not None and phys.kind in ("i", "u")
                and np.can_cast(np.min_scalar_type(self.bounds[0]), phys)
                and np.can_cast(np.min_scalar_type(self.bounds[1]), phys))
        if isinstance(self.data, torch.Tensor):
            data = self.data.to(torch_dtype(phys))
        else:
            data = np.asarray(self.data).astype(phys)
        return Column(data, lt, self.validity,
                      bounds=self.bounds if keep else None)
