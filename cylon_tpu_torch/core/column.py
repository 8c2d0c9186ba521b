"""Column: data, validity, dictionary and host-known bounds (port of
``cylon_tpu/core/column.py``).

Physical layout as in the reference: a fixed-width tensor plus an optional
boolean validity tensor (True = valid).  Strings are dictionary-encoded:
int32 codes on the device, a sorted value table on the host, so code order
is lexical order.  Above the crossover (``config.STRING_HASH_MIN_ROWS``
rows and a sampled distinct ratio of ``config.STRING_HASH_RATIO``) a
string column takes hashed codes instead: int64 value hashes on the
device, a :class:`HashedStrings` lookup on the host.  A host column
(before ingest) holds numpy arrays; the ``Table`` factories move it onto
the env's device.

Out of this slice: decimals and list passthrough columns (ROADMAP Queue 1,
slice 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..status import CylonTypeError, InvalidError
from .dtypes import LogicalType, from_numpy_dtype, physical_np_dtype, torch_dtype


def _is_null_scalar(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


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

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_numpy(arr: np.ndarray, type: LogicalType | None = None) -> "Column":
        """Build a HOST column from a numpy array (no device is touched).
        Encodes strings; NaN stays a float payload."""
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
    def _encode_strings(arr: np.ndarray) -> "Column":
        """Sorted-dictionary encoding (the reference's ``pd.factorize(
        sort=True)``, done with ``np.unique``): codes order like the
        strings.  Above the crossover, hashed codes (:class:`HashedStrings`)
        instead, decided as the reference decides: at least
        ``STRING_HASH_MIN_ROWS`` rows, and a distinct ratio of at least
        ``STRING_HASH_RATIO`` among every ``n // 65536``-th value (at
        most 65536 of them).  None and float NaN are nulls; their codes
        are those of the empty string."""
        if arr.dtype.kind == "S":
            arr = np.char.decode(arr, "utf-8")
        if arr.dtype == object:
            mask = np.asarray([_is_null_scalar(v) for v in arr], bool)
            for v in arr[~mask][:64]:
                if not isinstance(v, (str, bytes, np.str_, np.bytes_)):
                    raise CylonTypeError(
                        f"object column holds {type(v).__name__} values; "
                        "only strings are supported in this slice")
            values = np.asarray(
                ["" if m else (v.decode("utf-8", "replace")
                               if isinstance(v, (bytes, np.bytes_)) else str(v))
                 for v, m in zip(arr, mask)], dtype=object)
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

    # -- materialization ---------------------------------------------------
    def to_numpy(self, n: int | None = None) -> np.ndarray:
        """Decode to a host array of the first ``n`` rows (the valid
        prefix); nulls become NaN (floats) or None (object)."""
        from ..utils.host import host_array
        data = host_array(self.data)[: n if n is not None else len(self)]
        valid = (host_array(self.validity)[: len(data)]
                 if self.validity is not None else None)
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
