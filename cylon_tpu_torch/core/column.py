"""Column: data, validity, dictionary and host-known bounds (port of
``cylon_tpu/core/column.py``).

Physical layout as in the reference: a fixed-width tensor plus an optional
boolean validity tensor (True = valid).  Strings are dictionary-encoded:
int32 codes on the device, a sorted value table on the host, so code order
is lexical order.  A host column (before ingest) holds numpy arrays; the
``Table`` factories move it onto the env's device.

Out of this slice: hashed high-cardinality strings, decimals and list
passthrough columns (ROADMAP Queue 1, slice 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..status import CylonTypeError, InvalidError
from .dtypes import LogicalType, from_numpy_dtype, physical_np_dtype, torch_dtype


def _is_null_scalar(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


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
        strings.  None and float NaN are nulls."""
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
        dictionary, codes = np.unique(values, return_inverse=True)
        validity = ~mask if mask.any() else None
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
            out = self.dictionary[np.clip(data, 0, len(self.dictionary) - 1)] \
                if len(self.dictionary) else np.full(len(data), "", object)
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
