"""Logical type system (port of ``cylon_tpu/core/dtypes.py``).

A :class:`LogicalType` names the user-visible type; the physical
representation is a fixed-width tensor (strings are dictionary-encoded to
int32 codes with a host-side value table, decimals are scaled int64, and
list cells are int32 row codes into a host value store).  Unlike the reference there is
no x64 opt-out: 64-bit types always stay 64-bit.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch

from ..status import CylonTypeError


class LogicalType(enum.Enum):
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    STRING = "string"          # dictionary-encoded, codes int32
    DATE64 = "datetime64[ns]"  # physical int64 nanoseconds
    TIMEDELTA = "timedelta64[ns]"
    DECIMAL = "decimal"        # physical int64, scaled by DecimalScale
    LIST = "list"              # host passthrough: int32 codes into values


_NUMERIC_NP = {
    LogicalType.BOOL: np.bool_,
    LogicalType.INT8: np.int8,
    LogicalType.INT16: np.int16,
    LogicalType.INT32: np.int32,
    LogicalType.INT64: np.int64,
    LogicalType.UINT8: np.uint8,
    LogicalType.UINT16: np.uint16,
    LogicalType.UINT32: np.uint32,
    LogicalType.UINT64: np.uint64,
    LogicalType.FLOAT32: np.float32,
    LogicalType.FLOAT64: np.float64,
}

_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_NUMPY = {v: k for k, v in _TORCH.items()}


def physical_np_dtype(lt: LogicalType) -> np.dtype:
    """The numpy dtype of the device representation of ``lt``."""
    if lt in (LogicalType.STRING, LogicalType.LIST):
        return np.dtype(np.int32)
    if lt in (LogicalType.DATE64, LogicalType.TIMEDELTA,
              LogicalType.DECIMAL):
        return np.dtype(np.int64)
    return np.dtype(_NUMERIC_NP[lt])


def from_numpy_dtype(dt) -> LogicalType:
    dt = np.dtype(dt)
    if dt.kind == "M":
        return LogicalType.DATE64
    if dt.kind == "m":
        return LogicalType.TIMEDELTA
    if dt.kind in ("U", "S", "O"):
        return LogicalType.STRING
    try:
        return LogicalType(dt.name)
    except ValueError as e:
        raise CylonTypeError(f"unsupported dtype {dt}") from e


def torch_dtype(dt) -> torch.dtype:
    """numpy dtype -> torch dtype of the same width and kind."""
    try:
        return _TORCH[np.dtype(dt)]
    except KeyError as e:
        raise CylonTypeError(f"no torch dtype for {dt}") from e


def np_dtype_of(x) -> np.dtype:
    """numpy dtype of a tensor or a numpy array."""
    if isinstance(x, torch.Tensor):
        return _NUMPY[x.dtype]
    return np.dtype(x.dtype)


class Field(NamedTuple):
    """Column schema entry: name, logical type and nullability."""

    name: str
    type: LogicalType
    nullable: bool = False
