"""Series: a named column bound to its table's row layout, with elementwise
compute (port of ``cylon_tpu/series.py``).

Every op is a torch expression over the column's ``(W·cap,)`` tensors on
the env's device; padding rows compute values that the valid-prefix
convention ignores.  Result dtypes follow the reference's JAX promotion
(:func:`_result_dtype`): a Python scalar is weakly typed, an int and a
float array give the float's width, and a true division of integers
gives float32 below 8 bytes and float64 at 8.  Validity propagates as
AND (null op x -> null).

Reductions run per shard on the device — one ``(W, cap)`` masked
reduction for all shards at once — and combine the W partials on the
host, as the reference's ``shard_map`` does.

torch lacks most arithmetic, compares and reductions for uint16/32/64
(on the CPU and on the card), so those run on a same-width signed view
(wrapping add, subtract, multiply, negate: the same bits) or on an exact
int64 image (compares, floor division, remainder and power of 16- and
32-bit values; a uint64 compare flips the sign bit first).  A uint64
floor division, remainder or power raises ``CylonTypeError``.
"""

from __future__ import annotations

import decimal

import numpy as np
import torch

from .core.column import Column, HashedStrings
from .core.dtypes import LogicalType, from_numpy_dtype, np_dtype_of, torch_dtype
from .core.table import Table
from .ops.pack import SIGNED_VIEW as _SIGNED
from .status import CylonTypeError, InvalidError
from .utils.host import host_arrays

_UNSIGNED_WIDE = tuple(_SIGNED)
_FLOATS = (LogicalType.FLOAT32, LogicalType.FLOAT64)


def _binop_validity(a: Column, b):
    va = a.validity
    vb = b.validity if isinstance(b, Column) else None
    if va is None:
        return vb
    if vb is None:
        return va
    return va & vb


def _promote(a: np.dtype, b: np.dtype) -> np.dtype:
    """JAX's promotion of two typed operands: a float meets an integer at
    the float's width; integers promote as numpy does."""
    if a == b:
        return a
    if a.kind == "b":
        return b
    if b.kind == "b":
        return a
    if a.kind == "f" and b.kind == "f":
        return a if a.itemsize >= b.itemsize else b
    if a.kind == "f" or b.kind == "f":
        return a if a.kind == "f" else b
    return np.promote_types(a, b)


def _result_dtype(a: np.dtype, other) -> np.dtype:
    """The result dtype of ``a`` (an array dtype) with ``other``: a dtype,
    a numpy scalar (strongly typed) or a Python scalar (weakly typed:
    it takes the array's dtype unless its kind is higher)."""
    if isinstance(other, np.dtype):
        return _promote(a, other)
    if isinstance(other, np.generic):
        return _promote(a, other.dtype)
    if isinstance(other, bool):
        return a
    if isinstance(other, int):
        return np.dtype(np.int64) if a.kind == "b" else a
    if isinstance(other, float):
        return a if a.kind == "f" else np.dtype(np.float64)
    raise CylonTypeError(f"unsupported operand {other!r}")


def _operand_dtype(a: torch.Tensor, rhs) -> np.dtype:
    """:func:`_result_dtype` of tensor ``a`` with a tensor or a scalar."""
    return _result_dtype(np_dtype_of(a), np_dtype_of(rhs)
                         if isinstance(rhs, torch.Tensor) else rhs)


def _inexact(dt: np.dtype) -> np.dtype:
    """JAX's inexact image of a true division's operand dtype."""
    if dt.kind == "f":
        return dt
    return np.dtype(np.float64 if dt.itemsize == 8 else np.float32)


def _as(x, dt: torch.dtype):
    """Tensor ``x`` converted to ``dt``; a uint16/32/64 target through the
    exact int64 image (torch lacks most conversions into them)."""
    if x.dtype == dt:
        return x
    if dt in _UNSIGNED_WIDE:
        bits = torch.iinfo(_SIGNED[dt]).bits
        x = _int64_image(x)
        if bits < 64:
            x = x & ((1 << bits) - 1)
        return x.to(_SIGNED[dt]).view(dt)
    return x.to(dt)


def _int64_image(x):
    """int64 values of an integer or bool tensor (a uint64's bits)."""
    if x.dtype == torch.uint64:
        return x.view(torch.int64)
    if x.dtype in _UNSIGNED_WIDE:
        s = x.view(_SIGNED[x.dtype]).to(torch.int64)
        return s & ((1 << torch.iinfo(_SIGNED[x.dtype]).bits) - 1)
    return x.to(torch.int64)


def _order_image(x):
    """A tensor whose signed order equals ``x``'s order (unsigned wide
    types: the int64 image, a uint64 with its sign bit flipped)."""
    if x.dtype == torch.uint64:
        return x.view(torch.int64) ^ torch.iinfo(torch.int64).min
    if x.dtype in _UNSIGNED_WIDE:
        return _int64_image(x)
    return x


_ARITH = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "rsub": lambda a, b: b - a,
    "mul": lambda a, b: a * b,
    "truediv": lambda a, b: a / b,
    "rtruediv": lambda a, b: b / a,
    "floordiv": torch.floor_divide,
    "mod": torch.remainder,
    "pow": torch.pow,
    "neg": lambda a, _: torch.neg(a),
    "abs": lambda a, _: a if a.dtype == torch.bool else torch.abs(a),
}
_WRAPPING = ("add", "sub", "rsub", "mul", "neg")

_CMP = {
    "eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
    "gt": torch.gt, "ge": torch.ge,
}


class Series:
    """A column bound to a table's row layout (env + per-shard valid
    counts).  Arithmetic and comparisons with scalars or layout-matched
    Series; a boolean Series filters a ``DataFrame``."""

    __slots__ = ("name", "_col", "_env", "_valid")

    def __init__(self, name: str, col: Column, env, valid_counts: np.ndarray):
        self.name = name
        self._col = col
        self._env = env
        self._valid = valid_counts

    # -- basics ------------------------------------------------------------
    @property
    def column(self) -> Column:
        return self._col

    @property
    def dtype(self) -> LogicalType:
        return self._col.type

    @property
    def env(self):
        return self._env

    @property
    def valid_counts(self) -> np.ndarray:
        return self._valid

    def __len__(self) -> int:
        return int(self._valid.sum())

    @property
    def id(self) -> str:
        return self.name

    @property
    def data(self) -> np.ndarray:
        """The live values on the host (decoded), not the padded tensor
        (that is ``.column.data``)."""
        return self.to_numpy()

    @property
    def shape(self) -> tuple:
        return (len(self),)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Series({self.name!r}, {self.dtype.value}, len={len(self)})"

    def _table(self) -> Table:
        return Table({self.name: self._col}, self._env, self._valid)

    def to_numpy(self) -> np.ndarray:
        return self._table().to_pydict()[self.name]

    def to_pandas(self):
        from .status import require
        return require("pandas").Series(self.to_numpy(), name=self.name)

    # -- elementwise machinery ---------------------------------------------
    def _wrap(self, data, validity, lt: LogicalType | None = None,
              dictionary=None) -> "Series":
        lt = lt or from_numpy_dtype(np_dtype_of(data))
        return Series(self.name, Column(data, lt, validity, dictionary),
                      self._env, self._valid)

    def _other_operand(self, other):
        """``((self column, rhs tensor or scalar), validity)``."""
        if isinstance(other, Series):
            if other._col.data.shape != self._col.data.shape:
                raise InvalidError("series layouts differ; align first")
            if (other._col.type == LogicalType.STRING) != (
                    self._col.type == LogicalType.STRING):
                raise CylonTypeError("cannot mix string and numeric series")
            if other._col.type == LogicalType.STRING:
                from .relational.common import unify_dictionaries
                a, b = unify_dictionaries(self._col, other._col)
                return (a, b.data), _binop_validity(a, b)
            return (self._col, other._col.data), _binop_validity(
                self._col, other._col)
        if isinstance(other, str):
            raise CylonTypeError("string scalar only valid in comparisons")
        return (self._col, other), self._col.validity

    def _arith(self, other, op: str, name: str) -> "Series":
        if self._col.type == LogicalType.STRING:
            raise CylonTypeError(f"{name} not supported for string series")
        if self._col.type == LogicalType.LIST:
            raise CylonTypeError(f"{name} not supported for list series")
        if self._col.type == LogicalType.DECIMAL:
            raise CylonTypeError(
                f"{name} on decimal series is not supported (scale-exact "
                "arithmetic is not implemented); cast to float64 first")
        (col, rhs), validity = self._other_operand(other)
        a = col.data
        rdt = np_dtype_of(a) if op in ("neg", "abs") \
            else _operand_dtype(a, rhs)
        if op in ("truediv", "rtruediv"):
            rdt = _inexact(rdt)
        if isinstance(rhs, np.generic):
            rhs = rhs.item()
        return self._wrap(_apply(op, a, rhs, torch_dtype(rdt)), validity)

    def _compare(self, other, op: str) -> "Series":
        if self._col.type == LogicalType.LIST or (
                isinstance(other, Series)
                and other._col.type == LogicalType.LIST):
            raise CylonTypeError(
                "comparisons on list passthrough series are not supported")
        fn = _CMP[op]
        if self._col.type == LogicalType.DECIMAL:
            sc = self._col.dictionary
            if isinstance(other, Series) \
                    and other._col.type == LogicalType.DECIMAL:
                from .relational.common import rescale_decimal_pair
                a, b = rescale_decimal_pair(self._col, other._col)
                return self._wrap(fn(a.data, b.data),
                                  _binop_validity(a, b), LogicalType.BOOL)
            if isinstance(other, (int, decimal.Decimal)):
                q = decimal.Decimal(other).scaleb(sc.scale)
                if q != int(q):
                    raise CylonTypeError(
                        f"literal {other!r} has more fractional digits "
                        f"than the column scale {sc.scale}")
                return self._wrap(fn(self._col.data, int(q)),
                                  self._col.validity, LogicalType.BOOL)
            raise CylonTypeError(
                "decimal compares need a Decimal/int literal or another "
                "decimal series (float literals are lossy)")
        if isinstance(other, str):
            if self._col.type != LogicalType.STRING:
                raise CylonTypeError("string scalar vs numeric series")
            d = self._col.dictionary
            if isinstance(d, HashedStrings):
                # hashed codes have no lexical order: equality only
                if op not in ("eq", "ne"):
                    raise CylonTypeError(
                        "ordered compare on a high-cardinality hashed "
                        "string column is not supported (== and != work)")
                h = int(d.hash_values([other])[0])
                return self._wrap(fn(self._col.data, h), self._col.validity,
                                  LogicalType.BOOL)
            # codes order like the sorted dictionary; an absent scalar
            # compares as its insertion point - 0.5
            pos = int(np.searchsorted(d, other))
            present = pos < len(d) and d[pos] == other
            rhs = float(pos) if present else pos - 0.5
            return self._wrap(fn(self._col.data.to(torch.float64), rhs),
                              self._col.validity, LogicalType.BOOL)
        (col, rhs), validity = self._other_operand(other)
        if op not in ("eq", "ne"):
            for c in (col, getattr(other, "_col", None)):
                if c is not None and isinstance(
                        getattr(c, "dictionary", None), HashedStrings):
                    raise CylonTypeError(
                        "ordered compare on a high-cardinality hashed "
                        "string column is not supported (== and != work)")
        a = col.data
        rdt = torch_dtype(_operand_dtype(a, rhs))
        if isinstance(rhs, np.generic):
            rhs = rhs.item()
        a = _order_image(_as(a, rdt))
        if isinstance(rhs, torch.Tensor):
            rhs = _order_image(_as(rhs, rdt))
        elif rdt == torch.uint64:
            rhs = (int(rhs) & ((1 << 64) - 1)) ^ (1 << 63)
            rhs -= (1 << 64) if rhs >= (1 << 63) else 0
        return self._wrap(fn(a, rhs), validity, LogicalType.BOOL)

    # arithmetic
    def __add__(self, o):
        return self._arith(o, "add", "+")

    def __radd__(self, o):
        return self._arith(o, "add", "+")

    def __sub__(self, o):
        return self._arith(o, "sub", "-")

    def __rsub__(self, o):
        return self._arith(o, "rsub", "-")

    def __mul__(self, o):
        return self._arith(o, "mul", "*")

    def __rmul__(self, o):
        return self._arith(o, "mul", "*")

    def __truediv__(self, o):
        return self._arith(o, "truediv", "/")

    def __rtruediv__(self, o):
        return self._arith(o, "rtruediv", "/")

    def __floordiv__(self, o):
        return self._arith(o, "floordiv", "//")

    def __mod__(self, o):
        return self._arith(o, "mod", "%")

    def __pow__(self, o):
        return self._arith(o, "pow", "**")

    def __neg__(self):
        return self._arith(0, "neg", "neg")

    def __abs__(self):
        return self._arith(0, "abs", "abs")

    # comparisons
    def __eq__(self, o):  # type: ignore[override]
        return self._compare(o, "eq")

    def __ne__(self, o):  # type: ignore[override]
        return self._compare(o, "ne")

    def __lt__(self, o):
        return self._compare(o, "lt")

    def __le__(self, o):
        return self._compare(o, "le")

    def __gt__(self, o):
        return self._compare(o, "gt")

    def __ge__(self, o):
        return self._compare(o, "ge")

    __hash__ = None  # type: ignore[assignment]

    # logical
    def _logical(self, other, fn) -> "Series":
        if self._col.type != LogicalType.BOOL:
            raise CylonTypeError("logical op on non-bool series")
        (col, rhs), validity = self._other_operand(other)
        if not isinstance(rhs, torch.Tensor):
            rhs = torch.tensor(bool(rhs), device=col.data.device)
        return self._wrap(fn(col.data, rhs), validity, LogicalType.BOOL)

    def __and__(self, o):
        return self._logical(o, torch.logical_and)

    def __or__(self, o):
        return self._logical(o, torch.logical_or)

    def __xor__(self, o):
        return self._logical(o, torch.logical_xor)

    def __invert__(self):
        if self._col.type != LogicalType.BOOL:
            raise CylonTypeError("~ on non-bool series")
        return self._wrap(torch.logical_not(self._col.data),
                          self._col.validity, LogicalType.BOOL)

    # -- null handling -----------------------------------------------------
    def isna(self) -> "Series":
        """True where a value is null or a float NaN."""
        d = self._col.data
        if self._col.validity is None:
            out = torch.isnan(d) if self._col.type in _FLOATS \
                else torch.zeros(d.shape, dtype=torch.bool, device=d.device)
        else:
            out = torch.logical_not(self._col.validity)
            if self._col.type in _FLOATS:
                out = out | torch.isnan(d)
        return self._wrap(out, None, LogicalType.BOOL)

    def notna(self) -> "Series":
        return ~self.isna()

    def where(self, cond: "Series", other=None) -> "Series":
        """Rows where ``cond`` holds keep their value; the rest become
        ``other`` (default: null).  A null condition never selects.  The
        column keeps its type and dictionary."""
        if not isinstance(cond, Series):
            raise CylonTypeError("where condition must be a Series")
        if cond._col.type != LogicalType.BOOL:
            raise CylonTypeError("where condition must be boolean")
        from .relational.common import valid_flag
        keep = valid_flag(cond._col)
        if other is None:
            v = keep if self._col.validity is None \
                else (self._col.validity & keep)
            return self._wrap(self._col.data, v, self._col.type,
                              self._col.dictionary)
        return self._fill_where(torch.logical_not(keep), value=other)

    def fillna(self, value) -> "Series":
        # the mask covers every invalid slot: the result is fully valid
        return self._fill_where(self.isna()._col.data, value,
                                all_valid=True)

    def _fill_where(self, mask, value, all_valid: bool = False) -> "Series":
        """Replace the rows where ``mask`` holds with ``value``; they
        become valid.  Backs ``fillna`` (mask = isna) and the frame's
        ``where`` (mask = ~cond)."""
        col = self._col
        if col.type == LogicalType.STRING:
            if not isinstance(value, str):
                raise CylonTypeError("fill on string series needs str")
            d = col.dictionary
            if isinstance(d, HashedStrings):
                code = int(d.hash_values([value])[0])
                newd = d.merged_with(HashedStrings(
                    np.asarray([code]).astype(np.int64).view(np.uint64),
                    np.asarray([value], dtype=object)))
                data = torch.where(mask, code, col.data)
                v2 = None if (all_valid or col.validity is None) \
                    else (col.validity | mask)
                return self._wrap(data, v2, LogicalType.STRING, newd)
            pos = int(np.searchsorted(d, value))
            if not (pos < len(d) and d[pos] == value):
                newd = np.insert(d, pos, value)
                remap = torch.from_numpy(np.searchsorted(newd, d).astype(
                    np.int32)).to(col.data.device)
                codes = remap[col.data.clamp(0, max(len(d) - 1, 0)).long()] \
                    if len(d) else torch.zeros_like(col.data)
                col = Column(codes, LogicalType.STRING, col.validity, newd)
            code = int(np.searchsorted(col.dictionary, value))
            data = torch.where(mask, torch.tensor(code, dtype=torch.int32,
                                                  device=mask.device),
                               col.data)
            v = None if (all_valid or col.validity is None) \
                else (col.validity | mask)
            return self._wrap(data, v, LogicalType.STRING, col.dictionary)
        dt = col.data.dtype
        sv = _SIGNED.get(dt, dt)
        fill = np.asarray(value, np_dtype_of(col.data)).reshape(1)
        fill = torch.from_numpy(fill).view(sv).to(mask.device)
        data = torch.where(mask, fill, col.data.view(sv)).view(dt)
        v = None if (all_valid or col.validity is None) \
            else (col.validity | mask)
        return self._wrap(data, v, col.type)

    def astype(self, dtype) -> "Series":
        lt = dtype if isinstance(dtype, LogicalType) \
            else from_numpy_dtype(np.dtype(dtype))
        return Series(self.name, self._col.cast(lt), self._env, self._valid)

    # -- reductions --------------------------------------------------------
    def _partials(self, kind: str):
        """Per-shard ``(partials, counts)`` on the host: one masked
        ``(W, cap)`` reduction on the device, one pull (in a multi-process
        world each process reduces its ``(V, cap)`` blocks and the pull
        gathers every rank's).  Live rows that are null (or NaN, pandas'
        skipna) do not count."""
        from .parallel.shards import local_world
        col, lt = self._col, self._col.type
        w = self._valid.shape[0]
        v = local_world(w)
        cap = len(col) // max(v, 1)
        from .relational.common import live_mask
        mask = live_mask(self._valid, cap, col.data.device)
        if col.validity is not None:
            mask = mask & col.validity
        d = col.data
        if lt in _FLOATS:
            mask = mask & ~torch.isnan(d)
        cnt = mask.view(v, cap).sum(dim=1)
        if kind == "count":
            return host_arrays([cnt, cnt], world=w)
        if d.dtype.is_floating_point or d.dtype == torch.bool:
            d = d.to(torch.float64) if d.dtype == torch.bool else d
            zero, big = 0.0, float("inf")
        else:
            d = _order_image(d) if kind != "sum" else _int64_image(d)
            info = torch.iinfo(d.dtype)
            zero, big = 0, (info.max if kind == "min" else info.min)
        if kind == "sum" and d.dtype.is_floating_point:
            # each shard's float sum alone: a (V, cap) row reduction's
            # association depends on V, so a multi-process world's
            # partials would differ in their last bits from one process's
            m = torch.where(mask, d, zero).view(v, cap)
            out = torch.stack([row.sum() for row in m.unbind(0)]) if v \
                else m.sum(dim=1)
        elif kind == "sum":
            m = torch.where(mask, d, zero).view(v, cap)
            out = m.sum(dim=1, dtype=torch.int64)
        else:
            fill = big if kind == "min" or not d.dtype.is_floating_point \
                else -big
            m = torch.where(mask, d, fill).view(v, cap)
            out = m.amin(dim=1) if kind == "min" else m.amax(dim=1)
        return host_arrays([out, cnt], world=w)

    def _reduce(self, kind: str):
        col, lt = self._col, self._col.type
        if lt == LogicalType.STRING and kind not in ("count", "min", "max"):
            raise CylonTypeError(f"{kind} on string series")
        if (lt == LogicalType.STRING and kind in ("min", "max")
                and isinstance(col.dictionary, HashedStrings)):
            raise CylonTypeError(
                f"{kind} on a high-cardinality hashed string series: "
                "hashed codes carry no lexical order")
        parts, cnts = self._partials(kind)
        if kind == "sum":
            if lt in _FLOATS:
                return float(parts.sum())
            total = int(parts.sum())
            unsigned = not col.data.dtype.is_signed \
                and col.data.dtype != torch.bool
            return total & ((1 << 64) - 1) if unsigned else total
        if kind == "count":
            return int(parts.sum())
        live = cnts > 0
        if not live.any():
            # pandas: min/max of an empty or all-NaN numeric series is NaN
            return None if lt == LogicalType.STRING else float("nan")
        v = parts[live].min() if kind == "min" else parts[live].max()
        if col.data.dtype == torch.uint64:
            v = (int(v) ^ (1 << 63)) & ((1 << 64) - 1)
        if lt == LogicalType.STRING:
            return str(col.dictionary[int(v)])
        if lt in _FLOATS:
            return float(v)
        return int(v)

    def sum(self):
        return self._reduce("sum")

    def count(self) -> int:
        return self._reduce("count")

    def min(self):
        return self._reduce("min")

    def max(self):
        return self._reduce("max")

    def mean(self):
        c = self.count()
        return self.sum() / c if c else float("nan")

    def _unique_table(self) -> Table:
        from .relational.setops import unique_table
        return unique_table(self._table(), [self.name])

    def nunique(self) -> int:
        """Distinct non-null values (pandas' semantics: NaN drops too),
        counted on the device."""
        u = self._unique_table()
        return Series(self.name, u.column(self.name), self._env,
                      u.valid_counts).count()

    def unique(self) -> np.ndarray:
        return self._unique_table().to_pydict()[self.name]


def _apply(op: str, a: torch.Tensor, b, rdt: torch.dtype) -> torch.Tensor:
    """``_ARITH[op](a, b)`` at result dtype ``rdt``; unsigned wide types
    through a signed view (wrapping ops) or the int64 image."""
    fn = _ARITH[op]
    a = _as(a, rdt)
    if isinstance(b, torch.Tensor):
        b = _as(b, rdt)
    elif rdt != torch.bool:
        # a Python scalar in the result's kind (torch refuses int - True)
        b = float(b) if rdt.is_floating_point else int(b)
    if op in ("floordiv", "mod") and not rdt.is_floating_point:
        return _int_divmod(op, a, b, rdt)
    if op == "floordiv":
        return _float_floordiv(a, b)
    if rdt not in _UNSIGNED_WIDE:
        return fn(a, b)
    s = _SIGNED[rdt]
    if op in _WRAPPING:
        bb = b.view(s) if isinstance(b, torch.Tensor) else b
        return fn(a.view(s), bb).view(rdt)
    if rdt == torch.uint64:
        raise CylonTypeError(f"{op} on uint64 series is not supported")
    bb = _int64_image(b) if isinstance(b, torch.Tensor) else b
    return _as(fn(_int64_image(a), bb), rdt)


def _int_divmod(op: str, a: torch.Tensor, b, rdt: torch.dtype):
    """Integer ``a // b`` or ``a % b`` with JAX's answers at a zero
    divisor (padding rows hold zeros, and torch raises there): ``x // 0``
    is -1 for x = 0 and -2 otherwise (all ones for an unsigned type),
    ``x % 0`` is 0."""
    if rdt == torch.uint64:
        raise CylonTypeError(f"{op} on uint64 series is not supported")
    wide = rdt in _UNSIGNED_WIDE
    x = _int64_image(a) if wide else a
    y = (_int64_image(b) if wide else b) if isinstance(b, torch.Tensor) \
        else torch.tensor(b, dtype=x.dtype, device=x.device)
    zero = y == 0
    out = _ARITH[op](x, torch.where(zero, torch.ones_like(y), y))
    if op == "floordiv" and rdt.is_signed:
        at_zero = torch.where(x == 0, -1, -2).to(out.dtype)
    elif op == "floordiv":
        bits = 8 * torch.empty(0, dtype=rdt).element_size()
        at_zero = torch.full_like(out, (1 << bits) - 1)
    else:
        at_zero = torch.zeros_like(out)
    out = torch.where(zero, at_zero, out)
    return _as(out, rdt) if wide else out


def _float_floordiv(a: torch.Tensor, b) -> torch.Tensor:
    """JAX's float ``a // b``: the truncated remainder, the quotient of
    what is left, one down where the remainder's sign differs from the
    divisor's, rounded (a zero divisor gives NaN, as in JAX)."""
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    ind = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    return torch.round(torch.where(ind, div - 1, div))
