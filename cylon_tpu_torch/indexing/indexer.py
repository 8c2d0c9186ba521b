"""Row-label index and the loc/iloc indexers (port of
``cylon_tpu/indexing/indexer.py``).

A label index is "which column (or columns) is the index"; a label lookup
is a device compare-and-filter over that column, with no side structure.
``loc`` slices take both endpoints (pandas' and the reference's
contract); ``iloc`` is global position, through ``slice_table`` and
``filter_table``, whose positions come from the replicated valid
counts.  In a multi-process world a label's presence is each process's
answer over its own ranks' rows, gathered.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from ..core.column import Column, HashedStrings
from ..core.dtypes import LogicalType, np_dtype_of
from ..core.table import Table
from ..ops.pack import SIGNED_VIEW as _SIGNED
from ..relational.common import live_mask, valid_flag
from ..relational.repart import concat_tables, filter_table, slice_table
from ..status import CylonIndexError, CylonKeyError
from ..utils.host import host_array, host_arrays

if TYPE_CHECKING:  # pragma: no cover
    from ..frame import DataFrame

RANGE_INDEX = "__range__"


def _label_codes(col: Column, labels) -> torch.Tensor | None:
    """The device codes of ``labels`` in ``col``'s physical space, or None
    when one of them cannot occur (a string absent from the dictionary)."""
    dev = col.data.device
    if col.type == LogicalType.STRING:
        d = col.dictionary
        if isinstance(d, HashedStrings):
            return torch.from_numpy(d.hash_values(list(labels))).to(dev)
        codes = []
        for lb in labels:
            pos = int(np.searchsorted(d, lb))
            if not (pos < len(d) and d[pos] == lb):
                return None
            codes.append(pos)
        return torch.tensor(codes, dtype=col.data.dtype, device=dev)
    arr = np.asarray(labels).astype(np_dtype_of(col.data))
    t = torch.from_numpy(arr).to(dev)
    return t.view(_SIGNED[t.dtype]) if t.dtype in _SIGNED else t


def _data_view(col: Column) -> torch.Tensor:
    d = col.data
    return d.view(_SIGNED[d.dtype]) if d.dtype in _SIGNED else d


def _label_mask(col: Column, labels) -> torch.Tensor:
    """Device bool mask: the row's index value is one of ``labels``."""
    codes = _label_codes(col, labels)
    if codes is None:
        # string labels: keep the dictionary's present ones only
        present = [lb for lb in labels
                   if _label_codes(col, [lb]) is not None]
        if not present:
            return torch.zeros(col.data.shape, dtype=torch.bool,
                               device=col.data.device)
        codes = _label_codes(col, present)
    return torch.isin(_data_view(col), codes)


def _series_flag(mask):
    return valid_flag(mask.column)


def _gathered_any(flags: np.ndarray) -> np.ndarray:
    """A per-label bool vector OR-ed over every process of a
    multi-process world (each answered for its own ranks' rows)."""
    from ..parallel import transport
    proc = transport.current()
    if proc is None or proc.nproc == 1:
        return flags
    got = transport.allgather_array(np.asarray(flags, np.uint8),
                                    "indexer.present")
    return got.any(axis=0)


def _keep_index(out: "DataFrame", df: "DataFrame") -> "DataFrame":
    out._index = df._index
    out._index_drop = df._index_drop
    return out


class LocIndexer:
    """``df.loc[labels]``, ``df.loc[lo:hi]`` (inclusive) and
    ``df.loc[labels, cols]``."""

    def __init__(self, df: "DataFrame"):
        self._df = df

    def __getitem__(self, key):
        df = self._df
        multi = isinstance(df._index, tuple)
        cols = None
        if isinstance(key, tuple) and len(key) == 2 and not multi:
            key, cols = key
        if multi and isinstance(key, tuple) and len(key) == 2 \
                and not self._is_label_tuple(key):
            # a 2-tuple whose parts are not level values is (rows, cols)
            key, cols = key
        name = df._index
        if name is None or name == RANGE_INDEX:
            out = self._range_loc(key)
        elif multi:
            out = self._label_loc_multi(key, list(name))
        else:
            out = self._label_loc(key, name)
        if cols is not None:
            cols = [cols] if isinstance(cols, str) else list(cols)
            keep = set(df._index_cols() + cols)
            out = _keep_index(out._wrap(out._table.project(
                [c for c in out._table.column_names if c in keep])), df)
        return out

    def _is_label_tuple(self, key) -> bool:
        """A multi-index label tuple holds level values only; the (rows,
        cols) form has a container, slice or Series part."""
        if not isinstance(key, tuple):
            return False
        if len(key) > len(self._df._index_cols()):
            return False
        from ..series import Series
        return not any(isinstance(p, (list, tuple, slice, np.ndarray,
                                      Series)) for p in key)

    def _range_loc(self, key):
        df = self._df
        if isinstance(key, slice):
            lo = 0 if key.start is None else int(key.start)
            hi = len(df) - 1 if key.stop is None else int(key.stop)
            return df[lo:hi + 1]  # loc slices are inclusive
        if np.isscalar(key):
            return df[int(key):int(key) + 1]
        return df.iloc[list(key)]

    def _label_loc(self, key, name: str):
        df = self._df
        col = df._table.column(name)
        if isinstance(key, slice):
            # inclusive label range: start <= value <= stop
            s = df._col_series(name)
            mask = None
            if key.start is not None:
                mask = s >= key.start
            if key.stop is not None:
                m2 = s <= key.stop
                mask = m2 if mask is None else (mask & m2)
            if mask is None:
                return df
            return _keep_index(df._wrap(filter_table(df._table,
                                                     _series_flag(mask))), df)
        labels = [key] if np.isscalar(key) or isinstance(key, str) \
            else list(key)
        # pandas raises when ANY requested label is absent: check each
        # against the live index values, on the device
        present = self._present(col, labels)
        if not present.all():
            missing = [lb for lb, ok in zip(labels, present) if not ok]
            raise CylonKeyError(f"labels {missing!r} not found in index")
        return _keep_index(df._wrap(filter_table(df._table,
                                                 _label_mask(col, labels))),
                           df)

    def _present(self, col: Column, labels) -> np.ndarray:
        """Per label: does a live row hold it (one device pass, one pull)."""
        t = self._df._table
        live = live_mask(t.valid_counts, t.capacity, col.data.device)
        if col.validity is not None:
            live = live & col.validity
        out = np.zeros(len(labels), bool)
        idx = [i for i, lb in enumerate(labels)
               if _label_codes(col, [lb]) is not None]
        if idx:
            codes = _label_codes(col, [labels[i] for i in idx])
            hit = host_array(torch.isin(codes, _data_view(col)[live]))
            out[idx] = _gathered_any(hit)
        return out

    # -- multi-index -------------------------------------------------------
    def _multi_eq_mask(self, labels: tuple, names: list):
        """Conjunction of level equalities over the leading levels (pandas'
        partial indexing)."""
        mask = None
        for lv, lb in zip(names, labels):
            m = self._df._col_series(lv) == lb
            mask = m if mask is None else (mask & m)
        return mask

    def _lex_bound_mask(self, bound: tuple, names: list, is_start: bool):
        """Lexicographic ``>= start`` / ``<= stop`` over the levels a bound
        covers (inclusive; rows equal on the prefix are inside)."""
        mask = None
        for lv, b in reversed(list(zip(names, bound))):
            s = self._df._col_series(lv)
            strict = (s > b) if is_start else (s < b)
            mask = strict | (s == b) if mask is None \
                else strict | ((s == b) & mask)
        return mask

    def _label_loc_multi(self, key, names: list):
        df = self._df
        if isinstance(key, slice):
            def as_tuple(x):
                if x is None:
                    return None
                return x if isinstance(x, tuple) else (x,)
            lo, hi = as_tuple(key.start), as_tuple(key.stop)
            mask = None
            if lo is not None:
                mask = self._lex_bound_mask(lo, names, True)
            if hi is not None:
                m2 = self._lex_bound_mask(hi, names, False)
                mask = m2 if mask is None else (mask & m2)
            if mask is None:
                return df
            out = df._wrap(filter_table(df._table, _series_flag(mask)))
        elif isinstance(key, list):
            labels = [k if isinstance(k, tuple) else (k,) for k in key]
            masks = [self._multi_eq_mask(lb, names) for lb in labels]
            # presence ignores padding rows (their contents are
            # unspecified); one pull covers every label
            t = df._table
            live = live_mask(t.valid_counts, t.capacity,
                             masks[0].column.data.device)
            hits = host_arrays([torch.stack(
                [(_series_flag(m) & live).sum() for m in masks])])[0]
            hits = _gathered_any(hits > 0)
            for lb, h in zip(labels, hits):
                if int(h) == 0:
                    raise CylonKeyError(f"label {lb!r} not found in index")
            mask = masks[0]
            for m in masks[1:]:
                mask = mask | m
            out = df._wrap(filter_table(df._table, _series_flag(mask)))
        else:
            labels = key if isinstance(key, tuple) else (key,)
            if len(labels) > len(names):
                raise CylonKeyError(
                    f"label tuple {labels!r} longer than the "
                    f"{len(names)}-level index")
            mask = self._multi_eq_mask(labels, names)
            out = df._wrap(filter_table(df._table, _series_flag(mask)))
            if len(out) == 0:
                raise CylonKeyError(f"label {key!r} not found in index")
        return _keep_index(out, df)


class ILocIndexer:
    """``df.iloc[pos]``: global positional selection."""

    def __init__(self, df: "DataFrame"):
        self._df = df

    def __getitem__(self, key):
        cols = None
        if isinstance(key, tuple) and len(key) == 2:
            key, cols = key
        df = self._df
        n = len(df)
        if isinstance(key, slice):
            start, stop, step = key.indices(n)
            if step != 1:
                raise CylonIndexError("iloc step not supported")
            out = df._wrap(slice_table(df._table, start, stop - start))
        elif np.isscalar(key):
            i = int(key)
            if i < 0:
                i += n
            if not 0 <= i < n:
                raise CylonIndexError(f"position {key} out of range [0,{n})")
            out = df._wrap(slice_table(df._table, i, 1))
        else:
            out = df._wrap(self._positions(key, n))
        _keep_index(out, df)
        if cols is not None:
            cols = [cols] if isinstance(cols, str) else list(cols)
            out = out._wrap(out._table.project(cols))
            out._index = None
        return out

    def _positions(self, key, n: int) -> Table:
        """A positional list, pandas' order and duplicates: the contiguous
        runs of the sorted unique positions are sliced on the device, and
        the k picked rows reordered on the host and ingested again."""
        df = self._df
        pos = [int(p) + (n if int(p) < 0 else 0) for p in key]
        if any(not 0 <= p < n for p in pos):
            raise CylonIndexError(f"positions out of range [0,{n})")
        if not pos:
            return slice_table(df._table, 0, 0)
        uniq = sorted(set(pos))
        runs = []
        lo = prev = uniq[0]
        for p in uniq[1:]:
            if p == prev + 1:
                prev = p
                continue
            runs.append((lo, prev - lo + 1))
            lo = prev = p
        runs.append((lo, prev - lo + 1))
        parts = [slice_table(df._table, o, ln) for o, ln in runs]
        picked = parts[0] if len(parts) == 1 else concat_tables(parts)
        order = {p: i for i, p in enumerate(uniq)}
        sel = np.asarray([order[p] for p in pos], np.int64)
        host = picked.host_columns()
        cols = {}
        for cn, c in picked.columns.items():
            data, valid = host[cn]
            cols[cn] = Column(data[sel], c.type,
                              None if valid is None else valid[sel],
                              c.dictionary)
        return Table.from_host_columns(cols, df.env)
