"""CSV / Parquet / JSON readers and writers, single and distributed (port
of ``cylon_tpu/io/io.py``).

The readers take pyarrow's buffers straight into host columns
(``Table.from_arrow``); pandas serves the reader options pyarrow does not
take and the writers.  Both packages are imported inside the calls only:
without the one a call needs, it raises ``CylonIOError`` naming it (the
card machine has neither).  Distributed readers give each rank the rows
of its files (CSV) or a size-balanced set of row groups (Parquet);
distributed writers write one file per shard, pulling one shard at a
time.  :class:`ParquetScanSource` streams row-group batches as Tables for
``exec.pipelined_scan_join``.
"""

from __future__ import annotations

import glob as _glob
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from ..core.column import Column
from ..core.table import Table
from ..ctx.context import CylonEnv
from ..status import CylonIOError, CylonTypeError, require
from ..utils.host import host_arrays


def _expand(paths) -> list[str]:
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out = []
    for p in paths:
        p = os.fspath(p)
        matches = sorted(_glob.glob(p)) if any(ch in p for ch in "*?[") \
            else [p]
        out.extend(matches)
    if not out:
        raise CylonIOError(f"no files match {paths!r}")
    return out


def _map_files(files: list[str], read_one, parallel: bool = True) -> list:
    if parallel and len(files) > 1:
        with ThreadPoolExecutor(max_workers=min(8, len(files))) as ex:
            return list(ex.map(read_one, files))
    return [read_one(f) for f in files]


def _read_many(files: list[str], read_one, parallel: bool = True):
    """Read several files with pandas, threaded, into one frame."""
    pd = require("pandas")
    dfs = _map_files(files, read_one, parallel)
    return dfs[0] if len(dfs) == 1 else pd.concat(dfs, ignore_index=True)


def _concat_arrow(tables):
    if len(tables) == 1:
        return tables[0]
    return require("pyarrow").concat_tables(tables,
                                            promote_options="default")


def _read_many_arrow(files: list[str], read_one, parallel: bool = True):
    """Read several files with pyarrow, threaded, into one Arrow table."""
    return _concat_arrow(_map_files(files, read_one, parallel))


def _from_arrow(at, env) -> Table:
    """An Arrow table as a Table; an Arrow type with no direct conversion
    goes through pandas (the table already read, no second disk pass)."""
    try:
        return Table.from_arrow(at, env)
    except CylonTypeError:
        require("pandas")
        return Table.from_pandas(at.to_pandas(), env)


def read_csv(paths, env: CylonEnv | None = None, **kwargs) -> Table:
    """CSV through pyarrow's reader; pandas reader options (``kwargs``)
    take pandas' reader instead."""
    files = _expand(paths)
    if kwargs:
        pd = require("pandas")
        df = _read_many(files, lambda f: pd.read_csv(f, **kwargs))
        return Table.from_pandas(df, env)
    pacsv = require("pyarrow.csv")
    return _from_arrow(_read_many_arrow(files, pacsv.read_csv), env)


def read_parquet(paths, env: CylonEnv | None = None, **kwargs) -> Table:
    files = _expand(paths)
    if kwargs:
        pd = require("pandas")
        df = _read_many(files, lambda f: pd.read_parquet(f, **kwargs))
        return Table.from_pandas(df, env)
    pq = require("pyarrow.parquet")
    return _from_arrow(_read_many_arrow(files, pq.read_table), env)


def read_json(paths, env: CylonEnv | None = None, **kwargs) -> Table:
    """Newline-delimited JSON through pyarrow; a file pyarrow cannot parse
    (an array of objects) or pandas reader options take pandas'."""
    files = _expand(paths)
    if not kwargs:
        pajson = require("pyarrow.json")
        pa = require("pyarrow")
        try:
            at = _read_many_arrow(files, pajson.read_json)
            return Table.from_arrow(at, env)
        except (pa.ArrowInvalid, CylonTypeError):
            pass
    pd = require("pandas")
    kwargs.setdefault("lines", str(files[0]).endswith(".jsonl"))
    df = _read_many(files, lambda f: pd.read_json(f, **kwargs))
    return Table.from_pandas(df, env)


# -- writers ----------------------------------------------------------------

def write_csv(table: Table, path, **kwargs) -> None:
    kwargs.setdefault("index", False)
    table.to_pandas().to_csv(path, **kwargs)


def write_parquet(table: Table, path, **kwargs) -> None:
    require("pyarrow")
    kwargs.setdefault("index", False)
    table.to_pandas().to_parquet(path, **kwargs)


def write_json(table: Table, path, **kwargs) -> None:
    kwargs.setdefault("orient", "records")
    kwargs.setdefault("lines", True)
    table.to_pandas().to_json(path, **kwargs)


def _shard_frames(table: Table):
    """``(rank, pandas frame of that shard's live rows)``, one shard on
    the host at a time, each in one batched pull.  In a multi-process
    world only this process's ranks yield (the reference's
    ``_shard_frames`` under multi-controller execution)."""
    from ..parallel.shards import span
    pd = require("pandas")
    cols = dict(table.columns)
    cap = table.capacity
    ranks = span(table.env.world_size)
    for r in ranks:
        n_live = int(table.valid_counts[r])
        lo = (r - ranks.start) * cap
        flat = []
        for c in cols.values():
            flat.append(c.data[lo:lo + n_live])
            flat.append(None if c.validity is None
                        else c.validity[lo:lo + n_live])
        pulled = host_arrays(flat)
        data = {name: Column(pulled[2 * j], c.type, pulled[2 * j + 1],
                             c.dictionary).to_numpy(n_live)
                for j, (name, c) in enumerate(cols.items())}
        yield r, pd.DataFrame(data)


def _dist_path(path, rank: int) -> str:
    root, ext = os.path.splitext(os.fspath(path))
    return f"{root}_{rank}{ext}"


def _write_dist(table: Table, path, write) -> list[str]:
    out = []
    for rank, df in _shard_frames(table):
        p = _dist_path(path, rank)
        write(df, p)
        out.append(p)
    return out


def write_csv_dist(table: Table, path, **kwargs) -> list[str]:
    """One CSV per shard, ``{root}_{rank}{ext}``."""
    kwargs.setdefault("index", False)
    return _write_dist(table, path, lambda df, p: df.to_csv(p, **kwargs))


def write_parquet_dist(table: Table, path, **kwargs) -> list[str]:
    require("pyarrow")
    kwargs.setdefault("index", False)
    return _write_dist(table, path,
                       lambda df, p: df.to_parquet(p, **kwargs))


def write_json_dist(table: Table, path, **kwargs) -> list[str]:
    kwargs.setdefault("orient", "records")
    kwargs.setdefault("lines", True)
    return _write_dist(table, path, lambda df, p: df.to_json(p, **kwargs))


# -- distributed readers ----------------------------------------------------

def read_csv_dist(paths, env: CylonEnv, **kwargs) -> Table:
    """File i goes to rank ``i % W``: each rank's files form its
    partition.  Every process reads the file list and ingests its own
    ranks' rows."""
    from ..relational.repart import repartition
    files = _expand(paths)
    w = env.world_size
    per_rank: list[list[str]] = [[] for _ in range(w)]
    for i, f in enumerate(files):
        per_rank[i % w].append(f)
    if kwargs:
        pd = require("pandas")
        parts = [_read_many(fl, lambda f: pd.read_csv(f, **kwargs))
                 if fl else None for fl in per_rank]
        counts = [0 if p is None else len(p) for p in parts]
        live = [p for p in parts if p is not None]
        if not live:
            raise CylonIOError("no data read")
        t = Table.from_pandas(pd.concat(live, ignore_index=True), env)
    else:
        pacsv = require("pyarrow.csv")
        parts, counts = [], []
        for fl in per_rank:
            if fl:
                at = _read_many_arrow(fl, pacsv.read_csv)
                parts.append(at)
                counts.append(at.num_rows)
            else:
                counts.append(0)
        if not parts:
            raise CylonIOError("no data read")
        t = Table.from_arrow(_concat_arrow(parts), env)
    return repartition(t, tuple(counts))


def _row_group_units(files: list[str]) -> list[tuple]:
    """``(file, row_group, n_rows)`` in file and row-group order."""
    pq = require("pyarrow.parquet")
    units = []
    for f in files:
        meta = pq.ParquetFile(f)
        for g in range(meta.num_row_groups):
            units.append((f, g, meta.metadata.row_group(g).num_rows))
    return units


class ParquetScanSource:
    """A streaming row-group scan: iterating yields one :class:`Table` on
    ``env`` per batch of consecutive row groups of at most
    ``batch_rows`` rows (a larger row group is a batch of its own), in
    file and row-group order, so a consumer holds one batch at a time.
    ``columns`` projects the read (batches and :attr:`column_names`
    follow the requested order)."""

    def __init__(self, paths, env: CylonEnv, batch_rows: int = 1 << 20,
                 columns: Sequence | None = None):
        self.env = env
        self.files = _expand(paths)
        self.batch_rows = max(int(batch_rows), 1)
        self.columns = list(columns) if columns is not None else None
        self._units = _row_group_units(self.files)
        self.total_rows = int(sum(u[2] for u in self._units))
        self._names: list[str] | None = None
        self._handles: dict = {}   # one ParquetFile per path

    def _file(self, path: str):
        pf = self._handles.get(path)
        if pf is None:
            pf = self._handles[path] = \
                require("pyarrow.parquet").ParquetFile(path)
        return pf

    @property
    def column_names(self) -> list[str]:
        if self._names is None:
            schema = self._file(self.files[0]).schema_arrow
            self._names = list(schema.names) if self.columns is None \
                else [n for n in self.columns if n in schema.names]
        return self._names

    def batches(self):
        """The ``(file, row_group, n_rows)`` unit lists, one per batch."""
        out, rows = [], 0
        for u in self._units:
            if out and rows + u[2] > self.batch_rows:
                yield out
                out, rows = [], 0
            out.append(u)
            rows += u[2]
        if out:
            yield out

    def __iter__(self):
        for batch in self.batches():
            ats = [self._file(f).read_row_group(g, columns=self.columns)
                   for f, g, _ in batch]
            yield Table.from_arrow(_concat_arrow(ats), self.env)


def scan_parquet_dist(paths, env: CylonEnv, batch_rows: int = 1 << 20,
                      columns=None) -> ParquetScanSource:
    """The streaming mode of :func:`read_parquet_dist`: batches, not one
    table (feed it to ``exec.pipelined_scan_join``)."""
    return ParquetScanSource(paths, env, batch_rows=batch_rows,
                             columns=columns)


def read_parquet_dist(paths, env: CylonEnv, batch_rows: int | None = None,
                      **kwargs):
    """Row groups assigned to ranks greedily by size (the largest first,
    onto the least-loaded rank).  With ``batch_rows`` the streaming scan
    instead (:func:`scan_parquet_dist`)."""
    from ..relational.repart import repartition
    if batch_rows is not None:
        if kwargs:
            raise CylonIOError(
                "streaming parquet scan (batch_rows=) does not take "
                "pandas reader kwargs — project with columns= on "
                "scan_parquet_dist instead")
        return scan_parquet_dist(paths, env, batch_rows=batch_rows)
    pq = require("pyarrow.parquet")
    files = _expand(paths)
    w = env.world_size
    units = _row_group_units(files)
    units.sort(key=lambda u: -u[2])
    loads = [0] * w
    assign: list[list[tuple]] = [[] for _ in range(w)]
    for u in units:
        r = int(np.argmin(loads))
        assign[r].append(u)
        loads[r] += u[2]
    handles = {f: pq.ParquetFile(f) for f in files}
    parts, counts = [], []
    for r in range(w):
        if assign[r]:
            ats = [handles[f].read_row_group(g) for f, g, _ in assign[r]]
            parts.append(_concat_arrow(ats))
            counts.append(parts[-1].num_rows)
        else:
            counts.append(0)
    if not parts:
        raise CylonIOError("no data read")
    t = Table.from_arrow(_concat_arrow(parts), env)
    return repartition(t, tuple(counts))
