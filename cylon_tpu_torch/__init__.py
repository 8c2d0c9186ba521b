"""cylon_tpu_torch: the PyTorch/CUDA port of cylon_tpu for one NVIDIA H100.

The port mirrors ``cylon_tpu``'s module layout and is held bit-equal to it
by the ``tests/test_torch_*.py`` parity tests.  Its entry point is the
``DataFrame`` (``merge``, ``groupby(...).sum()`` and the other
aggregations, ``sort_values``) over the table operators: ``Table``
ingest, ``join_tables`` with every join type of the reference (an inner
join defers its output; a small side may be broadcast instead of
shuffled), ``join_tables_multi``, ``filter_table``,
``groupby_aggregate`` (the fused join→groupby pushdown, whose run-start
gather is the hand-written CUDA kernel ``kernels/windowed_gather.cu``,
and the sort-based groupby for every other table), the distributed
sample sort ``sort_table``, the set operations (``set_operation``,
``unique_table``, ``equals``, and ``exec.pipelined_set_op`` over row
chunks) and the redistributions (``repartition``, ``slice_table``,
``head``, ``tail``).  A column is a ``Series`` (arithmetic,
comparisons, masks, null handling and reductions on the device); a frame
has a label index with ``loc``/``iloc``.  Decimal (scaled int64) and
list (host passthrough) columns, Arrow interop (``Table.from_arrow`` /
``to_arrow``), file IO (``io``: CSV, Parquet, JSON, the streaming
Parquet scan) and ``exec.pipelined_scan_join`` complete the API.  A
string column of high cardinality takes hashed
64-bit codes (``core.column.HashedStrings``, hashed on the host by
``native/strhash.cpp``, built with ``g++`` at first use).  World sizes above 1 run as a
``VirtualMeshConfig`` world, W ranks on one device: tables hash-shuffle
through an order-preserving device-local exchange (``parallel/``) that
routes every row to the reference's rank, and every shard then runs the
world-1 operators.  Above the card's
memory the same work runs through the range-partitioned
``exec.pipelined_join`` with a ``GroupBySink``, whose per-row range
assignment is the hand-written CUDA kernel ``kernels/splitter_probe.cu``;
``join_tables``, ``groupby_aggregate`` and ``set_operation`` take that
chunked route on their own when the card runs out of memory (the retry
ladder, ``exec.recovery``), and a memory ledger over budget evicts cold
packed sources to host memory and past a host budget to disk
(``exec.memory``).

The package imports torch and numpy only; pandas and pyarrow are touched
only by the pandas and Arrow conversions and the file IO, inside the
calls, which raise ``CylonIOError`` naming the package when it is
missing.

``stream`` serves micro-batch streams: ``StreamTable`` (append-only,
shuffled on arrival), ``IncrementalView`` (a groupby kept up to date,
read as consistent snapshots) and ``TumblingWindowJoin`` (event-time
windows closed under an agreed watermark).

``obs`` observes a query: ``obs.explain_analyze(fn, ...)`` returns its
plan tree with per-node rows, bytes and seconds; the metrics registry,
the flight recorder (``CYLON_TPU_TORCH_TRACE``), the exchange's comm
matrix and the per-rank report are armed by their switches.
"""

from . import io  # noqa: F401  (readers and writers; pyarrow/pandas lazily)
from . import obs  # noqa: F401  (metrics, trace, plan, comm, rank report)
obs.trace.autoarm()     # CYLON_TPU_TORCH_TRACE=path arms the recorder
obs.metrics.autoarm()   # CYLON_TPU_TORCH_METRICS_JSON=path: final snapshot
from .core.column import Column
from .core.dtypes import LogicalType
from .core.row import Row, Scalar
from .core.table import DeferredTable, Table
from .ctx.context import (CylonEnv, DistributedConfig, LocalConfig,
                          VirtualMeshConfig)
from .exec import (GroupBySink, chunk_table, pipelined_join,
                   pipelined_scan_join, pipelined_set_op)
from .frame import DataFrame, GroupByDataFrame, concat, read_pandas
from .relational.groupby import groupby_aggregate
from .relational.join import join_tables, join_tables_multi
from .relational.repart import (concat_tables, filter_table, head,
                                repad_table, repartition, shuffle_table,
                                slice_table, tail)
from .relational.setops import equals, set_operation, unique_table
from .relational.sort import local_sort_table, sort_table
from .series import Series
from . import stream  # noqa: F401  (StreamTable, IncrementalView, windows)
from .status import (Code, CylonError, CylonIndexError, CylonIOError,
                     CylonKeyError, CylonTypeError, DeviceUnavailableError,
                     InvalidError, KernelError, ResumableAbort, Status)
from .utils.logging import set_log_level

__all__ = ["Code", "Column", "CylonEnv", "CylonError", "CylonIOError",
           "CylonIndexError", "CylonKeyError", "CylonTypeError",
           "DataFrame", "DeferredTable", "DeviceUnavailableError",
           "DistributedConfig",
           "GroupByDataFrame", "GroupBySink", "InvalidError", "KernelError",
           "LocalConfig", "LogicalType", "ResumableAbort", "Row", "Scalar",
           "Series", "Status", "Table", "VirtualMeshConfig", "chunk_table",
           "concat",
           "concat_tables",
           "equals", "filter_table", "groupby_aggregate", "head", "io",
           "join_tables", "join_tables_multi", "local_sort_table", "obs",
           "pipelined_join", "pipelined_scan_join", "pipelined_set_op",
           "read_pandas", "repad_table", "repartition", "set_log_level",
           "set_operation", "shuffle_table", "slice_table", "sort_table",
           "stream", "tail", "unique_table"]
