"""cylon_tpu_torch: the PyTorch/CUDA port of cylon_tpu for one NVIDIA H100.

The port mirrors ``cylon_tpu``'s module layout and is held bit-equal to it
by the ``tests/test_torch_*.py`` parity tests.  This slice runs the
BASELINE path at world size 1: ``Table.from_pydict`` ingest, an inner
``join_tables`` that defers its output, and ``groupby_aggregate`` through
the fused join→groupby pushdown, whose run-start gather is the
hand-written CUDA kernel ``kernels/windowed_gather.cu``.

The package imports torch and numpy only; pandas is touched only by
``Table.from_pandas`` / ``to_pandas`` when the caller uses them.
"""

from .core.column import Column
from .core.dtypes import LogicalType
from .core.table import DeferredTable, Table
from .ctx.context import CylonEnv, LocalConfig
from .relational.groupby import groupby_aggregate
from .relational.join import join_tables
from .status import CylonError, DeviceUnavailableError, InvalidError, KernelError

__all__ = ["Column", "CylonEnv", "CylonError", "DeferredTable",
           "DeviceUnavailableError", "InvalidError", "KernelError",
           "LocalConfig", "LogicalType", "Table", "groupby_aggregate",
           "join_tables"]
