from . import memory  # noqa: F401  — the ledger and the spill tiers
from . import recovery  # noqa: F401  — classification and the retry ladder
from .pipeline import (GroupBySink, chunk_table, pipelined_join,
                       pipelined_scan_join, pipelined_set_op)

__all__ = ["GroupBySink", "chunk_table", "pipelined_join",
           "pipelined_scan_join", "pipelined_set_op", "memory", "recovery"]
