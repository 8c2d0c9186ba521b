from . import checkpoint  # noqa: F401  — durable checkpoints and resume
from . import memory  # noqa: F401  — the ledger and the spill tiers
from . import preempt  # noqa: F401  — SIGTERM as a planned drain
from . import recovery  # noqa: F401  — classification and the retry ladder
from .pipeline import (GroupBySink, chunk_table, pipelined_join,
                       pipelined_scan_join, pipelined_set_op)

__all__ = ["GroupBySink", "checkpoint", "chunk_table", "memory",
           "pipelined_join", "pipelined_scan_join", "pipelined_set_op",
           "preempt", "recovery"]
