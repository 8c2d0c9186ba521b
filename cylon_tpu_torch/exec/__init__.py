from . import checkpoint  # noqa: F401  — durable checkpoints and resume
from . import compiler  # noqa: F401  — the kernel builds' lifecycle
from . import fleet  # noqa: F401  — the elastic resize of a serving fleet
from . import integrity  # noqa: F401  — the data-integrity audit tier
from . import memory  # noqa: F401  — the ledger and the spill tiers
from . import preempt  # noqa: F401  — SIGTERM as a planned drain
from . import recovery  # noqa: F401  — classification and the retry ladder
from . import scheduler  # noqa: F401  — the multi-tenant serving tier
from .pipeline import (GroupBySink, chunk_table, pipelined_join,
                       pipelined_scan_join, pipelined_set_op)
from .scheduler import QueryScheduler
from .session import QuerySession

__all__ = ["GroupBySink", "QueryScheduler", "QuerySession", "checkpoint",
           "chunk_table", "compiler", "fleet", "integrity", "memory",
           "pipelined_join", "pipelined_scan_join", "pipelined_set_op",
           "preempt", "recovery", "scheduler"]
