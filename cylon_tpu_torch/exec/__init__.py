from .pipeline import (GroupBySink, chunk_table, pipelined_join,
                       pipelined_scan_join, pipelined_set_op)

__all__ = ["GroupBySink", "chunk_table", "pipelined_join",
           "pipelined_scan_join", "pipelined_set_op"]
