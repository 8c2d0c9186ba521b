from .pipeline import GroupBySink, pipelined_join

__all__ = ["GroupBySink", "pipelined_join"]
