from .groupby import groupby_aggregate
from .join import join_tables

__all__ = ["groupby_aggregate", "join_tables"]
