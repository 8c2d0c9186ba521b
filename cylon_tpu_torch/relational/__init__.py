from .groupby import groupby_aggregate
from .join import join_tables, join_tables_multi
from .repart import filter_table

__all__ = ["filter_table", "groupby_aggregate", "join_tables",
           "join_tables_multi"]
