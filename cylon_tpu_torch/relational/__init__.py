from .groupby import groupby_aggregate
from .join import join_tables, join_tables_multi
from .repart import (concat_tables, filter_table, head, repad_table,
                     repartition, shuffle_table, slice_table, tail)
from .setops import equals, set_operation, unique_table
from .sort import sort_table

__all__ = ["concat_tables", "equals", "filter_table", "groupby_aggregate",
           "head", "join_tables", "join_tables_multi", "repad_table",
           "repartition", "set_operation", "shuffle_table", "slice_table",
           "sort_table", "tail", "unique_table"]
