"""File IO (port of ``cylon_tpu/io``): CSV, Parquet and JSON readers and
writers, single and distributed, and the streaming Parquet scan."""

from .io import (ParquetScanSource, read_csv, read_csv_dist, read_json,
                 read_parquet, read_parquet_dist, scan_parquet_dist,
                 write_csv, write_csv_dist, write_json, write_json_dist,
                 write_parquet, write_parquet_dist)

__all__ = ["ParquetScanSource", "read_csv", "read_csv_dist", "read_json",
           "read_parquet", "read_parquet_dist", "scan_parquet_dist",
           "write_csv", "write_csv_dist", "write_json", "write_json_dist",
           "write_parquet", "write_parquet_dist"]
