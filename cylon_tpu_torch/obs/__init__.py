"""Observability of cylon_tpu_torch (port of ``cylon_tpu/obs``).

* :mod:`.metrics`: the typed registry (counters, gauges, histograms)
  behind every counter of the package, Prometheus text and JSON
  snapshots (``CYLON_TPU_TORCH_METRICS_JSON``), and :func:`bench_detail`.
* :mod:`.trace`: the flight recorder, a bounded ring of spans and
  instants exported as Chrome-trace JSON (``CYLON_TPU_TORCH_TRACE``),
  with a post-mortem dump on drains, abort flushes and injected kills.
* :mod:`.plan`: EXPLAIN / EXPLAIN ANALYZE: every distributed operator
  opens a typed plan node; :func:`explain_analyze` adds per-node rows,
  bytes, self seconds reconciled with the phase table, and heavy-hitter
  key profiles (:mod:`.sketch`).
* :mod:`.comm`: the exchange's per-(src, dst) matrix
  (``CYLON_TPU_TORCH_COMM_MATRIX=1``).
* :mod:`.rank_report`: the per-rank phase report
  (``CYLON_TPU_TORCH_RANK_REPORT=1``).

With nothing armed the package pays one list load per timed region and
per exchange, and writes no file.
"""

from . import comm, metrics, plan, rank_report, sketch, trace  # noqa: F401
from .metrics import (bench_detail, counter, gauge,  # noqa: F401
                      histogram, maybe_write_snapshot, prometheus_text,
                      snapshot, write_prometheus, write_snapshot)
from .plan import explain, explain_analyze  # noqa: F401
