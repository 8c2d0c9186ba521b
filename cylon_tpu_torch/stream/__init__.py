"""Streaming ingest (port of ``cylon_tpu/stream``): append-only tables,
incremental views, and event-time windowed joins with an agreed
watermark.

* :class:`~cylon_tpu_torch.stream.table.StreamTable`: an append-only
  distributed table; each micro-batch hash-shuffles on arrival (the
  exchange's receive labelled ``stream.recv``), is admitted through the
  serving scheduler and kept as one more chunk;
* :class:`~cylon_tpu_torch.stream.view.IncrementalView`: a groupby-
  aggregate kept by a long-lived ``GroupBySink``; ``read()`` is a
  consistent snapshot, bit-equal to a from-scratch groupby over every row
  seen when the partial sums are exact; with checkpoints armed each
  absorbed partial commits and a killed ingest resumes by
  fast-forwarding the committed batches;
* :class:`~cylon_tpu_torch.stream.window.TumblingWindowJoin`: event-time
  tumbling windows closed under the agreed watermark
  (``exec/recovery.watermark_consensus``), joined to a slowly-changing
  small build side, their buffers retired through the spill tier
  (``exec/memory.evict_release``).

Drive it on the host with ``CylonEnv(VirtualMeshConfig(W), device=
"cpu")``; the default env is the card.
"""

from .table import StreamTable
from .view import IncrementalView
from .window import TumblingWindowJoin

__all__ = ["IncrementalView", "StreamTable", "TumblingWindowJoin"]
