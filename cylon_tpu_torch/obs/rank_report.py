"""Per-rank phase report: min / median / max of each phase (port of
``cylon_tpu/obs/rank_report.py``).

Armed (``CYLON_TPU_TORCH_RANK_REPORT=1`` or :func:`arm`), a caller builds
at the end of a run, per phase of the utils/timing table::

    {"min_s": ..., "median_s": ..., "max_s": ..., "skew": max/median}

Single-controller form: one process drives every rank and keeps one
phase table, so the report reduces over one rank (min = median = max).
The allgather of every process's table waits for the multi-card
transport.  Unarmed, nothing runs: the caller checks :func:`armed`.
"""

from __future__ import annotations

import os

__all__ = ["arm", "armed", "report"]

_ARMED: list = [False]


def arm(on: bool = True) -> None:
    _ARMED[0] = bool(on)


def armed() -> bool:
    return _ARMED[0] or os.environ.get("CYLON_TPU_TORCH_RANK_REPORT") == "1"


def _local_phases() -> dict[str, float]:
    from ..utils import timing
    return {k: float(v) for k, v in timing.snapshot().items()}


def report() -> dict:
    """The report now (the caller decides when the run ended)."""
    import numpy as np

    local = _local_phases()
    names = sorted(local)
    table = np.asarray([local[n] for n in names], np.float64).reshape(1, -1)
    phases = {}
    for i, n in enumerate(names):
        col = table[:, i]
        med = float(np.median(col))
        phases[n] = {
            "min_s": round(float(col.min()), 4),
            "median_s": round(med, 4),
            "max_s": round(float(col.max()), 4),
            "skew": round(float(col.max()) / med, 3) if med > 0 else None,
        }
    return {"ranks": int(table.shape[0]), "phases": phases}
