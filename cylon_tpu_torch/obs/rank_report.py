"""Per-rank phase report: min / median / max of each phase (port of
``cylon_tpu/obs/rank_report.py``).

Armed (``CYLON_TPU_TORCH_RANK_REPORT=1`` or :func:`arm`), a caller builds
at the end of a run, per phase of the utils/timing table::

    {"min_s": ..., "median_s": ..., "max_s": ..., "skew": max/median}

One process driving every rank keeps one phase table, so its report
reduces over one rank (min = median = max).  In a multi-process world
(ctx/context.DistributedConfig) every process's table is allgathered,
one row per process, after a check that every process timed the same
phase names (``RankDesyncError`` otherwise,
``cylon_tpu/obs/rank_report.py:50``).  Unarmed, nothing runs: the
caller checks :func:`armed`.
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
    from ..parallel import transport
    proc = transport.current()
    if proc is not None and proc.nproc > 1:
        import zlib
        from ..status import RankDesyncError
        crc = np.float64(zlib.crc32("|".join(names).encode()))
        sig = transport.allgather_array(np.asarray([crc]), "obs.rank_report")
        if len({float(r[0]) for r in sig}) != 1:
            raise RankDesyncError(
                "per-rank phase report: phase-name sets differ across "
                "ranks — the ranks timed different programs",
                site="obs.rank_report")
        table = transport.allgather_array(table[0], "obs.rank_report")
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
