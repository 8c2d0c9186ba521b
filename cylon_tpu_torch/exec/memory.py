"""Device-memory ledger (port of the ledger part of
``cylon_tpu/exec/memory.py``).

Every long-lived resident allocation of the pipelined join — each
:class:`~cylon_tpu_torch.relational.piece.PieceSource`'s packed lane matrix
and f64 side arrays, each ``GroupBySink`` partial — registers its byte
count under a deterministic owner name ``base#<n>``.  Admission of a new
packed source (:func:`ensure_headroom`) checks the ledger's balance plus
the new bytes plus the piece join's transient sort operands against the
budget: the card's total memory, or no limit on the CPU.

The reference answers pressure by evicting the coldest spillable owners to
host memory.  The port has no spill tier yet (ROADMAP.md Queue 1,
slice 11): an admission over the budget raises ``NotImplementedError``
naming that slice.
"""

from __future__ import annotations

import threading
import weakref

import torch


class Registration:
    """One resident allocation's ledger entry."""

    __slots__ = ("owner", "nbytes", "live", "__weakref__")

    def __init__(self, owner: str, nbytes: int):
        self.owner = owner
        self.nbytes = int(nbytes)
        self.live = True


class Ledger:
    """Owner-named byte accounting for resident device allocations."""

    def __init__(self):
        self._live: dict[str, Registration] = {}
        self._lock = threading.RLock()
        self._names = 0
        self._bytes = 0
        #: the largest balance since the last reset_stats()
        self.peak = 0

    def balance(self) -> int:
        return self._bytes

    def register(self, base: str, arrays, anchor=None) -> Registration:
        """Register ``arrays``' bytes under ``base#<n>``; ``anchor``:
        release automatically when this object is collected."""
        nbytes = sum(int(a.numel()) * int(a.element_size()) for a in arrays
                     if a is not None)
        with self._lock:
            self._names += 1
            reg = Registration(f"{base}#{self._names}", nbytes)
            self._live[reg.owner] = reg
            self._bytes += reg.nbytes
            self.peak = max(self.peak, self._bytes)
        if anchor is not None:
            try:
                weakref.finalize(anchor, self.release, reg)
            except TypeError:
                pass  # not weakrefable: the caller releases explicitly
        return reg

    def release(self, reg: Registration | None) -> None:
        """Drop a registration (idempotent)."""
        if reg is None:
            return
        with self._lock:
            if not reg.live:
                return
            reg.live = False
            self._live.pop(reg.owner, None)
            self._bytes -= reg.nbytes


_LEDGER = Ledger()


def ledger() -> Ledger:
    return _LEDGER


def reset_stats() -> None:
    """Restart the peak from the current balance."""
    _LEDGER.peak = _LEDGER.balance()


def register(base: str, arrays, anchor=None) -> Registration:
    return _LEDGER.register(base, arrays, anchor=anchor)


def register_table(base: str, table, anchor=None) -> Registration | None:
    """Account a materialized Table's columns (data + validity) under one
    owner, released when ``anchor`` (default: the table) is collected.  An
    unmaterialized DeferredTable is skipped: reading its columns here would
    defeat the fused pushdown it exists for."""
    from ..core.table import DeferredTable
    if isinstance(table, DeferredTable) and not table.materialized:
        return None
    return _LEDGER.register(base, _table_arrays(table),
                            anchor=table if anchor is None else anchor)


def _table_arrays(table) -> list:
    return [a for c in table.columns.values() for a in (c.data, c.validity)
            if a is not None]


def table_nbytes(table) -> int:
    """Device bytes of a materialized Table's columns (data + validity)."""
    return sum(int(a.numel()) * int(a.element_size())
               for a in _table_arrays(table))


def release(reg) -> None:
    _LEDGER.release(reg)


def balance() -> int:
    return _LEDGER.balance()


def budget_bytes(env) -> int:
    """The ledger's budget for ``env``'s device: the card's total memory,
    or 0 (no limit) on the CPU."""
    if env.on_cuda:
        return int(torch.cuda.get_device_properties(env.device).total_memory)
    return 0


def ensure_headroom(env, need: int, scratch: int = 0) -> None:
    """Admission for a new resident allocation of ``need`` bytes plus
    ``scratch`` transient bytes (the piece join's sort operands,
    :func:`cylon_tpu_torch.ops.pack.sort_operand_nbytes`).  Over the
    budget this raises ``NotImplementedError``: where the reference would
    evict cold owners to host memory, the port has no spill tier yet
    (slice 11)."""
    need = int(need) + int(scratch)
    b = budget_bytes(env)
    if b > 0 and _LEDGER.balance() + need > b:
        raise NotImplementedError(
            f"admitting {need} bytes over a {b}-byte device budget "
            f"(ledger balance {_LEDGER.balance()}) needs the host spill "
            "tier, slice 11 of ROADMAP.md Queue 1")


def spec_row_bytes(spec) -> int:
    """Resident bytes per row of a packed source: 4 per 32-bit lane plus 8
    per laneless f64 side column (ops/lanes.py layout)."""
    n_f64 = sum(1 for c in spec.cols if not c.lanes)
    return 4 * int(spec.n_lanes) + 8 * n_f64
