"""Device-memory ledger, host spill tier and disk tier (port of
``cylon_tpu/exec/memory.py``).

1. **The ledger** (:class:`Ledger`): every long-lived resident allocation
   of the pipelined join — each :class:`~cylon_tpu_torch.relational.piece.
   PieceSource`'s packed lane matrix and f64 side arrays, each
   ``GroupBySink`` partial, each scan batch — registers its bytes under a
   deterministic owner name ``base#<n>``, against a budget: ``CYLON_TPU_
   TORCH_HBM_BUDGET`` when set, else one card's total memory (every rank
   of a ``VirtualMeshConfig`` world lives on that card), else no limit on
   the CPU.

2. **The host spill tier**: an admission over the budget
   (:func:`ensure_headroom`) evicts the coldest spillable owners — LRU by
   last piece-loop access (:func:`touch`) — to host memory: each array
   is copied whole into one pinned host tensor, allocated at the
   registration's first eviction and reused after, whose W row blocks are
   the shards (``utils/host.host_shard_blocks``).  A host-resident
   ``PieceSource`` uploads only the current piece's window
   (:func:`upload_window`), on a side stream, so the pipelined join's
   upload of piece r+1 overlaps piece r's compute.  Round trips are
   bit-exact: raw 32- and 64-bit words move unchanged.

3. **The disk tier**: past a host budget (``CYLON_TPU_TORCH_HOST_BUDGET``)
   the coldest host pages demote to spill files under
   ``CYLON_TPU_TORCH_SPILL_DIR`` — one ``.spill.npy`` page per array and
   shard, sha256 over its content, written under the bounded IO retry.
   The first window access after a demotion verifies every page once
   (a mismatch, a torn page: ``CheckpointCorruptError`` at ``disk.read``,
   the owner retired, the ladder recomputes); windows then read straight
   off memory-mapped pages.  A write that fails (ENOSPC, an exhausted
   retry) keeps the page in host memory, recorded as a recovery event.
   With no host budget the disk tier touches no file.

4. **The ladder's spill rung** (:func:`spill_for_retry`): a predicted
   OOM first evicts every spillable owner and retries at the same
   configuration (exec/recovery.run_with_recovery).

Eviction and demotion counts go through ``recovery.count_consensus``
as in the reference; one process drives every rank, so the count is the
local one.  Each registration carries the serving session whose turn
made it (exec/scheduler.py); an eviction under another session's
pressure, or the scheduler's own admission pass, counts as a
``cross_session_evictions``.  Operators reach the admission and the
eviction through the scheduler's facades (``admit_allocation``,
``free_pressure``, ``spill_retry``).  Not ported: the reference's
``reuse`` admission credit for buffers donated into the allocating
program (the port donates nothing).

5. **Window lifetime** (the streaming tier, ``cylon_tpu_torch/stream``):
   an open event-time window's buffers are spillable registrations
   (:func:`register_window`), evicted like any cold owner under
   pressure; the watermark close retires them through
   :func:`evict_release` (device → host → released).
:func:`put_blocks` is the durable checkpoint restore's upload
(exec/checkpoint.py), through the same window copy.

Injector sites: ``spill.evict`` (``predicted`` simulates pressure and
evicts one owner; ``stall``/``spill_stall`` hang the eviction's pull),
``spill.upload``, ``disk.write`` (``corrupt``, ``stall``, ``enospc``)
and ``disk.read`` (``corrupt``, ``stall``).
"""

from __future__ import annotations

import contextlib
import errno
import hashlib
import os
import re
import threading
import weakref

import numpy as np
import torch

from .. import config
from ..status import CheckpointCorruptError
from ..utils import timing

#: injected kinds at the spill sites that raise as faults (the others
#: steer the spill machinery)
_RAISE_KINDS = ("device_oom", "capacity", "desync")


def _nbytes(arrays) -> int:
    return sum(int(a.numel()) * int(a.element_size()) for a in arrays
               if a is not None)


def _session_tag() -> str | None:
    """The serving session tagged on this thread (exec/recovery holds the
    tag the scheduler sets), or None outside one."""
    from . import recovery
    return recovery.current_session()


class Registration:
    """One resident allocation's ledger entry, and a spillable owner's
    handle to its arrays: ``arrays`` while on the device, ``host`` (per
    array, a list of W per-shard host blocks) while host-resident, ``disk``
    (per array, per shard a ``{"path", "sha", "nbytes"}`` page) while on
    disk.  ``disk_ok`` records the one verification per demotion and
    ``disk_views`` the memory-mapped pages after it; ``pinned`` holds the
    host tensors an eviction copies into, kept for the next one.
    ``session`` is the serving session whose turn registered it."""

    __slots__ = ("owner", "nbytes", "spillable", "seq", "arrays", "host",
                 "disk", "disk_ok", "disk_views", "pinned", "world",
                 "device", "live", "session", "__weakref__")

    def __init__(self, owner: str, arrays, spillable: bool, world: int,
                 seq: int):
        self.owner = owner
        self.nbytes = _nbytes(arrays)
        self.spillable = bool(spillable)
        self.session = _session_tag()
        # only a spillable entry holds its arrays: a bookkeeping entry
        # holding them would keep its own anchor alive
        self.arrays = tuple(arrays) if spillable else ()
        self.device = next((a.device for a in arrays if a is not None),
                           None)
        self.world = int(world)
        self.seq = seq
        self.host: tuple | None = None
        self.disk: tuple | None = None
        self.disk_ok = False
        self.disk_views: tuple | None = None
        self.pinned: tuple | None = None
        self.live = True

    @property
    def spilled(self) -> bool:
        """Off the device: host-resident or on disk."""
        return self.host is not None or self.disk is not None

    @property
    def on_disk(self) -> bool:
        return self.disk is not None


class Ledger:
    """Owner-named byte accounting for resident device allocations, with
    LRU eviction of spillable entries to host memory and LRU demotion of
    host pages to disk.  Every transition is a function of the
    registration and access sequence alone."""

    def __init__(self):
        self._live: dict[str, Registration] = {}
        self._lock = threading.RLock()
        self._seq = 0
        self._names = 0
        #: the largest balance since the last reset_stats()
        self.peak = 0

    # -- accounting --------------------------------------------------------
    def balance(self) -> int:
        with self._lock:
            return sum(r.nbytes for r in self._live.values()
                       if not r.spilled)

    def spillable_bytes(self) -> int:
        with self._lock:
            return sum(r.nbytes for r in self._live.values()
                       if r.spillable and not r.spilled)

    def host_balance(self) -> int:
        """Bytes of live registrations in host memory (not on disk): the
        disk tier's budget predicate."""
        with self._lock:
            return sum(r.nbytes for r in self._live.values()
                       if r.host is not None)

    # -- registration lifecycle --------------------------------------------
    def register(self, base: str, arrays, spillable: bool = False,
                 world: int = 1, anchor=None) -> Registration:
        """Register ``arrays``' bytes under ``base#<n>``; ``world``: the
        number of row-block shards of each array; ``anchor``: release
        automatically when this object is collected."""
        with self._lock:
            self._names += 1
            self._seq += 1
            reg = Registration(f"{base}#{self._names}", arrays, spillable,
                               world, self._seq)
            self._live[reg.owner] = reg
            self.peak = max(self.peak, self.balance())
        if anchor is not None:
            try:
                weakref.finalize(anchor, self.release, reg)
            except TypeError:
                pass  # not weakrefable: the caller releases explicitly
        return reg

    def touch(self, reg: Registration | None) -> None:
        """LRU bump: a piece-loop access of this registration."""
        if reg is None or not reg.live:
            return
        with self._lock:
            self._seq += 1
            reg.seq = self._seq

    def release(self, reg: Registration | None) -> None:
        """Drop a registration (idempotent): its device, host and disk
        copies go (spill files deleted best-effort)."""
        if reg is None or not reg.live:
            return
        with self._lock:
            reg.live = False
            self._live.pop(reg.owner, None)
            reg.arrays = ()
            reg.host = None
            reg.pinned = None
            disk, reg.disk = reg.disk, None
            reg.disk_ok = False
            reg.disk_views = None
        if disk is not None:
            _remove_disk_pages(disk)

    # -- host spill tier ---------------------------------------------------
    def evict(self, reg: Registration, stall: bool = False) -> int:
        """Copy one spillable registration's arrays to host memory, per
        shard, under the exchange watchdog, and drop the device references.
        Returns the bytes freed (0 when not evictable)."""
        if not (reg.live and reg.spillable and not reg.spilled
                and reg.arrays):
            return 0
        from . import recovery
        from ..utils.host import host_shard_blocks
        devs, w = list(reg.arrays), reg.world
        if reg.pinned is None:
            reg.pinned = tuple(
                torch.empty(a.shape, dtype=a.dtype, pin_memory=a.is_cuda)
                for a in devs)
        elif reg.device is not None and reg.device.type == "cuda":
            # the reused host tensors may still feed an earlier cycle's
            # window uploads on the side stream
            torch.cuda.synchronize(reg.device)
        bufs = reg.pinned
        with timing.region("spill.evict"):
            host = recovery.exchange_watchdog(
                "spill.evict",
                lambda: tuple(host_shard_blocks(a, w, out=b)
                              for a, b in zip(devs, bufs)),
                timeout_s=_stall_timeout(stall), stalled=stall)
        del devs
        with self._lock:
            reg.host = host
            reg.arrays = ()
        _note_spill("spill.evict", reg)
        return reg.nbytes

    def readmit(self, reg: Registration, stall: bool = False) -> tuple:
        """Upload a spilled registration's whole arrays back to the device
        and return them (a disk-resident one is promoted to host first).
        With ``CYLON_TPU_TORCH_WATCHDOG_S`` set the upload is waited on
        under the watchdog (site ``spill.upload``)."""
        if not (reg.live and reg.spilled):
            return reg.arrays
        if reg.host is None:
            self.promote_host(reg, stall=stall)
        arrs = _upload(list(reg.host), reg.device, stall=stall)
        if (config.EXCHANGE_WATCHDOG_S > 0 and not stall
                and reg.device.type == "cuda"):
            from . import recovery
            recovery.exchange_watchdog(
                "spill.upload", lambda: torch.cuda.synchronize(reg.device),
                stalled=False)
        with self._lock:
            reg.arrays = tuple(arrs)
            reg.host = None
            self._seq += 1
            reg.seq = self._seq
            self.peak = max(self.peak, self.balance())
        _STATS["readmit_events"] += 1
        _STATS["bytes_readmitted"] += reg.nbytes
        timing.add_bytes("spill.upload", reg.nbytes)
        return reg.arrays

    # -- disk tier ---------------------------------------------------------
    def demote(self, reg: Registration, stall: bool = False) -> int:
        """Write one host-resident registration's pages to spill files
        (one ``.spill.npy`` per array and shard, sha256 recorded in
        memory) and drop the host copy.  Returns the bytes moved off host
        memory.  A write that still fails after the IO retry keeps the
        registration in host memory (a ``disk.write`` recovery event,
        partial pages deleted); an injected ``stall`` raises through the
        watchdog; ``corrupt`` flips a byte after hashing."""
        if not (reg.live and reg.host is not None):
            return 0
        from . import recovery
        kind = recovery.maybe_inject(
            "disk.write", intercept=("corrupt", "stall", "enospc"))
        root = _rank_spill_dir()
        safe = _safe_owner(reg.owner)
        written: list[str] = []
        first = [True]

        def write_all():
            out = []
            for j, blocks in enumerate(reg.host):
                per = []
                for k, blk in enumerate(blocks):
                    if blk is None:     # another process's shard
                        per.append(None)
                        continue
                    path = os.path.join(root, f"{safe}.a{j}.s{k}.spill.npy")
                    if kind == "enospc" and first[0]:
                        raise OSError(errno.ENOSPC,
                                      "injected ENOSPC mid-demote")
                    arr = blk.numpy()
                    sha = _sha_arr(arr)
                    recovery.retry_io(lambda p=path, b=arr: np.save(p, b),
                                      "disk.write", on_retry=_note_retry)
                    written.append(path)
                    if kind == "corrupt" and first[0]:
                        _flip_last_byte(path)
                    first[0] = False
                    per.append({"path": path, "sha": sha,
                                "nbytes": int(arr.nbytes)})
                out.append(tuple(per))
            return tuple(out)

        try:
            with timing.region("disk.write"):
                if stall or kind == "stall":
                    meta = recovery.exchange_watchdog(
                        "disk.write", write_all,
                        timeout_s=_stall_timeout(True), stalled=True)
                else:
                    meta = write_all()
        except OSError as e:
            _remove_paths(written)
            _DSTATS["write_degrades"] += 1
            recovery._record("disk.write",
                             "enospc" if e.errno == errno.ENOSPC
                             else "os_error", "degrade_in_memory")
            from ..utils.logging import log
            log.warning("memory: demotion of %s to disk failed (%s); its "
                        "pages stay in host memory", reg.owner, e)
            return 0
        except BaseException:
            _remove_paths(list(written))
            raise
        with self._lock:
            reg.disk = meta
            reg.host = None
            reg.disk_ok = False
            reg.disk_views = None
        moved = sum(e["nbytes"] for per in meta for e in per)
        _DSTATS["events"] += 1
        _DSTATS["bytes_demoted"] += moved
        _DSTATS["pages_demoted"] += sum(len(per) for per in meta)
        _DEMOTION_LOG.append(reg.owner)
        timing.add_bytes("disk.write", moved)
        timing.bump("memory.disk.demote")
        return moved

    def verify_disk(self, reg: Registration, stall: bool = False) -> None:
        """Check every page of a disk-resident registration against its
        sha256 once per demotion (one page in memory at a time).  A
        mismatch, a torn page or an injected ``corrupt`` at ``disk.read``
        retires the owner and raises ``CheckpointCorruptError``."""
        if reg.disk is None or reg.disk_ok:
            return
        from . import recovery
        kind = recovery.maybe_inject("disk.read",
                                     intercept=("corrupt", "stall"))

        def check():
            if kind == "corrupt":
                raise CheckpointCorruptError(
                    "injected spill-page corruption on promote",
                    site="disk.read")
            for per in reg.disk:
                for ent in per:
                    if ent is None:
                        continue
                    if _sha_arr(_read_page(ent["path"])) != ent["sha"]:
                        raise CheckpointCorruptError(
                            f"spill page {ent['path']} failed its "
                            "content-hash check (torn write or on-disk "
                            "corruption)", site="disk.read")

        try:
            with timing.region("disk.read"):
                if stall or kind == "stall":
                    recovery.exchange_watchdog(
                        "disk.read", check,
                        timeout_s=_stall_timeout(True), stalled=True)
                else:
                    check()
        except CheckpointCorruptError:
            _DSTATS["corrupt_degrades"] += 1
            recovery._record("disk.read", "corrupt", "recompute_owner")
            self.release(reg)
            raise
        reg.disk_ok = True

    def promote_host(self, reg: Registration, stall: bool = False) -> None:
        """Read every verified page back into host blocks and delete the
        spill files."""
        if reg.disk is None:
            return
        self.verify_disk(reg, stall=stall)
        moved = 0
        with timing.region("disk.read"):
            hosts = []
            for per in reg.disk:
                blocks = []
                for ent in per:
                    if ent is None:
                        blocks.append(None)
                        continue
                    arr = _read_page(ent["path"])
                    blocks.append(torch.from_numpy(arr))
                    moved += int(arr.nbytes)
                    _DSTATS["pages_promoted"] += 1
                hosts.append(blocks)
        with self._lock:
            disk, reg.disk = reg.disk, None
            reg.host = tuple(hosts)
            reg.disk_ok = False
            reg.disk_views = None
        _remove_disk_pages(disk)
        _DSTATS["events"] += 1
        _DSTATS["bytes_promoted"] += moved
        timing.add_bytes("disk.read", moved)
        timing.bump("memory.disk.promote")

    def _demote_cands(self) -> list[Registration]:
        """Host-resident entries, oldest access first."""
        with self._lock:
            return sorted((r for r in self._live.values()
                           if r.host is not None), key=lambda r: r.seq)

    def demote_count_for(self, budget: int) -> int:
        """How many LRU demotions bring the host balance under
        ``budget``."""
        if budget <= 0:
            return 0
        bal = self.host_balance()
        if bal <= budget:
            return 0
        n = 0
        for r in self._demote_cands():
            n += 1
            bal -= r.nbytes
            if bal <= budget:
                break
        return n

    def demote_n(self, n: int) -> list[str]:
        """Demote the ``n`` oldest host-resident entries; the demoted
        owners in order."""
        out: list[str] = []
        for reg in self._demote_cands()[:max(int(n), 0)]:
            if self.demote(reg):
                out.append(reg.owner)
        return out

    def _spill_cands(self) -> list[Registration]:
        """Spillable, device-resident entries, oldest access first."""
        with self._lock:
            return sorted((r for r in self._live.values()
                           if r.spillable and not r.spilled),
                          key=lambda r: r.seq)

    def evict_count_for(self, need: int, budget: int) -> int:
        """How many LRU evictions bring ``balance + need`` under the
        budget (0 when it fits or there is no budget; every candidate
        when even that is not enough)."""
        if budget <= 0:
            return 0
        bal = self.balance()
        if bal + need <= budget:
            return 0
        n = 0
        for r in self._spill_cands():
            n += 1
            bal -= r.nbytes
            if bal + need <= budget:
                break
        return n

    def evict_n(self, n: int, stall: bool = False) -> list[str]:
        """Evict the ``n`` oldest spillable entries; the evicted owners in
        order."""
        evicted: list[str] = []
        for reg in self._spill_cands()[:max(int(n), 0)]:
            if self.evict(reg, stall=stall):
                evicted.append(reg.owner)
        return evicted

    def evict_until(self, need: int, budget: int,
                    stall: bool = False) -> list[str]:
        """Evict LRU owners until ``balance + need`` fits ``budget``."""
        return self.evict_n(self.evict_count_for(need, budget),
                            stall=stall)


_LEDGER = Ledger()


def ledger() -> Ledger:
    return _LEDGER


# ---------------------------------------------------------------------------
# the module's surface
# ---------------------------------------------------------------------------

def budget_bytes(env) -> int:
    """The ledger's device budget for ``env``: ``CYLON_TPU_TORCH_HBM_
    BUDGET`` when set, else the card's total memory, else 0 (no limit) on
    the CPU."""
    if config.HBM_BUDGET_BYTES > 0:
        return config.HBM_BUDGET_BYTES
    if env.on_cuda:
        return int(torch.cuda.get_device_properties(env.device).total_memory)
    return 0


def register(base: str, arrays, spillable: bool = False, world: int = 1,
             anchor=None) -> Registration:
    return _LEDGER.register(base, arrays, spillable=spillable, world=world,
                            anchor=anchor)


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
    return _nbytes(_table_arrays(table))


def release(reg) -> None:
    _LEDGER.release(reg)


def touch(reg) -> None:
    _LEDGER.touch(reg)


def device_arrays(reg: Registration) -> tuple | None:
    """The registration's device arrays, or None while spilled."""
    return reg.arrays if not reg.spilled else None


def evict(reg) -> int:
    return _LEDGER.evict(reg)


def readmit(reg) -> tuple:
    return _LEDGER.readmit(reg)


def demote(reg) -> int:
    return _LEDGER.demote(reg)


def promote_host(reg) -> None:
    _LEDGER.promote_host(reg)


def balance() -> int:
    return _LEDGER.balance()


def spillable_bytes() -> int:
    return _LEDGER.spillable_bytes()


def host_balance() -> int:
    return _LEDGER.host_balance()


def over_budget(env, need: int) -> bool:
    """Would ``need`` more resident bytes exceed ``env``'s budget?"""
    b = budget_bytes(env)
    return b > 0 and _LEDGER.balance() + int(need) > b


def try_free(env, need: int) -> int:
    """Evict LRU owners until ``need`` more bytes fit (the exchange
    guard's call, parallel/shuffle.py); the bytes freed."""
    if not config.SPILL_ENABLED:
        return 0
    before = _LEDGER.balance()
    _LEDGER.evict_until(int(need), budget_bytes(env))
    return before - _LEDGER.balance()


def ensure_headroom(env, need: int, scratch: int = 0,
                    site: str = "spill.evict") -> None:
    """Admission of a new resident allocation of ``need`` bytes plus
    ``scratch`` transient bytes (the piece join's sort operands,
    :func:`cylon_tpu_torch.ops.pack.sort_operand_nbytes`): over the
    budget, the coldest spillable owners evict to host memory, and past
    the host budget the coldest host pages demote to disk.  When nothing
    is left to evict the allocation goes ahead: a real OOM then reaches
    the retry ladder."""
    from . import recovery
    kind, armed = recovery.probe(site)
    if kind in _RAISE_KINDS:
        raise recovery.make_fault(kind, site)
    if not config.SPILL_ENABLED:
        return
    need = max(int(need) + int(scratch), 0)
    b = budget_bytes(env)
    if not (armed or b > 0):
        return
    want = _LEDGER.evict_count_for(need, b)
    if kind is not None and want == 0:
        want = 1  # injected pressure with no real deficit: evict one LRU
    want = recovery.count_consensus(env, want)
    if want > 0:
        evicted = _LEDGER.evict_n(want,
                                  stall=kind in ("stall", "spill_stall"))
        if evicted:
            from ..utils.logging import log
            log.info("memory: evicted %s to host under pressure (balance "
                     "%d B, budget %d B)", evicted, _LEDGER.balance(), b)
    _maybe_demote(env)


def spill_for_retry() -> int:
    """The ladder's spill rung: evict EVERY spillable resident owner (and
    demote past the host budget); the bytes freed."""
    if not config.SPILL_ENABLED:
        return 0
    freed = sum(_LEDGER.evict(reg) for reg in _LEDGER._spill_cands())
    if _disk_armed():
        _LEDGER.demote_n(_LEDGER.demote_count_for(config.HOST_BUDGET_BYTES))
    return freed


# ---------------------------------------------------------------------------
# window-lifetime residency (the streaming tier): an event-time window's
# buffers live from their first append to the watermark close
# ---------------------------------------------------------------------------

def register_window(base: str, arrays, world: int = 1,
                    anchor=None) -> Registration:
    """Register one window buffer's arrays (``world`` row-block shards
    each) as a SPILLABLE resident allocation: a window not yet closable
    is an LRU eviction candidate like a cold packed source, and the
    close retires it through :func:`evict_release`."""
    return _LEDGER.register(base, arrays, spillable=True, world=world,
                            anchor=anchor)


def evict_release(reg: Registration | None) -> int:
    """The window close: device → host → released.  The buffers are first
    evicted through the spill tier (the same watchdogged pull as any
    eviction, one ``spill_events`` record), then the registration is
    released with its host copy, so the balance drains by the window's
    full byte count.  A window that pressure already spilled goes
    straight to release.  Counts ``window_evictions`` and the
    ``stream.window_evicted`` event; returns the bytes retired."""
    if reg is None or not reg.live:
        return 0
    nbytes = reg.nbytes
    if not reg.spilled:
        _LEDGER.evict(reg)
    _LEDGER.release(reg)
    _STATS["window_evictions"] += 1
    timing.bump("stream.window_evicted")
    return nbytes


def prefetch_depth(env, window_pair_bytes: int) -> int:
    """2 (upload piece r+1's windows while piece r computes) when the
    budget has room for a second window pair, else 1."""
    b = budget_bytes(env)
    if b <= 0 or _LEDGER.balance() + 2 * int(window_pair_bytes) <= b:
        return 2
    return 1


def spec_row_bytes(spec) -> int:
    """Resident bytes per row of a packed source: 4 per 32-bit lane plus 8
    per laneless f64 side column (ops/lanes.py layout)."""
    n_f64 = sum(1 for c in spec.cols if not c.lanes)
    return 4 * int(spec.n_lanes) + 8 * n_f64


# ---------------------------------------------------------------------------
# disk tier plumbing: the one place that names spill files
# ---------------------------------------------------------------------------

def _disk_armed() -> bool:
    return config.SPILL_ENABLED and config.HOST_BUDGET_BYTES > 0


_SPILL_ROOT: list[str] = []


def spill_root() -> str:
    """``CYLON_TPU_TORCH_SPILL_DIR``, else a private temporary directory
    made at the first demotion."""
    if config.SPILL_DIR:
        return config.SPILL_DIR
    if not _SPILL_ROOT:
        import tempfile
        _SPILL_ROOT.append(tempfile.mkdtemp(prefix="cylon_tpu_torch_spill_"))
    return _SPILL_ROOT[0]


_PURGED_DIRS: set = set()


def _rank_spill_dir() -> str:
    """This process's spill directory (one process: ``rank0``), made on
    demand.  Its first use purges the ``.spill.npy`` pages a killed
    predecessor left: pages live as long as their process, their hashes in
    its memory, so a fixed spill directory would otherwise fill up run
    after run."""
    import glob
    d = os.path.join(spill_root(), "rank0")
    os.makedirs(d, exist_ok=True)
    if d not in _PURGED_DIRS:
        _PURGED_DIRS.add(d)
        _remove_paths(glob.glob(os.path.join(d, "*.spill.npy")))
    return d


_SAFE_OWNER_RE = re.compile(r"[^A-Za-z0-9_.-]")


def _safe_owner(owner: str) -> str:
    return _SAFE_OWNER_RE.sub("_", owner)


def _sha_arr(a) -> str:
    """sha256 over an array's raw bytes."""
    return hashlib.sha256(np.ascontiguousarray(a).data).hexdigest()


def _flip_last_byte(path: str) -> None:
    """Corrupt a written page (injection): XOR its last byte, which is
    data, not the npy header."""
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


def _read_page(path: str):
    """One page as an array, under the IO retry.  A page still unreadable
    after it, or torn (``np.load`` raises ValueError or EOFError on a
    truncated page), raises ``CheckpointCorruptError``."""
    from . import recovery
    try:
        return recovery.retry_io(lambda: np.load(path), "disk.read",
                                 on_retry=_note_retry)
    except (OSError, ValueError, EOFError) as e:
        raise CheckpointCorruptError(
            f"spill page {path} unreadable or torn: {e}",
            site="disk.read") from e


def _mmap_page(path: str):
    """A verified page memory-mapped for window reads."""
    from . import recovery
    try:
        return recovery.retry_io(lambda: np.load(path, mmap_mode="r"),
                                 "disk.read", on_retry=_note_retry)
    except (OSError, ValueError, EOFError) as e:
        raise CheckpointCorruptError(
            f"spill page {path} unreadable or torn: {e}",
            site="disk.read") from e


def _remove_paths(paths) -> None:
    for p in paths:
        try:
            os.remove(p)
        except OSError:
            pass  # best effort: a leftover page is never read again


def _remove_disk_pages(disk) -> None:
    _remove_paths(e["path"] for per in disk for e in per if e is not None)


def _note_retry() -> None:
    _DSTATS["retries"] += 1


def _maybe_demote(env) -> None:
    """Past the host budget, demote the LRU host pages to disk."""
    if not _disk_armed():
        return
    from . import recovery
    want = recovery.count_consensus(
        env, _LEDGER.demote_count_for(config.HOST_BUDGET_BYTES))
    if want > 0:
        _LEDGER.demote_n(want)


# ---------------------------------------------------------------------------
# host -> device
# ---------------------------------------------------------------------------

def _stall_timeout(stall: bool) -> float | None:
    """A stalled transfer's watchdog deadline: the configured one, or a
    short one when a stall is injected with the watchdog off."""
    if stall:
        return config.EXCHANGE_WATCHDOG_S or 0.2
    return None


_SIDE_STREAMS: dict = {}


def _side_stream(device):
    """The device's upload stream (made at first use)."""
    s = _SIDE_STREAMS.get(device)
    if s is None:
        s = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return s


def _put_window(blocks, starts, window: int, device, stream):
    """Per-shard windows ``[starts[i], starts[i] + window)`` of host blocks
    into one ``(W·window, ...)`` device tensor, zeros past a block's end
    (the resident slice's padding).  On the card the copies and the
    zeroing run on ``stream``.  ``None`` blocks (another process's
    shards, utils/host.host_shard_blocks) are skipped: the tensor holds
    this process's windows."""
    keep = [i for i, b in enumerate(blocks) if b is not None]
    blocks = [blocks[i] for i in keep]
    starts = [starts[i] for i in keep]
    rest = tuple(blocks[0].shape[1:])
    w = len(blocks)
    dtype = blocks[0].dtype
    if not isinstance(dtype, torch.dtype):          # mapped numpy pages
        dtype = torch.from_numpy(np.empty(0, dtype)).dtype
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        out = torch.empty((w * window,) + rest, dtype=dtype, device=device)
        for i, blk in enumerate(blocks):
            s = int(starts[i])
            m = max(min(window, int(blk.shape[0]) - s), 0)
            dst = out[i * window:(i + 1) * window]
            if m > 0:
                src = blk[s:s + m]
                if isinstance(src, np.ndarray):       # a mapped page
                    src = torch.from_numpy(np.array(src))
                dst[:m].copy_(src, non_blocking=stream is not None)
            if m < window:
                dst[m:].zero_()
    return out


def _upload(hosts, device, stall: bool = False) -> tuple:
    """Per-array host shard blocks -> whole device arrays (readmit)."""
    from . import recovery
    kind = recovery.injected("spill.upload")
    if kind in _RAISE_KINDS:
        raise recovery.make_fault(kind, "spill.upload")
    stall = stall or kind in ("stall", "spill_stall")
    devs = tuple(_put_window(blocks, [0] * len(blocks),
                             int(next(b for b in blocks
                                      if b is not None).shape[0]),
                             device, None)
                 for blocks in hosts)
    if stall:
        recovery.exchange_watchdog("spill.upload", lambda: None,
                                   timeout_s=_stall_timeout(True),
                                   stalled=True)
    return devs


def put_blocks(blocks, device) -> torch.Tensor:
    """W host row blocks of one shape and dtype (numpy arrays or CPU
    tensors) -> one ``(W·rows, ...)`` tensor on ``device``: the
    checkpoint restore's upload boundary (exec/checkpoint.py), through the
    spill tier's window copy, so a restored piece is byte-identical to the
    tensor its pages were pulled from.  On the card the blocks are staged
    in one pinned host tensor and copied on the device's side stream, and
    the current stream waits on the copy's event; on the CPU it is a
    copy."""
    host = [torch.from_numpy(np.ascontiguousarray(b))
            if isinstance(b, np.ndarray) else b for b in blocks]
    w, rows = len(host), int(host[0].shape[0])
    device = torch.device(device)
    if device.type != "cuda":
        return _put_window(host, [0] * w, rows, device, None)
    staged = torch.empty((w * rows,) + tuple(host[0].shape[1:]),
                         dtype=host[0].dtype, pin_memory=True)
    for i, b in enumerate(host):
        staged[i * rows:(i + 1) * rows].copy_(b)
    consumer = torch.cuda.current_stream(device)
    stream = _side_stream(device)
    out = _put_window([staged[i * rows:(i + 1) * rows] for i in range(w)],
                      [0] * w, rows, device, stream)
    out.record_stream(consumer)
    consumer.wait_event(stream.record_event())
    return out


def upload_window(reg: Registration, starts, window: int):
    """Upload ONE per-shard window ``[starts[i], starts[i] + window)`` of a
    spilled registration's arrays to its device — a host-resident
    ``PieceSource``'s piece.  The window is byte-identical to the resident
    slice, so joins over uploaded windows are bit-equal to unspilled
    runs.  Returns ``(arrays, ready)``: on the card the copies run on the
    device's side stream from pinned memory and ``ready`` is the event the
    consumer's stream must wait on before reading them (each array is
    recorded on the consumer's stream for the allocator); on the CPU
    ``ready`` is None.

    A disk-resident registration is verified once after its demotion
    (:meth:`Ledger.verify_disk`), then each window reads its rows straight
    off memory-mapped pages."""
    if not reg.spilled:
        raise ValueError(f"{reg.owner} is device-resident; slice it")
    from . import recovery
    _LEDGER.touch(reg)
    starts = np.asarray(starts, np.int64)
    window = int(window)
    from_disk = reg.host is None
    if from_disk:
        _LEDGER.verify_disk(reg)
        sources = reg.disk_views
        if sources is None:
            with timing.region("disk.read"):
                sources = tuple([None if ent is None
                                 else _mmap_page(ent["path"]) for ent in per]
                                for per in reg.disk)
            reg.disk_views = sources
    else:
        sources = reg.host
    kind = recovery.injected("spill.upload")
    if kind in _RAISE_KINDS:
        raise recovery.make_fault(kind, "spill.upload")
    dev = reg.device
    cuda = dev is not None and dev.type == "cuda"
    stream = consumer = ready = None
    if cuda:
        consumer = torch.cuda.current_stream(dev)
        stream = _side_stream(dev)
    with timing.region("spill.upload"):
        devs = tuple(_put_window(blocks, starts, window, dev, stream)
                     for blocks in sources)
        if cuda:
            for t in devs:
                t.record_stream(consumer)
            ready = stream.record_event()
    if kind in ("stall", "spill_stall"):
        recovery.exchange_watchdog(
            "spill.upload", lambda: ready.synchronize() if ready else None,
            timeout_s=_stall_timeout(True), stalled=True)
    moved = _nbytes(devs)
    _STATS["readmit_events"] += 1
    _STATS["bytes_readmitted"] += moved
    if from_disk:
        _DSTATS["events"] += 1
        _DSTATS["bytes_promoted"] += moved
        timing.add_bytes("disk.read", moved)
    timing.add_bytes("spill.upload", moved)
    return devs, ready


# ---------------------------------------------------------------------------
# stats and logs
# ---------------------------------------------------------------------------

# the counters live in the metrics registry (obs/metrics): the group
# views keep the `_STATS[k] += 1` sites and stats() as they are
from ..obs import metrics as _metrics  # noqa: E402

_STATS = _metrics.group("memory", (
    "spill_events", "bytes_spilled", "readmit_events", "bytes_readmitted",
    "cross_session_evictions", "window_evictions"))
#: disk-tier counters (registry names ``memory_disk_*``): demote/promote
#: events, pages and bytes, IO retries at the disk sites, owners retired
#: on a failed page check, and demotions that stayed in memory
_DSTATS = _metrics.group("memory_disk", (
    "events", "pages_demoted", "pages_promoted", "bytes_demoted",
    "bytes_promoted", "retries", "corrupt_degrades", "write_degrades"))

_metrics.gauge("memory_ledger_bytes",
               help="current resident-ledger balance (bytes)",
               fn=lambda: _LEDGER.balance())
_metrics.gauge("memory_peak_ledger_bytes",
               help="resident-ledger high-water mark (bytes)",
               fn=lambda: _LEDGER.peak)
_metrics.gauge("memory_host_ledger_bytes",
               help="host-resident spill balance (bytes), the disk tier's "
                    "CYLON_TPU_TORCH_HOST_BUDGET predicate",
               fn=lambda: _LEDGER.host_balance())
#: owners in eviction order since the last reset
_EVICTION_LOG: list[str] = []
#: owners in demotion order since the last reset
_DEMOTION_LOG: list[str] = []


def _note_spill(site: str, reg: Registration) -> None:
    _STATS["spill_events"] += 1
    _STATS["bytes_spilled"] += reg.nbytes
    if reg.session is not None and reg.session != _session_tag():
        # a tenant's state evicted under another tenant's pressure (or
        # the scheduler's admission pass, which runs untagged)
        _STATS["cross_session_evictions"] += 1
    _EVICTION_LOG.append(reg.owner)
    timing.add_bytes(site, reg.nbytes)
    timing.bump(f"memory.{site}")


def stats() -> dict:
    """The spill counters: ``spill_events``/``bytes_spilled`` (device to
    host), ``readmit_events``/``bytes_readmitted`` (host to device, whole
    or by window), ``cross_session_evictions`` (a serving session's
    registrations evicted under another's pressure), ``window_evictions``
    (closed event-time windows retired through :func:`evict_release`),
    the ledger's ``peak_ledger_bytes``, ``ledger_bytes`` and
    ``host_ledger_bytes``, and
    the disk tier's ``disk_events``, ``bytes_to_disk``/``bytes_from_disk``,
    ``disk_pages_demoted``/``disk_pages_promoted``, ``disk_retries``,
    ``disk_corrupt_degrades`` and ``disk_write_degrades``."""
    return dict(_STATS, peak_ledger_bytes=_LEDGER.peak,
                ledger_bytes=_LEDGER.balance(),
                host_ledger_bytes=_LEDGER.host_balance(),
                disk_events=_DSTATS["events"],
                bytes_to_disk=_DSTATS["bytes_demoted"],
                bytes_from_disk=_DSTATS["bytes_promoted"],
                disk_pages_demoted=_DSTATS["pages_demoted"],
                disk_pages_promoted=_DSTATS["pages_promoted"],
                disk_retries=_DSTATS["retries"],
                disk_corrupt_degrades=_DSTATS["corrupt_degrades"],
                disk_write_degrades=_DSTATS["write_degrades"])


def eviction_log() -> list[str]:
    return list(_EVICTION_LOG)


def demotion_log() -> list[str]:
    return list(_DEMOTION_LOG)


def reset_stats() -> None:
    """Zero the counters and logs and restart the peak from the current
    balance (live registrations stay)."""
    for d in (_STATS, _DSTATS):
        for k in d:
            d[k] = 0
    _EVICTION_LOG.clear()
    _DEMOTION_LOG.clear()
    _LEDGER.peak = _LEDGER.balance()
