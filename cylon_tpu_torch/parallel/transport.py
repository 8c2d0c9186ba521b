"""The cross-process transport: one ``torch.distributed`` process group
under a :class:`~cylon_tpu_torch.ctx.context.DistributedConfig` world
(the reference's ``jax.distributed`` multi-controller runtime,
``cylon_tpu/ctx/context.py:62``).

A world of P processes × V local ranks has W = P·V ranks, numbered
process-major: process p owns ranks ``[p·V, (p+1)·V)``.  Each process
holds only its own ranks' row blocks, so a column is a ``(V·cap, ...)``
tensor; the count matrices, valid counts, capacities and splitters are
replicated, the same on every process.  This module is the one place
that talks to the process group:

* :func:`current` names this process's share of the world (``None``
  without a distributed env), which ``parallel/shards`` reads to loop
  the local ranks only;
* :func:`allgather_rows` stacks every process's equal-shaped row block
  (the counterpart of ``multihost_utils.process_allgather``);
* :func:`all_reduce_max` is the consensus wire (exec/recovery.py);
* :func:`all_to_all_rows` moves the exchange's cross-process rows with
  ``all_to_all_single`` (parallel/shuffle.py);
* :func:`barrier` waits for every process;
* :func:`hop_groups` makes the two-hop route's process subgroups
  (topo/exchange.py), one per slice for hop 1 and one per local-index
  column for hop 2, which :func:`all_to_all_rows` and the allgathers
  take as ``group``.

Backends: NCCL moves device tensors; gloo moves host tensors, so under
gloo a CUDA tensor is staged through a pinned host buffer both ways (the
one-card rig, where NCCL refuses two ranks on one GPU).  :data:`STATS`
counts what crossed and splits the time into staging (device↔host
copies) and wire (the collective itself); the two-hop route adds each
hop's bytes and seconds (``hop1_*``, ``hop2_*``).  Its values live in the
metrics registry (``transport_*`` counters, obs/metrics.group); the view
reads and writes like a dict.  Every collective runs under
the exchange watchdog (exec/recovery.exchange_watchdog) with the process
group's own timeout behind it: a peer that never arrives raises
``RankDesyncError``.  Armed, the runtime sentinel logs each one
(analysis/runtime.note_collective).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..analysis import runtime as _sentinel
from ..obs import metrics as _metrics

#: each counter's zero: bytes and counts are ints, times float seconds
_ZERO = {"bytes_sent": 0, "bytes_received": 0, "collectives": 0,
         "exchanges": 0, "staging_s": 0.0, "wire_s": 0.0,
         "counts_s": 0.0, "votes_s": 0.0, "setup_s": 0.0,
         "hop1_bytes": 0, "hop1_staging_s": 0.0, "hop1_wire_s": 0.0,
         "hop2_bytes": 0, "hop2_staging_s": 0.0, "hop2_wire_s": 0.0}

#: what the transport moved and the time it took (reset by callers)
STATS = _metrics.group("transport", _ZERO)

#: bumped by every install of a new world: a plan voted in an earlier
#: world is voted again (topo/model.ensure_adopted)
_GENERATION = [0]


class Proc:
    """This process's share of a multi-process world."""

    def __init__(self, world: int, pid: int, nproc: int, backend: str,
                 device: torch.device, timeout_s: float):
        self.world = int(world)
        self.pid = int(pid)
        self.nproc = int(nproc)
        self.local = self.world // self.nproc
        self.first = self.pid * self.local
        self.backend = backend
        self.device = device
        self.timeout_s = float(timeout_s)
        #: each process's host name, in process order (set at start-up)
        self.hosts: tuple = ()
        #: the processes (this one included) that drive this process's
        #: device (set at start-up): they split its memory budget
        self.device_share = 1
        self.generation = 0
        #: (n_slices, ranks_per_slice) -> (hop-1 group, hop-2 group)
        self.groups: dict = {}

    @property
    def ranks(self) -> range:
        return range(self.first, self.first + self.local)

    @property
    def staged(self) -> bool:
        """Whether device tensors cross through host memory (gloo on the
        card)."""
        return self.backend != "nccl" and self.device.type == "cuda"


_PROC: Proc | None = None


def current(world: int | None = None) -> Proc | None:
    """This process's share of the distributed world, or None.  With
    ``world`` given, only a distributed world of that size answers."""
    if _PROC is None or (world is not None and int(world) != _PROC.world):
        return None
    return _PROC


def install(proc: Proc | None) -> None:
    global _PROC
    if proc is not None:
        _GENERATION[0] += 1
        proc.generation = _GENERATION[0]
    _PROC = proc


class Group:
    """This process's subgroup of one hop: the member processes in
    ascending order (so ascending global rank) and the process group
    handle."""

    __slots__ = ("members", "handle")

    def __init__(self, members, handle):
        self.members = tuple(int(m) for m in members)
        self.handle = handle


def hop_groups(n_slices: int, ranks_per_slice: int) -> tuple:
    """(hop-1 group, hop-2 group) of this process under a two-hop plan
    of ``n_slices`` slices of ``ranks_per_slice`` ranks, made once per
    plan.  Slices hold whole processes (``R % V == 0``, topo/model.py):
    slice s is processes ``[s·R/V, (s+1)·R/V)``; process p's ranks have
    the local indices of column ``p mod R/V``, whose processes form its
    hop-2 group.  Every process makes every group in the same order, as
    ``torch.distributed.new_group`` requires."""
    proc = _PROC
    key = (int(n_slices), int(ranks_per_slice))
    hit = proc.groups.get(key)
    if hit is not None:
        return hit
    per = int(ranks_per_slice) // proc.local       # processes per slice
    slices = [list(range(s * per, (s + 1) * per))
              for s in range(int(n_slices))]
    columns = [list(range(b, proc.nproc, per)) for b in range(per)]
    t0 = time.perf_counter()
    mine = [None, None]
    for hop, groups in ((0, slices), (1, columns)):
        for members in groups:
            handle = dist.new_group(
                members, timeout=_timedelta(proc.timeout_s))
            if proc.pid in members:
                mine[hop] = Group(members, handle)
    STATS["setup_s"] += time.perf_counter() - t0
    proc.groups[key] = tuple(mine)
    return proc.groups[key]


def destroy_groups() -> None:
    """Destroy this world's hop subgroups (env.finalize)."""
    proc = _PROC
    if proc is None:
        return
    for pair in proc.groups.values():
        for g in pair:
            if g is not None and g.handle is not None:
                dist.destroy_process_group(g.handle)
    proc.groups.clear()


def _timedelta(seconds: float):
    import datetime
    return datetime.timedelta(seconds=float(seconds))


def _handle(group):
    return None if group is None else group.handle


def _size(proc: Proc, group) -> int:
    return proc.nproc if group is None else len(group.members)


def reset_stats() -> None:
    for k, zero in _ZERO.items():
        STATS[k] = zero


reset_stats()


def _guarded(site: str, thunk, kind: str, dtype, group: int):
    """A collective under the exchange watchdog; a collective error (the
    process group's timeout, a peer gone) becomes ``RankDesyncError``.
    ``kind``, ``dtype`` and ``group`` (its process count) name it in the
    sentinel's collective log."""
    from ..exec.recovery import exchange_watchdog
    from ..status import RankDesyncError

    def run():
        try:
            return thunk()
        except RuntimeError as e:
            raise RankDesyncError(
                f"collective at {site} failed: a peer process did not "
                f"arrive or left ({str(e).splitlines()[0][:200]})",
                site=site) from e

    STATS["collectives"] += 1
    if _sentinel._state is not None:
        _sentinel.note_collective(site, kind, dtype, group)
    return exchange_watchdog(site, run)


def _to_wire(proc: Proc, x: torch.Tensor) -> torch.Tensor:
    """``x`` on the wire's device: itself under NCCL and on a CPU env;
    under gloo on the card, a pinned host copy.  Bool travels as
    uint8."""
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    if proc.backend == "nccl" or not x.is_cuda:
        return x.contiguous()
    t0 = time.perf_counter()
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x, non_blocking=True)
    torch.cuda.synchronize(x.device)
    STATS["staging_s"] += time.perf_counter() - t0
    return buf


def _wire_empty(proc: Proc, shape, dtype) -> torch.Tensor:
    """A receive buffer on the wire's device (pinned host memory for
    gloo on the card)."""
    if dtype == torch.bool:
        dtype = torch.uint8
    if proc.backend == "nccl":
        return torch.empty(shape, dtype=dtype, device=proc.device)
    return torch.empty(shape, dtype=dtype, pin_memory=proc.staged)


def _from_wire(x: torch.Tensor, dtype, device) -> torch.Tensor:
    """A received buffer back on ``device`` (the staging copy up, under
    gloo on the card), as ``dtype``."""
    if x.device != device:
        t0 = time.perf_counter()
        x = x.to(device, non_blocking=True)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        STATS["staging_s"] += time.perf_counter() - t0
    return x.view(torch.bool) if dtype == torch.bool else x


def all_reduce_max(value: int, site: str = "exchange.consensus") -> int:
    """Max of one int64 over every process (the consensus wire)."""
    proc = _PROC
    if proc is None:
        return int(value)
    t0 = time.perf_counter()
    x = torch.tensor([int(value)], dtype=torch.int64,
                     device=proc.device if proc.backend == "nccl" else "cpu")

    def run():
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return int(x[0].item())

    out = _guarded(site, run, "all_reduce", x.dtype, proc.nproc)
    STATS["votes_s"] += time.perf_counter() - t0
    return out


def allgather_array(arr: np.ndarray, site: str = "transport.allgather",
                    group: Group | None = None) -> np.ndarray:
    """Every process's equal-shaped host array stacked along a new first
    axis, ``(P, ...)`` in process order (the members of ``group`` in
    their order, when given)."""
    arr = np.ascontiguousarray(arr)
    proc = _PROC
    if proc is None:
        return arr[None]
    x = torch.from_numpy(arr)
    if proc.backend == "nccl":
        x = x.to(proc.device)
    return allgather_tensor(x, site, group).cpu().numpy()


def allgather_tensor(x: torch.Tensor, site: str = "transport.allgather",
                     group: Group | None = None) -> torch.Tensor:
    """Every process's equal-shaped tensor stacked along a new first axis
    ``(P, ...)``, on ``x``'s device (``group``: its members only)."""
    proc = _PROC
    if proc is None:
        return x[None]
    send = _to_wire(proc, x)
    out = _wire_empty(proc, (_size(proc, group),) + tuple(x.shape),
                      x.dtype)
    handle = _handle(group)

    def run():
        t0 = time.perf_counter()
        if proc.backend == "nccl":
            dist.all_gather_into_tensor(out, send, group=handle)
        else:
            dist.all_gather(list(out.unbind(0)), send, group=handle)
        STATS["wire_s"] += time.perf_counter() - t0
        return out

    return _from_wire(_guarded(site, run, "all_gather", x.dtype,
                               _size(proc, group)), x.dtype, x.device)


def allgather_rows(x: torch.Tensor, site: str = "transport.allgather",
                   group: Group | None = None) -> torch.Tensor:
    """Every process's ``(V·k, ...)`` row block concatenated in process
    order, ``(W·k, ...)``: a row-sharded tensor made whole (``group``:
    its members' blocks)."""
    proc = _PROC
    if proc is None or _size(proc, group) == 1:
        return x
    g = allgather_tensor(x, site, group)
    return g.reshape((g.shape[0] * g.shape[1],) + tuple(g.shape[2:]))


def allgather_counts(local: torch.Tensor) -> np.ndarray:
    """The count sidecar made whole: every process's ``(V, W)`` rows of
    the send-count matrix gathered into the replicated ``(W, W)`` host
    matrix (a collective even in a one-process world)."""
    t0 = time.perf_counter()
    g = allgather_tensor(local.to(torch.int64).contiguous(),
                         "exchange.counts")
    res = g.reshape(-1, g.shape[-1]).cpu().numpy().astype(np.int64)
    STATS["counts_s"] += time.perf_counter() - t0
    return res


def all_to_all_rows(send: torch.Tensor, send_splits, recv_splits,
                    site: str = "exchange.all_to_all",
                    group: Group | None = None) -> torch.Tensor:
    """One ``all_to_all_single`` round: ``send`` holds the rows for
    process q in its ``send_splits[q]``-row slice, in process order; the
    result holds process p's rows in its ``recv_splits[p]``-row slice.
    With ``group`` the splits follow its members' order and only they
    take part.  The caller leaves its own process's splits at 0 (local
    rows never cross)."""
    proc = _PROC
    handle = _handle(group)
    dtype, dev = send.dtype, send.device
    n_recv = int(sum(recv_splits))
    w_send = _to_wire(proc, send)
    w_recv = _wire_empty(proc, (n_recv,) + tuple(send.shape[1:]), dtype)
    row = int(np.prod(send.shape[1:], dtype=np.int64)) * send.element_size()

    def run():
        t0 = time.perf_counter()
        dist.all_to_all_single(w_recv, w_send,
                               output_split_sizes=[int(s) for s in
                                                   recv_splits],
                               input_split_sizes=[int(s) for s in
                                                  send_splits],
                               group=handle)
        if proc.backend == "nccl":
            torch.cuda.synchronize(proc.device)
        STATS["wire_s"] += time.perf_counter() - t0
        return w_recv

    got = _guarded(site, run, "all_to_all", dtype, _size(proc, group))
    STATS["bytes_sent"] += int(sum(send_splits)) * row
    STATS["bytes_received"] += n_recv * row
    return _from_wire(got, dtype, dev)


def broadcast(x: torch.Tensor, src: int,
              site: str = "collectives.bcast") -> torch.Tensor:
    """Process ``src``'s ``x`` on every process (the others pass a tensor
    of the same shape and dtype)."""
    proc = _PROC
    if proc is None or proc.nproc == 1:
        return x
    buf = _to_wire(proc, x)
    if buf.data_ptr() == x.data_ptr():     # never receive into the caller's
        buf = buf.clone()

    def run():
        t0 = time.perf_counter()
        dist.broadcast(buf, src=int(src))
        STATS["wire_s"] += time.perf_counter() - t0
        return buf

    return _from_wire(_guarded(site, run, "broadcast", x.dtype, proc.nproc),
                      x.dtype, x.device)


def barrier(site: str = "env.barrier") -> None:
    """Every process reaches this point before any leaves it (queued
    device work first)."""
    proc = _PROC
    if proc is None:
        return
    if proc.device.type == "cuda":
        torch.cuda.synchronize(proc.device)
    if proc.backend == "nccl":
        # a one-element all-reduce: the barrier NCCL offers needs device
        # ids, and this one waits for every rank just the same
        all_reduce_max(0, site)
        return
    _guarded(site, lambda: dist.barrier(), "barrier", None, proc.nproc)
