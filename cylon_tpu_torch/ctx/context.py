"""Execution context: ``CylonEnv`` + communicator configs (port of
``cylon_tpu/ctx/context.py``).

The reference's env holds a jax device mesh; here it holds one torch
device and a world size.  The env runs on ``cuda:0`` unless the caller
passes ``device="cpu"`` (the tests do); a CUDA request without a visible
CUDA device raises :class:`~cylon_tpu_torch.status.DeviceUnavailableError`
rather than dropping to the CPU.

World sizes above 1 come from two configs:

* :class:`VirtualMeshConfig`, the analog of the reference's
  ``CPUMeshConfig``: W ranks driven by one controller process with every
  shard on the env's one device, so a table's W shards are W row blocks
  of one tensor and the all-to-all is an order-preserving device-local
  permutation (parallel/shuffle.py);
* :class:`DistributedConfig`, the analog of the reference's
  ``TPUConfig(distributed=True)``: P processes joined by one
  ``torch.distributed`` process group, each driving V local ranks on its
  own device, W = P·V ranks numbered process-major.  A process holds
  only its V ranks' row blocks; the exchange moves the rows bound for
  another process with ``all_to_all_single`` and every vote is one
  all-reduce (parallel/transport.py).  NCCL on the card, gloo on the
  CPU; gloo on the card only when asked for by name (its exchange stages
  through pinned host memory).  NCCL never falls back to gloo, nor the
  card to the CPU: a backend that is missing or fails to start raises.

A config whose ``devices`` name more than one distinct device in one
process raises ``NotImplementedError``: several cards are driven by
several processes, one per card (torchrun's ``LOCAL_RANK`` picks a
process's card, :func:`local_rank_device`).

The env carries the reference's collective surface (``rank``,
``get_next_sequence``, ``add_config``/``get_config``, ``allgather``,
``gather``, ``bcast``, ``allreduce``, ``barrier``, ``finalize``):
``barrier`` waits for the device and, in a multi-process world, for
every process; ``finalize`` destroys the process group and the two-hop
route's subgroups.  ``env.topology`` is the world's tier model
(topo/model.py): the slices a ``CYLON_TPU_TORCH_SLICES`` declaration
makes, or across processes those of the processes' hosts.
"""

from __future__ import annotations

import datetime
import itertools
import os
import time

import torch

from ..status import DeviceUnavailableError, InvalidError


#: the env's monotone op ids (get_next_sequence)
_seq = itertools.count()


class CommConfig:
    """Base communicator config (reference: net/comm_config.hpp)."""

    comm_type = "local"
    world_size = 1
    #: the device each rank asks for (None: the env's default); a config
    #: over several cards (not ported) would name one per rank
    devices: tuple = (None,)


class LocalConfig(CommConfig):
    """Serial context: world size 1, no collectives (reference Init())."""

    comm_type = "local"


class VirtualMeshConfig(CommConfig):
    """W ranks on one device, driven by one process (the reference's
    ``CPUMeshConfig`` rig, ``cylon_tpu/ctx/context.py:104``).

    ``device``: the one device every rank runs on (default ``cuda:0``)."""

    comm_type = "virtual-mesh"

    def __init__(self, world_size: int = 8, device=None):
        self.world_size = int(world_size)
        self.devices = (device,) * self.world_size


class DistributedConfig(CommConfig):
    """P processes × V local ranks joined by ``torch.distributed`` (the
    reference's ``TPUConfig(distributed=True, coordinator_address,
    process_id, num_processes)``, ``cylon_tpu/ctx/context.py:62``).

    ``coordinator_address``: ``host:port`` of process 0's rendezvous
    (``tcp://`` optional); ``process_id`` and ``num_processes``: this
    process's index and the process count.  Each defaults to the
    torchrun-style environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``).  ``local_world``: V ranks per process
    (default 1).  ``backend``: ``None`` picks ``"nccl"`` on a CUDA
    device and ``"gloo"`` on the CPU; ``"gloo"`` on the card must be
    named.  ``device``: this process's device.  Without one, a process
    that torchrun started with ``LOCAL_RANK`` takes ``cuda:<LOCAL_RANK>``
    (one process per card), and ``DeviceUnavailableError`` is raised
    here, before any rendezvous, when that card is not there: there is
    no modulo and no fallback to ``cuda:0``; otherwise ``cuda:0``.  An
    explicit ``device`` always wins (the one-card gloo worlds name
    theirs).  ``timeout_s``: the process group's collective timeout
    (default the exchange watchdog's ``CYLON_TPU_TORCH_WATCHDOG_S`` when
    set, else 600 s)."""

    comm_type = "distributed"

    def __init__(self, coordinator_address: str | None = None,
                 process_id: int | None = None,
                 num_processes: int | None = None, local_world: int = 1,
                 backend: str | None = None, device=None,
                 timeout_s: float | None = None):
        envv = os.environ
        if coordinator_address is None and "MASTER_ADDR" in envv:
            coordinator_address = (f"{envv['MASTER_ADDR']}:"
                                   f"{envv.get('MASTER_PORT', '29500')}")
        if process_id is None:
            process_id = int(envv.get("RANK", "0"))
        if num_processes is None:
            num_processes = int(envv.get("WORLD_SIZE", "1"))
        if device is None and envv.get("LOCAL_RANK", "") != "":
            device = local_rank_device(int(envv["LOCAL_RANK"]))
        if coordinator_address is None:
            raise InvalidError("DistributedConfig needs a coordinator "
                               "address (or MASTER_ADDR/MASTER_PORT)")
        if backend not in (None, "nccl", "gloo"):
            raise InvalidError(f"backend must be 'nccl', 'gloo' or None, "
                               f"got {backend!r}")
        self.coordinator_address = str(coordinator_address)
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.local_world = int(local_world)
        if self.num_processes < 1 or self.local_world < 1 or not (
                0 <= self.process_id < self.num_processes):
            raise InvalidError(
                f"process {self.process_id} of {self.num_processes} with "
                f"{self.local_world} local ranks is no world")
        self.backend = backend
        self.timeout_s = timeout_s
        self.world_size = self.local_world * self.num_processes
        self.devices = (device,)


def local_rank_device(local_rank: int) -> torch.device:
    """``cuda:<local_rank>``, the card of a process that torchrun started
    with ``LOCAL_RANK``; :class:`DeviceUnavailableError` when the host
    has no such card (never another card in its place)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not 0 <= local_rank < n:
        raise DeviceUnavailableError(
            f"LOCAL_RANK={local_rank} names card {local_rank}, but torch "
            f"sees {n} CUDA device(s); pass device= to choose one")
    return torch.device("cuda", local_rank)


def _start_group(cfg: DistributedConfig, device: torch.device):
    """Join (or reuse) the process group; returns the transport's
    :class:`~cylon_tpu_torch.parallel.transport.Proc`."""
    from .. import config
    from ..parallel import transport
    import torch.distributed as dist
    backend = cfg.backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise InvalidError("the NCCL backend moves device tensors: it needs "
                           "a CUDA device; pass backend='gloo' on the CPU")
    if not dist.is_available() or not (
            dist.is_nccl_available() if backend == "nccl"
            else dist.is_gloo_available()):
        raise DeviceUnavailableError(
            f"torch.distributed backend {backend!r} is not available in "
            "this torch build")
    timeout = cfg.timeout_s
    if timeout is None:
        timeout = (config.EXCHANGE_WATCHDOG_S
                   if config.EXCHANGE_WATCHDOG_S > 0 else 600.0)
    proc = transport.current()
    if proc is not None:
        if (proc.world, proc.pid, proc.nproc, proc.backend) != (
                cfg.world_size, cfg.process_id, cfg.num_processes, backend):
            raise InvalidError(
                "this process already belongs to another distributed "
                "world; finalize() its env first")
        return proc
    addr = cfg.coordinator_address
    if "://" not in addr:
        addr = "tcp://" + addr
    t0 = time.perf_counter()
    try:
        kw = {}
        if backend == "nccl":
            kw["device_id"] = device
        dist.init_process_group(
            backend, init_method=addr, rank=cfg.process_id,
            world_size=cfg.num_processes,
            timeout=datetime.timedelta(seconds=float(timeout)), **kw)
    except Exception as e:  # noqa: BLE001 — typed below, never a fallback
        raise DeviceUnavailableError(
            f"torch.distributed {backend} process group failed to start "
            f"at {cfg.coordinator_address} (process {cfg.process_id} of "
            f"{cfg.num_processes}): {e}") from e
    proc = transport.Proc(cfg.world_size, cfg.process_id,
                          cfg.num_processes, backend, device, timeout)
    transport.install(proc)
    try:
        # the first collective makes the connections (NCCL's communicator)
        transport.all_reduce_max(0, "env.setup")
        proc.hosts, proc.device_share = _gather_hosts(device)
    except Exception:
        transport.install(None)
        dist.destroy_process_group()
        raise
    transport.STATS["setup_s"] = time.perf_counter() - t0
    return proc


def _gather_hosts(device: torch.device) -> tuple:
    """Every process's host name, in process order, and how many
    processes share this process's device (one allgather at set-up).
    The topology's ``"device"`` source groups the processes of one host
    into a slice (topo/model.host_slices); the memory ledger splits one
    card's budget among the processes that share it
    (exec/memory.budget_bytes).  A device is its host and its identity:
    a CUDA card's UUID where torch reports one, else its name."""
    import socket
    import numpy as np
    from ..parallel import transport
    ident = str(device)
    if device.type == "cuda":
        ident = str(getattr(torch.cuda.get_device_properties(device),
                            "uuid", ident))
    name = socket.gethostname().encode()[:255]
    dev = f"{socket.gethostname()}/{ident}".encode()[:255]
    buf = np.zeros((2, 256), np.uint8)
    buf[0, :len(name)] = np.frombuffer(name, np.uint8)
    buf[1, :len(dev)] = np.frombuffer(dev, np.uint8)
    got = transport.allgather_array(buf, "env.hosts")
    hosts = tuple(bytes(row[0]).rstrip(b"\0").decode(errors="replace")
                  for row in got)
    pid = transport.current().pid
    share = sum(1 for row in got if bytes(row[1]) == bytes(got[pid][1]))
    return hosts, share


def _resolve(dev: torch.device) -> torch.device:
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                f"device {dev} requested but torch sees no CUDA device; "
                "pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class CylonEnv:
    """The world handle: a config, one device, the world size and a serial
    that keys the prediction caches (CPython reuses ``id()`` after GC; a
    serial never repeats).  ``device`` overrides the config's device for
    every rank of a one-device world."""

    _next_serial = 0

    def __init__(self, config: CommConfig | None = None, device=None):
        self.config = config or LocalConfig()
        if int(self.config.world_size) < 1:
            raise InvalidError(f"world size must be at least 1, got "
                               f"{self.config.world_size}")
        devs = {torch.device("cuda:0" if d is None else d)
                for d in self.config.devices}
        if len(devs) != 1:
            raise NotImplementedError(
                f"one process drives one device, not {len(devs)}: the "
                "multi-card transport runs one process per card "
                "(DistributedConfig)")
        self.device = _resolve(devs.pop() if device is None
                               else torch.device(device))
        self._world = int(self.config.world_size)
        self._proc = None
        if isinstance(self.config, DistributedConfig):
            self._proc = _start_group(self.config, self.device)
        # spot semantics: arm the SIGTERM grace drain when
        # CYLON_TPU_TORCH_PREEMPT_GRACE_S declares a budget (one env read
        # and no handler otherwise)
        from ..exec.preempt import install as _install_preempt
        _install_preempt()
        self._conf: dict[str, str] = {}
        self._finalized = False
        self.serial = CylonEnv._next_serial
        CylonEnv._next_serial += 1

    @property
    def world_size(self) -> int:
        return self._world

    @property
    def is_distributed(self) -> bool:
        return self._world > 1

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    @property
    def process_count(self) -> int:
        """Processes in the world (1 unless a DistributedConfig)."""
        return 1 if self._proc is None else self._proc.nproc

    @property
    def multi_process(self) -> bool:
        """Whether the world spans more than one process."""
        return self.process_count > 1

    @property
    def local_world(self) -> int:
        """V, the ranks this process drives: W in one process."""
        return self._world if self._proc is None else self._proc.local

    @property
    def local_ranks(self) -> range:
        """The global ranks this process drives, ``[p·V, (p+1)·V)``."""
        return range(self._world) if self._proc is None \
            else self._proc.ranks

    @property
    def backend(self) -> str | None:
        """The process group's backend (None without one)."""
        return None if self._proc is None else self._proc.backend

    @property
    def topology(self):
        """The world's tier model (topo/model.topology): its slices, from
        ``CYLON_TPU_TORCH_SLICES`` or, across processes, the hosts."""
        from ..topo.model import topology
        return topology(self)

    @property
    def rank(self) -> int:
        """This process's index, as the reference's
        ``jax.process_index()``: 0 when one controller drives every
        rank."""
        return 0 if self._proc is None else self._proc.pid

    def get_next_sequence(self) -> int:
        """A monotone op id (tracing tags)."""
        return next(_seq)

    def add_config(self, key: str, value: str) -> None:
        self._conf[key] = value

    def get_config(self, key: str, default: str = "") -> str:
        return self._conf.get(key, default)

    # -- collective surface ------------------------------------------------
    def allgather(self, table):
        """AllGather(Table): every shard receives every row."""
        from ..parallel.collectives import allgather_table
        return allgather_table(table)

    def gather(self, table, root: int = 0):
        """Gather(Table, root): every row onto shard ``root``."""
        from ..parallel.collectives import gather_table
        return gather_table(table, root)

    def bcast(self, table, root: int = 0):
        """Bcast(Table): shard ``root``'s rows onto every shard."""
        from ..parallel.collectives import bcast_table
        return bcast_table(table, root)

    def allreduce(self, column_or_array, op: str = "sum", valid_counts=None):
        """AllReduce(Column, op): elementwise across shards, as a host
        array; pass the table's ``valid_counts`` to mask the padding."""
        from ..parallel.collectives import allreduce
        return allreduce(column_or_array, op, valid_counts,
                         world=self._world)

    def barrier(self) -> None:
        """Wait until the env's device has run every queued op and, in a
        distributed world, until every process has reached the barrier
        (under the exchange watchdog)."""
        if self.on_cuda:
            torch.cuda.synchronize(self.device)
        if self._proc is not None:
            from ..parallel import transport
            transport.barrier()

    def finalize(self) -> None:
        """Close the env; a distributed env destroys its process group."""
        if self._proc is not None and not self._finalized:
            from ..parallel import transport
            import torch.distributed as dist
            if dist.is_initialized():
                transport.destroy_groups()
            transport.install(None)
            if dist.is_initialized():
                dist.destroy_process_group()
        self._finalized = True

    def __repr__(self) -> str:  # pragma: no cover
        return f"CylonEnv(world={self._world}, device={self.device})"
