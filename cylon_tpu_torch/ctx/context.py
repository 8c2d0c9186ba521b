"""Execution context: ``CylonEnv`` + communicator configs (port of
``cylon_tpu/ctx/context.py``).

The reference's env holds a jax device mesh; here it holds one torch
device and a world size.  The env runs on ``cuda:0`` unless the caller
passes ``device="cpu"`` (the tests do); a CUDA request without a visible
CUDA device raises :class:`~cylon_tpu_torch.status.DeviceUnavailableError`
rather than dropping to the CPU.

World sizes above 1 come from :class:`VirtualMeshConfig`, the analog of
the reference's ``CPUMeshConfig``: W ranks driven by one controller
process with every shard on the env's one device, so a table's W shards
are W row blocks of one tensor and the all-to-all is an order-preserving
device-local permutation (parallel/shuffle.py).  A config whose
``devices`` name more than one distinct device raises
``NotImplementedError``: the multi-card transport is a later slice.

The env carries the reference's collective surface (``rank``,
``get_next_sequence``, ``add_config``/``get_config``, ``allgather``,
``gather``, ``bcast``, ``allreduce``, ``barrier``, ``finalize``) in its
single-controller form: every collective is device-local
(parallel/collectives.py) and ``barrier`` waits for the device.
"""

from __future__ import annotations

import itertools

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
                f"a world over {len(devs)} distinct devices needs the "
                "multi-card transport (torch.distributed / NCCL, or peer "
                "copies under one controller), a later slice of ROADMAP.md "
                "Queue 1 slice 3; VirtualMeshConfig runs every rank on one "
                "device")
        self.device = _resolve(devs.pop() if device is None
                               else torch.device(device))
        self._world = int(self.config.world_size)
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
    def rank(self) -> int:
        """This process's rank: 0, one controller drives every rank."""
        return 0

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
        """Wait until the env's device has run every queued op (one
        controller, one device: nothing else to wait for); a no-op on
        the CPU."""
        if self.on_cuda:
            torch.cuda.synchronize(self.device)

    def finalize(self) -> None:
        self._finalized = True

    def __repr__(self) -> str:  # pragma: no cover
        return f"CylonEnv(world={self._world}, device={self.device})"
