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
"""

from __future__ import annotations

import torch

from ..status import DeviceUnavailableError, InvalidError


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

    def __repr__(self) -> str:  # pragma: no cover
        return f"CylonEnv(world={self._world}, device={self.device})"
