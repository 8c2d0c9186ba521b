"""Execution context: ``CylonEnv`` + ``LocalConfig`` (port of
``cylon_tpu/ctx/context.py``).

The reference's env holds a jax device mesh; here it holds one torch
device.  The env runs on ``cuda:0`` unless the caller passes
``device="cpu"`` (the tests do); a CUDA request without a visible CUDA
device raises :class:`~cylon_tpu_torch.status.DeviceUnavailableError`
rather than dropping to the CPU.  Only world size 1 exists in this slice.
"""

from __future__ import annotations

import torch

from ..status import DeviceUnavailableError


class CommConfig:
    """Base communicator config (reference: net/comm_config.hpp)."""

    comm_type = "local"
    world_size = 1


class LocalConfig(CommConfig):
    """Serial context: world size 1, no collectives (reference Init())."""

    comm_type = "local"


class CylonEnv:
    """The world handle: a config, one device and a serial that keys the
    prediction caches (CPython reuses ``id()`` after GC; a serial never
    repeats)."""

    _next_serial = 0

    def __init__(self, config: CommConfig | None = None, device=None):
        self.config = config or LocalConfig()
        if self.config.world_size != 1:
            raise NotImplementedError(
                "cylon_tpu_torch runs world size 1 only; the "
                "torch.distributed config and the exchange come with "
                "slices 1 and 3 of ROADMAP.md Queue 1")
        dev = torch.device("cuda:0" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise DeviceUnavailableError(
                    f"device {dev} requested but torch sees no CUDA device; "
                    "pass device='cpu' to run on the host")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.serial = CylonEnv._next_serial
        CylonEnv._next_serial += 1

    @property
    def world_size(self) -> int:
        return 1

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def __repr__(self) -> str:  # pragma: no cover
        return f"CylonEnv(world=1, device={self.device})"
