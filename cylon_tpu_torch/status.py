"""Typed errors of cylon_tpu_torch.

A copy of the subset of ``cylon_tpu/status.py`` that the ported path
raises, with the same names and codes, so callers can assert on the same
error categories in both packages.  Two errors are the port's own: a
missing CUDA device and a kernel that did not build or launch.
"""

from __future__ import annotations

import enum


class Code(enum.IntEnum):
    """Error codes mirroring reference cpp/src/cylon/code.hpp:19-40."""

    OK = 0
    OutOfMemory = 1
    KeyError = 2
    TypeError = 3
    Invalid = 4
    IOError = 5
    CapacityError = 6
    IndexError = 7
    UnknownError = 9
    NotImplemented = 10
    ExecutionError = 42


class CylonError(Exception):
    """Base error carrying a :class:`Code`."""

    code: Code = Code.UnknownError

    def __init__(self, msg: str = "", code: Code | None = None):
        super().__init__(msg)
        if code is not None:
            self.code = code

    @property
    def msg(self) -> str:
        return str(self)


class InvalidError(CylonError):
    code = Code.Invalid


class CylonTypeError(CylonError):
    code = Code.TypeError


class CylonKeyError(CylonError):
    code = Code.KeyError


class NumericOverflowError(CylonError):
    """The armed saturation guard (ops/groupby.guard_saturation) found an
    int64 sum/count at the rail: the aggregate has wrapped or is one
    combine away from wrapping.  Surfaced, never retried."""

    code = Code.ExecutionError
    kind = "overflow"

    def __init__(self, msg: str = "", site: str | None = None,
                 column: str | None = None):
        super().__init__(msg)
        self.site = site
        self.column = column


class DeviceUnavailableError(CylonError):
    """A CUDA device was requested (the default) but none is visible.  The
    port never drops to the CPU on its own: pass ``device="cpu"``."""

    code = Code.ExecutionError


class KernelError(CylonError):
    """A hand-written CUDA kernel failed to build, load or launch."""

    code = Code.ExecutionError
