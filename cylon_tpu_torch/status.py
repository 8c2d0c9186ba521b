"""Typed errors of cylon_tpu_torch.

A copy of the subset of ``cylon_tpu/status.py`` that the ported path
raises, with the same names and codes, so callers can assert on the same
error categories in both packages.  Two errors are the port's own: a
missing CUDA device and a kernel that did not build or launch.

The fault taxonomy (:data:`FAULT_TYPES`) is what the retry ladder
(exec/recovery.py) dispatches on: a fault is recovered by a rung, any
other error propagates.
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
    SerializationError = 11
    RError = 12
    CodeGenError = 40
    ExpressionValidationError = 41
    ExecutionError = 42
    AlreadyExists = 45
    #: the spill tier's consensus vote (exec/recovery.spill_consensus);
    #: never raised
    SpillRequired = 46
    #: the checkpoint commit and resume votes (exec/recovery.
    #: ckpt_commit_consensus, ckpt_resume_consensus); never raised
    CkptCommit = 47
    #: the preemption drain vote (exec/recovery.drain_consensus); never
    #: raised
    PreemptDrain = 48
    #: the skew split's plan vote (exec/recovery.skew_plan_consensus);
    #: never raised
    SkewPlan = 49
    #: the topology plan's vote (exec/recovery.topo_plan_consensus);
    #: never raised
    TopoPlan = 50
    #: a conservation law or content fingerprint failed
    #: (:class:`DataIntegrityError`)
    IntegrityFault = 51


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


class CylonIndexError(CylonError):
    code = Code.IndexError


class CylonIOError(CylonError):
    code = Code.IOError


def require(module: str):
    """Import an optional package (pyarrow, pandas) for an IO or interop
    call, or raise :class:`CylonIOError` naming it: the card machine has
    neither, and no call carries on without the package it needs."""
    import importlib
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise CylonIOError(
            f"{module} is not installed; this call needs it") from e


class ExecutionError(CylonError):
    """A plan's own accounting failed at run time (the skew stitch's
    segment sums, relational/skew.py)."""

    code = Code.ExecutionError


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


class PredictedResourceExhausted(CylonError, MemoryError):
    """A capacity guard fired BEFORE any device allocation (the exchange's
    receive-budget guard, parallel/shuffle.py): device memory is untouched,
    so a retry in the same process at a degraded configuration is safe.
    The message keeps ``RESOURCE_EXHAUSTED (predicted)``, as the
    reference's does."""

    code = Code.OutOfMemory
    kind = "predicted"

    def __init__(self, msg: str = "", site: str | None = None):
        super().__init__(msg)
        self.site = site


class DeviceOOMError(CylonError):
    """The device ran out of memory for real: a ``torch.cuda.
    OutOfMemoryError``, or a ``RuntimeError`` carrying CUDA's
    out-of-memory text, mapped here by ``exec/recovery.classify`` (the one
    place that reads runtime error text); the original rides
    ``__cause__``."""

    code = Code.OutOfMemory
    kind = "device_oom"

    def __init__(self, msg: str = "", site: str | None = None):
        super().__init__(msg)
        self.site = site


class CapacityOverflowError(CylonError):
    """A pow2-bucketed static capacity (piece cap, output cap) was exceeded
    by the actual row counts: the planned shape cannot hold the data.  The
    remedy is a re-plan at a smaller piece size (the ladder's cap-halving
    rung), not a memory retry."""

    code = Code.CapacityError
    kind = "capacity"

    def __init__(self, msg: str = "", site: str | None = None):
        super().__init__(msg)
        self.site = site


class RankDesyncError(CylonError):
    """Ranks stopped advancing together, or a transfer hung: the exchange
    watchdog's deadline passed (exec/recovery.exchange_watchdog), or a
    consensus vote disagreed.  Carries the site and the last timing region
    entered."""

    code = Code.ExecutionError
    kind = "desync"

    def __init__(self, msg: str = "", site: str | None = None,
                 phase: str | None = None):
        super().__init__(msg)
        self.site = site
        self.phase = phase


class DataIntegrityError(CylonError):
    """Data in flight was lost, duplicated or changed: a conservation law
    or a content fingerprint failed at ``site`` in ``phase``.  A fault: the
    ladder recomputes the stage once, then aborts."""

    code = Code.IntegrityFault
    kind = "integrity"

    def __init__(self, msg: str = "", site: str | None = None,
                 phase: str | None = None):
        super().__init__(msg)
        self.site = site
        self.phase = phase


#: the recovery-fault types, in one tuple for isinstance dispatch
FAULT_TYPES = (PredictedResourceExhausted, DeviceOOMError,
               CapacityOverflowError, RankDesyncError, DataIntegrityError)


class CheckpointCorruptError(CylonError):
    """A spill page failed its content-hash check, or could not be read
    back whole (the disk tier, exec/memory.py).  At a ``disk.*`` site it is
    a fault: the owner's data exists nowhere else, so the ladder
    recomputes the stage — corruption degrades to recompute, never to a
    wrong answer."""

    code = Code.SerializationError
    kind = "corrupt"

    def __init__(self, msg: str = "", site: str | None = None):
        super().__init__(msg)
        self.site = site


class ResumableAbort(CylonError):
    """The retry ladder's final rung (exec/recovery, exec/checkpoint): a
    fault no in-process rung can cure (a real device OOM) arrived with
    durable checkpoints armed, or a preemption notice drained the piece
    loop.  Committed piece state is on disk, and a fresh process run with
    ``CYLON_TPU_TORCH_RESUME=1`` fast-forwards past it bit-identically.
    ``token`` is the resume token (the checkpoint root's absolute path);
    the original fault, if any, rides ``__cause__``.  Never retried in
    process."""

    code = Code.ExecutionError
    kind = "resumable"

    def __init__(self, msg: str = "", token: str | None = None):
        super().__init__(msg)
        self.token = token


class AdmissionTimeoutError(CylonError):
    """A pending serving session waited at the head of the admission
    queue past the deadline (``CYLON_TPU_TORCH_ADMISSION_TIMEOUT_S`` or
    the scheduler's ``admission_timeout_s``): the tenant fails typed
    instead of waiting without bound behind a long-running co-tenant
    (exec/scheduler.py)."""

    code = Code.ExecutionError
    kind = "admission_timeout"

    def __init__(self, msg: str = "", session: str | None = None,
                 waited_s: float | None = None):
        super().__init__(msg)
        self.session = session
        self.waited_s = waited_s


class RequeueOverflowError(CylonError):
    """A preempted tenant drained resumably but the scheduler's requeue
    capacity was spent: the tenant stays failed, typed, with the drain's
    :class:`ResumableAbort` (its resume token) on ``__cause__``, so a
    relaunch with ``CYLON_TPU_TORCH_RESUME=1`` can still resume it."""

    code = Code.CapacityError
    kind = "requeue_overflow"

    def __init__(self, msg: str = "", session: str | None = None):
        super().__init__(msg)
        self.session = session


class CompileQuarantinedError(CapacityOverflowError):
    """A kernel build is quarantined (exec/compiler.py): the compile
    intent journal shows that a predecessor process died while building
    this exact kernel (its source-and-flags digest), so building it
    again would walk back into the same crash.  A capacity fault on
    purpose, as in the reference: the ladder's ``Code.CapacityError``
    rung re-plans instead of re-crashing (here the digest does not
    change with the shape, so the retry meets the same quarantine and
    ends typed)."""

    kind = "quarantined"

    def __init__(self, msg: str = "", site: str | None = None,
                 signature: str | None = None):
        super().__init__(msg, site=site)
        self.signature = signature


class CompileTimeoutError(CylonError):
    """A kernel build ran past the compile watchdog's budget
    (``CYLON_TPU_TORCH_COMPILE_TIMEOUT_S``): its ``nvcc`` was killed and
    the caller surfaces typed instead of waiting on a hung compiler."""

    code = Code.ExecutionError
    kind = "compile_timeout"

    def __init__(self, msg: str = "", site: str | None = None,
                 signature: str | None = None):
        super().__init__(msg)
        self.site = site
        self.signature = signature


class DeviceUnavailableError(CylonError):
    """A CUDA device was requested (the default) but none is visible.  The
    port never drops to the CPU on its own: pass ``device="cpu"``."""

    code = Code.ExecutionError


class KernelError(CylonError):
    """A hand-written CUDA kernel failed to build, load or launch.
    ``signal``: the name of the signal that killed a kernel's compiler
    (a compiler crash, exec/recovery.is_compiler_crash), else None."""

    code = Code.ExecutionError

    def __init__(self, msg: str = "", code: Code | None = None, *,
                 signal: str | None = None):
        super().__init__(msg, code)
        self.signal = signal


class Status:
    """Value-style status for APIs that return instead of raising (the
    reference's ``Status``, ``cylon_tpu/status.py:354``): ``is_ok()``,
    ``get_code()``, ``get_msg()``; :meth:`raise_if_failed` raises
    ``CylonError(msg, code)``."""

    __slots__ = ("code", "msg")

    def __init__(self, code: Code = Code.OK, msg: str = ""):
        self.code = Code(code)
        self.msg = msg

    @staticmethod
    def OK() -> "Status":
        return Status(Code.OK)

    def is_ok(self) -> bool:
        return self.code == Code.OK

    def get_code(self) -> Code:
        return self.code

    def get_msg(self) -> str:
        return self.msg

    def raise_if_failed(self) -> None:
        if not self.is_ok():
            raise CylonError(self.msg, self.code)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Status({self.code.name}, {self.msg!r})"
