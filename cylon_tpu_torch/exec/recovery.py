"""Failure recovery: classification, injection, consensus and the retry
ladder (port of ``cylon_tpu/exec/recovery.py``).

1. **Fault taxonomy** (classes in :mod:`cylon_tpu_torch.status`):
   ``PredictedResourceExhausted`` (a guard fired before any allocation),
   ``DeviceOOMError`` (the card ran out of memory for real),
   ``CapacityOverflowError`` (a pow2 piece or output capacity was
   exceeded), ``RankDesyncError`` (a watchdog deadline passed) and
   ``DataIntegrityError``.  :func:`classify` is the one place that reads
   runtime error text: ``torch.cuda.OutOfMemoryError`` and a
   ``RuntimeError`` saying ``CUDA out of memory`` / ``CUDA error: out of
   memory`` (a CUB or cuBLAS workspace that failed) become
   ``DeviceOOMError``; a sticky CUDA error (an illegal memory access, a
   launch failure) is never an OOM and propagates.

2. **The retry ladder** (:func:`run_with_recovery`): a predicted OOM first
   takes the spill rung — resident state evicts to host memory
   (exec/memory.spill_for_retry) and the same configuration runs again —
   then an OOM retries the caller's chunked fallback at 4 and then 16
   chunks, a capacity overflow takes one cap-halving step (8 chunks), a
   disk-tier corruption or an integrity fault one recompute (4 chunks);
   nested ladders never escalate (the outer one owns the rungs), and
   every step is recorded (:func:`recovery_events`) and counted in the
   timing stats (``recovery.<site>.<kind>.<action>``).  Before a retry the
   failed attempt's frames are cleared and the allocator's cache emptied,
   so the retry does not run beside the failed attempt's memory.

3. **Fault injection** (``CYLON_TPU_TORCH_FAULTS="site[:rank][:nth]=
   kind[@session]"``): each fault is raised at its named site, so every
   rung runs on the CPU.  The grammar takes every site and kind the
   reference takes, so a spec written for it parses here, and every site
   probes: ``exchange.corrupt`` fires just after an exchange delivered
   (kind ``corrupt`` is intercepted there and flips one received
   element, the drill the armed fingerprints must catch),
   ``audit.verify`` wraps the fingerprint's pull (``stall`` hangs it
   inside the watchdog) and ``compile.build`` guards every kernel build
   (exec/compiler.py: ``stall`` hangs it inside the compile watchdog,
   ``kill`` SIGKILLs the process once the compile intent is on disk,
   ``corrupt`` poisons the manifest entry just written).  An
   ``@session`` spec fires only on the thread of that
   serving session (exec/scheduler.py tags each session's thread with
   :func:`set_session`), its ``nth`` counted against that session's own
   probes at the site, so a co-tenant's probes never shift it.

4. **The final rung** (:func:`_resumable`): with durable checkpoints
   armed (exec/checkpoint.py), a ``DeviceOOMError`` no rung cured, or a
   compiler crash (:func:`is_compiler_crash`: a kernel build whose
   ``nvcc`` died by a signal, or a quarantined build), flushes the
   checkpoint session and becomes a typed ``ResumableAbort`` carrying
   the resume token; a fresh process run with
   ``CYLON_TPU_TORCH_RESUME=1`` fast-forwards past the committed pieces.
   Unarmed, the fault propagates typed.

5. **Exchange watchdog** (:func:`exchange_watchdog`): with
   ``CYLON_TPU_TORCH_WATCHDOG_S`` set, a blocking transfer runs under a
   deadline and a hang surfaces as ``RankDesyncError``.

Serving sessions: recorded events carry the tagged session's name
(:func:`events_for_session` is one tenant's audit trail), and the votes
ride a session namespace above their payload (:func:`_ns_consensus`),
which is an identity in one process.

Consensus: in a multi-process world (ctx/context.DistributedConfig)
every vote is one all-reduce(MAX) of an int64 over the process group
(:func:`_consensus_wire`, parallel/transport.py); one process driving
every rank of a ``VirtualMeshConfig`` world takes its local value as the
agreed one — the reference's single-controller branch.  Only the votes
that ported code takes are here (the guard, the spill rung, the eviction
count, the skew plan, the checkpoint commit and resume, the watermark,
the preemption drain, the scheduler's preempt decision, the topology
plan, the integrity audit's fingerprint).
"""

from __future__ import annotations

import errno
import os
import threading
import traceback

import torch

from .. import config
from ..status import (CapacityOverflowError, CheckpointCorruptError, Code,
                      CylonError, DataIntegrityError, DeviceOOMError,
                      FAULT_TYPES,
                      PredictedResourceExhausted, RankDesyncError,
                      ResumableAbort)

#: injection site names, the reference's (exec/recovery.SITES there)
SITES = ("shuffle.recv_guard", "join.piece_cap", "groupby.device_oom",
         "exchange.stall", "spill.evict", "spill.upload",
         "disk.write", "disk.read",
         "ckpt.write", "ckpt.load", "ckpt.reshard", "pipe.phase_sync",
         "stream.append", "stream.watermark", "obs.export",
         "sched.preempt", "compile.build",
         "exchange.corrupt", "audit.verify")

#: fault kinds of the injection grammar: ``spill_stall`` hangs a spill
#: transfer inside the watchdog; ``corrupt`` flips a spill page's byte
#: after hashing (``disk.write``) or fails its check (``disk.read``);
#: ``enospc`` fails a page write with ``OSError(ENOSPC)``; ``kill``
#: SIGKILLs and ``term`` SIGTERMs the process at the site
KINDS = ("predicted", "device_oom", "capacity", "desync", "stall",
         "spill_stall", "corrupt", "enospc", "kill", "term")


# ---------------------------------------------------------------------------
# classification — the one place that reads runtime error text
# ---------------------------------------------------------------------------

_OOM_MARKERS = ("CUDA out of memory", "CUDA error: out of memory",
                "RESOURCE_EXHAUSTED")
#: errors that leave the CUDA context unusable: never retried in process
_STICKY_MARKERS = ("illegal memory access", "launch failure",
                   "device-side assert", "illegal instruction",
                   "misaligned address")


def _oom_text(s: str) -> bool:
    return (any(m in s for m in _OOM_MARKERS)
            and not any(m in s for m in _STICKY_MARKERS))


def is_oom(e: Exception) -> bool:
    """Device out-of-memory: a taxonomy OOM, ``torch.cuda.
    OutOfMemoryError``, or a foreign error carrying CUDA's text."""
    if isinstance(e, (PredictedResourceExhausted, DeviceOOMError,
                      torch.cuda.OutOfMemoryError)):
        return True
    return _oom_text(str(e))


def classify(e: Exception) -> CylonError | None:
    """Map an exception onto the fault taxonomy, or None (not a fault:
    re-raise it).  Typed faults pass through; a ``CheckpointCorruptError``
    from a ``disk.*`` site is a fault (its owner's data exists nowhere
    else, so the ladder recomputes); ``torch.cuda.OutOfMemoryError`` and a
    foreign error with CUDA's out-of-memory text become ``DeviceOOMError``
    (``PredictedResourceExhausted`` when the text says ``(predicted)``),
    the original on ``__cause__``.  A sticky CUDA error is not a fault."""
    if isinstance(e, FAULT_TYPES):
        return e
    if isinstance(e, CheckpointCorruptError):
        return e if str(getattr(e, "site", "") or "").startswith("disk.") \
            else None
    if isinstance(e, CylonError):
        return None
    if is_oom(e):
        s = str(e)
        cls = (PredictedResourceExhausted if "(predicted)" in s
               else DeviceOOMError)
        fault = cls(s)
        fault.__cause__ = e
        return fault
    return None


# ---------------------------------------------------------------------------
# compiler-crash classification
# ---------------------------------------------------------------------------

def is_compiler_crash(e: Exception) -> bool:
    """True when a kernel's compiler died rather than the program being
    invalid: a quarantined build (``CompileQuarantinedError``), or a
    build whose compiler a signal killed (a ``KernelError`` from
    exec/compiler.build_all carrying the signal).  The reference matches
    its XLA backend's crash texts, probed once per process; the port's
    only compilers are its own ``nvcc`` and ``g++`` runs, whose deaths
    it raises by type, so there is nothing to probe or match."""
    from ..status import CompileQuarantinedError, KernelError
    return isinstance(e, CompileQuarantinedError) or (
        isinstance(e, KernelError) and e.signal is not None)


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

class _FaultSpec:
    __slots__ = ("site", "rank", "nth", "kind", "session", "fired")

    def __init__(self, site: str, rank, nth, kind: str, session=None):
        self.site = site
        self.rank = rank        # int or None (= every rank)
        self.nth = nth          # int (1-based) or None (= every occurrence)
        self.kind = kind
        self.session = session  # str or None (= any session)
        self.fired = False


_FAULTS: list[_FaultSpec] | None = None   # None: parse the env at first use
_HITS: dict = {}    # occurrence counters: site -> n, (site, session) -> n


def _parse_faults(spec: str) -> list[_FaultSpec]:
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        lhs, _, kind = entry.partition("=")
        kind, _, session = kind.strip().partition("@")
        session = session.strip() or None
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"CYLON_TPU_TORCH_FAULTS: unknown kind {kind!r} in "
                f"{entry!r}; kinds: {KINDS}")
        parts = lhs.strip().split(":")
        site = parts[0]
        if site not in SITES:
            raise ValueError(
                f"CYLON_TPU_TORCH_FAULTS: unknown site {site!r} in "
                f"{entry!r}; sites: {SITES}")
        rank = None
        nth: int | None = 1
        if len(parts) > 1 and parts[1] not in ("", "*"):
            rank = int(parts[1])
        if len(parts) > 2:
            nth = None if parts[2] == "*" else int(parts[2])
        if len(parts) > 3:
            raise ValueError(
                f"CYLON_TPU_TORCH_FAULTS: bad entry {entry!r} "
                "(grammar: site[:rank][:nth]=kind[@session])")
        out.append(_FaultSpec(site, rank, nth, kind, session))
    return out


def install_faults(spec: str | None) -> None:
    """(Re)program the injector: ``spec`` in the env grammar, ``""`` to
    disarm, ``None`` to read ``CYLON_TPU_TORCH_FAULTS``.  Resets the
    occurrence counters, the one-shot flags and the event log."""
    global _FAULTS
    _HITS.clear()
    _EVENTS.clear()
    if spec is None:
        spec = os.environ.get("CYLON_TPU_TORCH_FAULTS", "")
    _FAULTS = _parse_faults(spec)


def _installed() -> list[_FaultSpec]:
    """The installed specs; at first use, ``CYLON_TPU_TORCH_FAULTS``'s
    (parsed without resetting the counters or the event log)."""
    global _FAULTS
    if _FAULTS is None:
        _FAULTS = _parse_faults(os.environ.get("CYLON_TPU_TORCH_FAULTS", ""))
    return _FAULTS


def probe(site: str) -> tuple[str | None, bool]:
    """Probe the injector at ``site`` → ``(kind, armed)``: the kind firing
    at this occurrence (consuming one-shot specs) or None, and whether any
    spec could still fire at this site.  A rank-selective spec fires on
    the process of that index (``env.rank``; 0 when one process drives
    every rank).
    An ``@session`` spec matches only on the thread tagged with that
    session (:func:`set_session`), and its ``nth`` counts that session's
    own probes at the site."""
    faults = _installed()
    if not faults:
        return None, False
    _HITS[site] = hit = _HITS.get(site, 0) + 1
    sess = current_session()
    sess_hit = hit
    if sess is not None:
        skey = (site, sess)
        _HITS[skey] = sess_hit = _HITS.get(skey, 0) + 1

    def could_fire(f) -> bool:
        if f.site != site:
            return False
        if f.nth is None:
            return True
        if f.session is None:
            return f.nth >= hit
        if f.session == sess:
            return f.nth >= sess_hit
        # another session's spec: its next probe is occurrence + 1
        return f.nth >= _HITS.get((site, f.session), 0) + 1

    # armed before the one-shots are consumed: the firing probe reads
    # as armed
    armed = any(could_fire(f) for f in faults)
    from ..parallel import transport
    proc = transport.current()
    me = 0 if proc is None else proc.pid
    kind = None
    for f in faults:
        if f.site != site or f.fired:
            continue
        if f.rank is not None and f.rank != me:
            continue
        if f.session is not None and f.session != sess:
            continue
        if f.nth is not None and f.nth != (sess_hit if f.session is not None
                                           else hit):
            continue
        f.fired = f.nth is not None
        kind = f.kind
        break
    return kind, armed


def injected(site: str) -> str | None:
    """Count one occurrence at ``site``; the kind firing there, or None."""
    return probe(site)[0]


def faults_declare(site: str) -> bool:
    """Whether any installed spec names ``site`` (counts no occurrence)."""
    return any(f.site == site for f in _installed())


def make_fault(kind: str, site: str) -> Exception:
    """The exception of an injected fault.  ``device_oom`` is a FOREIGN
    ``RuntimeError`` with CUDA's text, so injection runs :func:`classify`
    as a real allocator failure does."""
    if kind == "predicted":
        return PredictedResourceExhausted(
            f"RESOURCE_EXHAUSTED (predicted): injected fault at {site}",
            site=site)
    if kind == "device_oom":
        return RuntimeError(
            f"CUDA error: out of memory (injected device OOM at {site})")
    if kind == "capacity":
        return CapacityOverflowError(f"injected capacity overflow at {site}",
                                     site=site)
    if kind == "corrupt":
        return CheckpointCorruptError(f"injected corruption at {site}",
                                      site=site)
    if kind == "enospc":
        return OSError(errno.ENOSPC, f"injected ENOSPC at {site}")
    return RankDesyncError(f"injected rank desync at {site}", site=site,
                           phase=_last_phase())


def maybe_inject(site: str, intercept: tuple = ()) -> str | None:
    """Raise the fault armed at ``site`` (nothing when none is).  ``kill``
    and ``term`` signal the process instead; kinds in ``intercept`` are
    returned for the site to handle (a disk write flips a byte on
    ``corrupt``)."""
    kind = injected(site)
    if kind is None:
        return None
    if kind in ("kill", "term"):
        import signal
        if kind == "term":
            _record(site, kind, "sigterm")
        else:
            # SIGKILL leaves no unwind: the flight recorder's post-mortem
            # (armed runs) is written here, beside the manifests
            try:
                from ..obs import trace
                trace.postmortem(f"injected kill at {site}")
            except Exception:  # noqa: BLE001 — the kill proceeds regardless
                pass
        os.kill(os.getpid(), signal.SIGKILL if kind == "kill"
                else signal.SIGTERM)
        return None
    if kind in intercept:
        return kind
    _record(site, kind, "injected")
    raise make_fault(kind, site)


# ---------------------------------------------------------------------------
# recovery-event log
# ---------------------------------------------------------------------------

_EVENTS: list[dict] = []
#: per thread: the ladder's nesting depth and the serving session's tag
_tls = threading.local()


def set_session(name: str | None, ordinal: int | None = None) -> None:
    """Tag this thread with a serving session (the scheduler calls it on
    each session's thread): recorded events carry the name, ``@session``
    specs match it, and the votes ride its namespace.  ``None`` clears
    the tag, the behavior outside a scheduler."""
    _tls.session = name
    _tls.session_ord = ordinal


def current_session() -> str | None:
    """The serving session tagged on this thread, or None."""
    return getattr(_tls, "session", None)


def _session_ns() -> int:
    """The vote namespace: 0 with no session tagged, else 1 + (ordinal
    mod 30), which fits the reference's int32 wire."""
    o = getattr(_tls, "session_ord", None)
    return 0 if o is None else 1 + (int(o) % 30)


def events_for_session(name: str) -> list[dict]:
    """The recorded events tagged with serving session ``name``: one
    tenant's audit trail."""
    return [e for e in _EVENTS if e.get("session") == name]


def _last_phase() -> str:
    from ..utils import timing
    return timing.last_region()


def _record(site: str, kind: str, action: str) -> None:
    from ..utils import timing
    from ..utils.logging import log
    ev = {"site": site, "kind": kind, "action": action}
    sess = current_session()
    if sess is not None:
        # a serving session's events name it; outside a scheduler the
        # key is absent, as in the reference
        ev["session"] = sess
    _EVENTS.append(ev)
    timing.bump(f"recovery.{site}.{kind}.{action}")
    log.warning("recovery: %s fault at %s -> %s", kind, site, action)


def recovery_events() -> list[dict]:
    """Events since the last :func:`reset_events`/:func:`drain_events`,
    each ``{"site", "kind", "action"}`` (and ``"session"`` on a serving
    session's thread), oldest first."""
    return list(_EVENTS)


def drain_events() -> list[dict]:
    out = list(_EVENTS)
    _EVENTS.clear()
    return out


def reset_events() -> None:
    _EVENTS.clear()


# ---------------------------------------------------------------------------
# consensus: one all-reduce(MAX) across the processes of a distributed
# world; the local value in one process
# ---------------------------------------------------------------------------

_WIRE = 1 << 20


def _consensus_wire(env, wire: int,
                    site: str = "exchange.consensus") -> int:
    """Max-reduce one int64 across the processes of the distributed world
    (``torch.distributed`` all-reduce under the exchange watchdog,
    parallel/transport.py) — the transport of every vote
    (``cylon_tpu/exec/recovery.py:637``).  One process drives every rank
    of a one-process world, so there the local value is the agreed one.
    Every process must call it at the same point: it is a collective;
    ``site`` names the vote in a ``RankDesyncError``."""
    from ..parallel import transport
    if transport.current() is None:
        return int(wire)
    return transport.all_reduce_max(int(wire), site)


def _voted(what: str, wire: int) -> int:
    """The agreed wire of one vote, on the trace timeline (armed runs)."""
    from ..obs import trace
    trace.instant("consensus." + what, wire=int(wire))
    return wire


def _ns_consensus(env, payload: int, base: int, what: str) -> int:
    """Max-agree ``payload`` (< ``base``) with the serving session's
    namespace above it, ``wire = ns · base + payload``.  An agreed wire
    from another namespace means a peer voted from a different session
    and raises ``RankDesyncError`` (one-sided, as the reference's: the
    rank holding the highest namespace proceeds)."""
    ns = _session_ns()
    agreed = _voted(what, _consensus_wire(env, ns * base + int(payload),
                                          what))
    if agreed // base != ns:
        raise RankDesyncError(
            f"cross-session consensus collision at {what}: this rank "
            f"voted in session namespace {ns}, the agreed wire is from "
            f"namespace {agreed // base}", site=what, phase=_last_phase())
    return agreed % base


def _min_consensus(env, n: int, what: str) -> int:
    """Min-agree a count below the epoch base: the complement rides the
    max wire (the max of the complement is the complement of the min)."""
    top = _CKPT_EPOCH_BASE - 1
    return top - _ns_consensus(env, top - int(n), _CKPT_EPOCH_BASE, what)


def consensus_code(env, code) -> Code:
    """The agreed (max) status code over the world's ranks."""
    return Code(_ns_consensus(env, int(code), 64, "exchange.consensus"))


def guard_consensus(env, local_fault: bool) -> bool:
    """Raise/proceed agreement of a capacity guard, taken before the
    exchange starts: True when any rank's guard fired."""
    return consensus_code(env, Code.OutOfMemory if local_fault
                          else Code.OK) != Code.OK


def spill_consensus(env, local_need: bool) -> bool:
    """Agreement to take the spill rung: True when any rank can spill."""
    return consensus_code(env, Code.SpillRequired if local_need
                          else Code.OK) == Code.SpillRequired


def count_consensus(env, n: int) -> int:
    """Max-agree a small count (the spill tier's eviction and demotion
    counts): every rank then evicts as many owners."""
    return _ns_consensus(env, min(max(int(n), 0), _WIRE - 1), _WIRE,
                         "exchange.count")


def preempt_consensus(env, victim_plus1: int) -> int:
    """The scheduler's preempt decision (exec/scheduler.py): every rank
    votes its chosen victim as ``ordinal + 1`` (0: none) and the max
    wins, so every rank drains the same tenant or none does."""
    return _ns_consensus(env, min(max(int(victim_plus1), 0), _WIRE - 1),
                         _WIRE, "sched.preempt")


#: namespace base of the admission footprint's wire: bytes below 1 PiB
_BYTES_BASE = 1 << 50


def footprint_consensus(env, nbytes: int) -> int:
    """Max-agree a session's admission footprint in bytes (exec/
    scheduler: the declared footprint clamped by the shape family's
    observed peak, which is each process's own history): every process
    then charges the same bytes and admits alike."""
    return _ns_consensus(env, min(max(int(nbytes), 0), _BYTES_BASE - 1),
                         _BYTES_BASE, "scheduler.footprint")


def drain_consensus(env, local_flag: bool) -> bool:
    """Preemption drain agreement (exec/checkpoint.drain_requested): True
    when any rank received a preemption notice, so every rank drains at
    the same piece boundary."""
    return consensus_code(env, Code.PreemptDrain if local_flag
                          else Code.OK) == Code.PreemptDrain


#: epoch field width of the checkpoint wires
_CKPT_EPOCH_BASE = 1 << 20


#: namespace base of the checkpoint commit's wire (code, epoch) below it
_CKPT_NS_BASE = 1 << 26


def ckpt_commit_consensus(env, epoch: int) -> int:
    """Phase 2 of the checkpoint's two-phase manifest commit: every
    process has staged its manifest and votes ``Code.CkptCommit`` with its
    staged epoch; only then does any process publish it.  The vote is the
    reference's two rounds (``cylon_tpu/exec/recovery.py:844-863``): the
    wire max-agreed, then the epoch's complement max-agreed (the max of
    the complement is the complement of the min), both in the session's
    namespace, so the process holding the highest epoch sees a lower one
    too.  Any divergence raises ``RankDesyncError`` before any rename.
    One process stages every rank's epoch, so there the vote is its own
    epoch."""
    epoch = int(epoch)
    if not 0 <= epoch < _CKPT_EPOCH_BASE:
        raise ValueError(f"checkpoint epoch {epoch} out of wire range")
    from ..parallel import transport
    if transport.current() is None:
        return _voted("ckpt.commit", epoch)
    head = int(Code.CkptCommit) * _CKPT_EPOCH_BASE
    wire = head + epoch
    agreed = _ns_consensus(env, wire, _CKPT_NS_BASE, "ckpt.commit")
    inv = _ns_consensus(env, head + (_CKPT_EPOCH_BASE - 1 - epoch),
                        _CKPT_NS_BASE, "ckpt.commit")
    lo = _CKPT_EPOCH_BASE - 1 - (inv % _CKPT_EPOCH_BASE)
    if agreed != wire or lo != epoch:
        raise RankDesyncError(
            f"checkpoint commit diverged: this process staged epoch "
            f"{epoch}, the vote saw [{lo}, {agreed % _CKPT_EPOCH_BASE}] — "
            "processes are checkpointing different pieces",
            site="ckpt.commit", phase=_last_phase())
    return epoch


def ckpt_resume_consensus(env, n: int) -> int:
    """Min-agree the resume fast-forward count (exec/pipeline): every
    rank fast-forwards the fewest pieces any rank restored and
    verified."""
    n = int(n)
    if not 0 <= n < _CKPT_EPOCH_BASE:
        raise ValueError(f"resume fast-forward count {n} out of wire range")
    return _min_consensus(env, n, "ckpt.resume")


def watermark_consensus(env, n: int) -> int:
    """Min-agree the streaming watermark (the event-time window close,
    ``stream/window.py``): ``n`` is this rank's count of newly closable
    windows, and every rank closes the fewest any rank can, so no rank
    emits or evicts a window another still holds open."""
    n = int(n)
    if not 0 <= n < _CKPT_EPOCH_BASE:
        raise ValueError(f"watermark window count {n} out of wire range")
    return _min_consensus(env, n, "stream.watermark")


def _plan_hash_consensus(env, code: Code, plan_hash: int, site: str,
                         what: str) -> None:
    """Adopt-one-plan agreement shared by the skew split and the topology
    route (the reference's ``_plan_hash_consensus``,
    ``cylon_tpu/exec/recovery.py:891``): every rank votes two 20-bit
    slices of its plan's hash, each as a max and as a min (four rounds),
    before the plan's first exchange; a rank whose slice is not both
    raises ``RankDesyncError`` naming ``code``.  One process computes the
    plan once for every rank, so there the vote passes."""
    from ..parallel import transport
    if transport.current() is None:
        return
    h = int(plan_hash) & ((1 << 64) - 1)
    for k in range(2):
        mine = (h >> (20 * k)) & (_WIRE - 1)
        hi = _ns_consensus(env, mine, _WIRE, site)
        lo = _min_consensus(env, mine, site)
        if hi != mine or lo != mine:
            raise RankDesyncError(
                f"{what} consensus ({code.name}): this rank's plan hash "
                f"slice {k} is {mine:#x}, the ranks voted [{lo:#x}, "
                f"{hi:#x}] — ranks derived different plans", site=site,
                phase=_last_phase())


def skew_plan_consensus(env, plan_hash: int) -> None:
    """Adopt-one-plan agreement of the adaptive skew split (relational/
    skew.py), ``Code.SkewPlan`` at ``skew.plan``."""
    _plan_hash_consensus(env, Code.SkewPlan, plan_hash, "skew.plan",
                         "skew-plan")


def topo_plan_consensus(env, plan_hash: int) -> None:
    """Adopt-one-plan agreement of the two-hop topology route
    (topo/model.ensure_adopted), ``Code.TopoPlan`` at ``topo.plan``:
    voted once per env layout and plan before the first hierarchical
    exchange, so a process whose slice map differs raises before any
    hop starts."""
    _plan_hash_consensus(env, Code.TopoPlan, plan_hash, "topo.plan",
                         "topology-plan")


def fingerprint_consensus(env, fp: int) -> None:
    """Rank-coherent check of an audited content fingerprint
    (exec/integrity.py, its only caller): every process votes two 20-bit
    slices of its 64-bit value as a max and as a min, ``Code.
    IntegrityFault`` at ``audit.verify``, so a process whose data differs
    raises ``RankDesyncError`` before any process commits the stage.  In
    one process the fingerprint covers every rank already, so the vote
    passes."""
    _plan_hash_consensus(env, Code.IntegrityFault, fp, "audit.verify",
                         "fingerprint-audit")


# ---------------------------------------------------------------------------
# exchange watchdog
# ---------------------------------------------------------------------------

def exchange_watchdog(site: str, thunk, timeout_s: float | None = None,
                      stalled: bool | None = None):
    """Run a blocking transfer or pull under ``CYLON_TPU_TORCH_WATCHDOG_S``
    (or ``timeout_s``): off (0) it is a plain call; on, the thunk runs in
    a worker thread and a miss of the deadline raises ``RankDesyncError``
    carrying the site and the last region entered.  The ``stall`` kind at
    ``exchange.stall`` simulates the hang; ``stalled=True`` forces it (the
    spill tier's ``spill_stall``)."""
    t = config.EXCHANGE_WATCHDOG_S if timeout_s is None else float(timeout_s)
    if t <= 0:
        return thunk()
    if stalled is None:
        stalled = injected("exchange.stall")
    box: dict = {}

    def run():
        if stalled:
            import time
            time.sleep(4 * t)        # the data never arrives
            return
        try:
            box["value"] = thunk()
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            box["error"] = e

    th = threading.Thread(target=run, daemon=True,
                          name=f"cylon-watchdog-{site}")
    th.start()
    th.join(t)
    if "error" in box:
        raise box["error"]
    if "value" not in box:
        _record(site, "desync", "watchdog")
        raise RankDesyncError(
            f"exchange watchdog: no progress at {site} within {t:g}s — a "
            "transfer hung", site=site, phase=_last_phase())
    return box["value"]


# ---------------------------------------------------------------------------
# bounded IO retry
# ---------------------------------------------------------------------------

#: transient-OSError retries taken by retry_io, every site together
from ..obs import metrics as _obs_metrics  # noqa: E402

IO_RETRIES = _obs_metrics.counter(
    "recovery_io_retries",
    help="transient-OSError retries taken by the bounded IO backoff")

#: errnos that no short backoff heals: the caller's degrade path owns them
_NON_TRANSIENT_ERRNOS = frozenset(
    getattr(errno, name)
    for name in ("ENOSPC", "EDQUOT", "EROFS", "ENOENT", "EISDIR")
    if hasattr(errno, name))


def retry_io(fn, site: str, attempts: int = 3, base_delay_s: float = 0.05,
             on_retry=None):
    """Run a filesystem thunk with at most ``attempts`` tries, backing off
    ``base · 2^i`` seconds on a transient ``OSError``; a non-transient
    errno (ENOSPC, EDQUOT, EROFS, ENOENT, EISDIR) and every other
    exception raise at once.  ``on_retry`` runs once per retry."""
    import time
    from ..utils import timing
    from ..utils.logging import log
    last: OSError | None = None
    for i in range(max(int(attempts), 1)):
        if i:
            IO_RETRIES.inc()
            timing.bump(f"io_retry.{site}")
            if on_retry is not None:
                on_retry()
            log.warning("%s: transient OSError (%s); retry %d/%d after "
                        "%.3fs backoff", site, last, i, attempts - 1,
                        base_delay_s * (2 ** (i - 1)))
            time.sleep(base_delay_s * (2 ** (i - 1)))
        try:
            return fn()
        except OSError as e:
            if e.errno in _NON_TRANSIENT_ERRNOS:
                raise
            last = e
    raise last


# ---------------------------------------------------------------------------
# the retry ladder
# ---------------------------------------------------------------------------

#: chunk counts of the fallback per fault code: an OOM streams at 4, then
#: 16 chunks; a capacity overflow takes one cap-halving step (8 chunks
#: halve the 4-chunk default's pieces); a disk-tier corruption or an
#: integrity fault recomputes once at the base configuration
RETRY_RUNGS = {Code.OutOfMemory: (4, 16), Code.CapacityError: (8,),
               Code.SerializationError: (4,), Code.IntegrityFault: (4,)}


def _resumable(exc, label: str):
    """The ladder's final rung: with durable checkpoints armed
    (``CYLON_TPU_TORCH_CKPT_DIR``), a fault no in-process rung can cure —
    a ``DeviceOOMError`` (the CUDA context may not be trusted) or a
    compiler crash (:func:`is_compiler_crash`) — flushes the checkpoint
    session and becomes a :class:`ResumableAbort` carrying the resume
    token, the fault on ``__cause__``, recorded as ``resumable_abort``.
    Anything else, or unarmed, comes back unchanged."""
    from . import checkpoint
    if not checkpoint.enabled():
        return exc
    if not (isinstance(exc, DeviceOOMError) or is_compiler_crash(exc)):
        return exc
    token = checkpoint.flush_for_abort(label)
    kind = getattr(exc, "kind", "compiler_crash")
    _record(label, kind, "resumable_abort")
    ra = ResumableAbort(
        f"{label}: unrecoverable {kind} fault with durable checkpoints "
        f"armed — committed piece state flushed; rerun the same workload "
        f"in a FRESH process with CYLON_TPU_TORCH_RESUME=1 to fast-forward "
        f"past committed pieces (resume token: {token})", token=token)
    ra.__cause__ = exc
    return ra


def _release_frames(e: BaseException) -> None:
    """Clear the locals of every frame a failed attempt's exception chain
    holds, so the tensors they reference go back to the allocator before
    the retry (the traceback's lines stay printable)."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if e.__traceback__ is not None:
            traceback.clear_frames(e.__traceback__)
        e = e.__cause__ or e.__context__


def _empty_cache() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _wire_code(fault) -> int:
    """The ladder's vote: ``Code·4 + sub``, a predicted OOM (sub 0)
    below a real device OOM (sub 1) of the same code, so the agreed wire
    names the fault type every process raises
    (``cylon_tpu/exec/recovery.py:699``); 0 without a fault."""
    if fault is None:
        return 0
    sub = 0 if isinstance(fault, PredictedResourceExhausted) else 1
    return int(fault.code) * 4 + sub


def _fault_from_wire(wire: int, msg: str) -> Exception:
    """The typed fault of an agreed wire, the same class on every
    process."""
    code = Code(int(wire) // 4)
    if code == Code.OutOfMemory:
        return (PredictedResourceExhausted(msg) if wire % 4 == 0
                else DeviceOOMError(msg))
    if code == Code.CapacityError:
        return CapacityOverflowError(msg)
    if code == Code.SerializationError:
        return CheckpointCorruptError(msg, site="disk.read")
    if code == Code.IntegrityFault:
        return DataIntegrityError(msg, site="audit.verify",
                                  phase=_last_phase())
    return RankDesyncError(msg, phase=_last_phase())


def _attempt(fn, label: str = ""):
    """``(result, fault)``; a non-fault exception propagates."""
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 — classify filters
        fault = classify(e)
        if fault is None:
            exc = _resumable(e, label)
            if exc is e:
                raise
            raise exc from e
        _release_frames(e)
        return None, fault


def run_with_recovery(primary, can_fallback: bool, fallback, label: str,
                      env=None):
    """``primary()`` under the retry ladder: classify any fault, then
    either return, retry (the spill rung, then ``fallback(n_chunks)`` on
    the :data:`RETRY_RUNGS` schedule) or raise the typed fault.  A
    fallback that re-enters a guarded operator gets no rungs of its own.
    ``env`` names the world the consensus votes over (local here)."""
    nested = getattr(_tls, "depth", 0) > 0
    from ..parallel import transport
    multi = transport.current() is not None

    def agree(fault):
        if not multi:
            code = Code.OK if fault is None \
                else consensus_code(env, fault.code)
            return code, fault
        # every process votes, fault or not, over the wire encoding, so
        # all agree on the fault's type; a process whose own attempt
        # passed adopts a peer's fault of the agreed class
        wire = _ns_consensus(env, _wire_code(fault), 1024, label)
        if wire == 0:
            return Code.OK, None
        if fault is None or _wire_code(fault) != wire:
            fault = _fault_from_wire(
                wire, f"peer rank fault during {label} (consensus "
                      f"{Code(wire // 4).name})")
        return Code(wire // 4), fault

    result, fault = _attempt(primary, label)
    agreed, fault = agree(fault)
    if agreed == Code.OK:
        return result
    kind = getattr(fault, "kind", "fault")

    # the spill rung: a predicted fault fired before any allocation, so
    # evicting resident state and running the same configuration again
    # discards no completed work
    if not nested and isinstance(fault, PredictedResourceExhausted):
        from . import memory
        local_can = config.SPILL_ENABLED and memory.spillable_bytes() > 0
        if spill_consensus(env, local_can):
            # through the serving tier's facade, like every eviction
            from . import scheduler
            scheduler.spill_retry()
            from ..utils.logging import log
            _record(label, kind, "spill_retry")
            log.warning("%s %s fault; spill rung: resident state evicted "
                        "to host, retrying at the same configuration",
                        label, kind)
            _empty_cache()
            _tls.depth = getattr(_tls, "depth", 0) + 1
            try:
                result, fault = _attempt(primary, label)
            finally:
                _tls.depth -= 1
            agreed, fault = agree(fault)
            if agreed == Code.OK:
                return result
            kind = getattr(fault, "kind", kind)

    rungs = RETRY_RUNGS.get(agreed, ())
    if not rungs or not can_fallback or nested:
        _record(label, kind, "abort")
        raise _resumable(fault, label)

    from ..utils.logging import log
    last = fault
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        for nc in rungs:
            _record(label, kind, f"retry_chunks_{nc}")
            log.warning("%s %s fault (%s); retry via the chunked fallback "
                        "with %d chunks", label, kind, type(last).__name__,
                        nc)
            _empty_cache()
            result, fault = _attempt(lambda: fallback(nc), label)
            agreed, fault = agree(fault)
            if agreed == Code.OK:
                return result
            last, kind = fault, getattr(fault, "kind", kind)
            if agreed not in RETRY_RUNGS:
                break
    finally:
        _tls.depth -= 1
    _record(label, kind, "abort")
    raise _resumable(last, label)
