"""The compile lifecycle of the port's kernel builds (port of
``cylon_tpu/exec/compiler.py``).

The reference governs XLA: every ``jax.jit`` program rides its facade.
The port has no jit, no ``torch.compile`` and no CUDA graph; what it
compiles are the hand-written kernels, each an ``nvcc`` build of one
``.cu`` source into a shared library loaded with ctypes
(``kernels.build``/``kernels.load``), and the host string hash's ``g++``
build (``native/``).  Nothing else in the port builds or loads a
library, and every such build and load goes through this module, which
keeps the reference's surface and counter names:

* **counters** — ``compile_cache_miss_total`` counts builds,
  ``compile_cache_hit_total`` loads served by a library already built
  (a live handle, or a file on disk), ``compile_seconds_total`` and
  ``compile_events_total`` the builds' wall seconds and runs, and
  ``compile_quarantine_total``, ``compile_timeout_total``,
  ``compile_manifest_drop_total``.  ``compile_cache_evict_total`` and
  ``compile_mesh_table_evict_total`` stay 0: a loaded library is never
  unloaded (``ctypes`` does not close one), so there is no program
  budget to evict under, and no per-mesh program table.
* **the ledger** — the loaded libraries by label, a handful per process
  (the two kernels and the string hash).
* **the persistent layer** (``CYLON_TPU_TORCH_COMPILE_CACHE_DIR``) —
  libraries build into ``<dir>/kernels``, beside three files written
  through a temporary file, a rename and ``recovery.retry_io``: a warm
  **manifest** of each library's sha256, the **quarantine** ledger and
  a per-process compile **intent** journal.  Armed, a library is loaded
  only when its manifest entry exists and its bytes hash to it; one
  that fails (a flipped bit, a poisoned entry) is dropped, counted and
  rebuilt, never loaded.
* **the intent journal and the quarantine** — the intent names every
  build in flight and is written before the compilers start and cleared
  after.  A process that finds an intent left by a process no longer
  alive quarantines those builds (their source-and-flags digests, the
  library's name suffix) and a later build of one raises
  ``CompileQuarantinedError``.  A live sibling's intent is left alone.
* **the watchdog** — a build running past
  ``CYLON_TPU_TORCH_COMPILE_TIMEOUT_S`` is killed and raises
  ``CompileTimeoutError``.
* **the injector** at ``compile.build``: ``stall`` replaces the compiler
  with a process that hangs, which the watchdog kills (a 2 s budget when
  none is set); ``kill`` SIGKILLs the process once the intent is on
  disk; ``corrupt`` poisons the manifest entry just written.

Unarmed (no directory, no watchdog, no ``compile.build`` spec) the kernels
build into ``cylon_tpu_torch/kernels/_build`` and the facade writes
nothing.  A build is never replaced by a kernel's plain version: a
failed, timed-out or quarantined build raises.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

from .. import config
from ..obs import metrics
from ..status import (CompileQuarantinedError, CompileTimeoutError,
                      KernelError)

#: the injector site guarding every build
SITE = "compile.build"

#: the canonical row capacity of a world-1 ingest (shape families), kept
#: in config and exported here under the reference's name
family_cap = config.family_cap

_HIT = metrics.counter(
    "compile_cache_hit_total",
    help="kernel library loads served by a library already built")
_MISS = metrics.counter(
    "compile_cache_miss_total",
    help="kernel library builds (nvcc or g++ runs that produced one)")
_EVICT = metrics.counter(
    "compile_cache_evict_total",
    help="loaded kernel libraries evicted (no counterpart in the port: "
         "a library is never unloaded; always 0)")
_MESH_EVICT = metrics.counter(
    "compile_mesh_table_evict_total",
    help="per-mesh program tables cleared (no counterpart in the port: "
         "always 0)")
_SECONDS = metrics.counter(
    "compile_seconds_total",
    help="cumulative wall seconds of the kernel builds")
_EVENTS = metrics.counter(
    "compile_events_total", help="kernel builds run")
_QUARANTINED = metrics.counter(
    "compile_quarantine_total",
    help="kernel builds quarantined from a dead predecessor's intent")
_TIMEOUTS = metrics.counter(
    "compile_timeout_total",
    help="kernel builds killed by the compile watchdog")
_MANIFEST_DROPS = metrics.counter(
    "compile_manifest_drop_total",
    help="kernel libraries dropped on a failed sha256 (rebuilt, never "
         "loaded)")

_lock = threading.RLock()

#: label -> loaded library handle
_LEDGER: dict = {}

#: [None = recompute at the next check, else the cached bool]
_ARMED: list = [None]

#: the persistent layer's state for the directory scanned last
_DIR_STATE: dict = {"path": None, "quarantine": set(), "manifest": {},
                    "adopted": []}

#: label -> wall seconds of its build in this process
build_seconds: dict = {}


def cache_dir() -> str:
    """The persistent directory (``CYLON_TPU_TORCH_COMPILE_CACHE_DIR``),
    or ``""`` when the persistent layer is off."""
    return str(config.COMPILE_CACHE_DIR or "")


def _compute_armed() -> bool:
    if float(config.COMPILE_TIMEOUT_S or 0) > 0 or cache_dir():
        return True
    from . import recovery
    try:
        return recovery.faults_declare(SITE)
    except ValueError:      # a broken spec disarms, it does not crash
        return False


def armed() -> bool:
    """True while the persistent layer, a watchdog budget or a
    ``compile.build`` spec needs the guarded path (cached; :func:`rearm`
    recomputes)."""
    a = _ARMED[0]
    if a is None:
        a = _ARMED[0] = _compute_armed()
    return a


def rearm() -> None:
    """Recompute the armed state and scan the persistent directory again
    at the next use: after changing ``config.COMPILE_*`` or the injector's
    specs mid-process."""
    _ARMED[0] = None
    _DIR_STATE["path"] = None


def build_dir(default: str) -> str:
    """Where libraries build: ``<dir>/kernels`` under the persistent
    layer, else ``default``."""
    d = cache_dir()
    return os.path.join(d, "kernels") if d else default


# ---------------------------------------------------------------------------
# the persistent layer: manifest, quarantine, intent journal
# ---------------------------------------------------------------------------

def _atomic_json(path: str, payload) -> None:
    """Write through a temporary file and a rename, under the bounded
    transient-``OSError`` retry."""
    from . import recovery

    def write():
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, sort_keys=True)
        os.replace(tmp, path)

    recovery.retry_io(write, SITE)


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _file_sha(path: str) -> str | None:
    try:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return None


def _intent_path(d: str, pid: int | None = None) -> str:
    return os.path.join(d, f"intent.{os.getpid() if pid is None else pid}"
                           ".json")


def _alive(pid: int) -> bool:
    if pid == os.getpid():
        return True
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:         # another user's live process
        return True
    return True


def _drop(fname: str, d: str) -> None:
    """Drop one manifest entry and its library file (counted)."""
    _DIR_STATE["manifest"].pop(fname, None)
    try:
        os.remove(os.path.join(d, "kernels", fname))
    except OSError:
        pass
    _MANIFEST_DROPS.inc()
    _record("corrupt", f"manifest_drop:{fname}")


def _ensure_dir() -> dict | None:
    """Arm the persistent layer for the configured directory (once per
    directory): read the quarantine ledger, keep the manifest entries
    whose library still hashes to them (dropping the others), and adopt
    the intents of dead processes into the quarantine."""
    d = cache_dir()
    if not d:
        return None
    with _lock:
        if _DIR_STATE["path"] == d:
            return _DIR_STATE
        from . import recovery
        recovery.retry_io(
            lambda: os.makedirs(os.path.join(d, "kernels"), exist_ok=True),
            SITE)
        q = _read_json(os.path.join(d, "quarantine.json")) or {}
        quarantine = set(q.get("signatures", ()))
        man = _read_json(os.path.join(d, "manifest.json"))
        _DIR_STATE.update(path=d, quarantine=quarantine, manifest={},
                          adopted=[])
        dropped = []
        for fname, ent in (man.items() if isinstance(man, dict) else ()):
            path = os.path.join(d, "kernels", fname)
            if not os.path.exists(path):
                continue            # a library removed on purpose
            ok = isinstance(ent, dict) and ent.get("sha256") == \
                _file_sha(path)
            if ok:
                _DIR_STATE["manifest"][fname] = ent
            else:
                dropped.append(fname)
        for fname in dropped:
            _drop(fname, d)
        if dropped:
            _atomic_json(os.path.join(d, "manifest.json"),
                         _DIR_STATE["manifest"])
        adopted = []
        try:
            names = sorted(f for f in os.listdir(d)
                           if f.startswith("intent.") and f.endswith(".json"))
        except OSError:
            names = []
        for name in names:
            p = os.path.join(d, name)
            intent = _read_json(p) or {}
            pid = int(intent.get("pid", 0) or 0)
            if pid and _alive(pid):
                continue            # a sibling building right now
            for ent in intent.get("entries", ()):
                sig = ent.get("sig")
                if sig and sig not in quarantine:
                    quarantine.add(sig)
                    adopted.append(dict(ent))
                    _QUARANTINED.inc()
                    _record("quarantined",
                            f"orphan_intent:{ent.get('kernel', '?')}")
            try:
                os.remove(p)
            except OSError:
                pass
        if adopted:
            _atomic_json(os.path.join(d, "quarantine.json"),
                         {"signatures": sorted(quarantine)})
        _DIR_STATE["adopted"] = adopted
        return _DIR_STATE


def quarantine(sig: str) -> None:
    """Put ``sig`` into the quarantine ledger (persisted when the
    persistent layer is on)."""
    st = _ensure_dir()
    with _lock:
        _DIR_STATE["quarantine"].add(sig)
        if st is not None:
            _atomic_json(os.path.join(st["path"], "quarantine.json"),
                         {"signatures": sorted(st["quarantine"])})


def quarantined_signatures() -> tuple:
    with _lock:
        return tuple(sorted(_DIR_STATE["quarantine"]))


def _write_intent(jobs) -> None:
    d = cache_dir()
    if d:
        _atomic_json(_intent_path(d), {
            "pid": os.getpid(),
            "entries": [{"kernel": j.label, "sig": j.sig} for j in jobs]})


def _clear_intent() -> None:
    d = cache_dir()
    if d:
        try:
            os.remove(_intent_path(d))
        except OSError:
            pass


def _manifest_add(label: str, path: str, poison: bool = False) -> None:
    st = _ensure_dir()
    if st is None:
        return
    with _lock:
        ent = {"kernel": label, "sha256": _file_sha(path)}
        if poison:
            # the injector's ``corrupt``: a wrong hash, which the next
            # process must drop (and rebuild), never trust
            ent["sha256"] = "0" * 64
            _record("corrupt", "poisoned_manifest")
        st["manifest"][os.path.basename(path)] = ent
        _atomic_json(os.path.join(st["path"], "manifest.json"),
                     st["manifest"])


def expected_warm() -> int:
    """Manifest entries that passed their hash when the directory was
    scanned: the libraries a relaunch loads without building."""
    st = _ensure_dir()
    return 0 if st is None else len(st["manifest"])


def usable(path: str) -> bool:
    """Whether the library at ``path`` may be loaded as it is: it exists
    and, under the persistent layer, its bytes hash to its manifest
    entry.  A library that fails is dropped (counted) so the caller
    rebuilds it."""
    st = _ensure_dir() if cache_dir() else None
    if not os.path.exists(path):
        return False
    if st is None:
        return True
    fname = os.path.basename(path)
    with _lock:
        ent = st["manifest"].get(fname)
        if ent is not None and ent.get("sha256") == _file_sha(path):
            return True
        _drop(fname, st["path"])
        _atomic_json(os.path.join(st["path"], "manifest.json"),
                     st["manifest"])
    return False


# ---------------------------------------------------------------------------
# the guarded build
# ---------------------------------------------------------------------------

def _record(kind: str, action: str) -> None:
    from . import recovery
    recovery._record(SITE, kind, action)


class Job:
    """One library build: ``cmd`` writes ``tmp``, which is renamed to
    ``target`` when the compiler succeeds.  ``sig`` is the build's
    source-and-flags digest (the quarantine's key)."""

    __slots__ = ("label", "sig", "cmd", "tmp", "target", "proc", "t0",
                 "log", "kind")

    def __init__(self, label: str, sig: str, cmd, tmp: str, target: str):
        self.label, self.sig, self.cmd = label, sig, list(cmd)
        self.tmp, self.target = tmp, target
        self.proc = self.t0 = self.log = self.kind = None


#: what a stalled build runs in place of its compiler: a process that
#: never finishes
_HUNG = (sys.executable, "-c", "import time\nwhile True: time.sleep(60)")


def _start(job: Job) -> None:
    cmd = list(_HUNG) if job.kind == "stall" else job.cmd
    job.t0 = time.perf_counter()
    try:
        job.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise KernelError(f"cannot start the compiler of {job.label}: "
                          f"{e}") from e


def _kill_all(jobs) -> None:
    for j in jobs:
        if j.proc is not None and j.proc.poll() is None:
            j.proc.kill()
            j.proc.communicate()


def build_all(jobs) -> None:
    """Run the builds of ``jobs`` at once, one compiler process each, and
    wait for them all.  Guarded (:func:`armed`): a quarantined build
    raises ``CompileQuarantinedError`` before any starts; the intent is
    written first and cleared after; the injector is probed once per
    build; the watchdog kills every build past its budget and raises
    ``CompileTimeoutError``; each new library's sha256 enters the
    manifest.  A compiler that fails raises ``KernelError``; one killed
    by a signal (a compiler crash, recovery.is_compiler_crash) carries
    the signal's name on the error's ``signal``."""
    jobs = list(jobs)
    if not jobs:
        return
    guarded = armed()
    st = _ensure_dir() if guarded else None
    if guarded:
        with _lock:
            bad = [j for j in jobs if j.sig in _DIR_STATE["quarantine"]]
        if bad:
            j = bad[0]
            _record("quarantined", "raised")
            raise CompileQuarantinedError(
                f"kernel build {j.label} ({j.sig}) is quarantined: a "
                "predecessor process died while building it (an orphaned "
                "compile intent); building it again would repeat the "
                "crash", site=SITE, signature=j.sig)
    if st is not None:
        _write_intent(jobs)
    try:
        if guarded:
            from . import recovery
            for j in jobs:
                # kill fires here, with the intent on disk: the crash
                # the quarantine exists for
                j.kind = recovery.maybe_inject(SITE,
                                               intercept=("corrupt", "stall"))
        os.makedirs(os.path.dirname(jobs[0].target), exist_ok=True)
        for j in jobs:
            _start(j)
        t = float(config.COMPILE_TIMEOUT_S or 0)
        if t <= 0 and any(j.kind == "stall" for j in jobs):
            t = 2.0     # an injected stall surfaces typed, budget or not
        deadline = time.perf_counter() + t if t > 0 else None
        for j in jobs:
            try:
                left = None if deadline is None else max(
                    deadline - time.perf_counter(), 0.0)
                j.log, _ = j.proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                _kill_all(jobs)
                _TIMEOUTS.inc()
                _record("stall", "watchdog")
                raise CompileTimeoutError(
                    f"compile watchdog: the build of {j.label} did not "
                    f"finish within {t:g}s — the compiler is hung",
                    site=SITE, signature=j.sig) from None
            secs = time.perf_counter() - j.t0
            _SECONDS.inc(secs)
            _EVENTS.inc()
            build_seconds[j.label] = secs
    finally:
        _kill_all(jobs)
        if st is not None:
            _clear_intent()
    failed, killed_by = [], None
    for j in jobs:
        rc = j.proc.returncode
        if rc != 0:
            if rc < 0:
                killed_by = killed_by or signal.Signals(-rc).name
                why = f"compiler killed by signal {signal.Signals(-rc).name}"
            else:
                why = f"compiler exit {rc}"
            failed.append(f"{j.label} ({why}):\n{j.log}")
            continue
        os.replace(j.tmp, j.target)
        _MISS.inc()
        if st is not None:
            _manifest_add(j.label, j.target, poison=(j.kind == "corrupt"))
    if failed:
        raise KernelError("kernel build failed: " + "\n".join(failed),
                          signal=killed_by)


# ---------------------------------------------------------------------------
# the ledger of loaded libraries
# ---------------------------------------------------------------------------

def live(label: str):
    """The loaded library of ``label`` (a hit), or None when it is not
    loaded."""
    with _lock:
        lib = _LEDGER.get(label)
        if lib is not None:
            _HIT.inc()
        return lib


def admit(label: str, path: str, opener, built: bool):
    """Load ``path`` with ``opener(path)`` and enter it into the ledger;
    ``built`` says whether this call's build made it (else the load is a
    hit)."""
    lib = opener(path)
    with _lock:
        _LEDGER[label] = lib
        if not built:
            _HIT.inc()
    return lib


def live_programs() -> int:
    """Loaded kernel libraries (the ``compile_programs_live`` gauge)."""
    with _lock:
        return len(_LEDGER)


metrics.gauge("compile_programs_live",
              help="loaded kernel libraries (the compile ledger)",
              fn=live_programs)


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def stats() -> dict:
    """The facade's counters, under the reference's keys (the serving
    tier's ``stats()["compile"]`` and ``bench_detail``'s block)."""
    return {
        "programs_live": live_programs(),
        "cache_hits": _HIT.value,
        "cache_misses": _MISS.value,
        "cache_evictions": _EVICT.value,
        "mesh_table_evictions": _MESH_EVICT.value,
        "compile_seconds": round(float(_SECONDS.value), 6),
        "compile_events": _EVENTS.value,
        "quarantined": len(_DIR_STATE["quarantine"]),
        "quarantine_adoptions": _QUARANTINED.value,
        "watchdog_timeouts": _TIMEOUTS.value,
        "manifest_drops": _MANIFEST_DROPS.value,
        "expected_warm": (len(_DIR_STATE["manifest"])
                          if _DIR_STATE["path"] else 0),
    }


def reset_stats() -> None:
    """Zero the counters (the ledger and the persistent state stay)."""
    for c in (_HIT, _MISS, _EVICT, _MESH_EVICT, _SECONDS, _EVENTS,
              _QUARANTINED, _TIMEOUTS, _MANIFEST_DROPS):
        c.reset()
    build_seconds.clear()
