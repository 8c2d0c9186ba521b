"""Chaos soak: seeded fault schedules against the port in child processes
that are SIGKILLed, SIGTERMed and resumed (port of
``scripts/chaos_soak.py``).

Seeded random fault schedules over the injector sites (the
``CYLON_TPU_TORCH_FAULTS`` grammar, exec/recovery.py) are driven against
a TPC-H-shaped pipelined ``lineitem ⋈ orders`` → ``GroupBySink`` workload
running in a CHILD process, so the ``kill`` kind (SIGKILL mid-range-loop)
and the ``ResumableAbort`` path can be survived and resumed:

* every schedule must end in a BIT-EQUAL result (a sha256 over the
  sorted result columns' raw bytes against an uninjected baseline),
  possibly after the retry ladder degraded the run in process;
* or in a hard crash / typed ``ResumableAbort`` (exit 17) — then the
  child reruns with ``CYLON_TPU_TORCH_RESUME=1`` against the surviving
  checkpoint directory and THAT run must be bit-equal, fast-forwarding
  past committed pieces (``resume_fast_forwarded_pieces``);
* recovery-event counts stay bounded (:data:`MAX_RECOVERY_EVENTS`).

The first four schedules are pinned (kill-and-resume, corrupt-on-write
then kill, corrupt-on-load during the resume, and kill-and-resume with
the windowed-gather kernel's dispatch switched off —
``CYLON_TPU_TORCH_WINDOWED_GATHER=0`` must stay bit-equal to the
baseline, which runs with it on); the rest are drawn from ``--seed``.
Before any schedule runs the parent holds the baseline against a numpy
oracle (an int64 sort and ``np.add.reduceat``, exact).  On the card the
baseline child must launch both kernels (K1, the windowed gather, and
K2, the splitter probe) and holds its first launch of each bit-equal to
the plain version; every child reports its launches, and every child
but the ``--compile`` flow's shares one compile directory
(``CYLON_TPU_TORCH_COMPILE_CACHE_DIR``) made by the parent, so only the
first builds the kernels.

Flows, each pinned (not drawn), each the reference's flag:

* ``--elastic``: a two-stage workload checkpointed at W = 2, killed mid
  stage 2 and resumed at W = 1 (stage 1 re-shards), at W = 2 (plain
  fast-forward), killed again at W = 1 and resumed at W = 2; a
  ``ckpt.reshard`` corruption and a kill inside the re-shard; SIGTERM
  under the preemption grace (typed ``ResumableAbort``, exit 17).
* ``--oocore``: ``CYLON_TPU_TORCH_HBM_BUDGET``/``_HOST_BUDGET`` caps
  force the disk tier; ENOSPC mid-demote, corrupt-on-promote, a kill
  mid-demote and resume, and the unarmed leg with zero disk events.
* ``--audit``: the armed clean run, one-shot and persistent
  ``exchange.corrupt``, the same corruption under the skew split and
  under two slices (``CYLON_TPU_TORCH_SLICES=2``), the unarmed leg.
* ``--compile``: the kernel builds' lifecycle (exec/compiler.py) with a
  fresh compile directory per leg: a kill inside a build, corrupt-on-
  build, a stall under the watchdog, the unarmed leg.  The worker adds
  a second stage that ingests a hashed-string column (the ``g++`` string
  hash's build) after the pipelined stage has committed its pieces.
* ``--skew``: the adaptive skew split's voted plan through a capacity
  fault, a spill fault and a kill; the armed run at skew 0 votes
  nothing.
* ``--multislice``: two slices of 2 ranks in one process; the two-hop
  route bit-equal to the flat one with 1/R of its cross-slice messages,
  a capacity fault, a whole-slice kill resumed on one slice, the unarmed
  single-slice leg.
* ``--stream``: a micro-batch stream killed mid-ingest and resumed.
* ``--concurrent K``: K serving tenants, one killed mid-query, every
  answer bit-equal to its solo run after the resume.
* ``--fleet``: preempt and requeue, a kill inside the preemption drain,
  a fleet resize W = 4 → 2, a typed admission deadline.

Deviations from the reference (each is forced by the port):

* The result digest reads ``Table.to_pydict()`` (the card's machine has
  no pandas): the rows sorted by the key, the columns in name order, each
  column's raw bytes — the reference's sha for the same rows.
* The soak workload's orders side names its key ``l_orderkey``, so the
  piece joins defer and the sink runs the fused pushdown and K1
  (:func:`_make_workload`); its output is the reference's.
* The fourth pinned schedule switches the windowed-gather kernel off:
  the reference's ``CYLON_TPU_PACKED_OVERLAP`` selects a second piece
  scheduler the port does not have.
* ``CYLON_TPU_EXCHANGE_GUARD_CPU`` has no counterpart: the port's
  receive guard probes its injector site on the CPU too; nor has
  ``CYLON_TPU_COMPILE_BUDGET`` (the port's compile tier has no budget).
* ``--compile``'s kill leg ends typed.  A quarantine keys on the kernel's
  source-and-flags digest, not on a shape, so no re-planned chunk count
  skirts it: the rerun against the same directory ends in
  ``CompileQuarantinedError`` (exit 4) or, checkpoints armed, a
  ``ResumableAbort`` (exit 17), and a third run with a fresh compile
  directory resumes bit-equal with fast-forwarded pieces.  The killed
  build is found by order (the corrupt leg reports the build order), and
  the intent journal is ``intent.<pid>.json``.
* ``--fleet``'s deadline leg repeats tA's query until twice the
  deadline has passed: the port runs tA in a fraction of the 0.3 s
  deadline, so tB would never wait that long.

Usage::

    python -m cylon_tpu_torch.exec.chaos_soak --device cpu --seed 7
    python -m cylon_tpu_torch.exec.chaos_soak --device cpu --seed 5 \\
        --schedules 6 --rows 1200 --chunks 3
    python -m cylon_tpu_torch.exec.chaos_soak --rows 67108864 --chunks 4 \\
        --world 4 --seed 5 --schedules 6          # on the card
    python -m cylon_tpu_torch.exec.chaos_soak --device cpu --elastic \\
        --rows 1000 --chunks 3

``--device`` defaults to ``cuda``; without a card the soak exits nonzero
with ``DeviceUnavailableError``.  A child whose kernel build or launch
fails is a failed schedule.  Exit status 0 = every schedule converged;
1 otherwise.  The last line of output is one JSON object.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

#: the directory holding the ``cylon_tpu_torch`` package: the children's
#: working directory and import path
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "cylon_tpu_torch.exec.chaos_soak"

#: (site, eligible kinds) for the randomized draws — ``stall``/``desync``
#: are excluded: a desync is terminal by design (never retried), so a
#: schedule containing one cannot converge and would only test the
#: harness, not the ladder
SITE_KINDS = [
    ("shuffle.recv_guard", ["predicted", "device_oom", "capacity"]),
    ("join.piece_cap", ["capacity"]),
    ("groupby.device_oom", ["device_oom", "predicted"]),
    ("spill.evict", ["predicted"]),
    ("ckpt.write", ["corrupt", "device_oom", "kill"]),
    ("ckpt.load", ["corrupt"]),
]

#: per-run ceiling on logged recovery events: the ladder's schedule is
#: spill + 2 chunk rungs (+1 cap rung) per operator — a soak workload
#: crossing this is looping, not recovering
MAX_RECOVERY_EVENTS = 8

RESUMABLE_EXIT = 17
#: the ``--compile`` worker's typed exits: a compile watchdog timeout, a
#: quarantined build with no checkpoints to resume from
COMPILE_TIMEOUT_EXIT = 3
QUARANTINED_EXIT = 4

#: a child's time limit; one past it is killed and counts as a failure
CHILD_TIMEOUT_S = 600

#: the workload's seeds (the reference's)
SOAK_SEED = 20260803
STREAM_SEED = 20260804
ELASTIC_SEED = 20260804
SKEW_SEED = 20260805
TOPO_SEED = 20260806
COMPILE_SEED = 20260807

#: the switches armed per leg only: a child never inherits them from the
#: parent's environment (a stale budget, slice map, fault spec or audit
#: switch would cap, re-route or inject into the baseline legs)
PER_LEG_VARS = (
    "CYLON_TPU_TORCH_FAULTS", "CYLON_TPU_TORCH_CKPT_DIR",
    "CYLON_TPU_TORCH_RESUME", "CYLON_TPU_TORCH_TRACE",
    "CYLON_TPU_TORCH_PREEMPT_GRACE_S", "CYLON_TPU_TORCH_HBM_BUDGET",
    "CYLON_TPU_TORCH_HOST_BUDGET", "CYLON_TPU_TORCH_SPILL_DIR",
    "CYLON_TPU_TORCH_SPILL", "CYLON_TPU_TORCH_SLICES",
    "CYLON_TPU_TORCH_TOPO_SHUFFLE", "CYLON_TPU_TORCH_SKEW_SPLIT",
    "CYLON_TPU_TORCH_WINDOWED_GATHER", "CYLON_TPU_TORCH_FLEET_CASE",
    "CYLON_TPU_TORCH_FLEET_TARGET", "CYLON_TPU_TORCH_ADMISSION_TIMEOUT_S",
    "CYLON_TPU_TORCH_COMPILE_CACHE_DIR", "CYLON_TPU_TORCH_COMPILE_TIMEOUT_S",
    "CYLON_TPU_TORCH_AUDIT", "CYLON_TPU_TORCH_WATCHDOG_S",
    "CYLON_TPU_TORCH_EXCHANGE_RECV_BUDGET", "CYLON_TPU_TORCH_METRICS_JSON",
    "CYLON_TPU_TORCH_STRING_HASH_MIN", "CYLON_TPU_TORCH_STRING_HASH_RATIO")

#: every child's launches of each kernel, summed (parent side)
_LAUNCHES = {"windowed_gather": 0, "splitter_probe": 0}
#: children spawned and their wall seconds, and when the flow started
#: (parent side)
_CHILDREN = {"n": 0, "seconds": 0.0, "t0": time.perf_counter()}


# ---------------------------------------------------------------------------
# worker: one workload run in this process (spawned by the parent)
# ---------------------------------------------------------------------------

def _result_sha(cols: dict) -> str:
    """sha256 over ``cols`` (already in row order), column by column in
    name order, each column's raw bytes; a string column's values joined
    by NUL and UTF-8 encoded."""
    import numpy as np
    h = hashlib.sha256()
    for name in sorted(cols):
        col = np.asarray(cols[name])
        if col.dtype == object:
            h.update("\0".join(map(str, col)).encode())
        else:
            h.update(np.ascontiguousarray(col).tobytes())
    return h.hexdigest()


def _sorted_pydict(table, key: str) -> dict:
    """The table's live rows as numpy columns, sorted by ``key`` (unique
    in every result here)."""
    import numpy as np
    cols = table.to_pydict()
    order = np.argsort(cols[key], kind="stable")
    return {k: np.asarray(v)[order] for k, v in cols.items()}


def _kernel_launches() -> dict:
    from ..ops import splitter_probe as sp
    from ..ops import windowed_gather as wg
    return {"windowed_gather": int(wg.COUNTS["launches"]),
            "splitter_probe": int(sp.COUNTS["launches"])}


def _check_first_launches(checks: dict) -> None:
    """Hold the first launch of each kernel in this process bit-equal to
    its plain version on the same inputs: the launch on the workload's
    path is compared, no extra launch is made."""
    import torch

    from ..ops import splitter_probe as sp
    from ..ops import windowed_gather as wg
    k1, k2 = wg.windowed_take_t, sp.count_ge_splitters

    def take(lanes, idx, window):
        out, ok = k1(lanes, idx, window)
        if "k1" not in checks and out.is_cuda:
            ls = wg.as_lanes(lanes)
            p_out, p_ok = wg.windowed_take_plain(ls, idx, window)
            same = bool(ok) == bool(p_ok) and torch.equal(out, p_out)
            checks["k1"] = {
                "L": len(ls), "M": int(ls[0].shape[0]),
                "S": int(idx.shape[0]), "window": int(window),
                "bit_equal": bool(same),
                "max_abs_err": int((out.to(torch.int64)
                                    - p_out.to(torch.int64)).abs().max())
                if out.numel() else 0}
        return out, ok

    def probe(ops, sops):
        got = k2(ops, sops)
        if "k2" not in checks and got.is_cuda:
            want = sp.count_ge_splitters_plain(ops, sops)
            checks["k2"] = {
                "K": len(ops), "cap": int(ops[0].shape[0]),
                "S": int(sops[0].shape[0]),
                "bit_equal": bool(torch.equal(got, want)),
                "max_abs_err": int((got.to(torch.int64)
                                    - want.to(torch.int64)).abs().max())
                if got.numel() else 0}
        return got

    wg.windowed_take_t = take
    sp.count_ge_splitters = probe


def _make_workload(ct, env, seed: int, rows: int):
    """The TPC-H-shaped attempt: orders ⋈ lineitem on the order key,
    aggregated per order — integer "money", so every retry and restore
    path is exactly bit-comparable.  Seeded: the resumed process rebuilds
    the identical inputs, which is what makes the stage plan tokens
    match.  The orders side names its key ``l_orderkey`` (the reference:
    ``o_orderkey``): a join on one key name coalesces it and defers each
    piece, so the ``GroupBySink`` takes the fused pushdown, whose
    run-start gather is K1; on two key names every piece materializes and
    groups by sort, in both packages, and K1 never runs.  The sink's
    output (names and values) is the reference's."""
    import numpy as np

    from . import GroupBySink, pipelined_join

    def attempt(nc):
        rng = np.random.default_rng(seed)
        n_ord = max(rows // 4, 64)
        orders = ct.Table.from_pydict(
            {"l_orderkey": np.arange(n_ord, dtype=np.int64),
             "o_shippriority": rng.integers(0, 5, n_ord).astype(np.int64)},
            env)
        lineitem = ct.Table.from_pydict(
            {"l_orderkey": rng.integers(0, n_ord, rows).astype(np.int64),
             "l_quantity": rng.integers(1, 51, rows).astype(np.int64),
             "l_extendedprice": rng.integers(900_00, 10_500_00,
                                             rows).astype(np.int64)},
            env)
        sink = GroupBySink("l_orderkey", [("l_quantity", "sum"),
                                          ("l_extendedprice", "sum")])
        pipelined_join(lineitem, orders, "l_orderkey", "l_orderkey",
                       how="inner", n_chunks=nc, sink=sink)
        return sink.finalize()
    return attempt


def oracle_columns(seed: int, rows: int) -> dict:
    """The core workload's answer from numpy alone: the same seeded
    draws, every lineitem row matching its one order, then per order the
    sums, by an int64 sort and ``np.add.reduceat`` (exact)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_ord = max(rows // 4, 64)
    rng.integers(0, 5, n_ord)                  # o_shippriority
    key = rng.integers(0, n_ord, rows).astype(np.int64)
    qty = rng.integers(1, 51, rows).astype(np.int64)
    price = rng.integers(900_00, 10_500_00, rows).astype(np.int64)
    # any order within a key gives the same integer sums
    order = np.argsort(key)
    key = key[order]
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    return {"l_orderkey": key[starts],
            "l_quantity_sum": np.add.reduceat(qty[order], starts),
            "l_extendedprice_sum": np.add.reduceat(price[order], starts)}


def worker(args) -> int:
    import cylon_tpu_torch as ct

    from . import checkpoint, memory, recovery
    from ..status import ResumableAbort

    recovery.install_faults(None)   # validate the env grammar up front
    env = ct.CylonEnv(ct.VirtualMeshConfig(args.world, device=args.device))
    checks: dict = {}
    if args.check_kernels:
        _check_first_launches(checks)

    if args.stream:
        return _worker_stream(args, env)
    if args.elastic:
        return _worker_elastic(args, env)
    if args.skew:
        return _worker_skew(args, env)
    if args.multislice:
        return _worker_topo(args, env)
    if args.compile_flow:
        return _worker_compile(args, env)
    if args.fleet:
        return _worker_fleet(args, env)
    if args.concurrent > 1:
        return _worker_concurrent(args, env)

    attempt = _make_workload(ct, env, SOAK_SEED, args.rows)
    try:
        out = recovery.run_with_recovery(
            lambda: attempt(args.chunks), True, attempt, "soak", env=env)
    except ResumableAbort as e:
        _emit({"resumable": True, "token": e.token,
               "events": len(recovery.recovery_events())})
        return RESUMABLE_EXIT

    cols = _sorted_pydict(out, "l_orderkey")
    _emit({
        "ok": True, "sha": _result_sha(cols),
        "rows": int(len(cols["l_orderkey"])),
        "columns": sorted(cols),
        "events": len(recovery.recovery_events()),
        "event_list": recovery.recovery_events(),
        "first_launch": checks,
        # disk-tier counters: the --oocore flow asserts these
        **{k: v for k, v in memory.stats().items()
           if k.startswith(("disk_", "bytes_to_disk", "bytes_from_disk"))},
        **checkpoint.stats(),
    })
    return 0


def _emit(obj: dict) -> None:
    """A worker's result line, with this process's kernel launches."""
    print(json.dumps({**obj, "kernel_launches": _kernel_launches()},
                     default=str), flush=True)


def _worker_stream(args, env) -> int:
    """The streaming-ingest workload (stream/): a seeded micro-batch stream
    appended into a StreamTable and an IncrementalView whose absorbed
    partials commit durably per batch (one checkpoint piece per append
    with ``CYLON_TPU_TORCH_CKPT_DIR`` armed).  A SIGKILL mid-ingest
    crashes the process between commits; the resumed rerun replays the
    same stream, fast-forwards the committed view state (ffwd > 0), and
    the final view must be bit-equal to the uninterrupted run."""
    import numpy as np

    from . import checkpoint, recovery
    from ..stream import IncrementalView, StreamTable

    rng = np.random.default_rng(STREAM_SEED)
    st = StreamTable(env, key="k", name="soak")
    view = IncrementalView(
        st, "k", [("v", "sum"), ("v", "mean"), ("v", "var")],
        name="soak_view", env=env)
    n_batches = max(args.rows // 500, 6)
    for _ in range(n_batches):
        st.append({"k": rng.integers(0, 64, 500).astype(np.int64),
                   "v": rng.integers(-100, 100, 500).astype(np.float64)})
    cols = _sorted_pydict(view.read(), "k")
    _emit({
        "ok": True, "sha": _result_sha(cols), "rows": int(len(cols["k"])),
        "batches": n_batches, "ffwd": view.fast_forwarded,
        "events": len(recovery.recovery_events()),
        **checkpoint.stats(),
    })
    return 0


def run_stream(args) -> int:
    """The ``--stream`` flow: baseline → SIGKILL mid-ingest with
    checkpoints armed → resume, which must fast-forward the committed
    view state (ffwd > 0) and end bit-equal; a predicted fault at the
    append site (no retry rung) must surface typed."""
    own_workdir = args.workdir is None
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_stream_")
    failures: list = []

    base_p, base = _spawn(args, os.path.join(args.workdir, "base"), "",
                          resume=False, stream=True)
    if base_p.returncode != 0 or not base or not base.get("sha"):
        return _baseline_failed(args, base_p, "stream", own_workdir)
    print(f"# stream baseline sha={base['sha'][:16]} "
          f"batches={base['batches']}", flush=True)

    # pinned: a hard kill at the Nth append, and one during the view's
    # checkpoint write — both mid-ingest, both must resume
    for faults in ("stream.append::3=kill", "ckpt.write::2=kill"):
        killdir = os.path.join(args.workdir,
                               faults.split("=")[0].replace(":", "_"))
        p, _ = _spawn(args, killdir, faults, resume=False, stream=True)
        if p.returncode != -9:
            failures.append(
                f"stream kill ({faults!r}) did not crash the process "
                f"(rc={p.returncode})")
            continue
        if not os.path.exists(os.path.join(killdir,
                                           "TRACE_POSTMORTEM.json")):
            failures.append(f"stream kill ({faults!r}) left no "
                            "TRACE_POSTMORTEM.json breadcrumb")
        p2, info2 = _spawn(args, killdir, "", resume=True, stream=True)
        if p2.returncode != 0 or not info2:
            failures.append(f"stream resume ({faults!r}) failed "
                            f"rc={p2.returncode}: {_tail(p2)}")
        elif info2.get("sha") != base["sha"]:
            failures.append(
                f"stream resume ({faults!r}) diverged: {info2}")
        elif not info2.get("ffwd"):
            failures.append(
                f"stream resume ({faults!r}) recomputed committed "
                f"window state: {info2}")
        else:
            print(f"# stream {faults!r} + resume -> ok "
                  f"(ffwd={info2['ffwd']})", flush=True)

    # a predicted fault at the append site surfaces TYPED: an append has
    # no retry rung, so the contract is a loud typed abort
    p, info = _spawn(args, os.path.join(args.workdir, "pred"),
                     "stream.append::2=predicted", resume=False,
                     stream=True)
    if p.returncode == 0:
        failures.append(
            f"stream predicted fault was swallowed (rc=0): {info}")
    elif "PredictedResourceExhausted" not in (p.stdout + p.stderr):
        failures.append(
            f"stream predicted fault did not surface typed "
            f"(rc={p.returncode})")
    else:
        print("# stream predicted-fault schedule -> ok (typed abort)",
              flush=True)

    return _finish(args, own_workdir, {"stream": True}, failures)


def _worker_compile(args, env) -> int:
    """The compile-lifecycle workload (exec/compiler.py): stage 1 is the
    standard join+sink under the ladder (its pieces checkpointed), stage
    2 ingests a hashed-string column (``native/``'s ``g++`` build) and
    joins it onto stage 1's result, under a ladder of its own without a
    fallback, so a quarantined build there becomes a ``ResumableAbort``
    with stage 1 committed.  The compile tier is armed per leg through
    the environment.  The JSON line reports the sha, the facade's
    counters, the order of the builds and the persistent directory's
    file listing.  A watchdog timeout exits 3, a quarantine with no
    checkpoints 4, a ``ResumableAbort`` 17 — all typed, never hangs."""
    import numpy as np

    import cylon_tpu_torch as ct

    from . import checkpoint, compiler, recovery
    from .. import config
    from ..status import (CompileQuarantinedError, CompileTimeoutError,
                          ResumableAbort)

    # every stage-2 string column hashes (core/column: rows and ratio)
    config.STRING_HASH_MIN_ROWS = 1
    attempt = _make_workload(ct, env, COMPILE_SEED, args.rows)

    def strings(out):
        keys = out.to_pydict()["l_orderkey"]
        perm = np.random.default_rng(COMPILE_SEED).permutation(len(keys))
        names = ct.Table.from_pydict(
            {"o_orderkey": keys,
             "o_clerk": np.array([f"Clerk#{i:09d}" for i in perm],
                                 dtype=object)}, env)
        return ct.join_tables(out, names, "l_orderkey", "o_orderkey",
                              how="inner")

    def stats():
        d = compiler.cache_dir()
        return {"armed": bool(compiler.armed()),
                "cache_files": (sorted(os.listdir(d))
                                if d and os.path.isdir(d) else []),
                "build_order": list(compiler.build_seconds),
                **compiler.stats()}

    try:
        out = recovery.run_with_recovery(
            lambda: attempt(args.chunks), True, attempt, "soak", env=env)
        joined = recovery.run_with_recovery(
            lambda: strings(out), False, None, "soak.strings", env=env)
    except CompileTimeoutError as e:
        _emit({"timeout_typed": True, "site": e.site,
               "signature": getattr(e, "signature", None), **stats()})
        return COMPILE_TIMEOUT_EXIT
    except CompileQuarantinedError as e:
        _emit({"quarantined_typed": True,
               "signature": getattr(e, "signature", None), **stats()})
        return QUARANTINED_EXIT
    except ResumableAbort as e:
        _emit({"resumable": True, "token": e.token,
               "cause": type(e.__cause__).__name__,
               "events": len(recovery.recovery_events()),
               **checkpoint.stats(), **stats()})
        return RESUMABLE_EXIT
    cols = _sorted_pydict(joined, "l_orderkey")
    _emit({
        "ok": True, "sha": _result_sha(cols),
        "rows": int(len(cols["l_orderkey"])),
        "events": len(recovery.recovery_events()),
        **checkpoint.stats(), **stats(),
    })
    return 0


def run_compile(args) -> int:
    """The ``--compile`` flow (module docstring).  The corrupt leg runs
    first on a fresh directory and reports the build order; the kill leg
    then kills the string hash's build, the one stage 2 makes after
    stage 1 committed its pieces."""
    own_workdir = args.workdir is None
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_compile_")
    failures: list = []

    def spawn(tag, faults, cache_dir=None, extra=None, resume=False,
              workdir=None):
        env_extra = {}
        if cache_dir is not None:
            env_extra["CYLON_TPU_TORCH_COMPILE_CACHE_DIR"] = cache_dir
        env_extra.update(extra or {})
        return _spawn(args, workdir or os.path.join(args.workdir, tag),
                      faults, resume=resume, extra_env=env_extra,
                      compile_flow=True)

    # unarmed baseline: the bit-equality oracle AND the zero-write leg
    p, base = spawn("base", "")
    if p.returncode != 0 or not base or not base.get("sha"):
        return _baseline_failed(args, p, "compile", own_workdir)
    print(f"# compile unarmed baseline sha={base['sha'][:16]}", flush=True)
    if base.get("armed"):
        failures.append(f"facade armed with no compile env vars: {base}")
    if base.get("quarantined") or base.get("watchdog_timeouts") \
            or base.get("expected_warm"):
        failures.append(f"unarmed run exercised armed-only state: {base}")

    # corrupt-on-build: the poisoned manifest entry fails its content
    # hash at the relaunch's arm time — dropped to a clean rebuild,
    # bit-equal, never a wrong library
    order: list = []
    cdir = os.path.join(args.workdir, "corrupt", "ccache")
    p, info = spawn("corrupt", "compile.build::1=corrupt", cache_dir=cdir)
    if p.returncode != 0 or not info or info.get("sha") != base["sha"]:
        failures.append(f"corrupt-on-build leg diverged "
                        f"(rc={p.returncode}): {info}\n{_tail(p)}")
    else:
        order = list(info.get("build_order") or [])
        p2, info2 = spawn("corrupt_rerun", "", cache_dir=cdir)
        if p2.returncode != 0 or not info2 \
                or info2.get("sha") != base["sha"]:
            failures.append(f"relaunch over poisoned manifest diverged "
                            f"(rc={p2.returncode}): {info2}")
        elif not info2.get("manifest_drops"):
            failures.append(f"poisoned manifest entry not dropped at "
                            f"arm time: {info2}")
        else:
            print(f"# compile corrupt + relaunch -> ok (drops="
                  f"{info2['manifest_drops']} builds={order})", flush=True)

    # kill mid-build → orphan intent → the rerun adopts it into the
    # quarantine and ends typed; a fresh directory then resumes
    if "strhash" not in order:
        failures.append(f"no string-hash build in the build order {order}")
    else:
        kill_nth = order.index("strhash") + 1
        kdir = os.path.join(args.workdir, "kill", "ccache")
        p, _ = spawn("kill", f"compile.build::{kill_nth}=kill",
                     cache_dir=kdir)
        intents = (sorted(f for f in os.listdir(kdir)
                          if f.startswith("intent.") and f.endswith(".json"))
                   if os.path.isdir(kdir) else [])
        if p.returncode != -9:
            failures.append(f"kill mid-compile did not crash the process "
                            f"(rc={p.returncode})")
        elif not intents:
            failures.append("killed compile left no intent journal on disk")
        else:
            rdir = os.path.join(args.workdir, "kill_rerun")
            p2, info2 = spawn("kill_rerun", "", cache_dir=kdir,
                              workdir=rdir)
            if p2.returncode not in (RESUMABLE_EXIT, QUARANTINED_EXIT) \
                    or not info2:
                failures.append(f"rerun after kill mid-compile did not end "
                                f"typed (rc={p2.returncode}): {info2}\n"
                                f"{_tail(p2)}")
            elif not info2.get("quarantine_adoptions"):
                failures.append(f"rerun never adopted the orphan intent: "
                                f"{info2}")
            elif not info2.get("quarantined"):
                failures.append(f"adopted orphan not quarantined: {info2}")
            elif info2.get("expected_warm") != kill_nth - 1:
                failures.append(f"rerun's warm expectations differ from the "
                                f"{kill_nth - 1} builds the killed run "
                                f"finished: {info2}")
            elif "quarantine.json" not in info2.get("cache_files", []):
                failures.append(f"quarantine not persisted: {info2}")
            else:
                p3, info3 = spawn(
                    "kill_resume", "", resume=True, workdir=rdir,
                    cache_dir=os.path.join(args.workdir, "kill_resume",
                                           "ccache"))
                if p3.returncode != 0 or not info3 \
                        or info3.get("sha") != base["sha"]:
                    failures.append(f"resume with a fresh compile directory "
                                    f"diverged (rc={p3.returncode}): "
                                    f"{info3}\n{_tail(p3)}")
                elif p2.returncode == RESUMABLE_EXIT \
                        and not info3.get("resume_fast_forwarded_pieces"):
                    failures.append(f"resume recomputed the committed "
                                    f"stage: {info3}")
                else:
                    print(f"# compile kill + rerun -> ok (typed rc="
                          f"{p2.returncode}, adoptions="
                          f"{info2['quarantine_adoptions']}, resume ffwd="
                          f"{info3.get('resume_fast_forwarded_pieces')})",
                          flush=True)

    # injected stall with the watchdog budget armed: typed
    # CompileTimeoutError (exit 3), never a hang — and the SAME directory
    # then reruns clean (a timeout does not poison the cache)
    sdir = os.path.join(args.workdir, "stall", "ccache")
    p, info = spawn("stall", "compile.build::1=stall", cache_dir=sdir,
                    extra={"CYLON_TPU_TORCH_COMPILE_TIMEOUT_S": "0.5"})
    if p.returncode != COMPILE_TIMEOUT_EXIT or not info \
            or not info.get("timeout_typed"):
        failures.append(f"stall did not surface a typed compile timeout "
                        f"(rc={p.returncode}): {info}\n{_tail(p)}")
    elif not info.get("watchdog_timeouts"):
        failures.append(f"watchdog timeout not counted: {info}")
    else:
        p2, info2 = spawn("stall_rerun", "", cache_dir=sdir)
        if p2.returncode != 0 or not info2 \
                or info2.get("sha") != base["sha"]:
            failures.append(f"rerun after stall diverged "
                            f"(rc={p2.returncode}): {info2}")
        elif info2.get("quarantine_adoptions"):
            failures.append(f"a watchdog timeout left an orphan intent "
                            f"(must clear in finally): {info2}")
        else:
            print("# compile stall -> ok (typed timeout, dir reruns "
                  "clean)", flush=True)

    return _finish(args, own_workdir, {"compile": True}, failures)


def _audit_counters() -> dict:
    from . import integrity
    return {f"audit_{k}": v for k, v in integrity.stats().items()
            if k in ("conservation_checks", "fingerprint_checks",
                     "fingerprint_votes", "violations",
                     "corruptions_injected")}


def _worker_skew(args, env) -> int:
    """The adaptive-skew-split workload (relational/skew.py): a monolithic
    skewed-key inner join + groupby-sum.  ``--skew-frac`` shapes the
    probe key column (0.0 = the unarmed contract leg);
    ``CYLON_TPU_TORCH_SKEW_SPLIT`` arms or disarms the route.  The JSON
    line reports the sha, the voted plan hash (None when the join ran
    unsplit) and the always-on exchange row counter."""
    import numpy as np

    import cylon_tpu_torch as ct

    from . import recovery
    from ..obs import metrics
    from ..relational import skew as skew_facade

    rng = np.random.default_rng(SKEW_SEED)
    n = max(args.rows, 2048)
    mv = max(int(n * 0.9), 8)
    hot = np.int64(mv // 2)
    lk = rng.integers(0, mv, n).astype(np.int64)
    if args.skew_frac > 0.0:
        lk = np.where(rng.random(n) < args.skew_frac, hot, lk)
    rk = rng.integers(0, mv, n).astype(np.int64)
    rk[rk == hot] = hot + 1
    rk[0] = hot
    lt = ct.Table.from_pydict(
        {"k": lk, "a": rng.integers(0, mv, n).astype(np.int64)}, env)
    rt = ct.Table.from_pydict(
        {"k": rk, "b": rng.integers(0, mv, n).astype(np.int64)}, env)

    # injected recoverable faults are handled by the operators' own
    # ladders inside these calls; a `kill` SIGKILLs mid-flight and the
    # parent reruns fresh
    j = ct.join_tables(lt, rt, "k", "k", how="inner")
    out = ct.groupby_aggregate(j, "k", [("a", "sum"), ("b", "sum")])
    plan = skew_facade.last_plan()
    cols = _sorted_pydict(out, "k")
    _emit({
        "ok": True, "sha": _result_sha(cols), "rows": int(len(cols["k"])),
        "events": len(recovery.recovery_events()),
        "event_list": recovery.recovery_events(),
        "plan_hash": (format(plan.plan_hash(), "016x")
                      if plan is not None else None),
        "skew_split_joins": int(metrics.counter("skew_split_joins").value),
        "exchange_rows": int(metrics.counter("exchange_rows_total").value),
        **_audit_counters(),
    })
    return 0


def _worker_topo(args, env) -> int:
    """The multi-slice topology workload (topo/): a monolithic join +
    groupby-sum whose route — flat or two-hop — follows
    ``CYLON_TPU_TORCH_SLICES`` / ``CYLON_TPU_TORCH_TOPO_SHUFFLE``.  The
    JSON line reports the sha, the voted topology plan hash (None when
    every exchange routed flat), the always-on exchange counters and the
    cross-slice ("dcn") tier counters."""
    import numpy as np

    import cylon_tpu_torch as ct

    from . import recovery
    from ..obs import metrics
    from ..topo import model as topo_model

    rng = np.random.default_rng(TOPO_SEED)
    n = max(args.rows, 2048)
    mv = max(int(n * 0.9), 8)
    lt = ct.Table.from_pydict(
        {"k": rng.integers(0, mv, n).astype(np.int64),
         "a": rng.integers(0, mv, n).astype(np.int64)}, env)
    rt = ct.Table.from_pydict(
        {"k": rng.integers(0, mv, n).astype(np.int64),
         "b": rng.integers(0, mv, n).astype(np.int64)}, env)
    j = ct.join_tables(lt, rt, "k", "k", how="inner")
    out = ct.groupby_aggregate(j, "k", [("a", "sum"), ("b", "sum")])
    plan = topo_model.last_plan()
    cols = _sorted_pydict(out, "k")

    def c(name):
        return int(metrics.counter(name).value)

    _emit({
        "ok": True, "sha": _result_sha(cols), "rows": int(len(cols["k"])),
        "events": len(recovery.recovery_events()),
        "event_list": recovery.recovery_events(),
        "topo_plan_hash": (format(plan.plan_hash(), "016x")
                           if plan is not None else None),
        "topo_plans_voted": c("topo_plans_voted"),
        "exchange_rows": c("exchange_rows_total"),
        "exchange_count": c("exchange_count"),
        "dcn_rows": c("exchange_dcn_rows_total"),
        "dcn_messages": c("exchange_dcn_messages_total"),
        "dcn_wire_bytes": c("exchange_dcn_wire_bytes_total"),
        **_audit_counters(),
    })
    return 0


def run_multislice(args) -> int:
    """The ``--multislice`` flow: world 4 in one process, two slices of 2
    (``CYLON_TPU_TORCH_SLICES=2``); R = ranks per slice = 2."""
    own_workdir = args.workdir is None
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_topo_")
    failures: list = []
    r_per_slice = 2

    def spawn(tag, faults, slices=2, armed=True, extra=None):
        env_extra = {"CYLON_TPU_TORCH_TOPO_SHUFFLE": "1" if armed else "0"}
        if slices:
            env_extra["CYLON_TPU_TORCH_SLICES"] = str(slices)
        env_extra.update(extra or {})
        return _spawn(args, os.path.join(args.workdir, tag), faults,
                      resume=False, extra_env=env_extra, multislice=True,
                      world=4)

    # the flat-routed run on the two-tier grid: the bit-equality oracle
    # AND the cross-slice traffic yardstick
    p, base = spawn("base", "", armed=False)
    if p.returncode != 0 or not base or not base.get("sha"):
        return _baseline_failed(args, p, "multislice", own_workdir)
    print(f"# topo flat baseline sha={base['sha'][:16]} "
          f"dcn_messages={base['dcn_messages']}", flush=True)
    if base.get("topo_plans_voted"):
        failures.append(f"flat-routed run voted a topology plan: {base}")

    # armed happy path: a voted plan, bit-equal, cross-slice messages 1/R
    p, info = spawn("hier", "")
    plan0 = (info or {}).get("topo_plan_hash")
    if p.returncode != 0 or not info or info.get("sha") != base["sha"]:
        failures.append(f"hierarchical run diverged (rc={p.returncode}): "
                        f"{info}\n{_tail(p)}")
    elif not plan0 or not info.get("topo_plans_voted"):
        failures.append(f"hierarchical run never voted a plan: {info}")
    elif info.get("dcn_rows") != base.get("dcn_rows"):
        failures.append(
            f"cross-slice PAYLOAD changed (must be route-invariant): "
            f"{info.get('dcn_rows')} != {base.get('dcn_rows')}")
    elif info["dcn_messages"] * r_per_slice > base["dcn_messages"] * 1.2:
        failures.append(
            f"cross-slice message count not reduced ~1/R: hier="
            f"{info['dcn_messages']} flat={base['dcn_messages']} R=2")
    else:
        print(f"# topo hier -> ok (plan={plan0} dcn_messages="
              f"{info['dcn_messages']} vs flat {base['dcn_messages']})",
              flush=True)

    # a capacity fault inside the two-hop exchange (its receive guard
    # probes before the second hop): the ladder's retry must re-adopt the
    # IDENTICAL voted topology plan before going bit-equal
    p, info = spawn("capacity", "shuffle.recv_guard::1=capacity")
    if p.returncode != 0 or not info or info.get("sha") != base["sha"]:
        failures.append(f"capacity-fault leg diverged (rc={p.returncode}):"
                        f" {info}\n{_tail(p)}")
    elif info.get("topo_plan_hash") != plan0:
        failures.append(f"capacity-fault recovery adopted a DIFFERENT "
                        f"topology plan: {info.get('topo_plan_hash')} != "
                        f"{plan0}")
    elif not info.get("events") or info["events"] > MAX_RECOVERY_EVENTS:
        failures.append(f"capacity-fault leg events out of range: {info}")
    else:
        print("# topo capacity fault -> ok (same voted plan, bit-equal)",
              flush=True)

    # whole-slice loss → elastic resume: the checkpointed two-stage
    # workload runs at world 4 / 2 slices, a SIGKILL mid stage 2 takes
    # the process (both slices) down, and the resume runs on the
    # surviving world 2, one slice: the re-shard fast-forwards stage 1
    k1 = args.chunks + 1
    two_tier = {"CYLON_TPU_TORCH_SLICES": "2"}
    one_tier = {"CYLON_TPU_TORCH_SLICES": "1"}
    p, ebase = _spawn(args, os.path.join(args.workdir, "ebase"), "",
                      resume=False, elastic=True, world=4,
                      extra_env=two_tier)
    if p.returncode != 0 or not ebase or not ebase.get("sha"):
        failures.append(f"elastic two-tier baseline failed "
                        f"(rc={p.returncode}): {_tail(p)}")
    else:
        dk = os.path.join(args.workdir, "slicekill")
        p1, _ = _spawn(args, dk, f"ckpt.write::{k1}=kill", resume=False,
                       elastic=True, world=4, extra_env=two_tier)
        if p1.returncode != -9:
            failures.append(f"whole-slice kill did not crash "
                            f"(rc={p1.returncode})")
        else:
            p2, info2 = _spawn(args, dk, "", resume=True, elastic=True,
                               world=2, extra_env=one_tier)
            if p2.returncode != 0 or not info2 \
                    or info2.get("sha") != ebase["sha"]:
                failures.append(
                    f"slice-loss resume diverged (rc={p2.returncode}): "
                    f"{info2}\n{_tail(p2)}")
            elif not info2.get("resume_resharded_pieces") \
                    or not info2.get("resume_world_mismatch"):
                failures.append(f"slice loss did not re-shard: {info2}")
            else:
                print(f"# topo slice-kill + elastic resume -> ok "
                      f"(resharded={info2['resume_resharded_pieces']} "
                      f"ffwd={info2['resume_fast_forwarded_pieces']})",
                      flush=True)

    # the unarmed single-slice contract: with NO slice declaration the
    # armed route votes nothing and runs the flat engine — same sha,
    # same exchange rows, same exchange count
    p, flat0 = spawn("single_unarmed", "", slices=0, armed=False)
    p2, flat1 = spawn("single_armed", "", slices=0, armed=True)
    if p.returncode != 0 or p2.returncode != 0 or not flat0 or not flat1:
        failures.append(f"single-slice legs failed (rc={p.returncode}/"
                        f"{p2.returncode}): {flat0} {flat1}")
    elif flat1.get("sha") != flat0.get("sha"):
        failures.append(f"armed-on-single-slice diverged: {flat1}")
    elif flat1.get("topo_plan_hash") is not None \
            or flat1.get("topo_plans_voted"):
        failures.append(f"armed-on-single-slice voted a plan: {flat1}")
    elif (flat1.get("exchange_rows") != flat0.get("exchange_rows")
          or flat1.get("exchange_count") != flat0.get("exchange_count")):
        failures.append(
            f"armed-on-single-slice moved different exchange traffic: "
            f"{flat1} != {flat0}")
    else:
        print("# topo unarmed single-slice -> ok (no vote, identical "
              "exchange counters)", flush=True)

    return _finish(args, own_workdir, {"multislice": True}, failures)


def run_audit(args) -> int:
    """The ``--audit`` flow: silent exchange corruption injected at
    ``exchange.corrupt`` must be CAUGHT by the armed fingerprint (typed,
    one recompute, bit-equal) on the flat, the skew-split and the
    two-slice routes; persistent corruption must end in a typed abort;
    the unarmed path does zero fingerprint work."""
    own_workdir = args.workdir is None
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_audit_")
    failures: list = []

    def spawn(tag, faults, extra=None, skew=False):
        return _spawn(args, os.path.join(args.workdir, tag), faults,
                      resume=False, extra_env=extra or {}, world=4,
                      skew=skew, multislice=not skew)

    def integrity_event(info):
        # the ladder's recompute of a caught corruption records an event
        # of kind "integrity"
        return any(ev.get("kind") == "integrity"
                   for ev in (info or {}).get("event_list") or [])

    # unarmed baseline: the bit-equality oracle AND the zero-overhead
    # contract (the conservation laws still run: free host math)
    p, base = spawn("base", "")
    if p.returncode != 0 or not base or not base.get("sha"):
        return _baseline_failed(args, p, "audit", own_workdir)
    print(f"# audit unarmed baseline sha={base['sha'][:16]} "
          f"conservation_checks={base['audit_conservation_checks']}",
          flush=True)
    if base.get("audit_fingerprint_checks") \
            or base.get("audit_fingerprint_votes"):
        failures.append(f"UNARMED run did fingerprint work: {base}")
    if not base.get("audit_conservation_checks"):
        failures.append(f"conservation laws not always-on: {base}")

    armed = {"CYLON_TPU_TORCH_AUDIT": "1"}
    # armed clean run: bit-equal, fingerprints checked, zero violations,
    # exactly the unarmed run's exchange traffic
    p, info = spawn("armed", "", extra=armed)
    if p.returncode != 0 or not info or info.get("sha") != base["sha"]:
        failures.append(f"armed clean run diverged (rc={p.returncode}): "
                        f"{info}\n{_tail(p)}")
    elif not info.get("audit_fingerprint_checks") \
            or not info.get("audit_fingerprint_votes"):
        failures.append(f"armed run never fingerprinted: {info}")
    elif info.get("audit_violations"):
        failures.append(f"armed clean run reported violations: {info}")
    elif (info.get("exchange_rows") != base.get("exchange_rows")
          or info.get("exchange_count") != base.get("exchange_count")):
        failures.append(
            f"arming the audit changed exchange traffic: {info} != {base}")
    else:
        print(f"# audit armed clean -> ok (fp_checks="
              f"{info['audit_fingerprint_checks']})", flush=True)

    # one-shot silent corruption, armed: a typed DataIntegrityError the
    # ladder converts into ONE recompute — bit-equal, the event recorded
    p, info = spawn("corrupt", "exchange.corrupt=corrupt", extra=armed)
    if p.returncode != 0 or not info or info.get("sha") != base["sha"]:
        failures.append(f"caught-corruption leg diverged "
                        f"(rc={p.returncode}): {info}\n{_tail(p)}")
    elif not info.get("audit_violations") \
            or not info.get("audit_corruptions_injected"):
        failures.append(f"corruption not injected/detected: {info}")
    elif not integrity_event(info):
        failures.append(f"no integrity recovery event recorded: {info}")
    elif info.get("events", 0) > MAX_RECOVERY_EVENTS:
        failures.append(f"corruption recovery events out of range: {info}")
    else:
        print("# audit one-shot corruption -> ok (caught, one recompute, "
              "bit-equal)", flush=True)

    # PERSISTENT corruption: every recompute re-flips, so the ladder
    # must exhaust its one rung and abort TYPED, never answer wrongly
    p, info = spawn("persist", "exchange.corrupt::*=corrupt", extra=armed)
    if p.returncode == 0:
        failures.append(f"persistent corruption returned a result: {info}")
    elif "DataIntegrityError" not in (p.stderr or ""):
        failures.append(f"persistent corruption died untyped "
                        f"(rc={p.returncode}): {_tail(p)}")
    else:
        print("# audit persistent corruption -> typed abort (ok)",
              flush=True)

    # corruption under the SKEW-SPLIT route: caught at the post-exchange
    # stage inside the split join, recomputed onto the same voted plan
    skew_env = {"CYLON_TPU_TORCH_SKEW_SPLIT": "1", **armed}
    p, sbase = spawn("skew_base", "", extra=skew_env, skew=True)
    if p.returncode != 0 or not sbase or not sbase.get("sha") \
            or not sbase.get("skew_split_joins"):
        failures.append(f"audit skew baseline failed (rc={p.returncode}, "
                        f"did it split?): {sbase}\n{_tail(p)}")
    else:
        p, info = spawn("skew_corrupt", "exchange.corrupt=corrupt",
                        extra=skew_env, skew=True)
        if p.returncode != 0 or not info \
                or info.get("sha") != sbase["sha"]:
            failures.append(f"skew-route corruption leg diverged "
                            f"(rc={p.returncode}): {info}\n{_tail(p)}")
        elif not info.get("audit_violations") or not integrity_event(info):
            failures.append(f"skew-route corruption not caught: {info}")
        elif info.get("plan_hash") != sbase.get("plan_hash"):
            failures.append(f"skew-route recompute changed the voted "
                            f"plan: {info.get('plan_hash')} != "
                            f"{sbase.get('plan_hash')}")
        else:
            print("# audit corruption under skew-split -> ok (caught, "
                  "same plan, bit-equal)", flush=True)

    # corruption under the TWO-SLICE route: the two-hop exchange's
    # delivered rows are fingerprinted like the flat route's — caught,
    # bit-equal to the flat oracle
    topo_env = {"CYLON_TPU_TORCH_SLICES": "2",
                "CYLON_TPU_TORCH_TOPO_SHUFFLE": "1", **armed}
    p, info = spawn("topo_corrupt", "exchange.corrupt=corrupt",
                    extra=topo_env)
    if p.returncode != 0 or not info or info.get("sha") != base["sha"]:
        failures.append(f"topo-route corruption leg diverged "
                        f"(rc={p.returncode}): {info}\n{_tail(p)}")
    elif not info.get("topo_plans_voted"):
        failures.append(f"topo-route leg never voted a plan: {info}")
    elif not info.get("audit_violations") or not integrity_event(info):
        failures.append(f"topo-route corruption not caught: {info}")
    else:
        print("# audit corruption under two-tier route -> ok (caught, "
              "bit-equal)", flush=True)

    return _finish(args, own_workdir, {"audit": True}, failures)


def run_skew(args) -> int:
    """The ``--skew`` flow: every schedule ends bit-equal to the UNSPLIT
    baseline, and every recovered schedule lands on the IDENTICAL voted
    plan hash."""
    own_workdir = args.workdir is None
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_skew_")
    failures: list = []

    def spawn(tag, faults, armed=True, frac=0.8, extra=None):
        env_extra = {"CYLON_TPU_TORCH_SKEW_SPLIT": "1" if armed else "0"}
        env_extra.update(extra or {})
        return _spawn(args, os.path.join(args.workdir, tag), faults,
                      resume=False, extra_env=env_extra, skew=True,
                      skew_frac=frac)

    p, base = spawn("base", "", armed=False)
    if p.returncode != 0 or not base or not base.get("sha"):
        return _baseline_failed(args, p, "skew", own_workdir)
    print(f"# skew unsplit baseline sha={base['sha'][:16]}", flush=True)

    # armed happy path: a non-empty voted plan, bit-equal
    p, info = spawn("split", "")
    plan0 = (info or {}).get("plan_hash")
    if p.returncode != 0 or not info or info.get("sha") != base["sha"]:
        failures.append(f"armed split diverged (rc={p.returncode}): {info}\n"
                        f"{_tail(p)}")
    elif not plan0 or not info.get("skew_split_joins"):
        failures.append(f"armed split never voted a plan: {info}")
    else:
        print(f"# skew split -> ok (plan={plan0})", flush=True)

    # an exchange capacity fault INSIDE the split: the ladder retries the
    # join, which must re-detect and re-vote the IDENTICAL plan
    p, info = spawn("capacity", "shuffle.recv_guard::1=capacity")
    if p.returncode != 0 or not info or info.get("sha") != base["sha"]:
        failures.append(f"capacity-fault leg diverged (rc={p.returncode}): "
                        f"{info}\n{_tail(p)}")
    elif info.get("plan_hash") != plan0:
        failures.append(f"capacity-fault recovery re-voted a DIFFERENT "
                        f"plan: {info.get('plan_hash')} != {plan0}")
    elif not info.get("events") or info["events"] > MAX_RECOVERY_EVENTS:
        failures.append(f"capacity-fault leg events out of range: {info}")
    else:
        print("# skew capacity fault -> ok (same plan, bit-equal)",
              flush=True)

    # a spill fault under a device budget cap: same contract
    p, info = spawn("spill", "spill.evict::1=predicted",
                    extra={"CYLON_TPU_TORCH_HBM_BUDGET": "4096"})
    if p.returncode != 0 or not info or info.get("sha") != base["sha"]:
        failures.append(f"spill-fault leg diverged (rc={p.returncode}): "
                        f"{info}\n{_tail(p)}")
    elif info.get("plan_hash") != plan0:
        failures.append(f"spill-fault recovery re-voted a DIFFERENT "
                        f"plan: {info.get('plan_hash')} != {plan0}")
    else:
        print("# skew spill fault -> ok (same plan, bit-equal)", flush=True)

    # SIGKILL mid-workload (at the groupby site, after the voted split's
    # exchange ran), then a fresh rerun: same plan, bit-equal
    p, _ = spawn("kill", "groupby.device_oom::1=kill")
    if p.returncode != -9:
        failures.append(f"kill leg did not crash (rc={p.returncode})")
    else:
        p2, info2 = spawn("kill_rerun", "")
        if p2.returncode != 0 or not info2 \
                or info2.get("sha") != base["sha"]:
            failures.append(f"rerun after kill diverged "
                            f"(rc={p2.returncode}): {info2}\n{_tail(p2)}")
        elif info2.get("plan_hash") != plan0:
            failures.append(f"rerun after kill voted a DIFFERENT plan: "
                            f"{info2.get('plan_hash')} != {plan0}")
        else:
            print("# skew kill + rerun -> ok (same plan, bit-equal)",
                  flush=True)

    # the unarmed-at-skew-0 contract: the ARMED run at skew 0 votes
    # nothing, splits nothing, and moves exactly the unsplit run's rows
    p, flat0 = spawn("flat_unsplit", "", armed=False, frac=0.0)
    p2, flat1 = spawn("flat_armed", "", armed=True, frac=0.0)
    if p.returncode != 0 or p2.returncode != 0 or not flat0 or not flat1:
        failures.append(f"flat legs failed (rc={p.returncode}/"
                        f"{p2.returncode}): {flat0} {flat1}")
    elif flat1.get("sha") != flat0.get("sha"):
        failures.append(f"armed-at-skew-0 diverged: {flat1}")
    elif flat1.get("plan_hash") is not None \
            or flat1.get("skew_split_joins"):
        failures.append(f"armed-at-skew-0 voted a plan: {flat1}")
    elif flat1.get("exchange_rows") != flat0.get("exchange_rows"):
        failures.append(
            f"armed-at-skew-0 moved extra exchange rows: "
            f"{flat1.get('exchange_rows')} != {flat0.get('exchange_rows')}")
    else:
        print("# skew unarmed-at-0 -> ok (no vote, no extra exchange "
              "rows)", flush=True)

    return _finish(args, own_workdir, {"skew": True}, failures)


def run_oocore(args) -> int:
    """The ``--oocore`` flow: the disk tier's contract.  Budget caps below
    the workload's working set force evict → demote; every schedule ends
    bit-equal to the uncapped baseline — degraded, resumed or
    recomputed, never wrong — and the unarmed leg writes NOTHING."""
    own_workdir = args.workdir is None
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_oocore_")
    failures: list = []
    caps = {"CYLON_TPU_TORCH_HBM_BUDGET": "4096",
            "CYLON_TPU_TORCH_HOST_BUDGET": "4096"}

    def spawn(tag, faults, capped=True):
        workdir = os.path.join(args.workdir, tag)
        extra = dict(caps) if capped else {}
        extra["CYLON_TPU_TORCH_SPILL_DIR"] = os.path.join(workdir, "spill")
        return _spawn(args, workdir, faults, resume=False,
                      extra_env=extra), os.path.join(workdir, "spill")

    # uncapped, uninjected baseline: the bit-equality oracle
    (p, base), sd = spawn("base", "", capped=False)
    if p.returncode != 0 or not base or not base.get("sha"):
        return _baseline_failed(args, p, "oocore", own_workdir)
    print(f"# oocore baseline sha={base['sha'][:16]}", flush=True)
    if base.get("disk_events"):
        failures.append(f"UNARMED baseline wrote to disk: {base}")
    if os.path.isdir(sd):
        failures.append(f"unarmed run created the spill dir {sd}")

    # capped happy path: bit-equal THROUGH the disk tier, traffic counted
    (p, info), _ = spawn("capped", "")
    if p.returncode != 0 or not info or info.get("sha") != base["sha"]:
        failures.append(f"capped run diverged (rc={p.returncode}): {info}\n"
                        f"{_tail(p)}")
    elif not info.get("disk_events") or not info.get("bytes_to_disk"):
        failures.append(f"capped run never touched the disk tier: {info}")
    else:
        print(f"# oocore capped -> ok (disk_events={info['disk_events']} "
              f"bytes_to_disk={info['bytes_to_disk']})", flush=True)

    # ENOSPC mid-demote: typed degrade to in-memory — no crash, bit-equal
    (p, info), _ = spawn("enospc", "disk.write::1=enospc")
    if p.returncode != 0 or not info or info.get("sha") != base["sha"]:
        failures.append(f"enospc mid-demote crashed or diverged "
                        f"(rc={p.returncode}): {info}\n{_tail(p)}")
    elif not info.get("disk_write_degrades"):
        failures.append(f"enospc degrade not counted: {info}")
    else:
        print("# oocore enospc -> ok (typed degrade, bit-equal)",
              flush=True)

    # corrupt-on-promote: the ladder recomputes the owner — bit-equal
    (p, info), _ = spawn("corrupt", "disk.read::1=corrupt")
    if p.returncode != 0 or not info or info.get("sha") != base["sha"]:
        failures.append(f"corrupt-on-promote crashed or produced a WRONG "
                        f"answer (rc={p.returncode}): {info}\n{_tail(p)}")
    elif not info.get("disk_corrupt_degrades"):
        failures.append(f"corrupt degrade not counted: {info}")
    elif info.get("events", 0) > MAX_RECOVERY_EVENTS:
        failures.append(f"unbounded retries after corruption: {info}")
    else:
        print("# oocore corrupt-on-promote -> ok (recompute, bit-equal)",
              flush=True)

    # SIGKILL mid-demote, then resume: bit-equal after the crash
    (p, _), _ = spawn("kill", "disk.write::1=kill")
    if p.returncode != -9:
        failures.append(f"kill mid-demote did not crash "
                        f"(rc={p.returncode})")
    else:
        workdir = os.path.join(args.workdir, "kill")
        extra = dict(caps)
        extra["CYLON_TPU_TORCH_SPILL_DIR"] = os.path.join(workdir, "spill2")
        p2, info2 = _spawn(args, workdir, "", resume=True, extra_env=extra)
        if p2.returncode != 0 or not info2 \
                or info2.get("sha") != base["sha"]:
            failures.append(f"resume after kill mid-demote diverged "
                            f"(rc={p2.returncode}): {info2}\n{_tail(p2)}")
        else:
            print(f"# oocore kill mid-demote + resume -> ok (ffwd="
                  f"{info2.get('resume_fast_forwarded_pieces')})",
                  flush=True)

    return _finish(args, own_workdir, {"oocore": True}, failures)


def _worker_elastic(args, env) -> int:
    """The elastic-resume workload: TWO chained pipelined stages — a
    sinkless join (stage 1) feeding a join+GroupBySink (stage 2) — so a
    kill landing mid stage 2 leaves a COMPLETE stage 1 behind, which a
    resume at another world must re-shard and fast-forward while stage 2
    recomputes.  Integer money and a unique-key final groupby keep the
    sorted result world-invariant.  A preemption-grace drain (SIGTERM by
    the ``term`` kind, the grace budget in the environment) exits through
    a typed ResumableAbort (exit 17), not a signal death."""
    import numpy as np

    import cylon_tpu_torch as ct

    from . import GroupBySink, checkpoint, pipelined_join, recovery
    from ..status import ResumableAbort

    rng = np.random.default_rng(ELASTIC_SEED)
    rows = args.rows
    n_ord = max(rows // 4, 64)
    n_cust = 16
    orders = ct.Table.from_pydict(
        {"o_orderkey": np.arange(n_ord, dtype=np.int64),
         "o_custkey": rng.integers(0, n_cust, n_ord).astype(np.int64)},
        env)
    lineitem = ct.Table.from_pydict(
        {"l_orderkey": rng.integers(0, n_ord, rows).astype(np.int64),
         "l_quantity": rng.integers(1, 51, rows).astype(np.int64),
         "l_extendedprice": rng.integers(900_00, 10_500_00,
                                         rows).astype(np.int64)},
        env)
    customers = ct.Table.from_pydict(
        {"c_custkey": np.arange(n_cust, dtype=np.int64),
         "c_nationkey": rng.integers(0, 5, n_cust).astype(np.int64)},
        env)
    try:
        # stage 1 (sinkless): its piece outputs are the checkpointed
        # state a world change must re-shard in global row order
        jt = pipelined_join(lineitem, orders, "l_orderkey", "o_orderkey",
                            how="inner", n_chunks=args.chunks)
        # stage 2 (sink): mergeable partial aggregates
        sink = GroupBySink("o_custkey", [("l_quantity", "sum"),
                                         ("l_extendedprice", "sum")])
        pipelined_join(jt, customers, "o_custkey", "c_custkey",
                       how="inner", n_chunks=args.chunks, sink=sink)
        out = sink.finalize()
    except ResumableAbort as e:
        _emit({"resumable": True, "token": e.token,
               "events": len(recovery.recovery_events()),
               **checkpoint.stats()})
        return RESUMABLE_EXIT
    cols = _sorted_pydict(out, "o_custkey")
    _emit({
        "ok": True, "sha": _result_sha(cols),
        "rows": int(len(cols["o_custkey"])),
        "world": int(env.world_size),
        "events": len(recovery.recovery_events()),
        **checkpoint.stats(),
    })
    return 0


def run_elastic(args) -> int:
    """The ``--elastic`` flow.  ``k1`` is stage 2's first checkpoint write
    (stage 1's pieces occupy writes 1..chunks), so a fault there leaves
    stage 1 complete and stage 2 untouched."""
    own_workdir = args.workdir is None
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_elastic_")
    failures: list = []
    k1 = args.chunks + 1

    p, base = _spawn(args, os.path.join(args.workdir, "base"), "",
                     resume=False, elastic=True, world=2)
    if p.returncode != 0 or not base or not base.get("sha"):
        return _baseline_failed(args, p, "elastic", own_workdir)
    print(f"# elastic baseline sha={base['sha'][:16]} world=2", flush=True)

    def resume_leg(tag, workdir, world, resume_faults="", extra=None,
                   want_reshard=True):
        p2, info = _spawn(args, workdir, resume_faults, resume=True,
                          elastic=True, world=world, extra_env=extra)
        if p2.returncode != 0 or not info:
            failures.append(f"{tag}: resume at world={world} failed "
                            f"rc={p2.returncode}: {_tail(p2)}")
            return None
        if info.get("sha") != base["sha"]:
            failures.append(f"{tag}: resume at world={world} diverged "
                            f"from the world=2 baseline: {info}")
        elif want_reshard and not info.get("resume_resharded_pieces"):
            failures.append(f"{tag}: world change did not re-shard "
                            f"(recomputed everything): {info}")
        elif want_reshard and not info.get("resume_world_mismatch"):
            failures.append(f"{tag}: world mismatch not counted: {info}")
        elif not want_reshard and info.get("resume_resharded_pieces"):
            failures.append(f"{tag}: same-world resume resharded: {info}")
        elif not info.get("resume_fast_forwarded_pieces"):
            failures.append(f"{tag}: resume recomputed every committed "
                            f"piece: {info}")
        else:
            print(f"# elastic {tag} -> ok (world={world} "
                  f"ffwd={info['resume_fast_forwarded_pieces']} "
                  f"resharded={info['resume_resharded_pieces']} "
                  f"mismatch={info['resume_world_mismatch']})", flush=True)
        return info

    def kill_leg(tag, workdir, faults, extra=None):
        p1, _ = _spawn(args, workdir, faults, resume=False, elastic=True,
                       world=2, extra_env=extra)
        if p1.returncode != -9:
            failures.append(f"{tag}: kill schedule did not crash "
                            f"(rc={p1.returncode})")
            return False
        if not os.path.exists(os.path.join(workdir,
                                           "TRACE_POSTMORTEM.json")):
            failures.append(f"{tag}: killed child left no "
                            "TRACE_POSTMORTEM.json breadcrumb")
        return True

    # A: checkpoint at world 2, SIGKILL mid stage 2 → resume at world 1:
    # stage 1 re-shards 2 → 1 and fast-forwards, stage 2 recomputes
    da = os.path.join(args.workdir, "killA")
    if kill_leg("A", da, f"ckpt.write::{k1}=kill"):
        resume_leg("A (2→1 reshard)", da, 1)

    # B: the same kill → a plain resume at world 2 (no re-shard)
    db = os.path.join(args.workdir, "killB")
    if kill_leg("B", db, f"ckpt.write::{k1}=kill"):
        resume_leg("B (2→2 plain)", db, 2, want_reshard=False)

    # C: kill at world 2, resume at world 1 and kill THAT mid stage 2
    # (stage 1 now rewritten in the world-1 layout), then resume at
    # world 2: the newer world-1 manifests re-shard back up while the
    # stale world-2 rank directories read as stale
    dc = os.path.join(args.workdir, "killC")
    if kill_leg("C", dc, f"ckpt.write::{k1}=kill"):
        p2, _ = _spawn(args, dc, f"ckpt.write::{args.chunks + 2}=kill",
                       resume=True, elastic=True, world=1)
        if p2.returncode != -9:
            failures.append(f"C: second kill (world=1 resume) did not "
                            f"crash (rc={p2.returncode})")
        else:
            resume_leg("C (1→2 after-reshard)", dc, 2)

    # D: corruption injected DURING the re-shard read: the stage degrades
    # to recompute — bit-equal, nothing re-sharded
    dd = os.path.join(args.workdir, "killD")
    if kill_leg("D", dd, f"ckpt.write::{k1}=kill"):
        p2, info = _spawn(args, dd, "ckpt.reshard::1=corrupt",
                          resume=True, elastic=True, world=1)
        if p2.returncode != 0 or not info:
            failures.append(f"D: corrupt-reshard resume failed "
                            f"rc={p2.returncode}: {_tail(p2)}")
        elif info.get("sha") != base["sha"]:
            failures.append(f"D: corrupt reshard produced a WRONG "
                            f"answer: {info}")
        elif info.get("resume_resharded_pieces"):
            failures.append(f"D: corrupt reshard still adopted pieces: "
                            f"{info}")
        else:
            print("# elastic D (corrupt reshard → recompute) -> ok",
                  flush=True)

    # F: SIGKILL DURING the re-shard itself: nothing is committed until
    # the rewrite, so resuming AGAIN must re-shard cleanly
    df = os.path.join(args.workdir, "killF")
    if kill_leg("F", df, f"ckpt.write::{k1}=kill"):
        p2, _ = _spawn(args, df, "ckpt.reshard::1=kill", resume=True,
                       elastic=True, world=1)
        if p2.returncode != -9:
            failures.append(f"F: kill mid-reshard did not crash "
                            f"(rc={p2.returncode})")
        else:
            resume_leg("F (reshard after mid-reshard kill)", df, 1)

    # E: preemption grace — SIGTERM (the term kind) with the grace
    # budget armed exits through a typed ResumableAbort (exit 17), the
    # current stage committed; the world-1 resume rides the prefix
    de = os.path.join(args.workdir, "termE")
    grace = {"CYLON_TPU_TORCH_PREEMPT_GRACE_S": "30"}
    p1, info1 = _spawn(args, de, f"ckpt.write::{k1}=term", resume=False,
                       elastic=True, world=2, extra_env=grace)
    if p1.returncode != RESUMABLE_EXIT:
        failures.append(f"E: SIGTERM with grace armed did not drain via "
                        f"ResumableAbort (rc={p1.returncode}): "
                        f"{_tail(p1, 1500)}")
    elif not info1 or not info1.get("checkpoint_events"):
        failures.append(f"E: grace drain committed nothing: {info1}")
    elif not os.path.exists(os.path.join(de, "TRACE_POSTMORTEM.json")):
        failures.append("E: grace drain left no TRACE_POSTMORTEM.json "
                        "breadcrumb beside the manifests")
    else:
        print(f"# elastic E drain -> ok (committed="
              f"{info1['checkpoint_events']})", flush=True)
        p2, info2 = _spawn(args, de, "", resume=True, elastic=True,
                           world=1, extra_env=grace)
        if p2.returncode != 0 or not info2 \
                or info2.get("sha") != base["sha"]:
            failures.append(f"E: resume after grace drain diverged "
                            f"(rc={p2.returncode}): {info2}")
        else:
            print(f"# elastic E resume -> ok (ffwd="
                  f"{info2['resume_fast_forwarded_pieces']})", flush=True)

    return _finish(args, own_workdir, {"elastic": True}, failures)


def _worker_concurrent(args, env) -> int:
    """K concurrent serving sessions over one world (exec/scheduler.py),
    each a differently seeded join+sink tenant.  ``--only i`` runs one
    tenant alone — the SOLO leg whose sha is the concurrent run's oracle.
    Faults target tenants with the ``@session`` grammar
    (``ckpt.write::2=kill@t0``); a kill takes the whole process down and
    the parent reruns with ``CYLON_TPU_TORCH_RESUME=1``."""
    import cylon_tpu_torch as ct

    from . import checkpoint, recovery
    from .scheduler import QueryScheduler
    from ..status import ResumableAbort

    def make_fn(i: int):
        attempt = _make_workload(ct, env, SOAK_SEED + 7919 * i, args.rows)

        def fn():
            out = recovery.run_with_recovery(
                lambda: attempt(args.chunks), True, attempt,
                f"soak.t{i}", env=env)
            return _sorted_pydict(out, "l_orderkey")
        return fn

    sched = QueryScheduler(env, policy="fair")
    idxs = [i for i in range(args.concurrent)
            if args.only is None or i == args.only]
    for i in idxs:
        sched.submit(f"t{i}", make_fn(i))
    sessions = sched.run()
    shas, events = {}, {}
    for s in sessions:
        if isinstance(s.error, ResumableAbort):
            _emit({"resumable": True, "token": s.error.token,
                   "session": s.name})
            return RESUMABLE_EXIT
        if s.error is not None:
            raise s.error
        shas[s.name] = _result_sha(s.result)
        events[s.name] = s.recovery_events()
    _emit({
        "ok": True, "shas": shas, "session_events": events,
        "events": len(recovery.recovery_events()),
        **checkpoint.stats(),
    })
    return 0


def _worker_fleet(args, env) -> int:
    """One ``--fleet`` worker process.  The case rides
    ``CYLON_TPU_TORCH_FLEET_CASE``:

    * ``preempt`` — tA (long, low priority) submits tB (short, high
      priority) from inside its own first run; under ``policy=priority``
      and ``max_concurrency=1`` the scheduler preempt-drains tA at its
      next checkpoint boundary, runs tB, then requeues tA, which resumes
      in process (fast-forward > 0).  The solo oracles are computed in
      process with checkpointing popped.
    * ``resize`` — three tenants under a ResizeController
      (``CYLON_TPU_TORCH_FLEET_TARGET`` armed): sustained queue depth
      engages the all-or-nothing fleet drain; the worker exits 17 with
      zero failed_typed tenants, and the same case relaunched without the
      target (at the new ``--world``) resumes every tenant bit-equal.
    * ``deadline`` — ``CYLON_TPU_TORCH_ADMISSION_TIMEOUT_S`` armed,
      fifo, one slot: the queued tenant fails typed
      (AdmissionTimeoutError), never hangs."""
    import cylon_tpu_torch as ct

    from . import checkpoint
    from .fleet import ResizeController
    from .scheduler import QueryScheduler
    from ..status import AdmissionTimeoutError, ResumableAbort

    case = os.environ.get("CYLON_TPU_TORCH_FLEET_CASE", "preempt")

    def cols_of(seed, rows, nc):
        out = _make_workload(ct, env, seed, rows)(nc)
        return _sorted_pydict(out, "l_orderkey")

    # tenant specs: (seed, rows, chunks) — tA long (many drain
    # boundaries), tB short (the high-priority arrival)
    specs = {
        "tA": (SOAK_SEED, args.rows, args.chunks + 2),
        "tB": (20260810, max(args.rows // 3, 256), 2),
        "tC": (20260817, args.rows, args.chunks),
    }

    # solo oracles, computed in process with durable checkpoints (and any
    # resume request) popped, so they neither write stages nor
    # fast-forward from the scheduler runs' stages
    saved = {k: os.environ.pop(k, None)
             for k in ("CYLON_TPU_TORCH_CKPT_DIR", "CYLON_TPU_TORCH_RESUME")}
    solo = {name: _result_sha(cols_of(*spec))
            for name, spec in specs.items()}
    for k, v in saved.items():
        if v is not None:
            os.environ[k] = v

    def finish(sched, extra) -> int:
        shas, outcomes = {}, sched.stats()["outcomes"]
        for s in sched.sessions:
            if isinstance(s.error, ResumableAbort):
                _emit({"resumable": True, "token": s.error.token,
                       "session": s.name, "outcomes": outcomes,
                       "failed_typed": outcomes.get("failed_typed", 0),
                       "resize_target": sched.resize_target, **extra})
                return RESUMABLE_EXIT
            if s.error is not None:
                raise s.error
            shas[s.name] = _result_sha(s.result)
        st = sched.stats()
        _emit({"ok": True, "shas": shas,
               "bit_equal": all(shas[n] == solo[n] for n in shas),
               "outcomes": outcomes,
               "failed_typed": outcomes.get("failed_typed", 0),
               "preemptions": st["preemptions"],
               "requeues": st["requeues"],
               "resize_target": sched.resize_target,
               **checkpoint.stats(), **extra})
        return 0

    if case == "preempt":
        sched = QueryScheduler(env, policy="priority", max_concurrency=1)
        runs = {"n": 0}

        def ta():
            runs["n"] += 1
            if runs["n"] == 1:
                # the high-priority arrival lands MID-TRAFFIC: tA's own
                # first slice submits it
                sched.submit("tB", lambda: cols_of(*specs["tB"]),
                             priority=5)
            return cols_of(*specs["tA"])

        sched.submit("tA", ta)
        sched.submit("tC", lambda: cols_of(*specs["tC"]))
        sched.run()
        return finish(sched, {"case": case})

    if case == "resize":
        target = int(os.environ.get("CYLON_TPU_TORCH_FLEET_TARGET", "0")
                     or 0)
        fleet = (ResizeController(env, target_world=target,
                                  queue_depth_high=2)
                 if target > 0 else None)
        sched = QueryScheduler(env, policy="fair", max_concurrency=1,
                               fleet=fleet)
        for name in ("tA", "tB", "tC"):
            sched.submit(name, lambda n=name: cols_of(*specs[n]))
        sched.run()
        return finish(sched, {"case": case, "world": args.world})

    if case == "deadline":
        # tA holds the one slot past the deadline on any host: its query
        # runs again (the same answer) until twice the deadline has
        # passed, where the reference relied on tA taking that long
        deadline = float(os.environ.get(
            "CYLON_TPU_TORCH_ADMISSION_TIMEOUT_S", "0") or 0)

        def ta():
            t0 = time.perf_counter()
            out = cols_of(*specs["tA"])
            while time.perf_counter() - t0 < 2 * deadline:
                out = cols_of(*specs["tA"])
            return out

        sched = QueryScheduler(env, policy="fifo", max_concurrency=1)
        sched.submit("tA", ta)
        sched.submit("tB", lambda: cols_of(*specs["tB"]))
        sched.run()
        a, b = sched.sessions[0], sched.sessions[1]
        st = sched.stats()
        _emit({
            "ok": a.state == "done" and b.state == "failed",
            "timeout_typed": isinstance(b.error, AdmissionTimeoutError),
            "tA_bit_equal": (a.result is not None
                             and _result_sha(a.result) == solo["tA"]),
            "outcomes": st["outcomes"],
            "admission_timeouts": st["admission_timeouts"],
            "case": case})
        return 0

    _emit({"ok": False, "error": f"unknown fleet case {case!r}"})
    return 1


# ---------------------------------------------------------------------------
# parent: schedule generation + child supervision
# ---------------------------------------------------------------------------

def _draw_schedule(rng) -> dict:
    n = 1 + int(rng.random() < 0.4)
    entries, resume_entries = [], []
    have_capacity = False
    for _ in range(n):
        site, kinds = SITE_KINDS[int(rng.integers(0, len(SITE_KINDS)))]
        kind = kinds[int(rng.integers(0, len(kinds)))]
        if kind == "capacity" and have_capacity:
            # the capacity ladder is ONE rung by design and a capacity
            # abort is not resumable — a schedule with two capacity
            # faults cannot converge, like the excluded stall/desync
            # kinds; redraw the kind (or drop the entry where capacity
            # is the site's only kind)
            others = [k for k in kinds if k != "capacity"]
            if not others:
                continue
            kind = others[int(rng.integers(0, len(others)))]
        have_capacity = have_capacity or kind == "capacity"
        nth = int(rng.integers(1, 3))
        entry = f"{site}::{nth}={kind}"
        if site == "ckpt.load":
            # ckpt.load only fires while RESUMING — armed in the primary
            # run it would never trigger; arm it in the resume leg
            resume_entries.append(entry)
        else:
            entries.append(entry)
    if resume_entries and not any(e.endswith("=kill") for e in entries):
        # the resume leg only runs after a hard crash — force one
        entries.append("ckpt.write::2=kill")
    return {"faults": ",".join(entries),
            "resume_faults": ",".join(resume_entries)}


def _pinned_schedules() -> list[dict]:
    return [
        # the acceptance path: SIGKILL mid-range-loop after one piece
        # committed; the resume must fast-forward it
        {"faults": "ckpt.write::2=kill", "resume_faults": "",
         "expect_ffwd": True},
        # a corrupted page among the committed pieces: the resume
        # detects the hash mismatch and recomputes — still bit-equal
        {"faults": "ckpt.write::1=corrupt,ckpt.write::3=kill",
         "resume_faults": ""},
        # corruption injected on the LOAD side of the resume itself
        {"faults": "ckpt.write::3=kill",
         "resume_faults": "ckpt.load::1=corrupt"},
        # the dispatch switch: kill-and-resume with the windowed-gather
        # kernel OFF must hash-equal the baseline, which ran with it on
        {"faults": "ckpt.write::2=kill", "resume_faults": "",
         "expect_ffwd": True,
         "env": {"CYLON_TPU_TORCH_WINDOWED_GATHER": "0"}},
    ]


class Child:
    """A finished child process: ``returncode`` (None when killed at
    :data:`CHILD_TIMEOUT_S`), its output and its wall seconds."""

    __slots__ = ("returncode", "stdout", "stderr", "seconds")

    def __init__(self, returncode, stdout: str, stderr: str,
                 seconds: float):
        self.returncode = returncode
        self.stdout, self.stderr = stdout or "", stderr or ""
        self.seconds = seconds


def _tail(p, n: int = 2000) -> str:
    return (p.stdout + p.stderr)[-n:]


def _last_json(out: str):
    for line in reversed(out.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                return None
    return None


def _spawn(args, workdir: str, faults: str, resume: bool,
           extra_env: dict | None = None, concurrent: int = 1,
           only: int | None = None, stream: bool = False,
           elastic: bool = False, world: int | None = None,
           skew: bool = False, skew_frac: float = 0.8,
           multislice: bool = False, fleet: bool = False,
           compile_flow: bool = False,
           check_kernels: bool = False) -> tuple:
    """Run one worker child on ``workdir`` (its checkpoint root, beside
    its flight recorder's post-mortem) → ``(Child, its JSON line or
    None)``."""
    env = dict(os.environ)
    for k in PER_LEG_VARS:
        env.pop(k, None)
    env["CYLON_TPU_TORCH_FAULTS"] = faults
    env["CYLON_TPU_TORCH_CKPT_DIR"] = workdir
    # arm the flight recorder (obs/trace.py): a killed or drained child
    # leaves TRACE_POSTMORTEM.json next to its manifests
    env["CYLON_TPU_TORCH_TRACE"] = os.path.join(workdir, "trace.json")
    if getattr(args, "compile_cache", None) and not compile_flow:
        env["CYLON_TPU_TORCH_COMPILE_CACHE_DIR"] = args.compile_cache
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    env.update(extra_env or {})
    if resume:
        env["CYLON_TPU_TORCH_RESUME"] = "1"
    cmd = [sys.executable, "-m", MODULE, "--worker",
           f"--rows={args.rows}", f"--chunks={args.chunks}",
           f"--concurrent={concurrent}", f"--world={world or args.world}",
           f"--device={args.device}"]
    if only is not None:
        cmd.append(f"--only={only}")
    if stream:
        cmd.append("--stream")
    if elastic:
        cmd.append("--elastic")
    if skew:
        cmd += ["--skew", f"--skew-frac={skew_frac}"]
    if multislice:
        cmd.append("--multislice")
    if fleet:
        cmd.append("--fleet")
    if compile_flow:
        cmd.append("--compile")
    if check_kernels:
        cmd.append("--check-kernels")
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=CHILD_TIMEOUT_S)
        child = Child(p.returncode, p.stdout, p.stderr,
                      time.perf_counter() - t0)
    except subprocess.TimeoutExpired as e:
        def text(b):
            return b.decode(errors="replace") if isinstance(b, bytes) \
                else (b or "")
        child = Child(None, text(e.stdout), text(e.stderr)
                      + f"\nchild killed at its {CHILD_TIMEOUT_S} s limit",
                      time.perf_counter() - t0)
    info = _last_json(child.stdout)
    _CHILDREN["n"] += 1
    _CHILDREN["seconds"] += child.seconds
    for k, v in ((info or {}).get("kernel_launches") or {}).items():
        _LAUNCHES[k] = _LAUNCHES.get(k, 0) + int(v)
    return child, info


def _baseline_failed(args, p, flow: str, own_workdir: bool) -> int:
    print(_tail(p, 3000), file=sys.stderr)
    print(f"chaos-soak: {flow} baseline failed (rc={p.returncode})",
          file=sys.stderr)
    return _finish(args, own_workdir, {flow: True},
                   [f"{flow} baseline failed rc={p.returncode}"])


def _finish(args, own_workdir: bool, head: dict, failures: list,
            **extra) -> int:
    """Remove a workdir of our own, print the flow's JSON line and return
    its exit status."""
    if own_workdir:
        shutil.rmtree(args.workdir, ignore_errors=True)
    print(json.dumps({**head, "failures": len(failures),
                      "detail": failures[:10], **extra,
                      "device": args.device,
                      "seconds": round(time.perf_counter()
                                       - _CHILDREN["t0"], 3),
                      "children": _CHILDREN["n"],
                      "children_s": round(_CHILDREN["seconds"], 3),
                      "kernel_launches": dict(_LAUNCHES)}, default=str),
          flush=True)
    return 1 if failures else 0


def classify_outcome(sched: dict, baseline_sha: str, rc, info,
                     breadcrumb: bool, rc2=None, info2=None) -> tuple:
    """A schedule's verdict from its children: ``(outcome, failure)``
    where ``failure`` is None when the schedule converged.  ``rc, info``
    are the injected run's exit code and JSON line, ``breadcrumb``
    whether its TRACE_POSTMORTEM.json exists, ``rc2, info2`` the
    resume's (after a kill or a typed abort)."""
    if rc == 0:
        if not info or info.get("sha") != baseline_sha:
            return "diverged", f"completed but result diverged: {info}"
        if info["events"] > MAX_RECOVERY_EVENTS:
            return "unbounded", (f"unbounded retries: {info['events']} "
                                 "recovery events")
        return "ok", None
    if rc not in (-9, RESUMABLE_EXIT):
        return "failed", f"unexpected exit rc={rc}"
    outcome = "killed" if rc == -9 else "resumable"
    if not breadcrumb:
        # the injected kill dumps the flight recorder BEFORE the SIGKILL;
        # a ResumableAbort dumps at its flush — either way the
        # breadcrumb must land next to the manifests
        return outcome, "no TRACE_POSTMORTEM.json breadcrumb after " \
                        "kill/abort"
    if rc2 != 0:
        return outcome, f"resume run failed rc={rc2}"
    if not info2 or info2.get("sha") != baseline_sha:
        return outcome, f"resumed result diverged: {info2}"
    if info2["events"] > MAX_RECOVERY_EVENTS:
        return outcome, f"unbounded retries on resume: {info2['events']}"
    if sched.get("expect_ffwd") \
            and not info2.get("resume_fast_forwarded_pieces"):
        return outcome, f"resume recomputed committed pieces: {info2}"
    return (outcome + f"+resumed(ffwd="
            f"{info2.get('resume_fast_forwarded_pieces')})"), None


def _run_schedule(args, idx: int, sched: dict, baseline_sha: str,
                  failures: list) -> dict:
    workdir = tempfile.mkdtemp(prefix=f"soak{idx:02d}_", dir=args.workdir)
    t0 = time.perf_counter()
    p, info = _spawn(args, workdir, sched["faults"], resume=False,
                     extra_env=sched.get("env"))
    p2 = info2 = None
    crumb = os.path.exists(os.path.join(workdir, "TRACE_POSTMORTEM.json"))
    if p.returncode in (-9, RESUMABLE_EXIT) and crumb:
        p2, info2 = _spawn(args, workdir, sched.get("resume_faults", ""),
                           resume=True, extra_env=sched.get("env"))
    outcome, why = classify_outcome(
        sched, baseline_sha, p.returncode, info, crumb,
        None if p2 is None else p2.returncode, info2)
    if why is not None:
        tail = _tail(p2 if p2 is not None else p)
        failures.append(f"schedule {idx} ({sched['faults']!r}): {why}\n"
                        f"{tail}")
    rf = sched.get("resume_faults", "")
    print(f"# schedule {idx:02d} faults={sched['faults']!r}"
          + (f" resume_faults={rf!r}" if rf else "")
          + f" -> {outcome}" + ("" if why is None else " FAILED"),
          flush=True)
    shutil.rmtree(workdir, ignore_errors=True)
    return {"schedule": idx, "faults": sched["faults"],
            "resume_faults": rf, "outcome": outcome, "ok": why is None,
            "seconds": round(time.perf_counter() - t0, 3),
            "children": 1 + (p2 is not None)}


def run_concurrent(args) -> int:
    """The ``--concurrent K`` flow: K serving sessions on one world, a
    mid-query SIGKILL targeted at tenant t0 (the ``@session`` grammar),
    and a resumed rerun that must fast-forward t0's committed pieces
    while EVERY tenant's answer stays bit-equal to its solo run."""
    k = args.concurrent
    own_workdir = args.workdir is None
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_conc_")
    failures: list = []

    # solo legs: each tenant alone — the bit-equality oracle
    solo_shas: dict = {}
    for i in range(k):
        p, info = _spawn(args, os.path.join(args.workdir, f"solo{i}"),
                         "", resume=False, concurrent=k, only=i)
        if p.returncode != 0 or not info or not info.get("shas"):
            return _baseline_failed(args, p, "concurrent", own_workdir)
        solo_shas.update(info["shas"])
    print(f"# concurrent acceptance: {k} tenants, solo shas "
          f"{ {n: v[:12] for n, v in solo_shas.items()} }", flush=True)

    # the uninjected concurrent run: interleaving alone must not change
    # any tenant's answer
    p, info = _spawn(args, os.path.join(args.workdir, "conc"), "",
                     resume=False, concurrent=k)
    if p.returncode != 0 or not info or info.get("shas") != solo_shas:
        failures.append(f"un-injected concurrent run diverged: {info}")

    # the pinned kill: SIGKILL mid-query in tenant t0 after its 2nd
    # committed piece; every tenant dies with the process
    killdir = os.path.join(args.workdir, "kill")
    p, info = _spawn(args, killdir, "ckpt.write::2=kill@t0",
                     resume=False, concurrent=k)
    if p.returncode not in (-9, RESUMABLE_EXIT):
        failures.append(
            f"targeted kill did not crash the process (rc={p.returncode})")
    else:
        p2, info2 = _spawn(args, killdir, "", resume=True, concurrent=k)
        if p2.returncode != 0 or not info2:
            failures.append(f"concurrent resume failed rc={p2.returncode}:"
                            f" {_tail(p2)}")
        elif info2.get("shas") != solo_shas:
            failures.append(f"resumed concurrent result diverged: {info2}")
        elif not info2.get("resume_fast_forwarded_pieces"):
            failures.append(
                f"resume recomputed t0's committed pieces: {info2}")
        else:
            print(f"# kill@t0 + resume -> ok (ffwd="
                  f"{info2['resume_fast_forwarded_pieces']})", flush=True)

    return _finish(args, own_workdir, {"concurrent": k}, failures)


def run_fleet(args) -> int:
    """The ``--fleet`` flow: (1) a priority arrival preempts a running
    tenant, which requeues and finishes bit-equal with ffwd > 0; (2) a
    SIGKILL inside the preemption drain (the ``sched.preempt`` site), the
    relaunch resumes every tenant bit-equal; (3) a fleet resize W = 4 →
    2 mid-traffic with zero failed tenants; (4) the admission deadline
    surfaces a typed AdmissionTimeoutError, not a hang."""
    own_workdir = args.workdir is None
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_fleet_")
    failures: list = []

    def fail(msg, p=None):
        if p is not None:
            print(_tail(p, 3000), file=sys.stderr)
        failures.append(msg)
        print(f"# FAIL: {msg}", flush=True)

    case = "CYLON_TPU_TORCH_FLEET_CASE"
    # -- leg 1: preempt -> requeue -> resume, bit-equal
    d1 = os.path.join(args.workdir, "preempt")
    p, info = _spawn(args, d1, "", resume=False, fleet=True,
                     extra_env={case: "preempt"})
    if p.returncode != 0 or not info or not info.get("ok"):
        fail(f"preempt leg rc={p.returncode}: {info}", p)
    elif (not info.get("bit_equal")
          or info.get("preemptions", 0) < 1
          or not info.get("resume_fast_forwarded_pieces")):
        fail(f"preempt leg: expected bit-equal requeue with ffwd>0, "
             f"got {info}")
    else:
        print(f"# preempt leg -> ok (preemptions="
              f"{info['preemptions']}, ffwd="
              f"{info['resume_fast_forwarded_pieces']})", flush=True)

    # -- leg 2: SIGKILL during the preemption drain
    d2 = os.path.join(args.workdir, "killdrain")
    p, info = _spawn(args, d2, "sched.preempt::1=kill@tA", resume=False,
                     fleet=True, extra_env={case: "preempt"})
    if p.returncode != -9:
        fail(f"kill during preemption drain did not crash the process "
             f"(rc={p.returncode})", p)
    else:
        p2, info2 = _spawn(args, d2, "", resume=True, fleet=True,
                           extra_env={case: "preempt"})
        if p2.returncode != 0 or not info2 or not info2.get("ok"):
            fail(f"killdrain resume rc={p2.returncode}: {info2}", p2)
        elif (not info2.get("bit_equal")
              or not info2.get("resume_fast_forwarded_pieces")):
            fail(f"killdrain resume diverged or recomputed: {info2}")
        else:
            print(f"# kill@drain + resume -> ok (ffwd="
                  f"{info2['resume_fast_forwarded_pieces']})", flush=True)

    # -- leg 3: fleet resize world 4 -> 2, zero failed tenants
    d3 = os.path.join(args.workdir, "resize")
    p, info = _spawn(args, d3, "", resume=False, fleet=True, world=4,
                     extra_env={case: "resize",
                                "CYLON_TPU_TORCH_FLEET_TARGET": "2"})
    if p.returncode != RESUMABLE_EXIT or not info \
            or not info.get("resumable"):
        fail(f"resize leg did not drain resumably rc={p.returncode}: "
             f"{info}", p)
    elif info.get("failed_typed"):
        fail(f"resize drain failed tenants typed: {info}")
    elif info.get("resize_target") != 2:
        fail(f"resize drain carried wrong target: {info}")
    else:
        p2, info2 = _spawn(args, d3, "", resume=True, fleet=True, world=2,
                           extra_env={case: "resize"})
        if p2.returncode != 0 or not info2 or not info2.get("ok"):
            fail(f"resize resume rc={p2.returncode}: {info2}", p2)
        elif not info2.get("bit_equal") or info2.get("failed_typed"):
            fail(f"resize resume diverged or failed tenants: {info2}")
        elif not info2.get("resume_world_mismatch"):
            fail(f"resize resume never took the cross-world reshard "
                 f"path: {info2}")
        else:
            print(f"# resize 4->2 + resume -> ok (world_mismatch="
                  f"{info2['resume_world_mismatch']}, ffwd="
                  f"{info2.get('resume_fast_forwarded_pieces', 0)})",
                  flush=True)

    # -- leg 4: the admission deadline is typed, not a hang
    d4 = os.path.join(args.workdir, "deadline")
    p, info = _spawn(args, d4, "", resume=False, fleet=True,
                     extra_env={case: "deadline",
                                "CYLON_TPU_TORCH_ADMISSION_TIMEOUT_S":
                                    "0.3"})
    if p.returncode != 0 or not info or not info.get("ok"):
        fail(f"deadline leg rc={p.returncode}: {info}", p)
    elif not info.get("timeout_typed") or not info.get("tA_bit_equal"):
        fail(f"deadline leg: expected typed AdmissionTimeoutError with "
             f"tA unharmed, got {info}")
    else:
        print(f"# admission deadline -> ok (typed, "
              f"timeouts={info['admission_timeouts']})", flush=True)

    return _finish(args, own_workdir, {"fleet_legs": 4}, failures)


def run_soak(args) -> int:
    """The core soak: the baseline held against the numpy oracle (and, on
    the card, launching both kernels, the first launch of each bit-equal
    to its plain version), then the pinned schedules and the draws."""
    import numpy as np
    rng = np.random.default_rng(args.seed)
    own_workdir = args.workdir is None
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_soak_")

    schedules = _pinned_schedules()
    while len(schedules) < args.schedules:
        schedules.append(_draw_schedule(rng))
    schedules = schedules[:args.schedules]

    # the numpy oracle, computed while the baseline child runs (numpy's
    # sort releases the GIL)
    import threading
    orc: dict = {}

    def oracle():
        t = time.perf_counter()
        cols = oracle_columns(SOAK_SEED, args.rows)
        orc.update(names=sorted(cols), sha=_result_sha(cols),
                   seconds=time.perf_counter() - t)
    th = threading.Thread(target=oracle, daemon=True)
    th.start()
    # the uninjected baseline: the bit-equality oracle
    p, info = _spawn(args, os.path.join(args.workdir, "baseline"), "",
                     resume=False, check_kernels=args.device != "cpu")
    th.join()
    if p.returncode != 0 or not info or not info.get("sha"):
        return _baseline_failed(args, p, "soak", own_workdir)
    baseline_sha = info["sha"]
    print(f"# baseline sha={baseline_sha[:16]} rows={info['rows']} "
          f"launches={info.get('kernel_launches')}", flush=True)
    failures: list = []
    oracle_sha = orc.get("sha") if orc.get("names") == info.get("columns") \
        else None
    if oracle_sha != baseline_sha:
        failures.append(f"the baseline differs from the numpy oracle "
                        f"(columns {info.get('columns')})")
    launches = info.get("kernel_launches") or {}
    first = info.get("first_launch") or {}
    if args.device != "cpu":
        if not launches.get("windowed_gather") \
                or not launches.get("splitter_probe"):
            failures.append(f"the baseline launched K1 "
                            f"{launches.get('windowed_gather')} and K2 "
                            f"{launches.get('splitter_probe')} times: both "
                            "must launch")
        for name in ("k1", "k2"):
            if not (first.get(name) or {}).get("bit_equal"):
                failures.append(f"{name}'s first launch is not bit-equal "
                                f"to its plain version: {first.get(name)}")
    baseline = {"sha": baseline_sha, "rows": info["rows"],
                "seconds": round(p.seconds, 3), "kernel_launches": launches,
                "first_launch": first,
                "oracle": "equal" if oracle_sha == baseline_sha
                else "differs", "oracle_s": round(orc.get("seconds", 0), 3)}

    outcomes = [_run_schedule(args, i, sched, baseline_sha, failures)
                for i, sched in enumerate(schedules)]
    return _finish(args, own_workdir,
                   {"schedules": len(schedules), "seed": args.seed},
                   failures, rows=args.rows, chunks=args.chunks,
                   world=args.world, baseline=baseline, outcomes=outcomes)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog=f"python -m {MODULE}",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--schedules", type=int, default=20)
    ap.add_argument("--rows", type=int, default=3000)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the children's device: cuda (the card) or cpu")
    ap.add_argument("--check-kernels", action="store_true",
                    help="(worker) hold the first launch of each kernel "
                         "bit-equal to its plain version")
    ap.add_argument("--concurrent", type=int, default=1,
                    help="K>1: the K-tenant flow (kill one tenant "
                         "mid-query, resume, every tenant bit-equal to "
                         "its solo run)")
    ap.add_argument("--only", type=int, default=None,
                    help="(worker) restrict the concurrent scheduler to "
                         "one tenant — the solo bit-equality leg")
    ap.add_argument("--oocore", action="store_true",
                    help="the out-of-core flow (budget caps force the "
                         "disk tier; enospc/corrupt/kill schedules end "
                         "bit-equal, the unarmed leg writes nothing)")
    ap.add_argument("--stream", action="store_true",
                    help="the streaming-ingest flow (SIGKILL mid-ingest, "
                         "the resume fast-forwards the committed view "
                         "state, bit-equal)")
    ap.add_argument("--elastic", action="store_true",
                    help="the elastic-resume flow (checkpoint at W=2, "
                         "SIGKILL/SIGTERM mid-run, resume at W=1 and at "
                         "W=2 after a re-shard, bit-equal)")
    ap.add_argument("--skew", action="store_true",
                    help="the adaptive-skew-split flow (faults inside a "
                         "split join recover onto the SAME voted plan; "
                         "the armed run at skew 0 adds no exchange rows)")
    ap.add_argument("--skew-frac", type=float, default=0.8,
                    help="(worker) fraction of probe rows on the hot key")
    ap.add_argument("--compile", dest="compile_flow", action="store_true",
                    help="the compile-lifecycle flow (a kill inside a "
                         "build quarantines it, a poisoned manifest entry "
                         "rebuilds, a stall surfaces typed, the unarmed "
                         "leg writes nothing)")
    ap.add_argument("--multislice", action="store_true",
                    help="the two-slice topology flow (two-hop route "
                         "bit-equal to flat with a voted plan and 1/R "
                         "cross-slice messages; a whole-slice kill "
                         "resumes through the re-shard)")
    ap.add_argument("--audit", action="store_true",
                    help="the data-integrity audit flow (the armed "
                         "corruption drill caught and recomputed "
                         "bit-equal on every route; persistent "
                         "corruption aborts typed)")
    ap.add_argument("--fleet", action="store_true",
                    help="the fleet-survival flow (preempt and requeue, "
                         "a kill inside a preemption drain, a resize "
                         "4->2, a typed admission deadline)")
    ap.add_argument("--world", type=int, default=4,
                    help="the world size of a child's VirtualMeshConfig")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker:
        return worker(args)
    import torch

    from ..status import DeviceUnavailableError
    try:
        if torch.device(args.device).type == "cuda" \
                and not torch.cuda.is_available():
            raise DeviceUnavailableError(
                f"--device {args.device}: torch sees no CUDA device; pass "
                "--device cpu to soak on the host")
    except DeviceUnavailableError as e:
        print(f"chaos-soak: DeviceUnavailableError: {e}", file=sys.stderr)
        return 2
    flows = ((args.oocore, run_oocore), (args.skew, run_skew),
             (args.audit, run_audit), (args.multislice, run_multislice),
             (args.stream, run_stream), (args.compile_flow, run_compile),
             (args.elastic, run_elastic), (args.fleet, run_fleet),
             (args.concurrent > 1, run_concurrent))
    run = next((fn for on, fn in flows if on), run_soak)
    _CHILDREN["t0"] = time.perf_counter()
    # one compile directory for every child (the --compile flow arms its
    # own per leg): the first child builds the kernels, the rest load them
    args.compile_cache = tempfile.mkdtemp(prefix="chaos_ccache_")
    try:
        return run(args)
    finally:
        shutil.rmtree(args.compile_cache, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
