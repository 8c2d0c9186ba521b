"""The multi-process transport (ctx/context.DistributedConfig): P gloo
processes on the CPU, V ranks each, held against one process.

This file is both the pytest module and the per-process driver:

    python tests/test_torch_multiprocess.py <pid> <nproc> <addr> <V> <out.npz> [legs]

Each driver process joins a gloo world on ``127.0.0.1`` with
``device="cpu"``, builds the same seeded host tables (SPMD ingest: every
process uploads only its own ranks' blocks), runs the legs of
``tests/multihost_driver.py`` that the port has (not the topology and
integrity-audit legs, but for the armed join with its corrupt drill;
``kill_resume`` and ``elastic_resume`` are
tests/test_torch_multiprocess_ckpt.py's, the topology
tests/test_torch_multiprocess_ops.py's) and saves
what it saw: every result table's layout gathered whole (valid counts,
capacity, each shard's rows and padding) plus each leg's agreement
facts (the sentinel leg: its collective log, armed for one
iteration).  The parent test holds each process's layouts bit-equal to the
port's ``VirtualMeshConfig(W, device="cpu")`` and to the reference's
``CPUMeshConfig(W)`` in-process, and checks that every voted leg agreed
on every process.  At module level only torch, numpy and the port are
imported; jax and ``cylon_tpu`` are imported inside the test functions.

Worlds: P = 2 × V = 2 runs every leg; the main leg alone also runs at
P = 4 × V = 2 (W = 8) and P = 3 × V = 1 (W = 3).  Every spawn has a
timeout and kills its processes when it runs out.
"""

import json
import os
import socket
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import cylon_tpu_torch as pct  # noqa: E402
from cylon_tpu_torch import config as pconfig  # noqa: E402

N_ROWS = 3000
AGGS = [("a", "sum"), ("b", "mean")]
SPAWN_TIMEOUT_S = 150


def _inputs(n=N_ROWS, seed=11):
    """The main leg's two tables: int64 keys, an int64 and an
    integer-valued float64 payload (exact sums, so float results are
    bit-equal)."""
    rng = np.random.default_rng(seed)
    return ({"k": rng.integers(0, 500, n).astype(np.int64),
             "a": rng.integers(0, 1000, n).astype(np.int64)},
            {"k": rng.integers(0, 500, n).astype(np.int64),
             "b": rng.integers(0, 1000, n).astype(np.float64)})


# ---------------------------------------------------------------------------
# the legs, over the port's API on any env (the driver's distributed one,
# or the parent's virtual mesh of the same world)
# ---------------------------------------------------------------------------

def _put(out: dict, name: str, t, full) -> None:
    """Record table ``t``'s layout under ``name``: valid counts, capacity
    and each column's rows across every shard, padding included."""
    out[f"{name}|vc"] = np.asarray(t.valid_counts, np.int64)
    out[f"{name}|cap"] = np.asarray([t.capacity], np.int64)
    out[f"{name}|names"] = np.asarray(t.column_names)
    for cn in t.column_names:
        c = t.column(cn)
        out[f"{name}|d|{cn}"] = full(c.data)
        if c.validity is not None:
            out[f"{name}|v|{cn}"] = full(c.validity)


def port_api(w: int):
    """The port's operators, and ``full`` pulling a row-sharded tensor
    whole (every process's blocks in a distributed world)."""
    from types import SimpleNamespace
    from cylon_tpu_torch.utils.host import host_array
    return SimpleNamespace(
        Table=pct.Table, join_tables=pct.join_tables,
        groupby_aggregate=pct.groupby_aggregate, sort_table=pct.sort_table,
        GroupBySink=pct.GroupBySink, pipelined_join=pct.pipelined_join,
        repartition=pct.repartition, slice_table=pct.slice_table,
        head=pct.head, tail=pct.tail, set_operation=pct.set_operation,
        DataFrame=pct.DataFrame, full=lambda x: host_array(x, world=w))


def reference_api():
    """The reference's operators under the same names."""
    from types import SimpleNamespace
    import cylon_tpu as rct
    from cylon_tpu import exec as rexec
    from cylon_tpu import relational as rrel
    return SimpleNamespace(
        Table=rct.Table, join_tables=rrel.join_tables,
        groupby_aggregate=rrel.groupby_aggregate, sort_table=rrel.sort_table,
        GroupBySink=rexec.GroupBySink, pipelined_join=rexec.pipelined_join,
        repartition=rrel.repartition, slice_table=rrel.slice_table,
        head=rrel.head, tail=rrel.tail, full=np.asarray)


def leg_main(ct, env, out):
    """Ingest, then join → groupby(sum, mean) → sort, and the deferred
    join materialized."""
    full = ct.full
    left, right = _inputs()
    lt = ct.Table.from_pydict(left, env)
    rt = ct.Table.from_pydict(right, env)
    _put(out, "ingest_l", lt, full)
    _put(out, "ingest_r", rt, full)
    j = ct.join_tables(lt, rt, "k", "k")
    g = ct.groupby_aggregate(j, "k", AGGS)
    _put(out, "groupby", g, full)
    _put(out, "sorted", ct.sort_table(g, "k"), full)
    _put(out, "join", ct.join_tables(lt, rt, "k", "k"), full)
    return lt, rt


def leg_semi_anti(ct, env, out, lt, rt):
    full = ct.full
    _put(out, "semi", ct.join_tables(lt, rt, "k", "k", how="semi"), full)
    _put(out, "anti", ct.join_tables(lt, rt, "k", "k", how="anti"), full)
    _put(out, "left", ct.join_tables(lt, rt, "k", "k", how="left"), full)


def leg_sorts(ct, env, out, lt, rt):
    """The sort-based groupby (non-associative ops through the raw route,
    associative ones through the combine route) and the sample sort with
    both methods."""
    full = ct.full
    _put(out, "gb_combine",
         ct.groupby_aggregate(lt, "a", [("k", "sum"), ("k", "max")]), full)
    _put(out, "gb_raw",
         ct.groupby_aggregate(lt, "a", [("k", "median")]), full)
    _put(out, "sort_initial", ct.sort_table(lt, ["a", "k"]), full)
    _put(out, "sort_regular", ct.sort_table(rt, "b", ascending=False,
                                            method="regular"), full)


def leg_pipelined(ct, env, out, lt, rt):
    """``pipelined_join(n_chunks=2)`` into a ``GroupBySink`` (K2's plain
    version ranges every piece, K1's plain version gathers the fused
    pushdown on the CPU)."""
    full = ct.full
    sink = ct.GroupBySink("k", [("a", "sum"), ("b", "sum")])
    ct.pipelined_join(lt, rt, "k", "k", n_chunks=2, sink=sink)
    res = sink.finalize()
    _put(out, "pipe_sink", res, full)
    out["pipe_sink_multiset|rows"] = _rows(res)
    rows = ct.pipelined_join(lt, rt, "k", "k", n_chunks=2)
    _put(out, "pipe_rows", rows, full)
    out["pipe_multiset|rows"] = _rows(rows)


def leg_repart(ct, env, out, lt, rt):
    """Repartition, row ranges and the table collectives."""
    full = ct.full
    w = env.world_size
    _put(out, "repart", ct.repartition(lt), full)
    _put(out, "repart_uneven",
         ct.repartition(lt, [0] * (w - 1) + [lt.row_count]), full)
    _put(out, "slice", ct.slice_table(lt, 700, 1100), full)
    _put(out, "head", ct.head(rt, 123), full)
    _put(out, "tail", ct.tail(rt, 456), full)
    _put(out, "allgather", env.allgather(rt), full)
    _put(out, "gather", env.gather(rt, root=w - 1), full)
    _put(out, "bcast", env.bcast(lt, root=1), full)
    col = lt.column("a")
    out["allreduce|sum"] = env.allreduce(col, "sum", lt.valid_counts)
    out["allreduce|max"] = env.allreduce(col, "max", lt.valid_counts)


def _rows(t) -> np.ndarray:
    """A table's rows as one sorted int64 matrix (a multiset compare)."""
    d = t.to_pydict() if hasattr(t, "to_pydict") else {
        k: v.to_numpy() for k, v in t.to_pandas().items()}
    m = np.stack([np.asarray(d[n]).astype(np.float64).view(np.int64)
                  if np.asarray(d[n]).dtype.kind == "f"
                  else np.asarray(d[n]).astype(np.int64)
                  for n in sorted(d)], axis=1)
    return m[np.lexsort(m.T[::-1])] if len(m) else m


def _json(out, name, obj) -> None:
    out[name] = np.frombuffer(json.dumps(obj, sort_keys=True).encode(),
                              np.uint8)


def leg_guard(ct, env, out, lt, rt):
    """A predicted receive-budget fault injected on process 0 only: the
    guard's vote makes every process raise and retry through the 4-chunk
    fallback, and the result equals the uninjected run."""
    from cylon_tpu_torch.exec import recovery
    base = _rows(ct.join_tables(lt, rt, "k", "k"))
    recovery.install_faults("shuffle.recv_guard:0:1=predicted")
    recovery.reset_events()
    try:
        got = _rows(ct.join_tables(lt, rt, "k", "k"))
        _json(out, "guard|events", recovery.recovery_events())
    finally:
        recovery.install_faults("")
    out["guard|same"] = np.asarray([np.array_equal(got, base)])


def leg_spill(ct, env, out, lt, rt):
    """Eviction pressure on process 0 only (nth 2: the probe side's
    source is registered by then): the spill vote makes every process
    evict the same owners in the same order, bit-equal to the
    unpressured run."""
    from cylon_tpu_torch.exec import memory, recovery
    base = _rows(ct.pipelined_join(lt, rt, "k", "k", n_chunks=4))
    recovery.install_faults("spill.evict:0:2=predicted")
    recovery.reset_events()
    memory.reset_stats()
    try:
        got = _rows(ct.pipelined_join(lt, rt, "k", "k", n_chunks=4))
    finally:
        recovery.install_faults("")
    out["spill|same"] = np.asarray([np.array_equal(got, base)])
    _json(out, "spill|log", memory.eviction_log())
    out["spill|events"] = np.asarray([memory.stats()["spill_events"]])


def leg_obs(ct, env, out, lt, rt):
    """The rank report over every process's phase table, and the comm
    matrix, verified identical across processes by its own report."""
    from cylon_tpu_torch.obs import comm, metrics, rank_report
    from cylon_tpu_torch.utils import timing
    prev = timing.mode()
    timing.enable("async")
    timing.reset()
    ct.pipelined_join(lt, rt, "k", "k", n_chunks=4)
    timing.enable(prev)
    rank_report.arm()
    rep = rank_report.report()
    rank_report.arm(False)
    out["rank|ranks"] = np.asarray([rep["ranks"]])
    out["rank|phases"] = np.asarray(sorted(rep["phases"]))
    comm.arm()
    comm.reset()
    rows0 = metrics.counter("exchange_rows_total").value
    ct.join_tables(lt, rt, "k", "k")
    crep = comm.report()
    comm.arm(False)
    comm.reset()
    out["comm|rows_delta"] = np.asarray(
        [metrics.counter("exchange_rows_total").value - rows0])
    _json(out, "comm|report", crep)


def leg_stream(ct, env, out, lt, rt):
    """Seeded micro-batches into a TumblingWindowJoin: the watermark
    min-vote closes the same windows on every process."""
    from cylon_tpu_torch.stream import TumblingWindowJoin
    srng = np.random.default_rng(29)
    dims = ct.Table.from_pydict(
        {"k": np.arange(16, dtype=np.int64),
         "dim": np.arange(16, dtype=np.int64) * 3}, env)
    wj = TumblingWindowJoin(env, key="k", time_col="t", window=100,
                            build=dims, build_on="k", lateness=10)
    for i in range(3):
        wj.append({"k": srng.integers(0, 16, 300).astype(np.int64),
                   "t": (i * 100 + srng.integers(0, 100, 300)).astype(
                       np.int64),
                   "v": srng.integers(0, 50, 300).astype(np.int64)})
    out["stream|agreed"] = np.asarray([wj.watermark()])
    out["stream|closed"] = np.asarray([wid for wid, _ in wj.closed])
    sig = [zlib.crc32(_rows(o).tobytes()) if o is not None else 0
           for _, o in wj.closed]
    out["stream|sig"] = np.asarray(sig, np.int64)


def leg_skew(ct, env, out, lt, rt):
    """A hot key on ~70% of the probe rows arms the skew split: every
    process adopts the same plan hash, and the split join and its fused
    groupby equal the unsplit plan's."""
    from cylon_tpu_torch.relational import skew
    full = ct.full
    rng = np.random.default_rng(31)
    ns = 6000
    hot = np.int64(77)
    sk = rng.integers(0, 600, ns).astype(np.int64)
    sk = np.where(rng.random(ns) < 0.7, hot, sk)
    sl = ct.Table.from_pydict(
        {"k": sk, "a": rng.integers(0, 100, ns).astype(np.int64)}, env)
    bk = rng.integers(0, 600, ns).astype(np.int64)
    bk[bk == hot] = hot + 1
    bk[0] = hot
    sr = ct.Table.from_pydict(
        {"k": bk, "b": rng.integers(0, 100, ns).astype(np.int64)}, env)
    js = ct.join_tables(sl, sr, "k", "k")
    gs = ct.groupby_aggregate(js, "k", [("a", "sum"), ("b", "sum")])
    plan = skew.last_plan()
    out["skew|hash"] = np.asarray(
        [-1 if plan is None else plan.plan_hash() & 0x7FFFFFFFFFFFFFFF],
        np.int64)
    _put(out, "skew_groupby", gs, full)
    _put(out, "skew_join", js, full)
    prev = pconfig.SKEW_SPLIT
    pconfig.SKEW_SPLIT = False
    try:
        ju = ct.join_tables(sl, sr, "k", "k")
        out["skew|join_same"] = np.asarray([np.array_equal(
            _rows(js), _rows(ju))])
        out["skew|groupby_same"] = np.asarray([np.array_equal(
            _rows(gs), _rows(ct.groupby_aggregate(
                ju, "k", [("a", "sum"), ("b", "sum")])))])
    finally:
        pconfig.SKEW_SPLIT = prev


def leg_refusals(ct, env, out, lt, rt):
    """The one multi-process refusal, a typed error: the hashed-string
    sort (InvalidError, as the reference).  Every other case runs across
    processes and must not raise: armed checkpoints, the scheduler, the
    stream table, the incremental view, the set operations, partitioned
    IO, the Series and the TPC-H tables."""
    import tempfile
    from cylon_tpu_torch import io, tpch
    from cylon_tpu_torch.exec import QueryScheduler
    from cylon_tpu_torch.stream import IncrementalView, StreamTable
    names = np.asarray([f"name{i:05d}" for i in range(N_ROWS)],
                       dtype=object)
    prev = (pconfig.STRING_HASH_MIN_ROWS, pconfig.STRING_HASH_RATIO)
    pconfig.STRING_HASH_MIN_ROWS, pconfig.STRING_HASH_RATIO = 100, 0.01
    try:
        st = ct.Table.from_pydict({"s": names, "a": lt.to_pydict()["a"]},
                                  env)
    finally:
        pconfig.STRING_HASH_MIN_ROWS, pconfig.STRING_HASH_RATIO = prev
    io_dir = os.environ.get("TORCH_MP_IO_DIR") or tempfile.mkdtemp()
    cases = {
        "hashed_sort": lambda: ct.sort_table(st, "s"),
        "checkpoint": lambda: _armed_checkpoint(ct, lt, rt),
        "scheduler": lambda: QueryScheduler(env),
        "io_write_dist": lambda: io.write_csv_dist(lt, os.path.join(
            io_dir, "x.csv")),
        "io_read_dist": lambda: io.read_csv_dist([os.path.join(
            io_dir, f"x_{r}.csv") for r in range(env.world_size)], env),
        "set_op": lambda: ct.set_operation(lt, lt, "union"),
        "stream_table": lambda: StreamTable(env, "k"),
        "incremental_view": lambda: _view_read(env, StreamTable,
                                               IncrementalView),
        "series": lambda: ct.DataFrame({"a": np.arange(8)}, env=env)["a"],
        "tpch": lambda: tpch.generate_tables(0.001, env),
    }
    got = {}
    for name, fn in cases.items():
        if name == "io_read_dist":
            env.barrier()           # every process has written its files
        try:
            fn()
            got[name] = "none"
        except Exception as e:  # noqa: BLE001 — the class is the result
            got[name] = type(e).__name__
    _json(out, "refusals", got)


def _view_read(env, StreamTable, IncrementalView):
    """A view over a stream of one batch, read once."""
    st = StreamTable(env, "k")
    view = IncrementalView(st, "k", [("k", "count")])
    st.append({"k": np.arange(8, dtype=np.int64)})
    return view.read()


def _armed_checkpoint(ct, lt, rt):
    import tempfile
    from cylon_tpu_torch.exec import checkpoint
    prev = os.environ.get("CYLON_TPU_TORCH_CKPT_DIR")
    os.environ["CYLON_TPU_TORCH_CKPT_DIR"] = tempfile.mkdtemp()
    try:
        ct.pipelined_join(lt, rt, "k", "k", n_chunks=2)
    finally:
        if prev is None:
            del os.environ["CYLON_TPU_TORCH_CKPT_DIR"]
        else:
            os.environ["CYLON_TPU_TORCH_CKPT_DIR"] = prev


def audit_fingerprints(ct, env, lt, rt) -> np.ndarray:
    """The armed BASELINE join → groupby: the fingerprints of its result
    and of the left input (exec/integrity.table_fingerprint), which do
    not depend on the process layout."""
    from cylon_tpu_torch.exec import integrity
    g = ct.groupby_aggregate(ct.join_tables(lt, rt, "k", "k"), "k", AGGS)
    return np.asarray([integrity.table_fingerprint(g),
                       integrity.table_fingerprint(lt)], np.uint64)


def leg_audit(ct, env, out, lt, rt):
    """Armed (``CYLON_TPU_TORCH_AUDIT=1``): the BASELINE fingerprints and
    the audit counters; then ``exchange.corrupt`` on process 1 only, once
    (every process recomputes, the result unchanged) and on every
    occurrence (every process aborts typed)."""
    from cylon_tpu_torch.exec import integrity, recovery
    from cylon_tpu_torch.status import DataIntegrityError
    os.environ["CYLON_TPU_TORCH_AUDIT"] = "1"
    integrity.rearm()
    try:
        s0 = integrity.stats()
        out["audit|fp"] = audit_fingerprints(ct, env, lt, rt)
        s1 = integrity.stats()
        out["audit|counts"] = np.asarray(
            [s1[k] - s0[k] for k in ("conservation_checks",
                                     "fingerprint_checks",
                                     "fingerprint_votes", "violations")])
        base = _rows(ct.join_tables(lt, rt, "k", "k", how="left"))
        for tag, spec in (("once", "exchange.corrupt:1=corrupt"),
                          ("always", "exchange.corrupt:1:*=corrupt")):
            recovery.install_faults(spec)
            try:
                got = _rows(ct.join_tables(lt, rt, "k", "k", how="left"))
                res = "same" if np.array_equal(got, base) else "differs"
            except DataIntegrityError as e:
                res = f"{type(e).__name__}:{e.site}"
            finally:
                _json(out, f"audit|{tag}_events", [
                    e for e in recovery.recovery_events()
                    if e["kind"] == "integrity"])
                recovery.install_faults("")
            out[f"audit|{tag}"] = np.asarray([res])
    finally:
        os.environ.pop("CYLON_TPU_TORCH_AUDIT", None)
        integrity.rearm()


def leg_sentinel(ct, env, out, lt, rt):
    """The runtime sentinel armed for one monolithic join → groupby: this
    process's collective log and its running digest."""
    from cylon_tpu_torch.analysis import runtime
    runtime.enable()
    runtime.reset()
    try:
        _rows(ct.groupby_aggregate(ct.join_tables(lt, rt, "k", "k"), "k",
                                   AGGS))
        out["sentinel|digest"] = np.asarray([runtime.collective_digest()])
        _json(out, "sentinel|log", runtime.collective_log())
    finally:
        runtime.disable()


PORT_LEGS = ("main", "semi_anti", "sorts", "pipelined", "repart")
PROC_LEGS = ("barrier", "guard", "spill", "obs", "stream", "skew",
             "refusals", "audit", "sentinel", "desync")


def run_port_legs(ct, env, legs) -> dict:
    out = {}
    lt, rt = leg_main(ct, env, out)
    for name in legs:
        if name != "main":
            globals()["leg_" + name](ct, env, out, lt, rt)
    return out


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _driver(argv) -> None:
    pid, nproc, addr, v, path = (int(argv[0]), int(argv[1]), argv[2],
                                 int(argv[3]), argv[4])
    legs = argv[5].split(",") if len(argv) > 5 else list(PORT_LEGS)
    env = pct.CylonEnv(pct.DistributedConfig(addr, pid, nproc,
                                             local_world=v, timeout_s=120),
                       device="cpu")
    assert env.world_size == v * nproc and env.rank == pid
    assert env.local_world == v and list(env.local_ranks) == \
        list(range(pid * v, (pid + 1) * v))
    assert env.backend == "gloo"
    ct = port_api(env.world_size)
    out = run_port_legs(ct, env, [x for x in legs if x in PORT_LEGS])
    if "barrier" in legs:
        # a barrier that really waits: process 1 arrives a second late
        env.barrier()
        if pid == 1:
            time.sleep(1.0)
        t0 = time.perf_counter()
        env.barrier()
        out["barrier|wait_s"] = np.asarray([time.perf_counter() - t0])
    lt = rt = None
    for name in PROC_LEGS:
        if name in legs and name not in ("barrier", "desync"):
            if lt is None:
                left, right = _inputs()
                lt = ct.Table.from_pydict(left, env)
                rt = ct.Table.from_pydict(right, env)
            env.barrier()
            globals()["leg_" + name](ct, env, out, lt, rt)
    if "desync" not in legs:
        np.savez(path, **out)
        env.finalize()
        return
    # the last leg: process 0 skips a vote that process 1 takes; the
    # watchdog turns the missing peer into RankDesyncError
    from cylon_tpu_torch.exec import recovery
    from cylon_tpu_torch.status import RankDesyncError
    env.barrier()
    done = os.path.join(os.path.dirname(path), "desync.done")
    if pid == 0:
        deadline = time.monotonic() + 20
        while not os.path.exists(done) and time.monotonic() < deadline:
            time.sleep(0.05)
        out["desync|error"] = np.asarray(["skipped"])
    else:
        pconfig.EXCHANGE_WATCHDOG_S = 5.0
        t0 = time.perf_counter()
        try:
            recovery.count_consensus(env, 1)
            out["desync|error"] = np.asarray(["none"])
        except RankDesyncError as e:
            out["desync|error"] = np.asarray(["RankDesyncError"])
        out["desync|s"] = np.asarray([time.perf_counter() - t0])
    np.savez(path, **out)
    if pid == 1:
        open(done, "w").close()
    sys.stdout.flush()
    os._exit(0)


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start(tmp, nproc, v, legs=None, extra_env=None, driver=None):
    """Launch ``nproc`` driver processes (not waited on): this file's, or
    the file ``driver`` names."""
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("CYLON_TPU_TORCH_FAULTS", None)
    env.update(extra_env or {})
    env["TORCH_MP_IO_DIR"] = str(tmp)
    paths = [os.path.join(str(tmp), f"p{nproc}v{v}_{i}.npz")
             for i in range(nproc)]
    cmd = [sys.executable, driver or os.path.abspath(__file__)]
    procs = [subprocess.Popen(
        cmd + [str(i), str(nproc), addr, str(v), paths[i]]
        + ([",".join(legs)] if legs else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=_ROOT) for i in range(nproc)]
    return procs, paths, time.monotonic() + SPAWN_TIMEOUT_S


def finish(handle):
    """Wait for a launch; returns ``(codes, outputs, results)`` with each
    process's saved dict (None where it saved none).  A process still
    running at the launch's deadline is killed, and so are its peers."""
    procs, paths, deadline = handle
    outs = []
    try:
        for p in procs:
            try:
                o, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                o, _ = p.communicate()
            outs.append(o)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = [dict(np.load(pth, allow_pickle=False)) if os.path.exists(pth)
           else None for pth in paths]
    return [p.returncode for p in procs], outs, res


def _assert_ok(codes, outs):
    for i, (c, o) in enumerate(zip(codes, outs)):
        assert c == 0, f"process {i} exited {c}:\n{o[-4000:]}"


_CACHE = {}
ALL_LEGS = PORT_LEGS + PROC_LEGS


#: the worlds this file runs, all launched together at first use
WORLDS = {(2, 2): ALL_LEGS, (4, 2): ("main",), (3, 1): ("main",),
          (1, 4): ("main",)}


def _world(tmp_path_factory, nproc, v):
    if "launched" not in _CACHE:
        _CACHE["launched"] = {
            key: start(tmp_path_factory.mktemp(f"mp{key[0]}{key[1]}"),
                       key[0], key[1], list(legs))
            for key, legs in WORLDS.items()}
    key = (nproc, v)
    if key not in _CACHE:
        _CACHE[key] = finish(_CACHE["launched"][key])
    codes, outs, res = _CACHE[key]
    _assert_ok(codes, outs)
    return res


def _virtual(w, legs=PORT_LEGS):
    key = ("virtual", w, legs)
    if key not in _CACHE:
        env = pct.CylonEnv(pct.VirtualMeshConfig(w), device="cpu")
        _CACHE[key] = run_port_legs(port_api(w), env, legs)
    return _CACHE[key]


def _reference(w):
    """The reference's legs on its ``CPUMeshConfig(W)``, in-process."""
    key = ("reference", w)
    if key not in _CACHE:
        import jax
        from cylon_tpu import config as rconfig
        from cylon_tpu.ctx.context import CPUMeshConfig
        import cylon_tpu as rct
        prev = rconfig.BROADCAST_JOIN_ROWS
        rconfig.BROADCAST_JOIN_ROWS = 0
        try:
            env = rct.CylonEnv(config=CPUMeshConfig(world_size=w))
            _CACHE[key] = run_port_legs(reference_api(), env, PORT_LEGS)
        finally:
            rconfig.BROADCAST_JOIN_ROWS = prev
            jax.clear_caches()
    return _CACHE[key]


def _assert_same(got: dict, want: dict, names):
    keys = sorted(k for k in want if k.split("|")[0] in names)
    assert keys, f"nothing to compare for {names}"
    for k in keys:
        assert k in got, k
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _load(res, name):
    """A leg's JSON fact from every process."""
    return [json.loads(bytes(r[name])) for r in res]


@pytest.fixture(autouse=True)
def _routes(monkeypatch):
    monkeypatch.setattr(pconfig, "BROADCAST_JOIN_ROWS", 0)


LEG_TABLES = {
    "main": ("ingest_l", "ingest_r", "groupby", "sorted", "join"),
    "semi_anti": ("semi", "anti", "left"),
    "sorts": ("gb_combine", "gb_raw", "sort_initial", "sort_regular"),
    "pipelined": ("pipe_sink", "pipe_rows"),
    "repart": ("repart", "repart_uneven", "slice", "head", "tail",
               "allgather", "gather", "bcast", "allreduce"),
}


@pytest.mark.parametrize("nproc,v", [(2, 2), (4, 2), (3, 1), (1, 4)])
def test_main_leg_matches_one_process(tmp_path_factory, nproc, v):
    """Ingest and join → groupby → sort, every process's view bit-equal,
    layout included, to the virtual mesh of the same world."""
    res = _world(tmp_path_factory, nproc, v)
    want = _virtual(nproc * v, ("main",))
    for r in res:
        _assert_same(r, want, LEG_TABLES["main"])


@pytest.mark.parametrize("leg", sorted(LEG_TABLES))
def test_leg_matches_one_process(tmp_path_factory, leg):
    res = _world(tmp_path_factory, 2, 2)
    want = _virtual(4)
    for r in res:
        _assert_same(r, want, LEG_TABLES[leg]
                     + (("pipe_multiset", "pipe_sink_multiset")
                        if leg == "pipelined" else ()))


@pytest.mark.parametrize("leg", sorted(LEG_TABLES))
def test_leg_matches_reference(tmp_path_factory, leg):
    """Each process's view against the reference's ``CPUMeshConfig(4)``
    run of the same leg (the pipelined join's results as multisets: the
    packages lay out its pieces differently, ROADMAP.md "Deviations that
    stay", PR 2)."""
    _world(tmp_path_factory, 1, 4)      # launch the worlds first
    want = _reference(4)
    res = _world(tmp_path_factory, 2, 2)
    names = LEG_TABLES[leg]
    if leg == "pipelined":
        names = ("pipe_multiset", "pipe_sink_multiset")
    for r in res:
        _assert_same(r, want, names)


def test_barrier_waits(tmp_path_factory):
    """Process 1 arrives a second late: process 0 leaves no earlier."""
    res = _world(tmp_path_factory, 2, 2)
    assert float(res[0]["barrier|wait_s"][0]) >= 0.9
    assert float(res[1]["barrier|wait_s"][0]) < 0.9


def test_guard_fault_on_one_process(tmp_path_factory):
    """A predicted fault injected on process 0 only: one recovery event
    on every process, the same one, and the uninjected result."""
    res = _world(tmp_path_factory, 2, 2)
    want = [{"site": "join", "kind": "predicted",
             "action": "retry_chunks_4"}]
    assert _load(res, "guard|events") == [want, want]
    assert all(bool(r["guard|same"][0]) for r in res)


def test_audit_fingerprints_and_corrupt_drill(tmp_path_factory):
    """Armed at 2 × 2: both processes hold the one-process world's
    fingerprints and the same audit counts; a one-shot corruption on
    process 1 is recomputed on both, a persistent one aborts both,
    typed, after the same single retry."""
    from cylon_tpu_torch.exec import integrity
    res = _world(tmp_path_factory, 2, 2)
    env = pct.CylonEnv(pct.VirtualMeshConfig(4), device="cpu")
    ct = port_api(4)
    left, right = _inputs()
    os.environ["CYLON_TPU_TORCH_AUDIT"] = "1"
    integrity.rearm()
    try:
        want = audit_fingerprints(ct, env, ct.Table.from_pydict(left, env),
                                  ct.Table.from_pydict(right, env))
    finally:
        os.environ.pop("CYLON_TPU_TORCH_AUDIT", None)
        integrity.rearm()
    for r in res:
        np.testing.assert_array_equal(r["audit|fp"], want)
        assert r["audit|once"].tolist() == ["same"]
        assert r["audit|always"].tolist() == [
            "DataIntegrityError:shuffle.recv"]
    np.testing.assert_array_equal(res[0]["audit|counts"],
                                  res[1]["audit|counts"])
    assert int(res[0]["audit|counts"][1]) > 0
    assert int(res[0]["audit|counts"][3]) == 0
    once, always = (_load(res, f"audit|{t}_events") for t in
                    ("once", "always"))
    assert once[0] == once[1] and len(once[0]) == 1
    assert once[0][0]["action"].startswith("retry")
    assert always[0] == always[1]
    assert [e["action"] for e in always[0]] == ["retry_chunks_4", "abort"]


def test_collective_logs_agree(tmp_path_factory):
    """Armed for one monolithic iteration at 2 × 2: both processes log
    the same collectives in the same order (CL202 finds nothing) and hold
    the same digest."""
    from cylon_tpu_torch.analysis import compare_logs
    res = _world(tmp_path_factory, 2, 2)
    logs = _load(res, "sentinel|log")
    assert logs[0] and compare_logs(dict(enumerate(logs))) == []
    assert {e[1] for e in logs[0]} >= {"all_gather", "all_to_all",
                                       "all_reduce"}
    digests = [r["sentinel|digest"].tolist() for r in res]
    assert digests[0] == digests[1] and digests[0][0]


def test_spill_same_evictions(tmp_path_factory):
    res = _world(tmp_path_factory, 2, 2)
    logs = _load(res, "spill|log")
    assert logs[0] and logs[0] == logs[1]
    assert all(int(r["spill|events"][0]) >= 1 for r in res)
    assert all(bool(r["spill|same"][0]) for r in res)


def test_comm_and_rank_report(tmp_path_factory):
    """The comm report (verified across processes by its own allgather)
    is byte-identical everywhere and reconciles with the counters; the
    rank report has one row per process and the pipeline's phases."""
    res = _world(tmp_path_factory, 2, 2)
    assert bytes(res[0]["comm|report"]) == bytes(res[1]["comm|report"])
    rep = _load(res, "comm|report")[0]
    assert rep["world"] == 4 and rep["exchanges"] >= 1
    assert rep["total_rows"] == int(res[0]["comm|rows_delta"][0])
    for r in res:
        assert int(r["rank|ranks"][0]) == 2
        assert "pipe.piece_join" in set(r["rank|phases"].tolist())


def test_watermark_closes_same_windows(tmp_path_factory):
    res = _world(tmp_path_factory, 2, 2)
    for k in ("stream|agreed", "stream|closed", "stream|sig"):
        np.testing.assert_array_equal(res[0][k], res[1][k], err_msg=k)
    assert len(res[0]["stream|closed"]) >= 1


def test_skew_plan_hash_identical(tmp_path_factory):
    res = _world(tmp_path_factory, 2, 2)
    assert int(res[0]["skew|hash"][0]) >= 0
    assert int(res[0]["skew|hash"][0]) == int(res[1]["skew|hash"][0])
    for r in res:
        assert bool(r["skew|join_same"][0])
        assert bool(r["skew|groupby_same"][0])
    _assert_same(res[1], res[0], ("skew_groupby", "skew_join"))


def test_refusals(tmp_path_factory):
    """The hashed-string sort still raises across processes; armed
    checkpoints, the scheduler, the stream table and the incremental
    view, refused until their multi-process forms came, now run."""
    res = _world(tmp_path_factory, 2, 2)
    runs = ("io_read_dist", "io_write_dist", "set_op", "series", "tpch",
            "checkpoint", "scheduler", "stream_table", "incremental_view")
    for got in _load(res, "refusals"):
        assert got.pop("hashed_sort") == "InvalidError"
        assert {k: got.pop(k) for k in runs} == dict.fromkeys(runs, "none")
        assert got == {}, got


def test_desync_raises_without_hang(tmp_path_factory):
    """Process 0 skips a vote: process 1 raises RankDesyncError at its
    5 s watchdog, and both processes exit."""
    res = _world(tmp_path_factory, 2, 2)
    assert str(res[0]["desync|error"][0]) == "skipped"
    assert str(res[1]["desync|error"][0]) == "RankDesyncError"
    assert 4.5 <= float(res[1]["desync|s"][0]) < 15


def test_config_backends():
    """``backend=None`` takes gloo on the CPU; NCCL on the CPU is refused
    by name, and a card that is not there is never replaced by the
    CPU."""
    cfg = pct.DistributedConfig("127.0.0.1:1", 0, 1, local_world=2)
    assert cfg.world_size == 2 and cfg.backend is None
    with pytest.raises(pct.InvalidError):
        pct.CylonEnv(pct.DistributedConfig("127.0.0.1:1", 0, 1,
                                           backend="nccl"), device="cpu")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(pct.DeviceUnavailableError):
            pct.CylonEnv(pct.DistributedConfig("127.0.0.1:1", 0, 1))
    with pytest.raises(pct.InvalidError):
        pct.DistributedConfig("127.0.0.1:1", 2, 2)
    with pytest.raises(pct.InvalidError):
        pct.DistributedConfig("127.0.0.1:1", 0, 1, backend="mpi")


def _cards(monkeypatch, n: int) -> None:
    """Pretend the host has ``n`` CUDA cards, and fail any rendezvous."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)

    def no_rendezvous(*a, **k):
        raise AssertionError("a rendezvous was attempted")
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        no_rendezvous)


def test_local_rank_picks_the_card(monkeypatch):
    """Under torchrun, ``LOCAL_RANK=2`` of 4 cards is ``cuda:2``: every
    process its own card, not all on card 0."""
    import torch
    _cards(monkeypatch, 4)
    monkeypatch.setenv("LOCAL_RANK", "2")
    cfg = pct.DistributedConfig("127.0.0.1:1", 2, 4)
    assert cfg.devices == (torch.device("cuda", 2),)


def test_local_rank_without_its_card_raises(monkeypatch):
    """``LOCAL_RANK=1`` on a host of one card raises
    ``DeviceUnavailableError`` at the config, before any rendezvous: no
    modulo onto card 0, no fallback."""
    _cards(monkeypatch, 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(pct.DeviceUnavailableError):
        pct.DistributedConfig("127.0.0.1:1", 1, 2)
    with pytest.raises(pct.DeviceUnavailableError):
        pct.CylonEnv(pct.DistributedConfig("127.0.0.1:1", 1, 2))


def test_explicit_device_ignores_local_rank(monkeypatch):
    """An explicit ``device`` wins over ``LOCAL_RANK`` (the one-card gloo
    worlds name theirs), whatever the card count."""
    import torch
    _cards(monkeypatch, 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    cfg = pct.DistributedConfig("127.0.0.1:1", 0, 1, device="cpu")
    assert cfg.devices == ("cpu",)
    monkeypatch.delenv("LOCAL_RANK")
    cfg = pct.DistributedConfig("127.0.0.1:1", 0, 1)
    assert cfg.devices == (None,)


if __name__ == "__main__":
    _driver(sys.argv[1:])
