"""Durable checkpoints across processes: gloo worlds on the CPU killed,
drained, resumed and re-sharded, held against one process and against
the reference.

This file is both the pytest module and the per-process driver (the
protocol of tests/test_torch_multiprocess.py, whose helpers it uses):

    python tests/test_torch_multiprocess_ckpt.py <pid> <nproc> <addr> <V> <out.npz> <scenario>

The parent sets the checkpoint switches in each world's environment
(``CYLON_TPU_TORCH_CKPT_DIR``, ``CYLON_TPU_TORCH_RESUME``,
``CYLON_TPU_TORCH_FAULTS``, ``CYLON_TPU_TORCH_PREEMPT_GRACE_S``,
``CYLON_TPU_TORCH_WATCHDOG_S``).  Scenarios, all at 2 processes × 2
ranks unless named otherwise:

* ``kill_resume`` (``tests/multihost_driver.py:129``): process 0 is
  SIGKILLed at its third ``ckpt.write``; process 1 raises
  ``RankDesyncError`` and exits nonzero.  The resume shows one manifest
  epoch on both processes, ``ffwd > 0`` and the uninterrupted digest.
* ``elastic_resume`` (``tests/multihost_driver.py:74-127``): the
  two-stage TPC-H-shaped workload, killed at stage 2's first write,
  resumed in one process at W = 2: the re-shard path, the pandas
  oracle's answer.
* ``grow``: a complete stage written by one process at W = 4 resumed by
  2 × 2 (the re-shard path: a new process layout of the same world),
  then resumed again by 2 × 2 (a plain fast-forward).  Rank directories
  whose manifests disagree on ``procs`` then make the stage start over.
* ``tamper``: process 0's staged epoch is one ahead: both processes
  raise ``RankDesyncError`` at the commit vote, and no manifest is
  published.
* ``drain``: a ``term`` sent to process 0 drains both processes at the
  same piece boundary (``ResumableAbort``), each writing
  ``RESUME_TOKEN.json``; the resume equals the uninterrupted run.
* ``audit``: the kill-resume join written with the audit armed
  (``CYLON_TPU_TORCH_AUDIT=1``), then resumed armed after process 0's
  last piece lost a page and process 1's second piece lost its recorded
  fingerprint: the processes restore different prefixes and audit
  different misses, yet make the same collectives and adopt the same
  one-piece prefix.

Results are compared as sorted rows (the pipelined join lays out its
pieces differently in the two packages, ROADMAP.md "Deviations that
stay", PR 2), integers bit-equal.  At module level only torch, numpy and
the port are imported.
"""

import glob
import json
import os
import sys
import time
import zlib

import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
for _p in (_ROOT, _HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import cylon_tpu_torch as pct  # noqa: E402
import test_torch_multiprocess as mp  # noqa: E402

#: the watchdog the children run under: a dead peer surfaces within it
WATCHDOG_S = "8"
KILL_CHUNKS = 4


# ---------------------------------------------------------------------------
# the workloads, over either package's API on any env
# ---------------------------------------------------------------------------

def kill_workload(ct, env):
    """``tests/multihost_driver.py``'s kill-resume join: the main leg's
    tables joined through ``pipelined_join(n_chunks=4)``."""
    left, right = mp._inputs()
    lt = ct.Table.from_pydict(left, env)
    rt = ct.Table.from_pydict(right, env)
    return mp._rows(ct.pipelined_join(lt, rt, "k", "k", how="inner",
                                      n_chunks=KILL_CHUNKS))


def elastic_inputs():
    """``tests/multihost_driver.py:89-98``'s orders, lineitem and
    customers (seed 17)."""
    erng = np.random.default_rng(17)
    n_ord, n_li, n_cust = 600, 2400, 16
    orders = {"o_orderkey": np.arange(n_ord, dtype=np.int64),
              "o_custkey": erng.integers(0, n_cust, n_ord).astype(np.int64)}
    lineitem = {"l_orderkey": erng.integers(0, n_ord, n_li).astype(np.int64),
                "l_quantity": erng.integers(1, 51, n_li).astype(np.int64)}
    customers = {"c_custkey": np.arange(n_cust, dtype=np.int64),
                 "c_nationkey": erng.integers(0, 5, n_cust).astype(np.int64)}
    return orders, lineitem, customers


def elastic_workload(ct, env):
    """A sinkless pipelined join feeding a pipelined join into a
    ``GroupBySink`` (two checkpoint stages of 3 pieces each)."""
    orders, lineitem, customers = elastic_inputs()
    o = ct.Table.from_pydict(orders, env)
    li = ct.Table.from_pydict(lineitem, env)
    c = ct.Table.from_pydict(customers, env)
    jt = ct.pipelined_join(li, o, "l_orderkey", "o_orderkey", how="inner",
                           n_chunks=3)
    sink = ct.GroupBySink("o_custkey", [("l_quantity", "sum")])
    ct.pipelined_join(jt, c, "o_custkey", "c_custkey", how="inner",
                      n_chunks=3, sink=sink)
    return mp._rows(sink.finalize())


def elastic_oracle() -> np.ndarray:
    """Σ l_quantity per o_custkey over lineitem ⋈ orders (numpy), as
    ``test_torch_multiprocess._rows`` orders a result."""
    orders, lineitem, _ = elastic_inputs()
    cust = orders["o_custkey"][lineitem["l_orderkey"]]
    sums = np.bincount(cust, lineitem["l_quantity"], minlength=16)
    keys = np.unique(cust)
    m = np.stack([sums[keys].astype(np.int64), keys], axis=1)
    return m[np.lexsort(m.T[::-1])]


def grow_workload(ct, env):
    """One pipelined join into a ``GroupBySink`` (the stage a layout
    change adopts whole)."""
    left, right = mp._inputs()
    lt = ct.Table.from_pydict(left, env)
    rt = ct.Table.from_pydict(right, env)
    sink = ct.GroupBySink("k", [("a", "sum"), ("b", "sum")])
    ct.pipelined_join(lt, rt, "k", "k", n_chunks=3, sink=sink)
    return mp._rows(sink.finalize())


WORKLOADS = {"kill_resume": kill_workload, "elastic_resume":
             elastic_workload, "grow": grow_workload,
             "tamper": kill_workload, "drain": kill_workload,
             "audit": kill_workload}


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _epochs(root: str, pid: int) -> list:
    """This process's committed manifest epochs, by stage."""
    out = []
    for path in sorted(glob.glob(os.path.join(root, f"rank{pid}", "stage*",
                                              "MANIFEST.json"))):
        with open(path, encoding="utf-8") as f:
            out.append(int(json.load(f)["epoch"]))
    return out


def _tamper(pid: int) -> None:
    """Process 0 stages its first manifest one epoch ahead."""
    from cylon_tpu_torch.exec import checkpoint
    if pid != 0:
        return
    orig = checkpoint.Stage._commit

    def ahead(self):
        if not getattr(self, "_tampered", False):
            self._tampered = True
            self.epoch += 1
        return orig(self)

    checkpoint.Stage._commit = ahead


def _spoil(root: str) -> None:
    """Process 0's last piece gets a bad meta page (its sha fails on
    load); process 1's piece 1 records another fingerprint (its pages
    still verify)."""
    for pid, piece in ((0, str(KILL_CHUNKS - 1)), (1, "1")):
        man_path, = glob.glob(os.path.join(root, f"rank{pid}", "stage*",
                                           "MANIFEST.json"))
        with open(man_path, encoding="utf-8") as f:
            man = json.load(f)
        entry = man["pieces"][piece]
        if pid == 0:
            meta = os.path.join(os.path.dirname(man_path), entry["meta"])
            with open(meta, "r+b") as f:
                f.seek(-1, os.SEEK_END)
                last = f.read(1)
                f.seek(-1, os.SEEK_END)
                f.write(bytes([last[0] ^ 1]))
        else:
            entry["fp"] ^= 1
            with open(man_path, "w", encoding="utf-8") as f:
                json.dump(man, f)


def _driver(argv) -> None:
    pid, nproc, addr, v, path = (int(argv[0]), int(argv[1]), argv[2],
                                 int(argv[3]), argv[4])
    scenario = argv[5]
    from cylon_tpu_torch.exec import checkpoint
    from cylon_tpu_torch.parallel import transport
    env = pct.CylonEnv(pct.DistributedConfig(addr, pid, nproc,
                                             local_world=v, timeout_s=60),
                       device="cpu")
    ct = mp.port_api(env.world_size)
    if scenario == "tamper":
        _tamper(pid)
    out = {"pid": np.asarray([pid])}
    t0 = time.perf_counter()
    try:
        out["rows"] = WORKLOADS[scenario](ct, env)
    except Exception as e:  # noqa: BLE001 — the class is the result
        out["error"] = np.asarray([type(e).__name__])
        out["site"] = np.asarray([str(getattr(e, "site", ""))])
        out["s"] = np.asarray([time.perf_counter() - t0])
        out["epochs"] = np.asarray(_epochs(checkpoint.ckpt_dir(), pid),
                                   np.int64)
        mp._json(out, "stats", checkpoint.stats())
        np.savez(path, **out)
        # the process group closes after a peer died: no collective runs
        env.finalize()
        sys.stdout.flush()
        raise
    epochs = _epochs(checkpoint.ckpt_dir(), pid)
    # every process must have committed the same epochs and result
    sig = np.asarray(epochs + [zlib.crc32(out["rows"].tobytes())], np.int64)
    got = transport.allgather_array(sig, "test.epochs")
    out["agree"] = np.asarray([bool((got == got[0]).all())])
    out["epochs"] = np.asarray(epochs, np.int64)
    mp._json(out, "stats", checkpoint.stats())
    np.savez(path, **out)
    env.finalize()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

_CACHE: dict = {}


def _start(tmp, scenario, root, nproc=2, v=2, **switches):
    """Launch one ``scenario`` world of ``nproc`` processes under
    checkpoint root ``root`` (not waited on)."""
    import subprocess
    addr = f"127.0.0.1:{mp._free_port()}"
    env = dict(os.environ)
    for k in list(env):
        if k.startswith("CYLON_TPU_TORCH_"):
            env.pop(k)
    env.update({"CYLON_TPU_TORCH_CKPT_DIR": root,
                "CYLON_TPU_TORCH_WATCHDOG_S": WATCHDOG_S,
                "CYLON_TPU_TORCH_BROADCAST_JOIN_ROWS": "0"})
    env.update({f"CYLON_TPU_TORCH_{k.upper()}": str(x)
                for k, x in switches.items()})
    os.makedirs(tmp, exist_ok=True)
    tag = f"{scenario}{len(os.listdir(tmp))}"
    paths = [os.path.join(tmp, f"{tag}_{i}.npz") for i in range(nproc)]
    cmd = [sys.executable, os.path.abspath(__file__)]
    procs = [subprocess.Popen(
        cmd + [str(i), str(nproc), addr, str(v), paths[i], scenario],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=_ROOT) for i in range(nproc)]
    return procs, paths, time.monotonic() + mp.SPAWN_TIMEOUT_S


class _Switches:
    """Set the port's checkpoint switches in this process for a block."""

    def __init__(self, **values):
        self.values = {f"CYLON_TPU_TORCH_{k.upper()}": v
                       for k, v in values.items()}

    def __enter__(self):
        from cylon_tpu_torch.exec import checkpoint
        self.prev = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        checkpoint.reset_stages()
        checkpoint.reset_stats()
        return self

    def __exit__(self, *exc):
        for k, v in self.prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _one_process(workload, w: int, **switches):
    """``workload`` in this process at ``VirtualMeshConfig(w)`` under the
    given switches; (rows, checkpoint stats)."""
    from cylon_tpu_torch.exec import checkpoint
    env = pct.CylonEnv(pct.VirtualMeshConfig(w), device="cpu")
    with _Switches(**switches):
        rows = workload(mp.port_api(w), env)
        return rows, checkpoint.stats()


def _reference(workload, w: int):
    """``workload`` on the reference's ``CPUMeshConfig(w)``, unarmed."""
    import jax
    import cylon_tpu as rct
    from cylon_tpu import config as rconfig
    from cylon_tpu.ctx.context import CPUMeshConfig
    prev = (rconfig.BROADCAST_JOIN_ROWS, os.environ.pop(
        "CYLON_TPU_CKPT_DIR", None))
    rconfig.BROADCAST_JOIN_ROWS = 0
    try:
        env = rct.CylonEnv(config=CPUMeshConfig(world_size=w))
        return workload(mp.reference_api(), env)
    finally:
        rconfig.BROADCAST_JOIN_ROWS = prev[0]
        if prev[1] is not None:
            os.environ["CYLON_TPU_CKPT_DIR"] = prev[1]
        jax.clear_caches()


def _finish(handle):
    codes, outs, res = mp.finish(handle)
    for r in res:
        if r is not None and "stats" in r:
            r["stats"] = json.loads(bytes(r["stats"]))
    return codes, outs, res


def _run_all(tmp):
    """Every scenario's worlds: the first launches together, each chain's
    next launch as soon as its previous one ended; the one-process and
    reference expectations are computed while they run."""
    os.environ["CYLON_TPU_TORCH_BROADCAST_JOIN_ROWS"] = "0"
    from cylon_tpu_torch import config as pconfig
    pconfig.BROADCAST_JOIN_ROWS = 0
    d = lambda name: os.path.join(tmp, name)  # noqa: E731
    r = {"tmp": tmp}
    nxt: dict = {}
    first = {
        "kill_a": _start(d("w"), "kill_resume", d("kill"),
                         faults="ckpt.write:0:3=kill"),
        "elastic_a": _start(d("w"), "elastic_resume", d("elastic"),
                            faults="ckpt.write:0:4=kill"),
        "tamper": _start(d("w"), "tamper", d("tamper")),
        "drain_a": _start(d("w"), "drain", d("drain"),
                          faults="ckpt.write:0:2=term",
                          preempt_grace_s=30),
        "audit_a": _start(d("w"), "audit", d("audit"), audit=1),
    }
    try:
        # one process writes the complete W = 4 stage the grow adopts
        r["grow_one"] = _one_process(grow_workload, 4,
                                     ckpt_dir=d("grow"), resume=None)
        first["grow_b"] = _start(d("w"), "grow", d("grow"), resume=1)
        r["kill_a"] = _finish(first.pop("kill_a"))
        nxt["kill_b"] = _start(d("w"), "kill_resume", d("kill"), resume=1)
        r["drain_a"] = _finish(first.pop("drain_a"))
        nxt["drain_b"] = _start(d("w"), "drain", d("drain"), resume=1,
                                preempt_grace_s=30)
        r["grow_b"] = _finish(first.pop("grow_b"))
        nxt["grow_c"] = _start(d("w"), "grow", d("grow"), resume=1)
        r["tamper"] = _finish(first.pop("tamper"))
        r["audit_a"] = _finish(first.pop("audit_a"))
        _spoil(d("audit"))
        nxt["audit_b"] = _start(d("w"), "audit", d("audit"), resume=1,
                                audit=1)
        r["elastic_a"] = _finish(first.pop("elastic_a"))
        # the expectations, while the second launches run
        r["virtual_kill"] = _one_process(kill_workload, 4)[0]
        r["virtual_elastic"] = _one_process(elastic_workload, 4)[0]
        r["virtual_grow"] = _one_process(grow_workload, 4)[0]
        # the 2 x 2 stage resumed in one process at W = 2
        r["elastic_one"] = _one_process(elastic_workload, 2,
                                        ckpt_dir=d("elastic"), resume=1)
        for k in ("kill_b", "drain_b", "grow_c", "audit_b"):
            r[k] = _finish(nxt.pop(k))
        # rank dirs that disagree on procs: the stage starts over
        for path in glob.glob(os.path.join(d("grow"), "rank1", "stage*",
                                           "MANIFEST.json")):
            with open(path, encoding="utf-8") as f:
                man = json.load(f)
            man["procs"] = 3
            with open(path, "w", encoding="utf-8") as f:
                json.dump(man, f)
        r["grow_torn"] = _finish(_start(d("w"), "grow", d("grow"),
                                        resume=1))
        r["reference_kill"] = _reference(kill_workload, 4)
        r["reference_elastic"] = _reference(elastic_workload, 4)
        r["reference_grow"] = _reference(grow_workload, 4)
    finally:
        for handle in list(first.values()) + list(nxt.values()):
            for p in handle[0]:
                p.kill()
    return r


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    if "r" not in _CACHE:
        _CACHE["r"] = _run_all(str(tmp_path_factory.mktemp("mpckpt")))
    return _CACHE["r"]


def _ok(run):
    codes, outs, res = run
    mp._assert_ok(codes, outs)
    return res


def test_kill_resume(worlds):
    """Process 0 dies at its third write (rc -9); process 1 raises
    ``RankDesyncError`` at a vote within the watchdog and exits nonzero
    without a result.  The 2 × 2 resume fast-forwards on both processes,
    with one manifest epoch and the uninterrupted answer."""
    codes, outs, res = worlds["kill_a"]
    assert codes[0] == -9, outs[0][-2000:]
    assert codes[1] != 0 and res[1] is not None, outs[1][-2000:]
    assert str(res[1]["error"][0]) == "RankDesyncError"
    assert float(res[1]["s"][0]) < 2 * float(WATCHDOG_S)
    assert "rows" not in res[1]
    assert res[1]["stats"]["checkpoint_events"] == 2
    res = _ok(worlds["kill_b"])
    for r in res:
        assert bool(r["agree"][0])
        assert r["stats"]["resume_fast_forwarded_pieces"] == 2
        assert r["epochs"].tolist() == res[0]["epochs"].tolist()
        np.testing.assert_array_equal(r["rows"], worlds["virtual_kill"])
        np.testing.assert_array_equal(r["rows"], worlds["reference_kill"])


def test_elastic_resume_two_processes_to_one(worlds):
    """Stage 1 complete across two rank directories, stage 2 killed at
    its first write; one process at W = 2 re-shards stage 1, recomputes
    stage 2 and gives the oracle's answer."""
    codes, outs, res = worlds["elastic_a"]
    assert codes[0] == -9 and codes[1] != 0, outs
    assert str(res[1]["error"][0]) == "RankDesyncError"
    rows, st = worlds["elastic_one"]
    assert st["resume_fast_forwarded_pieces"] > 0, st
    assert st["resume_resharded_pieces"] > 0, st
    assert st["resume_world_mismatch"] > 0, st
    np.testing.assert_array_equal(rows, elastic_oracle())
    np.testing.assert_array_equal(rows, worlds["virtual_elastic"])
    np.testing.assert_array_equal(rows, worlds["reference_elastic"])


def test_grow_one_process_to_two(worlds):
    """A stage committed by one process at W = 4 is a new process layout
    for 2 × 2: both processes re-shard it whole and commit their own
    rank directories; the next 2 × 2 resume is a plain fast-forward."""
    _, st = worlds["grow_one"]
    assert st["checkpoint_events"] == 3 and st["resume_world_mismatch"] == 0
    for r in _ok(worlds["grow_b"]):
        assert bool(r["agree"][0])
        assert r["stats"]["resume_world_mismatch"] == 1
        assert r["stats"]["resume_resharded_pieces"] == 3
        np.testing.assert_array_equal(r["rows"], worlds["virtual_grow"])
        np.testing.assert_array_equal(r["rows"],
                                      worlds["reference_grow"])
    for r in _ok(worlds["grow_c"]):
        assert bool(r["agree"][0])
        assert r["stats"]["resume_world_mismatch"] == 0
        assert r["stats"]["resume_fast_forwarded_pieces"] == 3
        assert r["stats"]["checkpoint_events"] == 0
        np.testing.assert_array_equal(r["rows"], worlds["virtual_grow"])


def test_manifests_disagreeing_on_procs_start_over(worlds):
    """Rank directories whose manifests disagree on ``procs`` are a torn
    checkpoint: both processes start the stage over and recompute."""
    for r in _ok(worlds["grow_torn"]):
        assert bool(r["agree"][0])
        assert r["stats"]["resume_fast_forwarded_pieces"] == 0
        assert r["stats"]["resume_world_mismatch"] == 0
        assert r["stats"]["checkpoint_events"] == 3
        np.testing.assert_array_equal(r["rows"], worlds["virtual_grow"])


def test_tampered_epoch_raises_on_both(worlds):
    """Process 0 stages epoch 2 where process 1 stages epoch 1: the
    two-round vote raises on both processes, and neither publishes."""
    codes, outs, res = worlds["tamper"]
    for c, o, r in zip(codes, outs, res):
        assert c != 0 and r is not None, o[-2000:]
        assert str(r["error"][0]) == "RankDesyncError"
        assert str(r["site"][0]) == "ckpt.commit"
        assert r["epochs"].tolist() == []


def test_term_drains_both_processes(worlds):
    """A SIGTERM to process 0 at its second write: the drain vote stops
    both processes at the same boundary with two pieces committed and a
    resume token each; the resume fast-forwards them."""
    codes, outs, res = worlds["drain_a"]
    for c, o, r in zip(codes, outs, res):
        assert c != 0 and r is not None, o[-2000:]
        assert str(r["error"][0]) == "ResumableAbort"
        assert r["stats"]["checkpoint_events"] == 2
        assert r["epochs"].tolist() == res[0]["epochs"].tolist()
    with open(os.path.join(worlds["tmp"], "drain", "RESUME_TOKEN.json"),
              encoding="utf-8") as f:
        assert json.load(f)["stages"]
    for r in _ok(worlds["drain_b"]):
        assert bool(r["agree"][0])
        assert r["stats"]["resume_fast_forwarded_pieces"] == 2
        np.testing.assert_array_equal(r["rows"], worlds["virtual_kill"])


def test_armed_resume_audits_in_step(worlds):
    """An armed resume where process 0 loses a page of its last piece and
    process 1 a recorded fingerprint of its second: the restore vote and
    the audit's own vote agree on one piece on both processes, which
    recompute the rest to the uninterrupted answer."""
    for r in _ok(worlds["audit_a"]):
        assert r["stats"]["checkpoint_events"] == KILL_CHUNKS
    for r in _ok(worlds["audit_b"]):
        assert bool(r["agree"][0])
        assert r["stats"]["resume_fast_forwarded_pieces"] == 1
        np.testing.assert_array_equal(r["rows"], worlds["virtual_kill"])


def teardown_module():
    if "jax" in sys.modules:
        sys.modules["jax"].clear_caches()


if __name__ == "__main__":
    _driver(sys.argv[1:])

