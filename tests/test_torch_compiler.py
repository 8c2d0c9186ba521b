"""The compile tier of the port (``cylon_tpu_torch.exec.compiler``), after
tests/test_compiler.py, and a join call site repeated against the
reference's capacity prediction (``relational/join._CAP_CACHE``), on the
CPU.

The port compiles no XLA program: its compiles are the ``nvcc`` builds of
its kernels and the ``g++`` build of the host string hash.  There is no
compiler here, so the facade runs test builds (a Python process that
writes the library file, or one that hangs or dies by a signal) through
``compiler.build_all`` and loads them through a test opener:

* shape families: ``family_cap`` equal to the reference's, and the join,
  the fused join → groupby and the set ops bit- and order-equal with
  ``SHAPE_FAMILIES`` on and off (and equal to the reference);
* the ledger: hits on a live handle and on a library already on disk
  (no build), nothing evicted, and its live gauge;
* an orphaned intent quarantined, raising ``CompileQuarantinedError`` (a
  ``CapacityOverflowError``), a live sibling's left alone; the happy path
  clearing its intent and writing the manifest;
* a stall typed as ``CompileTimeoutError`` (with a budget and without);
* a poisoned manifest entry and a flipped library byte dropped and
  rebuilt, never loaded; unarmed, nothing written beside the library;
* ``kernels.build`` through the facade (a stand-in compiler), a compiler
  killed by a signal being a compiler crash, and the final rung turning
  a crash into ``ResumableAbort`` with checkpoints armed;
* ``stats()`` with the reference's keys, ``QueryScheduler.stats()
  ["compile"]``;
* a repeated join call site: the reference's rows on every call, each
  output at its exact bucket (the port has no capacity prediction)."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu import config as rconfig
from cylon_tpu.exec import compiler as rcompiler
from cylon_tpu.relational import join as rjoin
from cylon_tpu.relational import join_tables as r_join
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch import kernels
from cylon_tpu_torch.exec import compiler, recovery
from cylon_tpu_torch.status import (CapacityOverflowError,
                                    CompileQuarantinedError,
                                    CompileTimeoutError, KernelError,
                                    ResumableAbort)
from test_torch_groupby_sort import assert_same

B = 256
HOWS = ["inner", "left", "right", "outer"]


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean_facade(monkeypatch):
    """Every test starts and ends with the injector disarmed, the counters
    zeroed, no persistent directory state and a fresh ledger."""
    monkeypatch.setattr(compiler, "_LEDGER", {})
    recovery.install_faults("")
    compiler.reset_stats()
    yield
    recovery.install_faults("")
    compiler.reset_stats()
    with compiler._lock:
        compiler._DIR_STATE.update(path=None, quarantine=set(),
                                   manifest={}, adopted=[])
    monkeypatch.undo()
    compiler.rearm()


def _arm_dir(monkeypatch, d) -> None:
    monkeypatch.setattr(pconfig, "COMPILE_CACHE_DIR", str(d))
    compiler.rearm()


def _relaunch() -> None:
    """What a fresh process sees: no persistent state scanned, nothing
    loaded, the counters at zero."""
    with compiler._lock:
        compiler._DIR_STATE.update(path=None, quarantine=set(),
                                   manifest={}, adopted=[])
        compiler._LEDGER.clear()
    recovery.install_faults("")
    compiler.reset_stats()
    compiler.rearm()


#: a stand-in compiler: writes ``payload`` to the path given after -o
_WRITE = ("import sys\na = sys.argv\n"
          "open(a[a.index('-o') + 1], 'wb').write(a[-1].encode())")


def _job(target: str, label="k1", sig="00ff", payload="lib-bytes"):
    tmp = f"{target}.tmp"
    return compiler.Job(label, sig, [sys.executable, "-c", _WRITE, "-o",
                                     tmp, payload], tmp, target)


def _target(monkeypatch, tmp_path, name="libk1-00ff.so") -> str:
    return os.path.join(compiler.build_dir(str(tmp_path / "_build")), name)


def _dead_pid() -> int:
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


# ---------------------------------------------------------------------------
# shape families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("families", [True, False])
def test_family_cap_matches_reference(monkeypatch, families):
    monkeypatch.setattr(rconfig, "SHAPE_FAMILIES", families)
    monkeypatch.setattr(pconfig, "SHAPE_FAMILIES", families)
    for n in (0, 1, 7, B - 1, B, B + 1, 3 * B // 2, 4097, 70000):
        assert compiler.family_cap(n) == rcompiler.family_cap(n)
    assert compiler.family_cap(B) == B


def _join_dfs(rng, n):
    ldf = pd.DataFrame({"k": rng.integers(0, 40, n).astype(np.int32),
                        "a": rng.random(n)})
    rdf = pd.DataFrame({"k": rng.integers(0, 40, 53).astype(np.int32),
                        "b": rng.random(53)})
    return ldf, rdf


def _fam_vs_exact(monkeypatch, run):
    fam = run()
    monkeypatch.setattr(pconfig, "SHAPE_FAMILIES", False)
    exact = run()
    monkeypatch.setattr(pconfig, "SHAPE_FAMILIES", True)
    pd.testing.assert_frame_equal(fam.reset_index(drop=True),
                                  exact.reset_index(drop=True))
    return fam


@pytest.mark.parametrize("n", [B - 1, B, B + 1])
@pytest.mark.parametrize("how", HOWS)
def test_canonicalized_join_bit_equal(monkeypatch, rng, n, how):
    ldf, rdf = _join_dfs(rng, n)
    env = pct.CylonEnv(device="cpu")

    def run():
        lt, rt = (pct.Table.from_pandas(d, env) for d in (ldf, rdf))
        return pct.join_tables(lt, rt, "k", "k", how=how).to_pandas()

    _fam_vs_exact(monkeypatch, run)


def test_canonicalized_join_equals_reference(monkeypatch, rng, env1):
    ldf, rdf = _join_dfs(rng, B + 1)
    env = pct.CylonEnv(device="cpu")
    got = _fam_vs_exact(monkeypatch, lambda: pct.join_tables(
        *(pct.Table.from_pandas(d, env) for d in (ldf, rdf)), "k", "k",
        how="left").to_pandas())
    want = r_join(*(rct.Table.from_pandas(d, env1) for d in (ldf, rdf)),
                  "k", "k", how="left").to_pandas()
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


@pytest.mark.parametrize("n", [B - 1, B + 1])
def test_canonicalized_fused_groupby(monkeypatch, rng, n):
    ldf = pd.DataFrame({"k": rng.integers(0, 20, n).astype(np.int32),
                        "v": rng.random(n)})
    rdf = pd.DataFrame({"k": np.arange(20, dtype=np.int32),
                        "b": rng.random(20)})
    env = pct.CylonEnv(device="cpu")

    def run():
        j = pct.DataFrame(ldf, env=env).merge(pct.DataFrame(rdf, env=env),
                                              on="k", how="inner")
        return j.groupby("k").agg({"v": "sum", "b": "max"}).to_pandas()

    _fam_vs_exact(monkeypatch, run)


@pytest.mark.parametrize("op", ["union", "intersect", "subtract"])
def test_canonicalized_set_ops(monkeypatch, rng, op):
    adf = pd.DataFrame({"k": rng.integers(0, 30, B + 1).astype(np.int32),
                        "g": rng.integers(0, 4, B + 1).astype(np.int32)})
    bdf = pd.DataFrame({"k": rng.integers(0, 30, 57).astype(np.int32),
                        "g": rng.integers(0, 4, 57).astype(np.int32)})
    env = pct.CylonEnv(device="cpu")
    _fam_vs_exact(monkeypatch, lambda: pct.set_operation(
        *(pct.Table.from_pandas(d, env) for d in (adf, bdf)),
        op).to_pandas())


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

def _opener(path):
    return object()


def test_ledger_counts_hits_and_keeps_every_library():
    for name in ("a", "b", "c"):
        compiler.admit(name, "/x", _opener, built=True)
    assert compiler.live("b") is compiler._LEDGER["b"]
    compiler.admit("d", "/x", _opener, built=False)
    assert sorted(compiler._LEDGER) == ["a", "b", "c", "d"]
    st = compiler.stats()
    assert (st["cache_hits"], st["cache_evictions"]) == (2, 0)
    assert compiler.live("e") is None


def test_live_gauge_tracks_ledger():
    from cylon_tpu_torch.obs import metrics
    base = compiler.live_programs()
    compiler.admit("g", "/x", _opener, built=True)
    assert compiler.live_programs() == base + 1
    assert metrics.gauge("compile_programs_live").value == base + 1
    compiler._LEDGER.pop("g")
    assert compiler.live_programs() == base


def test_built_library_loads_as_hit_without_build(monkeypatch, tmp_path):
    """A library already in the build directory loads as a hit, and the
    next use takes the live handle (a hit again): no build."""
    paths = {}
    for name in ("windowed_gather", "splitter_probe"):
        p = tmp_path / f"lib{name}.so"
        p.write_bytes(b"x")
        paths[name] = str(p)
    monkeypatch.setattr(kernels, "library_path", lambda n: paths[n])
    monkeypatch.setattr(kernels, "_open", lambda n, p: (n, p))
    monkeypatch.setattr(kernels, "_nvcc", lambda: pytest.fail("a build"))
    assert kernels.load("windowed_gather") == ("windowed_gather",
                                               paths["windowed_gather"])
    kernels.load("splitter_probe")
    assert kernels.load("windowed_gather") is \
        compiler._LEDGER["windowed_gather"]
    st = compiler.stats()
    assert (st["cache_misses"], st["compile_events"]) == (0, 0)
    assert st["cache_hits"] == 3 and st["cache_evictions"] == 0


# ---------------------------------------------------------------------------
# the intent journal, the quarantine and the manifest
# ---------------------------------------------------------------------------

def test_orphan_intent_quarantines_typed(monkeypatch, tmp_path):
    _arm_dir(monkeypatch, tmp_path)
    (tmp_path / "intent.999.json").write_text(json.dumps(
        {"pid": _dead_pid(), "entries": [{"kernel": "k1", "sig": "00ff"}]}))
    (tmp_path / "intent.live.json").write_text(json.dumps(
        {"pid": os.getppid(), "entries": [{"kernel": "k2",
                                           "sig": "11ee"}]}))
    target = _target(monkeypatch, tmp_path)
    with pytest.raises(CompileQuarantinedError) as ei:
        compiler.build_all([_job(target)])
    assert isinstance(ei.value, CapacityOverflowError)
    assert ei.value.signature == "00ff" and ei.value.site == "compile.build"
    assert compiler.quarantined_signatures() == ("00ff",)
    assert compiler.stats()["quarantine_adoptions"] == 1
    assert not (tmp_path / "intent.999.json").exists()
    assert (tmp_path / "intent.live.json").exists()   # a live sibling's
    q = json.loads((tmp_path / "quarantine.json").read_text())
    assert q["signatures"] == ["00ff"]
    # another digest (another source or flags) builds
    other = _target(monkeypatch, tmp_path, "libk1-22dd.so")
    compiler.build_all([_job(other, sig="22dd")])
    assert os.path.exists(other)


def test_quarantined_error_is_a_capacity_fault():
    e = CompileQuarantinedError("x", site="compile.build", signature="ab")
    assert isinstance(e, CapacityOverflowError) and e.signature == "ab"
    assert e.kind == "quarantined" and e.code == rct.Code.CapacityError


def test_happy_path_clears_intent_and_writes_manifest(monkeypatch,
                                                      tmp_path):
    _arm_dir(monkeypatch, tmp_path)
    seen = []
    real = compiler._start

    def start(job):
        seen.append(sorted(os.listdir(tmp_path)))
        real(job)

    monkeypatch.setattr(compiler, "_start", start)
    target = _target(monkeypatch, tmp_path)
    compiler.build_all([_job(target)])
    assert f"intent.{os.getpid()}.json" in seen[0]
    assert not [f for f in os.listdir(tmp_path) if f.startswith("intent")]
    man = json.loads((tmp_path / "manifest.json").read_text())
    import hashlib
    sha = hashlib.sha256(open(target, "rb").read()).hexdigest()
    assert man == {"libk1-00ff.so": {"kernel": "k1", "sha256": sha}}
    st = compiler.stats()
    assert (st["cache_misses"], st["compile_events"]) == (1, 1)
    assert st["compile_seconds"] > 0
    _relaunch()
    _arm_dir(monkeypatch, tmp_path)
    assert compiler.expected_warm() == 1 and compiler.usable(target)


@pytest.mark.parametrize("how", ["poisoned_entry", "flipped_byte"])
def test_bad_library_dropped_and_rebuilt(monkeypatch, tmp_path, how):
    _arm_dir(monkeypatch, tmp_path)
    target = _target(monkeypatch, tmp_path)
    if how == "poisoned_entry":
        recovery.install_faults("compile.build=corrupt")
        compiler.rearm()
    compiler.build_all([_job(target)])
    good = open(target, "rb").read()
    man = json.loads((tmp_path / "manifest.json").read_text())
    if how == "poisoned_entry":
        assert man["libk1-00ff.so"]["sha256"] == "0" * 64
    else:
        with open(target, "r+b") as f:
            f.write(bytes([good[0] ^ 1]))
    _relaunch()
    _arm_dir(monkeypatch, tmp_path)
    assert not compiler.usable(target)           # never loaded
    assert compiler.stats()["manifest_drops"] == 1
    assert not os.path.exists(target)
    compiler.build_all([_job(target)])
    assert open(target, "rb").read() == good
    assert compiler.usable(target)
    assert compiler.stats()["cache_misses"] == 1


def test_unarmed_writes_nothing(monkeypatch, tmp_path):
    compiler.rearm()
    assert compiler.cache_dir() == "" and not compiler.armed()

    def boom(*a, **k):
        raise AssertionError("the persistent layer ran unarmed")

    for name in ("_ensure_dir", "_write_intent", "_manifest_add",
                 "_atomic_json"):
        monkeypatch.setattr(compiler, name, boom)
    target = str(tmp_path / "_build" / "libk1-00ff.so")
    assert compiler.build_dir(str(tmp_path / "_build")) == \
        str(tmp_path / "_build")
    compiler.build_all([_job(target)])
    assert os.listdir(tmp_path / "_build") == ["libk1-00ff.so"]
    assert compiler.usable(target)


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------

def test_stall_surfaces_typed(monkeypatch, tmp_path):
    monkeypatch.setattr(pconfig, "COMPILE_TIMEOUT_S", 0.3)
    recovery.install_faults("compile.build=stall")
    compiler.rearm()
    target = str(tmp_path / "libk1-00ff.so")
    with pytest.raises(CompileTimeoutError) as ei:
        compiler.build_all([_job(target)])
    assert ei.value.site == "compile.build" and ei.value.signature == "00ff"
    assert compiler.stats()["watchdog_timeouts"] == 1
    assert not os.path.exists(target)
    # the one-shot spec is spent: the same build finishes
    monkeypatch.setattr(pconfig, "COMPILE_TIMEOUT_S", 60.0)
    compiler.rearm()
    compiler.build_all([_job(target)])
    assert os.path.exists(target)


def test_stall_without_budget_still_types(tmp_path):
    recovery.install_faults("compile.build=stall")
    compiler.rearm()
    with pytest.raises(CompileTimeoutError):
        compiler.build_all([_job(str(tmp_path / "libk1-00ff.so"))])


# ---------------------------------------------------------------------------
# the kernels through the facade, and the final rung
# ---------------------------------------------------------------------------

def _fake_nvcc(tmp_path, body: str) -> str:
    path = tmp_path / "nvcc"
    path.write_text(f"#!{sys.executable}\nimport os, signal, sys\n{body}\n")
    path.chmod(0o755)
    return str(path)


def test_kernels_build_through_the_facade(monkeypatch, tmp_path):
    _arm_dir(monkeypatch, tmp_path / "cache")
    nvcc = _fake_nvcc(tmp_path, "a = sys.argv\n"
                      "open(a[a.index('-o') + 1], 'wb').write(b'so')")
    monkeypatch.setattr(kernels, "_nvcc", lambda: nvcc)
    paths = kernels.build()
    assert sorted(paths) == sorted(kernels.SOURCES)
    for name, p in paths.items():
        assert p == os.path.join(str(tmp_path / "cache"), "kernels",
                                 f"lib{name}-{kernels.digest(name)}.so")
        assert os.path.exists(p)
    st = compiler.stats()
    assert (st["cache_misses"], st["compile_events"]) == (2, 2)
    man = json.loads((tmp_path / "cache" / "manifest.json").read_text())
    assert sorted(e["kernel"] for e in man.values()) == \
        sorted(kernels.SOURCES)
    kernels.build()                                # nothing to build
    assert compiler.stats()["cache_misses"] == 2


def test_compiler_crash_reaches_the_final_rung(monkeypatch, tmp_path):
    nvcc = _fake_nvcc(tmp_path, "os.kill(os.getpid(), signal.SIGSEGV)")
    monkeypatch.setattr(kernels, "_nvcc", lambda: nvcc)
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(KernelError, match="SIGSEGV") as ei:
        kernels.build(("windowed_gather",))
    crash = ei.value
    assert crash.signal == "SIGSEGV"
    assert recovery.is_compiler_crash(crash)
    assert recovery.is_compiler_crash(CompileQuarantinedError("x"))
    # by type, not by text: a failed build without a signal, or another
    # error that merely says so, is no compiler crash
    assert not recovery.is_compiler_crash(KernelError("nvcc exit 1"))
    assert not recovery.is_compiler_crash(
        RuntimeError("compiler killed by signal SIGSEGV"))

    def primary():
        raise crash

    # unarmed: the crash propagates typed
    monkeypatch.delenv("CYLON_TPU_TORCH_CKPT_DIR", raising=False)
    with pytest.raises(KernelError):
        recovery.run_with_recovery(primary, True, lambda nc: None, "t")
    # armed: the session is flushed and the crash becomes resumable
    monkeypatch.setenv("CYLON_TPU_TORCH_CKPT_DIR", str(tmp_path / "ck"))
    with pytest.raises(ResumableAbort) as ei:
        recovery.run_with_recovery(primary, True, lambda nc: None, "t")
    assert ei.value.__cause__ is crash and ei.value.token

    # a quarantined build takes the capacity rung, meets the same
    # quarantine (its digest does not change with the shape), and ends
    # resumable too
    def quarantined(*a):
        raise CompileQuarantinedError("build is quarantined",
                                      site="compile.build", signature="s")

    recovery.reset_events()
    with pytest.raises(ResumableAbort):
        recovery.run_with_recovery(quarantined, True, quarantined, "t")
    acts = [e["action"] for e in recovery.recovery_events()
            if e["kind"] == "quarantined"]
    assert acts == ["retry_chunks_8", "abort", "resumable_abort"]


# ---------------------------------------------------------------------------
# the stats blocks
# ---------------------------------------------------------------------------

def test_stats_keys_match_reference():
    assert set(compiler.stats()) == set(rcompiler.stats())
    compiler.admit("x", "/x", _opener, built=True)
    assert compiler.stats()["programs_live"] == 1
    assert compiler.stats()["mesh_table_evictions"] == 0


def test_scheduler_stats_carry_compile_block():
    from cylon_tpu.exec.scheduler import QueryScheduler as RSched
    from cylon_tpu_torch.exec import QueryScheduler
    sched = QueryScheduler(pct.CylonEnv(device="cpu"))
    rs = RSched(rct.CylonEnv(config=rct.LocalConfig()))
    assert set(sched.stats()["compile"]) == set(rs.stats()["compile"])


# ---------------------------------------------------------------------------
# the join's capacity prediction
# ---------------------------------------------------------------------------

def _pred_frames(n, hot):
    """Same sizes and names whatever ``hot``: the call site's key; ``hot``
    keys of zero on both sides multiply the output."""
    lk = np.arange(n, dtype=np.int64)
    rk = np.arange(n, dtype=np.int64)
    lk[:hot] = 0
    rk[:hot] = 0
    return (pd.DataFrame({"k": lk, "a": lk * 3}),
            pd.DataFrame({"k": rk, "b": rk * 5}))


@pytest.mark.parametrize("w", [1, 4])
def test_repeated_join_site_equals_reference(w, env1, env4, monkeypatch):
    """The same call site joined four times, its output growing and then
    shrinking: every result holds the reference's rows, and each output
    is sized by its own counts (the exact bucket).  The reference queues
    phase 2 at the site's last bucket and keeps that capacity when it was
    larger; the port has no capacity prediction (ROADMAP.md "No
    counterpart, by decision")."""
    monkeypatch.setattr(rconfig, "BROADCAST_JOIN_ROWS", 0)
    monkeypatch.setattr(pconfig, "BROADCAST_JOIN_ROWS", 0)
    rjoin._CAP_CACHE.clear()
    renv = {1: env1, 4: env4}[w]
    penv = pct.CylonEnv(pct.VirtualMeshConfig(w), device="cpu")
    for hot in (0, 0, 40, 0):
        ldf, rdf = _pred_frames(300, hot)
        got = pct.join_tables(*(pct.Table.from_pandas(d, penv)
                                for d in (ldf, rdf)), "k", "k", how="left")
        want = r_join(*(rct.Table.from_pandas(d, renv) for d in (ldf, rdf)),
                      "k", "k", how="left")
        np.testing.assert_array_equal(got.valid_counts, want.valid_counts)
        assert got.capacity == pconfig.pow2ceil(int(max(got.valid_counts)))
        cols = ["k", "a", "b"]
        pd.testing.assert_frame_equal(
            got.to_pandas().sort_values(cols).reset_index(drop=True),
            want.to_pandas().sort_values(cols).reset_index(drop=True),
            check_dtype=False)


def test_repeated_pipelined_join_is_stable(env1):
    ldf, rdf = _pred_frames(2000, 0)
    penv = pct.CylonEnv(device="cpu")
    lt, rt = (pct.Table.from_pandas(d, penv) for d in (ldf, rdf))
    first = pct.pipelined_join(lt, rt, "k", "k", how="left", n_chunks=4)
    again = pct.pipelined_join(lt, rt, "k", "k", how="left", n_chunks=4)
    assert again.capacity == first.capacity
    pd.testing.assert_frame_equal(first.to_pandas(), again.to_pandas())
