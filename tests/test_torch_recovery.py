"""The fault taxonomy, the injector, the retry ladder, consensus and the
watchdog of cylon_tpu_torch (``exec/recovery.py``, ``status.py``) against
cylon_tpu's, mirroring the classes of tests/test_recovery.py.

The same thunks, tables (numpy draws from one seed) and fault specs go
through both packages; held equal are the recovery events (site, kind,
action), the typed errors and the results, integers bit-equal.  The
operator cases run at W = 4 (the reference's ``env4`` CPU mesh, the
port's ``VirtualMeshConfig(4)`` on the CPU).  The port's own cases: the
classification of ``torch.cuda.OutOfMemoryError``, of CUDA's
out-of-memory text and of a sticky CUDA error (never an OOM).  Not
mirrored: ``test_consensus_program_is_one_pmax`` (the multi-process wire
waits for the multi-card transport)."""

import errno
import gc

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as rct
from cylon_tpu import config as rconfig
from cylon_tpu import status as rstatus
from cylon_tpu.exec import GroupBySink as RSink
from cylon_tpu.exec import pipelined_join as r_pipe
from cylon_tpu.exec import recovery as rrec
from cylon_tpu.relational import groupby_aggregate as r_groupby
from cylon_tpu.relational import join_tables as r_join
from cylon_tpu.relational.repart import shuffle_table as r_shuffle
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch import status as pstatus
from cylon_tpu_torch.exec import memory as pmem
from cylon_tpu_torch.exec import recovery as prec
from cylon_tpu_torch.relational.repart import shuffle_table as p_shuffle
from cylon_tpu_torch.parallel import shuffle as p_shuffle_mod

W = 4
PKGS = {"ref": (rrec, rstatus), "port": (prec, pstatus)}


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Release the reference's compiled XLA:CPU programs at module end."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean():
    for rec in (rrec, prec):
        rec.install_faults("")
        rec.reset_events()
    gc.collect()
    yield
    for rec in (rrec, prec):
        rec.install_faults("")
        rec.reset_events()


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    """(recovery module, status module) of one package."""
    return PKGS[request.param]


@pytest.fixture()
def penv4():
    return pct.CylonEnv(pct.VirtualMeshConfig(W), device="cpu")


def _events(rec):
    return [(e["site"], e["kind"], e["action"])
            for e in rec.recovery_events()]


def _frames(rng, n=4000):
    """tests/test_recovery.py's tables."""
    ldf = pd.DataFrame({"k": rng.integers(0, 500, n).astype(np.int64),
                        "a": rng.integers(0, 50, n).astype(np.int64)})
    rdf = pd.DataFrame({"k": rng.integers(0, 500, n).astype(np.int64),
                        "b": rng.integers(0, 50, n).astype(np.int64)})
    return ldf, rdf


def _rows(table, cols):
    """A table's live rows as host arrays sorted by ``cols``."""
    h = table.host_columns()
    arrs = [np.asarray(h[c][0]) for c in cols]
    order = np.lexsort(arrs[::-1])
    return [a[order] for a in arrs]


def _same(ref, port, cols):
    for a, b in zip(_rows(ref, cols), _rows(port, cols)):
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# the taxonomy and classification
# ---------------------------------------------------------------------------

class TestTaxonomy:
    def test_codes_and_kinds(self):
        for name in ("PredictedResourceExhausted", "DeviceOOMError",
                     "CapacityOverflowError", "RankDesyncError",
                     "DataIntegrityError", "CheckpointCorruptError"):
            r, p = getattr(rstatus, name), getattr(pstatus, name)
            assert int(p().code) == int(r().code), name
            assert p.kind == r.kind, name
        for code in ("OutOfMemory", "CapacityError", "SerializationError",
                     "SpillRequired", "IntegrityFault"):
            assert int(getattr(pstatus.Code, code)) \
                == int(getattr(rstatus.Code, code)), code
        assert [c.__name__ for c in pstatus.FAULT_TYPES] \
            == [c.__name__ for c in rstatus.FAULT_TYPES]
        assert isinstance(pstatus.PredictedResourceExhausted(), MemoryError)

    def test_classify_passthrough(self, pkg):
        rec, st = pkg
        for f in (st.PredictedResourceExhausted("x"), st.DeviceOOMError("x"),
                  st.CapacityOverflowError("x"), st.RankDesyncError("x")):
            assert rec.classify(f) is f

    def test_classify_foreign(self, pkg):
        rec, st = pkg
        e = RuntimeError("RESOURCE_EXHAUSTED: out of memory allocating")
        f = rec.classify(e)
        assert isinstance(f, st.DeviceOOMError) and f.__cause__ is e
        f = rec.classify(MemoryError("RESOURCE_EXHAUSTED (predicted): x"))
        assert isinstance(f, st.PredictedResourceExhausted)
        assert rec.classify(ValueError("boom")) is None
        assert rec.classify(st.InvalidError("bad arg")) is None

    def test_classify_cuda_errors(self):
        """The port's runtime: torch's OOM type, CUDA's out-of-memory text
        (a CUB or cuBLAS workspace that failed) and a sticky error."""
        e = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                        "allocate 20.00 GiB")
        f = prec.classify(e)
        assert isinstance(f, pstatus.DeviceOOMError) and f.__cause__ is e
        for text in ("CUDA out of memory. Tried to allocate 2.00 MiB",
                     "CUDA error: out of memory\nCUDA kernel errors might "
                     "be asynchronously reported"):
            f = prec.classify(RuntimeError(text))
            assert isinstance(f, pstatus.DeviceOOMError), text
            assert prec.is_oom(RuntimeError(text))
        for text in ("CUDA error: an illegal memory access was encountered",
                     "CUDA error: unspecified launch failure",
                     "CUDA error: out of memory after an illegal memory "
                     "access was encountered"):
            assert prec.classify(RuntimeError(text)) is None, text
            assert not prec.is_oom(RuntimeError(text))

    def test_oom_fallback_entry_is_the_ladder(self):
        """``relational/common.run_with_oom_fallback`` in both packages: a
        foreign allocator failure climbs the same rungs to the same
        answer, with the same events."""
        from cylon_tpu.relational.common import run_with_oom_fallback as r_f
        from cylon_tpu_torch.relational.common import \
            run_with_oom_fallback as p_f
        got = []
        for rec, fallback_entry in ((rrec, r_f), (prec, p_f)):
            rec.install_faults("")
            tried = []

            def primary():
                raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory "
                                   "while trying to allocate 1.00GiB")

            def fallback(nc):
                tried.append(nc)
                if nc == 4:
                    primary()
                return nc * 10

            out = fallback_entry(primary, True, fallback, "entry")
            got.append((out, tried, _events(rec)))
        assert got[0] == got[1]
        assert got[1][0] == 160 and got[1][1] == [4, 16]


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------

class TestInjector:
    def test_grammar_rejects_unknown(self, pkg):
        rec, _ = pkg
        for spec in ("nope.site=predicted", "shuffle.recv_guard=nope",
                     "shuffle.recv_guard:0:1:9=predicted",
                     "shuffle.recv_guard=enospc_typo"):
            with pytest.raises(ValueError):
                rec.install_faults(spec)

    def test_every_site_and_kind_parses(self):
        assert prec.SITES == rrec.SITES and prec.KINDS == rrec.KINDS
        for site in prec.SITES:
            prec.install_faults(f"{site}:0:2=predicted@tenant")

    @pytest.mark.parametrize("spec,probes", [
        ("groupby.device_oom::2=device_oom", 3),
        ("groupby.device_oom::*=device_oom", 3),
        ("shuffle.recv_guard:1=predicted", 2),
        ("shuffle.recv_guard:0=predicted", 2),
        ("shuffle.recv_guard:1:2=predicted", 3),
        ("shuffle.recv_guard::*=predicted", 2),
        ("ckpt.write:0:2=kill", 1),
        ("", 2),
    ])
    def test_probe_sequences_match(self, spec, probes):
        """nth, every-occurrence and rank selectivity, and the ``armed``
        flag, probe by probe equal (the one process is rank 0)."""
        seqs = []
        for rec in (rrec, prec):
            rec.install_faults(spec)
            site = spec.split(":")[0].split("=")[0] or "shuffle.recv_guard"
            seqs.append([rec.probe(site) for _ in range(probes)])
        assert seqs[0] == seqs[1]

    def test_first_probe_keeps_earlier_events(self, monkeypatch):
        """The spec is read from ``CYLON_TPU_TORCH_FAULTS`` at the first
        probe without clearing what the ladder recorded before it (a
        retry's first probe must not erase the retry's own event)."""
        monkeypatch.setenv("CYLON_TPU_TORCH_FAULTS",
                           "groupby.device_oom=device_oom")
        monkeypatch.setattr(prec, "_FAULTS", None)
        prec._record("join", "device_oom", "retry_chunks_4")
        assert prec.injected("groupby.device_oom") == "device_oom"
        assert _events(prec) == [("join", "device_oom", "retry_chunks_4")]

    @pytest.mark.parametrize("spec", [
        "groupby.device_oom::2=device_oom@t1",
        "groupby.device_oom::*=device_oom@t1",
        "groupby.device_oom::2=device_oom@t1,groupby.device_oom::3=capacity",
    ])
    def test_session_selector(self, spec):
        """An ``@session`` spec never fires on a thread no session tags
        (the only kind of thread the port has until the scheduler comes)
        and stays armed; its untagged neighbours fire as usual — probe by
        probe equal to the reference."""
        seqs = []
        for rec in (rrec, prec):
            rec.install_faults(spec)
            seqs.append([rec.probe("groupby.device_oom") for _ in range(4)])
        assert seqs[0] == seqs[1]
        assert all(armed for _, armed in seqs[1])
        assert [k for k, _ in seqs[1]].count("device_oom") == 0

    def test_install_faults_fully_resets_state(self, pkg):
        rec, _ = pkg
        rec.install_faults("groupby.device_oom::2=device_oom")
        assert rec.injected("groupby.device_oom") is None
        assert rec.injected("groupby.device_oom") == "device_oom"
        rec.install_faults("groupby.device_oom::2=device_oom")
        assert rec.injected("groupby.device_oom") is None
        assert rec.injected("groupby.device_oom") == "device_oom"
        rec.install_faults("groupby.device_oom::1=device_oom")
        with pytest.raises(RuntimeError):
            rec.maybe_inject("groupby.device_oom")
        assert len(rec.recovery_events()) == 1
        rec.install_faults("groupby.device_oom::1=device_oom")
        assert rec.recovery_events() == []

    def test_all_kinds_constructible(self, pkg):
        rec, st = pkg
        for spec, site, exc in (
                ("join.piece_cap=capacity", "join.piece_cap",
                 st.CapacityOverflowError),
                ("shuffle.recv_guard=predicted", "shuffle.recv_guard",
                 st.PredictedResourceExhausted),
                ("exchange.stall=desync", "exchange.stall",
                 st.RankDesyncError),
                ("ckpt.load=corrupt", "ckpt.load",
                 st.CheckpointCorruptError)):
            rec.install_faults(spec)
            with pytest.raises(exc):
                rec.maybe_inject(site)
        rec.install_faults("groupby.device_oom=device_oom")
        with pytest.raises(RuntimeError) as ei:   # foreign on purpose
            rec.maybe_inject("groupby.device_oom")
        assert isinstance(rec.classify(ei.value), st.DeviceOOMError)
        rec.install_faults("ckpt.reshard=corrupt")
        assert rec.maybe_inject("ckpt.reshard",
                                intercept=("corrupt",)) == "corrupt"


# ---------------------------------------------------------------------------
# the bounded IO retry
# ---------------------------------------------------------------------------

class TestRetryIO:
    @pytest.mark.parametrize("fails,err,want_calls,ok", [
        (1, 5, 2, True),                 # a transient blip, then it lands
        (9, 5, 3, False),                # bounded: three calls, then raise
        (9, errno.ENOSPC, 1, False),     # a full disk does not heal
    ])
    def test_retry_sequences_match(self, monkeypatch, fails, err,
                                   want_calls, ok):
        monkeypatch.setattr("time.sleep", lambda s: None)
        for rec in (rrec, prec):
            calls, hits = [0], [0]

            def flaky():
                calls[0] += 1
                if calls[0] <= fails:
                    raise OSError(err, "blip")
                return "landed"

            if ok:
                assert rec.retry_io(flaky, "disk.write",
                                    on_retry=lambda: hits.__setitem__(
                                        0, hits[0] + 1)) == "landed"
            else:
                with pytest.raises(OSError):
                    rec.retry_io(flaky, "disk.write")
            assert calls[0] == want_calls
        assert prec.IO_RETRIES.value >= 1

    def test_non_oserror_propagates_untouched(self):
        with pytest.raises(ValueError):
            prec.retry_io(lambda: (_ for _ in ()).throw(ValueError("x")),
                          "disk.write")


class TestDiskCorruptClassification:
    def test_disk_site_corruption_is_a_fault(self, pkg):
        rec, st = pkg
        e = st.CheckpointCorruptError("spill page bad", site="disk.read")
        assert rec.classify(e) is e
        assert st.Code.SerializationError in rec.RETRY_RUNGS
        assert rec.classify(st.CheckpointCorruptError(
            "page bad", site="ckpt.load")) is None
        assert rec.classify(st.CheckpointCorruptError("page bad")) is None

    def test_rungs_match(self):
        assert {int(k): v for k, v in prec.RETRY_RUNGS.items()} \
            == {int(k): v for k, v in rrec.RETRY_RUNGS.items()}


# ---------------------------------------------------------------------------
# the ladder, unit level
# ---------------------------------------------------------------------------

def _oom():
    raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")


def _ladder_cases():
    """(name, primary, fallback factory) triples run through both
    ladders; the factory takes the package's status module and a list
    recording the chunk counts tried."""
    def fb_4_fails(st, seen):
        def fb(nc):
            seen.append(nc)
            if nc == 4:
                raise RuntimeError("RESOURCE_EXHAUSTED again")
            return "ok"
        return fb

    def fb_always_fails(st, seen):
        def fb(nc):
            seen.append(nc)
            raise RuntimeError("RESOURCE_EXHAUSTED still")
        return fb

    def fb_ok(st, seen):
        return lambda nc: seen.append(nc) or "ok"

    return {
        "ok": (lambda st: 42, fb_ok),
        "oom_4_then_16": (lambda st: _oom(), fb_4_fails),
        "capacity_halving": (lambda st: (_ for _ in ()).throw(
            st.CapacityOverflowError("cap", site="join.piece_cap")), fb_ok),
        "exhaustion": (lambda st: _oom(), fb_always_fails),
        "non_fault": (lambda st: (_ for _ in ()).throw(ValueError("no")),
                      fb_ok),
        "desync_never_retries": (lambda st: (_ for _ in ()).throw(
            st.RankDesyncError("hung", site="exchange.stall")), fb_ok),
        "predicted_no_spillable": (lambda st: (_ for _ in ()).throw(
            st.PredictedResourceExhausted("RESOURCE_EXHAUSTED (predicted)")),
            fb_ok),
        "disk_corrupt_recompute": (lambda st: (_ for _ in ()).throw(
            st.CheckpointCorruptError("bad", site="disk.read")), fb_ok),
    }


class TestLadder:
    @pytest.mark.parametrize("case", sorted(_ladder_cases()))
    def test_ladder_matches_reference(self, case):
        """Result or error type, chunk counts tried and events equal."""
        primary, make_fb = _ladder_cases()[case]
        got = []
        for rec, st in (PKGS["ref"], PKGS["port"]):
            seen = []
            try:
                out = rec.run_with_recovery(lambda: primary(st), True,
                                            make_fb(st, seen), "t")
            except Exception as e:  # noqa: BLE001 — compared by type name
                out = type(e).__name__
            got.append((out, seen, _events(rec)))
        assert got[0] == got[1]

    def test_nested_ladder_never_reescalates(self, pkg):
        rec, _ = pkg
        inner_calls = []

        def inner():
            return rec.run_with_recovery(
                _oom, True, lambda nc: inner_calls.append(nc), "inner")

        def fb(nc):
            if nc == 4:
                inner()
            return "ok"

        assert rec.run_with_recovery(_oom, True, fb, "outer") == "ok"
        assert inner_calls == []

    def test_counted_in_timing_stats(self):
        from cylon_tpu_torch.utils import timing
        prec.run_with_recovery(_oom, True, lambda nc: "ok", "t")
        assert any(k.startswith("recovery.t.device_oom.retry")
                   for k in timing.snapshot()), timing.snapshot()
        assert timing.counts()["recovery.t.device_oom.retry_chunks_4"] >= 1

    def test_failed_attempt_frames_are_cleared(self):
        """The failed attempt's locals are released before the retry: a
        tensor held only by the raising frame is collected by then."""
        import weakref
        refs = []

        def primary():
            big = torch.zeros(1024)
            refs.append(weakref.ref(big))
            raise RuntimeError("CUDA out of memory. Tried to allocate")

        def fb(nc):
            gc.collect()
            assert refs[0]() is None, "the failed attempt's tensor lives"
            return "ok"

        assert prec.run_with_recovery(primary, True, fb, "t") == "ok"


# ---------------------------------------------------------------------------
# the ladder through the operators (injection-driven)
# ---------------------------------------------------------------------------

def _both_tables(ldf, rdf, env4, penv4):
    return ((rct.Table.from_pandas(ldf, env4),
             rct.Table.from_pandas(rdf, env4)),
            (pct.Table.from_pandas(ldf, penv4),
             pct.Table.from_pandas(rdf, penv4)))


class TestInjectedOperators:
    @pytest.mark.parametrize("spec", [
        "shuffle.recv_guard:0:1=predicted",
        "shuffle.recv_guard:0:1=predicted,join.piece_cap::1=capacity",
        "shuffle.recv_guard::1=device_oom",
    ])
    def test_join_ladders_match(self, env4, penv4, rng, spec):
        """A guard fault reroutes the join through the pipeline; a piece
        cap overflow inside the 4-chunk rung moves to the next rung: the
        same events and the same rows as the reference."""
        ldf, rdf = _frames(rng)
        (rl, rr), (pl, pr) = _both_tables(ldf, rdf, env4, penv4)
        rrec.install_faults(spec)
        prec.install_faults(spec)
        rj = r_join(rl, rr, "k", "k", how="inner")
        pj = pct.join_tables(pl, pr, "k", "k", how="inner")
        assert _events(prec) == _events(rrec)
        assert _events(prec)[0][2] == "retry_chunks_4"
        _same(rj, pj, ["k", "a", "b"])
        exp = ldf.merge(rdf, on="k")
        assert pj.row_count == len(exp)

    @pytest.mark.parametrize("spec,raises", [
        ("groupby.device_oom::1=device_oom", False),
        ("groupby.device_oom::1=device_oom,"
         "groupby.device_oom::2=device_oom", False),
        ("groupby.device_oom::*=device_oom", True),
    ])
    def test_groupby_ladders_match(self, env4, penv4, rng, spec, raises):
        """4 → 16 chunk escalation of the groupby and its typed
        exhaustion: the same events and sums as the reference."""
        ldf, _ = _frames(rng, n=1200 if raises else 4000)
        rt = rct.Table.from_pandas(ldf, env4)
        pt = pct.Table.from_pandas(ldf, penv4)
        out = []
        for rec, st, fn, t in ((rrec, rstatus, r_groupby, rt),
                               (prec, pstatus, pct.groupby_aggregate, pt)):
            rec.install_faults(spec)
            res = None
            if raises:
                with pytest.raises(st.DeviceOOMError):
                    fn(t, "k", [("a", "sum")])
            else:
                res = fn(t, "k", [("a", "sum")])
            out.append((_events(rec), res))
        assert out[0][0] == out[1][0]
        assert ("groupby", "device_oom", "retry_chunks_4") in out[1][0]
        if not raises:
            _same(out[0][1], out[1][1], ["k", "a_sum"])

    def test_packed_piece_cap_check_is_typed(self, penv4, rng):
        from cylon_tpu_torch.relational.piece import PieceSource
        ldf, _ = _frames(rng, n=800)
        src = PieceSource(pct.Table.from_pandas(ldf, penv4), pad=8)
        with pytest.raises(pstatus.CapacityOverflowError):
            src.packed(np.zeros(W, np.int64), np.full(W, 64, np.int64),
                       piece_cap=32)

    def test_set_op_falls_back(self, env4, penv4, rng):
        """The set operation's OOM retries through ``pipelined_set_op``,
        as the reference's does: same events, same rows."""
        ldf, rdf = _frames(rng, n=2000)
        (rl, rr), (pl, pr) = _both_tables(ldf[["k"]], rdf[["k"]], env4,
                                          penv4)
        from cylon_tpu.relational.setops import set_operation as r_setop
        spec = "shuffle.recv_guard::1=device_oom"
        rrec.install_faults(spec)
        prec.install_faults(spec)
        r = r_setop(rl, rr, "subtract")
        p = pct.set_operation(pl, pr, "subtract")
        assert _events(prec) == _events(rrec) \
            == [("set_op", "device_oom", "retry_chunks_4")]
        _same(r, p, ["k"])


# ---------------------------------------------------------------------------
# prefetch and recovery together
# ---------------------------------------------------------------------------

class TestOverlapRobustness:
    """The port's piece schedule always prepares pieces through
    ``_PieceFuture`` (the reference's overlap on): faults raised while
    preparing a piece ahead surface at its consume point, and the ladder
    takes the reference's rungs at the same pieces."""

    def test_piece_future_defers_typed_not_foreign(self):
        from cylon_tpu_torch.exec.pipeline import _PieceFuture

        def typed():
            raise pstatus.CapacityOverflowError("deferred until consumed")

        fut = _PieceFuture(typed)          # held: raised when consumed
        with pytest.raises(pstatus.CapacityOverflowError):
            fut.get()
        with pytest.raises(ValueError):       # foreign: raised at once
            _PieceFuture(lambda: (_ for _ in ()).throw(ValueError("x")))

    def test_phase_sync_fault_surfaces_typed(self, env4, penv4, rng,
                                             monkeypatch):
        ldf, rdf = _frames(rng, n=1500)
        (rl, rr), (pl, pr) = _both_tables(ldf, rdf, env4, penv4)
        monkeypatch.setattr(rconfig, "PACKED_OVERLAP", True)
        for rec, st, run, lt, rt in (
                (rrec, rstatus, r_pipe, rl, rr),
                (prec, pstatus, pct.pipelined_join, pl, pr)):
            rec.install_faults("pipe.phase_sync::1=predicted")
            with pytest.raises(st.PredictedResourceExhausted):
                run(lt, rt, "k", "k", how="inner", n_chunks=3)
            assert _events(rec) == [("pipe.phase_sync", "predicted",
                                     "injected")]

    @pytest.mark.parametrize("spec,budget", [
        ("shuffle.recv_guard:0:1=predicted,join.piece_cap::1=capacity",
         0),
        ("spill.upload::1=device_oom", 4096),
    ])
    def test_piece_faults_ladder_matches(self, env4, penv4, rng,
                                         monkeypatch, spec, budget):
        """A piece-cap overflow inside the pipelined fallback, and a
        device OOM at a spilled source's window upload: the reference's
        events (its overlap on) and the same rows."""
        ldf, rdf = _frames(rng)
        (rl, rr), (pl, pr) = _both_tables(ldf, rdf, env4, penv4)
        monkeypatch.setattr(rconfig, "PACKED_OVERLAP", True)
        for cfg in (rconfig, pconfig):
            monkeypatch.setattr(cfg, "HBM_BUDGET_BYTES", budget)
        outs = []
        for rec, run, join, env, lt, rt in (
                (rrec, r_pipe, r_join, env4, rl, rr),
                (prec, pct.pipelined_join, pct.join_tables, penv4, pl, pr)):
            gc.collect()
            rec.install_faults(spec)
            if budget:
                out = rec.run_with_recovery(
                    lambda: run(lt, rt, "k", "k", how="inner", n_chunks=4),
                    True, lambda nc: run(lt, rt, "k", "k", how="inner",
                                         n_chunks=nc), "join", env=env)
            else:
                out = join(lt, rt, "k", "k", how="inner")
            outs.append((_events(rec), out))
        assert outs[0][0] == outs[1][0] and outs[1][0]
        _same(outs[0][1], outs[1][1], ["k", "a", "b"])
        pmem.reset_stats()

    def test_groupby_oom_ladder_matches(self, env4, penv4, rng,
                                        monkeypatch):
        """The chaos-soak shape: a pipelined join into a GroupBySink keyed
        on a non-join column under the ladder, a device OOM at the
        groupby site: the same events and bit-equal sums."""
        n = 2000
        ldf = pd.DataFrame({"k": rng.integers(0, 500, n).astype(np.int64),
                            "g": rng.integers(0, 7, n).astype(np.int64),
                            "a": rng.integers(0, 50, n).astype(np.int64)})
        rdf = pd.DataFrame({"k": rng.integers(0, 500, n).astype(np.int64),
                            "b": rng.integers(0, 50, n).astype(np.int64)})
        (rl, rr), (pl, pr) = _both_tables(ldf, rdf, env4, penv4)
        monkeypatch.setattr(rconfig, "PACKED_OVERLAP", True)
        outs = []
        for rec, run, sink_cls, env, lt, rt in (
                (rrec, r_pipe, RSink, env4, rl, rr),
                (prec, pct.pipelined_join, pct.GroupBySink, penv4, pl, pr)):
            rec.install_faults("groupby.device_oom::1=device_oom")

            def attempt(nc):
                sink = sink_cls("g", [("a", "sum")])
                run(lt, rt, "k", "k", how="inner", n_chunks=nc, sink=sink)
                return sink.finalize()

            out = rec.run_with_recovery(lambda: attempt(4), True, attempt,
                                        "soak", env=env)
            outs.append((_events(rec), out))
        assert outs[0][0] == outs[1][0] and outs[1][0]
        _same(outs[0][1], outs[1][1], ["g", "a_sum"])


# ---------------------------------------------------------------------------
# consensus and the watchdog
# ---------------------------------------------------------------------------

class TestConsensusAndWatchdog:
    def test_consensus_single_controller_is_local(self, penv4):
        C = pstatus.Code
        for code in (C.OK, C.OutOfMemory, C.CapacityError):
            assert prec.consensus_code(penv4, code) == code
            assert prec.consensus_code(None, code) == code
        assert prec.guard_consensus(penv4, True)
        assert not prec.guard_consensus(penv4, False)
        assert prec.spill_consensus(penv4, True)
        assert not prec.spill_consensus(penv4, False)
        assert prec.count_consensus(penv4, 3) == 3
        prec.skew_plan_consensus(penv4, 0xDEADBEEF)
        for n in (-3, 0, 3, (1 << 20) - 1, 1 << 21):   # clamped to the wire
            assert prec.count_consensus(penv4, n) == \
                rrec.count_consensus(None, n)

    def test_watermark_consensus_value_and_range(self, penv4, env4):
        """The watermark vote returns the local count on one controller,
        as the reference's does on one process, and both refuse a count
        outside the wire's 20-bit field."""
        for n in (0, 1, 7, (1 << 20) - 1):
            assert prec.watermark_consensus(penv4, n) == n \
                == rrec.watermark_consensus(env4.mesh, n)
        for n in (-1, 1 << 20, 1 << 40):
            for rec, arg in ((prec, penv4), (rrec, env4.mesh)):
                with pytest.raises(ValueError):
                    rec.watermark_consensus(arg, n)

    def test_watchdog_passthrough_and_errors(self, pkg):
        rec, _ = pkg
        assert rec.exchange_watchdog("exchange.counts", lambda: 7,
                                     timeout_s=0) == 7
        assert rec.exchange_watchdog("exchange.counts", lambda: 7,
                                     timeout_s=5.0) == 7
        with pytest.raises(ValueError):
            rec.exchange_watchdog(
                "exchange.counts",
                lambda: (_ for _ in ()).throw(ValueError("inner")),
                timeout_s=5.0)

    def test_watchdog_converts_stall_to_desync(self, pkg):
        rec, st = pkg
        from cylon_tpu.utils import timing as rtiming
        from cylon_tpu_torch.utils import timing as ptiming
        timing = ptiming if rec is prec else rtiming
        with timing.region("pipe.unit_test_phase"):
            pass
        rec.install_faults("exchange.stall=stall")
        with pytest.raises(st.RankDesyncError) as ei:
            rec.exchange_watchdog("exchange.counts", lambda: 7,
                                  timeout_s=0.2)
        assert ei.value.site == "exchange.counts"
        assert ei.value.phase == "pipe.unit_test_phase"
        assert _events(rec) == [("exchange.counts", "desync", "watchdog")]

    def test_watchdog_stall_through_shuffle(self, env4, penv4, rng,
                                            monkeypatch):
        """A stalled count pull surfaces as RankDesyncError from the
        shuffle, in both packages, and the ladder does not retry it."""
        ldf, _ = _frames(rng, n=800)
        for cfg in (rconfig, pconfig):
            monkeypatch.setattr(cfg, "EXCHANGE_WATCHDOG_S", 0.2)
        for rec, st, shuffle, t in (
                (rrec, rstatus, r_shuffle, rct.Table.from_pandas(ldf, env4)),
                (prec, pstatus, p_shuffle,
                 pct.Table.from_pandas(ldf, penv4))):
            rec.install_faults("exchange.stall=stall")
            with pytest.raises(st.RankDesyncError):
                shuffle(t, ["k"])


# ---------------------------------------------------------------------------
# the typed guard site
# ---------------------------------------------------------------------------

class TestGuardSiteTyped:
    def test_recv_guard_honors_injected_kind(self, env4, penv4, rng):
        ldf, _ = _frames(rng, n=800)
        for rec, st, shuffle, t in (
                (rrec, rstatus, r_shuffle, rct.Table.from_pandas(ldf, env4)),
                (prec, pstatus, p_shuffle,
                 pct.Table.from_pandas(ldf, penv4))):
            rec.install_faults("shuffle.recv_guard::1=capacity")
            with pytest.raises(st.CapacityOverflowError):
                shuffle(t, ["k"])

    def test_recv_guard_raises_typed(self, env8, rng, monkeypatch):
        """One key in every row: its destination's receive passes a 4 KiB
        budget, and both packages refuse before the exchange allocates."""
        n = 4000
        df = pd.DataFrame({"k": np.full(n, 7, np.int64),
                           "v": rng.random(n)})
        penv8 = pct.CylonEnv(pct.VirtualMeshConfig(8), device="cpu")
        for cfg in (rconfig, pconfig):
            monkeypatch.setattr(cfg, "EXCHANGE_RECV_BUDGET_BYTES", 4096)
        # the reference's CPU switch; the port's guard binds on the card
        monkeypatch.setattr(rconfig, "EXCHANGE_RECV_GUARD_CPU", True)
        monkeypatch.setattr(p_shuffle_mod, "_guard_applies", lambda env: True)
        msgs = []
        for st, shuffle, t in (
                (rstatus, r_shuffle, rct.Table.from_pandas(df, env8)),
                (pstatus, p_shuffle, pct.Table.from_pandas(df, penv8))):
            with pytest.raises(st.PredictedResourceExhausted) as ei:
                shuffle(t, ["k"])
            assert ei.value.site == "shuffle.recv_guard"
            assert "RESOURCE_EXHAUSTED (predicted)" in str(ei.value)
            msgs.append(str(ei.value).split(" B at ")[0])
        assert msgs[0] == msgs[1]      # the same predicted receive bytes
