"""Durable checkpoints, resume, the elastic re-shard, the preemption drain
and the ladder's final rung of cylon_tpu_torch (``exec/checkpoint.py``,
``exec/preempt.py``, ``exec/recovery.py``, ``exec/pipeline.py``) against
cylon_tpu's, mirroring the classes of tests/test_checkpoint.py.

Every scenario runs in both packages on the same tables (numpy draws from
one seed, through pandas), each package under its own checkpoint root.
Held equal: the results (sorted rows, bit for bit; NaN equal to NaN), the
``checkpoint.stats()`` counters (``bytes_checkpointed`` as zero or not:
the meta sidecars pickle each package's own classes), the recovery
events and the plan tokens the manifests record.  The operator cases run at W = 4 unless a
case says otherwise (the reference's CPU mesh, the port's
``VirtualMeshConfig`` on the CPU).  Not mirrored: the two serving-tier
drains (the scheduler is slice 13), the compiler-crash final rung (the
compile tier, slice 16) and the chaos soak, for which a port child
process is killed at ``ckpt.write`` and resumed."""

import json
import os
import shutil
import signal
import subprocess
import sys

import jax
import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu.ctx.context import CPUMeshConfig
from cylon_tpu.exec import GroupBySink as RSink
from cylon_tpu.exec import checkpoint as rckpt
from cylon_tpu.exec import pipelined_join as r_pipe
from cylon_tpu.exec import preempt as rpre
from cylon_tpu.exec import recovery as rrec
from cylon_tpu import status as rstatus
from cylon_tpu.relational import groupby_aggregate as r_groupby
import cylon_tpu_torch as pct
from cylon_tpu_torch.exec import checkpoint as pckpt
from cylon_tpu_torch.exec import memory as pmem
from cylon_tpu_torch.exec import preempt as ppre
from cylon_tpu_torch.exec import recovery as prec
from cylon_tpu_torch import status as pstatus
from cylon_tpu_torch.utils import timing as ptiming

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pkg:
    """One package's handles, so a scenario is written once."""

    def __init__(self, name, ct, ckpt, rec, pre, st, sink, pipe, prefix):
        self.name, self.ct, self.ckpt, self.rec = name, ct, ckpt, rec
        self.pre, self.st, self.sink, self.pipe = pre, st, sink, pipe
        self.prefix = prefix
        self._envs: dict = {}

    def env(self, w: int):
        if w not in self._envs:
            if self.name == "ref":
                self._envs[w] = rct.CylonEnv(
                    config=CPUMeshConfig(world_size=w) if w > 1
                    else rct.LocalConfig())
            else:
                self._envs[w] = pct.CylonEnv(pct.VirtualMeshConfig(w),
                                             device="cpu")
        return self._envs[w]

    def var(self, name: str) -> str:
        return self.prefix + name

    def tables(self, ldf, rdf, w: int):
        env = self.env(w)
        return (self.ct.Table.from_pandas(ldf, env),
                self.ct.Table.from_pandas(rdf, env))

    def join(self, lt, rt, n_chunks=4):
        return _sorted(self.pipe(lt, rt, "k", "k", how="inner",
                                 n_chunks=n_chunks))

    def sink_run(self, lt, rt, n_chunks=4):
        sink = self.sink("k", [("a", "sum"), ("b", "sum")])
        self.pipe(lt, rt, "k", "k", how="inner", n_chunks=n_chunks,
                  sink=sink)
        return _sorted(sink.finalize())

    def root(self) -> str:
        return self.ckpt.ckpt_dir()

    def stage_dir(self) -> str:
        """rank0's first stage directory."""
        rank_dir = os.path.join(self.root(), "rank0")
        return os.path.join(rank_dir, sorted(os.listdir(rank_dir))[0])

    def manifest(self) -> dict:
        with open(os.path.join(self.stage_dir(), "MANIFEST.json"),
                  encoding="utf-8") as f:
            return json.load(f)

    def events(self):
        return [(e["site"], e["kind"], e["action"])
                for e in self.rec.recovery_events()]

    def reset(self):
        self.ckpt.reset_stages()
        self.ckpt.reset_stats()


REF = Pkg("ref", rct, rckpt, rrec, rpre, rstatus, RSink, r_pipe,
          "CYLON_TPU_")
PORT = Pkg("port", pct, pckpt, prec, ppre, pstatus, pct.GroupBySink,
           pct.pipelined_join, "CYLON_TPU_TORCH_")
BOTH = (REF, PORT)


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Release the reference's compiled XLA:CPU programs at module end."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    """Each package under its own checkpoint root, with a fresh stage
    sequence, zeroed counters, a disarmed injector and no pending
    preemption notice."""
    for p in BOTH:
        monkeypatch.setenv(p.var("CKPT_DIR"), str(tmp_path / p.name))
        monkeypatch.delenv(p.var("RESUME"), raising=False)
        monkeypatch.delenv(p.var("PREEMPT_GRACE_S"), raising=False)
        p.reset()
        p.rec.install_faults("")
        p.pre.reset()
    yield
    for p in BOTH:
        p.reset()
        p.rec.install_faults("")
        p.pre.reset(uninstall=True)


def _resume_mode(monkeypatch):
    """What a fresh process run with the resume switch does."""
    for p in BOTH:
        monkeypatch.setenv(p.var("RESUME"), "1")
        p.reset()


def _sorted(table) -> pd.DataFrame:
    df = table.to_pandas()
    cols = [c for c in ("k", "a", "b", "s", "f", "a_sum", "b_sum")
            if c in df.columns]
    return df.sort_values(cols, na_position="last").reset_index(drop=True)


def _bitequal(a: pd.DataFrame, b: pd.DataFrame) -> None:
    assert list(a.columns) == list(b.columns)
    for c in a.columns:
        np.testing.assert_array_equal(b[c].to_numpy(), a[c].to_numpy(), c)


def _frames(rng, n=2500, card=250):
    ldf = pd.DataFrame({"k": rng.integers(0, card, n).astype(np.int64),
                        "a": rng.integers(0, 50, n).astype(np.int64)})
    rdf = pd.DataFrame({"k": rng.integers(0, card, n).astype(np.int64),
                        "b": rng.integers(0, 50, n).astype(np.int64)})
    return ldf, rdf


def _stats_equal():
    """Both packages' counters equal; ``bytes_checkpointed`` only as zero
    or not, since the meta sidecars pickle each package's own classes
    (the module paths differ in length)."""
    rs, ps = REF.ckpt.stats(), PORT.ckpt.stats()
    assert (ps.pop("bytes_checkpointed") > 0) \
        == (rs.pop("bytes_checkpointed") > 0)
    assert ps == rs
    return PORT.ckpt.stats()


def _tokens_equal():
    """The manifests of both packages' first stage name the same plan:
    base token and full token."""
    rm, pm = REF.manifest(), PORT.manifest()
    assert pm["base"] == rm["base"]
    assert pm["plan"] == rm["plan"]
    return pm


def _run_both(run, ldf, rdf, w=4, **kw):
    """``run`` ("join" or "sink_run") in both packages on the same frames,
    held bit-equal, and, armed, the plan tokens their first stage's
    manifests record held equal.  Returns the reference's result."""
    out = []
    for p in BOTH:
        lt, rt = p.tables(ldf, rdf, w)
        out.append(getattr(p, run)(lt, rt, **kw))
    _bitequal(*out)
    if all(p.root() and os.path.isdir(os.path.join(p.root(), "rank0"))
           for p in BOTH):
        _tokens_equal()
    return out[0]


def _flip(path, at=None):
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2 if at is None else at] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))


def _first_page(p):
    d = p.stage_dir()
    return os.path.join(d, next(f for f in sorted(os.listdir(d))
                                if f.startswith("piece_0.p")))


# ---------------------------------------------------------------------------
# page round trip
# ---------------------------------------------------------------------------

def _classes_frame(rng, n=400):
    df = pd.DataFrame({
        "k": rng.integers(0, 50, n).astype(np.int64),
        "s": np.asarray([f"v{i % 7}" for i in range(n)], dtype=object),
        "f": np.where(rng.random(n) < 0.1, np.nan, rng.random(n)),
        "ni": pd.array(rng.integers(0, 9, n), dtype="Int64"),
    })
    df.loc[rng.integers(0, n, 20), "ni"] = pd.NA
    df.loc[rng.integers(0, n, 10), "f"] = -0.0
    return df


def _same_columns(t, back):
    assert back.column_names == t.column_names
    for name in t.column_names:
        a, b = t.column(name), back.column(name)
        assert a.type == b.type, name
        assert a.data.dtype == b.data.dtype, name
        np.testing.assert_array_equal(
            np.asarray(b.data).view(np.uint8),
            np.asarray(a.data).view(np.uint8), name)
        assert (a.validity is None) == (b.validity is None), name
        if a.validity is not None:
            np.testing.assert_array_equal(np.asarray(b.validity),
                                          np.asarray(a.validity), name)
        assert a.bounds == b.bounds, name
    np.testing.assert_array_equal(back.valid_counts, t.valid_counts)


class TestPageRoundTrip:
    @pytest.mark.parametrize("w", [1, 4])
    def test_bit_exact_all_column_classes(self, rng, w):
        """Dictionary strings, nullable ints, NaN and -0.0 f64 and int64
        round-trip bit-exactly through a page in both packages."""
        df = _classes_frame(rng)
        for p in BOTH:
            t = p.ct.Table.from_pandas(df, p.env(w))
            stage = p.ckpt.open_stage(p.env(w), "unit", "tok")
            stage.save_piece(0, t)
            _same_columns(t, stage.load_piece(0))
        assert _stats_equal()["resume_fast_forwarded_pieces"] == 1

    def test_port_only_column_classes(self, rng, monkeypatch):
        """The port's other column classes: uint16/32/64 through their
        signed views, hashed strings, decimal, list and bool, with their
        bounds and dictionaries."""
        import decimal
        from cylon_tpu_torch import config as pconfig
        monkeypatch.setattr(pconfig, "STRING_HASH_MIN_ROWS", 16)
        monkeypatch.setattr(pconfig, "STRING_HASH_RATIO", 0.01)
        n = 64
        env = PORT.env(4)
        t = pct.Table.from_pydict({
            "u16": rng.integers(0, 1 << 16, n).astype(np.uint16),
            "u32": rng.integers(0, 1 << 32, n).astype(np.uint32),
            "u64": rng.integers(0, 1 << 63, n).astype(np.uint64)
            | np.uint64(1 << 63),
            "h": np.asarray([f"name{i}" for i in range(n)], dtype=object),
            "d": np.asarray([decimal.Decimal(i) / 100 for i in range(n)],
                            dtype=object),
            # the trailing None keeps numpy from stacking the lists 2-D
            "l": np.asarray([[i, i + 1] for i in range(n)] + [None],
                            dtype=object)[:n],
            "bb": rng.random(n) < 0.5,
        }, env)
        from cylon_tpu_torch.core.column import HashedStrings
        assert isinstance(t.column("h").dictionary, HashedStrings)
        stage = pckpt.open_stage(env, "unit", "tok")
        stage.save_piece(0, t)
        back = stage.load_piece(0)
        _same_columns(t, back)
        assert back.to_pydict()["h"].tolist() == t.to_pydict()["h"].tolist()
        assert back.to_pydict()["d"].tolist() == t.to_pydict()["d"].tolist()
        assert back.to_pydict()["l"].tolist() == t.to_pydict()["l"].tolist()

    def test_flaky_write_is_retried_not_aborted(self, rng, monkeypatch):
        """A transient OSError on the manifest rename is retried
        (``recovery.retry_io``) and the piece round-trips bit-exactly."""
        monkeypatch.setattr("time.sleep", lambda s: None)
        df = pd.DataFrame({"k": rng.integers(0, 9, 64).astype(np.int64)})
        real = os.replace
        for p in BOTH:
            t = p.ct.Table.from_pandas(df, p.env(4))
            stage = p.ckpt.open_stage(p.env(4), "flaky", "tok")
            fails = [1]

            def flaky(src, dst, fails=fails):
                if fails[0]:
                    fails[0] -= 1
                    raise OSError(5, "transient EIO blip")
                return real(src, dst)

            monkeypatch.setattr(os, "replace", flaky)
            before = prec.IO_RETRIES.value
            stage.save_piece(0, t)
            monkeypatch.setattr(os, "replace", real)
            if p is PORT:
                assert prec.IO_RETRIES.value == before + 1
            _same_columns(t, stage.load_piece(0))
        _stats_equal()

    def test_manifest_commits_identical_epoch_per_piece(self, rng):
        ldf, rdf = _frames(rng, n=800)
        mans = []
        for p in BOTH:
            lt, rt = p.tables(ldf, rdf, 4)
            stage = p.ckpt.open_stage(p.env(4), "unit", "tok")
            stage.save_piece(0, lt)
            stage.save_piece(1, rt)
            man = p.manifest()
            assert not os.path.exists(
                os.path.join(p.stage_dir(), "MANIFEST.json.staged"))
            mans.append(man)
        for m in mans:
            assert m["epoch"] == 2 and m["plan"] == "tok"
            assert set(m["pieces"]) == {"0", "1"}
        keep = ("plan", "base", "label", "epoch", "gen", "complete",
                "n_pieces", "world", "procs")
        assert {k: mans[1][k] for k in keep} == {k: mans[0][k] for k in keep}
        assert _stats_equal()["checkpoint_events"] == 2

    def test_hash_mismatch_raises_typed(self, rng):
        ldf, _ = _frames(rng, n=800)
        for p in BOTH:
            t = p.ct.Table.from_pandas(ldf, p.env(4))
            stage = p.ckpt.open_stage(p.env(4), "unit", "tok")
            stage.save_piece(0, t)
            _flip(os.path.join(stage.dir, stage.committed[0]["meta"]), at=0)
            with pytest.raises(p.st.CheckpointCorruptError):
                stage.load_piece(0)
        assert _stats_equal()["corrupt_pages"] == 1


# ---------------------------------------------------------------------------
# resume fast-forward through the pipelined range loop
# ---------------------------------------------------------------------------

class TestResumeFastForward:
    @pytest.mark.parametrize("w", [1, 3, 4])
    def test_sinkless_resume_bit_equal_no_recompute(self, rng, monkeypatch,
                                                    w):
        ldf, rdf = _frames(rng)
        base = _run_both("join", ldf, rdf, w)
        s1 = _stats_equal()
        assert s1["checkpoint_events"] >= 2 and s1["bytes_checkpointed"] > 0
        _tokens_equal()
        _resume_mode(monkeypatch)
        _bitequal(base, _run_both("join", ldf, rdf, w))
        s2 = _stats_equal()
        assert s2["resume_fast_forwarded_pieces"] == s1["checkpoint_events"]
        assert s2["checkpoint_events"] == 0

    @pytest.mark.parametrize("w", [1, 3, 4])
    def test_sink_partials_resume_bit_equal(self, rng, monkeypatch, w):
        ldf, rdf = _frames(rng)
        base = _run_both("sink_run", ldf, rdf, w)
        exp = (ldf.merge(rdf, on="k").groupby("k", as_index=False)
               .agg(a_sum=("a", "sum"), b_sum=("b", "sum")))
        np.testing.assert_array_equal(base["a_sum"], exp["a_sum"])
        n_committed = _stats_equal()["checkpoint_events"]
        assert n_committed >= 2
        _tokens_equal()
        _resume_mode(monkeypatch)
        _bitequal(base, _run_both("sink_run", ldf, rdf, w))
        assert _stats_equal()["resume_fast_forwarded_pieces"] == n_committed

    def test_partial_prefix_resume(self, rng, monkeypatch):
        """Only a prefix committed: the resume restores it and recomputes
        the rest, bit-equal."""
        ldf, rdf = _frames(rng)
        base = _run_both("join", ldf, rdf)
        full = None
        for p in BOTH:
            path = os.path.join(p.stage_dir(), "MANIFEST.json")
            man = p.manifest()
            full = len(man["pieces"])
            del man["pieces"][str(max(int(k) for k in man["pieces"]))]
            man["epoch"] -= 1
            with open(path, "w", encoding="utf-8") as f:
                json.dump(man, f)
        assert full >= 2
        _resume_mode(monkeypatch)
        _bitequal(base, _run_both("join", ldf, rdf))
        s = _stats_equal()
        assert s["resume_fast_forwarded_pieces"] == full - 1
        assert s["checkpoint_events"] == 1

    def test_corrupt_page_degrades_to_recompute(self, rng, monkeypatch):
        ldf, rdf = _frames(rng)
        base = _run_both("join", ldf, rdf)
        for p in BOTH:
            _flip(_first_page(p))
        _resume_mode(monkeypatch)
        _bitequal(base, _run_both("join", ldf, rdf))
        s = _stats_equal()
        assert s["corrupt_pages"] >= 1
        assert s["resume_fast_forwarded_pieces"] == 0
        assert PORT.events() == REF.events() \
            == [("ckpt.load", "corrupt", "recompute")]

    def test_injected_write_corruption_caught_on_resume(self, rng,
                                                        monkeypatch):
        """``ckpt.write`` ``corrupt`` flips a page byte after hashing: the
        resume's check catches it and the stage recomputes."""
        ldf, rdf = _frames(rng)
        for p in BOTH:
            p.rec.install_faults("ckpt.write::1=corrupt")
        base = _run_both("sink_run", ldf, rdf)
        _resume_mode(monkeypatch)
        _bitequal(base, _run_both("sink_run", ldf, rdf))
        s = _stats_equal()
        assert s["corrupt_pages"] == 1
        assert s["resume_fast_forwarded_pieces"] == 0
        assert PORT.events() == REF.events()

    def test_injected_load_corruption(self, rng, monkeypatch):
        ldf, rdf = _frames(rng)
        base = _run_both("join", ldf, rdf)
        _resume_mode(monkeypatch)
        for p in BOTH:
            p.rec.install_faults("ckpt.load::1=corrupt")
        _bitequal(base, _run_both("join", ldf, rdf))
        assert _stats_equal()["resume_fast_forwarded_pieces"] == 0
        assert PORT.events() == REF.events()
        assert ("ckpt.load", "corrupt", "recompute") in PORT.events()

    def test_plan_token_mismatch_starts_over(self, rng, monkeypatch):
        """A checkpoint of another plan (another chunk count) is never
        spliced in: the stage starts over."""
        ldf, rdf = _frames(rng)
        _run_both("join", ldf, rdf, n_chunks=4)
        _resume_mode(monkeypatch)
        out = _run_both("join", ldf, rdf, n_chunks=3)
        exp = ldf.merge(rdf, on="k").sort_values(["k", "a", "b"])
        np.testing.assert_array_equal(out["a"], exp["a"])
        s = _stats_equal()
        assert s["resume_fast_forwarded_pieces"] == 0
        assert s["checkpoint_events"] >= 2

    def test_injected_write_fault_records_event(self, rng):
        """A ``device_oom`` at ``ckpt.write`` is recorded and the ladder
        converges in both packages alike."""
        ldf, rdf = _frames(rng)
        outs = []
        for p in BOTH:
            lt, rt = p.tables(ldf, rdf, 4)
            p.rec.install_faults("ckpt.write::1=device_oom")

            def attempt(nc=4, p=p, lt=lt, rt=rt):
                return p.join(lt, rt, n_chunks=nc)

            outs.append(p.rec.run_with_recovery(attempt, True, attempt,
                                                "test", env=p.env(4)))
        _bitequal(*outs)
        assert PORT.events() == REF.events()
        assert ("ckpt.write", "device_oom", "injected") in PORT.events()
        _stats_equal()

    def test_resume_consensus_wire_math(self):
        for rec in (rrec, prec):
            assert rec.ckpt_resume_consensus(None, 0) == 0
            assert rec.ckpt_resume_consensus(None, 7) == 7
            assert rec.ckpt_commit_consensus(None, 3) == 3
            assert rec.drain_consensus(None, True) is True
            assert rec.drain_consensus(None, False) is False
            for bad in (-1, 1 << 20):
                with pytest.raises(ValueError):
                    rec.ckpt_resume_consensus(None, bad)
                with pytest.raises(ValueError):
                    rec.ckpt_commit_consensus(None, bad)
        for p in BOTH:
            p.ckpt._STATS["resume_fast_forwarded_pieces"] = 5
            p.ckpt.unrestore(2)
        assert _stats_equal()["resume_fast_forwarded_pieces"] == 3
        for name in ("CkptCommit", "PreemptDrain"):
            assert int(getattr(pstatus.Code, name)) \
                == int(getattr(rstatus.Code, name))

    def test_staged_only_manifest_is_ignored(self, rng, monkeypatch):
        """A manifest staged but never published is not restored."""
        ldf, rdf = _frames(rng)
        base = _run_both("join", ldf, rdf)
        for p in BOTH:
            m = os.path.join(p.stage_dir(), "MANIFEST.json")
            os.replace(m, m + ".staged")
        _resume_mode(monkeypatch)
        _bitequal(base, _run_both("join", ldf, rdf))
        assert _stats_equal()["resume_fast_forwarded_pieces"] == 0

    def test_fast_forwarded_pieces_upload_nothing(self, rng, monkeypatch):
        """With the packed sources spilled (a 4 KiB ledger budget), a
        partial-prefix resume uploads windows only for the recomputed
        piece: a fast-forwarded piece never gets a prepared piece."""
        from cylon_tpu_torch import config as pconfig
        monkeypatch.setattr(pconfig, "HBM_BUDGET_BYTES", 4096)
        monkeypatch.setattr(pconfig, "SPILL_ENABLED", True)
        ldf, rdf = _frames(rng)
        base = REF.join(*REF.tables(ldf, rdf, 4))
        lt, rt = PORT.tables(ldf, rdf, 4)
        pmem.reset_stats()
        _bitequal(base, PORT.join(lt, rt))
        full_uploads = pmem.stats()["readmit_events"]
        n = PORT.ckpt.stats()["checkpoint_events"]
        assert full_uploads >= n >= 3
        man = PORT.manifest()
        for k in sorted(man["pieces"], key=int)[1:]:
            del man["pieces"][k]
        with open(os.path.join(PORT.stage_dir(), "MANIFEST.json"), "w",
                  encoding="utf-8") as f:
            json.dump(man, f)
        _resume_mode(monkeypatch)
        pmem.reset_stats()
        _bitequal(base, PORT.join(lt, rt))
        assert PORT.ckpt.stats()["resume_fast_forwarded_pieces"] == 1
        assert pmem.stats()["readmit_events"] \
            == full_uploads * (n - 1) // n


# ---------------------------------------------------------------------------
# elastic resume
# ---------------------------------------------------------------------------

class TestForeignPrefix:
    """``Stage.load_foreign_pieces(limit, prefix_ok)`` on a stage of four
    pieces committed at W = 4 and adopted at W = 2 (the stream views'
    mode): a corrupt piece k > 0 trims the adoption to pieces 0..k-1
    with a ``prefix_trim`` event; without ``prefix_ok``, or at k = 0,
    the adoption raises; ``limit`` caps the prefix."""

    @staticmethod
    def _commit(p, rng_seed=3):
        base = p.ckpt.plan_token("unit_prefix", "k", "a")
        stage = p.ckpt.open_stage(p.env(4), "unit", p.ckpt.plan_token(
            base, 4), base_token=base)
        rng = np.random.default_rng(rng_seed)
        frames = []
        for i in range(4):
            df = pd.DataFrame({"k": rng.integers(0, 50, 300).astype(
                np.int64), "a": rng.integers(0, 9, 300).astype(np.int64)})
            stage.save_piece(i, p.ct.Table.from_pandas(df, p.env(4)))
            frames.append(df.sort_values(["k", "a"]).reset_index(drop=True))
        return base, frames

    @staticmethod
    def _reopen(p, base):
        p.reset()
        return p.ckpt.open_stage(p.env(2), "unit", p.ckpt.plan_token(
            base, 2), base_token=base)

    @pytest.mark.parametrize("bad", [0, 1, 3])
    def test_corrupt_piece_trims_the_prefix(self, monkeypatch, bad):
        got = {}
        for p in BOTH:
            base, frames = self._commit(p)
            _flip(os.path.join(p.stage_dir(), f"piece_{bad}.p0"))
            monkeypatch.setenv(p.var("RESUME"), "1")
            stage = self._reopen(p, base)
            assert stage.foreign is not None and not stage.resuming
            with pytest.raises(p.st.CheckpointCorruptError):
                stage.load_foreign_pieces()
            if bad == 0:
                with pytest.raises(p.st.CheckpointCorruptError):
                    stage.load_foreign_pieces(prefix_ok=True)
                pieces = []
            else:
                pieces = stage.load_foreign_pieces(prefix_ok=True)
            assert len(pieces) == bad
            for piece, want in zip(pieces, frames):
                _bitequal(want, _sorted(piece))
                assert list(piece.valid_counts) == [150, 150]
            got[p.name] = (p.events(), p.ckpt.stats()["corrupt_pages"],
                           [_sorted(t) for t in pieces])
        assert got["port"][:2] == got["ref"][:2]
        assert (("ckpt.reshard", "corrupt", "prefix_trim")
                in got["port"][0]) == (bad > 0)

    def test_limit_caps_the_prefix(self, monkeypatch):
        for p in BOTH:
            base, frames = self._commit(p)
            _flip(os.path.join(p.stage_dir(), "piece_3.p0"))
            monkeypatch.setenv(p.var("RESUME"), "1")
            stage = self._reopen(p, base)
            pieces = stage.load_foreign_pieces(limit=2)
            assert len(pieces) == 2
            _bitequal(frames[1], _sorted(pieces[1]))
            assert len(stage.load_foreign_pieces(limit=9,
                                                 prefix_ok=True)) == 3
        assert PORT.events() == REF.events()


class TestElasticReshard:
    @staticmethod
    def _frames(rng, n=1800, card=200):
        return _frames(rng, n=n, card=card)

    @pytest.mark.parametrize("w_from,w_to", [(4, 2), (4, 1), (2, 4)])
    def test_reshard_then_plain_fast_forward(self, rng, monkeypatch,
                                             w_from, w_to):
        """A complete stage committed at ``w_from`` re-shards at ``w_to``
        (every piece fast-forwarded and re-sharded, the mismatch counted
        once) and, rewritten in the new layout, a second resume there is a
        plain fast-forward."""
        ldf, rdf = self._frames(rng)
        base = _run_both("join", ldf, rdf, w_from, n_chunks=3)
        n_pieces = _stats_equal()["checkpoint_events"]
        assert n_pieces >= 2
        _resume_mode(monkeypatch)
        _bitequal(base, _run_both("join", ldf, rdf, w_to, n_chunks=3))
        s = _stats_equal()
        assert s["resume_world_mismatch"] == 1
        assert s["resume_resharded_pieces"] == n_pieces
        assert s["resume_fast_forwarded_pieces"] == n_pieces
        assert PORT.events() == REF.events() \
            == [("ckpt.reshard", "world_mismatch", "detected")]
        _resume_mode(monkeypatch)
        _bitequal(base, _run_both("join", ldf, rdf, w_to, n_chunks=3))
        s2 = _stats_equal()
        assert s2["resume_world_mismatch"] == 0
        assert s2["resume_resharded_pieces"] == 0
        assert s2["resume_fast_forwarded_pieces"] == n_pieces
        assert s2["checkpoint_events"] == 0
        assert PORT.manifest()["world"] == w_to

    def test_lane_classes_round_trip_bit_exact(self, rng, monkeypatch):
        """Dictionary strings, nullable ints and NaN-carrying f64 survive
        the stitch and re-block bit-exactly."""
        n = 1600
        ldf = pd.DataFrame({
            "k": rng.integers(0, 120, n).astype(np.int64),
            "s": np.asarray([f"v{i % 11}" for i in range(n)], dtype=object),
            "f": np.where(rng.random(n) < 0.15, np.nan, rng.random(n)),
            "ni": pd.array(rng.integers(0, 9, n), dtype="Int64"),
        })
        ldf.loc[rng.integers(0, n, 40), "ni"] = pd.NA
        rdf = pd.DataFrame({"k": rng.integers(0, 120, n).astype(np.int64),
                            "b": rng.integers(0, 50, n).astype(np.int64)})
        base = _run_both("join", ldf, rdf, 4, n_chunks=3)
        _resume_mode(monkeypatch)
        out = _run_both("join", ldf, rdf, 2, n_chunks=3)
        _bitequal(base, out)
        assert _stats_equal()["resume_resharded_pieces"] > 0

    def test_corrupt_foreign_page_degrades_to_recompute(self, rng,
                                                        monkeypatch):
        ldf, rdf = self._frames(rng, n=1200)
        base = _run_both("join", ldf, rdf, 4)
        for p in BOTH:
            _flip(_first_page(p))
        _resume_mode(monkeypatch)
        _bitequal(base, _run_both("join", ldf, rdf, 2))
        s = _stats_equal()
        assert s["corrupt_pages"] >= 1
        assert s["resume_resharded_pieces"] == 0
        assert s["resume_world_mismatch"] == 1
        assert PORT.events() == REF.events()

    def test_injected_reshard_corruption(self, rng, monkeypatch):
        ldf, rdf = self._frames(rng, n=1200)
        base = _run_both("join", ldf, rdf, 4)
        _resume_mode(monkeypatch)
        for p in BOTH:
            p.rec.install_faults("ckpt.reshard::1=corrupt")
        _bitequal(base, _run_both("join", ldf, rdf, 2))
        assert _stats_equal()["resume_resharded_pieces"] == 0
        assert PORT.events() == REF.events()
        assert any(e[0] == "ckpt.reshard" for e in PORT.events())

    def test_sink_partial_reshard_equals_batch_recompute(self, rng,
                                                         monkeypatch):
        """GroupBySink partials re-shard as mergeable state and combine to
        the batch answer."""
        ldf, rdf = self._frames(rng)
        base = _run_both("sink_run", ldf, rdf, 4, n_chunks=3)
        n_pieces = _stats_equal()["checkpoint_events"]
        _resume_mode(monkeypatch)
        _bitequal(base, _run_both("sink_run", ldf, rdf, 2, n_chunks=3))
        assert _stats_equal()["resume_resharded_pieces"] == n_pieces > 0

    def test_incomplete_stage_recomputes_and_counts(self, rng, monkeypatch):
        """A stage that never completed at the old world is not adopted:
        the mismatch is counted and the stage recomputes."""
        ldf, rdf = self._frames(rng, n=1200)
        base = _run_both("join", ldf, rdf, 4)
        for p in BOTH:
            man = p.manifest()
            man["complete"] = False
            with open(os.path.join(p.stage_dir(), "MANIFEST.json"), "w",
                      encoding="utf-8") as f:
                json.dump(man, f)
        _resume_mode(monkeypatch)
        _bitequal(base, _run_both("join", ldf, rdf, 2))
        s = _stats_equal()
        assert s["resume_world_mismatch"] == 1
        assert s["resume_resharded_pieces"] == 0
        assert s["resume_fast_forwarded_pieces"] == 0
        assert PORT.events() == REF.events()

    def test_truncated_complete_manifest_recomputes(self, rng, monkeypatch):
        """A manifest flagged complete whose piece table was truncated is
        not adopted as the whole stage."""
        ldf, rdf = self._frames(rng, n=1200)
        base = _run_both("join", ldf, rdf, 4)
        for p in BOTH:
            man = p.manifest()
            assert man["complete"] and man["n_pieces"] >= 2
            del man["pieces"][str(max(int(k) for k in man["pieces"]))]
            with open(os.path.join(p.stage_dir(), "MANIFEST.json"), "w",
                      encoding="utf-8") as f:
                json.dump(man, f)
        _resume_mode(monkeypatch)
        _bitequal(base, _run_both("join", ldf, rdf, 2))
        s = _stats_equal()
        assert s["resume_resharded_pieces"] == 0
        assert s["resume_world_mismatch"] == 1

    def test_changed_data_never_adopts_across_worlds(self, rng,
                                                     monkeypatch):
        """The base token carries the global row totals: a resume at
        another world over other inputs recomputes."""
        ldf, rdf = self._frames(rng, n=1500)
        _run_both("join", ldf, rdf, 4)
        ldf2, rdf2 = self._frames(rng, n=1100)
        _resume_mode(monkeypatch)
        out = _run_both("join", ldf2, rdf2, 2)
        exp = ldf2.merge(rdf2, on="k").sort_values(["k", "a", "b"])
        np.testing.assert_array_equal(out["b"], exp["b"])
        s = _stats_equal()
        assert s["resume_resharded_pieces"] == 0
        assert s["resume_fast_forwarded_pieces"] == 0

    def test_fresh_run_supersedes_older_generations(self, rng, monkeypatch):
        """Generations stay monotonic across sessions: a fresh run after a
        re-shard rewrite is not outranked by it at the next resume."""
        ldf, rdf = self._frames(rng, n=1200)
        _run_both("join", ldf, rdf, 4)
        _resume_mode(monkeypatch)
        _run_both("join", ldf, rdf, 2)
        for p in BOTH:
            monkeypatch.delenv(p.var("RESUME"))
            p.reset()
        ldf2 = ldf.copy()
        ldf2["a"] = ldf2["a"] + 1000
        base2 = _run_both("join", ldf2, rdf, 2)
        n_pieces = _stats_equal()["checkpoint_events"]
        assert PORT.manifest()["gen"] == REF.manifest()["gen"] == 2
        _resume_mode(monkeypatch)
        _bitequal(base2, _run_both("join", ldf2, rdf, 2))
        s = _stats_equal()
        assert s["resume_fast_forwarded_pieces"] == n_pieces > 0
        assert s["resume_world_mismatch"] == 0

    def test_orphan_rank_dirs_do_not_block_resume(self, rng, monkeypatch):
        """Rank dirs left by an older world do not read as a torn
        checkpoint against a newer run's manifests."""
        ldf, rdf = self._frames(rng, n=1200)
        _run_both("join", ldf, rdf, 4)
        for p in BOTH:
            shutil.copytree(os.path.join(p.root(), "rank0"),
                            os.path.join(p.root(), "rank1"))
            p.reset()
        base = _run_both("join", ldf, rdf, 2)
        n_pieces = _stats_equal()["checkpoint_events"]
        assert n_pieces > 0
        _resume_mode(monkeypatch)
        _bitequal(base, _run_both("join", ldf, rdf, 2))
        s = _stats_equal()
        assert s["resume_fast_forwarded_pieces"] == n_pieces
        assert s["resume_world_mismatch"] == 0

    def test_unrestore_clamps_and_raises(self):
        for p in BOTH:
            p.ckpt._STATS["resume_fast_forwarded_pieces"] = 2
            p.ckpt.unrestore(1)
            assert p.ckpt.stats()["resume_fast_forwarded_pieces"] == 1
            with pytest.raises(p.st.InvalidError):
                p.ckpt.unrestore(5)
            assert p.ckpt.stats()["resume_fast_forwarded_pieces"] == 0
            with pytest.raises(p.st.InvalidError):
                p.ckpt.unrestore(-1)
        _stats_equal()


# ---------------------------------------------------------------------------
# preemption grace
# ---------------------------------------------------------------------------

@pytest.fixture()
def grace(monkeypatch):
    """Arm both packages' grace budgets and install their handlers.  The
    port installs last, so a SIGTERM reaches its handler, which chains to
    the reference's."""
    for p in BOTH:
        monkeypatch.setenv(p.var("PREEMPT_GRACE_S"), "30")
    assert rpre.install() and ppre.install()
    yield
    ppre.reset(uninstall=True)


class TestPreemptGrace:
    def test_sigterm_drains_committed_then_resumes(self, rng, grace,
                                                   monkeypatch):
        """The ``term`` kind sends a real SIGTERM; the loop drains at the
        next piece boundary: the pending partial settles, the manifest
        commits and a ``ResumableAbort`` carries the token.  The resume
        fast-forwards the commits and is bit-equal."""
        ldf, rdf = _frames(rng, n=1800)
        exp = _run_both("sink_run", ldf, rdf, 4, n_chunks=3)
        for p in BOTH:
            p.reset()
            shutil.rmtree(p.root())
        committed = []
        for p in BOTH:
            lt, rt = p.tables(ldf, rdf, 4)
            for q in BOTH:      # one SIGTERM raises both packages' flags
                q.pre.reset()
            p.rec.install_faults("ckpt.write::2=term")
            with pytest.raises(p.st.ResumableAbort) as ei:
                p.sink_run(lt, rt, n_chunks=3)
            assert ei.value.token == os.path.abspath(p.root())
            assert "RESUME=1" in str(ei.value)
            assert p.pre.requested()
            committed.append(p.ckpt.stats()["checkpoint_events"])
            assert os.path.exists(os.path.join(p.root(),
                                               "RESUME_TOKEN.json"))
        assert committed[0] == committed[1] >= 2
        _stats_equal()
        assert PORT.events() == REF.events()
        assert ("pipelined_join", "preempt", "drain") in PORT.events()
        for p in BOTH:
            p.rec.install_faults("")
            p.pre.reset()
        _resume_mode(monkeypatch)
        _bitequal(exp, _run_both("sink_run", ldf, rdf, 4, n_chunks=3))
        assert _stats_equal()["resume_fast_forwarded_pieces"] \
            == committed[1]

    def test_unarmed_checkpoint_means_zero_writes(self, rng, grace,
                                                  monkeypatch, tmp_path):
        """Grace armed, checkpoints unarmed: a real SIGTERM changes
        nothing — the run completes, no file, no drain."""
        for p in BOTH:
            monkeypatch.delenv(p.var("CKPT_DIR"))
        ldf, rdf = _frames(rng, n=800)
        os.kill(os.getpid(), signal.SIGTERM)
        out = _run_both("join", ldf, rdf, 4, n_chunks=3)
        assert len(out) > 0
        assert rpre.requested() and ppre.requested()
        assert PORT.ckpt.stats() == REF.ckpt.stats() == dict.fromkeys(
            ("checkpoint_events", "bytes_checkpointed",
             "resume_fast_forwarded_pieces", "corrupt_pages",
             "resume_resharded_pieces", "resume_world_mismatch"), 0)
        assert not os.listdir(tmp_path)

    def test_grace_unset_means_no_drain(self, rng):
        """Checkpoints armed, no grace budget: a notice drains nothing."""
        for p in BOTH:
            p.pre.request()
        ldf, rdf = _frames(rng, n=800)
        _run_both("join", ldf, rdf, 4, n_chunks=3)
        assert _stats_equal()["checkpoint_events"] >= 2

    def test_grace_knob_and_handler(self, monkeypatch):
        """The knob is read on every call, a bad value raises typed, the
        handler installs once, declines off the main thread and restores
        the previous disposition."""
        import threading
        monkeypatch.delenv("CYLON_TPU_TORCH_PREEMPT_GRACE_S", raising=False)
        assert ppre.grace_seconds() is None and not ppre.install()
        monkeypatch.setenv("CYLON_TPU_TORCH_PREEMPT_GRACE_S", "nope")
        with pytest.raises(pstatus.InvalidError):
            ppre.armed()
        monkeypatch.setenv("CYLON_TPU_TORCH_PREEMPT_GRACE_S", "12.5")
        assert ppre.grace_seconds() == 12.5 and ppre.remaining_s() is None
        box = []
        th = threading.Thread(target=lambda: box.append(ppre.install()))
        th.start()
        th.join(10)
        assert not th.is_alive() and box == [False]
        prev = signal.getsignal(signal.SIGTERM)
        pct.CylonEnv(device="cpu")              # the env installs it
        assert signal.getsignal(signal.SIGTERM) == ppre._on_sigterm
        assert ppre.install()
        ppre.request()
        assert ppre.requested() and 0 < ppre.remaining_s() <= 12.5
        ppre.reset(uninstall=True)
        assert not ppre.requested()
        assert signal.getsignal(signal.SIGTERM) == prev


# ---------------------------------------------------------------------------
# the unarmed path and the final rung
# ---------------------------------------------------------------------------

class TestHappyPathAndFinalRung:
    def test_disabled_means_zero_writes(self, rng, monkeypatch, tmp_path):
        """Unarmed: no stage opens, no file is written, the counters stay
        zero and no checkpoint region or event enters the timing table."""
        for p in BOTH:
            monkeypatch.delenv(p.var("CKPT_DIR"))
        ptiming.reset()
        ldf, rdf = _frames(rng, n=800)
        _run_both("join", ldf, rdf)
        _run_both("sink_run", ldf, rdf)
        assert rckpt._STAGE_SEQ.get(None, 0) == 0
        assert pckpt._STAGE_SEQ.get(None, 0) == 0
        assert not any(v for v in _stats_equal().values())
        assert not os.listdir(tmp_path)
        assert not [k for k in ptiming.counts() if k.startswith("ckpt.")]

    def test_device_oom_abort_becomes_resumable(self, rng):
        """An unrecoverable device OOM with checkpoints armed raises a
        ``ResumableAbort`` carrying the token, the fault on
        ``__cause__``."""
        ldf, _ = _frames(rng, n=1000)
        for p in BOTH:
            t = p.ct.Table.from_pandas(ldf, p.env(4))
            p.rec.install_faults("groupby.device_oom::*=device_oom")
            groupby = r_groupby if p is REF else pct.groupby_aggregate
            with pytest.raises(p.st.ResumableAbort) as ei:
                groupby(t, "k", [("a", "sum")])
            assert ei.value.token == os.path.abspath(p.root())
            assert isinstance(ei.value.__cause__, p.st.DeviceOOMError)
            assert os.path.exists(os.path.join(p.root(),
                                               "RESUME_TOKEN.json"))
        assert PORT.events() == REF.events()
        assert PORT.events()[-1] == ("groupby", "device_oom",
                                     "resumable_abort")

    def test_persistent_oom_after_two_commits_resumes(self, rng,
                                                      monkeypatch):
        """A device OOM at every checkpoint write after the second commit
        exhausts the ladder around a sink run: the final rung raises a
        ``ResumableAbort`` with two pieces committed, and the resume
        fast-forwards them, bit-equal."""
        ldf, rdf = _frames(rng)
        exp = _run_both("sink_run", ldf, rdf)
        for p in BOTH:
            p.reset()
            shutil.rmtree(p.root())
        spec = ",".join(f"ckpt.write::{i}=device_oom" for i in range(3, 12))
        for p in BOTH:
            lt, rt = p.tables(ldf, rdf, 4)
            p.rec.install_faults(spec)

            def attempt(nc=4, p=p, lt=lt, rt=rt):
                return p.sink_run(lt, rt, n_chunks=nc)

            with pytest.raises(p.st.ResumableAbort) as ei:
                p.rec.run_with_recovery(attempt, True, attempt, "sink",
                                        env=p.env(4))
            assert isinstance(ei.value.__cause__, p.st.DeviceOOMError)
        assert PORT.events() == REF.events()
        assert PORT.events()[-1] == ("sink", "device_oom",
                                     "resumable_abort")
        s = _stats_equal()
        assert s["checkpoint_events"] == 2
        for p in BOTH:
            p.rec.install_faults("")
        _resume_mode(monkeypatch)
        _bitequal(exp, _run_both("sink_run", ldf, rdf))
        assert _stats_equal()["resume_fast_forwarded_pieces"] == 2

    def test_without_ckpt_faults_stay_typed(self, monkeypatch):
        """Unarmed, the ladder's typed fault raises as before."""
        for p in BOTH:
            monkeypatch.delenv(p.var("CKPT_DIR"))

            def boom():
                raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

            with pytest.raises(p.st.DeviceOOMError):
                p.rec.run_with_recovery(boom, False, None, "t",
                                        env=p.env(4))

    def test_compiler_crash_branch_waits_for_the_compile_tier(self):
        """The reference's final rung also takes an exhausted compiler
        crash; the port has no compile tier yet, so a foreign error is
        handed back unchanged even with checkpoints armed."""
        def boom():
            raise RuntimeError("tpu_compile_helper subprocess exit "
                               "signal SIGSEGV (11)")

        with pytest.raises(rstatus.ResumableAbort):
            rrec.run_with_recovery(boom, False, None, "t", env=REF.env(4))
        with pytest.raises(RuntimeError, match="SIGSEGV"):
            prec.run_with_recovery(boom, False, None, "t", env=PORT.env(4))


# ---------------------------------------------------------------------------
# a real kill of a port process, then its resume
# ---------------------------------------------------------------------------

_CHILD = """
import sys
import numpy as np
import cylon_tpu_torch as ct
d = np.load(sys.argv[1])
env = ct.CylonEnv(ct.VirtualMeshConfig(4), device="cpu")
lt = ct.Table.from_pydict({"k": d["lk"], "a": d["a"]}, env)
rt = ct.Table.from_pydict({"k": d["rk"], "b": d["b"]}, env)
sink = ct.GroupBySink("k", [("a", "sum"), ("b", "sum")])
ct.pipelined_join(lt, rt, "k", "k", n_chunks=4, sink=sink)
g = sink.finalize().to_pydict()
np.savez(sys.argv[2], **g)
"""


def test_kill_child_then_resume(rng, tmp_path):
    """A port child process SIGKILLed at its third ``ckpt.write`` (two
    pieces committed) leaves a manifest of exactly those pieces; a fresh
    child with the resume switch fast-forwards them and its result is
    bit-equal to the reference's uninterrupted run."""
    ldf, rdf = _frames(rng, n=4000, card=400)
    exp = REF.sink_run(*REF.tables(ldf, rdf, 4))
    src = tmp_path / "tables.npz"
    np.savez(src, lk=ldf["k"].to_numpy(), a=ldf["a"].to_numpy(),
             rk=rdf["k"].to_numpy(), b=rdf["b"].to_numpy())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CYLON_TPU_TORCH_")}
    env["CYLON_TPU_TORCH_CKPT_DIR"] = PORT.root()
    env["PYTHONPATH"] = REPO
    out = tmp_path / "out.npz"

    def child(**extra):
        return subprocess.run(
            [sys.executable, "-c", _CHILD, str(src), str(out)],
            env={**env, **extra}, capture_output=True, text=True,
            timeout=300, cwd=str(tmp_path))

    p = child(CYLON_TPU_TORCH_FAULTS="ckpt.write::3=kill")
    assert p.returncode == -signal.SIGKILL, p.stderr[-2000:]
    assert not out.exists()
    man = PORT.manifest()
    assert sorted(man["pieces"], key=int) == ["0", "1"]
    assert not man["complete"]
    p = child(CYLON_TPU_TORCH_RESUME="1")
    assert p.returncode == 0, p.stderr[-2000:]
    with np.load(out) as g:
        got = pd.DataFrame({c: g[c] for c in ("k", "a_sum", "b_sum")})
    _bitequal(exp, got.sort_values("k").reset_index(drop=True))
    man = PORT.manifest()
    assert man["complete"] and sorted(man["pieces"], key=int) \
        == ["0", "1", "2", "3"]
