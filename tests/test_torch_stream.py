"""Streaming ingest of cylon_tpu_torch (``stream/``: ``StreamTable``,
``IncrementalView``, ``TumblingWindowJoin``) against cylon_tpu's on the
CPU, mirroring the in-process cases of tests/test_stream.py.

Every scenario runs in both packages on the same numpy-seeded batches:
the reference on its CPU mesh (``CPUMeshConfig(4)``, ``LocalConfig()``
at W = 1), the port on ``VirtualMeshConfig(W)`` with ``device="cpu"``.
Held equal, with no float tolerance (the batches' payloads are integers
or integer-valued float64, so every partial sum is exact): ``view.read()``
after every batch (sorted by key, bit for bit) and against each package's
own from-scratch groupby over every row seen; the closed windows' ids and
sorted rows; the ``stats()`` dicts; ``window_evictions`` and the
drained ledger; the typed errors at ``stream.append``,
``stream.watermark`` and on bad arguments; a resume's ``fast_forwarded``,
the W = 4 → W = 2 prefix adoption and its corrupt-tail trim.  Not
mirrored: the bench smoke and the chaos soak (slow-marked in the
reference; the port has no streaming bench script yet).
"""

import gc
import os

import jax
import numpy as np
import pytest

import cylon_tpu as rct
from cylon_tpu import status as rstatus
from cylon_tpu.ctx.context import CPUMeshConfig
from cylon_tpu.exec import checkpoint as rckpt
from cylon_tpu.exec import memory as rmem
from cylon_tpu.exec import recovery as rrec
from cylon_tpu.relational.groupby import groupby_aggregate as r_groupby
import cylon_tpu.stream as rstream
import cylon_tpu_torch as pct
from cylon_tpu_torch import status as pstatus
from cylon_tpu_torch.exec import checkpoint as pckpt
from cylon_tpu_torch.exec import memory as pmem
from cylon_tpu_torch.exec import recovery as prec
import cylon_tpu_torch.stream as pstream

ALL_AGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
            ("v", "mean"), ("v", "var"), ("v", "std"), ("q", "sum"),
            ("q", "mean")]


class Pkg:
    """One package's handles, so a scenario is written once."""

    def __init__(self, name, ct, stream, mem, rec, ckpt, status, groupby,
                 prefix):
        self.name, self.ct, self.stream, self.mem = name, ct, stream, mem
        self.rec, self.ckpt, self.status = rec, ckpt, status
        self.groupby, self.prefix = groupby, prefix
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

    def table(self, cols: dict, w: int):
        return self.ct.Table.from_pydict(dict(cols), self.env(w))

    def reset(self):
        self.ckpt.reset_stages()
        self.ckpt.reset_stats()


REF = Pkg("ref", rct, rstream, rmem, rrec, rckpt, rstatus, r_groupby,
          "CYLON_TPU_")
PORT = Pkg("port", pct, pstream, pmem, prec, pckpt, pstatus,
           pct.groupby_aggregate, "CYLON_TPU_TORCH_")
BOTH = (REF, PORT)


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Release the reference's compiled XLA:CPU programs at module end."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for p in BOTH:
        monkeypatch.delenv(p.var("CKPT_DIR"), raising=False)
        monkeypatch.delenv(p.var("RESUME"), raising=False)
        p.rec.install_faults("")
        p.rec.reset_events()
        p.mem.reset_stats()
        p.reset()
    yield
    for p in BOTH:
        p.rec.install_faults("")
        p.rec.reset_events()
        p.reset()


def _batch(rng, n=200, keys=16):
    """Integer-valued payloads: every partial sum is exact."""
    return {"k": rng.integers(0, keys, n).astype(np.int64),
            "v": rng.integers(-500, 500, n).astype(np.float64),
            "q": rng.integers(1, 51, n).astype(np.int64)}


def _wbatch(rng, t_lo, t_hi, n=120, keys=16):
    return {"k": rng.integers(0, keys, n).astype(np.int64),
            "t": rng.integers(t_lo, t_hi, n).astype(np.int64),
            "v": rng.integers(0, 100, n).astype(np.int64)}


def rows(table, keys=None) -> dict:
    """A table's live rows as host arrays, sorted by ``keys`` (default:
    every column, first to last)."""
    d = table.to_pydict() if isinstance(table, pct.Table) \
        else {c: table.to_pandas()[c].to_numpy() for c in
              table.column_names}
    d = {k: np.asarray(v) for k, v in d.items()}
    keys = list(d) if keys is None else list(keys)
    order = np.lexsort([d[k] for k in reversed(keys)])
    return {k: v[order] for k, v in d.items()}


def bits_equal(a: dict, b: dict, label: str = "") -> None:
    """The same columns in the same order, each equal bit for bit (NaN
    as NaN, whatever its payload)."""
    assert list(a) == list(b), label
    for c in a:
        x, y = a[c], b[c]
        assert x.dtype == y.dtype, (label, c, x.dtype, y.dtype)
        if x.dtype.kind == "f":
            assert np.array_equal(np.isnan(x), np.isnan(y)), (label, c)
            x, y = x[~np.isnan(x)], y[~np.isnan(y)]
            assert x.tobytes() == y.tobytes(), (label, c)
        else:
            assert np.array_equal(x, y), (label, c)


def _dims(p, w, keys=16):
    return p.table({"k": np.arange(keys, dtype=np.int64),
                    "dim": np.arange(keys, dtype=np.int64) * 3 + 1}, w)


def _wj(p, w, **kw):
    args = dict(key="k", time_col="t", window=100, build=_dims(p, w),
                build_on="k")
    args.update(kw)
    return p.stream.TumblingWindowJoin(p.env(w), **args)


def _closed(wj) -> dict:
    return {int(wid): rows(out, ["k", "t", "v"]) for wid, out in wj.closed}


# ---------------------------------------------------------------------------
# IncrementalView
# ---------------------------------------------------------------------------

class TestIncrementalView:
    @pytest.mark.parametrize("w", [1, 4])
    def test_bit_equal_every_batch(self, w):
        """After every batch ``read()`` equals the package's from-scratch
        groupby over every row seen, and the port's equals the
        reference's, bit for bit (every aggregation, var/std too)."""
        seen, views, streams = [], {}, {}
        for p in BOTH:
            streams[p.name] = p.stream.StreamTable(p.env(w), key="k",
                                                   name="t0")
            views[p.name] = p.stream.IncrementalView(
                streams[p.name], "k", ALL_AGGS, name="v0", env=p.env(w))
        rng = np.random.default_rng(0)
        for i in range(3):
            b = _batch(rng)
            seen.append(b)
            full = {c: np.concatenate([bb[c] for bb in seen])
                    for c in ("k", "v", "q")}
            got = {}
            for p in BOTH:
                streams[p.name].append(dict(b))
                got[p.name] = rows(views[p.name].read(), ["k"])
                exp = rows(p.groupby(p.table(full, w), "k", ALL_AGGS),
                           ["k"])
                bits_equal(got[p.name], exp, f"{p.name} batch {i}")
            bits_equal(got["port"], got["ref"], f"batch {i}")
        assert views["port"].stats() == views["ref"].stats()
        assert streams["port"].stats() == streams["ref"].stats()

    def test_read_is_nondestructive(self):
        for p in BOTH:
            rng = np.random.default_rng(1)
            st = p.stream.StreamTable(p.env(4), key="k", name="t1")
            view = p.stream.IncrementalView(st, "k", [("v", "sum")],
                                            name="v1", env=p.env(4))
            st.append(_batch(rng))
            bits_equal(rows(view.read(), ["k"]), rows(view.read(), ["k"]))
            n_parts = len(view.sink._parts)
            st.append(_batch(rng))
            assert len(view.sink._parts) == n_parts + 1

    @pytest.mark.parametrize("w", [1, 4])
    def test_compaction_preserves_bit_equality(self, w):
        """``compact_every=2`` folds the partials; the folded snapshot
        equals the batch recompute and the reference's, bit for bit."""
        got = {}
        for p in BOTH:
            rng = np.random.default_rng(11)
            st = p.stream.StreamTable(p.env(w), key="k", name="tc")
            view = p.stream.IncrementalView(st, "k", ALL_AGGS, name="vc",
                                            env=p.env(w), compact_every=2)
            seen = []
            for _ in range(5):
                b = _batch(rng)
                seen.append(b)
                st.append(dict(b))
            assert len(view.sink._parts) <= 2
            full = {c: np.concatenate([bb[c] for bb in seen])
                    for c in ("k", "v", "q")}
            got[p.name] = rows(view.read(), ["k"])
            bits_equal(got[p.name], rows(p.groupby(p.table(full, w), "k",
                                                   ALL_AGGS), ["k"]))
            got[p.name + "_stats"] = view.stats()
        bits_equal(got["port"], got["ref"])
        assert got["port_stats"] == got["ref_stats"]

    def test_stream_release_drains_ledger(self):
        for p in BOTH:
            rng = np.random.default_rng(2)
            st = p.stream.StreamTable(p.env(4), key="k", name="t2")
            before = p.mem.balance()
            st.append(_batch(rng))
            assert p.mem.balance() > before
            st.release()
            assert p.mem.balance() <= before
            assert st.stats()["valid_counts"] == []

    def test_empty_stream_raises(self):
        for p in BOTH:
            st = p.stream.StreamTable(p.env(4), key="k", name="t3")
            with pytest.raises(p.status.InvalidError):
                st.snapshot()


# ---------------------------------------------------------------------------
# TumblingWindowJoin
# ---------------------------------------------------------------------------

class TestWindowedJoin:
    @pytest.mark.parametrize("w", [1, 4])
    def test_close_matches_reference_and_evicts(self, w):
        """The closed windows' ids and sorted rows equal the reference's
        and a numpy recompute; each close evicts (device → host) then
        releases, and the buffers' bytes drain."""
        out = {}
        for p in BOTH:
            p.mem.reset_stats()
            rng = np.random.default_rng(3)
            wj = _wj(p, w, lateness=0)
            batches = []
            for i in range(3):
                b = _wbatch(rng, i * 100, (i + 1) * 100)
                batches.append(b)
                wj.append(b)
            held = p.mem.balance()
            assert wj.watermark() == 2
            st = p.mem.stats()
            assert st["window_evictions"] == 2
            assert st["spill_events"] >= 2
            result_bytes = sum(r.nbytes for r in wj._closed_regs)
            assert result_bytes > 0
            assert p.mem.balance() - result_bytes < held
            out[p.name] = (_closed(wj), wj.stats(), st["window_evictions"])
        rclosed, rstats, rev = out["ref"]
        pclosed, pstats, pev = out["port"]
        assert sorted(pclosed) == sorted(rclosed) == [0, 1]
        for wid in rclosed:
            bits_equal(pclosed[wid], rclosed[wid], f"window {wid}")
        assert pstats == rstats and pev == rev
        # against numpy: every row of the window, with dim = 3k + 1
        t = np.concatenate([b["t"] for b in batches])
        for wid, got in pclosed.items():
            sel = (t >= wid * 100) & (t < (wid + 1) * 100)
            assert len(got["k"]) == int(sel.sum())
            assert np.array_equal(got["dim"], got["k"] * 3 + 1)

    def test_out_of_order_rows_land_in_correct_window(self):
        t = np.asarray([150, 20, 199, 0, 99, 100], np.int64)
        b = {"k": np.arange(6, dtype=np.int64) % 16, "t": t,
             "v": np.arange(6, dtype=np.int64)}
        got = {}
        for p in BOTH:
            rng = np.random.default_rng(4)
            wj = _wj(p, 4)
            wj.append(dict(b))
            wj.append(_wbatch(rng, 200, 300, n=40))
            wj.watermark()
            got[p.name] = _closed(wj)
            assert sorted(got[p.name][0]["t"].tolist()) == [0, 20, 99]
            assert sorted(got[p.name][1]["t"].tolist()) == [100, 150, 199]
        for wid in got["ref"]:
            bits_equal(got["port"][wid], got["ref"][wid])

    @pytest.mark.parametrize("policy", ["drop", "clamp"])
    def test_late_policy(self, policy):
        """``drop`` counts and discards the late rows; ``clamp`` lands
        them in the oldest open window, which closes with them."""
        res = {}
        for p in BOTH:
            rng = np.random.default_rng(5 if policy == "drop" else 6)
            wj = _wj(p, 4, late_policy=policy)
            wj.append(_wbatch(rng, 0, 100, n=50))
            wj.append(_wbatch(rng, 210, 260, n=50))
            wj.watermark()
            assert wj.windows_closed >= 1
            closed_through = wj._closed_through
            before = wj.rows_buffered
            wj.append({"k": np.zeros(5, np.int64),
                       "t": np.full(5, 10, np.int64),
                       "v": np.zeros(5, np.int64)})
            if policy == "drop":
                assert wj.late_dropped == 5 and wj.rows_buffered == before
            else:
                assert wj.late_clamped == 5 and closed_through in wj._open
            wj.append(_wbatch(rng, 300, 360, n=40))
            wj.watermark()
            if policy == "clamp":
                by_wid = dict(wj.closed)
                ts = rows(by_wid[closed_through])["t"].tolist()
                assert ts.count(10) == 5
            res[p.name] = (_closed(wj), wj.stats())
        assert res["port"][1] == res["ref"][1]
        assert sorted(res["port"][0]) == sorted(res["ref"][0])
        for wid in res["ref"][0]:
            bits_equal(res["port"][0][wid], res["ref"][0][wid])

    def test_open_window_spill_roundtrip(self):
        """An open window evicted under pressure comes back bit-exact at
        its close (the same rows as the reference's)."""
        got = {}
        for p in BOTH:
            p.mem.reset_stats()
            rng = np.random.default_rng(7)
            wj = _wj(p, 4)
            wj.append(_wbatch(rng, 0, 100, n=80))
            for buf in wj._open[0]:
                assert p.mem.evict(buf.reg) > 0
                assert buf.reg.spilled
            wj.append(_wbatch(rng, 150, 220, n=40))
            wj.watermark()
            assert p.mem.stats()["readmit_events"] >= 1
            got[p.name] = _closed(wj)
        assert sorted(got["port"]) == sorted(got["ref"])
        for wid in got["ref"]:
            bits_equal(got["port"][wid], got["ref"][wid])

    def test_epoch_scale_timestamps_fit_the_wire(self):
        t0 = 1_700_000_000
        res = {}
        for p in BOTH:
            wj = _wj(p, 4, window=60)
            wj.append({"k": np.zeros(4, np.int64),
                       "t": np.asarray([t0, t0 + 10, t0 + 30, t0 + 50],
                                       np.int64),
                       "v": np.arange(4, dtype=np.int64)})
            wj.append({"k": np.ones(2, np.int64),
                       "t": np.asarray([t0 + 120, t0 + 130], np.int64),
                       "v": np.zeros(2, np.int64)})
            agreed = wj.watermark()
            assert agreed == (t0 + 130) // 60
            res[p.name] = (agreed, _closed(wj), wj.stats())
        assert res["port"][0] == res["ref"][0]
        assert res["port"][2] == res["ref"][2]
        assert sorted(res["port"][1]) == sorted(res["ref"][1]) \
            == sorted({t0 // 60, (t0 + 50) // 60})
        for wid in res["ref"][1]:
            bits_equal(res["port"][1][wid], res["ref"][1][wid])

    def test_wire_saturation_votes_in_rounds(self, monkeypatch):
        """A jump wider than the vote's 2^20 − 1 clamp votes in rounds,
        the same number in both packages."""
        t0 = 3 * (1 << 20) * 60 + 7
        votes = {}
        for p in BOTH:
            calls = []
            real = p.rec.watermark_consensus

            def vote(mesh, n, real=real, calls=calls):
                calls.append(int(n))
                return real(mesh, n)
            monkeypatch.setattr(p.rec, "watermark_consensus", vote)
            wj = _wj(p, 4, window=60)
            wj.append({"k": np.zeros(2, np.int64),
                       "t": np.asarray([t0, t0 + 200], np.int64),
                       "v": np.zeros(2, np.int64)})
            votes[p.name] = (wj.watermark(), calls, wj.windows_closed)
        assert votes["port"] == votes["ref"]
        assert len(votes["port"][1]) == 4

    def test_pre_origin_events_raise(self):
        for p in BOTH:
            wj = _wj(p, 4, origin=1000)
            with pytest.raises(p.status.InvalidError):
                wj.append({"k": np.zeros(3, np.int64),
                           "t": np.asarray([999, 1100, 1200], np.int64),
                           "v": np.zeros(3, np.int64)})

    def test_pop_closed_drains_results_and_ledger(self):
        for p in BOTH:
            rng = np.random.default_rng(12)
            wj = _wj(p, 4)
            wj.append(_wbatch(rng, 0, 100, n=60))
            wj.append(_wbatch(rng, 150, 220, n=40))
            wj.watermark()
            assert wj.closed and wj._closed_regs
            held = p.mem.balance()
            popped = wj.pop_closed()
            assert len(popped) >= 1 and wj.closed == []
            del popped
            gc.collect()
            assert p.mem.balance() < held

    def test_release_retires_open_windows(self):
        """The port's ``release`` hands off the closed results and
        retires the windows still open: the ledger drains back to where
        the join started, with as many window evictions as the reference
        counts when its open buffers are retired one by one."""
        got = {}
        for p in BOTH:
            rng = np.random.default_rng(13)
            wj = _wj(p, 4)
            p.mem.reset_stats()
            before = p.mem.balance()
            wj.append(_wbatch(rng, 0, 100, n=60))
            wj.append(_wbatch(rng, 150, 320, n=80))
            wj.watermark()
            n_open = sum(len(v) for v in wj._open.values())
            assert wj.closed and n_open
            if p is PORT:
                assert wj.release() > 0
                assert wj.stats()["open_windows"] == 0 and not wj.closed
            else:
                wj.pop_closed()
                for bufs in wj._open.values():
                    for b in bufs:
                        p.mem.evict_release(b.reg)
                wj._open.clear()
            gc.collect()
            assert p.mem.balance() == before
            got[p.name] = (n_open, wj.windows_closed,
                           p.mem.stats()["window_evictions"])
        assert got["port"] == got["ref"]

    def test_bad_late_policy_and_window(self):
        for p in BOTH:
            with pytest.raises(p.status.InvalidError):
                _wj(p, 4, late_policy="nope")
            with pytest.raises(p.status.InvalidError):
                _wj(p, 4, window=0)

    def test_emit_callback_and_set_build(self):
        """``emit`` sees every close; a window closed after
        ``set_build`` joins the new build side (as-of the close)."""
        res = {}
        for p in BOTH:
            seen = []
            rng = np.random.default_rng(14)
            wj = _wj(p, 4, emit=lambda wid, out, seen=seen: seen.append(
                (wid, out.row_count)))
            wj.append(_wbatch(rng, 0, 100, n=40))
            wj.append(_wbatch(rng, 100, 150, n=40))
            wj.watermark()       # window 0 ripe only
            wj.set_build(p.table({"k": np.arange(8, dtype=np.int64),
                                  "dim": np.arange(8, dtype=np.int64)},
                                 4))
            wj.append(_wbatch(rng, 200, 300, n=40))
            wj.watermark()       # window 1 joins the 8-key build
            res[p.name] = (seen, _closed(wj))
        assert res["port"][0] == res["ref"][0]
        for wid in res["ref"][1]:
            bits_equal(res["port"][1][wid], res["ref"][1][wid])


# ---------------------------------------------------------------------------
# injection sites
# ---------------------------------------------------------------------------

class TestStreamInjection:
    def test_append_site_raises_typed(self):
        for p in BOTH:
            st = p.stream.StreamTable(p.env(4), key="k", name="inj")
            p.rec.install_faults("stream.append::1=predicted")
            with pytest.raises(p.status.PredictedResourceExhausted):
                st.append(_batch(np.random.default_rng(8)))
            evs = p.rec.recovery_events()
            assert evs and evs[0]["site"] == "stream.append"
        assert [(e["site"], e["kind"], e["action"])
                for e in PORT.rec.recovery_events()] \
            == [(e["site"], e["kind"], e["action"])
                for e in REF.rec.recovery_events()]

    def test_watermark_site_raises_typed(self):
        for p in BOTH:
            wj = _wj(p, 4)
            p.rec.install_faults("stream.watermark::1=desync")
            with pytest.raises(p.status.RankDesyncError):
                wj.watermark()

    def test_window_append_site_raises_typed(self):
        for p in BOTH:
            wj = _wj(p, 4)
            p.rec.install_faults("stream.append::1=capacity")
            with pytest.raises(p.status.CapacityOverflowError):
                wj.append(_wbatch(np.random.default_rng(9), 0, 100))
            assert wj.rows_buffered == 0


# ---------------------------------------------------------------------------
# checkpoints: resume, the re-shard and its corrupt-tail trim
# ---------------------------------------------------------------------------

def _arm(monkeypatch, tmp_path):
    for p in BOTH:
        monkeypatch.setenv(p.var("CKPT_DIR"), str(tmp_path / p.name))
        p.reset()


def _resume(monkeypatch):
    for p in BOTH:
        monkeypatch.setenv(p.var("RESUME"), "1")
        p.reset()


def _run_stream(p, w, name, aggs, seed, batches):
    rng = np.random.default_rng(seed)
    st = p.stream.StreamTable(p.env(w), key="k", name=name)
    view = p.stream.IncrementalView(st, "k", aggs, name=f"{name}_view",
                                    env=p.env(w))
    for _ in range(batches):
        st.append(_batch(rng))
    return view, rows(view.read(), ["k"])


def _ckpt_stats_equal():
    rs, ps = REF.ckpt.stats(), PORT.ckpt.stats()
    assert (ps.pop("bytes_checkpointed") > 0) \
        == (rs.pop("bytes_checkpointed") > 0)
    assert ps == rs
    return PORT.ckpt.stats()


class TestViewCheckpointResume:
    def test_in_process_resume_fast_forwards(self, tmp_path, monkeypatch):
        _arm(monkeypatch, tmp_path)
        aggs = [("v", "sum"), ("v", "var")]
        base = {p.name: _run_stream(p, 4, "ckpt", aggs, 9, 3)[1]
                for p in BOTH}
        bits_equal(base["port"], base["ref"])
        assert _ckpt_stats_equal()["checkpoint_events"] == 3
        _resume(monkeypatch)
        for p in BOTH:
            view, again = _run_stream(p, 4, "ckpt", aggs, 9, 3)
            assert view.fast_forwarded == 3
            assert len(view.sink._parts) == 3
            bits_equal(again, base[p.name])
        assert _ckpt_stats_equal()["resume_fast_forwarded_pieces"] == 3

    def test_world_change_reshards_committed_prefix(self, tmp_path,
                                                    monkeypatch):
        """W = 4 → W = 2: the committed prefix is adopted, re-sharded and
        committed again, so a third run at W = 2 is a plain fast-forward;
        every read bit-equal to the uninterrupted run."""
        _arm(monkeypatch, tmp_path)
        aggs = [("v", "sum"), ("q", "mean")]
        base = {p.name: _run_stream(p, 4, "el", aggs, 9, 4)[1]
                for p in BOTH}
        bits_equal(base["port"], base["ref"])
        assert _ckpt_stats_equal()["checkpoint_events"] == 4
        _resume(monkeypatch)
        for p in BOTH:
            view, again = _run_stream(p, 2, "el", aggs, 9, 4)
            assert view.fast_forwarded == 4
            bits_equal(again, base[p.name])
        s = _ckpt_stats_equal()
        assert s["resume_resharded_pieces"] == 4
        assert s["resume_world_mismatch"] == 1
        for p in BOTH:
            p.reset()
        for p in BOTH:
            view, third = _run_stream(p, 2, "el", aggs, 9, 4)
            assert view.fast_forwarded == 4
            bits_equal(third, base[p.name])
        assert _ckpt_stats_equal()["resume_resharded_pieces"] == 0

    def test_world_change_corrupt_tail_trims_prefix(self, tmp_path,
                                                    monkeypatch):
        """One flipped byte in the last committed batch's page costs one
        batch: the adoption trims to the verified prefix (a
        ``prefix_trim`` event) in both packages."""
        _arm(monkeypatch, tmp_path)
        base = {p.name: _run_stream(p, 4, "trim", [("v", "sum")], 13, 4)[1]
                for p in BOTH}
        for p in BOTH:
            rank0 = tmp_path / p.name / "rank0"
            stage = next(d for d in os.listdir(rank0) if "trim_view" in d)
            page = rank0 / stage / "piece_3.p0"
            raw = bytearray(page.read_bytes())
            raw[len(raw) // 2] ^= 0xFF
            page.write_bytes(bytes(raw))
        _resume(monkeypatch)
        for p in BOTH:
            view, again = _run_stream(p, 2, "trim", [("v", "sum")], 13, 4)
            assert view.fast_forwarded == 3
            bits_equal(again, base[p.name])
            assert any(e["action"] == "prefix_trim"
                       for e in p.rec.recovery_events())
        s = _ckpt_stats_equal()
        assert s["resume_resharded_pieces"] == 3
        assert s["corrupt_pages"] >= 1
        assert [(e["site"], e["kind"], e["action"])
                for e in PORT.rec.recovery_events()] \
            == [(e["site"], e["kind"], e["action"])
                for e in REF.rec.recovery_events()]

    def test_no_ckpt_no_writes(self, tmp_path):
        for p in BOTH:
            st = p.stream.StreamTable(p.env(4), key="k", name="nockpt")
            view = p.stream.IncrementalView(st, "k", [("v", "sum")],
                                            name="nockpt_view",
                                            env=p.env(4))
            st.append(_batch(np.random.default_rng(10)))
            view.read()
            assert view.sink._ckpt is None
        assert list(tmp_path.iterdir()) == []


def test_exports_and_default_names():
    """The package exports the three classes; the default view names
    count up from one class counter in both packages."""
    assert pct.stream.__all__ == ["IncrementalView", "StreamTable",
                                  "TumblingWindowJoin"]
    names = {}
    for p in BOTH:
        st = p.stream.StreamTable(p.env(1), key="k")
        n0 = p.stream.IncrementalView._SEQ[0]
        a = p.stream.IncrementalView(st, "k", [("v", "sum")])
        b = p.stream.IncrementalView(st, "k", [("v", "sum")])
        names[p.name] = (a.name, b.name, n0)
        assert a.name == f"view{n0}" and b.name == f"view{n0 + 1}"
        assert st.stats()["name"] == "stream" and repr(st)


def test_stream_session_windows_survive_cross_tenant_eviction(monkeypatch):
    """A ``kind="stream"`` session beside a pipelined-join tenant under a
    4 KiB ledger budget: the other tenant's admissions evict the stream's
    open windows (cross-session evictions), which come back bit-exact at
    their close; the windows and the view equal a solo run's, and the
    scheduler counts one stream session."""
    from cylon_tpu_torch import config as pconfig
    from cylon_tpu_torch.exec.scheduler import QueryScheduler
    env = PORT.env(4)

    def stream(p):
        rng = np.random.default_rng(21)
        st = p.stream.StreamTable(p.env(4), key="k", name="sess")
        view = p.stream.IncrementalView(st, "k", [("v", "sum")],
                                        name="sess_view", env=p.env(4))
        wj = _wj(p, 4, lateness=10)

        def ingest():
            for i in range(4):
                b = _wbatch(rng, i * 60, i * 60 + 60, n=200)
                st.append({"k": b["k"], "v": b["v"]})
                wj.append(b)
                wj.watermark()
            wj.watermark()
            return True
        return ingest, view, wj

    ingest, view, wj = stream(REF)
    ingest()
    solo = (_closed(wj), rows(view.read(), ["k"]))
    rng = np.random.default_rng(22)
    lt = PORT.table({"k": rng.integers(0, 64, 600).astype(np.int64),
                     "a": rng.integers(0, 9, 600).astype(np.int64)}, 4)
    rt = PORT.table({"k": rng.integers(0, 64, 600).astype(np.int64),
                     "b": rng.integers(0, 9, 600).astype(np.int64)}, 4)

    def tenant():
        for _ in range(2):
            sink = pct.GroupBySink("k", [("a", "sum")])
            pct.pipelined_join(lt, rt, "k", "k", n_chunks=3, sink=sink)
            sink.finalize()
        return True

    ingest, view, wj = stream(PORT)
    monkeypatch.setattr(pconfig, "HBM_BUDGET_BYTES", 4096)
    sched = QueryScheduler(env, policy="fair")
    sched.submit("ingest", ingest, kind="stream")
    sched.submit("join", tenant)
    sched.run(raise_errors=True)
    st = PORT.mem.stats()
    assert sched.stats()["stream_sessions"] == 1
    assert st["cross_session_evictions"] >= 1 and st["readmit_events"] >= 1
    got = _closed(wj)
    assert sorted(got) == sorted(solo[0])
    for wid in got:
        bits_equal(got[wid], solo[0][wid], f"window {wid}")
    bits_equal(rows(view.read(), ["k"]), solo[1])
