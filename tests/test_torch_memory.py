"""The ledger, the host spill tier and the disk tier of cylon_tpu_torch
(``exec/memory.py``) against cylon_tpu's (``cylon_tpu/exec/memory.py``),
mirroring the classes of tests/test_memory.py.

The same tables (numpy draws from one seed) and the same budgets go
through both packages at W = 4 (the reference's ``env4`` CPU mesh, the
port's ``VirtualMeshConfig(4)`` on the CPU).  Held equal: the eviction
and demotion logs owner by owner (each spillable owner named by its
order of registration), the recovery events, and the results —
integers bit-equal, layout included.  Spilled runs are also held
bit-equal to the port's unspilled runs, and disk pages round-trip
bit-exact, with torn or corrupt pages raising the typed errors."""

import gc
import glob
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as rct
from cylon_tpu import config as rconfig
from cylon_tpu.exec import GroupBySink as RSink
from cylon_tpu.exec import memory as rmem
from cylon_tpu.exec import pipelined_join as r_pipe
from cylon_tpu.exec import recovery as rrec
from cylon_tpu.relational import join_tables as r_join
from cylon_tpu.relational.piece import PieceSource as RSource
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch.exec import memory as pmem
from cylon_tpu_torch.exec import recovery as prec
from cylon_tpu_torch.relational.piece import PieceSource as PSource
from cylon_tpu_torch import status as pstatus
from cylon_tpu_torch.status import (CheckpointCorruptError, DeviceOOMError,
                                    RankDesyncError)

W = 4


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Release the reference's compiled XLA:CPU programs at module end, so
    a worker running later files does not accumulate them."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean():
    """Both injectors disarmed, both ledgers' stats zeroed and no leftover
    registrations (a leftover spillable source would give a ladder a
    spill rung of its own)."""
    for rec, mem in ((rrec, rmem), (prec, pmem)):
        rec.install_faults("")
        rec.reset_events()
        mem.reset_stats()
    gc.collect()
    yield
    for rec, mem in ((rrec, rmem), (prec, pmem)):
        rec.install_faults("")
        rec.reset_events()
    gc.collect()
    rmem.reset_stats()
    pmem.reset_stats()


@pytest.fixture()
def penv4():
    return pct.CylonEnv(pct.VirtualMeshConfig(W), device="cpu")


@pytest.fixture()
def both_budgets(monkeypatch):
    """Set one device budget (and host budget) in both packages."""
    def set_(hbm=None, host=None):
        for cfg in (rconfig, pconfig):
            if hbm is not None:
                monkeypatch.setattr(cfg, "HBM_BUDGET_BYTES", hbm)
            if host is not None:
                monkeypatch.setattr(cfg, "HOST_BUDGET_BYTES", host)
    return set_


class Owners:
    """Names spillable owners by their order of registration in the
    block (``spill#0``, ``spill#1``, ...), so that the two packages' logs
    compare owner by owner: the two ledgers also hold bookkeeping entries
    that are never evicted (the reference's exchange receive buffers,
    which the port does not register)."""

    def __init__(self, mem, monkeypatch):
        self.order = {}
        led = mem.ledger()
        register = led.register

        def spy(base, arrays, spillable=False, **kw):
            reg = register(base, arrays, spillable=spillable, **kw)
            if spillable:
                self.order[reg.owner] = len(self.order)
            return reg

        monkeypatch.setattr(led, "register", spy)

    def __call__(self, names):
        return [f"{n.split('#')[0]}#{self.order[n]}" for n in names]


def _frames(rng, n=4000):
    """tests/test_memory.py's tables."""
    ldf = pd.DataFrame({"k": rng.integers(0, 500, n).astype(np.int64),
                        "a": rng.integers(0, 50, n).astype(np.int64)})
    rdf = pd.DataFrame({"k": rng.integers(0, 500, n).astype(np.int64),
                        "b": rng.integers(0, 50, n).astype(np.int64)})
    return ldf, rdf


def _mixed_frame(rng, n=400):
    """Every lane class in one table (tests/test_memory.py's
    ``_mixed_lane_table``): wide and narrow int64, int32, float32, an f64
    side column with a NaN, bool, dictionary strings, nullable int64."""
    f64 = rng.random(n)
    f64[0] = np.nan
    return pd.DataFrame({
        "i64w": rng.integers(0, 2**40, n).astype(np.int64),
        "i64n": rng.integers(0, 100, n).astype(np.int64),
        "i32": rng.integers(0, 100, n).astype(np.int32),
        "f32": rng.random(n).astype(np.float32),
        "f64": f64,
        "b": rng.random(n) < 0.5,
        "s": pd.Series(rng.choice(["aa", "bb", "cc"], n)),
        "ni": pd.array(np.where(rng.random(n) < 0.1, None,
                                rng.integers(0, 50, n)), dtype="Int64"),
    })


def _host(table):
    """{name: (data bytes, validity | None)}: the bit-exact surface."""
    out = {}
    for name, (data, valid) in table.host_columns().items():
        out[name] = (np.asarray(data).tobytes(),
                     None if valid is None else np.asarray(valid, bool))
    return out


def _same_host(a, b):
    assert list(a) == list(b)
    for name in a:
        assert a[name][0] == b[name][0], f"{name} data bytes differ"
        assert (a[name][1] is None) == (b[name][1] is None), name
        if a[name][1] is not None:
            np.testing.assert_array_equal(a[name][1], b[name][1], name)


def _sorted_rows(table, cols):
    """A join's rows as sorted host arrays (join_tables' row order is its
    own; the tests compare the multiset)."""
    h = table.host_columns()
    arrs = [np.asarray(h[c][0]) for c in cols]
    order = np.lexsort(arrs[::-1])
    return [a[order] for a in arrs]


def _same_rows(ref, port):
    """Same columns, per-shard counts and every live row of every shard,
    bit for bit (validity included)."""
    assert port.column_names == ref.column_names
    np.testing.assert_array_equal(port.valid_counts, ref.valid_counts)
    w, rc, pc = len(ref.valid_counts), ref.capacity, port.capacity
    for name in ref.column_names:
        for arr_r, arr_p in ((ref.column(name).data, port.column(name).data),
                             (ref.column(name).validity,
                              port.column(name).validity)):
            assert (arr_r is None) == (arr_p is None), name
            if arr_r is None:
                continue
            a, b = np.asarray(arr_r), arr_p.numpy()
            assert a.dtype == b.dtype, name
            for r, n in enumerate(ref.valid_counts):
                np.testing.assert_array_equal(
                    b[r * pc:r * pc + n], a[r * rc:r * rc + n], name)


def _events(rec):
    return [(e["site"], e["kind"], e["action"])
            for e in rec.recovery_events()]


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

class TestLedger:
    def test_register_release_drains(self):
        for mem, arr in ((rmem, np.zeros(128, np.int64)),
                         (pmem, torch.zeros(128, dtype=torch.int64))):
            led = mem.ledger()
            base = led.balance()
            reg = mem.register("t", (arr,))
            assert led.balance() == base + 1024
            mem.release(reg)
            assert led.balance() == base
            mem.release(reg)      # idempotent
            assert led.balance() == base

    def test_table_release_drains_to_zero(self, env4, penv4, rng):
        df = pd.DataFrame({"k": rng.integers(0, 9, 256)})
        for mod, mem, env in ((rct, rmem, env4), (pct, pmem, penv4)):
            led = mem.ledger()
            base = led.balance()
            t = mod.Table.from_pandas(df, env)
            reg = mem.register_table("tbl", t)
            assert reg is not None and led.balance() > base
            del t
            gc.collect()
            assert led.balance() == base

    @pytest.mark.parametrize("spilled_first", [False, True])
    def test_window_evict_release_matches_reference(self, spilled_first):
        """A window registration is spillable; ``evict_release`` retires
        it device → host → released (a window already spilled goes
        straight to release), returns its bytes, counts
        ``window_evictions`` and drains the balance: the same counters
        in both packages."""
        import jax.numpy as jnp
        x = np.arange(256, dtype=np.int64)
        got = {}
        for mem, arrs in ((rmem, [jnp.asarray(x), jnp.asarray(x > 9)]),
                          (pmem, [torch.from_numpy(x),
                                  torch.from_numpy(x > 9)])):
            mem.reset_stats()
            base = mem.balance()
            reg = mem.register_window("w.w0", arrs)
            assert reg.spillable and mem.balance() == base + 256 * 9
            if spilled_first:
                assert mem.evict(reg) == 256 * 9
            assert mem.evict_release(reg) == 256 * 9
            assert mem.evict_release(reg) == 0     # no longer live
            assert mem.balance() == base and not reg.live
            st = mem.stats()
            got[mem] = (st["window_evictions"], st["spill_events"],
                        st["bytes_spilled"],
                        [o.split("#")[0] for o in mem.eviction_log()])
        assert got[pmem] == got[rmem]
        assert got[pmem][:2] == (1, 1)

    def test_budget_env_override(self, penv4, monkeypatch):
        monkeypatch.setattr(pconfig, "HBM_BUDGET_BYTES", 12345)
        assert pmem.budget_bytes(penv4) == 12345
        assert pmem.over_budget(penv4, 12346)
        monkeypatch.setattr(pconfig, "HBM_BUDGET_BYTES", 0)
        assert pmem.budget_bytes(penv4) == 0      # no limit on the CPU

    def test_property_random_sequences(self):
        """The same random register/evict/readmit/touch/release sequence
        keeps ``balance == sum of live device-resident registrations`` in
        both packages, step by step equal."""
        ops = np.random.default_rng(5)
        live = {"r": [], "p": []}
        bases = {"r": rmem.balance(), "p": pmem.balance()}
        for step in range(60):
            op = int(ops.integers(0, 5))
            n = int(ops.integers(8, 512))
            spill = bool(ops.integers(0, 2))
            pick = int(ops.integers(0, 1 << 30))
            for tag, mem in (("r", rmem), ("p", pmem)):
                regs = live[tag]
                if op == 0 or not regs:
                    arr = (np.zeros(n, np.float64) if tag == "r"
                           else torch.zeros(n, dtype=torch.float64))
                    regs.append(mem.register("prop", (arr,),
                                             spillable=spill))
                else:
                    reg = regs[pick % len(regs)]
                    if op == 1:
                        mem.evict(reg)
                    elif op == 2 and reg.spilled:
                        mem.readmit(reg)
                    elif op == 3:
                        mem.touch(reg)
                    else:
                        mem.release(reg)
                        regs.remove(reg)
                want = bases[tag] + sum(r.nbytes for r in regs
                                        if not r.spilled)
                assert mem.balance() == want, (tag, step)
            assert [r.spilled for r in live["r"]] \
                == [r.spilled for r in live["p"]], step
            assert (rmem.balance() - bases["r"]
                    == pmem.balance() - bases["p"]), step
        for tag, mem in (("r", rmem), ("p", pmem)):
            for reg in live[tag]:
                mem.release(reg)
            assert mem.balance() == bases[tag]

    def test_lru_eviction_order_is_deterministic(self, monkeypatch):
        got = {}
        for tag, mem, arr in (
                ("r", rmem, lambda: np.zeros(64, np.int64)),
                ("p", pmem, lambda: torch.zeros(64, dtype=torch.int64))):
            names = Owners(mem, monkeypatch)
            regs = [mem.register("lru", (arr(),), spillable=True)
                    for _ in range(3)]
            mem.touch(regs[0])    # the oldest untouched entry is regs[1]
            evicted = mem.ledger().evict_until(1, budget=1)
            assert evicted[0] == regs[1].owner
            got[tag] = names(evicted)
            for r in regs:
                mem.release(r)
        assert got["p"] == got["r"]


# ---------------------------------------------------------------------------
# spill round trips
# ---------------------------------------------------------------------------

class TestSpillRoundTrip:
    def test_bit_exact_all_lane_dtypes(self, env4, penv4, rng):
        """Every lane class, through evict and one window upload: the
        port's spilled window is byte-equal to its resident one and to the
        reference's spilled one."""
        df = _mixed_frame(rng)
        rt, pt = rct.Table.from_pandas(df, env4), pct.Table.from_pandas(
            df, penv4)
        lens = pt.valid_counts
        cap = pconfig.pow2ceil(int(lens.max()))
        starts = np.zeros(W, np.int64)
        rsrc, psrc = RSource(rt, pad=8), PSource(pt, pad=8)
        resident = _host(psrc.packed(starts, lens, cap).to_table())
        freed = pmem.evict(psrc._reg)
        assert freed > 0 and psrc.spilled and psrc.arrs is None
        spilled = _host(psrc.packed(starts, lens, cap).to_table())
        _same_host(spilled, resident)
        rmem.evict(rsrc._reg)
        _same_host(spilled, _host(rsrc.packed(starts, rt.valid_counts,
                                              cap).to_table()))
        st = pmem.stats()
        assert st["spill_events"] == 1 and st["bytes_spilled"] == freed
        assert st["bytes_readmitted"] > 0
        assert freed == rsrc._reg.nbytes      # the same packed bytes

    def test_whole_registration_readmit_bit_exact(self, penv4, rng):
        t = pct.Table.from_pandas(_mixed_frame(rng, n=256), penv4)
        src = PSource(t, pad=8)
        before = [a.numpy().tobytes() for a in src.arrs]
        pmem.evict(src._reg)
        arrs = pmem.readmit(src._reg)
        assert src.arrs is not None and not src.spilled
        assert [a.numpy().tobytes() for a in arrs] == before


# ---------------------------------------------------------------------------
# budget-driven spilling through the pipelined join
# ---------------------------------------------------------------------------

def _pipe_run(mod, run, lt, rt, how, sink):
    if not sink:
        return run(lt, rt, "k", "k", how=how, n_chunks=4)
    s = (RSink if mod is rct else pct.GroupBySink)(
        "k", [("a", "sum"), ("b", "sum"), ("a", "count")])
    run(lt, rt, "k", "k", how=how, n_chunks=4, sink=s)
    return s.finalize()


class TestBudgetSpill:
    @pytest.mark.parametrize("how", ["inner", "left", "outer"])
    @pytest.mark.parametrize("sink", [False, True], ids=["rows", "sink"])
    def test_pipelined_join_spills_and_stays_bit_equal(
            self, env4, penv4, rng, both_budgets, monkeypatch, how, sink):
        """A device budget below the resident working set: the pipelined
        join completes through the spill tier at the same chunk count,
        with the reference's eviction log, no ladder event, and a result
        bit- and layout-equal to the reference's spilled run and to the
        port's unspilled one."""
        ldf, rdf = _frames(rng)
        rl, rr = rct.Table.from_pandas(ldf, env4), rct.Table.from_pandas(
            rdf, env4)
        pl, pr = pct.Table.from_pandas(ldf, penv4), pct.Table.from_pandas(
            rdf, penv4)
        base = _pipe_run(pct, pct.pipelined_join, pl, pr, how, sink)
        gc.collect()
        pmem.reset_stats()
        rmem.reset_stats()
        both_budgets(hbm=4096)
        logs = {}
        for tag, mod, mem, run, lt, rt in (
                ("r", rct, rmem, r_pipe, rl, rr),
                ("p", pct, pmem, pct.pipelined_join, pl, pr)):
            names = Owners(mem, monkeypatch)
            out = _pipe_run(mod, run, lt, rt, how, sink)
            logs[tag] = (names(mem.eviction_log()), out)
            assert mem.stats()["spill_events"] > 0
        assert logs["p"][0] == logs["r"][0] and logs["p"][0]
        assert prec.recovery_events() == [] == rrec.recovery_events()
        _same_rows(logs["r"][1], logs["p"][1])
        _same_rows(base, logs["p"][1])

    @pytest.mark.parametrize("how", ["inner", "outer"])
    @pytest.mark.parametrize("sink", [False, True], ids=["rows", "sink"])
    def test_prefetch_ahead_bit_equal_to_one_piece_at_a_time(
            self, penv4, rng, monkeypatch, how, sink):
        """A budget that evicts one packed source and still holds two
        window pairs: ``prefetch_depth`` is 2, so piece r+1's windows
        upload before piece r joins.  The result is bit-equal to the same
        budget at depth 1 and to the unspilled run, the same bytes
        upload, and an upload fault of the piece prepared ahead still
        surfaces after the piece before it was consumed."""
        ldf, rdf = _frames(rng)
        pl, pr = pct.Table.from_pandas(ldf, penv4), pct.Table.from_pandas(
            rdf, penv4)
        calls, admit = [], pmem.ensure_headroom

        def admit_spy(env_, need, scratch=0, site="spill.evict"):
            calls.append((pmem.balance(), int(need), int(scratch)))
            return admit(env_, need, scratch, site)

        monkeypatch.setattr(pmem, "ensure_headroom", admit_spy)
        base = _pipe_run(pct, pct.pipelined_join, pl, pr, how, sink)
        monkeypatch.setattr(pmem, "ensure_headroom", admit)
        (_, need_l, _), (b1, need_r, scr_r) = calls
        depths, depth_fn = [], pmem.prefetch_depth

        def depth_spy(env_, pair):
            depths.append((pmem.balance(), int(pair), depth_fn(env_, pair)))
            return depths[-1][2]

        monkeypatch.setattr(pmem, "prefetch_depth", depth_spy)
        # the budget that evicts the first source and leaves no room for
        # a second window pair: depth 1
        monkeypatch.setattr(pconfig, "HBM_BUDGET_BYTES",
                            b1 - need_l + need_r + scr_r)
        pmem.reset_stats()
        one = _pipe_run(pct, pct.pipelined_join, pl, pr, how, sink)
        st_one = pmem.stats()
        assert depths and {d for _, _, d in depths} == {1}
        two_pairs = max(b for b, _, _ in depths) \
            + 2 * max(p for _, p, _ in depths)
        assert two_pairs < b1 + need_r + scr_r     # the source still evicts
        depths.clear()
        monkeypatch.setattr(pconfig, "HBM_BUDGET_BYTES", two_pairs)
        pmem.reset_stats()
        two = _pipe_run(pct, pct.pipelined_join, pl, pr, how, sink)
        st_two = pmem.stats()
        assert depths and {d for _, _, d in depths} == {2}
        for st in (st_one, st_two):
            assert st["spill_events"] == 1
        assert st_two["bytes_readmitted"] == st_one["bytes_readmitted"] > 0
        assert prec.recovery_events() == []
        _same_rows(one, two)
        _same_rows(base, two)
        # a fault while uploading the second piece ahead is held: the
        # first piece is consumed first, as at depth 1
        consumed = []
        for budget in (b1 - need_l + need_r + scr_r, two_pairs):
            monkeypatch.setattr(pconfig, "HBM_BUDGET_BYTES", budget)
            prec.install_faults("spill.upload::2=capacity")
            seen = []
            with pytest.raises(pstatus.CapacityOverflowError):
                pct.pipelined_join(pl, pr, "k", "k", how=how, n_chunks=4,
                                   sink=seen.append)
            consumed.append(len(seen))
            prec.install_faults("")
        assert consumed[0] == consumed[1] >= 1

    def test_spill_disabled_escape_hatch(self, penv4, rng, monkeypatch):
        """``CYLON_TPU_TORCH_SPILL=0``: the ledger keeps accounting and
        nothing evicts, under budget pressure or injected pressure, and
        the spill rung frees nothing."""
        monkeypatch.setattr(pconfig, "HBM_BUDGET_BYTES", 4096)
        monkeypatch.setattr(pconfig, "SPILL_ENABLED", False)
        src = PSource(pct.Table.from_pandas(_mixed_frame(rng, n=256),
                                            penv4), pad=8)
        assert pmem.balance() > 0
        prec.install_faults("spill.evict:0:1=predicted")
        pmem.ensure_headroom(penv4, 1 << 20)
        assert not src.spilled
        assert pmem.stats()["spill_events"] == 0
        assert pmem.spill_for_retry() == 0
        del src


# ---------------------------------------------------------------------------
# the ladder's spill rung and its handoff to chunk escalation
# ---------------------------------------------------------------------------

def _rung_run(env4, penv4, rng, spec, aux: bool):
    """One join under ``spec`` in both packages, with a spillable packed
    source resident when ``aux``; returns each package's events, joined
    rows and whether the aux source was spilled."""
    ldf, rdf = _frames(rng)
    out = {}
    for tag, mod, rec, src_cls, join, env in (
            ("r", rct, rrec, RSource, r_join, env4),
            ("p", pct, prec, PSource, pct.join_tables, penv4)):
        lt = mod.Table.from_pandas(ldf, env)
        rt = mod.Table.from_pandas(rdf, env)
        src = src_cls(mod.Table.from_pandas(ldf, env), pad=8) if aux \
            else None
        gc.collect()
        rec.install_faults(spec)
        j = join(lt, rt, "k", "k", how="inner")
        out[tag] = (_events(rec), _sorted_rows(j, ["k", "a", "b"]),
                    None if src is None else src.spilled)
        del src
    exp = ldf.merge(rdf, on="k")
    want = [exp[c].to_numpy() for c in ("k", "a", "b")]
    order = np.lexsort(want[::-1])
    for got, ref, w_ in zip(out["p"][1], out["r"][1], want):
        np.testing.assert_array_equal(got, w_[order])
        np.testing.assert_array_equal(got, ref)
    return out


class TestSpillRung:
    def test_predicted_fault_takes_spill_rung_first(self, env4, penv4, rng):
        """A predicted receive-budget fault with spillable state resident:
        one ``spill_retry``, no chunk escalation, the same rows."""
        out = _rung_run(env4, penv4, rng,
                        "shuffle.recv_guard:0:1=predicted", aux=True)
        assert out["p"][0] == out["r"][0] \
            == [("join", "predicted", "spill_retry")]
        assert out["p"][2] and out["r"][2]

    def test_spill_insufficient_hands_off_to_chunks(self, env4, penv4,
                                                    rng):
        """The guard faults again after the spill rung (nth = 2): the
        ladder falls through to the 4-chunk rung."""
        out = _rung_run(env4, penv4, rng,
                        "shuffle.recv_guard:0:1=predicted,"
                        "shuffle.recv_guard:0:2=predicted", aux=True)
        assert out["p"][0] == out["r"][0]
        acts = [a for s, _, a in out["p"][0] if s == "join"]
        assert acts[:2] == ["spill_retry", "retry_chunks_4"], acts

    def test_no_spillable_state_goes_straight_to_chunks(self, env4, penv4,
                                                        rng):
        out = _rung_run(env4, penv4, rng,
                        "shuffle.recv_guard:0:1=predicted", aux=False)
        assert out["p"][0] == out["r"][0] \
            == [("join", "predicted", "retry_chunks_4")]


# ---------------------------------------------------------------------------
# spill-site injection and the watchdog
# ---------------------------------------------------------------------------

class TestSpillInjection:
    def test_grammar_accepts_spill_sites_and_kind(self):
        for rec in (rrec, prec):
            rec.install_faults("spill.evict=predicted")
            rec.install_faults("spill.upload=spill_stall")
            rec.install_faults("spill.evict:0:2=spill_stall")
            with pytest.raises(ValueError):
                rec.install_faults("spill.nope=predicted")

    def test_upload_stall_surfaces_typed_desync(self, penv4, rng):
        t = pct.Table.from_pandas(_mixed_frame(rng, n=256), penv4)
        src = PSource(t, pad=8)
        pmem.evict(src._reg)
        prec.install_faults("spill.upload=spill_stall")
        with pytest.raises(RankDesyncError) as ei:
            src.packed(np.zeros(W, np.int64), t.valid_counts, 64)
        assert ei.value.site == "spill.upload"
        del src

    def test_evict_pressure_injection_evicts_lru(self, env4, penv4, rng,
                                                 monkeypatch):
        """``predicted`` at ``spill.evict`` simulates pressure: the
        admission evicts exactly the LRU spillable owner, in both."""
        df = _mixed_frame(rng, n=256)
        logs = {}
        for tag, mod, mem, rec, src_cls, env in (
                ("r", rct, rmem, rrec, RSource, env4),
                ("p", pct, pmem, prec, PSource, penv4)):
            names = Owners(mem, monkeypatch)
            src = src_cls(mod.Table.from_pandas(df, env), pad=8)
            rec.install_faults("spill.evict:0:1=predicted")
            mem.ensure_headroom(env, 0)
            assert src.spilled
            assert mem.eviction_log() == [src._reg.owner]
            logs[tag] = names(mem.eviction_log())
            del src
        assert logs["p"] == logs["r"]

    def test_evict_exception_kinds_raise_typed(self, penv4):
        prec.install_faults("spill.evict=device_oom")
        with pytest.raises(Exception) as ei:
            pmem.ensure_headroom(penv4, 0)
        assert isinstance(prec.classify(ei.value), DeviceOOMError)


# ---------------------------------------------------------------------------
# the disk tier
# ---------------------------------------------------------------------------

@pytest.fixture()
def disk(tmp_path, monkeypatch):
    """The port's disk tier armed with a tiny host budget and a private
    spill root; yields the root."""
    root = str(tmp_path / "spill")
    monkeypatch.setattr(pconfig, "HOST_BUDGET_BYTES", 4096)
    monkeypatch.setattr(pconfig, "SPILL_DIR", root)
    return root


def _pages(root):
    return sorted(glob.glob(os.path.join(root, "rank*", "*.spill.npy")))


def _spilled_source(penv4, rng, n=256):
    t = pct.Table.from_pandas(_mixed_frame(rng, n=n), penv4)
    src = PSource(t, pad=8)
    pmem.evict(src._reg)
    return t, src


class TestDiskTier:
    def test_demote_window_read_bit_exact(self, penv4, rng, disk):
        """device → host → disk → a window off memory-mapped pages:
        byte-equal to the resident window, pages on disk while demoted,
        the traffic counted."""
        t = pct.Table.from_pandas(_mixed_frame(rng), penv4)
        lens = t.valid_counts
        cap = pconfig.pow2ceil(int(lens.max()))
        starts = np.zeros(W, np.int64)
        src = PSource(t, pad=8)
        ref = _host(src.packed(starts, lens, cap).to_table())
        pmem.evict(src._reg)
        assert pmem.demote(src._reg) > 0
        assert src._reg.on_disk and src._reg.host is None
        assert pmem.demotion_log() == [src._reg.owner]
        pages = _pages(disk)
        assert pages, "no spill page written"
        _same_host(_host(src.packed(starts, lens, cap).to_table()), ref)
        st = pmem.stats()
        assert st["disk_events"] >= 2
        assert st["bytes_to_disk"] > 0 and st["bytes_from_disk"] > 0
        assert st["disk_pages_demoted"] == len(pages)
        del src

    def test_full_readmit_from_disk_bit_exact(self, penv4, rng, disk):
        t = pct.Table.from_pandas(_mixed_frame(rng, n=256), penv4)
        src = PSource(t, pad=8)
        before = [a.numpy().tobytes() for a in src.arrs]
        pmem.evict(src._reg)
        pmem.demote(src._reg)
        arrs = pmem.readmit(src._reg)
        assert not src.spilled and not src._reg.on_disk
        assert [a.numpy().tobytes() for a in arrs] == before
        assert not _pages(disk)
        del src

    def test_host_budget_drives_demotion_through_pipelined_join(
            self, env4, penv4, rng, tmp_path, both_budgets, monkeypatch):
        """Both budgets below the working set: the pipelined join rides
        device → host → disk → mapped windows, with the reference's
        eviction and demotion logs, no ladder event, and the unspilled
        result; the spill directory is empty afterwards."""
        monkeypatch.setattr(rconfig, "SPILL_DIR", str(tmp_path / "r"))
        monkeypatch.setattr(pconfig, "SPILL_DIR", str(tmp_path / "p"))
        ldf, rdf = _frames(rng)
        rl, rr = rct.Table.from_pandas(ldf, env4), rct.Table.from_pandas(
            rdf, env4)
        pl, pr = pct.Table.from_pandas(ldf, penv4), pct.Table.from_pandas(
            rdf, penv4)
        base = pct.pipelined_join(pl, pr, "k", "k", n_chunks=4)
        gc.collect()
        rmem.reset_stats()
        pmem.reset_stats()
        both_budgets(hbm=4096, host=4096)
        logs = {}
        for tag, mem, run, lt, rt in (("r", rmem, r_pipe, rl, rr),
                                      ("p", pmem, pct.pipelined_join, pl,
                                       pr)):
            names = Owners(mem, monkeypatch)
            out = run(lt, rt, "k", "k", how="inner", n_chunks=4)
            st = mem.stats()
            assert st["disk_events"] > 0 and st["bytes_to_disk"] > 0, st
            logs[tag] = (names(mem.eviction_log()),
                         names(mem.demotion_log()), out)
        assert logs["p"][:2] == logs["r"][:2] and logs["p"][1]
        assert prec.recovery_events() == [] == rrec.recovery_events()
        _same_rows(logs["r"][2], logs["p"][2])
        _same_rows(base, logs["p"][2])
        del logs, out
        gc.collect()
        assert not _pages(str(tmp_path / "p"))

    def test_enospc_demotion_degrades_in_memory(self, penv4, rng, disk):
        _, src = _spilled_source(penv4, rng)
        prec.install_faults("disk.write::1=enospc")
        assert pmem.demote(src._reg) == 0
        assert src._reg.host is not None and not src._reg.on_disk
        assert pmem.stats()["disk_write_degrades"] == 1
        assert _events(prec) == [("disk.write", "enospc",
                                  "degrade_in_memory")]
        assert not _pages(disk)
        del src

    def test_corrupt_promote_is_typed_and_retires_owner(self, penv4, rng,
                                                        disk):
        t, src = _spilled_source(penv4, rng)
        prec.install_faults("disk.write::1=corrupt")
        assert pmem.demote(src._reg) > 0
        with pytest.raises(CheckpointCorruptError) as ei:
            src.packed(np.zeros(W, np.int64), t.valid_counts, 64)
        assert ei.value.site == "disk.read"
        assert not src._reg.live
        assert pmem.stats()["disk_corrupt_degrades"] == 1
        del src

    def test_corrupt_promote_recomputes_through_ladder(
            self, env4, penv4, rng, tmp_path, both_budgets, monkeypatch):
        """A corrupt page inside a pipelined join → sink under the ladder
        degrades to one recompute rung, in both packages alike, and the
        answer is the unspilled one."""
        ldf, rdf = _frames(rng)
        got = {}
        for tag, mod, mem, rec, cfg, run, sink_cls, env in (
                ("r", rct, rmem, rrec, rconfig, r_pipe, RSink, env4),
                ("p", pct, pmem, prec, pconfig, pct.pipelined_join,
                 pct.GroupBySink, penv4)):
            lt = mod.Table.from_pandas(ldf, env)
            rt = mod.Table.from_pandas(rdf, env)

            def attempt(nc):
                sink = sink_cls("k", [("a", "sum"), ("b", "sum")])
                run(lt, rt, "k", "k", how="inner", n_chunks=nc, sink=sink)
                return sink.finalize()

            if tag == "p":
                base = attempt(4)
            gc.collect()
            mem.reset_stats()
            monkeypatch.setattr(cfg, "HBM_BUDGET_BYTES", 4096)
            monkeypatch.setattr(cfg, "HOST_BUDGET_BYTES", 4096)
            monkeypatch.setattr(cfg, "SPILL_DIR", str(tmp_path / tag))
            rec.install_faults("disk.read::1=corrupt")
            out = rec.run_with_recovery(lambda: attempt(4), True, attempt,
                                        "oocore", env=env)
            got[tag] = (_events(rec), out)
            assert mem.stats()["disk_corrupt_degrades"] == 1
        assert got["p"][0] == got["r"][0]
        assert ("disk.read", "corrupt", "recompute_owner") in got["p"][0]
        assert ("oocore", "corrupt", "retry_chunks_4") in got["p"][0]
        _same_rows(got["r"][1], got["p"][1])
        _same_rows(base, got["p"][1])

    def test_torn_page_surfaces_typed_not_crash(self, penv4, rng, disk):
        t, src = _spilled_source(penv4, rng)
        assert pmem.demote(src._reg) > 0
        page = _pages(disk)[0]
        with open(page, "r+b") as f:        # truncate mid-data
            f.truncate(os.path.getsize(page) // 2)
        with pytest.raises(CheckpointCorruptError) as ei:
            src.packed(np.zeros(W, np.int64), t.valid_counts, 64)
        assert ei.value.site == "disk.read"
        assert pmem.stats()["disk_corrupt_degrades"] == 1
        del src

    def test_disk_stalls_surface_typed_desync(self, penv4, rng, disk):
        t, src = _spilled_source(penv4, rng)
        prec.install_faults("disk.write::1=stall")
        with pytest.raises(RankDesyncError) as ei:
            pmem.demote(src._reg)
        assert ei.value.site == "disk.write"
        prec.install_faults("")       # disarmed; the pages are still host
        assert pmem.demote(src._reg) > 0
        prec.install_faults("disk.read::1=stall")
        with pytest.raises(RankDesyncError) as ei:
            src.packed(np.zeros(W, np.int64), t.valid_counts, 64)
        assert ei.value.site == "disk.read"
        del src

    def test_transient_oserror_retries_then_succeeds(self, penv4, rng, disk,
                                                     monkeypatch):
        _, src = _spilled_source(penv4, rng)
        real_save, fails = np.save, [1]

        def flaky_save(path, arr, **kw):
            if fails[0]:
                fails[0] -= 1
                raise OSError(5, "transient EIO")
            return real_save(path, arr, **kw)

        monkeypatch.setattr(np, "save", flaky_save)
        assert pmem.demote(src._reg) > 0
        assert pmem.stats()["disk_retries"] == 1
        del src

    def test_unarmed_disk_tier_writes_nothing(self, penv4, rng, tmp_path,
                                              monkeypatch):
        root = str(tmp_path / "never")
        monkeypatch.setattr(pconfig, "SPILL_DIR", root)
        monkeypatch.setattr(pconfig, "HBM_BUDGET_BYTES", 4096)
        monkeypatch.setattr(pconfig, "HOST_BUDGET_BYTES", 0)
        ldf, rdf = _frames(rng)
        pct.pipelined_join(pct.Table.from_pandas(ldf, penv4),
                           pct.Table.from_pandas(rdf, penv4), "k", "k",
                           n_chunks=4)
        st = pmem.stats()
        assert st["spill_events"] > 0
        assert st["disk_events"] == 0 and st["bytes_to_disk"] == 0
        assert not os.path.exists(root)

    def test_predecessor_orphans_purged_on_first_use(self, penv4, rng,
                                                     disk):
        d = os.path.join(disk, "rank0")
        os.makedirs(d, exist_ok=True)
        orphan = os.path.join(d, "dead_owner.a0.s0.spill.npy")
        np.save(orphan, np.zeros(8))
        pmem._PURGED_DIRS.discard(d)          # a fresh process
        _, src = _spilled_source(penv4, rng)
        assert pmem.demote(src._reg) > 0
        assert not os.path.exists(orphan)
        del src

    def test_demotion_lru_order_is_deterministic(self, disk, monkeypatch,
                                                 tmp_path):
        monkeypatch.setattr(rconfig, "HOST_BUDGET_BYTES", 4096)
        monkeypatch.setattr(rconfig, "SPILL_DIR", str(tmp_path / "r"))
        got = {}
        for tag, mem, arr in (
                ("r", rmem, lambda: np.zeros(64, np.int64)),
                ("p", pmem, lambda: torch.zeros(64, dtype=torch.int64))):
            names = Owners(mem, monkeypatch)
            regs = [mem.register("dlru", (arr(),), spillable=True)
                    for _ in range(3)]
            for r in regs:
                mem.evict(r)
            mem.touch(regs[0])     # the oldest untouched host page: regs[1]
            led = mem.ledger()
            assert led.demote_count_for(1) >= 1
            got[tag] = names(led.demote_n(1))
            assert got[tag] == names([regs[1].owner])
            for r in regs:
                mem.release(r)
        assert got["p"] == got["r"]
