"""The serving tier of cylon_tpu_torch (``exec/scheduler.py``,
``exec/session.py`` and their hooks in ``exec/recovery``,
``exec/checkpoint`` and ``exec/memory``) against cylon_tpu's, mirroring
the non-slow cases of tests/test_scheduler.py.

Every scenario runs in both packages on the same inputs (numpy draws from
one seed): the reference on its CPU mesh (``env1``/``env4``), the port on
``VirtualMeshConfig(w, device="cpu")``.  Held equal: the results, bit for
bit, the session states and outcome buckets, the ``stats()`` counters
(the reference's ``compile`` block has no counterpart yet), the recovery
events (site, kind, action, session), the checkpoint stage directory
names and the typed errors.  Grant order is compared under ``fifo`` and
``priority`` only: ``fair`` keys on wall-clock seconds.  Not mirrored:
``test_program_cache_shared_across_tenants`` (the port has no program
cache before the compile tier) and the two slow harnesses:
``scripts/chaos_soak.py --concurrent`` has its port, ``python -m
cylon_tpu_torch.exec.chaos_soak --concurrent``, held by
tests/test_torch_chaos_soak.py (slow-marked, as the reference's);
``scripts/bench_serving.py`` waits for the port's benchmark, and its
card counterparts are ``chip_smoke.serve_path`` and ``serve_small``
(rehearsed in tests/test_torch_serve_rehearsal.py).

Also here: a deferred inner join → ``groupby_aggregate`` on the join key
at W = 4 with ``groupby.device_oom`` injected, untagged and inside a
scheduler session, for sum, mean/max and the 4 → 16 escalation."""

import gc
import os
import time

import jax
import numpy as np
import pytest
import torch

import cylon_tpu as rct
from cylon_tpu import config as rconfig
from cylon_tpu import obs as robs
from cylon_tpu import status as rstatus
from cylon_tpu.ctx.context import CPUMeshConfig
from cylon_tpu.exec import GroupBySink as RSink
from cylon_tpu.exec import checkpoint as rckpt
from cylon_tpu.exec import fleet as rfleet
from cylon_tpu.exec import memory as rmem
from cylon_tpu.exec import pipelined_join as r_pipe
from cylon_tpu.exec import recovery as rrec
from cylon_tpu.exec import scheduler as rsched
from cylon_tpu.exec import session as rsession
from cylon_tpu.relational import groupby_aggregate as r_groupby
from cylon_tpu.relational import join_tables as r_join
from cylon_tpu.utils import timing as rtiming
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch import obs as pobs
from cylon_tpu_torch import status as pstatus
from cylon_tpu_torch.exec import checkpoint as pckpt
from cylon_tpu_torch.exec import fleet as pfleet
from cylon_tpu_torch.exec import memory as pmem
from cylon_tpu_torch.exec import recovery as prec
from cylon_tpu_torch.exec import scheduler as psched
from cylon_tpu_torch.exec import session as psession
from cylon_tpu_torch.utils import timing as ptiming


class Pkg:
    """One package's handles, so a scenario is written once."""

    def __init__(self, name, ct, config, obs, st, sink, pipe, ckpt, fleet,
                 mem, rec, sched, session, timing, groupby, join, prefix):
        self.name, self.ct, self.config, self.obs = name, ct, config, obs
        self.st, self.sink, self.pipe, self.ckpt = st, sink, pipe, ckpt
        self.fleet, self.mem, self.rec, self.sched = fleet, mem, rec, sched
        self.session, self.timing = session, timing
        self.groupby, self.join = groupby, join
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

    def table(self, cols: dict, env):
        return self.ct.Table.from_pydict(cols, env)

    def rows(self, table) -> dict:
        """A result's columns as numpy arrays, rows sorted by every
        column (first column first)."""
        if self.name == "ref":
            df = table.to_pandas()
            cols = {c: df[c].to_numpy() for c in df.columns}
        else:
            cols = {c: np.asarray(v) for c, v in table.to_pydict().items()}
        order = np.lexsort([cols[c] for c in reversed(list(cols))])
        return {c: v[order] for c, v in cols.items()}

    def region_calls(self, sess, name: str) -> int:
        if self.name == "ref":
            return sess.phase_snapshot()[name]["n"]
        return sess.timing.counts()[name]

    def region_s(self, sess, name: str) -> float:
        if self.name == "ref":
            return sess.phase_snapshot()[name]["s"]
        return sess.phase_snapshot()[name]

    def timing_off(self) -> bool:
        if self.name == "ref":
            return not self.config.BENCH_TIMINGS
        return self.timing.mode() is None

    def events(self, evs=None):
        """Recovery events as (site, kind, action, session) tuples."""
        evs = self.rec.recovery_events() if evs is None else evs
        return [(e["site"], e["kind"], e["action"], e.get("session"))
                for e in evs]

    def reset(self):
        self.rec.install_faults("")
        self.rec.reset_events()
        self.rec.set_session(None, None)
        self.mem.reset_stats()
        self.ckpt.reset_stats()
        self.ckpt.reset_stages()
        self.sched.reset_family_history()


REF = Pkg("ref", rct, rconfig, robs, rstatus, RSink, r_pipe, rckpt, rfleet,
          rmem, rrec, rsched, rsession, rtiming, r_groupby, r_join,
          "CYLON_TPU_")
PORT = Pkg("port", pct, pconfig, pobs, pstatus, pct.GroupBySink,
           pct.pipelined_join, pckpt, pfleet, pmem, prec, psched, psession,
           ptiming, pct.groupby_aggregate, pct.join_tables,
           "CYLON_TPU_TORCH_")
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
        p.reset()
    gc.collect()
    yield
    for p in BOTH:
        p.reset()


def pipe_fn(p: Pkg, env, seed, n=1200, chunks=3, label=None):
    """A TPC-H-shaped pipelined join into a sink (the reference test's
    tenant): piece-loop interleave points and spillable piece sources.
    Returns the sorted result rows."""
    def attempt(nc):
        rng = np.random.default_rng(seed)
        n_ord = max(n // 4, 64)
        orders = p.table(
            {"o_orderkey": np.arange(n_ord, dtype=np.int64),
             "o_pri": rng.integers(0, 5, n_ord).astype(np.int64)}, env)
        line = p.table(
            {"l_orderkey": rng.integers(0, n_ord, n).astype(np.int64),
             "l_qty": rng.integers(1, 51, n).astype(np.int64)}, env)
        sink = p.sink("l_orderkey", [("l_qty", "sum")])
        p.pipe(line, orders, "l_orderkey", "o_orderkey", how="inner",
               n_chunks=nc, sink=sink)
        return p.rows(sink.finalize())

    if label is None:
        return lambda: attempt(chunks)
    return lambda: p.rec.run_with_recovery(
        lambda: attempt(chunks), True, attempt, label, env=env)


def same_rows(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for c in a:
        np.testing.assert_array_equal(b[c], a[c], c)


def both(scenario):
    """Run ``scenario(p)`` for the reference, then the port; the two
    return values."""
    out = []
    for p in BOTH:
        out.append(scenario(p))
        p.reset()
    return out


def typed(fn) -> str:
    """The class name of the error ``fn`` raises ("" when none)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class is the result
        return type(e).__name__
    return ""


class TestPolicies:
    def test_policy_keys(self):
        def scenario(p):
            S = p.session.QuerySession
            a = S("a", lambda: None, 0, priority=1)
            b = S("b", lambda: None, 1, priority=5)
            c = S("c", lambda: None, 2, priority=5, weight=2.0)
            picks = [min([b, a], key=p.sched._fifo_key).name,
                     min([a, b, c], key=p.sched._priority_key).name]
            a.service_s, b.service_s, c.service_s = 1.0, 3.0, 3.0
            picks.append(min([a, b, c], key=p.sched._fair_key).name)
            a.service_s = 2.0
            picks.append(min([a, b, c], key=p.sched._fair_key).name)
            return picks

        r, q = both(scenario)
        assert q == r == ["a", "b", "a", "c"]

    def test_unknown_policy_and_duplicate_names(self):
        def scenario(p):
            env = p.env(1)
            errs = [typed(lambda: p.sched.QueryScheduler(env,
                                                         policy="lottery"))]
            sched = p.sched.QueryScheduler(env)
            sched.submit("t0", lambda: 1)
            errs.append(typed(lambda: sched.submit("t0", lambda: 2)))
            errs.append(typed(lambda: sched.submit("bad/name", lambda: 3)))
            errs.append(typed(lambda: sched.submit("s", lambda: 3,
                                                   kind="batch")))
            return errs

        r, q = both(scenario)
        assert q == r == ["InvalidError", "InvalidError", "ValueError",
                          "ValueError"]

    def test_fair_interleaves_and_timing_tables_disjoint(self):
        """Two interleaved sessions' phase tables are disjoint: each
        holds its own thread's regions only, identically named ones
        included, and the process-wide table stays untouched."""
        def scenario(p):
            order = []

            def tenant(name):
                def fn():
                    for _ in range(3):
                        with p.timing.region("q.work"):
                            with p.timing.region(f"only.{name}"):
                                time.sleep(0.003)
                        order.append(name)
                        p.sched.maybe_yield()
                    return name
                return fn

            sched = p.sched.QueryScheduler(p.env(1), policy="fair")
            a = sched.submit("tA", tenant("tA"))
            b = sched.submit("tB", tenant("tB"))
            sched.run(raise_errors=True)
            assert a.slices >= 2 and b.slices >= 2
            assert set(order[:4]) == {"tA", "tB"}
            got = {}
            for s, other in ((a, "tB"), (b, "tA")):
                snap = s.phase_snapshot()
                assert f"only.{other}" not in snap
                assert s.attributed_s() > 0
                got[s.name] = (s.result, s.state, s.outcome(),
                               p.region_calls(s, "q.work"),
                               p.region_calls(s, f"only.{s.name}"))
            assert p.timing_off()
            assert "q.work" not in p.timing.snapshot()
            return got

        r, q = both(scenario)
        assert q == r
        assert q["tA"] == ("tA", "done", "completed", 3, 3)

    def test_region_spanning_yield_excludes_baton_wait(self):
        """A region spanning a yield point does not absorb the co-tenant's
        slices: the parked time is netted out of it."""
        def scenario(p):
            def busy(work_s):
                def fn():
                    for _ in range(3):
                        with p.timing.region("outer.span"):
                            time.sleep(work_s)
                            p.sched.maybe_yield()
                return fn

            sched = p.sched.QueryScheduler(p.env(1), policy="fair")
            a = sched.submit("tA", busy(0.002))
            b = sched.submit("tB", busy(0.03))
            sched.run(raise_errors=True)
            assert a.slices >= 2 and b.slices >= 2
            return (p.region_s(a, "outer.span") < 0.05,
                    p.region_s(b, "outer.span") >= 0.09)

        r, q = both(scenario)
        assert q == r == (True, True)

    def test_priority_runs_high_first(self):
        def scenario(p):
            done = []

            def mk(name):
                def fn():
                    p.sched.maybe_yield()
                    done.append(name)
                return fn

            sched = p.sched.QueryScheduler(p.env(1), policy="priority")
            sched.submit("lo", mk("lo"), priority=0)
            sched.submit("hi", mk("hi"), priority=9)
            sched.run(raise_errors=True)
            return done

        r, q = both(scenario)
        assert q == r == ["hi", "lo"]


def _stats(sched) -> dict:
    """``stats()`` without the compile block (the reference counts XLA
    programs, the port kernel libraries) and the wall-clock seconds."""
    st = dict(sched.stats())
    st.pop("compile", None)
    st.pop("admission_wait_s")
    return st


class TestAdmission:
    def test_admission_wait_then_release(self):
        """A budget that fits one declared footprint: the second session
        waits at admission and starts after the first completes (fifo,
        no overtaking)."""
        def scenario(p):
            events = []

            def mk(name):
                def fn():
                    events.append(("start", name))
                    p.sched.maybe_yield()
                    events.append(("end", name))
                return fn

            sched = p.sched.QueryScheduler(p.env(1), policy="fifo",
                                           budget_bytes=1000)
            a = sched.submit("tA", mk("tA"), footprint_bytes=600)
            b = sched.submit("tB", mk("tB"), footprint_bytes=600)
            sched.run(raise_errors=True)
            assert b.admission_wait_s > 0
            return (events, a.admission_waits, b.admission_waits,
                    _stats(sched))

        r, q = both(scenario)
        assert q == r
        assert q[0] == [("start", "tA"), ("end", "tA"), ("start", "tB"),
                        ("end", "tB")]
        assert q[1] == 0 and q[2] >= 1 and q[3]["admission_waits"] >= 1

    def test_force_admit_when_nothing_runs(self):
        """A footprint above the whole budget cannot deadlock the queue:
        with nothing running, the session is force-admitted."""
        def scenario(p):
            sched = p.sched.QueryScheduler(p.env(1), budget_bytes=100)
            s = sched.submit("huge", lambda: 42, footprint_bytes=10**9)
            sched.run(raise_errors=True)
            return s.result, _stats(sched)

        r, q = both(scenario)
        assert q == r
        assert q[0] == 42 and q[1]["forced_admissions"] == 1

    def test_force_serial_counted_and_wait_closed(self):
        """The force-serial grant is counted under its own name and
        closes the candidate's admission-wait period."""
        def scenario(p):
            before = p.obs.counter("sched_admission_force_serial").value
            sched = p.sched.QueryScheduler(p.env(1), budget_bytes=100)
            s = sched.submit("huge", lambda: 42, footprint_bytes=10**9)
            sched.run(raise_errors=True)
            return (s.result, sched.stats()["admission_force_serial"],
                    p.obs.counter("sched_admission_force_serial").value
                    - before, s._wait_mark, s.outcome())

        r, q = both(scenario)
        assert q == r == (42, 1, 1, None, "completed")

    def test_family_history_unblocks_co_fit(self):
        """With a recorded peak of 200 B for their shape family, two
        600 B tenants are admitted at min(600, 200 x 1.5) = 300 B against
        a 1000 B budget: neither waits."""
        def scenario(p):
            events = []

            def mk(name):
                def fn():
                    events.append(("start", name))
                    p.sched.maybe_yield()
                    events.append(("end", name))
                return fn

            p.sched.reset_family_history()
            p.sched.note_family_peak("mixA", 200)
            try:
                sched = p.sched.QueryScheduler(
                    p.env(1), policy="fifo", budget_bytes=1000,
                    history_safety_factor=1.5)
                a = sched.submit("tA", mk("tA"), footprint_bytes=600,
                                 shape_family="mixA")
                b = sched.submit("tB", mk("tB"), footprint_bytes=600,
                                 shape_family="mixA")
                sched.run(raise_errors=True)
            finally:
                p.sched.reset_family_history()
            return (len(events), a.admission_waits, b.admission_waits,
                    _stats(sched))

        r, q = both(scenario)
        assert q == r
        assert q[:3] == (4, 0, 0) and q[3]["admission_waits"] == 0

    def test_cross_tenant_eviction_under_pressure(self, monkeypatch):
        """Tenant B's admission evicts tenant A's cold spillable
        registration, counted as a cross-session eviction, and A's state
        comes back bit-exact from host memory."""
        def scenario(p):
            monkeypatch.setattr(p.config, "HBM_BUDGET_BYTES", 1)
            env = p.env(1)
            box = {}

            def tenant_a():
                if p.name == "ref":
                    import jax.numpy as jnp
                    arr = jnp.arange(1 << 18, dtype=jnp.uint32)
                    box["host"] = np.asarray(arr)
                else:
                    arr = torch.arange(1 << 18, dtype=torch.int32)
                    box["host"] = arr.numpy().copy()
                box["reg"] = p.mem.register("tenantA_state", (arr,),
                                            spillable=True)
                p.sched.maybe_yield()    # B runs while A's state is cold
                p.sched.maybe_yield()
                box["evicted"] = box["reg"].spilled
                got = p.mem.readmit(box["reg"])
                box["back"] = np.asarray(got[0]).ravel()
                p.mem.release(box["reg"])

            def tenant_b():
                p.config.HBM_BUDGET_BYTES = (1 << 19) + (1 << 16)
                p.sched.admit_allocation(env, 1 << 19)

            sched = p.sched.QueryScheduler(env, policy="fair")
            sched.submit("tA", tenant_a)
            sched.submit("tB", tenant_b)
            sched.run(raise_errors=True)
            np.testing.assert_array_equal(box["back"], box["host"])
            return (box["evicted"],
                    p.mem.stats()["cross_session_evictions"] >= 1,
                    sched.stats()["cross_session_evictions"] >= 1)

        r, q = both(scenario)
        assert q == r == (True, True, True)

    def test_estimate_footprint(self):
        def scenario(p):
            t = p.table({"a": np.arange(100, dtype=np.int64),
                         "b": np.arange(100, dtype=np.float64)}, p.env(1))
            return (p.sched.estimate_footprint(t, factor=2.0),
                    p.sched.estimate_footprint(t, factor=1.0))

        r, q = both(scenario)
        assert q == r
        assert q[0] >= 2 * 100 * 16


class TestServing:
    def test_pipelined_sessions_bit_equal_and_isolated(self):
        """Three interleaved pipelined tenants, a predicted-OOM fault
        injected into tA only (``@tA``): tA's ladder runs with tagged
        events, tB and tC stay clean, every answer equals its solo run
        and the reference's."""
        def scenario(p):
            env = p.env(4)
            solo = {s: pipe_fn(p, env, s)() for s in (11, 22, 33)}
            p.rec.install_faults("shuffle.recv_guard::1=predicted@tA")
            sched = p.sched.QueryScheduler(env, policy="fair")
            a = sched.submit("tA", pipe_fn(p, env, 11, label="tA"))
            b = sched.submit("tB", pipe_fn(p, env, 22))
            c = sched.submit("tC", pipe_fn(p, env, 33))
            sched.run(raise_errors=True)
            for sess, seed in ((a, 11), (b, 22), (c, 33)):
                same_rows(solo[seed], sess.result)
            assert all(e[3] == "tA" for e in p.events())
            return ({s.name: s.result for s in (a, b, c)},
                    p.events(a.recovery_events()), b.recovery_events(),
                    c.recovery_events(),
                    [s.outcome() for s in (a, b, c)])

        r, q = both(scenario)
        for name in r[0]:
            same_rows(r[0][name], q[0][name])
        assert q[1:] == r[1:]
        assert len(q[1]) >= 1 and q[2] == q[3] == []

    def test_scheduler_reusable_across_runs(self):
        """``run()`` is re-enterable: a finished run's abort latch does
        not fail sessions submitted for the next."""
        def scenario(p):
            sched = p.sched.QueryScheduler(p.env(1))
            a = sched.submit("a", lambda: 1)
            sched.run(raise_errors=True)
            b = sched.submit("b", lambda: 2)
            sched.run(raise_errors=True)
            return (a.state, a.result), (b.state, b.result)

        r, q = both(scenario)
        assert q == r == (("done", 1), ("done", 2))

    def test_scheduler_exclusive(self):
        def scenario(p):
            seen = {}

            def inner():
                seen["err"] = typed(
                    lambda: p.sched.QueryScheduler(p.env(1)).run())

            sched = p.sched.QueryScheduler(p.env(1))
            sched.submit("t0", inner)
            sched.run(raise_errors=True)
            return seen

        r, q = both(scenario)
        assert q == r == {"err": "InvalidError"}

    def test_failed_session_does_not_poison_others(self):
        def scenario(p):
            sched = p.sched.QueryScheduler(p.env(1), policy="fair")
            bad = sched.submit("bad", lambda: (_ for _ in ()).throw(
                RuntimeError("boom")))
            good = sched.submit("good", lambda: 7)
            sessions = sched.run()
            assert "boom" in str(bad.error)
            return (bad.state, bad.outcome(), good.state, good.result,
                    len(sessions), _stats(sched))

        r, q = both(scenario)
        assert q == r
        assert q[:5] == ("failed", "failed_untyped", "done", 7, 2)


class TestRecoverySessionPlumbing:
    def test_session_fault_targeting(self):
        def scenario(p):
            p.rec.install_faults("shuffle.recv_guard::1=predicted@tB")
            p.rec.set_session("tA", 0)
            got = [p.rec.probe("shuffle.recv_guard")]
            p.rec.set_session("tB", 1)
            # nth counts tB's own probes: this is tB's first
            got.append(p.rec.probe("shuffle.recv_guard"))
            got.append(p.rec.probe("shuffle.recv_guard"))
            p.rec.set_session(None, None)
            got.append(p.rec.probe("shuffle.recv_guard"))
            return got

        r, q = both(scenario)
        assert q == r
        assert q[0][0] is None and q[1][0] == "predicted"

    def test_session_nth_counts_per_session(self):
        def scenario(p):
            got = []
            p.rec.install_faults("ckpt.write::2=kill@t0")
            p.rec.set_session("t1", 1)
            got += [p.rec.probe("ckpt.write") for _ in range(5)]
            p.rec.set_session("t0", 0)
            got.append(p.rec.probe("ckpt.write"))      # t0's first
            p.rec.install_faults("ckpt.write::2=corrupt@t0")
            p.rec.set_session("t1", 1)
            got += [p.rec.probe("ckpt.write") for _ in range(3)]
            p.rec.set_session("t0", 0)
            got += [p.rec.probe("ckpt.write") for _ in range(3)]
            p.rec.set_session(None, None)
            return got

        r, q = both(scenario)
        assert q == r
        assert [k for k, _ in q[-3:]] == [None, "corrupt", None]

    def test_grammar_rejects_bad_specs(self):
        def scenario(p):
            errs = [typed(lambda: p.rec.install_faults(
                "ckpt.write::2=nosuch@t0")),
                    typed(lambda: p.rec.install_faults(
                        "nosuch.site::2=kill@t0"))]
            p.rec.install_faults("")
            return errs

        r, q = both(scenario)
        assert q == r == ["ValueError", "ValueError"]

    def test_consensus_namespace_identity_single_process(self):
        def scenario(p):
            env = p.env(4)
            mesh = env.mesh if p.name == "ref" else env
            p.rec.set_session("tA", 7)
            got = [p.rec._session_ns(),
                   int(p.rec.consensus_code(mesh, p.st.Code.OK)),
                   int(p.rec.consensus_code(mesh,
                                            p.st.Code.SpillRequired)),
                   p.rec.count_consensus(mesh, 3),
                   p.rec.preempt_consensus(mesh, 5)]
            p.rec.set_session(None, None)
            got.append(p.rec._session_ns())
            return got

        r, q = both(scenario)
        assert q == r
        assert q[0] == 8 and q[3] == 3 and q[4] == 5 and q[5] == 0

    def test_events_tagged_and_filtered(self):
        def scenario(p):
            p.rec.set_session("tX", 3)
            p.rec._record("shuffle.recv_guard", "predicted", "test")
            p.rec.set_session(None, None)
            p.rec._record("shuffle.recv_guard", "predicted", "test")
            evs = p.rec.recovery_events()
            assert p.rec.events_for_session("tX") == [evs[0]]
            return evs

        r, q = both(scenario)
        assert q == r
        assert q[0]["session"] == "tX" and "session" not in q[1]

    def test_checkpoint_stage_namespacing(self, monkeypatch, tmp_path):
        def scenario(p):
            monkeypatch.setenv(p.var("CKPT_DIR"), str(tmp_path / p.name))
            env = p.env(1)
            p.ckpt.reset_stages()
            try:
                p.rec.set_session("tA", 0)
                sa0 = p.ckpt.open_stage(env, "pipelined_join", "tok")
                sa1 = p.ckpt.open_stage(env, "pipelined_join", "tok")
                p.rec.set_session("tB", 1)
                sb0 = p.ckpt.open_stage(env, "pipelined_join", "tok")
                p.rec.set_session(None, None)
                sn0 = p.ckpt.open_stage(env, "pipelined_join", "tok")
                p.ckpt.reset_session_stages("tA")
                p.rec.set_session("tA", 0)
                sa2 = p.ckpt.open_stage(env, "pipelined_join", "tok")
                p.rec.set_session(None, None)
                return [os.path.basename(s.dir)
                        for s in (sa0, sa1, sb0, sn0, sa2)]
            finally:
                p.ckpt.reset_stages()

        r, q = both(scenario)
        assert q == r == ["stage000-tA.pipelined_join",
                          "stage001-tA.pipelined_join",
                          "stage000-tB.pipelined_join",
                          "stage000-pipelined_join",
                          "stage000-tA.pipelined_join"]


# ---------------------------------------------------------------------------
# a deferred join → groupby under groupby.device_oom, untagged and in a
# scheduler session
# ---------------------------------------------------------------------------

OOM_SPECS = {
    "sum": ([("a", "sum")], "groupby.device_oom::1=device_oom"),
    "mean_max": ([("a", "mean"), ("b", "max")],
                 "groupby.device_oom::1=device_oom"),
    "escalate_4_16": ([("a", "sum"), ("b", "sum")],
                      "groupby.device_oom::1=device_oom,"
                      "groupby.device_oom::2=device_oom"),
}


@pytest.mark.parametrize("tagged", [False, True],
                         ids=["untagged", "session"])
@pytest.mark.parametrize("case", sorted(OOM_SPECS))
def test_join_groupby_device_oom(case, tagged):
    """The inner join stays deferred, ``groupby_aggregate`` on its key
    takes the fused pushdown, and ``groupby.device_oom`` fires in it: the
    ladder retries through the chunked route.  Both packages record the
    same events (inside a session, tagged with it; the spec then names
    the session) and give bit-equal values."""
    aggs, spec = OOM_SPECS[case]
    rng = np.random.default_rng(5)
    n = 3000
    lcols = {"k": rng.integers(0, 400, n).astype(np.int64),
             "a": rng.integers(0, 1000, n).astype(np.int64)}
    rcols = {"k": rng.integers(0, 400, n).astype(np.int64),
             "b": rng.integers(0, 1000, n).astype(np.int64)}

    def scenario(p):
        env = p.env(4)
        lt, rt = p.table(lcols, env), p.table(rcols, env)
        p.rec.install_faults(spec + ("@t0" if tagged else ""))

        def query():
            j = p.join(lt, rt, "k", "k", how="inner")
            return p.rows(p.groupby(j, "k", aggs))

        if not tagged:
            out = query()
        else:
            sched = p.sched.QueryScheduler(env, policy="fifo")
            s = sched.submit("t0", query)
            sched.run(raise_errors=True)
            out = s.result
            assert p.events(s.recovery_events()) == p.events()
        return out, p.events()

    (r_out, r_ev), (q_out, q_ev) = both(scenario)
    same_rows(r_out, q_out)
    assert q_ev == r_ev
    assert ("groupby", "device_oom", "retry_chunks_4",
            "t0" if tagged else None) in q_ev
    if case == "escalate_4_16":
        assert ("groupby", "device_oom", "retry_chunks_16",
                "t0" if tagged else None) in q_ev
