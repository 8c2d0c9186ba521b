"""Preemption, requeue, admission deadlines and the elastic resize of
cylon_tpu_torch's serving tier (``exec/scheduler.py``, ``exec/fleet.py``,
the scheduler's drain in ``exec/checkpoint``) against cylon_tpu's,
mirroring the non-slow cases of tests/test_fleet.py and the two
scheduler cases of tests/test_checkpoint.py::TestPreemptGrace.

Each scenario runs in both packages on the same inputs, each package
under its own checkpoint root.  Held equal: results (bit for bit),
session states and outcome buckets, ``stats()`` counters (without the
reference's compile block), recovery events, stage directory names,
the resize breadcrumb's fields (all but the pid) and the typed errors.
Not mirrored here: the slow harnesses.  ``scripts/chaos_soak.py --fleet``
has its port, ``python -m cylon_tpu_torch.exec.chaos_soak --fleet``,
held by tests/test_torch_chaos_soak.py (slow-marked, as the reference's);
``bench_serving`` with 64 preemptive tenants waits for the port's
benchmark, and its card counterparts are ``chip_smoke.serve_small`` (the
resize relaunch, the kill inside a session) and ``serve_path``'s preempt
leg."""

import json
import os
import time

import numpy as np
import pytest

from cylon_tpu.exec import preempt as rpre
from cylon_tpu_torch.exec import preempt as ppre
from test_torch_scheduler import (BOTH, _clean,  # noqa: F401
                                  _release_compiled_programs, _stats, both,
                                  pipe_fn, same_rows, typed)

PRE = {"ref": rpre, "port": ppre}


def _arm(monkeypatch, tmp_path, p) -> str:
    root = str(tmp_path / p.name)
    monkeypatch.setenv(p.var("CKPT_DIR"), root)
    p.ckpt.reset_stages()
    p.ckpt.reset_stats()
    return root


def _stages(root: str) -> list:
    rank0 = os.path.join(root, "rank0")
    return sorted(os.listdir(rank0)) if os.path.isdir(rank0) else []


class TestPreemption:
    def test_preempt_requeue_resume_bit_equal(self, monkeypatch, tmp_path):
        """tB (priority 5) arrives while tA runs and preempts it at its
        next checkpoint boundary; tA requeues, fast-forwards its
        committed pieces, is preempted again by tB2 after committing new
        ones, and finishes bit-equal to its solo run; tC's log stays
        empty."""
        def scenario(p):
            env = p.env(4)
            solo_a = pipe_fn(p, env, 11, n=1800, chunks=6)()
            solo_b = pipe_fn(p, env, 22, n=900, chunks=2)()
            solo_c = pipe_fn(p, env, 33, n=1800, chunks=6)()
            root = _arm(monkeypatch, tmp_path, p)
            sched = p.sched.QueryScheduler(env, policy="priority",
                                           max_concurrency=1)
            runs = {"n": 0}
            fn_a = pipe_fn(p, env, 11, n=1800, chunks=6)

            def tenant_a():
                runs["n"] += 1
                if runs["n"] == 1:
                    sched.submit("tB", pipe_fn(p, env, 22, n=900,
                                               chunks=2), priority=5)
                elif runs["n"] == 2:
                    sched.submit("tB2", pipe_fn(p, env, 22, n=900,
                                                chunks=2), priority=5)
                return fn_a()

            a = sched.submit("tA", tenant_a)
            c = sched.submit("tC", pipe_fn(p, env, 33, n=1800, chunks=6))
            sched.run()
            b = next(s for s in sched.sessions if s.name == "tB")
            b2 = next(s for s in sched.sessions if s.name == "tB2")
            assert a.state == "done" and a.error is None, a.error
            same_rows(solo_a, a.result)
            same_rows(solo_b, b.result)
            same_rows(solo_b, b2.result)
            same_rows(solo_c, c.result)
            ff = p.ckpt.stats()["resume_fast_forwarded_pieces"]
            return (a.result, a.preemptions, a.requeues, runs["n"], ff > 0,
                    c.recovery_events(), a.outcome(), _stats(sched),
                    [s.name for s in sched.sessions], _stages(root))

        r, q = both(scenario)
        same_rows(r[0], q[0])
        assert q[1:] == r[1:]
        assert q[1:7] == (2, 2, 3, True, [], "preempted_requeued")
        assert q[7]["outcomes"] == {"preempted_requeued": 1,
                                    "completed": 3}
        assert "stage000-tA.pipelined_join" in q[9]

    def test_no_progress_guard_and_budget(self):
        """A tenant that committed nothing since its last preemption is
        not preempted again; a spent budget, a draining session and an
        equal-ranked candidate exclude it too."""
        def scenario(p):
            S = p.session.QuerySession
            sched = p.sched.QueryScheduler(p.env(1), policy="priority")
            cand = S("hi", lambda: None, 5, priority=9)
            v = S("lo", lambda: None, 0, priority=0)

            def pick(c, vs):
                got = sched._pick_victim(c, vs)
                return None if got is None else got.name

            got = [pick(cand, [v])]
            v.preemptions, v.pieces_committed, v._progress_mark = 1, 3, 3
            got.append(pick(cand, [v]))
            v.pieces_committed = 4
            got.append(pick(cand, [v]))
            v.preemptions = v.preempt_budget
            got.append(pick(cand, [v]))
            v.preemptions, v._drain_mode = 0, "preempt"
            got.append(pick(cand, [v]))
            got.append(pick(cand, [S("peer", lambda: None, 1,
                                     priority=9)]))
            return got

        r, q = both(scenario)
        assert q == r == ["lo", None, "lo", None, None, None]

    def test_requeue_overflow_typed(self, monkeypatch, tmp_path):
        """With requeue capacity 0 a drained tenant fails with
        ``RequeueOverflowError``, its ``ResumableAbort`` on
        ``__cause__``."""
        def scenario(p):
            env = p.env(4)
            _arm(monkeypatch, tmp_path, p)
            sched = p.sched.QueryScheduler(env, policy="priority",
                                           max_concurrency=1,
                                           requeue_capacity=0)
            runs = {"n": 0}
            fn_a = pipe_fn(p, env, 11, n=1800, chunks=6)

            def tenant_a():
                runs["n"] += 1
                if runs["n"] == 1:
                    sched.submit("tB", pipe_fn(p, env, 22, n=900,
                                               chunks=2), priority=5)
                return fn_a()

            a = sched.submit("tA", tenant_a)
            sched.run()
            b = next(s for s in sched.sessions if s.name == "tB")
            assert isinstance(a.error, p.st.RequeueOverflowError)
            assert isinstance(a.error.__cause__, p.st.ResumableAbort)
            assert a.error.session == "tA"
            return (b.state, b.error, a.state, a.outcome(),
                    type(a.error).__name__, a.error.kind, _stats(sched))

        r, q = both(scenario)
        assert q == r
        assert q[:6] == ("done", None, "failed", "failed_typed",
                         "RequeueOverflowError", "requeue_overflow")
        assert q[6]["requeue_overflows"] == 1

    def test_unarmed_happy_path_adds_nothing(self):
        """No priorities, no resize controller, checkpoints unarmed: no
        checkpoint counter moves, no recovery event, no preemption."""
        def scenario(p):
            env = p.env(4)
            assert not p.ckpt.enabled()
            sched = p.sched.QueryScheduler(env, policy="fair")
            sched.submit("t0", pipe_fn(p, env, 11))
            sched.submit("t1", pipe_fn(p, env, 22))
            sched.run(raise_errors=True)
            assert all(v == 0 for v in p.ckpt.stats().values())
            return (p.rec.recovery_events(),
                    _stats(sched),
                    [s.result for s in sched.sessions])

        r, q = both(scenario)
        assert q[:2] == r[:2]
        for a, b in zip(r[2], q[2]):
            same_rows(a, b)
        st = q[1]
        assert q[0] == [] and st["preemptions"] == st["requeues"] == 0
        assert st["fleet_drains"] == 0 and st["resize_target"] is None
        assert st["admission_timeouts"] == 0
        assert st["outcomes"] == {"completed": 2}


class TestAdmissionDeadline:
    def test_admission_timeout_typed(self):
        """A pending session waiting past the deadline fails with
        ``AdmissionTimeoutError`` (its name and wait seconds), its wait
        closed; the running tenant is untouched."""
        def scenario(p):
            def holder():
                for _ in range(12):
                    time.sleep(0.02)
                    p.sched.maybe_yield()
                return "done"

            sched = p.sched.QueryScheduler(p.env(1), policy="fifo",
                                           budget_bytes=1000,
                                           admission_timeout_s=0.05)
            a = sched.submit("tA", holder, footprint_bytes=600)
            b = sched.submit("tB", lambda: 1, footprint_bytes=600)
            sched.run()
            assert isinstance(b.error, p.st.AdmissionTimeoutError)
            assert b.error.waited_s > 0.05 and b.admission_wait_s > 0
            st = sched.stats()
            # the deadline's counters (the loop's turns and the process's
            # memory counters vary with the host's load)
            return (a.state, a.result, b.state, b.error.kind,
                    b.error.session, b._wait_mark, b.outcome(),
                    {k: st[k] for k in (
                        "sessions", "completed", "failed", "admission_waits",
                        "forced_admissions", "admission_timeouts",
                        "outcomes")})

        r, q = both(scenario)
        assert q == r
        assert q[:7] == ("done", "done", "failed", "admission_timeout",
                         "tB", None, "failed_typed")
        assert q[7]["admission_timeouts"] == 1
        assert q[7]["outcomes"] == {"completed": 1, "failed_typed": 1}

    def test_admission_timeout_env_knob(self, monkeypatch):
        """The ``<prefix>ADMISSION_TIMEOUT_S`` switch arms the same
        deadline."""
        def scenario(p):
            sched = p.sched.QueryScheduler(p.env(1))
            got = []
            for raw in ("0.04", "bogus", "0"):
                monkeypatch.setenv(p.var("ADMISSION_TIMEOUT_S"), raw)
                got.append(sched._admission_timeout())
            monkeypatch.delenv(p.var("ADMISSION_TIMEOUT_S"))
            got.append(sched._admission_timeout())
            return got

        r, q = both(scenario)
        assert q == r
        assert q[0] == pytest.approx(0.04) and q[1:] == [None] * 3


class TestResizeController:
    def test_rejects_bad_target(self):
        def scenario(p):
            return typed(lambda: p.fleet.ResizeController(p.env(1),
                                                          target_world=0))

        r, q = both(scenario)
        assert q == r == "InvalidError"

    def test_gated_on_checkpoint(self):
        """Without checkpoints the controller never engages."""
        def scenario(p):
            assert not p.ckpt.enabled()
            ctrl = p.fleet.ResizeController(p.env(1), target_world=2,
                                            queue_depth_high=0,
                                            min_committed_pieces=0)
            sched = p.sched.QueryScheduler(p.env(1), fleet=ctrl)
            return (ctrl.maybe_resize(sched), ctrl.engaged,
                    sched._fleet_drain)

        r, q = both(scenario)
        assert q == r == (False, False, False)

    def test_pressure_triggers_and_breadcrumb(self, monkeypatch, tmp_path):
        """Queue depth and committed progress engage the fleet drain:
        the running tenant is flagged, the target latches and the
        ``FLEET_RESIZE.json`` breadcrumb lands in the checkpoint root."""
        def scenario(p):
            root = _arm(monkeypatch, tmp_path, p)
            ctrl = p.fleet.ResizeController(p.env(1), target_world=2,
                                            queue_depth_high=1,
                                            min_committed_pieces=1)
            sched = p.sched.QueryScheduler(p.env(1), fleet=ctrl)
            run = sched.submit("hot", lambda: None)
            run.state, run.pieces_committed = "running", 3
            queued = sched.submit("cold", lambda: None)
            got = [ctrl.should_resize(sched), ctrl.maybe_resize(sched),
                   ctrl.engaged, sched._fleet_drain, sched.resize_target,
                   run._drain_mode, queued._drain_mode]
            with open(os.path.join(root, "FLEET_RESIZE.json"),
                      encoding="utf-8") as f:
                crumb = json.load(f)
            assert crumb.pop("pid") == os.getpid()
            # the ledger's balance is this process's: whatever earlier
            # cases left registered in each package
            assert crumb.pop("ledger_bytes") == p.mem.stats()["ledger_bytes"]
            assert crumb.pop("ledger_frac") == 0.0
            got += [crumb, sched.stats()["fleet_drains"],
                    ctrl.maybe_resize(sched)]
            return got

        r, q = both(scenario)
        assert q == r
        assert q[:7] == [True, True, True, True, 2, "fleet", None]
        assert q[7] == {"target_world": 2, "from_world": 1,
                        "queue_depth": 1, "pieces_committed": 3}
        assert q[8:] == [1, False]

    def test_min_committed_guard(self, monkeypatch, tmp_path):
        def scenario(p):
            _arm(monkeypatch, tmp_path, p)
            ctrl = p.fleet.ResizeController(p.env(1), target_world=2,
                                            queue_depth_high=0,
                                            min_committed_pieces=5)
            sched = p.sched.QueryScheduler(p.env(1), fleet=ctrl)
            return ctrl.should_resize(sched), ctrl.maybe_resize(sched)

        r, q = both(scenario)
        assert q == r == (False, False)

    def test_fleet_drain_resume_bit_equal(self, monkeypatch, tmp_path):
        """The controller engages mid-traffic, every tenant ends done or
        drained-resumable (none failed typed), and a resumed scheduler
        pass finishes every tenant bit-equal with fast-forwarded
        pieces."""
        def scenario(p):
            env = p.env(4)
            seeds = (11, 22, 33)
            solos = {s: pipe_fn(p, env, s, n=1800, chunks=6)()
                     for s in seeds}
            root = _arm(monkeypatch, tmp_path, p)
            ctrl = p.fleet.ResizeController(env, target_world=2,
                                            queue_depth_high=2)
            sched = p.sched.QueryScheduler(env, policy="fifo",
                                           max_concurrency=1, fleet=ctrl)
            for i, s in enumerate(seeds):
                sched.submit(f"t{i}", pipe_fn(p, env, s, n=1800, chunks=6))
            sched.run()
            first = (sched.resize_target, _stats(sched),
                     [s.outcome() for s in sched.sessions],
                     p.events(), os.path.exists(
                         os.path.join(root, "FLEET_RESIZE.json")))
            monkeypatch.setenv(p.var("RESUME"), "1")
            p.ckpt.reset_stages()
            p.ckpt.reset_stats()
            sched2 = p.sched.QueryScheduler(env, policy="fifo",
                                            max_concurrency=1)
            for i, s in enumerate(seeds):
                sched2.submit(f"t{i}", pipe_fn(p, env, s, n=1800, chunks=6))
            sched2.run(raise_errors=True)
            for i, s in enumerate(seeds):
                same_rows(solos[s], sched2.sessions[i].result)
            monkeypatch.delenv(p.var("RESUME"))
            return (first, p.ckpt.stats()["resume_fast_forwarded_pieces"],
                    _stages(root))

        r, q = both(scenario)
        assert q == r
        (target, st, outcomes, _, crumb), ff, _ = q
        assert target == 2 and crumb and ff > 0
        assert st["outcomes"].get("failed_typed", 0) == 0
        assert set(outcomes) <= {"completed", "drained_resumable"}


class TestFamilyHistory:
    def test_note_and_observe_peak(self):
        def scenario(p):
            p.sched.reset_family_history()
            got = [p.sched.observed_peak("mixA")]
            p.sched.note_family_peak("mixA", 200)
            p.sched.note_family_peak("mixA", 150)     # max-update
            got.append(p.sched.observed_peak("mixA"))
            p.sched.note_family_peak("mixA", 500)
            got += [p.sched.observed_peak("mixA"),
                    p.sched.observed_peak(None)]
            return got

        r, q = both(scenario)
        assert q == r == [None, 200, 500, None]

    def test_explain_analyze_family_records_peak(self):
        """``explain_analyze(family=)`` records the run's peak ledger
        bytes for the family: a pipelined join's packed sources are
        ledger registrations, so the peak is above zero in both."""
        def scenario(p):
            env = p.env(4)
            p.sched.reset_family_history()
            p.mem.reset_stats()
            p.obs.explain_analyze(pipe_fn(p, env, 11), family="qpipe",
                                  profile_keys=False)
            peak = p.sched.observed_peak("qpipe")
            assert peak == p.mem.stats()["peak_ledger_bytes"]
            p.sched.reset_family_history()
            return peak > 0

        r, q = both(scenario)
        assert q == r is True


# ---------------------------------------------------------------------------
# the scheduler under a SIGTERM drain (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

@pytest.fixture()
def grace(monkeypatch):
    """Both packages' grace budgets armed and their handlers installed
    (the port's last: a SIGTERM reaches it, and it chains to the
    reference's)."""
    for p in BOTH:
        monkeypatch.setenv(p.var("PREEMPT_GRACE_S"), "30")
    assert rpre.install() and ppre.install()
    yield
    ppre.reset(uninstall=True)
    rpre.reset(uninstall=True)


def _grace_tables(p, env, n):
    rng = np.random.default_rng(42)
    lcols = {"k": rng.integers(0, 250, n).astype(np.int64),
             "a": rng.integers(0, 50, n).astype(np.int64)}
    rcols = {"k": rng.integers(0, 250, n).astype(np.int64),
             "b": rng.integers(0, 50, n).astype(np.int64)}
    return p.table(lcols, env), p.table(rcols, env)


class TestPreemptGrace:
    def test_scheduler_drains_running_tenant(self, monkeypatch, tmp_path,
                                             grace):
        """A SIGTERM from t0's second checkpoint write: t0 drains with a
        typed ResumableAbort at its own boundary, committed state
        durable; every other tenant finished or drained typed too."""
        def scenario(p):
            env = p.env(4)
            _arm(monkeypatch, tmp_path, p)
            for pre in PRE.values():   # one SIGTERM raises both flags
                pre.reset()

            def make_fn():
                def fn():
                    lt, rt = _grace_tables(p, env, 1500)
                    sink = p.sink("k", [("a", "sum")])
                    p.pipe(lt, rt, "k", "k", how="inner", n_chunks=3,
                           sink=sink)
                    return p.rows(sink.finalize())
                return fn

            p.rec.install_faults("ckpt.write::2=term@t0")
            sched = p.sched.QueryScheduler(env, policy="fair",
                                           max_concurrency=2)
            sessions = [sched.submit(f"t{i}", make_fn()) for i in range(3)]
            sched.run()
            assert isinstance(sessions[0].error, p.st.ResumableAbort)
            for s in sessions[1:]:
                assert (s.error is None and s.result is not None) \
                    or isinstance(s.error, p.st.ResumableAbort)
            assert all(s.state in ("done", "failed") for s in sessions)
            assert sched.stats()["resumable_aborts"] >= 1
            assert p.ckpt.stats()["checkpoint_events"] >= 1
            return (sessions[0].outcome(),
                    ("pipelined_join", "preempt", "drain", "t0")
                    in p.events())

        r, q = both(scenario)
        assert q == r == ("drained_resumable", True)

    def test_scheduler_preempt_before_admission(self, monkeypatch,
                                                tmp_path, grace):
        """A notice before anything ran: no session is admitted, every
        pending tenant fails typed with the resume token, counted."""
        def scenario(p):
            root = _arm(monkeypatch, tmp_path, p)

            def fn():
                raise AssertionError("a drained-pending session ran")

            PRE[p.name].request()
            sched = p.sched.QueryScheduler(p.env(4), policy="fifo")
            sessions = [sched.submit(f"t{i}", fn) for i in range(3)]
            sched.run()
            assert all(isinstance(s.error, p.st.ResumableAbort)
                       and s.error.token == os.path.abspath(root)
                       for s in sessions)
            PRE[p.name].reset()
            return (_stats(sched), p.ckpt.stats()["checkpoint_events"],
                    p.events())

        r, q = both(scenario)
        assert q == r
        st, events, evs = q
        assert st["preempt_drained"] == 3 and st["resumable_aborts"] == 3
        assert events == 0
        assert evs == [(f"sched.t{i}", "preempt", "drain_pending", None)
                       for i in range(3)]

