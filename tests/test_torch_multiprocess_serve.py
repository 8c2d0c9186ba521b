"""The serving tier across processes: one gloo world of 2 processes × 2
ranks on the CPU whose schedulers are made to disagree on every vote,
held against one process and against the reference.

This file is both the pytest module and the per-process driver (the
protocol of tests/test_torch_multiprocess.py, whose helpers it uses):

    python tests/test_torch_multiprocess_serve.py <pid> <nproc> <addr> <V> <out.npz>

Every process runs the same scheduler over the same submissions, and each
process is given its own view of what a process sees alone, so that its
local choice differs from its peer's:

* ``fair``: the fair-share clocks (``QuerySession.attributed_s``) of the
  sessions that have run are skewed in opposite directions on the two
  processes, under a concurrency cap of 2 with checkpoints armed: the
  running pick, the preempt victim and the admission pick with a
  requeued tenant pending each differ;
* ``expiry``: process 0's admission deadline is 1 ms, process 1's a
  day: only process 0 sees the waiting session expire;
* ``evict``: process 1 holds 2 MiB more in its ledger: only it wants to
  evict before the admission;
* ``fleet``: process 1's resize controller fires at any ledger fraction,
  process 0's never: only process 1 wants the fleet drain;
* ``family``: only process 0 has an observed peak for the tenant's shape
  family (``scheduler.note_family_peak``), which clamps its footprint
  below the budget, where process 1 charges the declared footprint,
  above it: the clamped footprint is voted.

Each vote is recorded with this process's wish and the agreed value.
The parent checks that every vote differed from a peer's wish at least
once, that both processes took the same agreed sequence, and that every
answer (a pipelined join into a ``GroupBySink``, as rows) equals its
solo run in the port's one-process ``VirtualMeshConfig(4)`` and on the
reference's ``CPUMeshConfig(4)``: integers, bit-equal.  At module level
only torch, numpy and the port are imported.
"""

import json
import os
import sys
import time

import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
for _p in (_ROOT, _HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import cylon_tpu_torch as pct  # noqa: E402
import test_torch_multiprocess as mp  # noqa: E402

#: (seed, rows, pieces) of each tenant of the fair scenario
FAIR = ((11, 1800, 6), (22, 1200, 4), (33, 1800, 6), (44, 900, 3))
#: the vote each scenario forces to diverge
VOTES = ("pick", "preempt", "admit", "expiry", "evict", "fleet",
         "family")


def tenant(ct, env, seed: int, n: int, chunks: int):
    """A TPC-H-shaped pipelined join into a sink (the scheduler tests'
    tenant): its rows."""
    rng = np.random.default_rng(seed)
    n_ord = max(n // 4, 64)
    orders = ct.Table.from_pydict(
        {"o_orderkey": np.arange(n_ord, dtype=np.int64),
         "o_pri": rng.integers(0, 5, n_ord).astype(np.int64)}, env)
    line = ct.Table.from_pydict(
        {"l_orderkey": rng.integers(0, n_ord, n).astype(np.int64),
         "l_qty": rng.integers(1, 51, n).astype(np.int64)}, env)
    sink = ct.GroupBySink("l_orderkey", [("l_qty", "sum")])
    ct.pipelined_join(line, orders, "l_orderkey", "o_orderkey",
                      how="inner", n_chunks=chunks, sink=sink)
    return mp._rows(sink.finalize())


def solo_answers(ct, env) -> dict:
    """Every tenant's answer run alone."""
    return {f"s{seed}": tenant(ct, env, seed, n, c) for seed, n, c in FAIR}


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

class _Taps:
    """Record each scheduler vote as (vote, this process's wish, agreed):
    the scheduler's methods set the vote's name while they run, and the
    consensus calls they make are logged under it."""

    def __init__(self):
        from cylon_tpu_torch.exec import fleet, recovery, scheduler
        self.log: list = []
        self.label = None
        sched = scheduler.QueryScheduler
        for cls, name, label in (
                (sched, "_pick", "pick"), (sched, "_admit_pending", "admit"),
                (sched, "_force_admit", "admit"),
                (sched, "_expire_admissions", "expiry"),
                (sched, "_evict_for", "evict"),
                (sched, "_maybe_preempt", "preempt"),
                (sched, "_admission_footprint", "family"),
                (fleet.ResizeController, "maybe_resize", "fleet")):
            self._label(cls, name, label)
        for name in ("count_consensus", "preempt_consensus",
                     "footprint_consensus"):
            self._vote(recovery, name)

    def _label(self, cls, name, label):
        orig = getattr(cls, name)
        taps = self

        def wrapped(obj, *a, **k):
            prev, taps.label = taps.label, label
            try:
                return orig(obj, *a, **k)
            finally:
                taps.label = prev

        setattr(cls, name, wrapped)

    def _vote(self, mod, name):
        orig = getattr(mod, name)
        taps = self

        def wrapped(env, value):
            got = orig(env, value)
            if taps.label is not None:
                taps.log.append((taps.label, int(value), int(got)))
            return got

        setattr(mod, name, wrapped)


def _skew_fair_clocks(pid: int) -> None:
    """The fair-share clocks of sessions that ran, skewed one way on
    process 0 and the other on process 1 (a session that never ran keeps
    0 on both, as the reference relies on)."""
    from cylon_tpu_torch.exec.session import QuerySession
    orig = QuerySession.attributed_s

    def skewed(self):
        a = orig(self)
        if self.service_s <= 0:
            return a
        return a + 1e3 * ((self.ordinal + 1) if pid else (10 - self.ordinal))

    QuerySession.attributed_s = skewed


def scenario_fair(ct, env, pid, out):
    from cylon_tpu_torch.exec import QueryScheduler
    _skew_fair_clocks(pid)
    sched = QueryScheduler(env, policy="fair", max_concurrency=2)
    sess = [sched.submit(f"t{i}", lambda s=s, n=n, c=c: tenant(
        ct, env, s, n, c)) for i, (s, n, c) in enumerate(FAIR)]
    grants = []
    orig = sched._grant_slice
    sched._grant_slice = lambda s: (grants.append(s.ordinal), orig(s))[1]
    sched.run(raise_errors=True)
    for s, (seed, _n, _c) in zip(sess, FAIR):
        out[f"fair|s{seed}"] = s.result
    st = sched.stats()
    out["fair|grants"] = np.asarray(grants, np.int64)
    out["fair|counts"] = np.asarray(
        [st["preemptions"], st["requeues"], st["completed"]], np.int64)


def scenario_expiry(ct, env, pid, out):
    from cylon_tpu_torch.exec import QueryScheduler, scheduler

    def holder():
        for _ in range(6):
            time.sleep(0.01)
            scheduler.maybe_yield()
        return tenant(ct, env, *FAIR[1])

    sched = QueryScheduler(env, policy="fifo", budget_bytes=1000,
                           admission_timeout_s=0.001 if pid == 0 else 86400)
    a = sched.submit("tA", holder, footprint_bytes=600)
    b = sched.submit("tB", lambda: 1, footprint_bytes=600)
    sched.run()
    out["expiry|s22"] = a.result
    out["expiry|b"] = np.asarray([b.state, type(b.error).__name__])


def scenario_evict(ct, env, pid, out):
    import torch
    from cylon_tpu_torch.exec import QueryScheduler, memory
    from cylon_tpu_torch.parallel import transport
    warm = memory.register("warm", (torch.zeros(1 << 16, dtype=torch.int64),),
                           spillable=True)
    bal = transport.allgather_array(
        np.asarray([memory.ledger().balance()], np.int64), "test.balance")
    pad = memory.register("pad", (torch.zeros(1 << 18, dtype=torch.int64),)) \
        if pid == 1 else None
    fp = 1 << 16
    sched = QueryScheduler(env, policy="fifo",
                           budget_bytes=int(bal.max()) + fp + 4096)
    t = sched.submit("t0", lambda: tenant(ct, env, *FAIR[0]),
                     footprint_bytes=fp)
    sched.run(raise_errors=True)
    out["evict|s11"] = t.result
    out["evict|evicted"] = np.asarray([warm.spilled,
                                       sched.stats()["scheduler_evictions"]])
    memory.release(warm)
    memory.release(pad)


def scenario_family(ct, env, pid, out):
    from cylon_tpu_torch.exec import QueryScheduler, scheduler
    scheduler.reset_family_history()
    if pid == 0:
        # 100 B observed x the 1.5 safety factor fits the 1000 B budget;
        # the declared 5000 B does not
        scheduler.note_family_peak("fam", 100)
    sched = QueryScheduler(env, policy="fifo", budget_bytes=1000)
    t = sched.submit("t0", lambda: tenant(ct, env, *FAIR[1]),
                     footprint_bytes=5000, shape_family="fam")
    sched.run(raise_errors=True)
    st = sched.stats()
    out["family|s22"] = t.result
    out["family|admission"] = np.asarray(
        [st["forced_admissions"], st["admission_waits"]], np.int64)
    scheduler.reset_family_history()


def scenario_fleet(ct, env, pid, out, root):
    from cylon_tpu_torch.exec import QueryScheduler, checkpoint
    from cylon_tpu_torch.exec.fleet import ResizeController
    ctrl = ResizeController(env, target_world=2, queue_depth_high=None,
                            ledger_frac_high=0.0 if pid == 1 else None)
    sched = QueryScheduler(env, policy="fifo", max_concurrency=1,
                           fleet=ctrl)
    for i, (s, n, c) in enumerate(FAIR[:3]):
        sched.submit(f"t{i}", lambda s=s, n=n, c=c: tenant(ct, env, s, n, c))
    sched.run()
    out["fleet|first"] = np.asarray(
        [sched.resize_target or 0] + [s.state == "done"
                                      for s in sched.sessions], np.int64)
    with open(os.path.join(root, "FLEET_RESIZE.json"),
              encoding="utf-8") as f:
        out["fleet|crumb"] = np.asarray([json.load(f)["target_world"]])
    # the relaunch: every tenant resumes past its committed pieces
    os.environ["CYLON_TPU_TORCH_RESUME"] = "1"
    checkpoint.reset_stages()
    checkpoint.reset_stats()
    sched = QueryScheduler(env, policy="fifo", max_concurrency=1)
    sess = [sched.submit(f"t{i}", lambda s=s, n=n, c=c: tenant(
        ct, env, s, n, c)) for i, (s, n, c) in enumerate(FAIR[:3])]
    sched.run(raise_errors=True)
    del os.environ["CYLON_TPU_TORCH_RESUME"]
    for s, (seed, _n, _c) in zip(sess, FAIR):
        out[f"fleet|s{seed}"] = s.result
    out["fleet|ffwd"] = np.asarray(
        [checkpoint.stats()["resume_fast_forwarded_pieces"]])


def _driver(argv) -> None:
    pid, nproc, addr, v, path = (int(argv[0]), int(argv[1]), argv[2],
                                 int(argv[3]), argv[4])
    from cylon_tpu_torch.exec import checkpoint
    env = pct.CylonEnv(pct.DistributedConfig(addr, pid, nproc,
                                             local_world=v, timeout_s=60),
                       device="cpu")
    ct = mp.port_api(env.world_size)
    taps = _Taps()
    out = {}
    base = os.environ["TORCH_MP_CKPT"]
    for name in ("family", "expiry", "evict", "fleet", "fair"):
        env.barrier()
        armed = name in ("fleet", "fair")
        if armed:
            os.environ["CYLON_TPU_TORCH_CKPT_DIR"] = os.path.join(base, name)
        checkpoint.reset_stages()
        fn = globals()["scenario_" + name]
        if name == "fleet":
            fn(ct, env, pid, out, os.path.join(base, name))
        else:
            fn(ct, env, pid, out)
        os.environ.pop("CYLON_TPU_TORCH_CKPT_DIR", None)
    mp._json(out, "votes", taps.log)
    from cylon_tpu_torch.parallel import transport
    out["device_share"] = np.asarray([transport.current().device_share])
    np.savez(path, **out)
    env.finalize()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

_CACHE: dict = {}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if "res" not in _CACHE:
        tmp = tmp_path_factory.mktemp("mpserve")
        handle = mp.start(tmp, 2, 2, extra_env={
            "TORCH_MP_CKPT": str(tmp), "CYLON_TPU_TORCH_WATCHDOG_S": "60",
            "CYLON_TPU_TORCH_BROADCAST_JOIN_ROWS": "0"},
            driver=os.path.abspath(__file__))
        try:
            _CACHE["virtual"] = solo_answers(
                mp.port_api(4), pct.CylonEnv(pct.VirtualMeshConfig(4),
                                             device="cpu"))
            _CACHE["reference"] = _reference()
        except BaseException:
            for p in handle[0]:
                p.kill()
            raise
        codes, outs, res = mp.finish(handle)
        mp._assert_ok(codes, outs)
        _CACHE["res"] = res
    return _CACHE["res"]


def _reference() -> dict:
    import jax
    import cylon_tpu as rct
    from cylon_tpu import config as rconfig
    from cylon_tpu.ctx.context import CPUMeshConfig
    prev = rconfig.BROADCAST_JOIN_ROWS
    rconfig.BROADCAST_JOIN_ROWS = 0
    try:
        return solo_answers(mp.reference_api(), rct.CylonEnv(
            config=CPUMeshConfig(world_size=4)))
    finally:
        rconfig.BROADCAST_JOIN_ROWS = prev
        jax.clear_caches()


@pytest.fixture(autouse=True)
def _routes(monkeypatch):
    from cylon_tpu_torch import config as pconfig
    monkeypatch.setattr(pconfig, "BROADCAST_JOIN_ROWS", 0)


@pytest.mark.parametrize("vote", VOTES)
def test_vote_diverges_and_agrees(world, vote):
    """The vote was taken with different wishes at least once, and both
    processes took the same agreed values, in the same order."""
    logs = [[e for e in mp._load([r], "votes")[0] if e[0] == vote]
            for r in world]
    assert logs[0], f"no {vote} vote was taken"
    assert [e[2] for e in logs[0]] == [e[2] for e in logs[1]]
    assert len(logs[0]) == len(logs[1])
    assert any(a[1] != b[1] for a, b in zip(*logs)), logs


@pytest.mark.parametrize("scenario", ("fair", "expiry", "evict", "fleet",
                                      "family"))
def test_answers_equal_solo(world, scenario):
    """Every tenant's answer on both processes equals its solo run, in
    one process and on the reference."""
    keys = sorted(k for k in world[0] if k.startswith(scenario + "|s"))
    assert keys
    for k in keys:
        want = _CACHE["virtual"][k.split("|")[1]]
        np.testing.assert_array_equal(want, _CACHE["reference"][
            k.split("|")[1]])
        for r in world:
            np.testing.assert_array_equal(r[k], want, err_msg=k)


def test_outcomes_agree(world):
    """Both processes saw the same schedule: the fair grants, the
    preemptions and requeues, the expired session, the eviction and the
    fleet drain with its resume."""
    a, b = world
    for k in ("fair|grants", "fair|counts", "expiry|b", "evict|evicted",
              "fleet|first", "fleet|crumb", "fleet|ffwd",
              "family|admission"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(a["fair|counts"][0]) >= 1 and int(a["fair|counts"][1]) >= 1
    assert a["expiry|b"].tolist() == ["failed", "AdmissionTimeoutError"]
    assert a["evict|evicted"].tolist() == [1, 1]
    assert a["fleet|first"][0] == 2 and int(a["fleet|crumb"][0]) == 2
    assert int(a["fleet|ffwd"][0]) > 0
    # the voted footprint is the declared one: neither process fits it,
    # both run the tenant by the serial force-admission
    assert a["family|admission"].tolist()[0] == 1


def test_processes_sharing_a_device_split_its_budget(world, monkeypatch):
    """The set-up's allgather counts the processes on one device (both,
    here); a card's memory is split among them, and the budget switch
    still overrides the split."""
    import types
    import torch
    from cylon_tpu_torch import config as pconfig
    from cylon_tpu_torch.exec import memory
    from cylon_tpu_torch.parallel import transport
    assert [int(r["device_share"][0]) for r in world] == [2, 2]
    env = types.SimpleNamespace(on_cuda=True, device="cuda:0",
                                world_size=4)
    proc = types.SimpleNamespace(device_share=2)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            total_memory=80 << 30))
    monkeypatch.setattr(transport, "current",
                        lambda world=None: proc if world == 4 else None)
    monkeypatch.setattr(pconfig, "HBM_BUDGET_BYTES", 0)
    assert memory.budget_bytes(env) == 40 << 30
    proc.device_share = 1
    assert memory.budget_bytes(env) == 80 << 30
    monkeypatch.setattr(pconfig, "HBM_BUDGET_BYTES", 1 << 30)
    assert memory.budget_bytes(env) == 1 << 30


def test_force_admit_takes_the_agreed_pick(monkeypatch):
    """With nothing running and two requeued tenants pending, the serial
    force-admission starts the session the processes agreed on (a peer
    wished for ordinal 1; this process's own pick is ordinal 0), as the
    admission pick does: the processes' fair-share clocks differ."""
    from cylon_tpu_torch.exec import QueryScheduler, recovery
    env = pct.CylonEnv(pct.VirtualMeshConfig(2), device="cpu")
    sched = QueryScheduler(env, policy="fair", budget_bytes=1)
    sess = [sched.submit(f"t{i}", lambda: None, footprint_bytes=10)
            for i in range(3)]
    for s, clock in zip(sess, (1.0, 2.0, 3.0)):
        s.requeues, s.service_s = 1, clock
    started = []
    monkeypatch.setattr(sched, "_multi", lambda: True)
    monkeypatch.setattr(sched, "_start", started.append)
    monkeypatch.setattr(recovery, "count_consensus",
                        lambda env, wish: max(wish, 1))
    sched._force_admit()
    assert [s.name for s in started] == ["t1"]


def teardown_module():
    if "jax" in sys.modules:
        sys.modules["jax"].clear_caches()


if __name__ == "__main__":
    _driver(sys.argv[1:])
