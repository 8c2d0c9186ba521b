"""The topology tier (cylon_tpu_torch/topo) against the reference's
(cylon_tpu/topo): tests/test_topo.py's fast cases in both packages.

The port runs on ``VirtualMeshConfig(8, device="cpu")`` declared as two
slices of four (``CYLON_TPU_TORCH_SLICES=2``), the reference on its
``CPUMeshConfig(8)`` with ``CYLON_TPU_SLICES=2``; each fixture calls
both packages' ``_reslice()`` before and after.  Every operator's result
on the port's two-hop route is held bit-equal, layout included, to the
port's flat route and to the reference's two-hop route.  The model's
answers, the host arithmetic (hop matrices, blocks, the gateway
capacity, the guard's bytes, each tier's traffic), the plan hash and the
comm matrix's ``tiers`` block equal the reference's; with one slice the
exchange takes no vote and bumps no tier counter.  Inputs are a few
thousand rows from numpy seeds.
"""

from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as rct
from cylon_tpu import config as rconfig
from cylon_tpu.obs import comm as rcomm
from cylon_tpu.relational import groupby_aggregate as r_groupby
from cylon_tpu.relational import join_tables as r_join
from cylon_tpu.relational import sort_table as r_sort
from cylon_tpu.relational.repart import repartition as r_repart
from cylon_tpu.relational.repart import shuffle_table as r_shuffle
from cylon_tpu.relational.setops import set_operation as r_setop
from cylon_tpu.topo import exchange as rtx, model as rtm
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from cylon_tpu_torch.obs import comm as pcomm, metrics as pmetrics
from cylon_tpu_torch.relational.repart import shuffle_table as p_shuffle
from cylon_tpu_torch.status import DataIntegrityError
from cylon_tpu_torch.topo import exchange as ptx, model as ptm
from test_torch_shuffle import assert_layout


def _reslice_both():
    rtm._reslice()
    ptm._reslice()


@pytest.fixture
def alike(monkeypatch):
    """Both packages' broadcast joins off, so every join shuffles."""
    monkeypatch.setattr(rconfig, "BROADCAST_JOIN_ROWS", 0)
    monkeypatch.setattr(pconfig, "BROADCAST_JOIN_ROWS", 0)


@pytest.fixture
def two_tier(env8, monkeypatch, alike):
    """(reference env, port env): W = 8 declared as 2 slices of 4."""
    monkeypatch.setenv("CYLON_TPU_SLICES", "2")
    monkeypatch.setenv("CYLON_TPU_TORCH_SLICES", "2")
    _reslice_both()
    yield env8, pct.CylonEnv(VirtualMeshConfig(8), device="cpu")
    monkeypatch.delenv("CYLON_TPU_SLICES")
    monkeypatch.delenv("CYLON_TPU_TORCH_SLICES")
    _reslice_both()


@pytest.fixture
def one_slice(env8, monkeypatch, alike):
    monkeypatch.delenv("CYLON_TPU_SLICES", raising=False)
    monkeypatch.delenv("CYLON_TPU_TORCH_SLICES", raising=False)
    _reslice_both()
    yield env8, pct.CylonEnv(VirtualMeshConfig(8), device="cpu")
    _reslice_both()


def _frames(n=3000, seed=11, mv=300):
    """Two tables on int64 keys; ``a`` is integer-valued float64, so its
    sums are exact in any association order (the packages' groupbys
    associate float sums differently, tests/test_torch_groupby_sort.py)."""
    rng = np.random.default_rng(seed)
    return (pd.DataFrame({"k": rng.integers(0, mv, n).astype(np.int64),
                          "a": rng.integers(0, 1000, n).astype(
                              np.float64)}),
            pd.DataFrame({"k": rng.integers(0, mv, n).astype(np.int64),
                          "b": rng.integers(0, 99, n).astype(np.int64)}))


def _pair(envs, *dfs):
    """Each frame as a (reference, port) table pair."""
    renv, penv = envs
    return [(rct.Table.from_pandas(d, renv), pct.Table.from_pandas(d, penv))
            for d in dfs]


def assert_same_port(a, b):
    """Two port tables with the same layout, padding included."""
    assert a.column_names == b.column_names
    np.testing.assert_array_equal(a.valid_counts, b.valid_counts)
    assert a.capacity == b.capacity
    for name in a.column_names:
        ca, cb = a.column(name), b.column(name)
        assert ca.data.dtype == cb.data.dtype, name
        assert torch.equal(ca.data, cb.data), name
        assert (ca.validity is None) == (cb.validity is None), name
        if ca.validity is not None:
            assert torch.equal(ca.validity, cb.validity), name


def _flat(fn):
    """``fn()`` with both packages' two-hop route switched off."""
    prev = (rconfig.TOPO_SHUFFLE, pconfig.TOPO_SHUFFLE)
    rconfig.TOPO_SHUFFLE = pconfig.TOPO_SHUFFLE = False
    try:
        return fn()
    finally:
        rconfig.TOPO_SHUFFLE, pconfig.TOPO_SHUFFLE = prev


def _three_way(ref_fn, port_fn):
    """The port's two-hop result held equal to its flat one and to the
    reference's two-hop one; returns the port's two-hop result."""
    n0 = pmetrics.counter("timing_event_exchange.two_hop").value
    hier = port_fn()
    assert pmetrics.counter("timing_event_exchange.two_hop").value > n0
    assert_same_port(hier, _flat(port_fn))
    assert_layout(ref_fn(), hier)
    return hier


# ---------------------------------------------------------------------------
# the tier model
# ---------------------------------------------------------------------------

class TestModel:
    def test_env_declaration(self, two_tier):
        renv, penv = two_tier
        t, rt = penv.topology, renv.topology
        assert (t.n_slices, t.ranks_per_slice, t.source) == (2, 4, "env")
        assert (rt.n_slices, rt.ranks_per_slice, rt.source) == \
            (t.n_slices, t.ranks_per_slice, t.source)
        assert t.slice_of(0) == 0 and t.slice_of(7) == 1
        assert t.slice_ids().tolist() == rt.slice_ids().tolist() == \
            [0, 0, 0, 0, 1, 1, 1, 1]
        np.testing.assert_array_equal(t.cross_mask(), rt.cross_mask())

    @pytest.mark.parametrize("bad", ["3", "16", "1", "0", "nope"])
    def test_bad_declarations_degrade_to_single(self, one_slice,
                                                monkeypatch, bad):
        renv, penv = one_slice
        monkeypatch.setenv("CYLON_TPU_SLICES", bad)
        monkeypatch.setenv("CYLON_TPU_TORCH_SLICES", bad)
        _reslice_both()
        assert penv.topology.n_slices == renv.topology.n_slices == 1
        assert penv.topology.source == "single"
        assert ptm.hier_plan(penv) is None
        assert rtm.hier_plan(renv.mesh) is None

    def test_gateway_and_plan_identity(self, two_tier):
        renv, penv = two_tier
        for d, s in ((6, 0), (6, 1), (0, 1), (7, 0)):
            assert ptm.gateway_of(d, s, 4) == rtm.gateway_of(d, s, 4)
        assert ptm.gateway_of(6, 0, 4) == 2
        p1, p2 = ptm.hier_plan(penv), ptm.hier_plan(penv)
        assert p1 is p2 and p1.route == "hierarchical"
        assert p1.plan_hash() == ptm.TopologyPlan(
            penv.topology, "hierarchical").plan_hash()
        rp = rtm.hier_plan(renv.mesh)
        assert p1.plan_hash() == rp.plan_hash()
        assert p1.summary() == rp.summary()
        flat = ptm.TopologyPlan(penv.topology, "flat")
        assert flat.plan_hash() == rtm.TopologyPlan(
            renv.topology, "flat").plan_hash()

    def test_ranks_per_slice_one_routes_flat(self, one_slice, monkeypatch):
        renv, penv = one_slice
        monkeypatch.setenv("CYLON_TPU_SLICES", "8")
        monkeypatch.setenv("CYLON_TPU_TORCH_SLICES", "8")
        _reslice_both()
        assert penv.topology.n_slices == renv.topology.n_slices == 8
        assert ptm.hier_plan(penv) is None
        assert rtm.hier_plan(renv.mesh) is None

    def test_slice_major_order(self):
        class D:
            def __init__(self, i, s=None):
                self.id = i
                if s is not None:
                    self.slice_index = s

        interleaved = [D(0, 1), D(1, 0), D(2, 1), D(3, 0)]
        ordered = ptm.slice_major_order(interleaved)
        assert [d.id for d in ordered] == [1, 3, 0, 2] == \
            [d.id for d in rtm.slice_major_order(interleaved)]
        plain = [D(i) for i in range(4)]
        assert ptm.slice_major_order(plain) == plain

    def test_host_slices(self):
        hs = ptm.host_slices
        assert hs(["a", "a", "b", "b"], 1) == [0, 0, 1, 1]
        assert hs(["a", "a", "b", "b"], 2) == [0, 0, 0, 0, 1, 1, 1, 1]
        assert hs(["n1", "n2"], 3) == [0, 0, 0, 1, 1, 1]
        assert hs(["a", "a", "a", "a"], 2) is None      # one host
        assert hs(["a", "b", "a", "b"], 1) is None      # not contiguous
        assert hs(["a", "a", "a", "b"], 1) is None      # not uniform
        assert hs([], 1) is None

    def test_whole_process_rule(self, monkeypatch):
        """Across processes the two-hop route needs R % V == 0; one
        process takes any R."""
        monkeypatch.setenv("CYLON_TPU_TORCH_SLICES", "2")
        ptm._reslice()
        try:
            def env(w, p, v):
                return SimpleNamespace(world_size=w, process_count=p,
                                       local_world=v, device="cpu")
            assert ptm.hier_plan(env(8, 4, 2)) is not None   # R 4, V 2
            assert ptm.hier_plan(env(4, 4, 1)) is not None   # R 2, V 1
            assert ptm.hier_plan(env(4, 2, 2)) is not None   # R 2, V 2
            assert ptm.hier_plan(env(12, 3, 4)) is None      # R 6, V 4
            assert ptm.hier_plan(env(12, 4, 3)) is not None  # R 6, V 3
            assert ptm.hier_plan(env(12, 1, 12)) is not None  # one process
        finally:
            monkeypatch.delenv("CYLON_TPU_TORCH_SLICES")
            ptm._reslice()


# ---------------------------------------------------------------------------
# the host arithmetic
# ---------------------------------------------------------------------------

class TestHostMath:
    @pytest.mark.parametrize("seed", [5, 6, 7])
    def test_hop_counts_conservation(self, seed):
        rng = np.random.default_rng(seed)
        c = rng.integers(0, 50, (8, 8)).astype(np.int64)
        c1, c2 = ptx.hop_counts(c, 2)
        r1, r2 = rtx.hop_counts(c, 2)
        np.testing.assert_array_equal(c1, r1)
        np.testing.assert_array_equal(c2, r2)
        sid = np.arange(8) // 4
        assert (c1[sid[:, None] != sid[None, :]] == 0).all()
        loc = np.arange(8) % 4
        assert (c2[loc[:, None] != loc[None, :]] == 0).all()
        assert np.array_equal(c1.sum(axis=1), c.sum(axis=1))
        assert np.array_equal(c1.sum(axis=0), c2.sum(axis=1))
        assert np.array_equal(c2.sum(axis=0), c.sum(axis=0))

    @pytest.mark.parametrize("shape", [(8, 2), (8, 4), (12, 3), (16, 2)])
    def test_schedule_and_traffic_equal_reference(self, shape):
        w, s_ = shape
        rng = np.random.default_rng(w * 31 + s_)
        c = rng.integers(0, 40000, (w, w)).astype(np.int64)
        c[0, -1] = 300000                      # a multi-round cell
        pplan = ptm.TopologyPlan(ptm.Topology(w, s_, "env"), "hierarchical")
        rplan = rtm.TopologyPlan(rtm.Topology(w, s_, "env"), "hierarchical")
        assert pplan.plan_hash() == rplan.plan_hash()
        pp, rp = ptx.prepare(pplan, c), rtx.prepare(rplan, c)
        for f in ("block1", "rounds1", "block2", "rounds2", "cap1"):
            assert getattr(pp, f) == getattr(rp, f), f
        np.testing.assert_array_equal(pp.per_gw, rp.per_gw)
        for h in (pp.c1, pp.c2):
            assert ptx.hop_block(h, int(c.sum()), w, s_) == \
                rtx.hop_block(h, int(c.sum()), w, s_)
        assert ptx.recv_guard_bytes(pplan, pp, 65536, 24) == \
            rtx.recv_guard_bytes(rplan, rp, 65536, 24)
        topo_p = ptm.Topology(w, s_, "env")
        topo_r = rtm.Topology(w, s_, "env")
        for route in ("flat", "two_hop"):
            assert ptx.tier_traffic(topo_p, c, 16, route, prep=pp) == \
                rtx.tier_traffic(topo_r, c, 16, route, prep=rp), route
        assert ptm.tier_split(c, topo_p) == rtm.tier_split(c, topo_r)

    @pytest.mark.parametrize("tamper", ["c1", "c2", "negative"])
    def test_tampered_hop_raises(self, tamper):
        rng = np.random.default_rng(9)
        c = rng.integers(0, 50, (8, 8)).astype(np.int64)
        c1, c2 = ptx.hop_counts(c, 2)
        if tamper == "c1":
            c1[0, 1] += 1
        elif tamper == "c2":
            c2[5, 1] += 1
        else:
            c1[0, 1], c1[0, 2] = -1, c1[0, 2] + c1[0, 1] + 1
        from cylon_tpu_torch.exec import integrity
        with pytest.raises(DataIntegrityError,
                           match="two-hop conservation law violated"):
            integrity.conserve_hops(c, c1, c2)


# ---------------------------------------------------------------------------
# bit/order equality per operator
# ---------------------------------------------------------------------------

class TestEquality:
    def test_shuffle_table(self, two_tier):
        (rl, pl), _ = _pair(two_tier, *_frames())
        _three_way(lambda: r_shuffle(rl, ["k"]),
                   lambda: p_shuffle(pl, ["k"]))

    @pytest.mark.parametrize("how", ["inner", "left", "outer"])
    def test_join(self, two_tier, how):
        (rl, pl), (rr, pr) = _pair(two_tier, *_frames(seed=12))
        _three_way(lambda: r_join(rl, rr, "k", "k", how=how),
                   lambda: pct.join_tables(pl, pr, "k", "k", how=how))

    def test_join_groupby(self, two_tier):
        (rl, pl), (rr, pr) = _pair(two_tier, *_frames(seed=13))
        aggs = [("a", "sum"), ("b", "sum")]
        _three_way(
            lambda: r_groupby(r_join(rl, rr, "k", "k"), "k", aggs),
            lambda: pct.groupby_aggregate(
                pct.join_tables(pl, pr, "k", "k"), "k", aggs))

    def test_sort(self, two_tier):
        (rl, pl), _ = _pair(two_tier, *_frames(seed=14))
        _three_way(lambda: r_sort(rl, "k"), lambda: pct.sort_table(pl, "k"))

    def test_repartition(self, two_tier):
        (rl, pl), _ = _pair(two_tier, *_frames(seed=15))
        _three_way(lambda: r_repart(r_shuffle(rl, ["k"])),
                   lambda: pct.repartition(p_shuffle(pl, ["k"])))

    @pytest.mark.parametrize("op", ["intersect", "union", "subtract"])
    def test_set_ops(self, two_tier, op):
        rng = np.random.default_rng(16)
        a = pd.DataFrame({"k": rng.integers(0, 50, 800).astype(np.int64)})
        b = pd.DataFrame({"k": rng.integers(0, 50, 800).astype(np.int64)})
        (ra, pa), (rb, pb) = _pair(two_tier, a, b)
        _three_way(lambda: r_setop(ra, rb, op),
                   lambda: pct.set_operation(pa, pb, op))

    def test_hot_key_multi_round(self, two_tier):
        """All rows on one key: the hops run several rounds."""
        rng = np.random.default_rng(14)
        df = pd.DataFrame({"k": np.full(60000, 7, np.int64),
                           "a": rng.random(60000)})
        [(rt_, pt_)] = _pair(two_tier, df)
        m0 = pmetrics.counter("timing_event_exchange.multiround").value
        _three_way(lambda: r_shuffle(rt_, ["k"]),
                   lambda: p_shuffle(pt_, ["k"]))
        assert pmetrics.counter(
            "timing_event_exchange.multiround").value > m0

    def test_skew_split_under_two_tiers(self, two_tier):
        rng = np.random.default_rng(15)
        n = 6000
        hot = np.int64(77)
        sk = rng.integers(0, 600, n).astype(np.int64)
        sk = np.where(rng.random(n) < 0.7, hot, sk)
        bk = rng.integers(0, 600, n).astype(np.int64)
        bk[bk == hot] = hot + 1
        bk[0] = hot
        left = pd.DataFrame({"k": sk, "a": rng.integers(0, 100, n)})
        right = pd.DataFrame({"k": bk, "b": rng.integers(0, 100, n)})
        (rl, pl), (rr, pr) = _pair(two_tier, left, right)
        _three_way(lambda: r_join(rl, rr, "k", "k"),
                   lambda: pct.join_tables(pl, pr, "k", "k"))


# ---------------------------------------------------------------------------
# tier accounting, the vote and the single-slice route
# ---------------------------------------------------------------------------

def _armed(comm, metrics, fn):
    """(comm report, rows counter delta, bytes counter delta) of fn()."""
    comm.arm()
    comm.reset()
    r0 = metrics.counter("exchange_rows_total").value
    b0 = metrics.counter("exchange_bytes_total").value
    try:
        fn()
        rep = comm.report()
    finally:
        comm.arm(False)
        comm.reset()
    return (rep, metrics.counter("exchange_rows_total").value - r0,
            metrics.counter("exchange_bytes_total").value - b0)


class TestAccounting:
    def test_tiers_block_equals_reference(self, two_tier):
        from cylon_tpu.obs import metrics as rmetrics
        (rl, pl), _ = _pair(two_tier, *_frames(seed=16))
        reps = {}
        for route in ("two_hop", "flat"):
            run = (lambda f: f()) if route == "two_hop" else _flat
            reps[route] = (
                run(lambda: _armed(pcomm, pmetrics,
                                   lambda: p_shuffle(pl, ["k"]))),
                run(lambda: _armed(rcomm, rmetrics,
                                   lambda: r_shuffle(rl, ["k"]))))
        for route, ((prep, prows, pbytes), (rrep, _, _)) in reps.items():
            assert prep["tiers"] == rrep["tiers"], route
            assert prep["tiers"]["routes"] == {route: 1}
            t = prep["tiers"]
            assert t["n_slices"] == 2
            assert t["ici_rows"] + t["dcn_rows"] == prep["total_rows"] \
                == prows
            assert t["ici_bytes"] + t["dcn_bytes"] == prep["total_bytes"] \
                == pbytes
        th, tf = reps["two_hop"][0][0]["tiers"], reps["flat"][0][0]["tiers"]
        assert th["dcn_rows"] == tf["dcn_rows"]
        assert th["dcn_messages"] * 4 == tf["dcn_messages"]
        assert th["dcn_wire_bytes"] <= tf["dcn_wire_bytes"]

    def test_concentrated_repartition_cuts_dcn_wire(self, two_tier):
        """All rows on rank 0, spread evenly: the flat route pads each of
        its W−R cross-slice cells per rank to the block, the two-hop
        route's hop-2 cells stay at W·(S−1): exactly 1/R of the wire."""
        rng = np.random.default_rng(19)
        n = 4096
        df = pd.DataFrame({"k": rng.integers(0, 999, n).astype(np.int64)})
        [(rt_, pt_)] = _pair(two_tier, df)
        p0 = pct.repartition(pt_, [n] + [0] * 7)
        r0 = r_repart(rt_, rows_per_partition=[n] + [0] * 7)

        def measure():
            return _armed(pcomm, pmetrics,
                          lambda: pct.repartition(p0))[0]["tiers"]

        th, tf = measure(), _flat(measure)
        from cylon_tpu.obs import metrics as rmetrics
        assert th == _armed(rcomm, rmetrics,
                            lambda: r_repart(r0))[0]["tiers"]
        assert th["dcn_rows"] == tf["dcn_rows"]
        assert th["dcn_wire_bytes"] * 4 == tf["dcn_wire_bytes"]
        assert th["dcn_messages"] * 4 == tf["dcn_messages"]

    def test_plan_votes_once_per_env(self, two_tier):
        _, penv = two_tier
        (_, pl), _ = _pair(two_tier, *_frames(seed=17))
        ptm._ADOPTED.clear()
        v0 = pmetrics.counter("topo_plans_voted").value
        p_shuffle(pl, ["k"])
        plan = ptm.last_plan()
        assert plan is not None and plan.route == "hierarchical"
        assert plan.plan_hash() == ptm.hier_plan(penv).plan_hash()
        assert pmetrics.counter("topo_plans_voted").value == v0 + 1
        p_shuffle(pl, ["k"])
        assert pmetrics.counter("topo_plans_voted").value == v0 + 1

    def test_guard_fault_keeps_the_plan(self, two_tier):
        """A fault injected at shuffle.recv_guard: the join retries through
        its chunked fallback on the same voted plan, and its result equals
        the uninjected one."""
        from cylon_tpu_torch.exec import recovery
        (_, pl), (_, pr) = _pair(two_tier, *_frames(seed=18))
        base = pct.join_tables(pl, pr, "k", "k").to_pydict()
        h0 = ptm.last_plan().plan_hash()
        recovery.install_faults("shuffle.recv_guard:0:1=predicted")
        recovery.reset_events()
        try:
            got = pct.join_tables(pl, pr, "k", "k").to_pydict()
            events = recovery.recovery_events()
        finally:
            recovery.install_faults("")
        assert [e["action"] for e in events] == ["retry_chunks_4"]
        assert ptm.last_plan().plan_hash() == h0
        key = np.lexsort([got["b"], got["a"], got["k"]])
        bkey = np.lexsort([base["b"], base["a"], base["k"]])
        for c in ("k", "a", "b"):
            np.testing.assert_array_equal(np.asarray(got[c])[key],
                                          np.asarray(base[c])[bkey])

    def test_single_slice_is_the_flat_route(self, one_slice):
        """No declaration: the armed route is the flat one, with the same
        counters, no vote and no tier counter."""
        renv, penv = one_slice
        assert penv.topology.n_slices == 1
        assert ptm.hier_plan(penv) is None
        (rl, pl), (rr, pr) = _pair(one_slice, *_frames(seed=18))

        def run():
            names = ("exchange_rows_total", "exchange_count",
                     "exchange_dcn_rows_total", "exchange_ici_rows_total",
                     "exchange_dcn_messages_total", "topo_plans_voted",
                     "timing_event_exchange.two_hop")
            before = [pmetrics.counter(n).value for n in names]
            out = pct.join_tables(pl, pr, "k", "k")
            return out, [pmetrics.counter(n).value - b
                         for n, b in zip(names, before)]

        (oh, dh), (of, df) = run(), _flat(run)
        assert_same_port(oh, of)
        assert_layout(r_join(rl, rr, "k", "k"), oh)
        assert dh == df
        assert dh[0] > 0 and dh[1] > 0 and dh[2:] == [0] * 5

    def test_recv_guard_sizes_both_tiers(self, two_tier):
        _, penv = two_tier
        plan = ptm.hier_plan(penv)
        c = np.zeros((8, 8), np.int64)
        c[0:4, 4] = 1000        # slice 0 → rank (1, 0): gateway (0, 0)
        prep = ptx.prepare(plan, c)
        assert prep.cap1 >= 4000
        rb = 16
        need = ptx.recv_guard_bytes(plan, prep, 4096, rb)
        assert need == prep.cap1 * (rb + 4) + 4096 * rb


def teardown_module():
    import jax
    jax.clear_caches()
