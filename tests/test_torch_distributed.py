"""Parity of the BASELINE path at world sizes above 1: cylon_tpu_torch on
``VirtualMeshConfig(W, device="cpu")`` against cylon_tpu on the CPU mesh
(``CPUMeshConfig``), a few thousand rows per side.

Held bit-equal, layout included (``valid_counts``, capacity, each
shard's rows and padding):

* ingest at W = 3, 4 and 8 (the reference's contiguous ``_distribute``);
* ``join_tables -> groupby_aggregate(sum)`` through the fused pushdown at
  W = 4 and 8, as the CPU rules it (no window) and with the windowed
  route opened through K1's plain version, including a shard whose window
  overflows so the cross-shard ``win_ok`` redispatch runs;
* the deferred join read instead of fused, and an eager join;
* ``GroupBySink + pipelined_join(n_chunks = 2, 3) + finalize`` at W = 4;
* a ``JoinState`` carried across from a reference W = 4 join.

Both packages run the skew split at its default, armed (the BASELINE
keys are uniform, so no plan forms; the one case about the unsplit plan
turns both switches off), and take the plain hash plan at
``BROADCAST_JOIN_ROWS`` 0."""

import numpy as np
import pytest

import cylon_tpu as rct
from cylon_tpu import config as rconfig
from cylon_tpu.ctx.context import CPUMeshConfig
from cylon_tpu.exec import GroupBySink as RSink
from cylon_tpu.exec import pipelined_join as r_pipe
from cylon_tpu.relational import groupby_aggregate as r_groupby
from cylon_tpu.relational import join_tables as r_join
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from cylon_tpu_torch.ops import splitter_probe as sp
from cylon_tpu_torch.ops import windowed_gather as wg
from cylon_tpu_torch.relational import fused as pfused
from test_torch_shuffle import assert_layout

AGGS = [("a", "sum"), ("b", "sum"), ("a", "count"), ("b", "mean")]


@pytest.fixture(autouse=True)
def same_routes(monkeypatch):
    monkeypatch.setattr(rconfig, "BROADCAST_JOIN_ROWS", 0)
    monkeypatch.setattr(pconfig, "BROADCAST_JOIN_ROWS", 0)


@pytest.fixture(scope="module")
def envs(env4, env8):
    return {3: rct.CylonEnv(config=CPUMeshConfig(world_size=3)),
            4: env4, 8: env8}


def _penv(w):
    return pct.CylonEnv(VirtualMeshConfig(w), device="cpu")


def _baseline(n, seed=42):
    """bench.py's BASELINE inputs: two {k, payload} int64 tables."""
    rng = np.random.default_rng(seed)
    mv = int(n * 0.9)
    return ({"k": rng.integers(0, mv, n), "a": rng.integers(0, mv, n)},
            {"k": rng.integers(0, mv, n), "b": rng.integers(0, mv, n)})


def _skewed(n_small, big):
    """Many 1-row groups and one huge group: the shard the huge group
    hashes to has tiles that overflow any window."""
    k = np.concatenate([np.arange(n_small), np.full(big, n_small),
                        np.arange(n_small + 1, 2 * n_small)]).astype(np.int64)
    u = np.unique(k)
    return ({"k": k, "a": np.arange(len(k), dtype=np.int64)},
            {"k": u, "b": np.ones(len(u), np.int64)})


DATA = {"baseline": lambda: _baseline(12000),
        "skewed": lambda: _skewed(3000, 15000)}
_REF = {}


def _reference(envs, w, data):
    """The reference's join and fused groupby, computed once per case."""
    if (w, data) not in _REF:
        left, right = DATA[data]()
        rl = rct.Table.from_pydict(left, envs[w])
        rr = rct.Table.from_pydict(right, envs[w])
        rj = r_join(rl, rr, "k", "k")
        _REF[(w, data)] = (left, right, rj, r_groupby(rj, "k", AGGS))
    return _REF[(w, data)]


@pytest.mark.parametrize("w", [3, 4, 8])
@pytest.mark.parametrize("n", [5, 1001, 4096])
def test_ingest_matches_reference(envs, w, n):
    rng = np.random.default_rng(n)
    data = {"i": rng.integers(-2**40, 2**40, n),
            "j": rng.integers(0, 100, n).astype(np.int32),
            "f": rng.normal(size=n),
            "s": np.asarray([f"w{x}" for x in rng.integers(0, 50, n)],
                            dtype=object)}
    rt = rct.Table.from_pydict(data, envs[w])
    pt = pct.Table.from_pydict(data, _penv(w))
    assert_layout(rt, pt)
    out = pt.to_pydict()
    for name in data:
        np.testing.assert_array_equal(out[name], data[name])


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("data", ["baseline", "skewed"])
@pytest.mark.parametrize("windowed", [False, True])
def test_join_groupby_matches_reference(envs, monkeypatch, w, data,
                                        windowed):
    """The "skewed" case is about the unsplit plan itself — its huge
    group lands whole on one shard, whose window overflows — so both
    packages run it with ``SKEW_SPLIT`` off (tests/test_torch_skew.py
    holds that join under the split)."""
    if data == "skewed":
        monkeypatch.setattr(rconfig, "SKEW_SPLIT", False)
        monkeypatch.setattr(pconfig, "SKEW_SPLIT", False)
    left, right, _, rg = _reference(envs, w, data)
    calls = []
    if windowed:
        # open the windowed route on the CPU (K1's plain version): the
        # window comes from the minimum per-shard density as on the card,
        # without the card-only and segment-space gates
        monkeypatch.setattr(pfused, "_win_size",
                            lambda env, sc, dens: wg.pick_window(dens))
        take = wg.windowed_take_t

        def counted(lanes, idx, window):
            calls.append(window)
            return take(lanes, idx, window)
        monkeypatch.setattr(wg, "windowed_take_t", counted)
    penv = _penv(w)
    pj = pct.join_tables(pct.Table.from_pydict(left, penv),
                         pct.Table.from_pydict(right, penv), "k", "k")
    assert isinstance(pj, pct.DeferredTable)
    assert pj.grouped_by == ("k",)
    wg.reset_counts()
    pg = pct.groupby_aggregate(pj, "k", AGGS)
    assert not pj.materialized            # answered by the fused pushdown
    assert_layout(rg, pg)
    assert wg.COUNTS["launches"] == 0     # CPU tensors: plain version only
    if windowed:
        # one windowed dispatch: the window once per shard; the skewed
        # case's overflowing shard reruns every shard without it
        assert len(calls) == w
        assert wg.COUNTS["redispatches"] == int(data == "skewed")


@pytest.mark.parametrize("defer", [True, False])
def test_join_materializes_like_reference(envs, defer):
    rng = np.random.default_rng(3)
    left = {"k": rng.integers(0, 700, 2500),
            "a": rng.integers(-2**40, 2**40, 2500), "f": rng.normal(size=2500)}
    right = {"k": rng.integers(0, 700, 1500),
             "a": rng.integers(0, 99, 1500).astype(np.int32)}
    rj = r_join(rct.Table.from_pydict(left, envs[4]),
                rct.Table.from_pydict(right, envs[4]), "k", "k",
                allow_defer=defer)
    penv = _penv(4)
    pj = pct.join_tables(pct.Table.from_pydict(left, penv),
                         pct.Table.from_pydict(right, penv), "k", "k",
                         allow_defer=defer)
    assert isinstance(pj, pct.DeferredTable) == defer
    assert pj.column_names == ["k", "a_x", "f", "a_y"]
    assert_layout(rj, pj)


@pytest.mark.parametrize("n_chunks", [2, 3])
def test_pipelined_sink_matches_reference(envs, n_chunks):
    left, right = _baseline(6000, seed=9)
    rsink = RSink("k", AGGS)
    r_pipe(rct.Table.from_pydict(left, envs[4]),
           rct.Table.from_pydict(right, envs[4]), "k", "k",
           n_chunks=n_chunks, sink=rsink)
    penv = _penv(4)
    psink = pct.GroupBySink("k", AGGS)
    sp.reset_counts()
    pct.pipelined_join(pct.Table.from_pydict(left, penv),
                       pct.Table.from_pydict(right, penv), "k", "k",
                       n_chunks=n_chunks, sink=psink)
    assert sp.COUNTS["launches"] == 0     # CPU tensors: plain version only
    assert_layout(rsink.finalize(), psink.finalize())
    # and without a sink: the pieces concatenated per shard
    rp = r_pipe(rct.Table.from_pydict(left, envs[4]),
                rct.Table.from_pydict(right, envs[4]), "k", "k",
                n_chunks=n_chunks)
    pp = pct.pipelined_join(pct.Table.from_pydict(left, penv),
                            pct.Table.from_pydict(right, penv), "k", "k",
                            n_chunks=n_chunks)
    np.testing.assert_array_equal(pp.valid_counts, rp.valid_counts)
    r, p = rp.host_columns(), pp.host_columns()
    for name in r:
        np.testing.assert_array_equal(p[name][0], r[name][0], err_msg=name)


def test_join_state_carried_from_reference(envs):
    _, _, rj, rg = _reference(envs, 4, "baseline")
    st = rj.op_state
    fields = {f: getattr(st, f) for f in (
        "vcl", "vcr", "plan", "names", "dicts", "key_names", "cap_l",
        "cap_r", "all_live")}
    fields.update(
        idx_s=np.asarray(st.idx_s), bnd=np.asarray(st.bnd),
        pl_s=[np.asarray(p) for p in st.pl_s],
        lspec=(tuple(tuple(c) for c in st.lspec.cols), st.lspec.n_lanes,
               st.lspec.valid_lane0),
        rspec=(tuple(tuple(c) for c in st.rspec.cols), st.rspec.n_lanes,
               st.rspec.valid_lane0),
        types=[t.value for t in st.types])
    state = pfused.JoinState.from_reference_state(fields, "cpu")
    table = state.deferred_table()
    assert table.env.world_size == 4
    assert_layout(rg, pct.groupby_aggregate(table, "k", AGGS))
