"""Parity of the whole slice: the BASELINE path (``join_tables`` inner →
``groupby_aggregate`` on the join key through the fused pushdown) in
cylon_tpu_torch against cylon_tpu at a few thousand rows, plus the state
converters, the deferred join's materialization, the windowed route's
``win_ok`` redispatch and the package's import boundary.

Results must come back with the same keys in the same order.  Integer
aggregates are bit-equal; ``mean`` of integer columns is one IEEE division
of exact integer-valued float64 sums, so it is bit-equal too."""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu.relational import groupby_aggregate as r_groupby
from cylon_tpu.relational import join_tables as r_join
import cylon_tpu_torch as pct
from cylon_tpu_torch.ops import windowed_gather as wg
from cylon_tpu_torch.relational import fused as pfused

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGGS = [("a", "sum"), ("b", "sum"), ("a", "count"), ("b", "mean")]


@pytest.fixture()
def penv():
    return pct.CylonEnv(device="cpu")


def _baseline(n, seed=42, unique=0.9):
    """bench.py's BASELINE inputs: two {k, payload} int64 tables."""
    rng = np.random.default_rng(seed)
    mv = max(int(n * unique), 1)
    lk = rng.integers(0, mv, n).astype(np.int64)
    a = rng.integers(0, mv, n).astype(np.int64)
    rk = rng.integers(0, mv, n).astype(np.int64)
    b = rng.integers(0, mv, n).astype(np.int64)
    return {"k": lk, "a": a}, {"k": rk, "b": b}


def _assert_same(ref_table, port_table):
    r, p = ref_table.host_columns(), port_table.host_columns()
    assert list(r) == list(p)
    assert int(ref_table.row_count) == int(port_table.row_count)
    for name in r:
        (rd, rv), (pd_, pv) = r[name], p[name]
        assert rd.dtype == pd_.dtype, (name, rd.dtype, pd_.dtype)
        np.testing.assert_array_equal(pd_, rd, err_msg=name)
        assert (rv is None) == (pv is None), name
        if rv is not None:
            np.testing.assert_array_equal(pv, rv, err_msg=name)


def _ref_state(t):
    """A reference table's live host state in from_reference_state form."""
    hc = t.host_columns()
    return {n: (hc[n][0], hc[n][1], t.column(n).type.value,
                t.column(n).dictionary, t.column(n).bounds)
            for n in t.column_names}


@pytest.mark.parametrize("n", [2000, 4096, 20000])
def test_baseline_fused_matches_reference(env1, penv, n):
    left, right = _baseline(n)
    rj = r_join(rct.Table.from_pydict(left, env1),
                rct.Table.from_pydict(right, env1), "k", "k")
    pj = pct.join_tables(pct.Table.from_pydict(left, penv),
                         pct.Table.from_pydict(right, penv), "k", "k")
    assert isinstance(pj, pct.DeferredTable)
    rg, pg = r_groupby(rj, "k", AGGS), pct.groupby_aggregate(pj, "k", AGGS)
    assert not pj.materialized       # answered by the fused pushdown
    _assert_same(rg, pg)
    # and against the numpy oracle chip_smoke.py uses
    lk, rk = left["k"], right["k"]
    mv = int(n * 0.9)
    L, R = np.bincount(lk, minlength=mv), np.bincount(rk, minlength=mv)
    sa = np.bincount(lk, left["a"], minlength=mv).astype(np.int64)
    keep = (L > 0) & (R > 0)
    out = pg.to_pydict()
    np.testing.assert_array_equal(out["k"], np.nonzero(keep)[0])
    np.testing.assert_array_equal(out["a_sum"], (sa * R)[keep])


def test_from_reference_state_carries_tables(env1, penv):
    rng = np.random.default_rng(7)
    n = 3000
    # a nullable key (pandas Int64) and an f64 value column
    lk = pd.array(rng.integers(0, 800, n), dtype="Int64")
    lk[rng.random(n) < 0.05] = pd.NA
    rk = pd.array(rng.integers(0, 800, n // 2), dtype="Int64")
    rk[rng.random(n // 2) < 0.05] = pd.NA
    ldf = pd.DataFrame({"k": lk, "a": rng.integers(-50, 50, n)})
    rdf = pd.DataFrame({"k": rk, "b": rng.integers(0, 9, n // 2),
                        "c": rng.normal(size=n // 2)})
    rl, rr = (rct.Table.from_pandas(ldf, env1),
              rct.Table.from_pandas(rdf, env1))
    pl = pct.Table.from_reference_state(_ref_state(rl), rl.valid_counts,
                                        penv)
    pr = pct.Table.from_reference_state(_ref_state(rr), rr.valid_counts,
                                        penv)
    assert (pl.capacity, pr.capacity) == (rl.capacity, rr.capacity)
    _assert_same(rl, pl)
    aggs = [("a", "sum"), ("b", "sum"), ("b", "count"), ("a", "mean")]
    _assert_same(r_groupby(r_join(rl, rr, "k", "k"), "k", aggs),
                 pct.groupby_aggregate(pct.join_tables(pl, pr, "k", "k"),
                                       "k", aggs))
    # the deferred join read instead of fused: same rows, same order
    _assert_same(r_join(rl, rr, "k", "k"), pct.join_tables(pl, pr, "k", "k"))


def test_fused_stage_alone_via_join_state(env1, penv):
    left, right = _baseline(5000, seed=3)
    rj = r_join(rct.Table.from_pydict(left, env1),
                rct.Table.from_pydict(right, env1), "k", "k")
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
    state = pfused.JoinState.from_reference_state(fields, penv)
    pg = pct.groupby_aggregate(state.deferred_table(penv), "k", AGGS)
    _assert_same(r_groupby(rj, "k", AGGS), pg)


@pytest.mark.parametrize("defer", [True, False])
def test_join_materializes_like_reference(env1, penv, defer):
    rng = np.random.default_rng(11)
    n = 3000
    left = {"k": rng.integers(0, 500, n).astype(np.int64),
            "a": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
            "f": rng.normal(size=n)}
    right = {"k": rng.integers(0, 500, 1700).astype(np.int64),
             "a": rng.integers(0, 100, 1700).astype(np.int32)}
    rj = r_join(rct.Table.from_pydict(left, env1),
                rct.Table.from_pydict(right, env1), "k", "k",
                allow_defer=defer)
    pj = pct.join_tables(pct.Table.from_pydict(left, penv),
                         pct.Table.from_pydict(right, penv), "k", "k",
                         allow_defer=defer)
    assert isinstance(pj, pct.DeferredTable) == defer
    assert pj.column_names == ["k", "a_x", "f", "a_y"]
    _assert_same(rj, pj)


def test_string_keys_share_one_dictionary(env1, penv):
    # the two sides' dictionaries differ; promote_key_pair re-codes both
    # into one sorted dictionary, so codes (and key order) agree
    rng = np.random.default_rng(13)
    words = np.asarray([f"w{i:03d}" for i in range(300)], dtype=object)
    left = {"k": words[rng.integers(0, 250, 2500)],
            "a": rng.integers(0, 99, 2500).astype(np.int64)}
    right = {"k": words[rng.integers(50, 300, 1200)],
             "b": rng.integers(0, 99, 1200).astype(np.int64)}
    aggs = [("a", "sum"), ("b", "count"), ("k", "count")]
    rj = r_join(rct.Table.from_pydict(left, env1),
                rct.Table.from_pydict(right, env1), "k", "k")
    pj = pct.join_tables(pct.Table.from_pydict(left, penv),
                         pct.Table.from_pydict(right, penv), "k", "k")
    pg = pct.groupby_aggregate(pj, "k", aggs)
    _assert_same(r_groupby(rj, "k", aggs), pg)
    out = pg.to_pydict()
    assert list(out["k"]) == sorted(set(left["k"]) & set(right["k"]))


def _skewed(n_small, big):
    """Many 1-row groups around one huge group: tiles that reach across the
    huge group overflow any window."""
    k = np.concatenate([np.arange(n_small), np.full(big, n_small),
                        np.arange(n_small + 1, 2 * n_small)]).astype(np.int64)
    return {"k": k, "a": np.arange(len(k), dtype=np.int64)}, \
        {"k": np.unique(k), "b": np.ones(len(np.unique(k)), np.int64)}


@pytest.mark.parametrize("skewed", [False, True])
def test_windowed_route_and_win_ok_redispatch(env1, penv, monkeypatch,
                                              skewed):
    # open the windowed route on the CPU (its plain version): the window
    # is picked from the measured density as on the card, without the
    # card-only and segment-space gates; the first-sight dispatch stays
    # plain, as in the reference
    monkeypatch.setattr(pfused, "_win_size",
                        lambda env, sc, dens: wg.pick_window(dens))
    left, right = _skewed(800, 5000) if skewed else _baseline(6000, seed=5)
    rj = r_join(rct.Table.from_pydict(left, env1),
                rct.Table.from_pydict(right, env1), "k", "k")
    pj = pct.join_tables(pct.Table.from_pydict(left, penv),
                         pct.Table.from_pydict(right, penv), "k", "k")
    wg.reset_counts()
    pg = pct.groupby_aggregate(pj, "k", AGGS)
    assert wg.COUNTS["redispatches"] == int(skewed)
    assert wg.COUNTS["launches"] == 0      # CPU tensors: plain version only
    _assert_same(r_groupby(rj, "k", AGGS), pg)


def test_refusals(penv):
    t = pct.Table.from_pydict({"k": np.arange(10), "v": np.arange(10)}, penv)
    # a plain table's groupby takes the sort-based groupby (ported); a
    # single DataFrame column is a Series (ported)
    out = pct.groupby_aggregate(t, "k", [("v", "sum")]).to_pydict()
    np.testing.assert_array_equal(out["v_sum"], np.arange(10))
    v = pct.DataFrame(t)["v"]
    assert isinstance(v, pct.Series) and v.sum() == 45
    # a left join answers (ported): the reference's rows
    rt = rct.Table.from_pydict({"k": np.arange(10), "v": np.arange(10)},
                               rct.CylonEnv(config=rct.LocalConfig()))
    _assert_same(r_join(rt, rt, "k", "k", how="left"),
                 pct.join_tables(t, t, "k", "k", how="left"))
    with pytest.raises(pct.InvalidError):
        pct.groupby_aggregate(t, "k", [("v", "nosuchop")])

    # one virtual world runs on one device; a config naming a second
    # device asks for the multi-card transport, which is not ported yet
    from cylon_tpu_torch.ctx.context import CommConfig, VirtualMeshConfig

    class TwoCards(CommConfig):
        world_size = 2
        devices = ("cpu", "meta")
    for device in (None, "cpu"):
        with pytest.raises(NotImplementedError, match="multi-card"):
            pct.CylonEnv(TwoCards(), device=device)
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(pct.DeviceUnavailableError):
            pct.CylonEnv()
        with pytest.raises(pct.DeviceUnavailableError):
            pct.CylonEnv(VirtualMeshConfig(4))      # cuda:0 by default


def test_import_boundary():
    """The package (the pipelined join's modules included) and
    chip_smoke.py import neither jax nor cylon_tpu, and importing the
    package needs neither pandas nor pyarrow."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import cylon_tpu_torch, cylon_tpu_torch.relational.fused\n"
        "import cylon_tpu_torch.kernels, chip_smoke\n"
        "import cylon_tpu_torch.exec.pipeline, cylon_tpu_torch.exec.memory\n"
        "import cylon_tpu_torch.relational.piece\n"
        "import cylon_tpu_torch.relational.sort, cylon_tpu_torch.frame\n"
        "import cylon_tpu_torch.relational.groupby\n"
        "import cylon_tpu_torch.relational.repart\n"
        "import cylon_tpu_torch.relational.setops, cylon_tpu_torch.ops.setops\n"
        "import cylon_tpu_torch.native\n"
        "import cylon_tpu_torch.ops.splitter_probe, cylon_tpu_torch.ops.sort\n"
        "import cylon_tpu_torch.utils.timing\n"
        "import cylon_tpu_torch.ops.hashing, cylon_tpu_torch.parallel.shuffle\n"
        "import cylon_tpu_torch.parallel.shards\n"
        "import cylon_tpu_torch.parallel.collectives\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cylon_tpu', 'pandas', 'pyarrow'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code, REPO],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
