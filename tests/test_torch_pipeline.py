"""Parity of the range-partitioned pipelined join with its GroupBySink:
cylon_tpu_torch against cylon_tpu at world size 1 (``env1``), a few
thousand rows per side.

Every comparison is exact — same keys in the same order, same bits —
with the reference's Pallas splitter probe both off and on (interpret
mode on the CPU) against the port's splitter probe (its plain version on
the CPU).  Also held equal: the packed pieces' ``to_table`` windows,
``local_sort_table``, the ledger's admission, and the refusals."""

import gc

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu import config as rconfig
from cylon_tpu.exec import GroupBySink as RSink
from cylon_tpu.exec import pipelined_join as r_pipe
from cylon_tpu.ops import pallas_probe
from cylon_tpu.relational import join_tables as r_join
from cylon_tpu.relational.piece import PieceSource as RSource
from cylon_tpu.relational.sort import local_sort_table as r_lsort
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch.exec import memory as pmemory
from cylon_tpu_torch.ops import splitter_probe as sp
from cylon_tpu_torch.relational.piece import PieceSource as PSource
from cylon_tpu_torch.relational.sort import local_sort_table as p_lsort
from test_torch_shuffle import assert_layout

AGGS = [("a", "sum"), ("b", "sum"), ("a", "count"), ("b", "mean")]


@pytest.fixture()
def penv():
    return pct.CylonEnv(device="cpu")


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


def _tables(left, right, env1, penv):
    """The same pandas frames as a reference and a port table pair."""
    ldf, rdf = pd.DataFrame(left), pd.DataFrame(right)
    return (rct.Table.from_pandas(ldf, env1), rct.Table.from_pandas(rdf, env1),
            pct.Table.from_pandas(ldf, penv), pct.Table.from_pandas(rdf, penv))


def _data(kind, seed=0):
    """Left (probe) and right (build) frames of one key structure."""
    rng = np.random.default_rng(seed)
    nl, nr = 3000, 2500
    if kind == "baseline":            # bench.py's shape, masked tails
        lk = rng.integers(0, 2700, nl)
        rk = rng.integers(0, 2700, nr)
    elif kind == "wide":              # int64 keys past int32: (hi, lo)
        pool = rng.integers(-2**62, 2**62, 400, dtype=np.int64)
        lk, rk = rng.choice(pool, nl), rng.choice(pool, nr)
    elif kind == "hot_range":         # one key fills a whole range
        lk = rng.integers(0, 900, nl)
        rk = rng.integers(0, 900, nr)
        lk[rng.random(nl) < 0.3] = 450
        rk[rng.random(nr) < 0.6] = 450
    elif kind == "nullable":          # a null-flag operand in the key
        lk = pd.array(rng.integers(0, 800, nl), dtype="Int64")
        rk = pd.array(rng.integers(0, 800, nr), dtype="Int64")
        lk[rng.random(nl) < 0.05] = pd.NA
        rk[rng.random(nr) < 0.05] = pd.NA
    elif kind == "float64":           # an 'f' operand: NaN, ±0.0, ±inf
        pool = np.concatenate([rng.normal(size=500),
                               [np.nan, 0.0, -0.0, np.inf, -np.inf]])
        lk, rk = rng.choice(pool, nl), rng.choice(pool, nr)
    else:
        raise ValueError(kind)
    left = {"k": lk, "a": rng.integers(-1000, 1000, nl).astype(np.int64)}
    right = {"k": rk, "b": rng.integers(0, 1 << 40, nr).astype(np.int64)}
    return left, right


def _sinks(rl, rr, pl, pr, n_chunks, probe_on, monkeypatch):
    """Run both pipelines into a GroupBySink; returns (ref, port) results,
    the reference's probe-gate answers and the port's K2 entry calls."""
    r_gate, p_calls = [], []
    r_sup, p_probe = pallas_probe.supported, sp.count_ge_splitters

    def r_spy(*a):
        r_gate.append(r_sup(*a))
        return r_gate[-1]

    def p_spy(ops, sops):
        p_calls.append(len(sops[0]))
        return p_probe(ops, sops)

    monkeypatch.setattr(rconfig, "PALLAS_PROBE", probe_on)
    monkeypatch.setattr(pallas_probe, "supported", r_spy)
    monkeypatch.setattr(sp, "count_ge_splitters", p_spy)
    rs, ps = RSink("k", AGGS), pct.GroupBySink("k", AGGS)
    r_pipe(rl, rr, "k", "k", how="inner", n_chunks=n_chunks, sink=rs)
    balance = pmemory.balance()
    outs = pct.pipelined_join(pl, pr, "k", "k", how="inner",
                              n_chunks=n_chunks, sink=ps)
    assert all(o is None for o in outs)
    assert ps._disjoint                 # keyed on the join key
    snap = ps.snapshot()                # leaves the partials adopted
    pg = ps.finalize()
    _assert_same(snap, pg)
    # the partials' ledger registrations drain at finalize, and the packed
    # sources' with the pipeline's frame
    assert pmemory.balance() == balance
    return rs.finalize(), pg, r_gate, p_calls


@pytest.mark.parametrize("probe_on", [False, True])
@pytest.mark.parametrize("n_chunks", [1, 2, 6])
def test_sink_matches_reference(env1, penv, monkeypatch, n_chunks,
                                probe_on):
    rl, rr, pl, pr = _tables(*_data("baseline"), env1, penv)
    assert pl.capacity == 4096 and pl.row_count == 3000   # masked tail
    rg, pg, r_gate, p_calls = _sinks(rl, rr, pl, pr, n_chunks, probe_on,
                                     monkeypatch)
    _assert_same(rg, pg)
    # the reference's "on" leg really took its Pallas kernel, and the port
    # probed through its K2 entry once, against R-1 splitters, either way
    assert r_gate == ([True] if probe_on and n_chunks > 1 else [])
    assert p_calls == ([n_chunks - 1] if n_chunks > 1 else [])
    # and against the monolithic port join -> fused groupby
    mono = pct.groupby_aggregate(pct.join_tables(pl, pr, "k", "k"), "k",
                                 AGGS)
    for name in ("k", "a_sum", "b_sum", "a_count"):
        np.testing.assert_array_equal(pg.to_pydict()[name],
                                      mono.to_pydict()[name])


@pytest.mark.parametrize("kind", ["wide", "hot_range", "nullable"])
def test_sink_key_structures(env1, penv, monkeypatch, kind):
    rl, rr, pl, pr = _tables(*_data(kind, seed=3), env1, penv)
    rg, pg, r_gate, p_calls = _sinks(rl, rr, pl, pr, 6, True, monkeypatch)
    assert r_gate == [True] and p_calls == [5]
    _assert_same(rg, pg)


@pytest.mark.parametrize("sink", [False, True])
def test_exact_capacity_sentinel(env1, penv, monkeypatch, sink):
    """A build side at exact capacity (n == cap) has no padding row to
    serve as the +inf boundary: probe rows holding its max key must still
    find all their matches, and a key past it must route to the last
    range rather than vanish."""
    rng = np.random.default_rng(5)
    n = 4096
    right = {"k": np.full(n, 7, np.int64),
             "b": rng.integers(0, 100, n).astype(np.int64)}
    left = {"k": np.where(np.arange(96) % 2 == 0, 7, 9).astype(np.int64),
            "a": rng.integers(0, 100, 96).astype(np.int64)}
    rl, rr, pl, pr = _tables(left, right, env1, penv)
    assert pr.capacity == pr.row_count == n
    if sink:
        rg, pg, _, _ = _sinks(rl, rr, pl, pr, 4, True, monkeypatch)
        _assert_same(rg, pg)
        assert pg.to_pydict()["a_count"].tolist() == [48 * n]
    else:
        got = pct.pipelined_join(pl, pr, "k", "k", n_chunks=4)
        _assert_same(r_pipe(rl, rr, "k", "k", n_chunks=4), got)
        assert got.row_count == 48 * n


@pytest.mark.parametrize("sink", [False, True])
def test_no_overlapping_keys(env1, penv, monkeypatch, sink):
    """With a 2-row build every probe key sorts below it: no range
    qualifies and one empty piece pair keeps the output schema."""
    right = {"k": np.array([10, 20], np.int64), "b": np.array([1, 2])}
    left = {"k": np.array([1, 2, 3], np.int64), "a": np.array([4, 5, 6])}
    rl, rr, pl, pr = _tables(left, right, env1, penv)
    if sink:
        rg, pg, _, _ = _sinks(rl, rr, pl, pr, 4, False, monkeypatch)
        assert pg.row_count == 0
        assert pg.column_names == rg.column_names
        _assert_same(rg, pg)
    else:
        got = pct.pipelined_join(pl, pr, "k", "k", n_chunks=4)
        assert got.row_count == 0
        assert got.column_names == ["k", "a", "b"]


@pytest.mark.parametrize("kind", ["baseline", "wide", "nullable",
                                  "float64"])
def test_sinkless_rows_match_reference(env1, penv, kind):
    """Without a sink the packed pieces' joins concatenate: the same rows
    in the same order as the reference's pipelined join.  With a float64
    key (an 'f' operand through K2: NaN, ±0.0, ±inf), whose packed pieces
    the reference cannot build, the reference is its monolithic join:
    key groups ascend in both, left rows in source order within one."""
    rl, rr, pl, pr = _tables(*_data(kind, seed=9), env1, penv)
    got = pct.pipelined_join(pl, pr, "k", "k", n_chunks=3)
    ref = r_join(rl, rr, "k", "k", how="inner") if kind == "float64" \
        else r_pipe(rl, rr, "k", "k", n_chunks=3)
    _assert_same(ref, got)
    assert got.grouped_by == ("k",)


@pytest.mark.parametrize("refused", ["first_source", "second_source"])
def test_admission_over_budget_needs_spill_tier(penv, monkeypatch,
                                                refused):
    """A device budget a packed source does not fit in — the first one
    alone, or the second beside the first: the admission of the second
    evicts the first (the LRU spillable owner) to host memory, whose
    pieces then upload one window at a time; the join completes equal to
    the unbudgeted run, and the ledger drains afterwards."""
    left, right = _data("baseline")
    pl = pct.Table.from_pandas(pd.DataFrame(left), penv)
    pr = pct.Table.from_pandas(pd.DataFrame(right), penv)
    needs, admit = [], pmemory.ensure_headroom

    def spy(env, need, scratch=0):
        needs.append(int(need) + int(scratch))
        return admit(env, need, scratch)

    monkeypatch.setattr(pmemory, "ensure_headroom", spy)
    base = pct.pipelined_join(pl, pr, "k", "k", n_chunks=2)  # no limit
    assert len(needs) == 2 and min(needs) > 0
    gc.collect()
    balance = pmemory.balance()
    budget = balance + needs[0] - (refused == "first_source")
    monkeypatch.setattr(pmemory, "budget_bytes", lambda env: budget)
    needs.clear()
    pmemory.reset_stats()
    got = pct.pipelined_join(pl, pr, "k", "k", n_chunks=2)
    assert len(needs) == 2
    log = pmemory.eviction_log()
    assert len(log) == 1 and log[0].startswith("piece_src#"), log
    assert pmemory.stats()["bytes_readmitted"] > 0
    _assert_same(base, got)
    gc.collect()
    assert pmemory.balance() == balance


def _sorted_pair(env1, penv, seed=11):
    """A nullable int key, an int payload and an f64 column, sorted by
    key in both packages."""
    rng = np.random.default_rng(seed)
    n = 2500
    k = pd.array(rng.integers(0, 300, n), dtype="Int64")
    k[rng.random(n) < 0.05] = pd.NA
    df = pd.DataFrame({"k": k, "a": rng.integers(-9, 9, n).astype(np.int64),
                       "f": rng.normal(size=n)})
    rt, pt = rct.Table.from_pandas(df, env1), pct.Table.from_pandas(df, penv)
    return r_lsort(rt, ["k"]), p_lsort(pt, ["k"])


def test_local_sort_table_matches_reference(env1, penv):
    rs, ps = _sorted_pair(env1, penv)
    _assert_same(rs, ps)
    for name in rs.column_names:
        assert ps.column(name).bounds == rs.column(name).bounds, name


@pytest.mark.parametrize("start,length,cap", [
    (0, 700, 1024), (1300, 512, 512), (2400, 100, 128), (0, 0, 1)])
def test_packed_piece_windows(env1, penv, start, length, cap):
    """A packed window materialized with to_table equals the reference's
    window, and a packed inner join over two windows equals the
    reference's (materialized from the deferred state)."""
    rs, ps = _sorted_pair(env1, penv)
    pad = 1024
    r_src, p_src = RSource(rs, pad), PSource(ps, pad)
    w = np.asarray
    rp = r_src.packed(w([start]), w([length]), cap)
    pp = p_src.packed(w([start]), w([length]), cap)
    _assert_same(rp.to_table(), pp.to_table())
    assert pp.column_names == ["k", "a", "f"]
    # a join of the window with a second window of the same source
    r2 = r_src.packed(w([100]), w([900]), 1024)
    p2 = p_src.packed(w([100]), w([900]), 1024)
    rj = r_join(rp, r2, "k", "k", how="inner", allow_defer=True)
    pj = pct.join_tables(pp, p2, "k", "k", how="inner", allow_defer=True)
    assert isinstance(pj, pct.DeferredTable) and not pj.materialized
    _assert_same(rj, pj)
    # a window joined with a materialized Table takes the colocated join
    # of the materialized window: the same rows
    _assert_same(rj, pct.join_tables(pp, p2.to_table(), "k", "k",
                                     how="inner", allow_defer=False))


def test_refusals(env1, penv):
    t = pct.Table.from_pydict({"k": np.arange(10), "v": np.arange(10)}, penv)
    # a left join streams (ported): the reference's answer
    rt = rct.Table.from_pydict({"k": np.arange(10), "v": np.arange(10)},
                               env1)
    _assert_same(r_pipe(rt, rt, "k", "k", how="left", n_chunks=2),
                 pct.pipelined_join(t, t, "k", "k", how="left", n_chunks=2))
    with pytest.raises(pct.InvalidError):
        pct.pipelined_join(t, t, "k", "k", how="cross", n_chunks=2)
    with pytest.raises(pct.InvalidError):
        pct.GroupBySink("k", [("v", "median")])
    # a sink keyed off the join keys combines across pieces (ported): it
    # is refused no longer
    u = pct.Table.from_pydict({"k": np.arange(10), "g": np.arange(10) % 3,
                               "w": np.arange(10)}, penv)
    sink = pct.GroupBySink("g", [("v", "sum")])
    pct.pipelined_join(u, t, "k", "k", n_chunks=2, sink=sink)
    out = sink.finalize().to_pydict()
    np.testing.assert_array_equal(out["g"], [0, 1, 2])
    np.testing.assert_array_equal(out["v_sum"], [18, 12, 15])


# ---------------------------------------------------------------------------
# non-disjoint sinks: groups that span pieces combine through the
# sort-based groupby (inner joins; tests/test_pipeline.py's cases)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds4(env4):
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    return {1: None, 4: (env4, pct.CylonEnv(VirtualMeshConfig(4),
                                            device="cpu"))}


def _world(w, env1, penv, worlds4, monkeypatch):
    """(reference env, port env) at world size ``w``, both packages with
    the broadcast route off at W > 1 (the skew split armed in both)."""
    if w == 1:
        return env1, penv
    monkeypatch.setattr(rconfig, "BROADCAST_JOIN_ROWS", 0)
    monkeypatch.setattr(pconfig, "BROADCAST_JOIN_ROWS", 0)
    return worlds4[w]


def _pipe_frames(seed=3, n=3000):
    rng = np.random.default_rng(seed)
    ldf = pd.DataFrame({"k": rng.integers(0, 250, n).astype(np.int64),
                        "g": rng.integers(0, 7, n).astype(np.int64),
                        "a": rng.integers(0, 50, n).astype(np.int64)})
    rdf = pd.DataFrame({"k": rng.integers(100, 350, n // 2).astype(np.int64),
                        "b": rng.integers(0, 50, n // 2).astype(np.int64)})
    return ldf, rdf


@pytest.mark.parametrize("w", [4])
def test_sink_callable_partials_combine(env1, penv, worlds4, monkeypatch,
                                        w):
    """A plain callable sink: per-piece groupbys, concatenated and
    combined by one more groupby over the partials
    (tests/test_pipeline.py::test_pipelined_groupby_sink_combines)."""
    from cylon_tpu.relational import concat_tables as r_concat
    from cylon_tpu.relational import groupby_aggregate as r_groupby
    from cylon_tpu_torch.relational.repart import concat_tables as p_concat
    renv, penv_w = _world(w, env1, penv, worlds4, monkeypatch)
    ldf, rdf = _pipe_frames()
    rl, rr = rct.Table.from_pandas(ldf, renv), rct.Table.from_pandas(rdf,
                                                                     renv)
    pl, pr = pct.Table.from_pandas(ldf, penv_w), pct.Table.from_pandas(
        rdf, penv_w)
    aggs = [("a", "sum"), ("b", "sum")]
    combine = [("a_sum", "sum"), ("b_sum", "sum")]
    rparts = r_pipe(rl, rr, "k", "k", n_chunks=3,
                    sink=lambda c: r_groupby(c, "k", aggs))
    pparts = pct.pipelined_join(pl, pr, "k", "k", n_chunks=3,
                                sink=lambda c: pct.groupby_aggregate(
                                    c, "k", aggs))
    rg = r_groupby(r_concat(rparts), "k", combine)
    pg = pct.groupby_aggregate(p_concat(pparts), "k", combine)
    _assert_same(rg, pg)
    np.testing.assert_array_equal(pg.valid_counts, rg.valid_counts)
    assert pg.capacity == rg.capacity and pg.grouped_by == rg.grouped_by


@pytest.mark.parametrize("w", [1, 4])
def test_sink_overlapping_chunks(env1, penv, worlds4, monkeypatch, w):
    """var/std/mean combined across chunks that SHARE keys, fed by hand
    (tests/test_pipeline.py::TestGroupBySink::
    test_sink_var_overlapping_chunks).  Float results to the stated
    tolerance of tests/test_torch_groupby_sort.py."""
    from test_torch_groupby_sort import _scale, assert_same
    renv, penv_w = _world(w, env1, penv, worlds4, monkeypatch)
    rng = np.random.default_rng(4)
    df = pd.DataFrame({"k": rng.integers(0, 40, 3000).astype(np.int64),
                       "v": rng.random(3000),
                       "i": rng.integers(-50, 50, 3000)})
    aggs = [("v", "var"), ("v", "std"), ("v", "mean"), ("i", "min"),
            ("i", "max"), ("i", "count"), ("i", "sum")]
    rs, ps = RSink("k", aggs), pct.GroupBySink("k", aggs)
    for lo, hi in ((0, 1000), (1000, 2600), (2600, 3000)):
        rs(rct.Table.from_pandas(df.iloc[lo:hi], renv))
        ps(pct.Table.from_pandas(df.iloc[lo:hi], penv_w))
    assert not ps._disjoint
    rg, pg = rs.finalize(), ps.finalize()
    assert pg.grouped_by is None
    rg.grouped_by = None
    assert_same(rg, pg, _scale(df))


@pytest.mark.parametrize("w", [1, 4])
def test_sink_absorb_compact_matches_reference(env1, penv, worlds4,
                                               monkeypatch, w):
    """``absorb`` is the consume path and ``compact`` folds the partials
    into one: with integer-valued float payloads (exact partial sums) the
    compacted partial and every snapshot equal the reference's bit for
    bit, var/std included, and a compact of 0 or 1 partials or of a
    key-disjoint sink changes nothing."""
    renv, penv_w = _world(w, env1, penv, worlds4, monkeypatch)
    rng = np.random.default_rng(6)
    df = pd.DataFrame({"k": rng.integers(0, 30, 1500).astype(np.int64),
                       "v": rng.integers(-99, 99, 1500).astype(np.float64),
                       "i": rng.integers(-50, 50, 1500)})
    aggs = [("v", "var"), ("v", "std"), ("v", "mean"), ("i", "min"),
            ("i", "max"), ("i", "count"), ("i", "sum")]
    sinks = (RSink("k", aggs), pct.GroupBySink("k", aggs))
    for s in sinks:
        s.compact()                                  # no partials: no-op
        assert s._parts == []
    for lo, hi in ((0, 500), (500, 1100), (1100, 1500)):
        for s, mod, env in zip(sinks, (rct, pct), (renv, penv_w)):
            s.absorb(mod.Table.from_pandas(df.iloc[lo:hi], env))
        _assert_same(*[s.snapshot() for s in sinks])
    for s in sinks:
        s.compact()
        assert len(s._parts) == len(s._regs) == 1
    _assert_same(*[s._parts[0] for s in sinks])
    _assert_same(*[s.snapshot() for s in sinks])
    for s in sinks:
        part = s._parts[0]
        s.compact()                                  # one partial: no-op
        assert s._parts[0] is part
    for s, mod, env in zip(sinks, (rct, pct), (renv, penv_w)):
        s.absorb(mod.Table.from_pandas(df.iloc[:300], env))
    _assert_same(*[s.finalize() for s in sinks])
    disjoint = [pct.GroupBySink("k", aggs)]
    disjoint[0].mark_key_disjoint()
    for lo, hi in ((0, 700), (700, 1500)):
        disjoint[0].absorb(pct.Table.from_pandas(
            df[(df.k >= lo // 50) & (df.k < hi // 50)], penv_w))
    disjoint[0].compact()
    assert len(disjoint[0]._parts) == 2


@pytest.mark.parametrize("w", [1, 4])
def test_sink_non_key_by_combines_across_pieces(env1, penv, worlds4,
                                                monkeypatch, w):
    """A GroupBySink keyed on a payload column: its groups span pieces,
    so the sink combines through the sort-based groupby
    (tests/test_pipeline.py::TestPipelinedGroupBySinkHow::
    test_sink_non_key_by_combines_across_chunks, inner)."""
    from cylon_tpu.relational import groupby_aggregate as r_groupby
    renv, penv_w = _world(w, env1, penv, worlds4, monkeypatch)
    ldf, rdf = _pipe_frames(5)
    rl, rr = rct.Table.from_pandas(ldf, renv), rct.Table.from_pandas(rdf,
                                                                     renv)
    pl, pr = pct.Table.from_pandas(ldf, penv_w), pct.Table.from_pandas(
        rdf, penv_w)
    aggs = [("a", "sum"), ("b", "mean"), ("b", "max"), ("a", "count")]
    rs, ps = RSink("g", aggs), pct.GroupBySink("g", aggs)
    r_pipe(rl, rr, "k", "k", how="inner", n_chunks=4, sink=rs)
    pct.pipelined_join(pl, pr, "k", "k", how="inner", n_chunks=4, sink=ps)
    assert not ps._disjoint
    rg, pg = rs.finalize(), ps.finalize()
    _assert_same(rg, pg)
    np.testing.assert_array_equal(pg.valid_counts, rg.valid_counts)
    assert pg.capacity == rg.capacity
    # and the monolithic port join -> sort-based groupby on g
    mono = pct.groupby_aggregate(pct.join_tables(pl, pr, "k", "k"), "g",
                                 aggs).to_pandas()
    got = pg.to_pandas()
    pd.testing.assert_frame_equal(
        got.sort_values("g").reset_index(drop=True),
        mono.sort_values("g").reset_index(drop=True))


# ---------------------------------------------------------------------------
# left, right and outer joins through the pipeline (tests/test_pipeline.py's
# how cases): pieces materialize, and a sink takes the sort-based groupby
# ---------------------------------------------------------------------------

HOW_AGGS = [("a", "sum"), ("b", "sum"), ("b", "count"), ("a", "max")]


@pytest.fixture()
def no_cap_cache():
    """The reference materializes a piece join at the capacity an earlier
    call with the same signature needed, when that is larger; the port
    has no such cache, so a case comparing capacities starts without
    it."""
    from cylon_tpu.relational import join as rjoin
    rjoin._CAP_CACHE.clear()


def _assert_live_layout(ref, port):
    """Same rows per shard (the concatenation's padding is the
    reference's leftover block content, so it is not compared)."""
    _assert_same(ref, port)
    np.testing.assert_array_equal(port.valid_counts, ref.valid_counts)
    assert port.capacity == ref.capacity
    assert port.grouped_by == ref.grouped_by


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("how", ["left", "right", "outer"])
def test_pipelined_how_matches_reference(env1, penv, worlds4, monkeypatch,
                                         no_cap_cache, w, how):
    """Keys in [0, 250) on the left and [100, 350) on the right, so both
    sides hold unmatched rows, n_chunks = 3: the concatenated pieces, and
    a GroupBySink on the join key (whose groups over a null ``a`` or
    ``b`` sum as the reference sums them)."""
    renv, penv_w = _world(w, env1, penv, worlds4, monkeypatch)
    ldf, rdf = _pipe_frames(7)
    rl, rr = rct.Table.from_pandas(ldf, renv), rct.Table.from_pandas(rdf,
                                                                     renv)
    pl, pr = pct.Table.from_pandas(ldf, penv_w), pct.Table.from_pandas(
        rdf, penv_w)
    out = pct.pipelined_join(pl, pr, "k", "k", how=how, n_chunks=3)
    _assert_live_layout(r_pipe(rl, rr, "k", "k", how=how, n_chunks=3), out)
    assert out.row_count == len(ldf.merge(rdf, on="k", how=how))
    rs, ps = RSink("k", HOW_AGGS), pct.GroupBySink("k", HOW_AGGS)
    r_pipe(rl, rr, "k", "k", how=how, n_chunks=3, sink=rs)
    sp.reset_counts()
    pct.pipelined_join(pl, pr, "k", "k", how=how, n_chunks=3, sink=ps)
    assert sp.COUNTS["launches"] == 0     # CPU tensors: plain version only
    assert ps._disjoint
    _assert_live_layout(rs.finalize(), ps.finalize())


@pytest.mark.parametrize("how", ["left", "right", "outer"])
def test_pipelined_how_null_and_string_keys(env4, how, monkeypatch,
                                            no_cap_cache):
    """Null-key and dictionary-string groups stay whole in one range
    (tests/test_pipeline.py::test_pipelined_join_null_and_string_keys)."""
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    monkeypatch.setattr(rconfig, "BROADCAST_JOIN_ROWS", 0)
    rng = np.random.default_rng(8)
    n = 1500
    ldf = pd.DataFrame({"k": rng.choice(["ant", "bee", "cow", "dog", "elk"],
                                        n).astype(object),
                        "a": rng.random(n)})
    rdf = pd.DataFrame({"k": rng.choice(["bee", "cow", "dog", "fox"],
                                        n // 2).astype(object),
                        "b": rng.random(n // 2)})
    ldf.loc[ldf.index % 7 == 0, "k"] = None
    rdf.loc[rdf.index % 5 == 0, "k"] = None
    penv4 = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    _assert_live_layout(
        r_pipe(rct.Table.from_pandas(ldf, env4),
               rct.Table.from_pandas(rdf, env4), "k", "k", how=how,
               n_chunks=3),
        pct.pipelined_join(pct.Table.from_pandas(ldf, penv4),
                           pct.Table.from_pandas(rdf, penv4), "k", "k",
                           how=how, n_chunks=3))


@pytest.mark.parametrize("case", ["exact_capacity", "no_qualifying_range"])
@pytest.mark.parametrize("how", ["left", "right", "outer"])
def test_pipelined_how_edge_ranges(env1, penv, no_cap_cache, case, how):
    """A build side exactly at its capacity (no padding row to serve as
    the +infinity splitter) and a 2-row build whose range 0 snaps empty
    while every probe key routes there (tests/test_pipeline.py::
    TestExactCapacityAllHows)."""
    rng = np.random.default_rng(9)
    if case == "exact_capacity":
        n = 4096
        bdf = pd.DataFrame({"k": np.full(n, 7, np.int64),
                            "b": rng.random(n)})
        pdf = pd.DataFrame({"k": np.where(np.arange(96) % 2 == 0, 7, 9)
                            .astype(np.int64), "a": rng.random(96)})
    else:
        bdf = pd.DataFrame({"k": np.array([10, 20], np.int64),
                            "b": [1.0, 2.0]})
        pdf = pd.DataFrame({"k": np.array([1, 2, 3], np.int64),
                            "a": [0.1, 0.2, 0.3]})
    rl, rr, pl, pr = _tables(pdf, bdf, env1, penv)
    out = pct.pipelined_join(pl, pr, "k", "k", how=how, n_chunks=4)
    _assert_live_layout(r_pipe(rl, rr, "k", "k", how=how, n_chunks=4), out)
    assert out.row_count == len(pdf.merge(bdf, on="k", how=how))


# ---------------------------------------------------------------------------
# the chunked set operation and its row chunks
# ---------------------------------------------------------------------------

def _setop_frames(seed=11):
    """Two frames of (k, s) rows with repeats within and across chunks,
    a nullable key and a string column."""
    rng = np.random.default_rng(seed)

    def frame(n, lo):
        k = pd.array(rng.integers(lo, lo + 40, n), dtype="Int64")
        k[rng.random(n) < 0.05] = pd.NA
        return pd.DataFrame({"k": k,
                             "s": rng.choice(["x", "y", "z"], n)
                             .astype(object)})

    return frame(700, 0), frame(500, 20)


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("op", ["union", "intersect", "subtract"])
def test_pipelined_set_op_matches_reference(env1, penv, worlds4, monkeypatch,
                                            w, op):
    """``pipelined_set_op(n_chunks=3)`` against the reference's, layout
    included; its rows equal the monolithic set operation's."""
    from cylon_tpu.exec import pipelined_set_op as r_pipe_setop
    renv, penv_w = _world(w, env1, penv, worlds4, monkeypatch)
    a, b = _setop_frames()
    ra, rb = rct.Table.from_pandas(a, renv), rct.Table.from_pandas(b, renv)
    pa, pb = pct.Table.from_pandas(a, penv_w), pct.Table.from_pandas(b,
                                                                     penv_w)
    out = pct.pipelined_set_op(pa, pb, op, n_chunks=3)
    assert_layout(r_pipe_setop(ra, rb, op, n_chunks=3), out)

    def row_set(t):
        d = t.to_pydict()
        return sorted(zip([None if x is None or x != x else int(x)
                           for x in d["k"]], d["s"]),
                      key=lambda r: (r[0] is None, r[0] or 0, r[1]))

    assert row_set(out) == row_set(pct.set_operation(pa, pb, op))


@pytest.mark.parametrize("n_chunks", [1, 3, 5])
def test_chunk_table_matches_reference(env1, penv, worlds4, monkeypatch,
                                       n_chunks):
    """Every chunk's layout, and the chunks in order cover the table."""
    from cylon_tpu.exec import chunk_table as r_chunks
    renv, penv4 = _world(4, env1, penv, worlds4, monkeypatch)
    a, _ = _setop_frames()
    rt, pt = rct.Table.from_pandas(a, renv), pct.Table.from_pandas(a, penv4)
    rc, pc = r_chunks(rt, n_chunks), pct.chunk_table(pt, n_chunks)
    assert len(pc) == len(rc) == max(n_chunks, 1)
    for i in range(len(pc)):
        assert_layout(rc[i], pc[i])
    assert sum(c.row_count for c in pc) == pt.row_count
    if n_chunks > 1:
        assert_layout(rc[-1], pc[-1])
        with pytest.raises(IndexError):
            pc[n_chunks]
