"""Parity of the query profiler: cylon_tpu_torch's ``obs/plan.py`` and
``obs/comm.py`` with the operators' plan nodes, against cylon_tpu's on
the CPU (the reference on its ``env1``/``env4`` mesh, the port on
``VirtualMeshConfig(W, device="cpu")``).  Mirrors tests/test_explain.py.

Held equal between the packages: ``explain(...).static_dict()`` of
bench.py's join → groupby on both routes, configuration 5's skewed join
→ groupby at its small shape, the set operations and the sample sort, at
W = 1 and 4, apart from the deviations listed in :data:`DEVIATIONS`; and
the comm matrix of the same exchanges (rows and bytes).  Held against
the reference's tolerances on the port alone: ``reconcile()``, the
dispatch/wait split, the key profile (within 2x of the true share), the
comm-matrix sums against the exchange counters, and the unarmed
contract (no node, no comm record, no file).
"""

import os

import jax
import numpy as np
import pytest

import cylon_tpu as rct
from cylon_tpu import obs as robs
from cylon_tpu.exec import GroupBySink as RSink
from cylon_tpu.exec import pipelined_join as r_pjoin
from cylon_tpu.obs import comm as rcomm
from cylon_tpu.relational import join as rjoin
from cylon_tpu.relational import skew as rskew
import cylon_tpu_torch as pct
from cylon_tpu_torch import obs as pobs
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from cylon_tpu_torch.obs import comm as pcomm
from cylon_tpu_torch.obs import metrics as pmetrics
from cylon_tpu_torch.obs import plan as pplan
from cylon_tpu_torch.relational import skew as pskew
from cylon_tpu_torch.status import InvalidError
from cylon_tpu_torch.utils import timing

#: the static trees' known differences, each a (path, port, reference)
#: rewrite applied to the reference's tree before the comparison:
#: * ``donate``: the reference's pipelined join donates its sorted tables
#:   into the packed sources (``CYLON_TPU_DONATE``, on by default); the
#:   port donates no buffer (ROADMAP.md "No counterpart, by decision").
DEVIATIONS = {"pipelined_join": {"donate": (False, True)}}


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Release the reference's compiled XLA:CPU programs at module end."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean():
    for comm in (rcomm, pcomm):
        comm.arm(False)
        comm._rearm()
        comm.reset()
    timing.reset()
    rjoin._CAP_CACHE.clear()
    rskew.record_plan(None)
    pskew.record_plan(None)
    yield
    for comm in (rcomm, pcomm):
        comm.arm(False)
        comm._rearm()
        comm.reset()
    timing.reset()


@pytest.fixture(scope="module")
def renvs(env1, env4):
    return {1: env1, 4: env4}


def penv(w):
    return pct.CylonEnv(VirtualMeshConfig(w), device="cpu")


def bench_inputs(n, seed=42, skew=0.0):
    """bench.py's tables (keys uniform in [0, 0.9 n)); ``skew``: that
    share of the probe's rows on the one hot key, which occurs once on
    the build side (bench.py --skew)."""
    rng = np.random.default_rng(seed)
    mv = max(int(n * 0.9), 1)
    lk = rng.integers(0, mv, n).astype(np.int64)
    if skew:
        hot = np.int64(mv // 2)
        lk = np.where(rng.random(n) < skew, hot, lk)
    a = rng.integers(0, mv, n).astype(np.int64)
    rk = rng.integers(0, mv, n).astype(np.int64)
    if skew:
        rk[rk == hot] = hot + 1
        rk[0] = hot
    b = rng.integers(0, mv, n).astype(np.int64)
    return {"k": lk, "a": a}, {"k": rk, "b": b}


def both_tables(renv, w, n=4000, skew=0.0):
    left, right = bench_inputs(n, skew=skew)
    pe = penv(w)
    return ((rct.Table.from_pydict(left, renv),
             rct.Table.from_pydict(right, renv)),
            (pct.Table.from_pydict(left, pe),
             pct.Table.from_pydict(right, pe)))


def r_mono(lt, rt):
    from cylon_tpu.relational import groupby_aggregate, join_tables
    j = join_tables(lt, rt, "k", "k", how="inner")
    return groupby_aggregate(j, "k", [("a", "sum"), ("b", "sum")])


def p_mono(lt, rt):
    j = pct.join_tables(lt, rt, "k", "k", how="inner")
    return pct.groupby_aggregate(j, "k", [("a", "sum"), ("b", "sum")])


def r_piped(lt, rt, n_chunks=3):
    sink = RSink("k", [("a", "sum"), ("b", "sum")])
    r_pjoin(lt, rt, "k", "k", how="inner", n_chunks=n_chunks, sink=sink)
    return sink.finalize()


def p_piped(lt, rt, n_chunks=3):
    sink = pct.GroupBySink("k", [("a", "sum"), ("b", "sum")])
    pct.pipelined_join(lt, rt, "k", "k", how="inner", n_chunks=n_chunks,
                       sink=sink)
    return sink.finalize()


def _jsonable(x):
    """Tuples and lists alike, numpy scalars as Python numbers."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def with_deviations(tree: dict) -> dict:
    """The reference's static tree with :data:`DEVIATIONS` applied."""
    def walk(d):
        for k, (port, ref) in DEVIATIONS.get(d["op"], {}).items():
            if d["attrs"].get(k) == ref:
                d["attrs"][k] = port
        for c in d["children"]:
            walk(c)
    tree = _jsonable(tree)
    for r in tree["roots"]:
        walk(r)
    return tree


def same_static(rq, pq):
    assert _jsonable(pq.static_dict()) == with_deviations(rq.static_dict())


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("route", ["monolithic", "pipelined"])
def test_bench_static_tree_matches_reference(renvs, w, route):
    """bench.py's join → groupby on both routes: the same operators,
    routes, keys, chunking and piece caps in both packages."""
    (rl, rr), (pl, pr) = both_tables(renvs[w], w)
    rf, pf = (r_mono, p_mono) if route == "monolithic" else (r_piped,
                                                              p_piped)
    rq, pq = robs.explain(rf, rl, rr), pobs.explain(pf, pl, pr)
    same_static(rq, pq)
    ops = {r.op for r in pq.roots}
    if route == "monolithic":
        assert {"join", "groupby"} <= ops
        g = next(r for r in pq.roots if r.op == "groupby")
        assert g.attrs["route"] == "fused_pushdown"
    else:
        root = pq.roots[0]
        assert root.op == "pipelined_join"
        assert root.attrs["route"] == "range_pipeline"
        assert root.attrs["n_ranges"] == 3
        assert [c.op for c in root.children].count("join.piece") == 3
        assert [c.op for c in root.children].count("shuffle") == (
            2 if w > 1 else 0)
    np.testing.assert_array_equal(
        np.asarray(pq.result.to_pydict()["a_sum"]),
        rq.result.to_pandas()["a_sum"].to_numpy())


def test_pipelined_single_range_deviation(renvs):
    """The listed deviation of the ``n_chunks == 1`` route (ROADMAP.md
    "Deviations that stay", PR 2): with a sink the port defers the join
    and the sink takes the fused pushdown, so no groupby node opens
    under the pipelined join; the reference materializes and its sink
    runs the sort-based groupby.  Both name the route ``monolithic``."""
    (rl, rr), (pl, pr) = both_tables(renvs[4], 4)
    rq = robs.explain(r_piped, rl, rr, 1)
    pq = pobs.explain(p_piped, pl, pr, 1)
    rroot, proot = rq.roots[0], pq.roots[0]
    assert rroot.attrs["route"] == proot.attrs["route"] == "monolithic"
    r_ops = [c.op for c in rroot.children]
    p_ops = [c.op for c in proot.children]
    assert "groupby" in r_ops and "groupby" not in p_ops
    assert [o for o in r_ops if o != "groupby"] == p_ops


def test_skewed_join_static_tree_matches_reference(renvs):
    """Configuration 5's skewed join → groupby at its small shape
    (bench.py --skew=0.9, W = 4): the split route with the same plan
    summary, the groupby taking the fused pushdown with its heavy
    partials combined."""
    (rl, rr), (pl, pr) = both_tables(renvs[4], 4, n=6000, skew=0.9)
    rq, pq = robs.explain(r_mono, rl, rr), pobs.explain(p_mono, pl, pr)
    same_static(rq, pq)
    join = next(r for r in pq.roots if r.op == "join")
    assert join.attrs["route"] == "skew_split"
    assert join.attrs["skew_plan"]["plan_hash"] \
        == pskew.last_plan().summary()["plan_hash"]


@pytest.mark.parametrize("op", ["union", "intersect", "subtract"])
def test_set_op_static_tree_matches_reference(renvs, op):
    (rl, rr), (pl, pr) = both_tables(renvs[4], 4, n=3000)
    from cylon_tpu.relational import set_operation as r_setop
    ra, rb = rl.project(["k"]), rr.project(["k"])
    pa, pb = pl.project(["k"]), pr.project(["k"])
    rq = robs.explain(r_setop, ra, rb, op)
    pq = pobs.explain(pct.set_operation, pa, pb, op)
    same_static(rq, pq)
    assert pq.roots[0].op == "set_op"
    assert pq.result.row_count == rq.result.row_count


@pytest.mark.parametrize("w", [1, 4])
def test_sample_sort_static_tree_matches_reference(renvs, w):
    (rl, _), (pl, _) = both_tables(renvs[w], w, n=3000)
    from cylon_tpu.relational import sort_table as r_sort
    for method in ("initial", "regular"):
        rq = robs.explain(r_sort, rl, "k", method=method)
        pq = pobs.explain(pct.sort_table, pl, "k", method=method)
        same_static(rq, pq)
        if w > 1:
            assert pq.roots[0].attrs["route"] == "sample_sort"


@pytest.mark.parametrize("route", ["monolithic", "pipelined"])
def test_analyze_reconciles_with_phase_table(route):
    """The reference's tolerances (tests/test_explain.py): node seconds
    at most the phase table's, unattributed ≤ max(5%, 0.02 s), per
    region within 2e-3 s; each node's seconds split into dispatch and
    wait; the analyze skeleton equal to explain's; the caller's timing
    mode restored."""
    left, right = bench_inputs(4000)
    pe = penv(4)
    lt, rt = pct.Table.from_pydict(left, pe), pct.Table.from_pydict(right,
                                                                   pe)
    f = p_mono if route == "monolithic" else p_piped
    assert timing.mode() is None
    qp = pobs.explain_analyze(f, lt, rt)
    assert timing.mode() is None
    rec = qp.reconcile()
    assert rec["phase_s"] > 0
    assert rec["node_s"] <= rec["phase_s"] + 1e-6
    assert abs(rec["unattributed_s"]) <= max(0.05 * rec["phase_s"], 0.02)
    for name, s in rec["per_phase_node_s"].items():
        assert s == pytest.approx(qp.global_phases[name]["s"],
                                  rel=1e-4, abs=2e-3), name

    def walk(n):
        assert n.seconds is not None and n.dispatch_s is not None
        assert n.seconds == pytest.approx(n.dispatch_s + n.block_s,
                                          rel=1e-4, abs=2e-3)
        for c in n.children:
            walk(c)
    for r in qp.roots:
        walk(r)
    assert qp.static_dict() == pobs.explain(f, lt, rt).static_dict()
    text = qp.render()
    assert "self=" in text and "phases: node" in text


def test_session_scope_absorbs_node_time():
    left, right = bench_inputs(3000)
    pe = penv(4)
    lt, rt = pct.Table.from_pydict(left, pe), pct.Table.from_pydict(right,
                                                                   pe)
    with timing.attribution_scope("tenant") as sc:
        pobs.explain_analyze(p_mono, lt, rt, reset_timings=False)
    assert sc.total_seconds() > 0
    assert "join.shuffle" in sc.snapshot()


@pytest.mark.parametrize("w", [3, 4])
def test_comm_matrix_cells_match_reference(w, env4):
    """One hash shuffle of the same table: the comm matrix's rows equal
    the reference's cell for cell, and so do the bytes (both exchanges
    move one int32 lane matrix of the same width: the int64 key and
    value narrowed to one lane each by their host-known bounds)."""
    import cylon_tpu as _r
    from cylon_tpu.ctx.context import CPUMeshConfig
    from cylon_tpu.relational.repart import shuffle_table as r_shuffle
    renv = env4 if w == 4 else _r.CylonEnv(config=CPUMeshConfig(
        world_size=w))
    (rl, _), (pl, _) = both_tables(renv, w, n=3000)
    rcomm.arm()
    pcomm.arm()
    r_shuffle(rl, ["k"])
    pct.shuffle_table(pl, ["k"])
    rrep, prep = rcomm.report(), pcomm.report()
    assert prep["rows"] == rrep["rows"]
    assert prep["bytes"] == rrep["bytes"]
    assert prep["row_sums_bytes"] == rrep["row_sums_bytes"]
    assert prep["col_sums_bytes"] == rrep["col_sums_bytes"]
    m = np.asarray(prep["rows"])
    assert int(m.sum()) == pl.row_count
    assert m.sum(axis=1).tolist() == [int(x) for x in pl.valid_counts]


def test_owner_label_reaches_plan_and_comm_matrix(env4):
    """The shuffle's ``owner`` label: a stream append's receive is
    ``stream.recv`` on its plan node and in the comm matrix's exchange
    log, a plain shuffle's ``shuffle.recv``, as in the reference."""
    from cylon_tpu.relational.repart import shuffle_table as r_shuffle
    from cylon_tpu.stream import StreamTable as RStream
    (rl, _), (pl, _) = both_tables(env4, 4, n=2000)
    batch = bench_inputs(2000)[0]
    rst = RStream(env4, key="k", name="s")
    pst = pct.stream.StreamTable(penv(4), key="k", name="s")
    rq = robs.explain(rst.append, dict(batch))
    pq = pobs.explain(pst.append, dict(batch))
    same_static(rq, pq)
    node = pq.static_dict()["roots"][0]
    assert node["op"] == "stream.append"
    assert node["children"][0]["attrs"]["owner"] == "stream.recv"
    sites = {}
    for comm, shuffle, t, st in ((rcomm, r_shuffle, rl, rst),
                                 (pcomm, pct.shuffle_table, pl, pst)):
        comm.arm()
        shuffle(t, ["k"])
        shuffle(t, ["k"], owner="unit.recv")
        st.append(dict(batch))
        sites[comm] = [e["site"] for e in comm.report()["recent"]]
    assert sites[pcomm] == sites[rcomm] \
        == ["shuffle.recv", "unit.recv", "stream.recv"]


def test_comm_sums_equal_exchange_counters():
    left, right = bench_inputs(4000)
    pe = penv(4)
    lt, rt = pct.Table.from_pydict(left, pe), pct.Table.from_pydict(right,
                                                                   pe)
    pcomm.arm()
    rows0 = pmetrics.counter("exchange_rows_total").value
    bytes0 = pmetrics.counter("exchange_bytes_total").value
    n0 = pmetrics.counter("exchange_count").value
    p_mono(lt, rt)
    p_piped(lt, rt)
    rep = pcomm.report()
    assert rep["exchanges"] == \
        pmetrics.counter("exchange_count").value - n0 >= 4
    assert rep["total_rows"] == \
        pmetrics.counter("exchange_rows_total").value - rows0
    assert rep["total_bytes"] == \
        pmetrics.counter("exchange_bytes_total").value - bytes0
    mb = np.asarray(rep["bytes"])
    assert mb.sum(axis=1).tolist() == rep["row_sums_bytes"]
    assert mb.sum(axis=0).tolist() == rep["col_sums_bytes"]
    qp = pobs.explain_analyze(p_mono, lt, rt, profile_keys=False)
    assert qp.to_dict()["comm_matrix"]["total_rows"] > 0


def test_unarmed_profile_never_touches_comm_state():
    left, right = bench_inputs(3000)
    pe = penv(4)
    lt, rt = pct.Table.from_pydict(left, pe), pct.Table.from_pydict(right,
                                                                   pe)
    assert not pcomm.armed()
    pobs.explain(p_mono, lt, rt)
    pobs.explain_analyze(p_mono, lt, rt)
    assert pcomm.matrix() is None
    pcomm.arm()
    rows0 = pmetrics.counter("exchange_rows_total").value
    p_mono(lt, rt)
    assert pcomm.report()["total_rows"] == \
        pmetrics.counter("exchange_rows_total").value - rows0


def test_key_profile_within_2x_of_truth():
    """A 0.9-hot key column: the profile names the hot key with a share
    within 2x of the truth, at the join node of an analyze run; with
    ``profile_keys=False`` no node carries a profile."""
    left, right = bench_inputs(20000, skew=0.9)
    pe = penv(4)
    lt, rt = pct.Table.from_pydict(left, pe), pct.Table.from_pydict(right,
                                                                   pe)
    hot = int(np.int64(int(20000 * 0.9) // 2))
    truth = float((left["k"] == hot).mean())
    prof = pplan.key_profile(lt, "k")
    top = prof["heavy"][0]
    assert top["key"] == hot
    assert truth / 2 <= top["share"] <= truth * 2
    assert prof["est_max_rank_share"] >= prof["max_key_share"]
    qp = pobs.explain_analyze(p_mono, lt, rt)
    join = next(r for r in qp.roots if r.op == "join")
    assert join.heavy["heavy"][0]["key"] == hot
    qp = pobs.explain_analyze(p_mono, lt, rt, profile_keys=False)

    def walk(n):
        assert n.heavy is None
        for c in n.children:
            walk(c)
    for r in qp.roots:
        walk(r)
    empty = pct.Table.from_pydict({"k": np.zeros(0, np.int64)}, pe)
    assert pplan.key_profile(empty, "k") is None


def test_unarmed_contract_and_nesting(tmp_path, monkeypatch):
    """No profile and no comm matrix: the exchange never calls
    ``comm.record``, no node exists and no file is written; the facade
    swallows writes; a nested profile raises ``InvalidError``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("CYLON_TPU_TORCH_COMM_MATRIX", raising=False)
    assert not pplan.active() and not pcomm.armed()

    def _boom(*a, **k):  # pragma: no cover - the assertion itself
        raise AssertionError("comm.record called while unarmed")
    monkeypatch.setattr(pcomm, "record", _boom)
    left, right = bench_inputs(3000)
    pe = penv(4)
    lt, rt = pct.Table.from_pydict(left, pe), pct.Table.from_pydict(right,
                                                                   pe)
    assert p_piped(lt, rt).row_count > 0
    assert pcomm.matrix() is None and pplan.current() is None
    assert os.listdir(tmp_path) == []
    with pplan.node("join", how="inner") as pn:
        assert not pn
        pn.set(rows_in=5)
        pn.annotate(route="x")
    pplan.annotate(route="y")
    assert pplan.current() is None
    with pytest.raises(InvalidError):
        pobs.explain(lambda: pobs.explain(p_mono, lt, rt))
