"""Parity of the adaptive skew-split join: cylon_tpu_torch's
``relational/skew.py`` (with ``obs/sketch.py``, ``common.sample_key_rows``,
``shuffle.skew_split_targets`` and ``repart.place_by_global_pos``) against
cylon_tpu's on the CPU, at world sizes 4 (``env4``) and 8 (``env8``); the
port runs on ``VirtualMeshConfig(W, device="cpu")``.  Both packages run
at their defaults, the split armed.

The cases mirror tests/test_skew.py's ``TestAdaptiveSkewSplit``.  Held
bit for bit: the Misra-Gries sketch on one weighted stream, the sampled
key rows, the plan's ``summary()`` with its ``plan_hash``, the split
exchange's layout, and each join type's stitched output — ``valid_counts``
(the even layout), every shard's rows in order, ``grouped_by`` None.  The
fused join → groupby under a plan holds integers bit-equal and floats to
the tolerance of tests/test_torch_groupby_sort.py (the member partials of
a heavy key fold in rank order in both packages, but each shard's fused
float sums may associate differently).  A case about the unsplit plan
itself switches both packages' ``SKEW_SPLIT`` off."""

import jax
import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu import config as rconfig
from cylon_tpu.obs.sketch import MisraGries as RMisraGries
from cylon_tpu.relational import groupby_aggregate as r_groupby
from cylon_tpu.relational import join as rjoin
from cylon_tpu.relational import join_tables as r_join
from cylon_tpu.relational import skew as rskew
from cylon_tpu.relational.common import sample_key_rows as r_sample
from cylon_tpu.relational.repart import place_by_global_pos as r_place
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from cylon_tpu_torch.obs.sketch import MisraGries as PMisraGries
from cylon_tpu_torch.relational import join as pjoin
from cylon_tpu_torch.relational import skew as pskew
from cylon_tpu_torch.relational.common import sample_key_rows as p_sample
from cylon_tpu_torch.relational.repart import (even_partition_counts,
                                               place_by_global_pos as p_place)
from cylon_tpu_torch.status import ExecutionError, InvalidError
from cylon_tpu_torch.utils import timing
from test_torch_groupby_sort import _scale, assert_same
from test_torch_shuffle import assert_layout

HOWS = ["inner", "left", "right", "outer"]


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Release the reference's compiled XLA:CPU programs when the module
    ends (tests/run_all.py: its compiler crashes more often in
    long-lived processes)."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    # the reference materializes at the capacity an earlier call with the
    # same signature needed (its speculative dispatch); the port has none
    rjoin._CAP_CACHE.clear()
    rskew.record_plan(None)
    pskew.record_plan(None)


@pytest.fixture(scope="module")
def envs(env4, env8):
    return {4: env4, 8: env8}


def penv(w):
    return pct.CylonEnv(VirtualMeshConfig(w), device="cpu")


def set_split(monkeypatch, on: bool) -> None:
    monkeypatch.setattr(rconfig, "SKEW_SPLIT", on)
    monkeypatch.setattr(pconfig, "SKEW_SPLIT", on)


def skewed_pair(seed=0, n=24_000, frac=0.6, build_hot=1):
    """tests/test_skew.py's ``_skewed_pair``: key 700 holds ``frac`` of
    the probe rows and ``build_hot`` build rows; the build side is large
    enough that the broadcast route does not take the join."""
    rng = np.random.default_rng(seed)
    mv, hot = 2000, np.int64(700)
    lk = rng.integers(0, mv, n).astype(np.int64)
    lk = np.where(rng.random(n) < frac, hot, lk)
    nb = n // 2
    rk = rng.integers(0, mv, nb).astype(np.int64)
    rk[rk == hot] = hot + 1
    rk[:build_hot] = hot
    ldf = pd.DataFrame({"k": lk,
                        "a": rng.integers(0, 1000, n).astype(np.int64),
                        "f": rng.normal(size=n).astype(np.float32)})
    rdf = pd.DataFrame({"k": rk,
                        "b": rng.integers(0, 1000, nb).astype(np.int64)})
    return ldf, rdf


def tables(ldf, rdf, envs, w):
    return ((rct.Table.from_pandas(ldf, envs[w]),
             rct.Table.from_pandas(rdf, envs[w])),
            (pct.Table.from_pandas(ldf, penv(w)),
             pct.Table.from_pandas(rdf, penv(w))))


def plans_equal():
    """Both packages adopted a plan, and the same one."""
    rp, pp = rskew.last_plan(), pskew.last_plan()
    assert rp is not None and pp is not None
    assert pp.summary() == rp.summary()
    assert pp.plan_hash() == rp.plan_hash()
    return pp


def test_misra_gries_same_stream():
    """The copied sketch absorbs a weighted stream with decrements into
    the same counters, order and error bound."""
    rng = np.random.default_rng(3)
    r, p = RMisraGries(k=8), PMisraGries(k=8)
    for _ in range(5):
        vals = rng.zipf(1.4, 3000).astype(np.uint32) % 500
        wts = rng.random(3000)
        r.update(vals, wts)
        p.update(vals, wts)
    r.update(np.arange(40, dtype=np.uint32))
    p.update(np.arange(40, dtype=np.uint32))
    assert p.items() == r.items()
    assert p.shares() == r.shares()
    assert p.error_bound == r.error_bound and p.n == r.n


@pytest.mark.parametrize("w", [4, 8])
def test_sample_key_rows(envs, w):
    """Values, validity bits, hashes and weights of the sample, on a
    two-column key with a nullable float column."""
    rng = np.random.default_rng(5)
    n = 5000
    f = rng.normal(size=n)
    f[rng.random(n) < 0.2] = np.nan
    df = pd.DataFrame({"k": rng.integers(0, 50, n).astype(np.int64),
                       "f": pd.array(np.where(np.isnan(f), None, f),
                                     dtype="Float64")})
    (rt, _), (pt, _) = tables(df, df, envs, w)
    ref = r_sample(rt, ["k", "f"], m=64)
    got = p_sample(pt, ["k", "f"], m=64)
    for a, b in zip(ref[:2], got[:2]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(y, x)
    for x, y in zip(ref[2:4], got[2:4]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(y, x)
    assert ref[4] == got[4]


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("how", HOWS)
def test_all_hows_stitched(envs, w, how):
    """Every join type under a plan: the same plan, and the stitched
    output equal to the reference's in layout and every row — the even
    layout, ``grouped_by`` None."""
    ldf, rdf = skewed_pair(build_hot=3)
    (rl, rr), (pl, pr) = tables(ldf, rdf, envs, w)
    if how == "right":
        # the probe side of a right join is the right table
        ref = r_join(rr, rl, "k", "k", how=how)
        out = pct.join_tables(pr, pl, "k", "k", how=how)
    else:
        ref = r_join(rl, rr, "k", "k", how=how)
        out = pct.join_tables(pl, pr, "k", "k", how=how)
    plan = plans_equal()
    assert int(plan.fanout.max()) >= 2
    assert out.grouped_by is None and ref.grouped_by is None
    assert_layout(ref, out)
    np.testing.assert_array_equal(
        out.valid_counts, even_partition_counts(out.row_count, w))


@pytest.mark.parametrize("w", [4, 8])
def test_split_exchange_layout(envs, w):
    """The split exchange itself: both sides' layouts after
    ``_shuffle_for_join``, and the probe side balanced."""
    ldf, rdf = skewed_pair(frac=0.9)
    (rl, rr), (pl, pr) = tables(ldf, rdf, envs, w)
    rls, rrs, rplan = rjoin._shuffle_for_join(rl, rr, ["k"], ["k"],
                                              "inner", envs[w])
    pls, prs, pplan = pjoin._shuffle_for_join(pl, pr, ["k"], ["k"],
                                              "inner", pl.env)
    assert isinstance(pplan, pskew.SkewPlan)
    assert pplan.summary() == rplan.summary()
    assert_layout(rls, pls)
    assert_layout(rrs, prs)
    assert int(pls.valid_counts.max()) <= 2 * (len(ldf) // w) + 1024


@pytest.mark.parametrize("w", [4, 8])
def test_fused_groupby_combines_heavy_partials(envs, w):
    """join → groupby-sum/count on the join key takes the fused pushdown
    and combines the heavy key's member partials onto its home rank: the
    result and its layout equal the reference's."""
    ldf, rdf = skewed_pair()
    (rl, rr), (pl, pr) = tables(ldf, rdf, envs, w)
    aggs = [("a", "sum"), ("b", "sum"), ("f", "sum"), ("a", "count")]
    ref = r_groupby(r_join(rl, rr, "k", "k"), "k", aggs)
    timing.reset()
    out = pct.groupby_aggregate(pct.join_tables(pl, pr, "k", "k"), "k",
                                aggs)
    assert timing.counts().get("skew.partial_combine") == 1
    assert "join.skew_stitch" not in timing.counts()
    plans_equal()
    assert out.grouped_by == ("k",)
    assert_same(ref, out, _scale(ldf) * len(rdf))


def test_min_max_groupby_consumes_unstitched(envs):
    """min/max decline the pushdown under a plan; the groupby takes the
    split layout, and the stitch never runs."""
    ldf, rdf = skewed_pair()
    (rl, rr), (pl, pr) = tables(ldf, rdf, envs, 8)
    aggs = [("a", "min"), ("a", "max"), ("b", "sum")]
    ref = r_groupby(r_join(rl, rr, "k", "k"), "k", aggs)
    timing.reset()
    out = pct.groupby_aggregate(pct.join_tables(pl, pr, "k", "k"), "k",
                                aggs)
    assert timing.counts().get("skew.stitch_elided") == 1
    assert "join.skew_stitch" not in timing.counts()
    assert_same(ref, out)


def test_materialized_join_groupby_skips_stitch(envs):
    """A materialized (left) skew join feeds a groupby its split layout
    (``StitchState``): no stitch, the reference's answer."""
    ldf, rdf = skewed_pair()
    (rl, rr), (pl, pr) = tables(ldf, rdf, envs, 4)
    ref = r_groupby(r_join(rl, rr, "k", "k", how="left"), "k",
                    [("b", "sum"), ("a", "max")])
    timing.reset()
    out = pct.groupby_aggregate(pct.join_tables(pl, pr, "k", "k",
                                                how="left"), "k",
                                [("b", "sum"), ("a", "max")])
    assert timing.counts().get("skew.stitch_elided") == 1
    assert "join.skew_stitch" not in timing.counts()
    assert_same(ref, out)


def test_null_heavy_key(envs):
    """A heavy NULL key splits like a value (the sampled tuple carries
    its validity bit)."""
    rng = np.random.default_rng(7)
    n = 24_000
    lk = rng.integers(0, 2000, n).astype(np.float64)
    lk[rng.random(n) < 0.6] = np.nan
    rk = rng.integers(0, 2000, n // 2).astype(np.float64)
    rk[:2] = np.nan
    ldf = pd.DataFrame({"k": pd.array(np.where(np.isnan(lk), None, lk),
                                      dtype="Float64"),
                        "a": rng.random(n)})
    rdf = pd.DataFrame({"k": pd.array(np.where(np.isnan(rk), None, rk),
                                      dtype="Float64"),
                        "b": rng.random(n // 2)})
    (rl, rr), (pl, pr) = tables(ldf, rdf, envs, 8)
    ref = r_join(rl, rr, "k", "k", how="inner")
    out = pct.join_tables(pl, pr, "k", "k", how="inner")
    plan = plans_equal()
    assert not plan.valids[0][0]
    assert_layout(ref, out)


def test_float_key(envs):
    """A float64 heavy key (NaN-free) with -0.0 and +0.0 among the light
    keys."""
    rng = np.random.default_rng(8)
    n = 24_000
    lk = rng.integers(0, 2000, n) * 0.5
    lk[rng.random(n) < 0.7] = 3.25
    lk[:50] = -0.0
    rk = rng.integers(0, 2000, n // 2) * 0.5
    rk[:3] = 3.25
    ldf = pd.DataFrame({"k": lk, "a": rng.integers(0, 9, n)})
    rdf = pd.DataFrame({"k": rk, "b": rng.integers(0, 9, n // 2)})
    (rl, rr), (pl, pr) = tables(ldf, rdf, envs, 4)
    ref = r_join(rl, rr, "k", "k", how="outer")
    out = pct.join_tables(pl, pr, "k", "k", how="outer")
    plans_equal()
    assert_layout(ref, out)


def test_multicol_and_string_keys(envs):
    """A two-column key whose second column is a dictionary string."""
    rng = np.random.default_rng(9)
    n = 24_000
    hot = rng.random(n) < 0.7
    ldf = pd.DataFrame({
        "k1": np.where(hot, 3, rng.integers(100, 900, n)).astype(np.int64),
        "k2": np.where(hot, "x", "y"),
        "a": rng.integers(0, 100, n).astype(np.int64)})
    rk = rng.integers(0, 900, n // 2)
    rdf = pd.DataFrame({"k1": rk.astype(np.int64),
                        "k2": np.where(rk % 2 == 0, "x", "y"),
                        "b": rng.integers(0, 100, n // 2).astype(np.int64)})
    rdf.loc[0, ["k1", "k2"]] = [3, "x"]
    (rl, rr), (pl, pr) = tables(ldf, rdf, envs, 8)
    ref = r_join(rl, rr, ["k1", "k2"], ["k1", "k2"], how="inner")
    out = pct.join_tables(pl, pr, ["k1", "k2"], ["k1", "k2"], how="inner")
    plans_equal()
    assert_layout(ref, out)


def test_string_key(envs):
    """A single dictionary-string heavy key, left join."""
    rng = np.random.default_rng(10)
    n = 24_000
    words = np.array([f"w{i:04d}" for i in range(800)], object)
    lk = words[rng.integers(0, 800, n)]
    lk[rng.random(n) < 0.6] = "w0123"
    rdf = pd.DataFrame({"k": words[rng.integers(0, 800, n // 2)],
                        "b": rng.integers(0, 9, n // 2)})
    ldf = pd.DataFrame({"k": lk, "a": rng.integers(0, 9, n)})
    (rl, rr), (pl, pr) = tables(ldf, rdf, envs, 4)
    ref = r_join(rl, rr, "k", "k", how="left")
    out = pct.join_tables(pl, pr, "k", "k", how="left")
    plans_equal()
    assert_layout(ref, out)


def test_wide_heavy_tuple_vs_narrow_build(envs):
    """A heavy probe key above int32 against a build side whose bounds
    fit int32: the comparisons stay on the (hi, lo) pair, and the plan
    counts the wide key's true build rows (none)."""
    rng = np.random.default_rng(11)
    n = 24_000
    wide = np.int64((1 << 32) + 5)
    lk = rng.integers(0, 1000, n).astype(np.int64)
    lk = np.where(rng.random(n) < 0.6, wide, lk)
    ldf = pd.DataFrame({"k": lk, "a": rng.integers(0, 100, n)})
    rdf = pd.DataFrame({"k": rng.integers(0, 1000, n).astype(np.int64),
                        "b": rng.integers(0, 100, n)})
    (rl, rr), (pl, pr) = tables(ldf, rdf, envs, 8)
    ref = r_join(rl, rr, "k", "k", how="left")
    out = pct.join_tables(pl, pr, "k", "k", how="left")
    plan = plans_equal()
    assert int(plan.n_build[0]) == 0
    assert_layout(ref, out)


def test_replication_guard_rejects_heavy_build(envs, monkeypatch):
    """A key heavy on BOTH sides does not split: the guard drops it and
    both packages run the hash plan."""
    for cfg in (rconfig, pconfig):
        monkeypatch.setattr(cfg, "SKEW_GUARD_ROWS", 128)
        monkeypatch.setattr(cfg, "SKEW_GUARD_RATIO", 2.0)
    # 3,000 probe rows, 70% on key 700, against 1,000 build rows, 300 of
    # them on key 700 (300 · 8 > 2 · 1,000); the probe under 4x the build
    # keeps the broadcast route off
    ldf, rdf = skewed_pair(n=3000, frac=0.7)
    # a copy: the frame's array may be read-only
    rk = rdf["k"].to_numpy()[:1000].copy()
    rk[:300] = 700
    rdf = pd.DataFrame({"k": rk, "b": rdf["b"].to_numpy()[:1000]})
    (rl, rr), (pl, pr) = tables(ldf, rdf, envs, 8)
    ref = r_join(rl, rr, "k", "k", how="inner")
    timing.reset()
    out = pct.join_tables(pl, pr, "k", "k", how="inner")
    assert rskew.last_plan() is None and pskew.last_plan() is None
    assert "join.skew_split" not in timing.counts()
    assert out.grouped_by == ref.grouped_by == ("k",)
    assert_layout(ref, out)
    assert out.row_count == len(ldf.merge(rdf, on="k"))
    # the guard, not the detector, kept the hash plan: above its row
    # floor the same join splits
    monkeypatch.setattr(pconfig, "SKEW_GUARD_ROWS", 65536)
    pct.join_tables(pl, pr, "k", "k", how="inner")
    assert pskew.last_plan() is not None


def test_unarmed_at_zero_skew(envs):
    """A uniform key with the route armed: no plan, no extra exchange —
    the hash plan's layout and ``grouped_by``."""
    rng = np.random.default_rng(12)
    n = 24_000
    ldf = pd.DataFrame({"k": rng.integers(0, n, n), "a": rng.random(n)})
    rdf = pd.DataFrame({"k": rng.integers(0, n, n), "b": rng.random(n)})
    (rl, rr), (pl, pr) = tables(ldf, rdf, envs, 8)
    ref = r_join(rl, rr, "k", "k", how="left")
    timing.reset()
    out = pct.join_tables(pl, pr, "k", "k", how="left")
    assert pskew.last_plan() is None
    counts = timing.counts()
    assert "join.skew_split" not in counts
    assert "skew.split_exchange" not in counts
    assert out.grouped_by == ref.grouped_by == ("k",)
    assert_layout(ref, out)


@pytest.mark.parametrize("how", ["inner", "outer"])
def test_escape_hatch_and_split_equals_unsplit(envs, monkeypatch, how):
    """The port's split output reads back row for row as its own unsplit
    one; with both switches off (the unsplit plan is the case) both
    packages take the hash plan and agree, layout included."""
    ldf, rdf = skewed_pair(n=8000)
    _, (pl, pr) = tables(ldf, rdf, envs, 8)
    split = pct.join_tables(pl, pr, "k", "k", how=how).to_pydict()
    assert pskew.last_plan() is not None
    set_split(monkeypatch, False)
    pskew.record_plan(None)
    (rl, rr), (pl, pr) = tables(ldf, rdf, envs, 8)
    ref = r_join(rl, rr, "k", "k", how=how)
    out = pct.join_tables(pl, pr, "k", "k", how=how)
    assert pskew.last_plan() is None and rskew.last_plan() is None
    assert_layout(ref, out)
    # bit- and order-equal: no sorting before the compare
    pd.testing.assert_frame_equal(pd.DataFrame(split),
                                  pd.DataFrame(out.to_pydict()))


def test_outer_join_regression(env4):
    """Both packages at their defaults, W = 4: an outer join of 20,000
    probe rows, 60% on key 777, against 5,000 uniform build rows gives
    equal valid counts, ``grouped_by``, rows in order and plan hash (the
    port once returned the unsplit hash layout here)."""
    rng = np.random.default_rng(0)
    n = 20_000
    lk = rng.integers(0, 5000, n)
    lk[rng.random(n) < 0.6] = 777
    ldf = pd.DataFrame({"k": lk.astype(np.int64), "a": rng.random(n)})
    rdf = pd.DataFrame({"k": rng.integers(0, 5000, 5000).astype(np.int64),
                        "b": rng.random(5000)})
    ref = r_join(rct.Table.from_pandas(ldf, env4),
                 rct.Table.from_pandas(rdf, env4), "k", "k", how="outer")
    out = pct.join_tables(pct.Table.from_pandas(ldf, penv(4)),
                          pct.Table.from_pandas(rdf, penv(4)), "k", "k",
                          how="outer")
    plan = plans_equal()
    assert plan.summary()["fanout"] == [3]
    np.testing.assert_array_equal(out.valid_counts, ref.valid_counts)
    assert out.grouped_by is None and ref.grouped_by is None
    assert_layout(ref, out)


def test_stitch_accounting_error(envs):
    """Counts that disagree with the join output raise the stitch's
    typed accounting error instead of placing rows wrongly."""
    ldf, rdf = skewed_pair(n=8000)
    _, (pl, pr) = tables(ldf, rdf, envs, 4)
    out = pct.join_tables(pl, pr, "k", "k", how="left")
    st = out.op_state
    assert isinstance(st, pskew.StitchState)
    st.plan.n_probe = st.plan.n_probe + 1
    with pytest.raises(ExecutionError, match="accounting diverged"):
        pskew.stitch_join_output(st.pre, st.key_out_names, st.plan, st.how,
                                 st.un_counts)


@pytest.mark.parametrize("w", [4, 8])
def test_place_by_global_pos(envs, w):
    """Rows placed by a permutation of global positions land on the even
    layout in position order, as in the reference; positions that are
    not a permutation raise ``InvalidError`` — also a repeated position
    whose destination counts still match the even layout, which would
    otherwise repeat one row and drop another."""
    rng = np.random.default_rng(13)
    n = 3001
    df = pd.DataFrame({"k": rng.integers(0, 99, n),
                       "f": rng.normal(size=n),
                       "s": rng.choice(["a", "bb", "c"], n)})
    rt = rct.Table.from_pandas(df, envs[w])
    pt = pct.Table.from_pandas(df, penv(w))
    perm = rng.permutation(n).astype(np.int64)
    cap, vc = pt.capacity, np.asarray(pt.valid_counts)
    pos = np.full(w * cap, n, np.int64)
    off = 0
    for r in range(w):
        pos[r * cap:r * cap + vc[r]] = perm[off:off + vc[r]]
        off += vc[r]
    import torch
    ref = r_place(rt, pos, n)
    out = p_place(pt, torch.from_numpy(pos), n)
    assert_layout(ref, out)
    got = out.to_pydict()["k"]
    want = np.empty(n, np.int64)
    want[perm] = df["k"].to_numpy()
    np.testing.assert_array_equal(np.asarray(got), want)
    bad = pos.copy()
    bad[:vc[0]] = 0
    with pytest.raises(InvalidError, match="not a permutation"):
        p_place(pt, torch.from_numpy(bad), n)
    first = np.nonzero(pos < even_partition_counts(n, w)[0])[0]
    bad = pos.copy()
    bad[first[1]] = bad[first[0]]       # both in destination 0's range
    with pytest.raises(InvalidError, match="not a permutation"):
        p_place(pt, torch.from_numpy(bad), n)

