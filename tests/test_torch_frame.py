"""Parity of the DataFrame entry: ``cylon_tpu_torch.DataFrame`` against
``cylon_tpu.DataFrame`` on the CPU at world sizes 1 (``env1``) and 4
(``env4``; the port on ``VirtualMeshConfig(4, device="cpu")``).

Cases: the README Quickstart (``merge`` → ``groupby`` → ``sum``), BASELINE
configuration 3's query (``groupby`` → ``sum`` → ``sort_values``
descending), every ``agg`` spelling, the naming of ``quantile`` and
``median`` results, the other aggregation methods, ``sort_values``
methods, ``drop``/``rename``/projection, ``concat``, moving a frame to
another env, the frame's accessors, ``merge`` with every ``how`` and
``join`` with its default "left".  Both packages run the skew split at
its default, armed, and with ``BROADCAST_JOIN_ROWS`` at 0 (as in
tests/test_torch_distributed.py).

Held: the table layout (``valid_counts``, capacity, ``grouped_by``,
column names and dtypes), validity, integers and strings bit-equal, and
floats to tests/test_torch_groupby_sort.py's stated tolerance."""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu import config as rconfig
from cylon_tpu.relational import join as rjoin
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from test_torch_groupby_sort import _scale, assert_same


@pytest.fixture(autouse=True)
def same_routes(monkeypatch):
    monkeypatch.setattr(rconfig, "BROADCAST_JOIN_ROWS", 0)
    monkeypatch.setattr(pconfig, "BROADCAST_JOIN_ROWS", 0)
    # the reference materializes a join at the capacity an earlier call
    # with the same signature needed, when that is larger; the port has
    # no such cache, so each case starts without one
    rjoin._CAP_CACHE.clear()


@pytest.fixture(params=[1, 4])
def worlds(request, env1, env4):
    w = request.param
    return ({1: env1, 4: env4}[w],
            pct.CylonEnv(VirtualMeshConfig(w), device="cpu"))


def _frames(seed=0, n=600):
    rng = np.random.default_rng(seed)
    left = pd.DataFrame({"key": rng.integers(0, 120, n),
                         "a": rng.random(n),
                         "i": rng.integers(-99, 99, n)})
    right = pd.DataFrame({"key": rng.integers(0, 120, n // 2),
                          "b": rng.random(n // 2)})
    return left, right


def same(r, p, scale=0.0):
    assert_same(r.table, p.table, scale)
    assert p.columns == r.columns
    assert p.shape == r.shape and len(p) == len(r)


def test_quickstart(worlds):
    renv, penv = worlds
    left, right = _frames()
    r1, r2 = rct.DataFrame(left, env=renv), rct.DataFrame(right, env=renv)
    p1, p2 = pct.DataFrame(left, env=penv), pct.DataFrame(right, env=penv)
    same(r1.merge(r2, on="key"), p1.merge(p2, on="key"), _scale(left))
    rg = r1.merge(r2, on="key").groupby("key")[["a", "b"]].sum()
    pg = p1.merge(p2, on="key").groupby("key")[["a", "b"]].sum()
    same(rg, pg, _scale(left) * len(right))
    assert pg.columns == ["key", "a", "b"]


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer", "semi",
                                 "anti"])
def test_merge_every_how(worlds, how):
    """``merge`` with every join type; a left or outer merge followed by
    a groupby-sum takes the sort-based groupby over the materialized
    join, whose unmatched rows carry null payloads."""
    renv, penv = worlds
    left, right = _frames(3)
    r1, r2 = rct.DataFrame(left, env=renv), rct.DataFrame(right, env=renv)
    p1, p2 = pct.DataFrame(left, env=penv), pct.DataFrame(right, env=penv)
    rm, pm = r1.merge(r2, on="key", how=how), p1.merge(p2, on="key", how=how)
    same(rm, pm)
    if how in ("semi", "anti"):
        return
    assert len(pm) == len(left.merge(right, on="key", how=how))
    same(rm.groupby("key")[["a", "b"]].sum(),
         pm.groupby("key")[["a", "b"]].sum(), _scale(left) * len(right))


def test_join_default_left(worlds):
    """``DataFrame.join`` with its default "left": keys kept apart and
    every overlapping column suffixed."""
    renv, penv = worlds
    left, right = _frames(4)
    r = rct.DataFrame(left, env=renv).join(rct.DataFrame(right, env=renv),
                                           on="key")
    p = pct.DataFrame(left, env=penv).join(pct.DataFrame(right, env=penv),
                                           on="key")
    same(r, p)
    assert p.columns == ["keyl", "a", "i", "keyr", "b"]


def test_config3_query(worlds):
    """``groupby("k")[["a"]].sum().sort_values("a", ascending=False)``
    on bench.py's generator (seed 42, k and a uniform in [0, 0.9 n))."""
    renv, penv = worlds
    n = 4000
    rng = np.random.default_rng(42)
    k = rng.integers(0, int(0.9 * n), n)
    a = rng.integers(0, int(0.9 * n), n)
    outs = []
    for lib, env in ((rct, renv), (pct, penv)):
        df = lib.DataFrame({"k": k, "a": a}, env=env)
        outs.append(df.groupby("k")[["a"]].sum()
                    .sort_values("a", ascending=False))
    same(*outs)
    got = outs[1].to_pandas()
    assert got["a"].is_monotonic_decreasing and got["k"].is_unique
    exp = pd.DataFrame({"k": k, "a": a}).groupby("k", as_index=False).sum()
    pd.testing.assert_frame_equal(
        got.sort_values("k").reset_index(drop=True), exp)


@pytest.mark.parametrize("spec", [
    "sum", ["sum", "mean"], {"a": "sum", "i": ["min", "max", "count"]},
    [("a", "sum"), ("i", "mean"), ("a", "std")]],
    ids=["name", "names", "dict", "pairs"])
def test_agg_spellings(worlds, spec):
    renv, penv = worlds
    left, _ = _frames(1)
    r = rct.DataFrame(left, env=renv).groupby("key").agg(spec)
    p = pct.DataFrame(left, env=penv).groupby("key").agg(spec)
    same(r, p, _scale(left))


def test_aggregation_methods_and_naming(worlds):
    renv, penv = worlds
    left, _ = _frames(2)
    rg = rct.DataFrame(left, env=renv).groupby("key")
    pg = pct.DataFrame(left, env=penv).groupby("key")
    for name in ("count", "min", "max", "mean", "var", "std", "nunique",
                 "median"):
        same(getattr(rg, name)(), getattr(pg, name)(), _scale(left))
    rq, pq = rg.quantile(0.25), pg.quantile(0.25)
    same(rq, pq, _scale(left))
    assert pq.columns == ["key", "a", "i"]
    assert pg.median().columns == ["key", "a", "i"]
    same(rg[["i"]].agg([("i", "quantile", 0.75)]),
         pg[["i"]].agg([("i", "quantile", 0.75)]))
    assert pg.agg([("i", "quantile", 0.75)]).columns == ["key",
                                                         "i_quantile_0.75"]


@pytest.mark.parametrize("method", ["initial", "regular"])
def test_sort_values(worlds, method):
    renv, penv = worlds
    left, _ = _frames(3)
    kw = dict(ascending=[False, True], method=method)
    same(rct.DataFrame(left, env=renv).sort_values(["i", "a"], **kw),
         pct.DataFrame(left, env=penv).sort_values(["i", "a"], **kw))


def test_projection_concat_and_env_move(worlds, env1):
    renv, penv = worlds
    left, right = _frames(4)
    r, p = rct.DataFrame(left, env=renv), pct.DataFrame(left, env=penv)
    same(r[["a", "key"]], p[["a", "key"]])
    same(r.drop("a"), p.drop("a"))
    same(r.rename({"a": "x"}), p.rename({"a": "x"}))
    same(rct.concat([r, r]), pct.concat([p, p]))
    # an op with env= moves the other frame there first (a host copy);
    # the join's capacity is left out: the reference's join reuses a
    # capacity predicted at its call site by earlier tests
    p1 = pct.DataFrame(right, env=pct.CylonEnv(device="cpu"))
    r1 = rct.DataFrame(right, env=env1)
    same(r1._to_env(renv), p1._to_env(penv))
    key = ["key", "a", "i", "b"]
    pd.testing.assert_frame_equal(
        p.merge(p1, on="key", env=penv).to_pandas().sort_values(key)
        .reset_index(drop=True),
        r.merge(r1, on="key", env=renv).to_pandas().sort_values(key)
        .reset_index(drop=True))
    assert p.dtypes == {"key": "int64", "a": "float64", "i": "int64"}
    assert "a" in p and "zz" not in p
    np.testing.assert_array_equal(p.to_numpy(), left.to_numpy())
    assert p.to_pydict()["i"] == list(left["i"])
    pd.testing.assert_frame_equal(p.to_pandas(), left)


def test_frame_refusals():
    p = pct.DataFrame({"k": np.arange(4), "v": np.arange(4.0)},
                      env=pct.CylonEnv(device="cpu"))
    # a single column is a Series (ported): the reference's values
    assert isinstance(p["k"], pct.Series)
    np.testing.assert_array_equal(
        p["k"].to_numpy(),
        rct.DataFrame({"k": np.arange(4)},
                      env=rct.CylonEnv(config=rct.LocalConfig()))["k"]
        .to_numpy())
    with pytest.raises(pct.CylonKeyError):
        p["nope"]
    with pytest.raises(pct.CylonKeyError):
        p.groupby("k")[["nope"]]
    # a left merge answers (ported): the reference's frame
    r = rct.DataFrame({"k": np.arange(4), "v": np.arange(4.0)},
                      env=rct.CylonEnv(config=rct.LocalConfig()))
    same(r.merge(r, on="k", how="left"), p.merge(p, on="k", how="left"))
    with pytest.raises(pct.InvalidError):
        p.merge(pct.DataFrame({"x": np.arange(4)}, env=p.env))
    assert pct.DataFrame([np.arange(3), np.ones(3)],
                         env=p.env).columns == ["0", "1"]
    assert pct.DataFrame.from_table(p.table).table is p.table


# ---------------------------------------------------------------------------
# set operations, distinct rows, redistribution and row ranges
# ---------------------------------------------------------------------------

def _set_frames(seed=5):
    rng = np.random.default_rng(seed)
    a = pd.DataFrame({"k": rng.integers(0, 30, 200),
                      "g": rng.integers(0, 3, 200)})
    b = pd.DataFrame({"k": rng.integers(10, 40, 150),
                      "g": rng.integers(0, 3, 150)})
    return a, b


def test_set_methods(worlds):
    renv, penv = worlds
    a, b = _set_frames()
    ra, rb = rct.DataFrame(a, env=renv), rct.DataFrame(b, env=renv)
    pa, pb = pct.DataFrame(a, env=penv), pct.DataFrame(b, env=penv)
    for op in ("union", "intersect", "subtract"):
        same(getattr(ra, op)(rb), getattr(pa, op)(pb))
    for keep in ("first", "last"):
        same(ra.drop_duplicates(["k"], keep=keep),
             pa.drop_duplicates(["k"], keep=keep))
    same(ra.drop_duplicates(), pa.drop_duplicates())
    assert pa.isin(pa.union(pb)) is ra.isin(ra.union(rb)) is True
    assert pa.isin(pb) is ra.isin(rb) is False
    assert pa.equals(pa) is ra.equals(ra) is True
    assert pa.equals(pb) is ra.equals(rb) is False
    shuffled = a.sample(frac=1.0, random_state=2).reset_index(drop=True)
    rs, ps = rct.DataFrame(shuffled, env=renv), pct.DataFrame(shuffled,
                                                              env=penv)
    assert pa.equals(ps, ordered=False) is ra.equals(rs, ordered=False) \
        is True


def test_redistribution_methods(worlds):
    renv, penv = worlds
    a, b = _set_frames()
    ra, pa = rct.DataFrame(a, env=renv), pct.DataFrame(a, env=penv)
    for n in (5, 77):
        same(ra.head(n), pa.head(n))
        same(ra.tail(n), pa.tail(n))
    same(ra.head(), pa.head())
    same(ra.shuffle("k"), pa.shuffle("k"))
    rsub = ra.subtract(rct.DataFrame(b, env=renv))
    psub = pa.subtract(pct.DataFrame(b, env=penv))
    same(rsub.repartition(), psub.repartition())
    w = penv.world_size
    counts = [0] * (w - 1) + [len(a)]
    same(ra.repartition(counts), pa.repartition(counts))
    assert pa.repartition(counts).to_pydict() == pa.to_pydict()


def test_set_methods_move_env(env1, env4):
    """``env=`` runs the method on another world (both frames move)."""
    a, b = _set_frames()
    p1 = pct.CylonEnv(device="cpu")
    p4 = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    ra, rb = rct.DataFrame(a, env=env1), rct.DataFrame(b, env=env1)
    pa, pb = pct.DataFrame(a, env=p1), pct.DataFrame(b, env=p1)
    out = pa.union(pb, env=p4)
    assert out.env is p4
    same(ra.union(rb, env=env4), out)
    same(ra.drop_duplicates(["k"], env=env4),
         pa.drop_duplicates(["k"], env=p4))
    same(ra.repartition(env=env4), pa.repartition(env=p4))
