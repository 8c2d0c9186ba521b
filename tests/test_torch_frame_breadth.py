"""Parity of the DataFrame's breadth: ``cylon_tpu_torch.DataFrame``
against ``cylon_tpu.DataFrame`` on the CPU, after
tests/test_frame_breadth.py, at world sizes 1 and 4 (3 for the column
ingest of ``__setitem__``, whose layout follows the frame's).

Cases: ``set_index`` with ``drop`` and its propagation through sort,
filter, head and merge; ``isna``/``notna``/``dropna``/``fillna`` (a
string column left as it is under a numeric fill); frame arithmetic
against scalars and frames, negation and ``abs``; ``where`` with and
without ``other``; ``__setitem__`` from a Series, a scalar and a host
array; ``applymap``, ``iterrows``, ``itertuples``, ``row`` with
``Scalar``; ``add_prefix``/``add_suffix``, the ``isnull``/``notnull``
aliases, ``to_pydict``, ``to_dict``, ``to_numpy``, ``to_string``,
``show`` and the frame reductions.

Held: result tables bit- and layout-equal (floats computed the same way
in both packages: an elementwise op is one IEEE operation), the index and
visible columns, ``to_pandas()`` frames equal; where the port answers
without pandas (``iterrows`` yields ``{column: value}`` dicts, the
reductions return dicts, ``to_dict`` — which raises ``AttributeError``
in the reference — and ``to_string``) the values are held against the
reference's or pandas' own."""

import jax
import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu.ctx.context import CPUMeshConfig
import cylon_tpu_torch as pct
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from test_torch_groupby_sort import assert_same


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """The reference compiles many small XLA:CPU programs here; release
    them when the module ends, so that a worker process running later
    files does not keep accumulating them (tests/run_all.py: XLA:CPU's
    compiler crashes more often in long-lived processes)."""
    yield
    jax.clear_caches()


def _pair(data, w, env1, env4):
    renv = {1: env1, 4: env4}.get(w) or rct.CylonEnv(
        config=CPUMeshConfig(world_size=w))
    penv = pct.CylonEnv(VirtualMeshConfig(w), device="cpu")
    return rct.DataFrame(data, env=renv), pct.DataFrame(data, env=penv)


@pytest.fixture(params=[1, 4])
def w(request):
    return request.param


def _data(seed=42):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"id": np.arange(20),
                       "v": rng.standard_normal(20),
                       "w": rng.integers(0, 5, 20).astype(float)})
    df.loc[df.index % 4 == 0, "v"] = np.nan
    return df


@pytest.fixture
def frames(w, env1, env4):
    return _pair(_data(), w, env1, env4)


def same(r, p):
    assert_same(r.table, p.table)
    assert p._index == r._index and p._index_drop == r._index_drop
    assert p.columns == r.columns and p.shape == r.shape
    assert p.dtypes == r.dtypes
    pd.testing.assert_frame_equal(p.to_pandas(), r.to_pandas())


def test_set_index_drop_semantics(frames):
    r, p = frames
    same(r.set_index("id"), p.set_index("id"))
    same(r.set_index("id", drop=False), p.set_index("id", drop=False))
    assert "id" not in p.set_index("id") and "id" in p
    with pytest.raises(pct.CylonKeyError):
        p.set_index("id")["id"]
    with pytest.raises(pct.CylonKeyError):
        p.set_index("nope")
    same(r.set_index("id").reset_index(), p.set_index("id").reset_index())


def test_index_survives_sort_filter_head_merge(frames, w, env1, env4):
    r, p = frames
    ri, pi = r.set_index("id"), p.set_index("id")
    same(ri.sort_values("v"), pi.sort_values("v"))
    same(ri[ri["w"] > 1.0], pi[pi["w"] > 1.0])
    same(ri.head(7), pi.head(7))
    same(ri.drop_duplicates(["w"]), pi.drop_duplicates(["w"]))
    ro, po = _pair(pd.DataFrame({"w": [0.0, 1.0, 2.0], "z": [9, 8, 7]}),
                   w, env1, env4)
    same(ri.merge(ro, on="w"), pi.merge(po, on="w"))


def test_missing_data(frames):
    r, p = frames
    for rd, pd_ in [(r, p), (r.set_index("id"), p.set_index("id"))]:
        same(rd.isna(), pd_.isna())
        same(rd.notna(), pd_.notna())
        same(rd.isnull(), pd_.isnull())
        same(rd.notnull(), pd_.notnull())
        same(rd.dropna(), pd_.dropna())
        same(rd.dropna(subset=["v"], how="all"),
             pd_.dropna(subset=["v"], how="all"))
        same(rd.dropna(how="all"), pd_.dropna(how="all"))
        same(rd.fillna(0.5), pd_.fillna(0.5))
    with pytest.raises(pct.InvalidError):
        p.dropna(how="some")


def test_fillna_skips_string_columns(w, env1, env4):
    r, p = _pair(pd.DataFrame({"s": ["a", None, "b"],
                               "v": [1.0, np.nan, 3.0],
                               "n": pd.array([1, None, 3], dtype="Int64")}),
                 w, env1, env4)
    same(r.fillna(0.0), p.fillna(0.0))
    # a string fill of a numeric column: both packages' numpy cast raises
    with pytest.raises(ValueError):
        r.fillna("z")
    with pytest.raises(ValueError):
        p.fillna("z")


def test_frame_arithmetic(frames):
    r, p = frames
    r, p = r.fillna(1.0), p.fillna(1.0)
    for f in [(lambda d: d * 2), (lambda d: d + 1), (lambda d: -d),
              (lambda d: d - d), (lambda d: d.abs()), (lambda d: abs(d)),
              (lambda d: d / 4)]:
        same(f(r), f(p))
    ri, pi = r.set_index("id"), p.set_index("id")
    same(ri * 2, pi * 2)
    same(ri + ri, pi + pi)
    with pytest.raises(pct.InvalidError):
        p + p[["v"]]


def test_where_and_setitem(w, env1, env4):
    df = pd.DataFrame({"a": [1, 2, 3, 4], "b": [1.0, None, 3.0, 4.0],
                       "s": ["x", "y", "x", "z"]})
    r, p = _pair(df, w, env1, env4)
    same(r.where(r["a"] > 2), p.where(p["a"] > 2))
    same(r[["a", "b"]].where(r["a"] > 2, 0), p[["a", "b"]].where(p["a"] > 2, 0))
    same(r.where(r.notna()), p.where(p.notna()))
    r["c"], p["c"] = r["a"] * 10 + r["b"], p["a"] * 10 + p["b"]
    r["d"], p["d"] = 7, 7
    r["e"], p["e"] = np.arange(4) * 0.5, np.arange(4) * 0.5
    r["a"], p["a"] = r["a"] - 1, p["a"] - 1
    same(r, p)
    with pytest.raises(pct.InvalidError):
        p["f"] = np.arange(3)
    with pytest.raises(pct.CylonKeyError):
        p[1] = 2


def test_setitem_ingest_follows_layout(env1, env4):
    """A host column lands in the frame's own (filtered, uneven) layout."""
    r, p = _pair(_data(), 3, env1, env4)
    rf, pf = r[r["w"] > 1.0], p[p["w"] > 1.0]
    n = len(pf)
    rf["x"], pf["x"] = np.arange(n) * 3, np.arange(n) * 3
    same(rf, pf)
    rf["y"], pf["y"] = rf["x"] + rf["id"], pf["x"] + pf["id"]
    same(rf, pf)


def test_applymap_iterrows_row_scalar(frames):
    r, p = frames
    r0, p0 = r.fillna(0.0), p.fillna(0.0)
    pd.testing.assert_frame_equal(p0.applymap(lambda x: x * 2).to_pandas(),
                                  r0.applymap(lambda x: x * 2).to_pandas())
    ri, pi = r0.set_index("id"), p0.set_index("id")
    pd.testing.assert_frame_equal(pi.applymap(lambda x: x * 2).to_pandas(),
                                  ri.applymap(lambda x: x * 2).to_pandas())
    rrows, prows = list(ri.iterrows()), list(pi.iterrows())
    assert len(prows) == len(rrows)
    for (rl, rs), (pl, ps) in zip(rrows, prows):
        assert pl == rl and ps == rs.to_dict()
    assert [tuple(t) for t in pi.itertuples()] \
        == [tuple(t) for t in ri.itertuples()]
    assert [tuple(t) for t in p0.itertuples(index=False)] \
        == [tuple(t) for t in r0.itertuples(index=False)]
    for i in (3, -1):
        rr, pr = r.row(i), p.row(i)
        assert pr.to_dict() == rr.to_dict()
        assert list(pr) == list(rr)
        for c in p.columns:
            ps, rs = pr.scalar(c), rr.scalar(c)
            assert ps.type.value == rs.type.value
            assert ps.is_null == rs.is_null
            assert (ps == rs.value) == (rs == rs.value)
    assert "id" not in p.set_index("id").row(0).to_dict()
    with pytest.raises(pct.InvalidError):
        p.row(20)
    with pytest.raises(pct.CylonKeyError):
        p.row(0)["nope"]


def test_prefix_suffix_pydict_string_reductions(w, env1, env4, capsys):
    df = pd.DataFrame({"a": [1, 2, 3, 4], "b": [1.0, None, 3.0, 4.0],
                       "s": ["p", "q", "p", None]})
    r, p = _pair(df, w, env1, env4)
    same(r.add_prefix("x_"), p.add_prefix("x_"))
    same(r.add_suffix("_y"), p.add_suffix("_y"))
    same(r.set_index("a").add_prefix("x_"), p.set_index("a").add_prefix("x_"))
    assert p.to_pydict().keys() == r.to_pydict().keys()
    for k, v in r.to_pydict().items():
        assert [None if x != x else x for x in p.to_pydict()[k]] \
            == [None if x != x else x for x in v]
    exp = {k: [None if (isinstance(x, float) and x != x) else x
               for x in v] for k, v in df.astype(object).where(
                   df.notna(), None).to_dict("list").items()}
    got = {k: [None if (isinstance(x, float) and x != x) else x for x in v]
           for k, v in p.to_dict().items()}
    assert got == exp
    assert all(type(x) in (int, float, str, type(None))
               for v in p.to_dict().values() for x in v)
    np.testing.assert_array_equal(p[["a", "b"]].to_numpy(),
                                  r[["a", "b"]].to_numpy())
    for op in ("sum", "min", "max", "count", "mean"):
        rv, pv = getattr(r, op)(), getattr(p, op)()
        assert list(pv) == list(rv.index)
        for k in pv:
            assert pv[k] == rv[k] or (pv[k] != pv[k] and rv[k] != rv[k])
    text = p.set_index("s").to_string()
    assert text.splitlines()[0].split() == ["s", "a", "b"]
    assert len(text.splitlines()) == 5
    p.show(2)
    assert len(capsys.readouterr().out.splitlines()) == 3


def test_multi_index_rows_without_pandas_objects(w, env1, env4):
    """A multi-index frame iterates and prints from its own labels."""
    df = pd.DataFrame({"a": ["x", "y", "x"], "b": [1, 2, 3],
                       "v": [0.5, 1.5, 2.5]})
    r, p = _pair(df, w, env1, env4)
    rm, pm = r.set_index(["a", "b"]), p.set_index(["a", "b"])
    prows = list(pm.iterrows())
    assert [lb for lb, _ in prows] == [lb for lb, _ in rm.iterrows()]
    assert [row for _, row in prows] == [s.to_dict()
                                         for _, s in rm.iterrows()]
    assert [tuple(t) for t in pm.itertuples()] \
        == [tuple(t) for t in rm.itertuples()]
    assert pm.to_string().splitlines()[1].split() == ["('x',", "1)", "0.5"]
