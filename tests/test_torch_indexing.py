"""Parity of the row-label index and ``loc``/``iloc``:
``cylon_tpu_torch.DataFrame`` against ``cylon_tpu.DataFrame`` on the CPU,
after tests/test_indexing.py, at world sizes 1, 3 and 4 (``iloc`` on a
list of positions re-ingests its rows, so the layout is held too).

Cases: ``iloc`` by position, negative position, slice and list (order
and duplicates kept), ``loc`` by label, label list, inclusive label
slice, a string index, a missing label, ``loc[rows, cols]``, the range
index, the multi-index (full and partial tuples, lists of tuples,
lexicographic slices, the (rows, cols) form, missing labels, padding
rows after a concat), and the index surviving a filter and a sort.

Held: the result tables bit- and layout-equal (``valid_counts``,
capacity, column names and dtypes, validity, values; floats are copied,
not computed, so bit-equal too), the same index and visible columns,
equal ``to_pandas()`` frames, and the same typed errors by class
name."""

import jax
import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu.ctx.context import CPUMeshConfig
from cylon_tpu.relational import concat_tables as r_concat
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


@pytest.fixture(params=[1, 3, 4])
def w(request):
    return request.param


def _pair(data, w, env1, env4):
    renv = {1: env1, 4: env4}.get(w) or rct.CylonEnv(
        config=CPUMeshConfig(world_size=w))
    penv = pct.CylonEnv(VirtualMeshConfig(w), device="cpu")
    return rct.DataFrame(data, env=renv), pct.DataFrame(data, env=penv)


@pytest.fixture
def df(w, env1, env4):
    data = pd.DataFrame({"id": [10, 20, 30, 40, 50, 60, 70, 80],
                         "v": np.arange(8) * 1.5,
                         "s": list("abcdefgh")})
    return _pair(data, w, env1, env4)


@pytest.fixture
def mdf(w, env1, env4):
    data = pd.DataFrame({"a": ["x", "x", "x", "y", "y", "z", "z", "z"],
                         "b": [1, 2, 3, 1, 2, 1, 2, 3],
                         "v": np.arange(8) * 2.0,
                         "w": np.arange(8, dtype=np.int64)})
    return _pair(data, w, env1, env4)


def same(r, p):
    assert_same(r.table, p.table)
    assert p._index == r._index and p._index_drop == r._index_drop
    assert p.columns == r.columns
    pd.testing.assert_frame_equal(p.to_pandas(), r.to_pandas())


def both_raise(fr, fp):
    with pytest.raises(Exception) as re:
        fr()
    with pytest.raises(Exception) as pe:
        fp()
    assert type(pe.value).__name__ == type(re.value).__name__


def test_iloc(df):
    r, p = df
    for key in [3, -1, slice(2, 5), slice(None, None), slice(6, 2),
                [1, 4, 6], [6, 1, 1, -2], [], (slice(1, 4), "v"),
                ([0, 7], ["s", "id"])]:
        same(r.iloc[key], p.iloc[key])
    both_raise(lambda: r.iloc[99], lambda: p.iloc[99])
    both_raise(lambda: r.iloc[[1, 99]], lambda: p.iloc[[1, 99]])
    both_raise(lambda: r.iloc[::2], lambda: p.iloc[::2])


def test_loc_labels_and_slices(df):
    r, p = df
    ri, pi = r.set_index("id"), p.set_index("id")
    for key in [[20, 50], 40, slice(30, 60), slice(None, 45),
                slice(35, None), ([20, 40], "v"), (slice(10, 30), ["s"])]:
        same(ri.loc[key], pi.loc[key])
    assert p.set_index("id").loc[[20, 50]].to_pandas().index.tolist() \
        == [20, 50]
    both_raise(lambda: ri.loc[[999]], lambda: pi.loc[[999]])
    both_raise(lambda: ri.loc[[20, 999]], lambda: pi.loc[[20, 999]])
    rs, ps = r.set_index("s"), p.set_index("s")
    for key in [["c", "f"], "h", slice("b", "e"), slice("bb", "ee")]:
        same(rs.loc[key], ps.loc[key])
    both_raise(lambda: rs.loc[["c", "q"]], lambda: ps.loc[["c", "q"]])
    for key in [slice(2, 4), 5, [1, 3]]:
        same(r.loc[key], p.loc[key])
    rk, pk = r.set_index("id", drop=False), p.set_index("id", drop=False)
    same(rk.loc[[20, 30]], pk.loc[[20, 30]])
    same(rk.iloc[0:2], pk.iloc[0:2])


def test_index_survives_filter_sort(df):
    r, p = df
    ri, pi = r.set_index("id"), p.set_index("id")
    same(ri[ri["v"] > 3.0].sort_values("v", ascending=False),
         pi[pi["v"] > 3.0].sort_values("v", ascending=False))
    same(ri.head(3), pi.head(3))
    same(ri.tail(2), pi.tail(2))
    same(ri[2:6], pi[2:6])
    np.testing.assert_array_equal(pi.index, ri.index)
    np.testing.assert_array_equal(p.index, r.index)
    same(ri.reset_index(), pi.reset_index())
    both_raise(lambda: ri["id"], lambda: pi["id"])


def test_multi_index(mdf):
    r, p = mdf
    rm, pm = r.set_index(["a", "b"]), p.set_index(["a", "b"])
    assert pm.columns == ["v", "w"]
    same(rm, pm)
    same(rm.reset_index(), pm.reset_index())
    for key in [("y", 2), "z", [("x", 1), ("z", 3)], [("y", 1)],
                slice(("x", 2), ("z", 1)), slice("y", None),
                slice(None, ("y", 1)), ([("y", 1)], "v")]:
        same(rm.loc[key], pm.loc[key])
    for key in [("q", 9), [("x", 1), ("q", 9)], ("x", 1, 5)]:
        both_raise(lambda: rm.loc[key], lambda: pm.loc[key])
    same(rm[rm["w"] >= 3].sort_values("v", ascending=False),
         pm[pm["w"] >= 3].sort_values("v", ascending=False))
    same(r.set_index(["a", "b"], drop=False),
         p.set_index(["a", "b"], drop=False))
    assert list(pm.index) == list(rm.index)


def test_multi_loc_missing_after_concat_padding(w, env1, env4):
    """Padding rows (stale values after a concat) never fake a label."""
    r1, p1 = _pair(pd.DataFrame({"a": [1, 2, 3], "b": [1, 1, 1],
                                 "v": [1., 2., 3.]}), w, env1, env4)
    r2, p2 = _pair(pd.DataFrame({"a": [4, 5, 6], "b": [2, 2, 2],
                                 "v": [4., 5., 6.]}), w, env1, env4)
    rb = rct.DataFrame(_table=r_concat([r1.table, r2.table]))
    pb = pct.DataFrame(_table=pct.concat_tables([p1.table, p2.table]))
    rm, pm = rb.set_index(["a", "b"]), pb.set_index(["a", "b"])
    both_raise(lambda: rm.loc[[(0, 0)]], lambda: pm.loc[[(0, 0)]])
    same(rm.loc[[(5, 2), (1, 1)]], pm.loc[[(5, 2), (1, 1)]])
