"""Parity of the decimal (scaled int64) and list (host passthrough)
columns and of object-column ingest: cylon_tpu_torch against cylon_tpu on
the CPU, after tests/test_decimal_list.py, at world sizes 1 and 4 (3 where
the shard layout matters).

Also pins the two ingest repairs: an object column whose 65th or later
value is a decimal or a list raises ``CylonTypeError`` where the
reference's ``as_str`` does (the port used to stringify it), and the
nulls ``pd.isna`` knows (``pd.NA``, ``pd.NaT``, ``np.datetime64('NaT')``,
a decimal NaN) give the reference's codes and validity (the port used to
raise).

Held: layout, validity, the physical values bit-equal (decimals are
integers), types and scales, decoded values, and the same typed errors
(by class name: the packages have their own error classes)."""

from decimal import Decimal

import jax
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import cylon_tpu as rct
from cylon_tpu import config as rconfig
from cylon_tpu.ctx.context import CPUMeshConfig
from cylon_tpu.relational import (concat_tables as r_concat,
                                  groupby_aggregate as r_groupby,
                                  join_tables as r_join,
                                  set_operation as r_setop,
                                  sort_table as r_sort,
                                  unique_table as r_unique)
from cylon_tpu.relational import join as rjoin
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch.core.column import Column as PColumn
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from cylon_tpu.core.column import Column as RColumn
from test_torch_groupby_sort import assert_same


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """The reference compiles many small XLA:CPU programs here; release
    them when the module ends, so that a worker process running later
    files does not keep accumulating them (tests/run_all.py: XLA:CPU's
    compiler crashes more often in long-lived processes)."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def same_routes(monkeypatch):
    monkeypatch.setattr(rconfig, "BROADCAST_JOIN_ROWS", 0)
    monkeypatch.setattr(pconfig, "BROADCAST_JOIN_ROWS", 0)
    rjoin._CAP_CACHE.clear()


def _envs(w, env1, env4):
    renv = {1: env1, 4: env4}.get(w) or rct.CylonEnv(
        config=CPUMeshConfig(world_size=w))
    return renv, pct.CylonEnv(VirtualMeshConfig(w), device="cpu")


@pytest.fixture(params=[1, 4])
def worlds(request, env1, env4):
    return _envs(request.param, env1, env4)


def _dec(vals, scale=2):
    q = Decimal(1).scaleb(-scale)
    return np.asarray([Decimal(str(v)).quantize(q) for v in vals],
                      dtype=object)


def same(r, p):
    """Layout, physical values, types, scales and decoded values."""
    assert_same(r, p)
    for n in r.column_names:
        rc, pc = r.column(n), p.column(n)
        assert pc.type.value == rc.type.value, n
        if rc.type.value == "decimal":
            assert (pc.dictionary.precision, pc.dictionary.scale) == \
                (rc.dictionary.precision, rc.dictionary.scale), n
    rd, pd_ = r.to_pandas(), p.to_pydict()
    for n in r.column_names:
        assert [None if (isinstance(v, float) and v != v) else v
                for v in rd[n]] == \
            [None if (isinstance(v, float) and v != v) else v
             for v in pd_[n]], n


def tables(df, renv, penv):
    return rct.Table.from_pandas(df, renv), pct.Table.from_pandas(df, penv)


# -- the two ingest repairs ---------------------------------------------------

@pytest.mark.parametrize("cells", [
    ["a"] * 70 + [Decimal("1.5")],
    ["a"] * 70 + [[1, 2]] + ["b"],
    ["a"] * 70 + [(1, 2)],
    ["a"] * 70 + [{"x": 1}],
    ["a", Decimal("1.5")],
    [Decimal("1.5"), "a"],
], ids=["late_decimal", "late_list", "late_tuple", "late_dict",
        "early_decimal", "decimal_probe"])
def test_mixed_object_column_raises(cells):
    """The port checks every non-null value, as the reference's as_str."""
    arr = np.asarray(cells + [None], dtype=object)
    with pytest.raises(Exception) as re:
        RColumn.from_numpy(arr)
    with pytest.raises(Exception) as pe:
        PColumn.from_numpy(arr)
    assert type(re.value).__name__ == "CylonTypeError"
    assert type(pe.value).__name__ == "CylonTypeError"


@pytest.mark.parametrize("cells", [
    ["a", pd.NA, "b", None],
    ["x", pd.NaT, None, "y", float("nan")],
    ["x", np.datetime64("NaT"), "y", np.timedelta64("NaT")],
    [pd.NA, "q", np.float32("nan"), "q"],
    ["a"] * 80 + [pd.NA, 7, True, b"bytes"],
], ids=["pd_na", "pd_nat", "np_nat", "leading_na", "stringified"])
def test_pandas_nulls_codes_and_validity(cells):
    """Every null pd.isna knows is a null, with the reference's codes,
    dictionary and validity; other scalars are stringified alike."""
    arr = np.asarray(cells, dtype=object)
    r, p = RColumn.from_numpy(arr), PColumn.from_numpy(arr)
    assert p.type.value == r.type.value == "string"
    np.testing.assert_array_equal(p.data, np.asarray(r.data))
    np.testing.assert_array_equal(p.validity, np.asarray(r.validity))
    assert list(p.dictionary) == list(r.dictionary)


def test_pandas_string_dtype_with_nulls(worlds):
    """A pandas string column with a null ingests in both packages."""
    renv, penv = worlds
    df = pd.DataFrame({"s": pd.array(["b", None, "a", "b", None],
                                     dtype="string"),
                       "v": np.arange(5)})
    same(*tables(df, renv, penv))


def test_decimal_nan_is_null(env1):
    arr = np.asarray([Decimal("1.50"), Decimal("NaN"), None,
                      Decimal("-2.25")], dtype=object)
    r, p = RColumn.from_numpy(arr), PColumn.from_numpy(arr)
    assert p.type.value == r.type.value == "decimal"
    np.testing.assert_array_equal(p.data, np.asarray(r.data))
    np.testing.assert_array_equal(p.validity, np.asarray(r.validity))


# -- decimals -----------------------------------------------------------------

def test_decimal_pandas_roundtrip_exact(worlds):
    renv, penv = worlds
    df = pd.DataFrame({"m": _dec([1.25, -3.10, 0.07, 99999.99]),
                       "k": np.arange(4, dtype=np.int64)})
    r, p = tables(df, renv, penv)
    same(r, p)
    assert list(p.to_pydict()["m"]) == list(df["m"])


def test_decimal_arrow_roundtrip(worlds):
    renv, penv = worlds
    arr = pa.array([Decimal("12.34"), None, Decimal("-0.01")],
                   type=pa.decimal128(10, 2))
    at = pa.table({"m": arr, "k": pa.array([1, 2, 3])})
    r, p = rct.Table.from_arrow(at, renv), pct.Table.from_arrow(at, penv)
    same(r, p)
    out = p.to_arrow()
    assert out.equals(r.to_arrow())
    assert out.column("m").type == pa.decimal128(10, 2)
    assert out.column("m").to_pylist() == arr.to_pylist()


@pytest.mark.parametrize("w", [1, 3, 4])
def test_decimal_join_groupby_sort(w, env1, env4):
    """Decimal keys and payloads of mixed scales through a join (the
    rescale), a groupby sum and a sort: tables bit- and layout-equal."""
    renv, penv = _envs(w, env1, env4)
    rng = np.random.default_rng(7)
    ldf = pd.DataFrame({"m": _dec(rng.integers(0, 40, 300) / 4, 2),
                        "p": _dec(rng.integers(-500, 500, 300) / 10, 1),
                        "a": rng.integers(0, 9, 300)})
    rdf = pd.DataFrame({"m": _dec(rng.integers(0, 40, 200) / 4, 3),
                        "b": rng.integers(0, 9, 200)})
    rl, pl = tables(ldf, renv, penv)
    rr, pr = tables(rdf, renv, penv)
    rj, pj = r_join(rl, rr, "m", "m"), pct.join_tables(pl, pr, "m", "m")
    same(rj, pj)
    assert pj.column("m").dictionary.scale == 3
    same(r_groupby(rj, "m", [("p", "sum"), ("b", "max")]),
         pct.groupby_aggregate(pj, "m", [("p", "sum"), ("b", "max")]))
    same(r_sort(rl, ["m", "p"], ascending=[False, True]),
         pct.sort_table(pl, ["m", "p"], ascending=[False, True]))


def test_decimal_join_mixed_scales_rescale(worlds):
    renv, penv = worlds
    ldf = pd.DataFrame({"m": _dec([2.5, 3.1, 4.0], scale=1), "a": [1, 2, 3]})
    rdf = pd.DataFrame({"m": _dec([2.50, 4.00, 9.99], scale=2),
                        "b": [10, 20, 30]})
    rl, pl = tables(ldf, renv, penv)
    rr, pr = tables(rdf, renv, penv)
    pj = pct.join_tables(pl, pr, "m", "m")
    same(r_join(rl, rr, "m", "m"), pj)
    assert sorted(pj.to_pydict()["b"].tolist()) == [10, 20]


def test_decimal_concat_and_setop(worlds):
    """concat rescales all inputs in one pass; set ops compare the
    rescaled integers."""
    renv, penv = worlds
    parts = [pd.DataFrame({"m": _dec([1.5, 2.25, 3], s)}) for s in (1, 2, 4)]
    rts = [rct.Table.from_pandas(d, renv) for d in parts]
    pts = [pct.Table.from_pandas(d, penv) for d in parts]
    rc, pc = r_concat(rts), pct.concat_tables(pts)
    same(rc, pc)
    assert pc.column("m").dictionary.scale == 4
    same(r_setop(rts[0], rts[1], "union"),
         pct.set_operation(pts[0], pts[1], "union"))
    same(r_unique(rc), pct.unique_table(pc))


def test_decimal_rescale_grows_precision(worlds):
    renv, penv = worlds
    a = pa.table({"m": pa.array([Decimal("99999")], type=pa.decimal128(5, 0)),
                  "x": pa.array([1])})
    b = pa.table({"m": pa.array([Decimal("99999.000")],
                                type=pa.decimal128(8, 3)),
                  "y": pa.array([2])})
    pj = pct.join_tables(pct.Table.from_arrow(a, penv),
                         pct.Table.from_arrow(b, penv), "m", "m")
    same(r_join(rct.Table.from_arrow(a, renv),
                rct.Table.from_arrow(b, renv), "m", "m"), pj)
    assert pj.to_arrow().column("m").to_pylist()[0] == Decimal("99999.000")


def test_decimal256_float_fallback(worlds):
    renv, penv = worlds
    arr = pa.array([Decimal("1.5"), Decimal("2.5"), Decimal("3.5")],
                   type=pa.decimal256(10, 1))
    at = pa.table({"m": arr})
    p = pct.Table.from_arrow(at, penv)
    same(rct.Table.from_arrow(at, renv), p)
    assert p.column("m").type == pct.LogicalType.FLOAT64


def test_leading_pd_na_decimal(worlds):
    renv, penv = worlds
    df = pd.DataFrame({"m": pd.Series([pd.NA, Decimal("1.5"),
                                       Decimal("2.5")], dtype=object)})
    r, p = tables(df, renv, penv)
    same(r, p)
    assert p.column("m").type == pct.LogicalType.DECIMAL


@pytest.mark.parametrize("v", ["1000000000000000000", "92233720368547758.08"])
def test_decimal_too_wide_raises(v):
    """19 digits: the precision bound; past int64: the conversion."""
    arr = np.asarray([Decimal(v)], dtype=object)
    with pytest.raises(Exception) as re:
        RColumn.from_numpy(arr)
    with pytest.raises(Exception) as pe:
        PColumn.from_numpy(arr)
    assert type(pe.value).__name__ == type(re.value).__name__


# -- lists --------------------------------------------------------------------

def _list_frames(n=200, seed=3):
    rng = np.random.default_rng(seed)
    ldf = pd.DataFrame({"k": rng.integers(0, 30, n).astype(np.int64),
                        "payload": [[int(i), int(i) * 2] for i in range(n)]})
    rdf = pd.DataFrame({"k": np.arange(30, dtype=np.int64),
                        "b": rng.random(30)})
    return ldf, rdf


def test_list_roundtrip_join_filter_concat(worlds):
    renv, penv = worlds
    ldf, rdf = _list_frames()
    rl, pl = tables(ldf, renv, penv)
    rr, pr = tables(rdf, renv, penv)
    same(rl, pl)
    assert list(pl.to_pydict()["payload"]) == list(ldf["payload"])
    same(r_join(rl, rr, "k", "k"), pct.join_tables(pl, pr, "k", "k"))
    rd, pd_ = rct.DataFrame(_table=rl), pct.DataFrame(_table=pl)
    rf, pf = rd[rd["k"] >= 15], pd_[pd_["k"] >= 15]
    same(rf.table, pf.table)
    same(r_concat([rf.table, rl]), pct.concat_tables([pf.table, pl]))


def test_list_arrow_ingest(worlds):
    renv, penv = worlds
    at = pa.table({"k": pa.array([1, 2, 3]),
                   "ls": pa.array([[1.0, 2.0], [], [3.0]],
                                  type=pa.list_(pa.float64()))})
    p = pct.Table.from_arrow(at, penv)
    same(rct.Table.from_arrow(at, renv), p)
    assert list(p.to_pydict()["ls"]) == [[1.0, 2.0], [], [3.0]]
    assert p.to_arrow().column("ls").to_pylist() == [[1.0, 2.0], [], [3.0]]


def test_list_keys_raise(worlds):
    renv, penv = worlds
    ldf, _ = _list_frames(40)
    rl, pl = tables(ldf, renv, penv)
    calls = [
        lambda m, t: m["join"](t, t, "payload", "payload"),
        lambda m, t: m["groupby"](t, "payload", [("k", "sum")]),
        lambda m, t: m["groupby"](t, "k", [("payload", "sum")]),
        lambda m, t: m["sort"](t, "payload"),
        lambda m, t: m["unique"](t),
        lambda m, t: m["setop"](t, t, "union"),
        lambda m, t: m["frame"](_table=t)["payload"] == [1, 2],
    ]
    rm = dict(join=r_join, groupby=r_groupby, sort=r_sort, unique=r_unique,
              setop=r_setop, frame=rct.DataFrame)
    pm = dict(join=pct.join_tables, groupby=pct.groupby_aggregate,
              sort=pct.sort_table, unique=pct.unique_table,
              setop=pct.set_operation, frame=pct.DataFrame)
    for call in calls:
        with pytest.raises(Exception) as re:
            call(rm, rl)
        with pytest.raises(Exception) as pe:
            call(pm, pl)
        assert type(pe.value).__name__ == type(re.value).__name__
    # a count of a list column is allowed
    same(r_groupby(rl, "k", [("payload", "count")]),
         pct.groupby_aggregate(pl, "k", [("payload", "count")]))
