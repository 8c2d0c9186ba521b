"""Parity of the Series: ``cylon_tpu_torch.Series`` against
``cylon_tpu.Series`` on the CPU at world sizes 1, 3 and 4, on the same
numpy inputs (seeded), columns of every width with nulls, NaN, zeros and
negatives.

Cases: arithmetic (``+ - * / // % **``, reflected forms, ``-``, ``abs``)
between two series and with Python and numpy scalars, the result dtypes of
JAX's promotion, zero divisors (XLA's answers), comparisons (numeric,
strings against scalars and series, hashed strings, decimals with their
literal and rescale rules), the logical operators, validity propagation,
``isna``/``notna``/``fillna``/``where``/``astype``, the reductions
(``sum``, ``count``, ``min``, ``max``, ``mean``, ``nunique``,
``unique``) and the typed refusals (strings, decimals, lists).

Held: the result's type, validity and live values (integers and bools
bit-equal; floats to tests/test_torch_groupby_sort.py's tolerance with a
zero scale: ``rtol = 1e-9`` for float64, two float32 ulps for float32),
reductions equal (float sums to ``rtol = 1e-9``), and the same typed
errors by class name."""

from decimal import Decimal

import jax
import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu import config as rconfig
from cylon_tpu.ctx.context import CPUMeshConfig
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
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


def _frames(w, env1, env4):
    renv = {1: env1, 4: env4}.get(w) or rct.CylonEnv(
        config=CPUMeshConfig(world_size=w))
    penv = pct.CylonEnv(VirtualMeshConfig(w), device="cpu")
    df = _data()
    return rct.DataFrame(df, env=renv), pct.DataFrame(df, env=penv)


@pytest.fixture
def frames(env1, env4):
    """Elementwise ops run on the whole ``(W·cap,)`` tensor whatever the
    layout, which only decides the padding rows: W = 4."""
    return _frames(4, env1, env4)


@pytest.fixture(params=[1, 3])
def frames3(request, env1, env4):
    """Reductions combine per-shard partials: one shard, and three uneven
    ones."""
    return _frames(request.param, env1, env4)


def _data(n=37, seed=11):
    rng = np.random.default_rng(seed)
    f64 = rng.standard_normal(n) * 10
    f64[rng.random(n) < 0.15] = np.nan
    f64[3] = 0.0
    return pd.DataFrame({
        "i64": rng.integers(-20, 20, n).astype(np.int64),
        "i32": rng.integers(-9, 9, n).astype(np.int32),
        "i8": rng.integers(-5, 5, n).astype(np.int8),
        "u8": rng.integers(0, 6, n).astype(np.uint8),
        "u32": rng.integers(0, 2 ** 32 - 1, n, dtype=np.uint64)
        .astype(np.uint32),
        "f64": f64,
        "f32": (rng.standard_normal(n) * 3).astype(np.float32),
        "b": rng.random(n) < 0.5,
        "ni": pd.array(np.where(rng.random(n) < 0.2, None,
                                rng.integers(-7, 7, n)), dtype="Int64"),
        "s": rng.choice(["pear", "fig", "kiwi", "apple"], n),
        "t": pd.array(np.where(rng.random(n) < 0.2, None,
                               rng.choice(["fig", "lime", "pear"], n)),
                      dtype=object),
    })


def same(rs, ps):
    """A reference and a port Series hold the same column."""
    assert ps.dtype.value == rs.dtype.value, (ps.dtype, rs.dtype)
    rt = rct.Table({"x": rs.column}, rs.env, rs.valid_counts)
    pt = pct.Table({"x": ps.column}, ps.env, ps.valid_counts)
    assert_same(rt, pt)
    if rs.dtype.value == "string":
        assert list(ps.to_numpy()) == list(rs.to_numpy())


def both_raise(fr, fp):
    with pytest.raises(Exception) as re:
        fr()
    with pytest.raises(Exception) as pe:
        fp()
    assert type(pe.value).__name__ == type(re.value).__name__, \
        (pe.value, re.value)


NUM = ["i64", "i32", "i8", "u8", "u32", "f64", "f32", "b", "ni"]
BINOPS = ["__add__", "__sub__", "__mul__", "__truediv__", "__floordiv__",
          "__mod__", "__rsub__", "__rtruediv__"]


@pytest.mark.parametrize("a", ["i64", "i32", "u32", "f32", "b", "ni"])
def test_arith_with_scalars(frames, a):
    """Python scalars are weakly typed, numpy scalars strongly."""
    r, p = frames
    for op in BINOPS:
        for k in (3, 2.5, np.float32(1.5), 0) + ((True,) if a == "b" else ()):
            if a == "b" and (
                    (isinstance(k, bool) and op in ("__sub__", "__rsub__",
                                                    "__floordiv__",
                                                    "__mod__"))
                    or (op == "__truediv__" and type(k) is int and k == 0)):
                # bool - bool: both refuse; bool // bool and % bool: torch
                # has no bool kernel; a bool / 0: XLA folds 0 / 0 to 0
                continue
            same(getattr(r[a], op)(k), getattr(p[a], op)(k))
    same(-r[a] if a != "b" else r[a] * 1, -p[a] if a != "b" else p[a] * 1)
    same(abs(r[a]), abs(p[a]))
    if a != "b":   # JAX's bool ** int is int32, outside torch's rules
        same(r[a] ** 2, p[a] ** 2)


@pytest.mark.parametrize("a,b", [("i64", "i32"), ("i64", "f32"),
                                 ("u8", "i8"), ("f64", "f32"),
                                 ("b", "i32"), ("u32", "u32"),
                                 ("ni", "i64"), ("u32", "i64")])
def test_arith_series_pairs(frames, a, b):
    """Two series: JAX's promotion, validity as AND, zero divisors."""
    r, p = frames
    for op in BINOPS[:6]:
        same(getattr(r[a], op)(r[b]), getattr(p[a], op)(p[b]))
    same(r[a] ** r["u8"], p[a] ** p["u8"])
    same(np.int64(3) * r[a], np.int64(3) * p[a])
    same(r[a] + r[b] * 2 - 1, p[a] + p[b] * 2 - 1)


@pytest.mark.parametrize("a", [c for c in NUM if c != "i8"] + ["s"])
def test_comparisons(frames, a):
    r, p = frames
    ops = ["__eq__", "__ne__", "__lt__", "__le__", "__gt__", "__ge__"]
    others = ["fig", "grape", "zz"] if a == "s" else [2, -1.5]
    for op in ops:
        for k in others:
            same(getattr(r[a], op)(k), getattr(p[a], op)(k))
        same(getattr(r[a], op)(r["t" if a == "s" else "i32"]),
             getattr(p[a], op)(p["t" if a == "s" else "i32"]))


def test_logic_and_nulls(frames):
    r, p = frames
    rm = (r["i64"] > 0) & (r["ni"] < 3)
    pm = (p["i64"] > 0) & (p["ni"] < 3)
    same(rm, pm)
    same(rm | (r["f64"] > 1), pm | (p["f64"] > 1))
    same(rm ^ r["b"], pm ^ p["b"])
    same(~rm, ~pm)
    same(rm & True, pm & True)
    for c in ["f64", "ni", "t", "i32"]:
        same(r[c].isna(), p[c].isna())
        same(r[c].notna(), p[c].notna())
    same(r["f64"].fillna(-1.0), p["f64"].fillna(-1.0))
    same(r["ni"].fillna(5), p["ni"].fillna(5))
    same(r["t"].fillna("fig"), p["t"].fillna("fig"))
    same(r["t"].fillna("zebra"), p["t"].fillna("zebra"))
    same(r["f64"].where(rm), p["f64"].where(pm))
    # a string where keeps its type and dictionary in the port; the
    # reference returns the INT32 codes (ROADMAP.md Queue 3)
    pw, rw = p["t"].where(pm), r["t"].where(rm)
    assert pw.dtype == pct.LogicalType.STRING and rw.dtype.value == "int32"
    np.testing.assert_array_equal(pw.column.validity,
                                  np.asarray(rw.column.validity))
    assert list(pw.to_numpy()) == [
        None if c is None else r["t"].column.dictionary[c]
        for c in rw.to_numpy()]
    same(r["i32"].where(rm, 99), p["i32"].where(pm, 99))
    same(r["u32"].where(rm, 7), p["u32"].where(pm, 7))
    for dt in ["float64", "int32", "float32", "int64"]:
        same(r["i64"].astype(dt), p["i64"].astype(dt))
        same(r["f32"].astype(dt), p["f32"].astype(dt))
    both_raise(lambda: r["i32"] & r["b"], lambda: p["i32"] & p["b"])
    both_raise(lambda: ~r["i32"], lambda: ~p["i32"])
    both_raise(lambda: r["f64"].where(r["i32"]),
               lambda: p["f64"].where(p["i32"]))
    both_raise(lambda: r["s"].fillna(1), lambda: p["s"].fillna(1))


@pytest.mark.parametrize("c", ["i64", "i32", "u8", "u32", "f64", "f32", "b",
                               "ni", "s", "t"])
def test_reductions(frames3, c):
    """Float sums in any order differ by at most ``n * eps * sum(|v|)``
    (eps of the column's float type): the stated tolerance here."""
    r, p = frames3
    kinds = ["count", "min", "max"] if c in ("s", "t") \
        else ["sum", "count", "min", "max", "mean"]
    if c in ("i64", "f64", "ni", "t"):
        kinds.append("nunique")
    col = _data()[c]
    for kind in kinds:
        rv, pv = getattr(r[c], kind)(), getattr(p[c], kind)()
        assert type(pv) is type(rv), (kind, rv, pv)
        if isinstance(rv, float) and kind in ("sum", "mean"):
            eps = np.finfo(col.dtype if col.dtype.kind == "f"
                           else np.float64).eps
            mag = float(np.nansum(np.abs(col.to_numpy(np.float64,
                                                      na_value=np.nan))))
            atol = len(col) * eps * mag / (len(col) if kind == "mean"
                                           else 1)
            np.testing.assert_allclose(pv, rv, rtol=0, atol=atol)
        else:
            assert pv == rv or (rv != rv and pv != pv), (kind, rv, pv)
    if c not in ("i64", "f64", "ni", "t"):
        return
    ru, pu = r[c].unique(), p[c].unique()
    assert len(pu) == len(ru)
    assert [None if (isinstance(v, float) and v != v) else v for v in pu] \
        == [None if (isinstance(v, float) and v != v) else v for v in ru]
    if c in ("s", "t"):
        both_raise(lambda: r[c].sum(), lambda: p[c].sum())


def test_reductions_after_filter(frames3):
    """Empty and all-null results: NaN (numeric) and None (strings)."""
    r, p = frames3
    rf, pf = r[r["i64"] > 100], p[p["i64"] > 100]
    for c in ["i64", "f64", "s"]:
        for kind in ["count", "min", "max"]:
            rv, pv = getattr(rf[c], kind)(), getattr(pf[c], kind)()
            assert (pv == rv) or (rv != rv and pv != pv) \
                or (rv is None and pv is None), (c, kind, rv, pv)
    assert pf["i64"].sum() == rf["i64"].sum() == 0
    g = pf["f64"].mean()
    assert g != g and rf["f64"].mean() != rf["f64"].mean()


def test_string_rules(frames):
    r, p = frames
    both_raise(lambda: r["s"] + 1, lambda: p["s"] + 1)
    same(r["s"] == 1, p["s"] == 1)   # compares the codes, as the reference
    both_raise(lambda: r["i64"] == "a", lambda: p["i64"] == "a")
    both_raise(lambda: r["i64"] + r["s"], lambda: p["i64"] + p["s"])
    both_raise(lambda: r["i64"] + "a", lambda: p["i64"] + "a")


def test_hashed_string_compare(monkeypatch, env4):
    monkeypatch.setattr(rconfig, "STRING_HASH_MIN_ROWS", 100)
    monkeypatch.setattr(pconfig, "STRING_HASH_MIN_ROWS", 100)
    names = np.asarray([f"Customer#{i:09d}" for i in range(300)],
                       dtype=object)
    df = pd.DataFrame({"n": names, "v": np.arange(300)})
    r = rct.DataFrame(df, env=env4)
    p = pct.DataFrame(df, env=pct.CylonEnv(VirtualMeshConfig(4),
                                           device="cpu"))
    same(r["n"] == "Customer#000000007", p["n"] == "Customer#000000007")
    same(r["n"] != "nobody", p["n"] != "nobody")
    both_raise(lambda: r["n"] < "C", lambda: p["n"] < "C")
    both_raise(lambda: r["n"].min(), lambda: p["n"].min())
    assert p["n"].nunique() == r["n"].nunique() == 300


def test_decimal_and_list_rules(env4):
    penv = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    q2, q3 = Decimal("0.01"), Decimal("0.001")
    df = pd.DataFrame({
        "m": np.asarray([Decimal(str(v)).quantize(q2)
                         for v in [0.05, 0.06, 0.07, 0.08, -1.5]], object),
        "n": np.asarray([Decimal(str(v)).quantize(q3)
                         for v in [0.05, 0.061, 0.07, 0.0, -1.5]], object),
        "ls": [[1], [2, 3], [], [4], [5]],
        "v": [1, 2, 3, 4, 5]})
    r, p = rct.DataFrame(df, env=env4), pct.DataFrame(df, env=penv)
    for lit in (Decimal("0.06"), Decimal("0.070"), 0, -2):
        for op in ("__ge__", "__eq__", "__lt__"):
            same(getattr(r["m"], op)(lit), getattr(p["m"], op)(lit))
    same(r["m"] == r["n"], p["m"] == p["n"])
    same(r["m"] < r["n"], p["m"] < p["n"])
    assert p[p["m"] >= Decimal("0.06")].to_pydict()["v"] == [2, 3, 4]
    both_raise(lambda: r["m"] >= Decimal("0.065"),
               lambda: p["m"] >= Decimal("0.065"))
    both_raise(lambda: r["m"] >= 0.06, lambda: p["m"] >= 0.06)
    both_raise(lambda: r["m"] + 1, lambda: p["m"] + 1)
    both_raise(lambda: r["ls"] == [1], lambda: p["ls"] == [1])
    both_raise(lambda: r["ls"] * 2, lambda: p["ls"] * 2)
    both_raise(lambda: r["v"] < r["ls"], lambda: p["v"] < p["ls"])
    for kind in ("sum", "min", "max", "count"):
        assert getattr(p["m"], kind)() == getattr(r["m"], kind)()
    same(r["m"].isna(), p["m"].isna())


def test_layout_mismatch_raises(env4):
    penv = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    a = pct.DataFrame({"x": np.arange(10)}, env=penv)
    b = pct.DataFrame({"x": np.arange(30)}, env=penv)
    with pytest.raises(pct.InvalidError):
        a["x"] + b["x"]
    with pytest.raises(pct.InvalidError):
        a["y"] = b["x"]
