"""Parity of the sort-based groupby: cylon_tpu_torch's
``groupby_aggregate`` on tables that are not an unmaterialized join,
against cylon_tpu's on the CPU, at world sizes 1 (``env1``), 3 (a
``CPUMeshConfig(3)``), 4 (``env4``) and 8 (``env8``); the port runs on
``VirtualMeshConfig(W, device="cpu")``.

The cases mirror tests/test_groupby.py (associative ops, multi-key,
nunique, median and quantile, dictionary-string keys, null values, mixed
associative and non-associative ops, one group, laneable dtypes on the
sort path, an f64 payload riding along, sumsq) and add the combine route
at W = 3, the scatter path (a ``_plan_vspec`` that returns None), the
grouped fast path (mirroring tests/test_grouped_fastpath.py's sort →
groupby cases), NaN and ±0.0 under min/max, a nullable key, an int64 key
past int32, and the typed errors.

Held: the layout (``valid_counts``, ``capacity``, ``grouped_by``, column
names and dtypes), every validity bit, integers and strings bit-equal,
and floats to a stated tolerance.  Both packages reduce a shard's float
payload in the same route (sort path or scatter path), but the order of
equal keys within a run and the prefix-sum association may differ, so a
float64 result is held to ``rtol = 1e-9`` plus ``atol = 64 * eps *
sum(|v| + v*v)`` over the payload column (eps of float64; the error of a
prefix-sum difference grows with the magnitudes summed before it, and 64
is a margin over the few roundings each side takes; a std to the square
root of that, since |sqrt(x) - sqrt(y)| <= sqrt(|x - y|)), and a float32
result to two float32 ulps (the float64 accumulator is rounded once).  A zero's
sign from min/max of a group holding both -0.0 and +0.0 depends on the
order within the group in both packages, so zeros compare by value."""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu.ctx.context import CPUMeshConfig
from cylon_tpu.relational import groupby_aggregate as r_groupby
from cylon_tpu.relational import groupby as rgb
from cylon_tpu.relational import sort_table as r_sort
from cylon_tpu.relational.common import narrow32_flags as r_narrow
import cylon_tpu_torch as pct
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from cylon_tpu_torch.relational import groupby as pgb
from cylon_tpu_torch.relational.common import narrow32_flags as p_narrow

EPS = np.finfo(np.float64).eps
EPS32 = np.finfo(np.float32).eps


@pytest.fixture(scope="module")
def envs(env1, env4, env8):
    return {1: env1, 3: rct.CylonEnv(config=CPUMeshConfig(world_size=3)),
            4: env4, 8: env8}


def penv(w):
    return pct.CylonEnv(VirtualMeshConfig(w), device="cpu")


def tables(df, envs, w):
    """The same pandas frame as a reference and a port table."""
    return (rct.Table.from_pandas(df, envs[w]),
            pct.Table.from_pandas(df, penv(w)))


def _scale(df):
    """sum(|v| + v*v) over every numeric column of the input."""
    num = df.select_dtypes("number").astype(np.float64)
    return float(np.nansum(np.abs(num.to_numpy()))
                 + np.nansum(num.to_numpy() ** 2))


def assert_same(ref, port, scale: float = 0.0):
    """Layout, validity and values (module docstring's tolerance)."""
    assert port.column_names == ref.column_names
    np.testing.assert_array_equal(port.valid_counts, ref.valid_counts)
    assert port.capacity == ref.capacity
    assert port.grouped_by == ref.grouped_by
    r, p = ref.host_columns(), port.host_columns()
    for name in r:
        (rd, rv), (pd_, pv) = r[name], p[name]
        assert rd.dtype == pd_.dtype, (name, rd.dtype, pd_.dtype)
        assert (rv is None) == (pv is None), name
        if rv is not None:
            np.testing.assert_array_equal(pv, rv, err_msg=name)
        ok = np.ones(len(rd), bool) if rv is None else rv
        if rd.dtype.kind == "f":
            if rd.dtype == np.float32:
                tol = dict(rtol=2 * EPS32, atol=0)
            elif name.endswith("_std"):
                # |sqrt(x) - sqrt(y)| <= sqrt(|x - y|)
                tol = dict(rtol=1e-9, atol=np.sqrt(64 * EPS * scale))
            else:
                tol = dict(rtol=1e-9, atol=64 * EPS * scale)
            np.testing.assert_allclose(pd_[ok], rd[ok], err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(pd_[ok], rd[ok], err_msg=name)


def both(df, envs, w, by, aggs, **kw):
    """Run the same groupby in both packages and hold them equal."""
    rt, pt = tables(df, envs, w)
    out = pct.groupby_aggregate(pt, by, aggs, **kw)
    assert_same(r_groupby(rt, by, aggs, **kw), out, _scale(df))
    return out


def frame(seed=42, n=200, nk=15):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, nk, n),
        "k2": rng.choice(["x", "y", "z"], n),
        "v": rng.random(n),
        "w": rng.integers(-50, 50, n),
    })


ASSOC = ["sum", "count", "min", "max", "mean", "var", "std"]


@pytest.mark.parametrize("w", [1, 3, 4, 8])
def test_associative_ops(envs, w):
    """Every associative op on a float and an int column: the raw route
    at W = 1, the combine route above it."""
    both(frame(), envs, w, "k", [(c, op) for op in ASSOC for c in "vw"])


@pytest.mark.parametrize("w", [1, 8])
def test_multi_key(envs, w):
    out = both(frame(), envs, w, ["k", "k2"], [("v", "sum")])
    assert out.grouped_by == ("k", "k2")


@pytest.mark.parametrize("w", [1, 8])
def test_nunique(envs, w):
    both(frame(), envs, w, "k", [("w", "nunique")])


@pytest.mark.parametrize("w", [1, 3, 8])
def test_median_quantile(envs, w):
    out = both(frame(), envs, w, "k", [("v", "median"),
                                       ("v", "quantile", 0.25),
                                       ("w", "quantile", 0.9)])
    assert out.column_names == ["k", "v_median", "v_quantile_0.25",
                                "w_quantile_0.9"]


def test_string_key(envs):
    both(frame(), envs, 8, "k2", [("v", "sum"), ("v", "count")])


def test_null_values(envs):
    df = pd.DataFrame({"k": [1, 1, 2, 2, 3, 3, 3, 1],
                       "s": ["a", None, "b", None, None, "c", "c", "a"]})
    both(df, envs, 4, "k", [("s", "count"), ("s", "nunique"),
                            ("s", "min"), ("s", "max")])


@pytest.mark.parametrize("w", [3, 8])
def test_mixed_assoc_nonassoc(envs, w):
    both(frame(), envs, w, "k", [("v", "sum"), ("w", "nunique")])


def test_single_group(envs):
    rng = np.random.default_rng(1)
    df = pd.DataFrame({"k": np.ones(64, np.int64), "v": rng.random(64)})
    both(df, envs, 8, "k", [("v", "sum")])


def _laneable(n=3000, seed=7):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, 150, n),
        "s": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
        "v": np.where(rng.random(n) < 0.15, np.nan,
                      rng.random(n) * 100).astype(np.float32),
        "w": rng.integers(-1000, 1000, n),
    })


def _vspec_choice(df, envs, w, val, by):
    """(reference, port) sort-path choice for these columns."""
    rt, pt = tables(df, envs, w)
    out = []
    for t, mod, nrw in ((rt, rgb, r_narrow), (pt, pgb, p_narrow)):
        vcols = [t.column(c) for c in val]
        bcols = [t.column(c) for c in by]
        out.append(mod._plan_vspec(vcols, bcols, nrw(bcols)) is not None)
    return tuple(out)


@pytest.mark.parametrize("w", [1, 4])
def test_sortpath_laneable_dtypes(envs, w):
    """f32 with NaN, int and string columns ride the sort path (asserted
    in both packages), through the combine route at W = 4 and the raw
    route at W = 1."""
    df = _laneable()
    assert _vspec_choice(df, envs, w, ["v", "w", "w", "v", "w"],
                         ["k", "s"]) == (True, True)
    both(df, envs, w, ["k", "s"], [("v", "mean"), ("w", "min"),
                                   ("w", "max"), ("v", "std"),
                                   ("w", "sum"), ("v", "sumsq")])


@pytest.mark.parametrize("w", [1, 4])
def test_scatter_path_f64_payload(envs, w):
    """f64 keys and values price the sort path out: both packages take
    the dense-rank scatter path (``_plan_vspec`` returns None)."""
    rng = np.random.default_rng(3)
    n = 3000
    df = pd.DataFrame({"k": rng.integers(0, 150, n).astype(np.float64),
                       "v": rng.random(n),
                       "w": rng.integers(0, 100, n)})
    assert _vspec_choice(df, envs, w, ["v", "w", "v", "w"],
                         ["k"]) == (False, False)
    both(df, envs, w, "k", [("v", "sum"), ("w", "mean"), ("v", "max"),
                            ("w", "min"), ("v", "median")])


def test_sumsq(envs):
    rng = np.random.default_rng(5)
    n = 3000
    df = pd.DataFrame({"k": rng.integers(0, 80, n).astype(np.int64),
                       "v": rng.random(n),
                       "w": rng.integers(-30, 30, n).astype(np.int64)})
    df.loc[df.index % 7 == 0, "v"] = None
    both(df, envs, 4, "k", [("v", "sumsq"), ("w", "sumsq")])


@pytest.mark.parametrize("w", [1, 4])
def test_nullable_and_wide_keys(envs, w):
    """A nullable int key (nulls form one group) beside an int64 key past
    int32 (two sort operands), every op."""
    rng = np.random.default_rng(11)
    n = 1500
    k = pd.array(rng.integers(0, 40, n), dtype="Int64")
    k[rng.random(n) < 0.1] = pd.NA
    df = pd.DataFrame({"k": k,
                       "big": rng.integers(0, 4, n) * (1 << 40),
                       "v": rng.integers(-(1 << 40), 1 << 40, n),
                       "f": rng.normal(size=n)})
    both(df, envs, w, ["k", "big"],
         [("v", op) for op in ASSOC + ["sumsq"]]
         + [("f", "nunique"), ("f", "median"), ("v", "quantile", 0.3)])


def _signed_zeros_nan():
    k = np.repeat(np.arange(6), 4)
    v = np.array([0.0, -0.0, 1.0, 2.0,         # ±0 with others
                  -0.0, 0.0, -0.0, 0.0,        # only zeros
                  np.nan, np.nan, np.nan, np.nan,   # all NaN: empty
                  np.nan, -3.0, np.inf, -0.0,  # NaN skipped, ±inf kept
                  -np.inf, 5.0, np.nan, 0.0,
                  7.0, 7.0, 7.0, 7.0])
    return pd.DataFrame({"k": k, "v": v})


@pytest.mark.parametrize("w", [1, 4])
def test_min_max_nan_signed_zero(envs, w):
    """NaN is skipped (an all-NaN group is null), ±inf and ±0.0 are
    values, on both the sort path (f32) and the scatter path (f64)."""
    df = _signed_zeros_nan()
    aggs = [("v", "min"), ("v", "max"), ("v", "count"), ("v", "sum"),
            ("v", "median"), ("v", "nunique")]
    out = both(df, envs, w, "k", aggs)
    got = out.to_pydict()
    empty = list(got["k"]).index(2)
    assert np.isnan(got["v_min"][empty]) and got["v_count"][empty] == 0
    both(df.astype({"v": np.float32}), envs, w, "k", aggs)


@pytest.mark.parametrize("w", [1, 4])
def test_grouped_fast_path(envs, w):
    """sort_table output carries ``grouped_by``: the groupby takes the
    grouped fast path (no shuffle, no rank sort) in both packages, with a
    nullable float key whose boundary compare is null-aware, and float
    keys holding NaN and -0.0 (tests/test_grouped_fastpath.py)."""
    rng = np.random.default_rng(0)
    n = 300
    df = pd.DataFrame({"k": rng.integers(0, 12, n).astype(float),
                       "v": rng.standard_normal(n)})
    df.loc[df.index % 17 == 0, "k"] = None
    for data in (df, pd.DataFrame({"k": [0.0, -0.0, 1.5, np.nan, np.nan,
                                         1.5],
                                   "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]})):
        rt, pt = tables(data, envs, w)
        rs, ps = r_sort(rt, "k"), pct.sort_table(pt, "k")
        assert ps.grouped_by == rs.grouped_by == ("k",)
        calls = []
        orig = pgb._group_keys
        pgb._group_keys = lambda *a, **k: calls.append(k.get(
            "grouped", a[3] if len(a) > 3 else False)) or orig(*a, **k)
        try:
            out = pct.groupby_aggregate(ps, "k", [("v", "sum"), ("v", "max"),
                                                  ("v", "nunique")])
        finally:
            pgb._group_keys = orig
        assert calls and all(calls)
        assert_same(r_groupby(rs, "k", [("v", "sum"), ("v", "max"),
                                        ("v", "nunique")]), out,
                    _scale(data))


def test_grouped_flag_cleared(envs):
    df = pd.DataFrame({"k": [1, 1, 2, 2], "v": [1.0, 2.0, 3.0, 4.0]})
    _, pt = tables(df, envs, 1)
    s = pct.sort_table(pt, "k")
    assert s.grouped_by == ("k",)
    assert s.project(["k"]).grouped_by is None
    g = pct.groupby_aggregate(s, "v", [("k", "count")])
    assert g.row_count == 4


@pytest.mark.parametrize("w", [1, 4])
def test_first_sight_redispatch(envs, w, monkeypatch):
    """More groups than the first-sight segment space: the first dispatch
    is detected through its group count and redispatched at the true
    bucket; the second call hits the cached bucket."""
    monkeypatch.setattr(pgb, "_FIRST_SEG_CAP", 8)
    monkeypatch.setattr(rgb, "_FIRST_SEG_CAP", 8)
    rng = np.random.default_rng(2)
    df = pd.DataFrame({"k": rng.integers(0, 500, 3000),
                       "v": rng.integers(0, 9, 3000)})
    rt, pt = tables(df, envs, w)
    calls = []
    orig = pgb._per_shard
    monkeypatch.setattr(pgb, "_per_shard",
                        lambda *a: calls.append(1) or orig(*a))
    for _ in range(2):
        out = pct.groupby_aggregate(pt, "k", [("v", "sum"), ("v", "max")])
    assert_same(r_groupby(rt, "k", [("v", "sum"), ("v", "max")]), out)
    # W = 1: raw 8 -> redispatch, then the cached bucket; W = 4: combine
    # and final each time, the combine redispatched once
    assert len(calls) == (3 if w == 1 else 5)


def test_typed_errors(envs):
    df = frame()
    rt, pt = tables(df, envs, 4)
    for lib, t in ((rct, rt), (pct, pt)):
        agg = lib.relational.groupby_aggregate \
            if lib is rct else pct.groupby_aggregate
        with pytest.raises(lib.status.InvalidError):
            agg(t, "k", [("k2", "sum")])
        with pytest.raises(lib.status.InvalidError):
            agg(t, "k", [("v", "nosuchop")])
        with pytest.raises(lib.status.InvalidError):
            agg(t, "k", [("v", "sum"), ("v", "sum")])
        with pytest.raises(lib.status.CylonKeyError):
            agg(t, "nokey", [("v", "sum")])


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("dtype", ["UInt8", "UInt16", "UInt32", "UInt64"])
def test_unsigned_min_max(envs, w, dtype):
    """min/max over unsigned values, 0 and the type's maximum included,
    with one group whose values are all null: that group is null and
    holds the reduction's identity, as in the reference.  The data of
    null slots is compared too."""
    rng = np.random.default_rng(13)
    top = int(np.iinfo(dtype.lower()).max)
    n = 400
    u = rng.integers(0, top, n, dtype=np.uint64, endpoint=True)
    u[:2] = (0, top)
    k = rng.integers(0, 20, n)
    df = pd.DataFrame({"k": k, "u": pd.array(u.astype(dtype.lower()),
                                              dtype=dtype)})
    df.loc[df["k"] == 7, "u"] = pd.NA
    aggs = [("u", "min"), ("u", "max"), ("u", "count")]
    rt, pt = tables(df, envs, w)
    ref, out = r_groupby(rt, "k", aggs), pct.groupby_aggregate(pt, "k", aggs)
    assert_same(ref, out)
    r, p = ref.host_columns(), out.host_columns()
    for name in ("u_min", "u_max"):
        np.testing.assert_array_equal(p[name][0], r[name][0], err_msg=name)
        assert not p[name][1][list(p["k"][0]).index(7)]


@pytest.mark.parametrize("aggs", [[("a", "sum")],
                                  [("a", "min"), ("b", "max")],
                                  [("b", "mean"), ("a", "count"),
                                   ("b", "median")]])
def test_zero_capacity_groupby(envs, aggs):
    """A W = 1 table of no rows has capacity 0: the groupby returns the
    empty result with the schema the W = 4 run of the reference gives."""
    df = pd.DataFrame({"k": np.array([], np.int64),
                       "a": np.array([], np.int64),
                       "b": np.array([], np.float64)})
    ref = r_groupby(rct.Table.from_pandas(df, envs[4]), "k", aggs)
    pt = pct.Table.from_pandas(df, penv(1))
    assert pt.capacity == 0
    out = pct.groupby_aggregate(pt, "k", aggs)
    assert out.column_names == ref.column_names
    assert out.row_count == ref.row_count == 0
    assert out.grouped_by == ref.grouped_by
    r, p = ref.host_columns(), out.host_columns()
    for name in r:
        assert p[name][0].dtype == r[name][0].dtype, name
        assert p[name][0].shape == r[name][0].shape == (0,), name
        assert (p[name][1] is None) == (r[name][1] is None), name
