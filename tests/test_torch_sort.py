"""Parity of the distributed sample sort: cylon_tpu_torch's ``sort_table``
against cylon_tpu's on the CPU at world sizes 1, 3, 4 and 8 (the port on
``VirtualMeshConfig(W, device="cpu")``), mirroring tests/test_sort.py:
numeric key dtypes, multi-key with mixed ``ascending``, dictionary
strings, nulls first and last, NaN and ±0.0, an empty table, all-equal
keys, skewed keys, both methods ("initial" and "regular"), and the method
validation.

Every comparison is the whole layout, bit for bit: ``valid_counts``,
capacity, each shard's rows in order and its zero padding, validity,
bounds and ``grouped_by``.  Both packages pick the same splitters (the
same sample positions, the same host lexsort), route every row to the
same rank and sort each shard stably, so nothing is left to a
tolerance."""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu.ctx.context import CPUMeshConfig
from cylon_tpu.relational import sort_table as r_sort
import cylon_tpu_torch as pct
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from test_torch_shuffle import assert_layout


@pytest.fixture(scope="module")
def envs(env1, env4, env8):
    return {1: env1, 3: rct.CylonEnv(config=CPUMeshConfig(world_size=3)),
            4: env4, 8: env8}


def both(df, envs, w, by, **kw):
    """The same sort in both packages, held layout-equal; returns the
    port's output."""
    rt = rct.Table.from_pandas(df, envs[w])
    pt = pct.Table.from_pandas(df, pct.CylonEnv(VirtualMeshConfig(w),
                                                device="cpu"))
    ro, po = r_sort(rt, by, **kw), pct.sort_table(pt, by, **kw)
    assert_layout(ro, po)
    assert po.grouped_by == ro.grouped_by == tuple(
        [by] if isinstance(by, str) else by)
    return po


@pytest.mark.parametrize("w", [1, 3, 4, 8])
@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64,
                                   np.float32, np.uint32])
def test_sort_numeric(envs, w, dtype):
    rng = np.random.default_rng(42)
    k = (rng.integers(0, 1000, 300).astype(dtype)
         if np.issubdtype(dtype, np.integer)
         else (rng.random(300) * 100).astype(dtype))
    df = pd.DataFrame({"k": k, "v": np.arange(300)})
    got = both(df, envs, w, "k").to_pandas()
    exp = df.sort_values("k", kind="stable").reset_index(drop=True)
    pd.testing.assert_frame_equal(got, exp, check_dtype=False)


@pytest.mark.parametrize("w", [3, 8])
@pytest.mark.parametrize("ascending", [True, False, [True, False]])
def test_sort_multi_key(envs, w, ascending):
    rng = np.random.default_rng(1)
    df = pd.DataFrame({"a": rng.integers(0, 10, 200), "b": rng.random(200)})
    both(df, envs, w, ["a", "b"], ascending=ascending)


def test_sort_strings(envs):
    rng = np.random.default_rng(2)
    words = ["kiwi", "fig", "apple", "mango", "pear", "plum", "lime"]
    df = pd.DataFrame({"s": rng.choice(words, 150), "v": np.arange(150)})
    both(df, envs, 8, "s")


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("nulls_position", ["first", "last"])
@pytest.mark.parametrize("ascending", [True, False])
def test_sort_nulls(envs, w, nulls_position, ascending):
    df = pd.DataFrame({"s": ["b", None, "a", None, "c", "a"] * 7,
                       "k": pd.array([3, None, 1, 2, None, 1] * 7,
                                     dtype="Int64"),
                       "v": np.arange(42)})
    both(df, envs, w, ["s", "k"], nulls_position=nulls_position,
         ascending=ascending)


@pytest.mark.parametrize("w", [1, 4])
def test_sort_nans(envs, w):
    df = pd.DataFrame({"f": [3.5, np.nan, -1.0, np.nan, 0.0, 99.9, -0.0,
                             np.inf, -np.inf, -0.0] * 5,
                       "v": np.arange(50)})
    got = both(df, envs, w, "f").to_pandas()
    exp = df.sort_values("f", kind="stable").reset_index(drop=True)
    pd.testing.assert_frame_equal(got, exp, check_dtype=False)
    both(df, envs, w, "f", ascending=False, nulls_position="first")


def test_sort_empty(envs):
    df = pd.DataFrame({"k": np.array([], np.int64)})
    assert both(df, envs, 4, "k").row_count == 0


def test_sort_all_equal_keys(envs):
    df = pd.DataFrame({"k": np.full(100, 7), "v": np.arange(100)})
    got = both(df, envs, 8, "k").to_pandas()
    assert got["k"].tolist() == [7] * 100


def test_sort_skewed(envs):
    rng = np.random.default_rng(3)
    vals = np.where(rng.random(400) < 0.7, 5, rng.integers(0, 1000, 400))
    got = both(pd.DataFrame({"k": vals, "v": np.arange(400)}), envs, 8,
               "k").to_pandas()
    assert got["k"].is_monotonic_increasing


@pytest.mark.parametrize("w", [3, 8])
@pytest.mark.parametrize("method", ["initial", "regular"])
def test_sort_methods(envs, w, method):
    """Both sample-sort strategies on a zipf-skewed key (regular's
    quantile-exact splitters keep the shards balanced)."""
    rng = np.random.default_rng(4)
    n = 6000
    keys = np.minimum(rng.zipf(1.4, n), 500).astype(np.int64)
    df = pd.DataFrame({"k": keys, "v": rng.random(n)})
    out = both(df, envs, w, "k", method=method)
    assert out.to_pandas()["k"].is_monotonic_increasing


def test_sort_method_validation(envs):
    t = pct.Table.from_pydict({"k": np.array([3, 1, 2])},
                              pct.CylonEnv(VirtualMeshConfig(4),
                                           device="cpu"))
    with pytest.raises(pct.InvalidError):
        pct.sort_table(t, "k", method="bogus")
    with pytest.raises(pct.InvalidError):
        pct.sort_table(t, [])



@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.uint64])
@pytest.mark.parametrize("local", [False, True])
def test_sort_unsigned_descending(envs, w, dtype, local):
    """A descending sort on an unsigned key, 0 and the type's maximum
    included, through ``sort_table`` and ``local_sort_table``: the same
    layout as the reference, row for row."""
    from cylon_tpu.relational.sort import local_sort_table as r_local
    rng = np.random.default_rng(6)
    top = int(np.iinfo(dtype).max)
    k = rng.integers(0, top, 300, dtype=np.uint64, endpoint=True)
    k[:4] = (0, top, 0, top)
    df = pd.DataFrame({"k": k.astype(dtype), "v": np.arange(300)})
    if not local:
        got = both(df, envs, w, "k", ascending=False).to_pandas()
        exp = df.sort_values("k", ascending=False, kind="stable")
        np.testing.assert_array_equal(got["k"], exp["k"])
        return
    rt = rct.Table.from_pandas(df, envs[w])
    pt = pct.Table.from_pandas(df, pct.CylonEnv(VirtualMeshConfig(w),
                                                device="cpu"))
    assert_layout(r_local(rt, "k", ascending=False),
                  pct.local_sort_table(pt, "k", ascending=False))
