"""Parity of high-cardinality (hashed) string keys: cylon_tpu_torch's
``native`` string hash, ``core.column.HashedStrings`` and the crossover,
and the joins, groupbys, set ops, unique and sorts on hashed keys,
against cylon_tpu's on the CPU at world sizes 1 and 4 (the port on
``VirtualMeshConfig(W, device="cpu")``).  ``hashed_mode`` lowers both
packages' crossover (``STRING_HASH_MIN_ROWS``, ``STRING_HASH_RATIO``) so a
few thousand rows take the hashed path.

Held bit-equal: the native hash, prefix lanes, longest adjacent common
prefix and UTF-8 lengths on 10,000 strings with non-ASCII characters,
empty strings and trailing NULs; the codes and shard layout of a column
above the crossover (``test_crossover_codes_and_layout``: before the
port had hashed strings its codes were sorted-dictionary indices); every
operator's output layout and ``grouped_by``; the typed refusal of a
groupby min/max on a hashed column.  Sorted output is also checked
against pandas' order."""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu import config as rconfig
from cylon_tpu import native as rnative
from cylon_tpu.core.column import HashedStrings as RHashed
from cylon_tpu.relational import groupby_aggregate as r_groupby
from cylon_tpu.relational import join as rjoin
from cylon_tpu.relational import join_tables as r_join
from cylon_tpu.relational import set_operation as r_setop
from cylon_tpu.relational import sort_table as r_sort
from cylon_tpu.relational import unique_table as r_unique
from cylon_tpu.status import InvalidError as RInvalidError
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch import native as pnative
from cylon_tpu_torch.core.column import Column, HashedStrings
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from cylon_tpu_torch.status import KernelError
from test_torch_shuffle import assert_layout


@pytest.fixture(autouse=True)
def same_routes(monkeypatch):
    monkeypatch.setattr(rconfig, "BROADCAST_JOIN_ROWS", 0)
    monkeypatch.setattr(pconfig, "BROADCAST_JOIN_ROWS", 0)
    rjoin._CAP_CACHE.clear()


@pytest.fixture
def hashed_mode(monkeypatch):
    """The hashed crossover for small tables, in both packages."""
    for cfg in (rconfig, pconfig):
        monkeypatch.setattr(cfg, "STRING_HASH_MIN_ROWS", 100)
        monkeypatch.setattr(cfg, "STRING_HASH_RATIO", 0.2)


@pytest.fixture(scope="module")
def envs(env1, env4):
    return {1: env1, 4: env4}


def tables(dfs, envs, w):
    env = pct.CylonEnv(VirtualMeshConfig(w), device="cpu")
    return [(rct.Table.from_pandas(d, envs[w]), pct.Table.from_pandas(d, env))
            for d in dfs]


def same(ref, port):
    assert_layout(ref, port)
    assert port.grouped_by == ref.grouped_by
    return port


def keys(rng, n, card=2000):
    return np.asarray([f"user_{i:08d}" for i in rng.integers(0, card, n)],
                      dtype=object)


def odd_strings(n=10_000, seed=0):
    """Non-ASCII, empty strings, trailing and inner NULs, long values."""
    rng = np.random.default_rng(seed)
    pool = ["", "a", "ab", "ab\0", "ab\0\0", "a\0b", "é", "日本語", "\0",
            "x" * 70, "Customer#000000001"]
    out = []
    for i in rng.integers(0, len(pool) + 4, n):
        if i < len(pool):
            out.append(pool[i])
        else:
            out.append("".join(chr(c) for c in
                               rng.integers(1, 0x2FFF, rng.integers(0, 24))))
    return np.asarray(out, dtype=object)


def test_native_helpers_bit_equal():
    vals = odd_strings()
    np.testing.assert_array_equal(pnative.hash_strings(vals),
                                  rnative.hash_strings(vals))
    for n_lanes in (1, 5):
        np.testing.assert_array_equal(pnative.prefix_lanes(vals, n_lanes),
                                      rnative.prefix_lanes(vals, n_lanes))
    np.testing.assert_array_equal(pnative.utf8_lengths(vals),
                                  rnative.utf8_lengths(vals))
    u = np.asarray(sorted(set(vals)), dtype=object)
    assert pnative.max_adjacent_lcp(u) == rnative.max_adjacent_lcp(u)
    assert pnative.max_adjacent_lcp(np.asarray(["x"], dtype=object)) == 0
    with_null = vals.copy()
    with_null[::7] = None                      # a null hashes as ""
    np.testing.assert_array_equal(pnative.hash_strings(with_null),
                                  rnative.hash_strings(with_null))


def test_native_needs_a_toolchain(monkeypatch):
    from cylon_tpu_torch.exec import compiler as pcompiler
    # the loaded library lives in the compile tier's ledger: start
    # without it, so the load has to build
    monkeypatch.setattr(pcompiler, "_LEDGER", {})
    monkeypatch.setattr(pnative.shutil, "which", lambda name: None)
    with pytest.raises(KernelError, match="g\\+\\+"):
        pnative.hash_strings(np.asarray(["a"], dtype=object))


@pytest.mark.parametrize("w", [1, 4])
def test_crossover_codes_and_layout(envs, hashed_mode, w):
    """Above the crossover a string column's codes are the reference's
    int64 hashes, and the row hash routes its rows to the same shards."""
    rng = np.random.default_rng(1)
    k = keys(rng, 3000)
    k[::13] = None
    df = pd.DataFrame({"k": k, "v": np.arange(3000)})
    ((rt, pt),) = tables([df], envs, w)
    assert isinstance(rt.column("k").dictionary, RHashed)
    assert isinstance(pt.column("k").dictionary, HashedStrings)
    same(rt, pt)
    same(rct.relational.shuffle_table(rt, ["k"]),
         pct.shuffle_table(pt, ["k"]))
    back = pt.to_pydict()["k"]
    np.testing.assert_array_equal(back, k)
    # the codes of new values (a literal's) are the column's own
    live = pt.host_columns()["k"][0]
    np.testing.assert_array_equal(
        pt.column("k").dictionary.hash_values(k[1:6]), live[1:6])


def test_crossover_thresholds(hashed_mode, monkeypatch):
    rng = np.random.default_rng(2)
    low = np.asarray(["a", "b", "c"] * 2000, dtype=object)
    assert not isinstance(Column.from_numpy(low).dictionary, HashedStrings)
    monkeypatch.setattr(pconfig, "STRING_HASH_MIN_ROWS", 4_000_000)
    c = Column.from_numpy(keys(rng, 5000))
    assert not isinstance(c.dictionary, HashedStrings)


@pytest.mark.parametrize("w", [1, 4])
def test_join_groupby_on_hashed_keys(envs, hashed_mode, w):
    rng = np.random.default_rng(3)
    n = 3000
    ldf = pd.DataFrame({"k": keys(rng, n), "a": rng.integers(0, 99, n)})
    rdf = pd.DataFrame({"k": keys(rng, n), "b": rng.integers(0, 99, n)})
    (rl, pl), (rr, pr) = tables([ldf, rdf], envs, w)
    rj, pj = r_join(rl, rr, "k", "k"), pct.join_tables(pl, pr, "k", "k")
    same(rj, pj)
    aggs = [("a", "sum"), ("b", "sum"), ("a", "count")]
    same(r_groupby(rj, "k", aggs), pct.groupby_aggregate(pj, "k", aggs))
    same(r_groupby(rl, "k", [("a", "sum"), ("k", "nunique")]),
         pct.groupby_aggregate(pl, "k", [("a", "sum"), ("k", "nunique")]))
    assert pj.row_count == len(ldf.merge(rdf, on="k"))


def test_join_hashed_vs_dictionary_side(envs, hashed_mode, monkeypatch):
    """One side hashed, the other a sorted dictionary: both recode into
    hash space."""
    rng = np.random.default_rng(4)
    ldf = pd.DataFrame({"k": keys(rng, 3000), "a": rng.integers(0, 9, 3000)})
    ((rl, pl),) = tables([ldf], envs, 4)
    for cfg in (rconfig, pconfig):
        monkeypatch.setattr(cfg, "STRING_HASH_MIN_ROWS", 10**12)
    rdf = pd.DataFrame({"k": keys(rng, 500, card=300),
                        "b": rng.integers(0, 9, 500)})
    ((rr, pr),) = tables([rdf], envs, 4)
    assert not isinstance(pr.column("k").dictionary, HashedStrings)
    pj = same(r_join(rl, rr, "k", "k"), pct.join_tables(pl, pr, "k", "k"))
    assert pj.row_count == len(ldf.merge(rdf, on="k"))
    same(r_setop(rl.project(["k"]), rr.project(["k"]), "intersect"),
         pct.set_operation(pl.project(["k"]), pr.project(["k"]),
                           "intersect"))


@pytest.mark.parametrize("w", [1, 4])
def test_unique_and_set_ops_on_hashed_keys(envs, hashed_mode, w):
    rng = np.random.default_rng(5)
    a = pd.DataFrame({"k": keys(rng, 2000, card=500)})
    b = pd.DataFrame({"k": keys(rng, 1500, card=700)})
    (ra, pa), (rb, pb) = tables([a, b], envs, w)
    u = same(r_unique(ra, ["k"]), pct.unique_table(pa, ["k"]))
    assert u.row_count == a["k"].nunique()
    for op in ("union", "subtract"):
        same(r_setop(ra, rb, op), pct.set_operation(pa, pb, op))


def test_min_max_refusal(envs, hashed_mode):
    rng = np.random.default_rng(6)
    df = pd.DataFrame({"g": np.zeros(2000, np.int64), "k": keys(rng, 2000)})
    ((rt, pt),) = tables([df], envs, 1)
    for op in ("min", "max"):
        with pytest.raises(RInvalidError) as rerr:
            r_groupby(rt, "g", [("k", op)])
        with pytest.raises(pct.InvalidError) as perr:
            pct.groupby_aggregate(pt, "g", [("k", op)])
        assert str(perr.value) == str(rerr.value)
    same(r_groupby(rt, "g", [("k", "count")]),
         pct.groupby_aggregate(pt, "g", [("k", "count")]))


def sort_case(name):
    rng = np.random.default_rng(7)
    if name == "plain":
        return pd.DataFrame({"k": keys(rng, 3000, card=100000),
                             "v": np.arange(3000)})
    if name == "nulls":
        k = keys(rng, 2000, card=50000)
        k[rng.random(2000) < 0.05] = None
        return pd.DataFrame({"k": k, "v": np.arange(2000)})
    if name == "prefixes":        # short strings before their extensions
        vals = ["b", "ba", "b0", "a" * 9, "a" * 9 + "z", "a" * 8, "aa", "",
                "zz", "z"]
        return pd.DataFrame({"k": np.asarray(
            [vals[i % len(vals)] + f"_{i}" for i in range(1500)],
            dtype=object)})
    if name == "deep_prefix":     # > 64 shared bytes: the dense-rank lane
        pre = "p" * 80
        return pd.DataFrame({"k": np.asarray(
            [f"{pre}{i:06d}" for i in rng.permutation(1500)], dtype=object)})
    if name == "trailing_nul":    # 'ab' < 'ab\0' < 'ab\0\0': the length lane
        vals = []
        for b in (f"v{i}" for i in range(300)):
            vals += [b + "\0\0", b, b + "\0"]
        return pd.DataFrame({"k": np.asarray(vals, dtype=object)})
    if name == "non_ascii":
        return pd.DataFrame({"k": odd_strings(2000, seed=8)})
    raise ValueError(name)


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("case", ["plain", "nulls", "prefixes", "deep_prefix",
                                  "trailing_nul", "non_ascii"])
def test_sort_on_hashed_keys(envs, hashed_mode, w, case):
    df = sort_case(case)
    ((rt, pt),) = tables([df], envs, w)
    assert isinstance(pt.column("k").dictionary, HashedStrings)
    for kw in ({}, {"ascending": False, "nulls_position": "first"}):
        out = same(r_sort(rt, "k", **kw), pct.sort_table(pt, "k", **kw))
        asc = kw.get("ascending", True)
        exp = df.sort_values("k", ascending=asc, kind="stable",
                             na_position=kw.get("nulls_position", "last"))
        got = out.to_pydict()["k"]
        assert [None if x is None else x for x in got] == \
            [None if pd.isna(x) else x for x in exp["k"]]


def test_sort_mixed_keys_and_grouped_contract(envs, hashed_mode):
    rng = np.random.default_rng(9)
    df = pd.DataFrame({"k": keys(rng, 2500, card=1000),
                       "v": rng.integers(0, 50, 2500)})
    ((rt, pt),) = tables([df], envs, 4)
    same(r_sort(rt, ["k", "v"]), pct.sort_table(pt, ["k", "v"]))
    rs, ps = r_sort(rt, "k"), pct.sort_table(pt, "k")
    assert ps.grouped_by == ("k",)
    # the groupby takes the grouped fast path on the sorted output
    same(r_groupby(rs, "k", [("v", "sum")]),
         pct.groupby_aggregate(ps, "k", [("v", "sum")]))
    fr = pct.DataFrame(df, env=pct.CylonEnv(VirtualMeshConfig(4),
                                            device="cpu"))
    same(rs, fr.sort_values("k").table)
