"""Parity of every join type: cylon_tpu_torch's ``join_tables`` and
``join_tables_multi`` against cylon_tpu's on the CPU, at world sizes 1
(``env1``), 3 (a ``CPUMeshConfig(3)``), 4 (``env4``) and 8 (``env8``);
the port runs on ``VirtualMeshConfig(W, device="cpu")``.

The cases mirror tests/test_join.py: a single key with every ``how``, a
two-column key, dictionary-string keys, different key names, null keys
matching null keys, key type promotion, an empty side, a right table that
holds only its key, a heavy key, the semi/anti joins (including the
heavy-key spread of a skewed probe side), the outer join on a skewed
probe, the broadcast route and the N-way join.

Held: values bit for bit (floats too: a join moves values, it adds
none) and the whole layout — ``valid_counts``, capacity, every shard's
rows in order and its padding, validity, bounds and ``grouped_by`` —
and the same typed errors.  Both packages run the skew split at its
default, armed: the heavy-key and skewed-probe cases take it at W > 1,
and the output is the stitched one (tests/test_torch_skew.py holds the
split itself).  Both packages take the broadcast route at the same
``BROADCAST_JOIN_ROWS``:
0 unless a case sets both to another value; a side of 0 rows takes the
route even then.  The reference's join capacity cache is cleared before
each case."""

import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu import config as rconfig
from cylon_tpu.ctx.context import CPUMeshConfig
from cylon_tpu.relational import join as rjoin
from cylon_tpu.relational import join_tables as r_join
from cylon_tpu.relational import join_tables_multi as r_multi
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from cylon_tpu_torch.parallel import shuffle as pshuf
from cylon_tpu_torch.relational import join as pjoin
from cylon_tpu_torch.utils import timing
from test_torch_shuffle import assert_layout

HOWS = ["inner", "left", "right", "outer"]
ALL_HOWS = HOWS + ["semi", "anti"]


@pytest.fixture(autouse=True)
def same_routes(monkeypatch):
    set_broadcast(monkeypatch, 0)
    # the reference materializes a join at the capacity an earlier call
    # with the same signature needed, when that is larger (its
    # speculative dispatch); the port has none, so each case starts
    # without the cache
    rjoin._CAP_CACHE.clear()


def set_broadcast(monkeypatch, rows: int) -> None:
    monkeypatch.setattr(rconfig, "BROADCAST_JOIN_ROWS", rows)
    monkeypatch.setattr(pconfig, "BROADCAST_JOIN_ROWS", rows)


@pytest.fixture(scope="module")
def envs(env1, env4, env8):
    return {1: env1, 3: rct.CylonEnv(config=CPUMeshConfig(world_size=3)),
            4: env4, 8: env8}


def penv(w):
    return pct.CylonEnv(VirtualMeshConfig(w), device="cpu")


def both(ldf, rdf, envs, w, left_on, right_on=None, how="inner", **kw):
    """The same join in both packages, held layout-equal; returns the
    port's output."""
    right_on = left_on if right_on is None else right_on
    ref = r_join(rct.Table.from_pandas(ldf, envs[w]),
                 rct.Table.from_pandas(rdf, envs[w]), left_on, right_on,
                 how=how, **kw)
    env = penv(w)
    out = pct.join_tables(pct.Table.from_pandas(ldf, env),
                          pct.Table.from_pandas(rdf, env), left_on,
                          right_on, how=how, **kw)
    assert_layout(ref, out)
    assert out.grouped_by == ref.grouped_by
    return out


def dfs(seed=42, nl=97, nr=53, lo=0, hi=30):
    rng = np.random.default_rng(seed)
    ldf = pd.DataFrame({"k": rng.integers(lo, hi, nl),
                        "a": rng.random(nl),
                        "c": rng.integers(0, 5, nl)})
    rdf = pd.DataFrame({"k": rng.integers(lo, hi, nr),
                        "b": rng.random(nr),
                        "c": rng.integers(0, 5, nr)})
    return ldf, rdf


@pytest.mark.parametrize("w", [1, 3, 4, 8])
@pytest.mark.parametrize("how", ALL_HOWS)
def test_join_single_key(envs, w, how):
    ldf, rdf = dfs()
    out = both(ldf, rdf, envs, w, "k", how=how)
    if how in HOWS:
        exp = ldf.merge(rdf, on="k", how=how, suffixes=("_x", "_y"))
        assert out.row_count == len(exp)
        assert out.column_names == list(exp.columns)


@pytest.mark.parametrize("how", ALL_HOWS)
def test_join_multi_key(envs, how):
    ldf, rdf = dfs()
    both(ldf, rdf, envs, 8, ["k", "c"], how=how)


@pytest.mark.parametrize("how", ["inner", "left", "outer", "anti"])
def test_join_string_key(envs, how):
    rng = np.random.default_rng(5)
    keys = np.array(["ant", "bee", "cat", "dog", "elk", "fox"], object)
    ldf = pd.DataFrame({"k": rng.choice(keys[:5], 50), "a": rng.random(50)})
    rdf = pd.DataFrame({"k": rng.choice(keys[2:], 30), "b": rng.random(30)})
    both(ldf, rdf, envs, 8, "k", how=how)


@pytest.mark.parametrize("how", ["inner", "right", "outer"])
def test_join_different_key_names(envs, how):
    rng = np.random.default_rng(6)
    ldf = pd.DataFrame({"lk": rng.integers(0, 10, 40), "a": rng.random(40)})
    rdf = pd.DataFrame({"rk": rng.integers(0, 10, 30), "b": rng.random(30)})
    both(ldf, rdf, envs, 4, "lk", "rk", how=how)


@pytest.mark.parametrize("how", ["inner", "outer", "semi", "anti"])
def test_join_null_keys_match(envs, how):
    ldf = pd.DataFrame({"k": ["a", None, "b", None], "a": [1, 2, 3, 4]})
    rdf = pd.DataFrame({"k": ["a", None, "c"], "b": [10, 20, 30]})
    both(ldf, rdf, envs, 4, "k", how=how)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_type_promotion(envs, how):
    rng = np.random.default_rng(7)
    ldf = pd.DataFrame({"k": rng.integers(0, 10, 40).astype(np.int32),
                        "a": rng.random(40)})
    rdf = pd.DataFrame({"k": rng.integers(0, 10, 30).astype(np.int64),
                        "b": rng.random(30)})
    out = both(ldf, rdf, envs, 4, "k", how=how)
    assert str(out.column("k").data.dtype) == "torch.int64"


@pytest.mark.parametrize("n_right", [2, 5])
@pytest.mark.parametrize("how", ["inner", "right", "left", "outer"])
def test_join_empty_side(envs, how, n_right):
    """An empty left side at W = 4.  Facing at least 4 rows it takes the
    broadcast route even at BROADCAST_JOIN_ROWS = 0 (0 <= 0) where the
    join type allows it, in both packages, so ``grouped_by`` is None."""
    ldf = pd.DataFrame({"k": np.array([], np.int64),
                        "a": np.array([], np.float64)})
    rdf = pd.DataFrame({"k": np.arange(1, n_right + 1, dtype=np.int64),
                        "b": np.arange(n_right, dtype=np.float64)})
    out = both(ldf, rdf, envs, 4, "k", how=how)
    assert out.row_count == (n_right if how in ("right", "outer") else 0)
    broadcast = how in ("inner", "right") and n_right >= 4
    assert (out.grouped_by is None) == broadcast


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("how", ALL_HOWS)
def test_join_zero_capacity_side_w1(envs, how, side):
    """A W = 1 table of no rows has capacity 0.  The reference's gather
    from it fails (ROADMAP.md Queue 3); the port answers, with the rows
    and dtypes the reference gives at W = 4, where the empty side has a
    padding row."""
    emp = pd.DataFrame({"k": np.array([], np.int64),
                        "a": np.array([], np.float64)})
    full = pd.DataFrame({"k": np.arange(5, dtype=np.int64),
                         "b": np.arange(5, dtype=np.float64) * 2})
    ldf, rdf = (emp, full) if side == "left" else (full, emp)
    ref = r_join(rct.Table.from_pandas(ldf, envs[4]),
                 rct.Table.from_pandas(rdf, envs[4]), "k", "k", how=how)
    pt = [pct.Table.from_pandas(x, penv(1)) for x in (ldf, rdf)]
    assert min(t.capacity for t in pt) == 0
    out = pct.join_tables(*pt, "k", "k", how=how)
    got, exp = out.to_pandas(), ref.to_pandas()
    assert list(got.columns) == list(exp.columns)
    assert list(got.dtypes) == list(exp.dtypes)
    pd.testing.assert_frame_equal(
        got.sort_values("k").reset_index(drop=True),
        exp.sort_values("k").reset_index(drop=True))


@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_join_right_table_key_only(envs, how):
    ldf = pd.DataFrame({"k": [1, 2, 3, 4], "a": [1., 2., 3., 4.]})
    rdf = pd.DataFrame({"k": [2, 3, 5]})
    out = both(ldf, rdf, envs, 4, "k", how=how)
    assert out.row_count == len(ldf.merge(rdf, on="k", how=how))


def heavy_frames(seed=8, n=200, share=0.8):
    rng = np.random.default_rng(seed)
    ldf = pd.DataFrame({"k": np.where(rng.random(n) < share, 7,
                                      rng.integers(0, 50, n)),
                        "a": rng.random(n)})
    rdf = pd.DataFrame({"k": rng.integers(0, 50, 40), "b": rng.random(40)})
    return ldf, rdf


@pytest.mark.parametrize("how", HOWS)
def test_join_heavy_skew(envs, how):
    """One key holding 80% of the left rows: the unsplit hash plan."""
    ldf, rdf = heavy_frames()
    both(ldf, rdf, envs, 8, "k", how=how)


def test_how_validation(envs):
    ldf, rdf = dfs()
    for lib, env in ((rct, envs[4]), (pct, penv(4))):
        join = r_join if lib is rct else pct.join_tables
        lt = lib.Table.from_pandas(ldf, env)
        rt = lib.Table.from_pandas(rdf, env)
        with pytest.raises(lib.status.InvalidError, match="how must be"):
            join(lt, rt, "k", "k", how="cross")
        with pytest.raises(lib.status.InvalidError):
            join(lt, rt, ["k", "c"], ["k"], how="left")


class TestSemiAntiJoin:
    """LEFT SEMI / LEFT ANTI: the output is the kept left rows, in each
    shard's row order, with no expansion."""

    @pytest.mark.parametrize("how", ["semi", "anti"])
    def test_matches_w4(self, envs, how):
        rng = np.random.default_rng(9)
        ldf = pd.DataFrame({"k": rng.integers(0, 60, 400).astype(np.int64),
                            "a": rng.random(400)})
        rdf = pd.DataFrame({"k": rng.integers(30, 90, 250).astype(np.int64),
                            "b": rng.random(250)})
        out = both(ldf, rdf, envs, 4, "k", how=how)
        m = ldf["k"].isin(set(rdf["k"]))
        exp = ldf[m] if how == "semi" else ldf[~m]
        assert sorted(out.to_pydict()["k"]) == sorted(exp["k"])

    @pytest.mark.parametrize("how", ["semi", "anti"])
    def test_local_w1(self, envs, how):
        rng = np.random.default_rng(10)
        ldf = pd.DataFrame({"k": rng.integers(0, 30, 120).astype(np.int64)})
        rdf = pd.DataFrame({"k": rng.integers(15, 45, 80).astype(np.int64)})
        out = both(ldf, rdf, envs, 1, "k", how=how)
        m = ldf["k"].isin(set(rdf["k"]))
        np.testing.assert_array_equal(out.to_pydict()["k"],
                                      ldf["k"][m if how == "semi" else ~m])

    def test_duplicates_emit_once(self, envs):
        ldf = pd.DataFrame({"k": np.asarray([1, 1, 2, 3], np.int64)})
        rdf = pd.DataFrame({"k": np.asarray([1] * 50 + [3], np.int64)})
        semi = both(ldf, rdf, envs, 4, "k", how="semi")
        anti = both(ldf, rdf, envs, 4, "k", how="anti")
        assert sorted(semi.to_pydict()["k"]) == [1, 1, 3]
        assert list(anti.to_pydict()["k"]) == [2]

    @pytest.mark.parametrize("how", ["semi", "anti"])
    def test_null_keys_match_nulls(self, envs, how):
        ldf = pd.DataFrame({"k": pd.array([1, None, 2], dtype="Int64")})
        rdf = pd.DataFrame({"k": pd.array([None, 2], dtype="Int64")})
        out = both(ldf, rdf, envs, 4, "k", how=how)
        assert out.row_count == (2 if how == "semi" else 1)

    @pytest.mark.parametrize("how", ["semi", "anti"])
    def test_string_keys(self, envs, how):
        rng = np.random.default_rng(11)
        lk = np.asarray([f"u{i}" for i in rng.integers(0, 40, 300)], object)
        rk = np.asarray([f"u{i}" for i in rng.integers(20, 60, 200)], object)
        both(pd.DataFrame({"k": lk}), pd.DataFrame({"k": rk}), envs, 4, "k",
             how=how)

    @pytest.mark.parametrize("w", [3, 8])
    @pytest.mark.parametrize("how", ["semi", "anti"])
    def test_skewed_probe(self, envs, monkeypatch, w, how):
        """90% of the probe rows on one key: both packages detect it and
        take the semi/anti spread (heavy build rows replicated, heavy
        probe rows round-robin), with the same layout."""
        monkeypatch.setattr(rconfig, "SKEW_MIN_SHARE", 0.01)
        monkeypatch.setattr(pconfig, "SKEW_MIN_SHARE", 0.01)
        spread = []
        orig = pshuf.skew_targets
        monkeypatch.setattr(pshuf, "skew_targets",
                            lambda *a: spread.append(1) or orig(*a))
        rng = np.random.default_rng(12)
        n = 4000
        lk = rng.integers(0, 500, n).astype(np.int64)
        lk[rng.random(n) < 0.9] = 7
        ldf = pd.DataFrame({"k": lk, "a": rng.random(n)})
        rdf = pd.DataFrame({"k": rng.integers(0, 500, 600).astype(np.int64)})
        out = both(ldf, rdf, envs, w, "k", how=how)
        assert spread == [1]
        m = ldf["k"].isin(set(rdf["k"]))
        exp = ldf[m] if how == "semi" else ldf[~m]
        assert sorted(out.to_pydict()["k"]) == sorted(exp["k"])

    def test_replication_guard(self, envs, monkeypatch):
        """A build side as heavy on the key as the probe: replicating it
        would blow up, so both packages hash both sides instead."""
        monkeypatch.setattr(rconfig, "SKEW_GUARD_ROWS", 100)
        monkeypatch.setattr(pconfig, "SKEW_GUARD_ROWS", 100)
        spread = []
        orig = pshuf.skew_targets
        monkeypatch.setattr(pshuf, "skew_targets",
                            lambda *a: spread.append(1) or orig(*a))
        rng = np.random.default_rng(14)
        lk = np.where(rng.random(3000) < 0.9, 3, rng.integers(0, 400, 3000))
        rk = np.where(rng.random(1500) < 0.9, 3, rng.integers(0, 400, 1500))
        both(pd.DataFrame({"k": lk}), pd.DataFrame({"k": rk}), envs, 8,
             "k", how="semi")
        assert spread == []


class TestOuterSkew:
    """Outer joins on a probe side where one key holds 85-90% of the
    rows: the unsplit hash plan, layout-equal."""

    def test_outer_90pct_one_key_w8(self, envs):
        rng = np.random.default_rng(15)
        n = 3000
        lk = rng.integers(0, 400, n).astype(np.int64)
        lk[rng.random(n) < 0.9] = 11
        ldf = pd.DataFrame({"k": lk, "a": rng.random(n)})
        rdf = pd.DataFrame({"k": rng.integers(200, 600, 800).astype(
            np.int64), "b": rng.random(800)})
        out = both(ldf, rdf, envs, 8, "k", how="outer")
        assert out.row_count == len(ldf.merge(rdf, on="k", how="outer"))

    def test_outer_skew_with_string_payload(self, envs):
        rng = np.random.default_rng(16)
        n = 2000
        lk = rng.integers(0, 200, n).astype(np.int64)
        lk[rng.random(n) < 0.85] = 3
        ldf = pd.DataFrame({"k": lk,
                            "s": [f"L{i % 37}" for i in range(n)]})
        rdf = pd.DataFrame({"k": rng.integers(100, 300, 500).astype(
            np.int64), "t": [f"R{i % 23}" for i in range(500)]})
        both(ldf, rdf, envs, 8, "k", how="outer")


class TestBroadcastJoin:
    """A small side replicates to every shard and the big side does not
    move; both packages at BROADCAST_JOIN_ROWS = 1000."""

    def _mk(self, seed=17, n_big=3000, n_small=40):
        rng = np.random.default_rng(seed)
        big = pd.DataFrame({"k": rng.integers(0, 50, n_big).astype(np.int64),
                            "a": rng.random(n_big)})
        small = pd.DataFrame({"k": np.arange(25, 25 + n_small,
                                             dtype=np.int64) % 60,
                              "b": rng.random(n_small)})
        return big, small

    @pytest.mark.parametrize("w", [3, 8])
    @pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
    def test_small_right(self, envs, monkeypatch, w, how):
        set_broadcast(monkeypatch, 1000)
        big, small = self._mk()
        timing.reset()
        out = both(big, small, envs, w, "k", how=how)
        assert timing.counts().get("join.broadcast") == 1
        assert out.grouped_by is None   # big side never co-located

    @pytest.mark.parametrize("how", ["right", "inner"])
    def test_small_left(self, envs, monkeypatch, how):
        set_broadcast(monkeypatch, 1000)
        big, small = self._mk()
        timing.reset()
        out = both(small, big, envs, 8, "k", how=how)
        assert timing.counts().get("join.broadcast") == 1
        assert out.row_count == len(small.merge(big, on="k", how=how))

    @pytest.mark.parametrize("how", ["outer", "right"])
    def test_unmatched_small_side_is_not_replicated(self, envs, monkeypatch,
                                                    how):
        """An outer join (either side) and a right join with a small right
        side would emit the replicated side's unmatched rows once per
        shard: both packages hash instead."""
        set_broadcast(monkeypatch, 1000)
        big, small = self._mk()
        timing.reset()
        both(big, small, envs, 4, "k", how=how)
        assert "join.broadcast" not in timing.counts()

    def test_no_shuffle_issued(self, envs, monkeypatch):
        set_broadcast(monkeypatch, 1000)
        calls = []
        for mod in (rjoin, pjoin):
            orig = mod.shuffle_table
            monkeypatch.setattr(
                mod, "shuffle_table",
                lambda *a, _o=orig, **k: calls.append(1) or _o(*a, **k))
        big, small = self._mk()
        both(big, small, envs, 8, "k", how="inner")
        assert calls == []   # the broadcast replaced both shuffles


class TestJoinTablesMulti:
    """The same-key N-way join: one co-partition per table, then a chain
    of local joins."""

    def _abc(self, seed=18):
        rng = np.random.default_rng(seed)
        n = 600
        return (pd.DataFrame({"k": rng.integers(0, 80, n).astype(np.int64),
                              "a": rng.random(n)}),
                pd.DataFrame({"k": rng.integers(0, 80, n).astype(np.int32),
                              "b": rng.random(n)}),
                pd.DataFrame({"k": rng.integers(0, 80, 100).astype(np.int64),
                              "c": rng.random(100)}))

    def both_multi(self, frames, ons, envs, w, **kw):
        ref = r_multi([rct.Table.from_pandas(f, envs[w]) for f in frames],
                      ons, **kw)
        env = penv(w)
        out = pct.join_tables_multi(
            [pct.Table.from_pandas(f, env) for f in frames], ons, **kw)
        assert_layout(ref, out)
        assert out.grouped_by is ref.grouped_by is None
        return out

    @pytest.mark.parametrize("w", [1, 4])
    @pytest.mark.parametrize("how", ["inner", "left"])
    def test_three_way(self, envs, w, how):
        """Three tables, the middle one's int32 key promoted before the
        shuffles."""
        a, b, c = self._abc()
        out = self.both_multi((a, b, c), ["k"] * 3, envs, w, how=how)
        exp = a.merge(b.astype({"k": np.int64}), on="k", how=how).merge(
            c, on="k", how=how)
        assert out.row_count == len(exp)

    def test_one_shuffle_per_table(self, envs, monkeypatch):
        calls = []
        orig = pjoin.shuffle_table
        monkeypatch.setattr(pjoin, "shuffle_table",
                            lambda *a, **k: calls.append(1) or orig(*a, **k))
        rng = np.random.default_rng(19)
        frames = [pd.DataFrame({"k": rng.integers(0, 60, 500),
                                f"v{i}": rng.random(500)}) for i in range(4)]
        self.both_multi(frames, ["k"] * 4, envs, 4)
        assert len(calls) == 4   # one exchange per table, none repeated

    def test_small_right_table_broadcast(self, envs, monkeypatch):
        set_broadcast(monkeypatch, 150)
        calls = []
        orig = pjoin.shuffle_table
        monkeypatch.setattr(pjoin, "shuffle_table",
                            lambda *a, **k: calls.append(1) or orig(*a, **k))
        self.both_multi(self._abc(), ["k"] * 3, envs, 8, how="left")
        assert len(calls) == 2   # the 100-row table replicated

    def test_string_keys_multi(self, envs):
        rng = np.random.default_rng(20)

        def mk(n, lo, hi):
            return pd.DataFrame(
                {"k": np.asarray([f"u{v}" for v in rng.integers(lo, hi, n)],
                                 object), f"v{lo}": rng.random(n)})
        self.both_multi((mk(300, 0, 40), mk(300, 20, 60), mk(100, 0, 60)),
                        ["k"] * 3, envs, 4)

    def test_colliding_left_chain_keeps_left_keys(self, envs):
        """A payload column named like the accumulated key renames it
        with suffixes[0]; the chain goes on joining on the renamed key
        (tests/test_advice_regressions.py)."""
        t1 = pd.DataFrame({"k": ["1", "2", "3", "9"], "x": [10, 20, 30, 90]})
        t2 = pd.DataFrame({"j": ["1", "2", "3"], "k": ["a", "b", "c"],
                           "y": [7, 8, 9]})
        t3 = pd.DataFrame({"m": ["1", None], "z": [111, 999]})
        out = self.both_multi((t1, t2, t3), ["k", "j", "m"], envs, 4,
                              how="left")
        got = out.to_pydict()
        assert got["z"][list(got["k_x"]).index("9")] is None

    def test_typed_errors(self, envs, monkeypatch):
        a, b, c = self._abc()
        for lib, multi, mod, env in ((rct, r_multi, rjoin, envs[4]),
                                     (pct, pct.join_tables_multi, pjoin,
                                      penv(4))):
            ts = [lib.Table.from_pandas(f, env) for f in (a, b, c)]
            err = lib.status.InvalidError
            with pytest.raises(err):
                multi(ts[:1], ["k"])
            with pytest.raises(err):
                multi(ts, ["k"] * 3, how="outer")
            with pytest.raises(err):
                multi(ts, ["k", ["k", "b"], "k"])
            # a step whose output lost the accumulated key column
            orig = mod.join_tables
            with monkeypatch.context() as mp:
                mp.setattr(mod, "join_tables",
                           lambda *x, **k: orig(*x, **k).project(["a", "b"]))
                with pytest.raises(err, match="disappeared"):
                    multi(ts, ["k"] * 3)


# ---------------------------------------------------------------------------
# the building blocks: ops/sort's compaction and null gather,
# repart.filter_table and collectives.allgather_table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_cap", [16, 64])
def test_compact_and_take_with_nulls(out_cap):
    import jax.numpy as jnp
    import torch
    from cylon_tpu.ops import sort as rsort
    from cylon_tpu_torch.ops import sort as psort
    rng = np.random.default_rng(21)
    flag = rng.random(40) < 0.3
    r_idx, r_n = rsort.compact_by_flag(jnp.asarray(flag), out_cap)
    p_idx, p_n = psort.compact_by_flag(torch.from_numpy(flag), out_cap)
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(r_idx))
    assert int(p_n) == int(r_n) == int(flag.sum())
    data = rng.integers(-9, 9, 40)
    valid = rng.random(40) < 0.8
    idx = rng.integers(-1, 40, 25).astype(np.int32)
    for v in (None, valid):
        rd, rv = rsort.take_with_nulls(
            jnp.asarray(data), None if v is None else jnp.asarray(v),
            jnp.asarray(idx))
        pd_, pv = psort.take_with_nulls(
            torch.from_numpy(data), None if v is None else torch.from_numpy(
                v), torch.from_numpy(idx))
        np.testing.assert_array_equal(pd_.numpy(), np.asarray(rd))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("w", [1, 3, 8])
def test_filter_and_allgather_table(envs, w):
    """``filter_table`` on a nullable bool column's ``valid_flag`` (rows
    stay on their shard, in order) and ``allgather_table`` (every shard
    holds every row), layout-equal to the reference."""
    import torch
    from cylon_tpu.parallel.collectives import allgather_table as r_gather
    from cylon_tpu.relational.common import valid_flag as r_flag
    from cylon_tpu.relational.repart import filter_table as r_filter
    from cylon_tpu_torch.parallel.collectives import allgather_table
    from cylon_tpu_torch.relational.common import valid_flag
    rng = np.random.default_rng(22)
    n = 300
    df = pd.DataFrame({"k": rng.integers(0, 50, n),
                       "f": rng.random(n),
                       "p": pd.array(rng.random(n) < 0.5, dtype="boolean"),
                       "s": rng.choice(["x", "y", "z"], n).astype(object)})
    df.loc[df.index % 9 == 0, "p"] = pd.NA
    rt = rct.Table.from_pandas(df, envs[w])
    pt = pct.Table.from_pandas(df, penv(w))
    ref = r_filter(rt, r_flag(rt.column("p")))
    out = pct.filter_table(pt, valid_flag(pt.column("p")))
    assert_layout(ref, out)
    assert out.row_count == int(df["p"].fillna(False).sum())
    assert_layout(r_gather(rt), allgather_table(pt))
    assert allgather_table(pt).row_count == n * w
    assert isinstance(out.column("k").data, torch.Tensor)
