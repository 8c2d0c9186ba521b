"""Parity of the file IO, the Arrow interop and the streamed scan join:
the same files read by ``cylon_tpu_torch.io`` and ``cylon_tpu.io`` on the
CPU give equal tables, after tests/test_io.py, at world sizes 1 and 4 (8
for the per-shard writers).

Cases: CSV, Parquet and JSON round trips (single and multi-file, pandas
reader options), the distributed readers' partitions (file division,
row-group balancing), the per-shard writers (one shard on the host at a
time), ``Table.from_arrow``/``to_arrow``/``to_pylist``/``from_numpy``/
``host_column``, ``scan_parquet_dist`` batches and projection, and
``pipelined_scan_join`` with and without a ``GroupBySink`` (its ledger
peak below the scan's bytes) and its typed limits; ``timing``'s
attribution helpers and ``set_log_level``.  A subprocess with pandas and
pyarrow made unimportable runs a Series query and a scan join, and gets
``CylonIOError`` naming the package from every IO call.

Held: tables layout- and bit-equal (values are read, not computed), the
same files written, the same typed errors by class name."""

import logging
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import cylon_tpu as rct
from cylon_tpu import io as rio
from cylon_tpu import config as rconfig
from cylon_tpu.exec import GroupBySink as RSink
from cylon_tpu.exec import pipelined_scan_join as r_scan_join
from cylon_tpu.relational import join as rjoin
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch import io as pio
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from cylon_tpu_torch.exec import memory
from cylon_tpu_torch.utils import timing
from test_torch_groupby_sort import assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _envs(w, env1, env4, env8):
    return ({1: env1, 4: env4, 8: env8}[w],
            pct.CylonEnv(VirtualMeshConfig(w), device="cpu"))


@pytest.fixture(params=[1, 4])
def envs(request, env1, env4, env8):
    return _envs(request.param, env1, env4, env8)


@pytest.fixture()
def data():
    rng = np.random.default_rng(5)
    return pd.DataFrame({"k": rng.integers(0, 50, 100),
                         "v": rng.random(100).round(6),
                         "s": rng.choice(["aa", "bb", "cc"], 100)})


def same(r, p):
    assert_same(r, p)
    pd.testing.assert_frame_equal(p.to_pandas(), r.to_pandas())


def test_single_file_roundtrips(tmp_path, envs, data):
    renv, penv = envs
    data.to_csv(tmp_path / "t.csv", index=False)
    data.to_parquet(tmp_path / "t.parquet", index=False)
    data.to_json(tmp_path / "t.jsonl", orient="records", lines=True)
    data.to_json(tmp_path / "t.json", orient="records")
    for reader, name, kw in [("read_csv", "t.csv", {}),
                             ("read_csv", "t.csv", {"usecols": ["k", "s"]}),
                             ("read_parquet", "t.parquet", {}),
                             ("read_parquet", "t.parquet",
                              {"columns": ["v"]}),
                             ("read_json", "t.jsonl", {}),
                             ("read_json", "t.json", {})]:
        p = getattr(pio, reader)(tmp_path / name, penv, **kw)
        same(getattr(rio, reader)(tmp_path / name, renv, **kw), p)
    t = pio.read_csv(tmp_path / "t.csv", penv)
    pio.write_csv(t, tmp_path / "o.csv")
    pio.write_parquet(t, tmp_path / "o.parquet")
    pio.write_json(t, tmp_path / "o.jsonl")
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "o.csv"), data)
    pd.testing.assert_frame_equal(pd.read_parquet(tmp_path / "o.parquet"),
                                  data)
    pd.testing.assert_frame_equal(
        pd.read_json(tmp_path / "o.jsonl", orient="records", lines=True),
        data)
    d = pct.DataFrame(_table=t)
    d.to_csv(tmp_path / "d.csv")
    d.to_parquet(tmp_path / "d.parquet")
    d.to_json(tmp_path / "d.jsonl")
    assert pd.read_csv(tmp_path / "d.csv").equals(data)


def test_multi_file_and_dist_readers(tmp_path, envs, data):
    renv, penv = envs
    sizes = [40, 25, 20, 15]
    off = 0
    for i, n in enumerate(sizes):
        data.iloc[off:off + n].to_csv(tmp_path / f"f{i}.csv", index=False)
        off += n
    glob = str(tmp_path / "f*.csv")
    same(rio.read_csv(glob, renv), pio.read_csv(glob, penv))
    p = pio.read_csv_dist(glob, penv)
    same(rio.read_csv_dist(glob, renv), p)
    same(rio.read_csv_dist(glob, renv, dtype={"k": "int32"}),
         pio.read_csv_dist(glob, penv, dtype={"k": "int32"}))
    data.to_parquet(tmp_path / "t.parquet", index=False, row_group_size=10)
    p = pio.read_parquet_dist(str(tmp_path / "t.parquet"), penv)
    same(rio.read_parquet_dist(str(tmp_path / "t.parquet"), renv), p)
    assert p.row_count == 100 and max(p.valid_counts) <= 100
    with pytest.raises(pct.CylonIOError):
        pio.read_csv(str(tmp_path / "nothing*.csv"), penv)
    with pytest.raises(pct.CylonIOError):
        pio.read_parquet_dist(str(tmp_path / "t.parquet"), penv,
                              batch_rows=20, engine="pyarrow")


def test_dist_writers_one_shard_at_a_time(tmp_path, env1, env4, env8,
                                          monkeypatch):
    """One file per shard, the same files as the reference's, without a
    whole-table pull."""
    renv, penv = _envs(8, env1, env4, env8)
    rng = np.random.default_rng(9)
    df = pd.DataFrame({"k": np.arange(3000, dtype=np.int64),
                       "s": np.asarray(["x", "y", "z"])[
                           rng.integers(0, 3, 3000)],
                       "v": rng.random(3000)})
    rt, pt = rct.Table.from_pandas(df, renv), pct.Table.from_pandas(df, penv)

    def boom(self):
        raise AssertionError("a dist writer pulled the whole table")

    monkeypatch.setattr(pct.Table, "to_pandas", boom)
    for fn, ext, read in [("write_csv_dist", "csv", pd.read_csv),
                          ("write_parquet_dist", "parquet", pd.read_parquet),
                          ("write_json_dist", "json",
                           lambda f: pd.read_json(f, lines=True))]:
        rfiles = getattr(rio, fn)(rt, str(tmp_path / f"r.{ext}"))
        pfiles = getattr(pio, fn)(pt, str(tmp_path / f"p.{ext}"))
        assert len(pfiles) == len(rfiles) == 8
        for rf, pf in zip(rfiles, pfiles):
            pd.testing.assert_frame_equal(read(pf), read(rf))


def test_arrow_table_methods(envs):
    renv, penv = envs
    at = pa.table({"i": pa.array([1, None, 3, 4], type=pa.int32()),
                   "f": pa.array([0.5, 1.5, None, 2.5]),
                   "s": pa.array(["b", "a", None, "b"]),
                   "d": pa.array(["x", "y", "x", "x"]).dictionary_encode(),
                   "t": pa.array([1, 2, None, 4], type=pa.timestamp("ms")),
                   "du": pa.array([5, None, 7, 8], type=pa.duration("s")),
                   "b": pa.array([True, None, False, True]),
                   "n": pa.nulls(4)})
    r, p = rct.Table.from_arrow(at, renv), pct.Table.from_arrow(at, penv)
    same(r, p)
    assert p.to_arrow().equals(r.to_arrow())
    rows = p.project(["i", "f", "s", "b"]).to_pylist()
    exp = at.select(["i", "f", "s", "b"]).to_pylist()
    assert [{k: (None if isinstance(v, float) and v != v else v)
             for k, v in row.items()} for row in rows] == exp
    np.testing.assert_array_equal(p.host_column("i")[0],
                                  r.host_column("i")[0])
    np.testing.assert_array_equal(p.host_column("i")[1],
                                  r.host_column("i")[1])
    names, arrs = ["a", "b"], [np.arange(5), np.arange(5) * 0.5]
    same(rct.Table.from_numpy(names, arrs, renv),
         pct.Table.from_numpy(names, arrs, penv))
    # the index column stays in the Arrow table
    assert pct.DataFrame(_table=p).set_index("i").to_arrow().column_names \
        == p.column_names


def _fact_dim(n=6000, keys=300, seed=4):
    rng = np.random.default_rng(seed)
    fact = pd.DataFrame({"k": rng.integers(0, keys, n).astype(np.int64),
                         "v": rng.integers(0, 100, n).astype(np.int64)})
    dim = pd.DataFrame({"k": np.arange(keys, dtype=np.int64),
                        "w": rng.integers(0, 9, keys).astype(np.int64)})
    return fact, dim


def test_scan_parquet_dist_batches(tmp_path, envs):
    renv, penv = envs
    fact, _ = _fact_dim()
    p = str(tmp_path / "fact.parquet")
    fact.to_parquet(p, row_group_size=700, index=False)
    rs = rio.scan_parquet_dist(p, renv, batch_rows=1500)
    ps = pio.scan_parquet_dist(p, penv, batch_rows=1500)
    assert ps.total_rows == rs.total_rows == len(fact)
    assert ps.column_names == rs.column_names == ["k", "v"]
    assert list(ps.batches()) == list(rs.batches())
    for rb, pb in zip(rs, ps):
        same(rb, pb)
    for cols in (["k"], ["v", "k"]):
        ps = pio.scan_parquet_dist(p, penv, batch_rows=2000, columns=cols)
        assert ps.column_names == cols
        assert all(b.column_names == cols for b in ps)
    assert isinstance(pio.read_parquet_dist(p, penv, batch_rows=2000),
                      pio.ParquetScanSource)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_pipelined_scan_join(tmp_path, envs, how):
    """With a sink: the groups equal the reference's and pandas', and the
    ledger never holds the whole scan side; without: the joined rows equal
    the reference's, batch for batch."""
    renv, penv = envs
    fact, dim = _fact_dim()
    dim = dim[dim.k % 7 != 0]   # unmatched fact rows for the left join
    p = str(tmp_path / "fact.parquet")
    fact.to_parquet(p, row_group_size=700, index=False)
    rb, pb = rct.Table.from_pandas(dim, renv), pct.Table.from_pandas(dim,
                                                                     penv)
    aggs = [("v", "sum"), ("w", "sum"), ("v", "count")]
    rsink, psink = RSink("k", aggs), pct.GroupBySink("k", aggs)
    r_scan_join(rio.scan_parquet_dist(p, renv, batch_rows=1500), rb, "k",
                "k", how=how, sink=rsink)
    memory.reset_stats()
    before = memory.ledger().balance()
    outs = pct.pipelined_scan_join(pio.scan_parquet_dist(
        p, penv, batch_rows=1500), pb, "k", "k", how=how, sink=psink)
    assert len(outs) == 5   # 9 row groups of 700 rows, two a batch
    peak = memory.ledger().peak - before
    assert 0 < peak < sum(fact[c].to_numpy().nbytes for c in fact.columns)
    same(rsink.finalize(), psink.finalize())
    rj = r_scan_join(rio.scan_parquet_dist(p, renv, batch_rows=1500), rb,
                     "k", "k", how=how)
    pj = pct.pipelined_scan_join(pio.scan_parquet_dist(
        p, penv, batch_rows=1500), pb, "k", "k", how=how)
    same(rj, pj)
    # any iterable of Tables is a scan
    batches = [pct.Table.from_pandas(fact.iloc[i:i + 2000], penv)
               for i in range(0, len(fact), 2000)]
    same(pct.pipelined_scan_join(batches, pb, "k", "k", how=how),
         pct.pipelined_scan_join(iter(batches), pb, "k", "k", how=how))


def test_pipelined_scan_join_typed_limits(tmp_path, envs):
    renv, penv = envs
    fact, dim = _fact_dim(n=2000, keys=50)
    p = str(tmp_path / "fact.parquet")
    fact.to_parquet(p, row_group_size=500, index=False)
    rb, pb = rct.Table.from_pandas(dim, renv), pct.Table.from_pandas(dim,
                                                                     penv)
    sdim = dim.assign(k=dim.k.astype(str))
    rsb, psb = rct.Table.from_pandas(sdim, renv), \
        pct.Table.from_pandas(sdim, penv)
    sfact = [pct.Table.from_pandas(fact.assign(k=fact.k.astype(str)), penv)]
    rsfact = [rct.Table.from_pandas(fact.assign(k=fact.k.astype(str)), renv)]
    cases = [
        (lambda: r_scan_join(rio.scan_parquet_dist(p, renv, 1000), rb, "k",
                             "k", how="outer"),
         lambda: pct.pipelined_scan_join(pio.scan_parquet_dist(p, penv, 1000),
                                         pb, "k", "k", how="outer")),
        (lambda: r_scan_join(rsfact, rsb, "k", "k"),
         lambda: pct.pipelined_scan_join(sfact, psb, "k", "k")),
        (lambda: r_scan_join([], rb, "k", "k"),
         lambda: pct.pipelined_scan_join([], pb, "k", "k")),
    ]
    for fr, fp in cases:
        with pytest.raises(Exception) as re:
            fr()
        with pytest.raises(Exception) as pe:
            fp()
        assert type(pe.value).__name__ == type(re.value).__name__


def test_timing_and_logging():
    timing.reset()
    timing.enable("async")
    try:
        with timing.attribution_scope("q") as sc:
            with timing.region("a"):
                assert timing.last_region() == "a"
            with timing.sync_region("a"):
                pass
            timing.bump("e")
            timing.add_bytes("a", 10)
        assert set(sc.snapshot()) == {"a", "a.block", "e"}
        assert sc.counts()["e"] == 1 and sc.bytes() == {"a": 10}
        dispatch, block = timing.split_snapshot(timing.snapshot())
        assert set(dispatch) == {"a", "e"} and set(block) == {"a"}
        assert timing.byte_counts() == {"a": 10}
        timing.maybe_block(pct.Table.from_pydict(
            {"x": np.arange(3)}, pct.CylonEnv(device="cpu"))
            .column("x").data)
    finally:
        timing.enable(None)
        timing.reset()
    assert timing.last_region() == ""
    from cylon_tpu_torch.utils.logging import _GLOG_LEVELS, log
    before = log.level
    try:
        for glog, lv in _GLOG_LEVELS.items():
            pct.set_log_level(glog)
            assert log.level == lv
        pct.set_log_level("debug")
        assert log.level == logging.DEBUG
        with pytest.raises(TypeError):
            pct.set_log_level(True)
    finally:
        log.setLevel(before)


def test_without_pandas_and_pyarrow(tmp_path):
    """The package imports, a Series query and a scan join run, and every
    IO call names the missing package."""
    code = textwrap.dedent("""
        import sys
        sys.modules["pandas"] = None
        sys.modules["pyarrow"] = None
        import numpy as np
        import cylon_tpu_torch as ct
        env = ct.CylonEnv(ct.VirtualMeshConfig(4), device="cpu")
        rng = np.random.default_rng(0)
        k = rng.integers(0, 50, 400)
        df = ct.DataFrame({"k": k, "a": rng.random(400)}, env=env)
        m = (df["k"] > 10) & (df["a"] < 0.5)
        f = df[m]
        f["b"] = f["a"] * 2 + 1
        sel = (k > 10) & (df.to_pydict()["a"] < np.float64(0.5))
        assert f["k"].count() == int(sel.sum())
        assert f.set_index("k").loc[20:30].shape[1] == 2
        dim = ct.Table.from_pydict({"k": np.arange(50),
                                    "w": np.arange(50) * 3}, env)
        batches = [ct.Table.from_pydict({"k": k[i:i + 100]}, env)
                   for i in range(0, 400, 100)]
        sink = ct.GroupBySink("k", [("w", "sum")])
        ct.pipelined_scan_join(batches, dim, "k", "k", sink=sink)
        got = sink.finalize().to_pydict()
        assert int(got["w_sum"].sum()) == int((k * 3).sum())
        for call in (lambda: ct.io.read_csv("x.csv", env),
                     lambda: ct.io.read_parquet("x.parquet", env),
                     lambda: ct.io.write_csv(dim, "y.csv"),
                     lambda: dim.to_arrow(),
                     lambda: df.to_pandas()):
            try:
                call()
            except ct.CylonIOError as e:
                assert "pandas" in str(e) or "pyarrow" in str(e), e
            else:
                raise AssertionError("an IO call ran without its package")
        print("OK")
    """)
    (tmp_path / "x.csv").write_text("k\n1\n")
    (tmp_path / "x.parquet").write_text("")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")
