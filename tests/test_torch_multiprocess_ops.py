"""The two-hop topology route and the operators across processes: gloo
worlds on the CPU held against one process and against the reference.

This file is both the pytest module and the per-process driver (the
protocol of tests/test_torch_multiprocess.py, whose helpers it uses):

    python tests/test_torch_multiprocess_ops.py <pid> <nproc> <addr> <V> <out.npz> <legs>

Every world declares two slices (``CYLON_TPU_TORCH_SLICES=2``):

* 4 × 1 (R = 2, V = 1): ``topo`` and ``tpch`` (TPC-H Q3 and Q8 at
  SF 0.01 on the SPMD-ingested tables);
* 2 × 2 (R = 2, V = 2, one slice per process): ``topo``, ``ops`` (set
  operations, ``unique_table``, ``equals``, ``pipelined_set_op``, the
  ``Series``, ``loc``/``iloc``, partitioned reads and writes and
  ``pipelined_scan_join``) and ``probe`` (right and outer joins, the
  broadcast route, string keys with nulls, min/mean/nunique, a
  descending two-key sort, a 3-way join, the pipelined outer join and a
  ``DataFrame`` chain);
* 4 × 2 (R = 4, V = 2): ``topo``.

The ``topo`` leg runs a shuffle, join → groupby, the sample sort, a
repartition and a union on the two-hop route, records the voted plan
hash, the processes of each hop's subgroup and the bytes each hop moved,
and compares its cross-slice message counter with the flat route's.  The
parent holds every result table bit-equal, layout included, to the
port's ``VirtualMeshConfig(W)`` and (topology and set operations) to the
reference's ``CPUMeshConfig(W)``; TPC-H against the reference's pandas
oracles.  All worlds are launched together at first use, each under a
timeout that kills its processes.  At module level only torch, numpy
and the port are imported.
"""

import json
import os
import sys
import tempfile

import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
for _p in (_ROOT, _HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import cylon_tpu_torch as pct  # noqa: E402
import test_torch_multiprocess as mp  # noqa: E402

SLICES = "2"
TPCH_SCALE, TPCH_SEED = 0.01, 0
#: the worlds and their legs, launched together
WORLDS = {(4, 1): ("topo", "tpch"), (2, 2): ("topo", "ops", "probe"),
          (4, 2): ("topo",)}


def _api(w):
    """The port's operators (tests/test_torch_multiprocess.port_api) with
    the ones these legs add."""
    ns = mp.port_api(w)
    from cylon_tpu_torch.relational.repart import shuffle_table
    ns.shuffle_table = shuffle_table
    ns.unique_table = pct.unique_table
    ns.pipelined_set_op = pct.pipelined_set_op
    return ns


def _reference_api():
    ns = mp.reference_api()
    from cylon_tpu import exec as rexec
    from cylon_tpu.relational import repart, setops
    ns.shuffle_table = repart.shuffle_table
    ns.set_operation = setops.set_operation
    ns.unique_table = setops.unique_table
    ns.pipelined_set_op = rexec.pipelined_set_op
    return ns


def _keys(ct, env):
    """Two one-column tables of int64 keys for the set operations."""
    left, right = mp._inputs()
    return (ct.Table.from_pydict({"k": left["k"] % 97}, env),
            ct.Table.from_pydict({"k": right["k"] % 89}, env))


# ---------------------------------------------------------------------------
# the legs
# ---------------------------------------------------------------------------

TOPO_TABLES = ("topo_shuffle", "topo_groupby", "topo_sort", "topo_repart",
               "topo_union")


def topo_tables(ct, env, out):
    """The topology leg's results, on any env."""
    full = ct.full
    left, right = mp._inputs()
    lt = ct.Table.from_pydict(left, env)
    rt = ct.Table.from_pydict(right, env)
    _put = mp._put
    _put(out, "topo_shuffle", ct.shuffle_table(lt, ["k"]), full)
    g = ct.groupby_aggregate(ct.join_tables(lt, rt, "k", "k"), "k", mp.AGGS)
    _put(out, "topo_groupby", g, full)
    _put(out, "topo_sort", ct.sort_table(lt, ["a", "k"]), full)
    _put(out, "topo_repart", ct.repartition(ct.shuffle_table(lt, ["k"])),
         full)
    ka, kb = _keys(ct, env)
    _put(out, "topo_union", ct.set_operation(ka, kb, "union"), full)
    return lt


def leg_topo(ct, env, out):
    """The tables, then what the route did in this process: the voted
    plan, its hop groups, each hop's bytes, and one shuffle's cross-slice
    messages on both routes."""
    from cylon_tpu_torch import config as pconfig
    from cylon_tpu_torch.obs import metrics
    from cylon_tpu_torch.parallel import transport
    from cylon_tpu_torch.topo import model as tm
    transport.reset_stats()
    lt = topo_tables(ct, env, out)
    plan = tm.last_plan()
    out["topo|hash"] = np.asarray(
        [-1 if plan is None else plan.plan_hash() & 0x7FFFFFFFFFFFFFFF],
        np.int64)
    out["topo|summary"] = np.frombuffer(json.dumps(
        None if plan is None else plan.summary()).encode(), np.uint8)
    out["topo|hop_bytes"] = np.asarray(
        [transport.STATS["hop1_bytes"], transport.STATS["hop2_bytes"]],
        np.int64)
    g1, g2 = transport.current().groups[(plan.n_slices,
                                         plan.ranks_per_slice)]
    out["topo|hop1_members"] = np.asarray(g1.members, np.int64)
    out["topo|hop2_members"] = np.asarray(g2.members, np.int64)
    msgs = metrics.counter("exchange_dcn_messages_total")
    rows = metrics.counter("exchange_dcn_rows_total")
    seen = []
    for armed in (True, False):
        prev = pconfig.TOPO_SHUFFLE
        pconfig.TOPO_SHUFFLE = armed
        try:
            m0, r0 = msgs.value, rows.value
            got = ct.shuffle_table(lt, ["k"])
            seen.append((msgs.value - m0, rows.value - r0,
                         mp._rows(got).tobytes()))
        finally:
            pconfig.TOPO_SHUFFLE = prev
    out["topo|dcn_messages"] = np.asarray([s[0] for s in seen], np.int64)
    out["topo|dcn_rows"] = np.asarray([s[1] for s in seen], np.int64)
    out["topo|flat_same"] = np.asarray([seen[0][2] == seen[1][2]])


OPS_TABLES = ("ops_union", "ops_intersect", "ops_subtract",
              "ops_unique_first", "ops_unique_last", "ops_pipe_setop",
              "ops_filter", "ops_loc_labels", "ops_loc_range",
              "ops_iloc_slice", "ops_iloc_list", "ops_csv", "ops_parquet",
              "ops_scan_join")
#: the ops tables the reference also computes
OPS_REFERENCE = ("ops_union", "ops_intersect", "ops_subtract",
                 "ops_unique_first", "ops_unique_last", "ops_pipe_setop")


def ops_setops(ct, env, out):
    full = ct.full
    ka, kb = _keys(ct, env)
    for op in ("union", "intersect", "subtract"):
        mp._put(out, f"ops_{op}", ct.set_operation(ka, kb, op), full)
    left, _ = mp._inputs()
    lt = ct.Table.from_pydict(left, env)
    mp._put(out, "ops_unique_first", ct.unique_table(lt, ["k"]), full)
    mp._put(out, "ops_unique_last",
            ct.unique_table(lt, ["k"], keep="last"), full)
    mp._put(out, "ops_pipe_setop",
            ct.pipelined_set_op(ka, kb, "intersect", n_chunks=2), full)
    return lt, ka, kb


def leg_ops(ct, env, out):
    """Every operator that refused across processes before this route
    had a multi-process form."""
    from cylon_tpu_torch import io
    full = ct.full
    lt, ka, kb = ops_setops(ct, env, out)
    _, right = mp._inputs()
    rt = ct.Table.from_pydict(right, env)
    out["ops_equals|v"] = np.asarray([
        pct.equals(lt, lt), pct.equals(lt, ct.repartition(lt)),
        pct.equals(lt, ct.sort_table(lt, "a"), ordered=False),
        pct.equals(lt, ct.sort_table(lt, "a")), pct.equals(ka, kb)])
    df = pct.DataFrame(lt)
    s = df["a"]
    out["ops_series|red"] = np.asarray(
        [s.sum(), s.min(), s.max(), s.count(), s.mean(), len(s)],
        np.float64)
    mp._put(out, "ops_filter", df[(s > 500) & (df["k"] < 400)].table, full)
    ix = df.set_index("k")
    mp._put(out, "ops_loc_labels", ix.loc[[7, 123, 499]].table, full)
    mp._put(out, "ops_loc_range", ix.loc[10:20].table, full)
    mp._put(out, "ops_iloc_slice", df.iloc[5:1234].table, full)
    mp._put(out, "ops_iloc_list", df.iloc[[2999, 3, 7, 3, 1500]].table,
            full)
    # partitioned writes (each process its own ranks' files), then the
    # reads of every file by every process
    root = os.environ.get("TORCH_MP_IO_DIR") or tempfile.mkdtemp()
    csvs = io.write_csv_dist(lt, os.path.join(root, "t.csv"))
    pqs = io.write_parquet_dist(rt, os.path.join(root, "t.parquet"))
    w = env.world_size
    out["ops_io|written"] = np.asarray(
        sorted(int(p.rsplit("_", 1)[1].split(".")[0]) for p in csvs + pqs),
        np.int64)
    env.barrier()
    every = [os.path.join(root, f"t_{r}.csv") for r in range(w)]
    mp._put(out, "ops_csv", io.read_csv_dist(every, env), full)
    pq = [os.path.join(root, f"t_{r}.parquet") for r in range(w)]
    mp._put(out, "ops_parquet", io.read_parquet_dist(pq, env), full)
    sink = ct.GroupBySink("k", [("b", "sum")])
    pct.pipelined_scan_join(io.scan_parquet_dist(pq, env, batch_rows=800),
                            lt, "k", "k", sink=sink)
    mp._put(out, "ops_scan_join", sink.finalize(), full)
    env.barrier()


PROBE_TABLES = ("probe_right", "probe_outer", "probe_bcast_inner",
                "probe_bcast_left", "probe_str_join", "probe_str_groupby",
                "probe_aggs", "probe_sort_desc", "probe_join3",
                "probe_pipe_outer", "probe_frame")


def leg_probe(ct, env, out):
    """What worked across processes without a test of its own."""
    full = ct.full
    left, right = mp._inputs()
    lt = ct.Table.from_pydict(left, env)
    rt = ct.Table.from_pydict(right, env)
    put = mp._put
    put(out, "probe_right", ct.join_tables(lt, rt, "k", "k", how="right"),
        full)
    put(out, "probe_outer", ct.join_tables(lt, rt, "k", "k", how="outer"),
        full)
    small = ct.Table.from_pydict(
        {"k": np.arange(0, 400, 2, dtype=np.int64),
         "c": np.arange(200, dtype=np.int64) * 3}, env)
    put(out, "probe_bcast_inner", ct.join_tables(lt, small, "k", "k"), full)
    put(out, "probe_bcast_left",
        ct.join_tables(lt, small, "k", "k", how="left"), full)
    rng = np.random.default_rng(41)
    names = np.asarray([f"s{i:03d}" for i in range(60)], dtype=object)
    sa = names[rng.integers(0, 60, 2000)]
    sa[rng.random(2000) < 0.1] = None
    sb = names[rng.integers(0, 60, 1500)]
    sb[rng.random(1500) < 0.1] = None
    st = ct.Table.from_pydict({"s": sa, "a": rng.integers(0, 99, 2000)},
                              env)
    sr = ct.Table.from_pydict({"s": sb, "b": rng.integers(0, 99, 1500)},
                              env)
    put(out, "probe_str_join", ct.join_tables(st, sr, "s", "s"), full)
    put(out, "probe_str_groupby",
        ct.groupby_aggregate(st, "s", [("a", "sum"), ("a", "count")]), full)
    put(out, "probe_aggs", ct.groupby_aggregate(
        lt, "k", [("a", "min"), ("a", "mean"), ("a", "nunique")]), full)
    put(out, "probe_sort_desc",
        ct.sort_table(st, ["s", "a"], ascending=False), full)
    t3 = ct.Table.from_pydict({"k": np.arange(500, dtype=np.int64),
                               "c": np.arange(500, dtype=np.int64)}, env)
    put(out, "probe_join3",
        pct.join_tables_multi([lt, rt, t3], ["k"] * 3), full)
    put(out, "probe_pipe_outer", ct.pipelined_join(
        lt, rt, "k", "k", how="outer", n_chunks=2), full)
    df = pct.DataFrame(lt).merge(pct.DataFrame(rt), on="k")
    put(out, "probe_frame", df.groupby("k")[["a", "b"]].sum().table, full)


def leg_tpch(ct, env, out):
    """TPC-H Q3 and Q8 on the SPMD-ingested tables."""
    from cylon_tpu_torch import tpch
    dfs = tpch.generate_tables(TPCH_SCALE, env, seed=TPCH_SEED)
    for q in ("q3", "q8"):
        res = getattr(tpch, q)(dfs, env=env)
        mp._put(out, f"tpch_{q}", res.table, ct.full)
        out[f"frame|{q}"] = res


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _driver(argv) -> None:
    pid, nproc, addr, v, path = (int(argv[0]), int(argv[1]), argv[2],
                                 int(argv[3]), argv[4])
    legs = argv[5].split(",")
    env = pct.CylonEnv(pct.DistributedConfig(addr, pid, nproc,
                                             local_world=v, timeout_s=120),
                       device="cpu")
    assert env.topology.n_slices == 2
    ct = _api(env.world_size)
    out = {}
    for name in legs:
        env.barrier()
        globals()["leg_" + name](ct, env, out)
    np.savez(path, **{k: x for k, x in out.items()
                      if not k.startswith("frame|")})
    env.finalize()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

_CACHE = {}


#: what the parent computes while the worlds run
EXPECTED = (("virtual", 4, "topo"), ("virtual", 8, "topo"),
            ("virtual", 4, "ops"), ("virtual", 4, "probe"),
            ("virtual", 4, "tpch"), ("reference", 4, "topo"),
            ("reference", 8, "topo"), ("reference", 4, "ops"))


def _world(tmp_path_factory, nproc, v):
    if "launched" not in _CACHE:
        launched = {}
        for key, legs in WORLDS.items():
            tmp = tmp_path_factory.mktemp(f"mpo{key[0]}{key[1]}")
            launched[key] = _start(tmp, key[0], key[1], list(legs))
        _CACHE["launched"] = launched
        try:
            for kind, w, part in EXPECTED:
                (_virtual if kind == "virtual" else _reference)(w, part)
        except BaseException:
            for procs, _paths, _dl in launched.values():
                for p in procs:
                    p.kill()
            raise
    key = (nproc, v)
    if key not in _CACHE:
        _CACHE[key] = mp.finish(_CACHE["launched"][key])
    codes, outs, res = _CACHE[key]
    mp._assert_ok(codes, outs)
    return res


def _start(tmp, nproc, v, legs):
    """Launch ``nproc`` driver processes of this file (not waited on)."""
    import subprocess
    import time
    addr = f"127.0.0.1:{mp._free_port()}"
    env = dict(os.environ)
    env.pop("CYLON_TPU_TORCH_FAULTS", None)
    env["CYLON_TPU_TORCH_SLICES"] = SLICES
    env["TORCH_MP_IO_DIR"] = str(tmp)
    paths = [os.path.join(str(tmp), f"p{nproc}v{v}_{i}.npz")
             for i in range(nproc)]
    cmd = [sys.executable, os.path.abspath(__file__)]
    procs = [subprocess.Popen(
        cmd + [str(i), str(nproc), addr, str(v), paths[i], ",".join(legs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=_ROOT) for i in range(nproc)]
    return procs, paths, time.monotonic() + mp.SPAWN_TIMEOUT_S


def _virtual(w, part):
    """One process's ``VirtualMeshConfig(w)`` run of a leg's tables."""
    key = ("virtual", w, part)
    if key not in _CACHE:
        env = pct.CylonEnv(pct.VirtualMeshConfig(w), device="cpu")
        out = {}
        fn = {"topo": topo_tables, "ops": leg_ops, "probe": leg_probe,
              "tpch": leg_tpch}[part]
        with tempfile.TemporaryDirectory() as d:
            prev = os.environ.get("TORCH_MP_IO_DIR")
            os.environ["TORCH_MP_IO_DIR"] = d
            try:
                fn(_api(w), env, out)
            finally:
                if prev is None:
                    del os.environ["TORCH_MP_IO_DIR"]
                else:
                    os.environ["TORCH_MP_IO_DIR"] = prev
        _CACHE[key] = out
    return _CACHE[key]


def _reference(w, part):
    """The reference's ``CPUMeshConfig(w)`` run of a leg's tables."""
    key = ("reference", w, part)
    if key not in _CACHE:
        import cylon_tpu as rct
        from cylon_tpu.ctx.context import CPUMeshConfig
        env = rct.CylonEnv(config=CPUMeshConfig(world_size=w))
        out = {}
        if part == "topo":
            topo_tables(_reference_api(), env, out)
        else:
            ops_setops(_reference_api(), env, out)
        _CACHE[key] = out
    return _CACHE[key]


TOPO_WORLDS = [(4, 1), (2, 2), (4, 2)]


@pytest.mark.parametrize("nproc,v", TOPO_WORLDS)
def test_topo_matches_one_process(tmp_path_factory, nproc, v):
    """The two-hop route's results on every process, bit-equal, layout
    included, to the port's one-process world of the same size."""
    res = _world(tmp_path_factory, nproc, v)
    want = _virtual(nproc * v, "topo")
    for r in res:
        mp._assert_same(r, want, TOPO_TABLES)


@pytest.mark.parametrize("nproc,v", TOPO_WORLDS)
def test_topo_matches_reference(tmp_path_factory, nproc, v):
    res = _world(tmp_path_factory, nproc, v)
    want = _reference(nproc * v, "topo")
    for r in res:
        mp._assert_same(r, want, TOPO_TABLES)


@pytest.mark.parametrize("nproc,v", TOPO_WORLDS)
def test_topo_plan_and_hops(tmp_path_factory, nproc, v):
    """One voted plan on every process, equal to the reference's for the
    same world; each hop on its subgroup; two-hop cross-slice messages
    1/R of the flat route's over the same cross-slice rows."""
    from cylon_tpu.topo import model as rtm
    res = _world(tmp_path_factory, nproc, v)
    w = nproc * v
    r_ = w // 2
    want = rtm.TopologyPlan(rtm.Topology(w, 2, "env"), "hierarchical")
    hashes = {int(r["topo|hash"][0]) for r in res}
    assert hashes == {want.plan_hash() & 0x7FFFFFFFFFFFFFFF}
    per = r_ // v                       # processes per slice
    for pid, r in enumerate(res):
        summary = json.loads(bytes(r["topo|summary"]))
        assert summary == {**want.summary(), "source": "env"}
        h1, h2 = r["topo|hop1_members"].tolist(), \
            r["topo|hop2_members"].tolist()
        s = pid // per
        assert h1 == list(range(s * per, (s + 1) * per))
        assert h2 == list(range(pid % per, nproc, per))
        hop1, hop2 = r["topo|hop_bytes"].tolist()
        assert hop2 > 0
        if per == 1:                    # one slice per process
            assert hop1 == 0
        else:
            assert hop1 > 0
        two_hop, flat = r["topo|dcn_messages"].tolist()
        assert two_hop > 0 and two_hop * r_ == flat
        d_two, d_flat = r["topo|dcn_rows"].tolist()
        assert d_two == d_flat > 0
        assert bool(r["topo|flat_same"][0])


@pytest.mark.parametrize("name", OPS_TABLES)
def test_ops_matches_one_process(tmp_path_factory, name):
    res = _world(tmp_path_factory, 2, 2)
    want = _virtual(4, "ops")
    for r in res:
        mp._assert_same(r, want, (name,))


@pytest.mark.parametrize("name", OPS_REFERENCE)
def test_ops_matches_reference(tmp_path_factory, name):
    res = _world(tmp_path_factory, 2, 2)
    want = _reference(4, "ops")
    for r in res:
        mp._assert_same(r, want, (name,))


def test_ops_answers(tmp_path_factory):
    """``equals`` and the Series reductions agree on every process with
    one process; each process wrote its own ranks' files."""
    res = _world(tmp_path_factory, 2, 2)
    want = _virtual(4, "ops")
    assert want["ops_equals|v"].tolist() == [True, True, True, False, False]
    for pid, r in enumerate(res):
        np.testing.assert_array_equal(r["ops_equals|v"],
                                      want["ops_equals|v"])
        np.testing.assert_array_equal(r["ops_series|red"],
                                      want["ops_series|red"])
        assert r["ops_io|written"].tolist() == \
            sorted([2 * pid, 2 * pid + 1] * 2)


@pytest.mark.parametrize("name", PROBE_TABLES)
def test_probe_matches_one_process(tmp_path_factory, name):
    res = _world(tmp_path_factory, 2, 2)
    want = _virtual(4, "probe")
    for r in res:
        mp._assert_same(r, want, (name,))


@pytest.mark.parametrize("q", ["q3", "q8"])
def test_tpch_matches_oracle(tmp_path_factory, q):
    """Q3 and Q8 on a 2-slice 4 × 1 world: every process's result equals
    the one-process world's, layout included, and the reference's pandas
    oracle on the same tables (tests/test_torch_tpch.py's tolerance)."""
    import pandas as pd
    from cylon_tpu import tpch as rtpch
    res = _world(tmp_path_factory, 4, 1)
    want = _virtual(4, "tpch")
    exp = getattr(rtpch, f"{q}_pandas")(rtpch.generate_pandas(
        scale=TPCH_SCALE, seed=TPCH_SEED))
    for r in res:
        mp._assert_same(r, want, (f"tpch_{q}",))
    got = want[f"frame|{q}"].to_pandas().reset_index(drop=True)
    assert len(got) == len(exp) > 0
    pd.testing.assert_frame_equal(got, exp[got.columns].reset_index(
        drop=True), check_dtype=False, check_exact=False, rtol=1e-9)


def teardown_module():
    if "jax" in sys.modules:
        sys.modules["jax"].clear_caches()


if __name__ == "__main__":
    _driver(sys.argv[1:])
