"""Parity of the integrity audit tier (``cylon_tpu_torch.exec.integrity``)
with ``cylon_tpu.exec.integrity`` on the CPU, after tests/test_integrity.py:
the port's 64-bit content fingerprint bit-equal to the reference's for the
same table at W = 1, 3, 4 and 8 (int, float with -0.0 and NaN, bool,
validity, decimal, hashed-string and list columns) and invariant to order,
placement and world; the conservation laws raising the reference's typed
error with its site, phase and message; the armed operators bit-equal to
the unarmed ones with the reference's audit counts; the
``Code.IntegrityFault`` rung (a one-shot ``exchange.corrupt`` recomputed,
a persistent one aborting typed, an ``audit.verify`` stall as
``RankDesyncError``); and the checkpoint manifests' fingerprints, equal to
the reference's, a tampered one recomputed and never adopted.

Both packages run on ``CPUMeshConfig``/``VirtualMeshConfig`` worlds with
their ``BROADCAST_JOIN_ROWS`` set alike, so every join takes the same
exchanges."""

import glob
import json
import os
from decimal import Decimal

import jax
import numpy as np
import pandas as pd
import pytest

import cylon_tpu as rct
from cylon_tpu import config as rconfig
from cylon_tpu.ctx.context import CPUMeshConfig
from cylon_tpu.exec import checkpoint as rckpt
from cylon_tpu.exec import integrity as ri
from cylon_tpu.exec import recovery as rrec
from cylon_tpu.obs import metrics as rmetrics
from cylon_tpu.exec import pipelined_join as r_pipelined_join
from cylon_tpu.relational import join as rjoin
from cylon_tpu.relational import join_tables as r_join
from cylon_tpu.relational.setops import set_operation as r_setop
import cylon_tpu_torch as pct
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch.ctx.context import VirtualMeshConfig
from cylon_tpu_torch.exec import checkpoint as pckpt
from cylon_tpu_torch.exec import integrity as pi
from cylon_tpu_torch.exec import recovery as prec
from cylon_tpu_torch.obs import metrics as pmetrics
from cylon_tpu_torch.status import (Code, DataIntegrityError,
                                    RankDesyncError)

AUDIT_KEYS = ("conservation_checks", "fingerprint_checks",
              "fingerprint_votes", "violations", "manifest_fps",
              "manifest_audits", "corruptions_injected")


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Both injectors disarmed, both event logs empty, the same join
    routes, both packages' audits unarmed unless a test arms them."""
    monkeypatch.setattr(rconfig, "BROADCAST_JOIN_ROWS", 0)
    monkeypatch.setattr(pconfig, "BROADCAST_JOIN_ROWS", 0)
    for mod in (rrec, prec):
        mod.install_faults("")
        mod.reset_events()
    rjoin._CAP_CACHE.clear()
    yield
    for mod in (rrec, prec):
        mod.install_faults("")
        mod.reset_events()
    os.environ.pop("CYLON_TPU_AUDIT", None)
    os.environ.pop("CYLON_TPU_TORCH_AUDIT", None)
    ri.rearm()
    pi.rearm()


def _arm(on: bool = True) -> None:
    for var in ("CYLON_TPU_AUDIT", "CYLON_TPU_TORCH_AUDIT"):
        os.environ[var] = "1" if on else "0"
    ri.rearm()
    pi.rearm()


@pytest.fixture()
def armed():
    _arm()
    yield


def _envs(w, env1, env4, env8):
    renv = {1: env1, 4: env4, 8: env8}.get(w) or rct.CylonEnv(
        config=CPUMeshConfig(world_size=w))
    return renv, pct.CylonEnv(VirtualMeshConfig(w), device="cpu")


def _frames(n=1200, card=120, seed=0):
    rng = np.random.default_rng(seed)
    ldf = pd.DataFrame({"k": rng.integers(0, card, n).astype(np.int64),
                        "a": rng.integers(0, 50, n).astype(np.int64)})
    rdf = pd.DataFrame({"k": rng.integers(0, card, n).astype(np.int64),
                        "b": rng.random(n)})
    return ldf, rdf


def _pair(df, renv, penv):
    return rct.Table.from_pandas(df, renv), pct.Table.from_pandas(df, penv)


def _rows(t, cols):
    return t.to_pandas().sort_values(cols).reset_index(drop=True)


def _delta(mod, before):
    now = mod.stats()
    return {k: now[k] - before[k] for k in AUDIT_KEYS}


# ---------------------------------------------------------------------------
# the fingerprint
# ---------------------------------------------------------------------------

def _wide_frame(n=700, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.random(n)
    x[5] = -0.0
    x[9] = np.nan
    q = Decimal("0.01")
    return pd.DataFrame({
        "k": rng.integers(-40, 40, n).astype(np.int64),
        "i": rng.integers(-5, 5, n).astype(np.int32),
        "x": x,
        "f": rng.random(n).astype(np.float32),
        "b": rng.random(n) < 0.5,
        "v": pd.array(np.where(rng.random(n) < 0.2, None,
                               rng.integers(0, 9, n)), dtype="Int64"),
        "m": np.asarray([Decimal(str(round(float(t), 2))).quantize(q)
                         for t in rng.random(n) * 100], dtype=object),
        "s": np.asarray([f"name{int(t):05d}" for t in
                         rng.integers(0, 3000, n)], dtype=object),
        "ls": [[int(t), int(t) * 2] for t in range(n)]})


@pytest.fixture()
def hashed_strings(monkeypatch):
    for cfg in (rconfig, pconfig):
        monkeypatch.setattr(cfg, "STRING_HASH_MIN_ROWS", 100)
        monkeypatch.setattr(cfg, "STRING_HASH_RATIO", 0.2)


@pytest.mark.parametrize("w", [1, 3, 4, 8])
def test_fingerprint_equals_reference(w, env1, env4, env8, hashed_strings):
    renv, penv = _envs(w, env1, env4, env8)
    rt, pt = _pair(_wide_frame(), renv, penv)
    assert type(pt.column("s").dictionary).__name__ == "HashedStrings"
    assert pt.column("v").validity is not None
    fp = pi.table_fingerprint(pt)
    assert isinstance(fp, int) and 0 <= fp < 1 << 64
    assert fp == ri.table_fingerprint(rt)


def test_order_placement_and_world_invariant(env4, env8):
    df = _wide_frame(seed=4).drop(columns=["ls"])
    fps = set()
    for w, frame in ((4, df), (4, df.sample(frac=1.0, random_state=3)),
                     (8, df), (3, df.iloc[::-1])):
        penv = pct.CylonEnv(VirtualMeshConfig(w), device="cpu")
        fps.add(pi.table_fingerprint(
            pct.Table.from_pandas(frame.reset_index(drop=True), penv)))
    assert len(fps) == 1
    assert fps == {ri.table_fingerprint(rct.Table.from_pandas(df, env8))}


@pytest.mark.parametrize("change", ["int", "mantissa", "neg_zero",
                                    "validity"])
def test_content_and_validity_sensitive(change, env4):
    df = _wide_frame(seed=5).drop(columns=["ls", "s", "m"])
    penv = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    fp0 = pi.table_fingerprint(pct.Table.from_pandas(df, penv))
    bumped = df.copy()
    if change == "int":
        bumped.loc[1, "k"] += 1
    elif change == "mantissa":
        bumped.loc[2, "x"] += 1e-12
    elif change == "neg_zero":
        bumped.loc[5, "x"] = 0.0          # was -0.0: only the sign bit
    else:
        i = int(np.flatnonzero(bumped["v"].notna().to_numpy())[0])
        bumped.loc[i, "v"] = None
    fp1 = pi.table_fingerprint(pct.Table.from_pandas(bumped, penv))
    assert fp1 != fp0
    assert fp1 == ri.table_fingerprint(rct.Table.from_pandas(bumped, env4))


# ---------------------------------------------------------------------------
# the conservation laws
# ---------------------------------------------------------------------------

def _both_raise(fn):
    """Run ``fn(pkg_integrity)`` in both packages: the same error class
    name, code, site, phase and message."""
    errs = []
    for mod in (ri, pi):
        with pytest.raises(Exception) as ei:
            fn(mod)
        errs.append(ei.value)
    r, p = errs
    assert type(p).__name__ == type(r).__name__ == "DataIntegrityError"
    assert (int(p.code), p.site, p.phase, str(p)) == \
        (int(r.code), r.site, r.phase, str(r))
    return p


_C = np.array([[1, 2], [3, 4]], np.int64)


@pytest.mark.parametrize("case", ["shape", "negative", "delivery", "total"])
def test_bad_sidecar_raises_reference_error(case):
    counts, per_dest, total = _C, _C.sum(axis=0), 10
    if case == "shape":
        counts = np.ones((2, 3), np.int64)
    elif case == "negative":
        counts = np.array([[1, -2], [3, 4]], np.int64)
        per_dest, total = counts.sum(axis=0), 6
    elif case == "delivery":
        per_dest = np.array([4, 7])
    else:
        total = 11
    before = pi.stats()["violations"]
    e = _both_raise(lambda m: m.conserve_exchange(
        counts, per_dest, total, 8, site="shuffle.recv"))
    assert e.code == Code.IntegrityFault
    assert pi.stats()["violations"] == before + 1


def _good(mod, metrics):
    metrics.counter("exchange_rows_total").inc(10)
    metrics.counter("exchange_bytes_total").inc(80)
    mod.conserve_exchange(_C, _C.sum(axis=0), 10, 8)


def test_counter_running_ahead_then_resync():
    for mod, metrics in ((ri, rmetrics), (pi, pmetrics)):
        # the message carries the counters' values: start both at zero
        metrics.reset("exchange_rows_total")
        metrics.reset("exchange_bytes_total")
        mod.reset_stats()
        _good(mod, metrics)
        metrics.counter("exchange_rows_total").inc(999)
    try:
        _both_raise(lambda m: _good(m, rmetrics if m is ri else pmetrics))
    finally:
        ri.reset_stats()
        pi.reset_stats()
    for mod, metrics in ((ri, rmetrics), (pi, pmetrics)):
        _good(mod, metrics)          # re-seeded: green again
        metrics.reset("exchange_rows_total")
        metrics.reset("exchange_bytes_total")
        before = mod.stats()["reconcile_resyncs"]
        _good(mod, metrics)          # a registry reset resyncs
        assert mod.stats()["reconcile_resyncs"] == before + 1


def test_route_that_raises_leaves_counters_in_step(monkeypatch):
    """An exchange whose route raises (here a device OOM inside the
    engine, once) counts nothing, so the next exchanges of the process
    reconcile: the join the ladder retries and a second join are both
    right, with no violation."""
    from cylon_tpu_torch.parallel import shuffle as pshuffle
    from cylon_tpu_torch.status import DeviceOOMError
    ldf, rdf = _frames(n=600, seed=6)
    penv = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    pl = pct.Table.from_pandas(ldf, penv)
    pr = pct.Table.from_pandas(rdf, penv)
    cols = ["k", "a", "b"]
    want = ldf.merge(rdf, on="k").sort_values(cols).reset_index(drop=True)
    move, calls = pshuffle._move, []

    def oom_once(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise DeviceOOMError("CUDA out of memory (injected)")
        return move(*a, **kw)

    monkeypatch.setattr(pshuffle, "_move", oom_once)
    before = pi.stats()["violations"]
    for _ in range(2):
        got = _rows(pct.join_tables(pl, pr, "k", "k", how="inner"), cols)
        pd.testing.assert_frame_equal(got, want, check_dtype=False)
    assert len(calls) > 1
    assert pi.stats()["violations"] == before


@pytest.mark.parametrize("case", ["c1", "c2", "gateway", "negative"])
def test_hop_identities(case):
    c1 = np.diag(_C.sum(axis=1))
    c2 = _C
    for mod in (ri, pi):
        mod.conserve_hops(_C, c1, c2)
    if case == "c1":
        c1 = 2 * c1
    elif case == "c2":
        c2 = np.zeros_like(_C)
    elif case == "gateway":
        c2 = np.array([[2, 2], [2, 4]], np.int64)
    else:
        c1 = -c1
    e = _both_raise(lambda m: m.conserve_hops(_C, c1, c2))
    assert e.site == "topo.exchange"


# ---------------------------------------------------------------------------
# armed operators: bit-equal to unarmed, the reference's audit counts
# ---------------------------------------------------------------------------

def _counted(fn_r, fn_p):
    """Run the same query in both packages; returns the port's result and
    both packages' audit-counter deltas."""
    r0, p0 = ri.stats(), pi.stats()
    out_r = fn_r()
    dr = _delta(ri, r0)
    out_p = fn_p()
    dp = _delta(pi, p0)
    return out_r, out_p, dr, dp


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer", "semi",
                                 "anti"])
def test_armed_joins(how, env4):
    ldf, rdf = _frames(seed=1)
    penv = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    (rl, pl), (rr, pr) = _pair(ldf, env4, penv), _pair(rdf, env4, penv)
    cols = ["k", "a"] if how in ("semi", "anti") else ["k", "a", "b"]
    base = _rows(pct.join_tables(pl, pr, "k", "k", how=how), cols)
    _arm()
    out_r, out_p, dr, dp = _counted(
        lambda: _rows(r_join(rl, rr, "k", "k", how=how), cols),
        lambda: _rows(pct.join_tables(pl, pr, "k", "k", how=how), cols))
    pd.testing.assert_frame_equal(out_p, base)
    pd.testing.assert_frame_equal(out_p, out_r, check_dtype=False)
    assert dp["fingerprint_checks"] > 0 and dp["violations"] == 0
    assert dp == dr


def test_armed_set_op_and_pipelined_join(env4):
    ldf, rdf = _frames(n=800, seed=2)
    penv = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    (rl, pl), (rr, pr) = _pair(ldf, env4, penv), _pair(rdf, env4, penv)
    base_u = _rows(pct.set_operation(pl.project(["k"]), pr.project(["k"]),
                                     "union"), ["k"])
    base_j = _rows(pct.pipelined_join(pl, pr, "k", "k", how="inner",
                                      n_chunks=3), ["k", "a", "b"])
    _arm()
    _, got, dr, dp = _counted(
        lambda: r_setop(rl.project(["k"]), rr.project(["k"]),
                                  "union"),
        lambda: _rows(pct.set_operation(pl.project(["k"]),
                                        pr.project(["k"]), "union"), ["k"]))
    pd.testing.assert_frame_equal(got, base_u)
    assert dp == dr and dp["fingerprint_checks"] > 0
    _, got, dr, dp = _counted(
        lambda: r_pipelined_join(rl, rr, "k", "k", how="inner",
                                        n_chunks=3),
        lambda: _rows(pct.pipelined_join(pl, pr, "k", "k", how="inner",
                                         n_chunks=3), ["k", "a", "b"]))
    pd.testing.assert_frame_equal(got, base_j)
    assert dp == dr and dp["fingerprint_checks"] > 0


def test_armed_skew_stitch(env4):
    """The adaptive skew split's stitched output is audited
    (``skew.stitch``) and equals the unarmed result."""
    rng = np.random.default_rng(6)
    n = 4000
    probe = np.where(rng.random(n) < 0.7, 7, rng.integers(0, 300, n))
    ldf = pd.DataFrame({"k": probe.astype(np.int64),
                        "a": rng.integers(0, 9, n).astype(np.int64)})
    rdf = pd.DataFrame({"k": np.arange(300, dtype=np.int64),
                        "b": np.arange(300, dtype=np.int64)})
    penv = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    (rl, pl), (rr, pr) = _pair(ldf, env4, penv), _pair(rdf, env4, penv)
    base = pct.join_tables(pl, pr, "k", "k", how="inner").to_pandas()
    _arm()
    out_r, out_p, dr, dp = _counted(
        lambda: r_join(rl, rr, "k", "k", how="inner").to_pandas(),
        lambda: pct.join_tables(pl, pr, "k", "k", how="inner").to_pandas())
    from cylon_tpu_torch.relational import skew
    assert skew.last_plan() is not None
    pd.testing.assert_frame_equal(out_p, base)
    pd.testing.assert_frame_equal(out_p, out_r, check_dtype=False)
    assert dp == dr and dp["fingerprint_checks"] > 0


def test_armed_stream_absorb(env4):
    rng = np.random.default_rng(5)
    penv = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    batches = [{"k": rng.integers(0, 16, 400).astype(np.int64),
                "v": rng.integers(0, 9, 400).astype(np.int64)}
               for _ in range(2)]
    _arm()
    reads = []
    deltas = []
    import cylon_tpu.stream as rstream
    for stream, env, mod in ((rstream, env4, ri), (pct.stream, penv, pi)):
        st = stream.StreamTable(env, key="k", name="t_audit")
        view = stream.IncrementalView(st, "k", [("v", "sum")], env=env)
        before = mod.stats()
        for b in batches:
            st.append(dict(b))
        deltas.append(_delta(mod, before))
        reads.append(_rows(view.read(), ["k"]))
    assert deltas[1] == deltas[0] and deltas[1]["fingerprint_checks"] >= 2
    pd.testing.assert_frame_equal(reads[1], reads[0], check_dtype=False)


def test_unarmed_zero_fingerprint_work(env4, monkeypatch):
    ldf, rdf = _frames(seed=3)
    penv = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    pl, pr = (pct.Table.from_pandas(d, penv) for d in (ldf, rdf))

    def boom(*a, **k):
        raise AssertionError("fingerprint work while unarmed")

    monkeypatch.setattr(pi, "_local_pair", boom)
    p0 = pi.stats()
    pct.join_tables(pl, pr, "k", "k", how="inner").to_pandas()
    d = _delta(pi, p0)
    assert d["fingerprint_checks"] == d["fingerprint_votes"] == 0
    assert d["conservation_checks"] > 0


# ---------------------------------------------------------------------------
# the IntegrityFault rung
# ---------------------------------------------------------------------------

def _integrity_events(mod):
    return [e["action"] for e in mod.recovery_events()
            if e["kind"] == "integrity"]


@pytest.mark.parametrize("spec", ["exchange.corrupt=corrupt",
                                  "exchange.corrupt::*=corrupt"])
def test_corrupt_drill(spec, env4, armed):
    ldf, rdf = _frames(seed=4)
    penv = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    (rl, pl), (rr, pr) = _pair(ldf, env4, penv), _pair(rdf, env4, penv)
    cols = ["k", "a", "b"]
    base = _rows(pct.join_tables(pl, pr, "k", "k", how="inner"), cols)
    outcomes = []
    for join, lt, rt, mod in ((r_join, rl, rr, rrec),
                              (pct.join_tables, pl, pr, prec)):
        mod.install_faults(spec)
        try:
            got = _rows(join(lt, rt, "k", "k", how="inner"), cols)
            outcomes.append(("ok", got, _integrity_events(mod)))
        except Exception as e:  # noqa: BLE001 — compared across packages
            outcomes.append((type(e).__name__, (e.site, e.phase),
                             _integrity_events(mod)))
        mod.install_faults("")
    (rk, rv, rev), (pk, pv, pev) = outcomes
    assert pk == rk and pev == rev
    if "*" in spec:
        assert pk == "DataIntegrityError"
        assert pv == rv == ("shuffle.recv", "post_exchange")
        assert pev.count("abort") == 1
        assert sum(a.startswith("retry") for a in pev) == 1
    else:
        assert pk == "ok" and len(pev) == 1 and pev[0].startswith("retry")
        pd.testing.assert_frame_equal(pv, base)


def test_two_hop_route_audited(monkeypatch):
    """On the two-hop route (2 slices of 4 ranks) the exchange's checks
    run after the second hop: armed bit-equal to unarmed, the hop
    identities counted, a one-shot corruption recomputed."""
    from cylon_tpu_torch.topo import model as ptm
    monkeypatch.setenv("CYLON_TPU_TORCH_SLICES", "2")
    ptm._reslice()
    try:
        ldf, rdf = _frames(n=800, seed=8)
        penv = pct.CylonEnv(VirtualMeshConfig(8), device="cpu")
        pl, pr = (pct.Table.from_pandas(d, penv) for d in (ldf, rdf))
        cols = ["k", "a", "b"]
        base = _rows(pct.join_tables(pl, pr, "k", "k", how="left"), cols)
        _arm()
        before = pi.stats()
        got = _rows(pct.join_tables(pl, pr, "k", "k", how="left"), cols)
        d = _delta(pi, before)
        assert ptm.last_plan().route == "hierarchical"
        pd.testing.assert_frame_equal(got, base)
        # two exchanges: each its own laws and its two hops' identities
        assert d["conservation_checks"] == 4 and d["violations"] == 0
        assert d["fingerprint_checks"] == d["fingerprint_votes"] == 2
        prec.install_faults("exchange.corrupt=corrupt")
        got = _rows(pct.join_tables(pl, pr, "k", "k", how="left"), cols)
        pd.testing.assert_frame_equal(got, base)
        assert _integrity_events(prec) == ["retry_chunks_4"]
    finally:
        monkeypatch.delenv("CYLON_TPU_TORCH_SLICES")
        ptm._reslice()


def test_audit_verify_stall_surfaces_typed(armed, monkeypatch):
    ldf, rdf = _frames(n=600, seed=5)
    penv = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    pl, pr = (pct.Table.from_pandas(d, penv) for d in (ldf, rdf))
    monkeypatch.setattr(pconfig, "EXCHANGE_WATCHDOG_S", 0.2)
    prec.install_faults("audit.verify=stall")
    with pytest.raises(RankDesyncError) as ei:
        pct.join_tables(pl, pr, "k", "k", how="inner").to_pandas()
    assert ei.value.site == "audit.verify"


# ---------------------------------------------------------------------------
# checkpoint manifests
# ---------------------------------------------------------------------------

@pytest.fixture()
def ckpt_dirs(tmp_path, monkeypatch):
    monkeypatch.setenv("CYLON_TPU_CKPT_DIR", str(tmp_path / "r"))
    monkeypatch.setenv("CYLON_TPU_TORCH_CKPT_DIR", str(tmp_path / "p"))
    monkeypatch.delenv("CYLON_TPU_RESUME", raising=False)
    monkeypatch.delenv("CYLON_TPU_TORCH_RESUME", raising=False)
    for mod in (rckpt, pckpt):
        mod.reset_stages()
        mod.reset_stats()
    yield tmp_path
    for mod in (rckpt, pckpt):
        mod.reset_stages()
        mod.reset_stats()


def test_manifest_fp_equals_reference_and_audits(env4, ckpt_dirs):
    ldf, _ = _frames(n=800, seed=6)
    penv = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    rl, pl = _pair(ldf, env4, penv)
    stage = pckpt.open_stage(penv, "unit_nofp", "tok")
    stage.save_piece(0, pl)
    assert stage.committed[0]["fp"] is None       # unarmed: nothing
    pi.audit_restored_table(pl, None)
    _arm()
    rstage = rckpt.open_stage(env4, "unit_fp", "tok")
    rstage.save_piece(0, rl)
    stage = pckpt.open_stage(penv, "unit_fp", "tok")
    stage.save_piece(0, pl)
    fp = stage.committed[0]["fp"]
    assert fp is not None and fp == rstage.committed[0]["fp"]
    before = pi.stats()["manifest_audits"]
    got = [stage.load_piece(0)]                    # a clean round trip
    assert pckpt.audit_restored(stage, got, 1) == 1
    assert pi.stats()["manifest_audits"] == before + 1
    stage.committed[0]["fp"] ^= 1                  # the shas still hold
    got = [stage.load_piece(0)]
    assert pckpt.audit_restored(stage, got, 1) == 0
    with pytest.raises(DataIntegrityError, match="refusing to adopt"):
        pi.audit_restored_table(got[0], stage.committed[0]["fp"])


def test_tampered_manifest_fp_recomputes_never_adopts(env4, ckpt_dirs,
                                                      monkeypatch, armed):
    ldf, rdf = _frames(n=1200, seed=7)
    penv = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    pl, pr = (pct.Table.from_pandas(d, penv) for d in (ldf, rdf))
    cols = ["k", "a", "b"]
    base = _rows(pct.pipelined_join(pl, pr, "k", "k", how="inner",
                                    n_chunks=3), cols)
    mans = sorted(glob.glob(os.path.join(pckpt.ckpt_dir(), "rank*",
                                         "stage*", "MANIFEST.json")))
    assert mans
    with open(mans[0], encoding="utf-8") as f:
        man = json.load(f)
    piece = sorted(man["pieces"], key=int)[-1]
    assert man["pieces"][piece]["fp"] is not None
    man["pieces"][piece]["fp"] ^= 1
    with open(mans[0], "w", encoding="utf-8") as f:
        json.dump(man, f)
    monkeypatch.setenv("CYLON_TPU_TORCH_RESUME", "1")
    pckpt.reset_stages()
    pckpt.reset_stats()
    prec.reset_events()
    resumed = _rows(pct.pipelined_join(pl, pr, "k", "k", how="inner",
                                       n_chunks=3), cols)
    pd.testing.assert_frame_equal(resumed, base)
    st = pckpt.stats()
    assert st["resume_fast_forwarded_pieces"] == 2, st
    assert any(e["site"] == "ckpt.load" and e["action"] == "recompute"
               for e in prec.recovery_events())
