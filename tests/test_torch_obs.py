"""Parity of the observability modules: cylon_tpu_torch's
``obs/metrics.py``, ``obs/trace.py``, ``obs/rank_report.py`` and the
attribution surface of ``utils/timing.py``, against cylon_tpu's on the
CPU.  Mirrors tests/test_obs.py.

Held equal between the packages: histogram percentiles, buckets,
attainment and the NaN cases on the same samples; the Prometheus lines of
the same metrics under the same prefix; the flight recorder's ring wrap,
async pairs and post-mortem content for the same event sequence; the
phase tables of nested scopes with excluded seconds; the rank report's
shape.  On the port alone: the group/namespace views behind the exec
modules' stats, the JSON snapshot and its poll, ``bench_detail``'s keys,
the typed export and post-mortem failures, the drain's post-mortem in the
checkpoint root, the unarmed contract (no file, no event) and the import
of the package with ``jax`` and ``cylon_tpu`` blocked.
"""

import json
import math
import os
import subprocess
import sys
import time
import types

import jax
import numpy as np
import pytest

from cylon_tpu import config as rconfig
from cylon_tpu.obs import metrics as rmetrics
from cylon_tpu.obs import rank_report as rrank
from cylon_tpu.obs import trace as rtrace
from cylon_tpu.utils import timing as rtiming
from cylon_tpu_torch import obs as pobs
from cylon_tpu_torch.exec import recovery as precovery
from cylon_tpu_torch.obs import metrics as pmetrics
from cylon_tpu_torch.obs import rank_report as prank
from cylon_tpu_torch.obs import trace as ptrace
from cylon_tpu_torch.status import (ExecutionError, InvalidError,
                                    PredictedResourceExhausted)
from cylon_tpu_torch.utils import timing as ptiming

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Release the reference's compiled XLA:CPU programs at module end."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Both recorders disarmed, fresh phase tables, both timing switches
    off and no armed injector, before and after each test."""
    for v in ("CYLON_TPU_TORCH_TRACE", "CYLON_TPU_TORCH_METRICS_JSON",
              "CYLON_TPU_TORCH_RANK_REPORT", "CYLON_TPU_TRACE",
              "CYLON_TPU_METRICS_JSON", "CYLON_TPU_RANK_REPORT"):
        monkeypatch.delenv(v, raising=False)
    prev = rconfig.BENCH_TIMINGS, ptiming.mode()

    def clean():
        for t in (rtrace, ptrace):
            t.disarm()
        for tm in (rtiming, ptiming):
            tm.reset()
        for m in (rmetrics, pmetrics):
            m._rearm_snapshots()
        precovery.install_faults("")
    clean()
    yield
    clean()
    rconfig.BENCH_TIMINGS = prev[0]
    ptiming.enable(prev[1])


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_histogram_matches_reference():
    """Percentiles (np.percentile, exact), buckets, attainment and the
    exposition view, equal on the same samples; the NaN and range
    contracts alike."""
    rng = np.random.default_rng(3)
    xs = list(rng.gamma(2.0, 0.05, 499))
    hists = []
    for m in (rmetrics, pmetrics):
        h = m.Histogram("t_hist_exact")
        for x in xs:
            h.observe(x)
        hists.append(h)
    rh, ph = hists
    for p in (0, 50, 90, 99, 99.9, 100):
        assert ph.percentile(p) == rh.percentile(p) \
            == float(np.percentile(np.asarray(xs, float), p))
    assert ph.bucket_counts == rh.bucket_counts
    assert ph.buckets == rh.buckets
    for t in (0.01, 0.1, 1.0):
        assert ph.attainment(t) == rh.attainment(t)
    assert ph.value == rh.value
    for bad in (-1, 100.5):
        with pytest.raises(InvalidError):
            ph.percentile(bad)
    empty = pmetrics.Histogram("t_hist_empty")
    assert math.isnan(empty.percentile(50)) and empty.value["p50"] is None
    assert empty.attainment(1.0) is None


@pytest.mark.parametrize("cap", [0, 8])
def test_truncated_histogram_matches_reference(monkeypatch, cap):
    """Past ``SAMPLE_CAP`` the quantiles interpolate in the buckets (or
    are NaN when no sample was kept), equal in both packages."""
    monkeypatch.setattr(rmetrics, "SAMPLE_CAP", cap)
    monkeypatch.setattr(pmetrics, "SAMPLE_CAP", cap)
    xs = np.linspace(0.01, 0.3, 40)
    rh = rmetrics.Histogram("t_trunc", buckets=(0.05, 0.1, 0.2, 0.4))
    ph = pmetrics.Histogram("t_trunc", buckets=(0.05, 0.1, 0.2, 0.4))
    for x in xs:
        rh.observe(x)
        ph.observe(x)
    assert ph.truncated and rh.truncated
    for p in (10, 50, 99):
        a, b = ph.percentile(p), rh.percentile(p)
        assert (math.isnan(a) and math.isnan(b)) or a == b
    assert ph.attainment(0.1) == rh.attainment(0.1)
    assert ph.value == rh.value


def test_prometheus_lines_match_reference():
    """The same counter, gauge and histogram under the same prefix give
    the same exposition lines in both packages."""
    lines = []
    for m in (rmetrics, pmetrics):
        m.counter("t_prom_c").set(9)
        m.gauge("t_prom_g").set(3)
        m.counter("t.prom.dotted").set(1)
        h = m.histogram("t_prom_h", buckets=(1.0, 2.0))
        h.reset()
        h.observe(0.5)
        h.observe(1.5)
        text = m.prometheus_text(prefix="cyl")
        lines.append([ln for ln in text.splitlines() if "t_prom" in ln])
    assert lines[0] == lines[1]
    assert "cyl_t_prom_dotted 1" in lines[1]
    assert 'cyl_t_prom_h_bucket{le="+Inf"} 2' in lines[1]
    assert "cylon_tpu_torch_t_prom_c 9" in pmetrics.prometheus_text()


def test_registry_views_and_conflicts():
    """Typed conflict; group and namespace views live in the registry;
    ``reset(prefix)``; the exec modules' stats are registry-backed and
    keep their shape."""
    pmetrics.counter("t_conflict")
    with pytest.raises(InvalidError):
        pmetrics.gauge("t_conflict")
    assert pmetrics.gauge("t_live", fn=lambda: 42).value == 42
    st = pmetrics.group("t_grp", ("a", "b"))
    st["a"] += 3
    assert dict(st) == {"a": 3, "b": 0}
    assert pmetrics.counter("t_grp_a").value == 3
    ns = pmetrics.namespace("t_ns")
    ns["x"] = ns.get("x", 0) + 7
    assert pmetrics.counter("t_ns_x").value == 7
    ns.clear()
    assert "x" not in ns and pmetrics.counter("t_ns_x").value == 0
    pmetrics.counter("t_rst_one").inc(5)
    pmetrics.counter("other_t_rst").inc(5)
    pmetrics.reset("t_rst")
    assert pmetrics.counter("t_rst_one").value == 0
    assert pmetrics.counter("other_t_rst").value == 5
    from cylon_tpu_torch.exec import checkpoint, memory
    checkpoint.reset_stats()
    memory.reset_stats()
    checkpoint._STATS["checkpoint_events"] += 2
    memory._STATS["spill_events"] += 1
    assert checkpoint.stats()["checkpoint_events"] == 2
    assert pmetrics.counter("ckpt_checkpoint_events").value == 2
    assert pmetrics.counter("memory_spill_events").value == 1
    assert set(memory.stats()) >= {"spill_events", "peak_ledger_bytes",
                                   "disk_events", "bytes_to_disk"}
    checkpoint.reset_stats()
    memory.reset_stats()
    assert pmetrics.counter("ckpt_checkpoint_events").value == 0
    # the families the exec modules and the exchange register
    import cylon_tpu_torch.parallel.shuffle  # noqa: F401
    pmetrics.counter("exchange_rows_total")
    text = pmetrics.prometheus_text()
    for fam in ("memory_ledger_bytes", "memory_disk_events",
                "ckpt_bytes_checkpointed", "exchange_rows_total",
                "recovery_io_retries"):
        assert f"cylon_tpu_torch_{fam}" in text, fam


def test_snapshot_poll_and_bench_detail(tmp_path, monkeypatch):
    ptiming.enable("async")
    with ptiming.region("t.snapcol"):
        pass
    assert "t.snapcol" in pmetrics.snapshot()["phases"]
    path = str(tmp_path / "m.json")
    pmetrics.write_snapshot(path)
    doc = json.load(open(path, encoding="utf-8"))
    assert "ts" in doc and isinstance(doc["metrics"], dict)
    os.unlink(path)
    monkeypatch.setenv("CYLON_TPU_TORCH_METRICS_JSON", path)
    monkeypatch.setenv("CYLON_TPU_TORCH_METRICS_INTERVAL_S", "3600")
    pmetrics._rearm_snapshots()
    assert pmetrics.maybe_write_snapshot() is True and os.path.exists(path)
    os.unlink(path)
    assert pmetrics.maybe_write_snapshot() is False
    assert not os.path.exists(path)
    bd = pobs.bench_detail()
    assert set(bd) == {"recovery_events", *pmetrics.BENCH_SPILL_KEYS,
                       *pmetrics.BENCH_CKPT_KEYS, "compile", "audit"}
    assert set(bd["compile"]) == set(rmetrics.BENCH_COMPILE_KEYS)
    assert set(bd["audit"]) == set(rmetrics.BENCH_AUDIT_KEYS)
    assert set(pmetrics.BENCH_CKPT_KEYS) == set(rmetrics.BENCH_CKPT_KEYS)
    assert set(pmetrics.BENCH_SPILL_KEYS) == \
        set(rmetrics.BENCH_SPILL_KEYS) - {"donated_bytes_reused"}
    precovery.reset_events()
    precovery._record("t.site", "predicted", "retry")
    assert len(pobs.bench_detail(events="keep")["recovery_events"]) == 1
    assert len(pobs.bench_detail()["recovery_events"]) == 1
    assert pobs.bench_detail()["recovery_events"] == []
    assert pobs.bench_detail(plan={"mode": "x"})["plan"] == {"mode": "x"}


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

def _drive(trace, timing, n=20):
    for i in range(n):
        timing.bump(f"t.ev{i}")
    timing.add_bytes("t.bytes", 128)
    with timing.region("t.last"):
        pass
    trace.async_begin("t.piece", 3, piece=3)
    trace.async_end("t.piece", 3)


def _shape(events):
    """Events without their clocks: (phase, name, args)."""
    return [(e[2], e[3], e[6]) for e in events]


def test_ring_wrap_async_pairs_match_reference():
    rrec = rtrace.arm(capacity=16)
    prec = ptrace.arm(capacity=16)
    _drive(rtrace, rtiming)
    _drive(ptrace, ptiming)
    assert _shape(prec.events()) == _shape(rrec.events())
    assert prec.dropped == rrec.dropped > 0
    assert [e[3] for e in prec.events(last=4)] == \
        ["t.bytes", "t.last", "t.piece", "t.piece"]
    doc = prec.chrome_trace()
    pair = [e for e in doc["traceEvents"] if e["name"] == "t.piece"]
    assert [e["ph"] for e in pair] == ["b", "e"]
    assert all(e["id"] == 3 and e["cat"] == "piece" for e in pair)
    tss = [e["ts"] for e in doc["traceEvents"] if "ts" in e]
    assert tss == sorted(tss)
    # the phase table stays empty with timing off
    assert "t.last" not in ptiming.snapshot()


def test_postmortem_content_matches_reference(tmp_path):
    docs = []
    for trace, timing, sub in ((rtrace, rtiming, "r"), (ptrace, ptiming,
                                                         "p")):
        trace.arm(capacity=16)
        with timing.attribution_scope("tenant_x"):
            _drive(trace, timing)
        out = trace.postmortem("unit", dir_path=str(tmp_path / sub), n=8)
        docs.append(json.load(open(out, encoding="utf-8")))
    rdoc, pdoc = docs
    for k in ("reason", "pid", "last_region", "dropped_events"):
        assert pdoc[k] == rdoc[k], k
    strip = [[{k: v for k, v in e.items() if k not in ("ts_us", "dur_us")}
              for e in d["events"]] for d in docs]
    assert strip[0] == strip[1] and len(strip[1]) == 8
    assert all(e["session"] == "tenant_x" for e in pdoc["events"])


def test_export_and_postmortem_failures_are_typed(tmp_path):
    """The ``obs.export`` injection site raises its kind; a real OSError
    of the export or of the post-mortem raises ``ExecutionError``."""
    ptrace.arm(path=str(tmp_path / "tr.json"), capacity=16)
    precovery.install_faults("obs.export::1=predicted")
    with pytest.raises(PredictedResourceExhausted):
        ptrace.export()
    precovery.install_faults("")
    assert ptrace.export() is not None
    missing = str(tmp_path / "no" / "such" / "tr.json")
    with pytest.raises(ExecutionError):
        ptrace.export(missing)
    blocker = tmp_path / "afile"
    blocker.write_text("x")
    with pytest.raises(ExecutionError):
        ptrace.postmortem("unit", dir_path=str(blocker / "sub"))


def test_drain_flush_writes_postmortem(tmp_path, monkeypatch):
    """The drain's and the final rung's flush leaves the post-mortem
    beside the manifests, its last events included."""
    from cylon_tpu_torch.exec import checkpoint
    root = str(tmp_path / "ckpt")
    monkeypatch.setenv("CYLON_TPU_TORCH_CKPT_DIR", root)
    ptrace.arm(capacity=16)
    with ptiming.region("ckpt.write"):
        pass
    checkpoint.flush_for_abort("unit")
    doc = json.load(open(os.path.join(root, "TRACE_POSTMORTEM.json"),
                         encoding="utf-8"))
    assert doc["reason"] == "abort flush: unit"
    assert any(e["name"] == "ckpt.write" for e in doc["events"])


def test_drain_survives_failed_postmortem(tmp_path, monkeypatch):
    """A post-mortem that cannot be written (its file name taken by a
    directory) is logged on the abort path: the drain still raises its
    ``ResumableAbort`` with the token, and the token file is written."""
    from cylon_tpu_torch.exec import checkpoint
    from cylon_tpu_torch.status import ResumableAbort
    root = tmp_path / "ckpt"
    (root / "TRACE_POSTMORTEM.json").mkdir(parents=True)
    monkeypatch.setenv("CYLON_TPU_TORCH_CKPT_DIR", str(root))
    monkeypatch.setenv("CYLON_TPU_TORCH_PREEMPT_GRACE_S", "30")
    ptrace.arm(capacity=16)
    with pytest.raises(ExecutionError):
        ptrace.postmortem("direct", dir_path=str(root))
    try:
        with pytest.raises(ResumableAbort) as ei:
            checkpoint.drain_abort("unit")
    finally:
        precovery.reset_events()
    assert ei.value.token == os.path.abspath(str(root))
    tok = json.load(open(root / "RESUME_TOKEN.json", encoding="utf-8"))
    assert tok["label"] == "unit"


def test_consensus_votes_on_timeline():
    rec = ptrace.arm(capacity=16)
    precovery.count_consensus(None, 3)
    assert rec.events()[-1][3] == "consensus.exchange.count"
    assert rec.events()[-1][6] == {"wire": 3}


def test_unarmed_records_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert not ptrace.armed() and ptiming._TRACE[0] is None
    with ptiming.region("t.off"):
        pass
    ptiming.bump("t.off_bump")
    ptrace.instant("t.off_instant")
    ptrace.complete("t.off_span", time.perf_counter())
    ptrace.async_begin("t.off_async", 1)
    assert ptrace.export() is None
    assert ptrace.postmortem("nothing armed") is None
    assert not prank.armed()
    assert pmetrics.maybe_write_snapshot() is False
    assert os.listdir(tmp_path) == []
    ptrace.autoarm()
    assert not ptrace.armed()
    monkeypatch.setenv("CYLON_TPU_TORCH_TRACE", str(tmp_path / "t.json"))
    ptrace.autoarm()
    assert ptrace.armed()
    assert ptrace.recorder().path == str(tmp_path / "t.json")


def test_import_blocks_jax_and_reference():
    """The package imports, and runs its observability, with ``jax`` and
    ``cylon_tpu`` unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'cylon_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import cylon_tpu_torch as ct\n"
        "env = ct.CylonEnv(ct.VirtualMeshConfig(4), device='cpu')\n"
        "t = ct.Table.from_pydict({'k': np.arange(64) % 7}, env)\n"
        "qp = ct.obs.explain_analyze(ct.sort_table, t, 'k')\n"
        "assert qp.roots[0].op == 'sort', qp.render()\n"
        "ct.Status.OK().raise_if_failed()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cylon_tpu') and sys.modules[m] is not None)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr


# ---------------------------------------------------------------------------
# utils/timing's attribution surface
# ---------------------------------------------------------------------------

def _nested(timing, sleep):
    with timing.attribution_scope("t_out") as so:
        with timing.region("t.outer"):
            with timing.region("t.inner"):
                sleep(0.03)
                timing.exclude_from_scope(0.03)
        with timing.region("t.only_outer"):
            sleep(0.02)
        with timing.attribution_scope("t_in") as si:
            with timing.region("t.only_inner"):
                sleep(0.02)
                timing.exclude_from_scope(0.02)
    return so, si


class _FakeClock:
    """A ``perf_counter`` that only :meth:`sleep` advances."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += seconds


def test_exclusion_and_nested_scopes_match_reference(monkeypatch):
    """Excluded seconds net out of the inner and outer region, in the
    scope's table and the process-wide one; nested scopes are disjoint.
    Both packages give the same tables' names, counts and nettings.
    Both packages' timing modules read one fake clock that the sleeps
    advance, so every netting is exact whatever the host's load."""
    clock = _FakeClock()
    fake_time = types.SimpleNamespace(perf_counter=clock.perf_counter)
    monkeypatch.setattr(rtiming, "time", fake_time)
    monkeypatch.setattr(ptiming, "time", fake_time)
    rconfig.BENCH_TIMINGS = True
    ptiming.enable("async")
    r = _nested(rtiming, clock.sleep)
    p = _nested(ptiming, clock.sleep)
    for (rs, ps) in zip(r, p):
        rd, pd = rs.snapshot(), ps.detail()
        assert sorted(rd) == sorted(pd)
        for k in rd:
            assert rd[k]["n"] == pd[k]["n"], k
            # rounded to 4 places in the reference's table
            assert abs(rd[k]["s"] - pd[k]["s"]) < 1e-4, k
    so, si = p
    assert so.snapshot()["t.outer"] == pytest.approx(0.0, abs=1e-9)
    assert so.snapshot()["t.only_outer"] == pytest.approx(0.02, abs=1e-9)
    assert "t.only_inner" not in so.snapshot()
    assert si.snapshot()["t.only_inner"] == pytest.approx(0.0, abs=1e-9)
    g = ptiming.snapshot()
    assert g["t.inner"] == pytest.approx(0.0, abs=1e-9)
    assert g["t.outer"] == pytest.approx(0.0, abs=1e-9)
    assert sorted(ptiming.detail()) == sorted(rtiming.snapshot())
    # absorb merges a scope's table, counts and bytes included
    so.absorb(si)
    assert so.detail()["t.only_inner"]["n"] == 1
    assert so.total_seconds() >= si.total_seconds()
    # reset clears the breadcrumb and the exclusion accumulator
    with ptiming.region("t.crumb"):
        pass
    assert ptiming.last_region() == "t.crumb"
    ptiming.reset()
    assert ptiming.last_region() == "" and ptiming._SCOPE_TLS.excluded == 0


def test_timing_counters_in_registry():
    ptiming.bump("t.reg_bump")
    ptiming.add_bytes("t.reg_bytes", 64)
    assert pmetrics.counter("timing_event_t.reg_bump").value == 1
    assert pmetrics.counter("timing_bytes_t.reg_bytes").value == 64
    assert ptiming.byte_counts()["t.reg_bytes"] == 64
    ptiming.reset()
    assert pmetrics.counter("timing_bytes_t.reg_bytes").value == 0


def test_rank_report_matches_reference(monkeypatch):
    assert not prank.armed()
    monkeypatch.setenv("CYLON_TPU_TORCH_RANK_REPORT", "1")
    assert prank.armed()
    monkeypatch.delenv("CYLON_TPU_TORCH_RANK_REPORT")
    prank.arm()
    assert prank.armed()
    prank.arm(False)
    rconfig.BENCH_TIMINGS = True
    ptiming.enable("async")
    for tm in (rtiming, ptiming):
        with tm.region("t.rank_phase"):
            time.sleep(0.01)
        tm.bump("t.rank_bump")
    reps = [rrank.report(), prank.report()]
    assert reps[1]["ranks"] == reps[0]["ranks"] == 1
    assert sorted(reps[1]["phases"]) == sorted(reps[0]["phases"])
    ent = reps[1]["phases"]["t.rank_phase"]
    assert ent["min_s"] == ent["median_s"] == ent["max_s"]
    assert ent["skew"] == 1.0
    assert reps[1]["phases"]["t.rank_bump"]["skew"] is None
