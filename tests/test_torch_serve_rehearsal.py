"""The card run's serving phases rehearsed on the CPU (port only):
``chip_smoke.serve_path`` at TPC-H SF 0.01 on a W = 4 world (the solo
pass against ``tpch_oracle`` and a numpy oracle, the concurrent ``fair``
pass and the preempt leg each bit-equal to the solo pass) and
``chip_smoke.serve_small`` at 20,000 rows a side (the typed admission
deadline and requeue overflow, the eviction between a prepared piece and
its consume, the fleet drain relaunched at W = 2 and the kill inside
tenant t0's checkpoint write, resumed, in child processes)."""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

import cylon_tpu_torch as ct  # noqa: E402
from cylon_tpu_torch import tpch  # noqa: E402
from cylon_tpu_torch.ctx.context import VirtualMeshConfig  # noqa: E402
from cylon_tpu_torch.exec import checkpoint, recovery  # noqa: E402


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    """No card: the script's device waits are no-ops here."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    for var in ("CKPT_DIR", "RESUME", "FAULTS", "PREEMPT_GRACE_S"):
        monkeypatch.delenv(f"CYLON_TPU_TORCH_{var}", raising=False)
    recovery.install_faults("")
    checkpoint.reset_stages()
    yield
    recovery.install_faults("")
    checkpoint.reset_stages()


def test_serve_path_sf001_w4(tmp_path):
    cols = tpch.generate_columns(0.01, 0)
    env = ct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    dfs = {name: ct.DataFrame(ct.Table.from_host_columns(c, env))
           for name, c in cols.items()}
    orc = chip_smoke.tpch_oracle(cols)
    orc["qpipe"] = chip_smoke.qpipe_oracle(cols)
    rows = {name: int(c[next(iter(c))].data.shape[0])
            for name, c in cols.items()}
    fair, pre = chip_smoke.serve_path(ct, dfs, env, orc, rows,
                                      str(tmp_path))
    assert fair["phase"] == "serve_path" and fair["bit_equal"]
    assert fair["scheduler"]["admission_waits"] >= 1
    assert fair["cross_session_evictions"] >= 1
    assert fair["scheduler"]["outcomes"] == {"completed": 4}
    assert set(fair["tenants"]) == {"t0", "t1", "t2", "t3"}
    assert [t["mix"] for t in fair["tenants"].values()] == [
        ["qpipe", "q6", "q1"], ["qpipe", "q12", "qpipe"],
        ["q3", "q14", "q15"], ["q5", "q17", "q5"]]
    assert pre["phase"] == "serve_path_preempt" and pre["bit_equal"]
    st = pre["scheduler"]
    assert st["preemptions"] >= 1 and st["requeues"] >= 1
    assert pre["checkpoint"]["resume_fast_forwarded_pieces"] >= 1
    assert pre["victims"] and all(
        pre["tenants"][v]["outcome"] == "preempted_requeued"
        for v in pre["victims"])
    assert st["outcomes"].get("failed_typed", 0) == 0
    # K2's first launch of each serve route was captured: qpipe's phase 1
    # probe, its n_chunks = 4 giving 3 splitters, the same shapes in
    # every pass
    k2 = {**fair["k2"], **pre["k2"]}
    assert set(k2) == {"solo", "fair", "preempt"}
    assert {(r["K"], r["S"], r["cap"]) for r in k2.values()} \
        == {(k2["solo"]["K"], 3, k2["solo"]["cap"])}


def test_serve_small_20k(tmp_path):
    rec = chip_smoke.serve_small(ct, str(tmp_path), n=20000, device="cpu")
    assert rec["admission_timeout"]["outcome"] == "failed_typed"
    assert rec["requeue_overflow"]["cause"] == "ResumableAbort"
    ev = rec["evict_between_prefetch_and_consume"]
    assert ev["cross_session_evictions"] >= 1 and ev["bit_equal_to_solo"]
    assert ev["windows_uploaded"] > ev["readmits_before"] >= 2
    assert rec["fleet"]["breadcrumb"]["target_world"] == 2
    assert set(rec["fleet"]["relaunch"]["outcomes"].values()) \
        == {"completed"}
    assert rec["kill_resume"]["stats"]["resume_fast_forwarded_pieces"] >= 1
