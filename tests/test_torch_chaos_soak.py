"""The port's chaos soak (``cylon_tpu_torch/exec/chaos_soak.py``) against
the reference's harness, ``scripts/chaos_soak.py``.

Held here, on the CPU: the seeded draws equal the reference's for the
same seeds and every drawn and pinned schedule parses under the port's
injector; the soak's workload in process gives the reference's sorted
columns and sha (the reference on its 4-device CPU mesh, the port on a
``VirtualMeshConfig(4)`` world on the CPU, 1,200 rows, 3 chunks), and the
numpy oracle the parent checks the baseline against gives them too; the
outcome classification fails a diverged sha, a missing breadcrumb, too
many recovery events, an unexpected exit and a resume that recomputed
what it should have fast-forwarded; and one soak runs end to end in
child processes.  Slow-marked: one mirror of each of the reference's
slow soak tests (tests/test_checkpoint.py, test_fleet.py,
test_scheduler.py, test_stream.py, test_topo.py) plus the ``--oocore``,
``--audit``, ``--skew`` and ``--compile`` flows with their pinned legs,
every one with ``--device cpu``.

The reference's script is loaded by ``importlib`` (its top level imports
the standard library only); its workload is rebuilt here from its
source, since it lives inside its ``worker``.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import cylon_tpu_torch as pct
from cylon_tpu_torch.exec import chaos_soak as soak
from cylon_tpu_torch.exec import recovery as prec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "cylon_tpu_torch")


def _reference():
    spec = importlib.util.spec_from_file_location(
        "_reference_chaos_soak", os.path.join(REPO, "scripts",
                                              "chaos_soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()

#: the reference's switches and the port's counterparts where a pinned
#: schedule carries one
SWITCHES = {"CYLON_TPU_PACKED_OVERLAP": "CYLON_TPU_TORCH_WINDOWED_GATHER"}


def _translated(sched: dict) -> dict:
    out = dict(sched)
    if "env" in out:
        out["env"] = {SWITCHES[k]: v for k, v in out["env"].items()}
    return out


def test_constants_equal_the_reference():
    assert soak.SITE_KINDS == REF.SITE_KINDS
    assert soak.MAX_RECOVERY_EVENTS == REF.MAX_RECOVERY_EVENTS
    assert soak.RESUMABLE_EXIT == REF.RESUMABLE_EXIT


@pytest.mark.parametrize("seed", range(50))
def test_draws_equal_the_reference(seed):
    """The same seed draws the same schedule, and the next draws too."""
    r_rng, p_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        assert soak._draw_schedule(p_rng) == REF._draw_schedule(r_rng)


def test_pinned_schedules_equal_the_reference():
    """Four pinned schedules, the reference's, the fourth's switch
    translated (the reference's overlap switch has no counterpart; the
    port's one dispatch switch on this path is the windowed gather's)."""
    ref = [_translated(s) for s in REF._pinned_schedules()]
    assert soak._pinned_schedules() == ref
    assert len(ref) == 4


def test_every_schedule_parses():
    """Every pinned schedule and 50 seeds' draws parse under the port's
    injector grammar (install_faults raises on an unknown site or
    kind)."""
    specs = []
    for s in soak._pinned_schedules():
        specs += [s["faults"], s["resume_faults"]]
    for seed in range(50):
        rng = np.random.default_rng(seed)
        for _ in range(4):
            s = soak._draw_schedule(rng)
            specs += [s["faults"], s["resume_faults"]]
    try:
        for spec in specs:
            prec.install_faults(spec)
            assert len(prec._installed()) == len(
                [e for e in spec.split(",") if e])
    finally:
        prec.install_faults("")


def test_per_leg_switches_are_the_ports():
    """Every switch a leg sets is popped from what a child inherits, and
    every popped name is one the port reads."""
    src = open(soak.__file__).read()
    set_by_legs = set(re.findall(r'"(CYLON_TPU_TORCH_[A-Z_]+)"', src))
    assert set_by_legs <= set(soak.PER_LEG_VARS)
    port_src = ""
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py") and f != "chaos_soak.py":
                port_src += open(os.path.join(dirpath, f)).read()
    harness = {"CYLON_TPU_TORCH_FLEET_CASE", "CYLON_TPU_TORCH_FLEET_TARGET"}
    for name in set(soak.PER_LEG_VARS) - harness:
        assert name in port_src, name


def _reference_workload(rows: int, n_chunks: int):
    """The reference's soak attempt (its ``worker``'s ``make_workload``)
    on its 4-device CPU mesh, sorted as its ``_result_sha`` reads it."""
    import cylon_tpu as rct
    from cylon_tpu.ctx.context import CPUMeshConfig
    from cylon_tpu.exec import GroupBySink, pipelined_join
    env = rct.CylonEnv(config=CPUMeshConfig(world_size=4))
    rng = np.random.default_rng(REF_SEED)
    n_ord = max(rows // 4, 64)
    orders = rct.Table.from_pydict(
        {"o_orderkey": np.arange(n_ord, dtype=np.int64),
         "o_shippriority": rng.integers(0, 5, n_ord).astype(np.int64)}, env)
    lineitem = rct.Table.from_pydict(
        {"l_orderkey": rng.integers(0, n_ord, rows).astype(np.int64),
         "l_quantity": rng.integers(1, 51, rows).astype(np.int64),
         "l_extendedprice": rng.integers(900_00, 10_500_00,
                                         rows).astype(np.int64)}, env)
    sink = GroupBySink("l_orderkey", [("l_quantity", "sum"),
                                      ("l_extendedprice", "sum")])
    pipelined_join(lineitem, orders, "l_orderkey", "o_orderkey",
                   how="inner", n_chunks=n_chunks, sink=sink)
    return sink.finalize().to_pandas().sort_values("l_orderkey") \
        .reset_index(drop=True)


#: the reference worker's seed of the soak workload
REF_SEED = 20260803


def test_workload_and_sha_equal_the_reference(monkeypatch):
    """The port's soak workload gives the reference's sorted columns bit
    for bit and the reference's sha; so does the numpy oracle."""
    for k in [k for k in os.environ if k.startswith("CYLON_TPU")]:
        monkeypatch.delenv(k)
    assert soak.SOAK_SEED == REF_SEED
    want = _reference_workload(1200, 3)
    env = pct.CylonEnv(pct.VirtualMeshConfig(4, device="cpu"))
    got = soak._sorted_pydict(
        soak._make_workload(pct, env, soak.SOAK_SEED, 1200)(3),
        "l_orderkey")
    assert sorted(got) == sorted(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        assert got[c].dtype == w.dtype and np.array_equal(got[c], w), c
    assert soak._result_sha(got) == REF._result_sha(want)
    orc = soak.oracle_columns(soak.SOAK_SEED, 1200)
    assert soak._result_sha(orc) == REF._result_sha(want)


BASE = "b" * 64
KILL = {"faults": "ckpt.write::2=kill", "expect_ffwd": True}


@pytest.mark.parametrize("case", [
    # (name, sched, rc, info, breadcrumb, rc2, info2, converged)
    ("converged", {}, 0, {"sha": BASE, "events": 2}, False, None, None,
     True),
    ("diverged_sha", {}, 0, {"sha": "a" * 64, "events": 0}, False, None,
     None, False),
    ("no_result_line", {}, 0, None, False, None, None, False),
    ("too_many_events", {}, 0, {"sha": BASE, "events": 9}, False, None,
     None, False),
    ("unexpected_rc", {}, 1, None, False, None, None, False),
    ("signal_not_kill", {}, -11, None, True, None, None, False),
    ("killed_resumed", KILL, -9, None, True, 0,
     {"sha": BASE, "events": 0, "resume_fast_forwarded_pieces": 1}, True),
    ("typed_abort_resumed", {}, 17, {"resumable": True}, True, 0,
     {"sha": BASE, "events": 1, "resume_fast_forwarded_pieces": 0}, True),
    ("missing_breadcrumb", KILL, -9, None, False, 0,
     {"sha": BASE, "events": 0, "resume_fast_forwarded_pieces": 1}, False),
    ("resume_failed", KILL, -9, None, True, 1, None, False),
    ("resume_diverged", KILL, -9, None, True, 0,
     {"sha": "c" * 64, "events": 0, "resume_fast_forwarded_pieces": 1},
     False),
    ("resume_too_many_events", KILL, 17, None, True, 0,
     {"sha": BASE, "events": 9, "resume_fast_forwarded_pieces": 1}, False),
    ("resume_without_ffwd", KILL, -9, None, True, 0,
     {"sha": BASE, "events": 0, "resume_fast_forwarded_pieces": 0}, False),
], ids=lambda c: c[0])
def test_outcome_classification(case):
    _, sched, rc, info, crumb, rc2, info2, converged = case
    outcome, why = soak.classify_outcome(sched, BASE, rc, info, crumb, rc2,
                                         info2)
    assert (why is None) == converged, (outcome, why)
    if converged and rc != 0:
        assert "+resumed(ffwd=" in outcome


def test_cuda_without_a_card_exits_typed(capsys):
    """``--device cuda`` with no card: a nonzero exit naming
    DeviceUnavailableError, and no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs none")
    assert soak.main(["--device", "cuda", "--schedules", "1"]) != 0
    out = capsys.readouterr()
    assert "DeviceUnavailableError" in out.err and "{" not in out.out


def _cli(*argv, timeout=300, **env_extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CYLON_TPU")}
    env["PYTHONPATH"] = REPO
    env.update(env_extra)
    p = subprocess.run([sys.executable, "-m", soak.MODULE, "--device",
                        "cpu", *argv], capture_output=True, text=True,
                       timeout=timeout, cwd=REPO, env=env)
    last = json.loads(p.stdout.strip().splitlines()[-1]) \
        if p.stdout.strip() else None
    return p, last


def test_soak_end_to_end():
    """One pinned schedule end to end: the baseline equal to the numpy
    oracle, a child SIGKILLed at its second ``ckpt.write`` and a resume
    that fast-forwards the committed piece, bit-equal."""
    p, last = _cli("--seed", "5", "--schedules", "1", "--rows", "1200",
                   "--chunks", "3")
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-2000:]
    assert "killed+resumed(ffwd=1)" in p.stdout
    assert last["failures"] == 0 and last["baseline"]["oracle"] == "equal"
    (o,) = last["outcomes"]
    assert o["ok"] and o["children"] == 2 and last["children"] == 3


# ---------------------------------------------------------------------------
# the flows (slow): the reference's slow tests, mirrored, and the rest
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_chaos_soak_trimmed():
    """tests/test_checkpoint.py's trimmed soak: three pinned schedules."""
    p, last = _cli("--seed", "5", "--schedules", "3", "--rows", "1200",
                   "--chunks", "3", timeout=570)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-2000:]
    assert "killed+resumed(ffwd=1)" in p.stdout, p.stdout[-2000:]


@pytest.mark.slow
def test_chaos_elastic_pinned():
    p, _ = _cli("--elastic", "--rows", "1000", "--chunks", "3", timeout=570)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-2000:]
    assert "A (2→1 reshard) -> ok" in p.stdout, p.stdout[-3000:]
    assert "C (1→2 after-reshard) -> ok" in p.stdout, p.stdout[-3000:]
    assert "E drain -> ok" in p.stdout, p.stdout[-3000:]


@pytest.mark.slow
def test_chaos_soak_fleet():
    p, _ = _cli("--fleet", "--rows", "2400", "--chunks", "4", timeout=560)
    assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]
    assert '"failures": 0' in p.stdout


@pytest.mark.slow
def test_chaos_soak_concurrent_kill_resume():
    p, _ = _cli("--concurrent", "2", "--rows", "1200", timeout=560)
    assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]
    assert '"failures": 0' in p.stdout


@pytest.mark.slow
def test_chaos_stream_kill_and_resume(tmp_path):
    p, _ = _cli("--stream", "--rows", "1500", "--workdir", str(tmp_path),
                timeout=560)
    assert p.returncode == 0, (p.stdout + p.stderr)[-3000:]
    assert "ffwd=" in p.stdout


@pytest.mark.slow
def test_chaos_multislice_pinned():
    p, _ = _cli("--multislice", "--rows", "2000", "--chunks", "3",
                timeout=570)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-2000:]
    assert "topo hier -> ok" in p.stdout, p.stdout[-3000:]
    assert "slice-kill + elastic resume -> ok" in p.stdout, p.stdout[-3000:]
    assert "unarmed single-slice -> ok" in p.stdout, p.stdout[-3000:]


@pytest.mark.slow
@pytest.mark.parametrize("flow, argv, legs", [
    ("oocore", ("--rows", "2000", "--chunks", "3"),
     ("oocore capped -> ok", "oocore enospc -> ok",
      "oocore corrupt-on-promote -> ok",
      "oocore kill mid-demote + resume -> ok")),
    ("audit", ("--rows", "3000"),
     ("audit armed clean -> ok", "audit one-shot corruption -> ok",
      "audit persistent corruption -> typed abort (ok)",
      "audit corruption under skew-split -> ok",
      "audit corruption under two-tier route -> ok")),
    ("skew", ("--rows", "4000"),
     ("skew split -> ok", "skew capacity fault -> ok",
      "skew spill fault -> ok", "skew kill + rerun -> ok",
      "skew unarmed-at-0 -> ok")),
    ("compile", ("--rows", "3000"),
     ("compile corrupt + relaunch -> ok", "compile kill + rerun -> ok",
      "compile stall -> ok")),
])
def test_chaos_flow_pinned(flow, argv, legs):
    p, last = _cli(f"--{flow}", *argv, timeout=570)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-2000:]
    assert last["failures"] == 0
    for leg in legs:
        assert leg in p.stdout, (leg, p.stdout[-3000:])
