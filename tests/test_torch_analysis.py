"""The port's analysis gate, ``cylon_tpu_torch/analysis``, held against
the reference's ``cylon_tpu/analysis`` on this CPU rig.

* The suppression grammar gives the reference's answers on every file of
  the reference's bad fixtures and of the port (a).
* On each reference fixture whose rule the port keeps, the port fires the
  reference's (rule, line) set; the coherence fixtures fire exactly their
  CX rule in both analyzers (b).
* The reference's synthetic call-graph, taint and dominance cases
  (tests/test_trace_safety.py), re-expressed with the port's transport
  calls, give the reference's findings (c).
* The reworded rules (TS101, TS117) and CL201 fire on the port's own
  fixtures, source strings under virtual ``cylon_tpu_torch/<dir>/``
  paths, and not on their negatives (d).
* The gate as a subprocess: exit 0 on the port with ``--strict
  --fail-stale-suppressions`` (every vote kind proven at a site, no
  stale suppression, the reference's JSON schema), exit 1 on a directory
  of the port's fixtures, ``--list-rules``, and an import that loads no
  jax and nothing of ``cylon_tpu`` (e, i).
* The runtime sentinel: funnel pulls (RT303, the pipelined join held to
  the reference's budget from tests/test_pipeline.py), kernel builds
  through the compile tier's stand-in builds (RT301, RT302), the
  collective log's comparator (CL202) and the stray-sync count's
  attribution (f, g, h).
"""

import json
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest

from cylon_tpu.analysis import ast_lint as rlint
from cylon_tpu.analysis import coherence as rcoh
from cylon_tpu.analysis import rules as rrules
import cylon_tpu_torch as pct
from cylon_tpu_torch.analysis import ast_lint as plint
from cylon_tpu_torch.analysis import coherence as pcoh
from cylon_tpu_torch.analysis import collective_check, runtime
from cylon_tpu_torch.analysis import rules as prules
from cylon_tpu_torch.ctx.context import VirtualMeshConfig

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PKG = os.path.join(REPO, "cylon_tpu_torch")
BAD = os.path.join(HERE, "data", "tracecheck_bad")
COH = os.path.join(BAD, "coherence")


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    yield
    jax.clear_caches()


def _py_files(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root)
            for f in sorted(fs) if f.endswith(".py")]


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


def _gate(*args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "cylon_tpu_torch.analysis", *args],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=300)


# ---------------------------------------------------------------------------
# (a) the suppression grammar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("root", [BAD, PKG], ids=["ref_fixtures", "port"])
def test_suppression_grammar_matches_reference(root):
    files = _py_files(root)
    assert len(files) > 10
    for path in files:
        src = _read(path)
        assert prules.suppressions(src) == rrules.suppressions(src), path
        assert prules.file_suppressed(src) == rrules.file_suppressed(src)
        sup = rrules.suppressions(src)
        for line in sup:
            for rule in ("TS101", "CX401", "TS112"):
                f_r = rrules.Finding(rule, path, line, "")
                f_p = prules.Finding(rule, path, line, "")
                assert prules.is_suppressed(f_p, sup, [line - 1]) == \
                    rrules.is_suppressed(f_r, sup, [line - 1])


# ---------------------------------------------------------------------------
# (b) the reference's fixtures of the rules the port keeps
# ---------------------------------------------------------------------------

KEPT_FIXTURES = (
    "bad_oom_stringmatch.py", "relational/bad_ckpt_write.py",
    "bad_direct_admission.py", "bad_stream_mutation.py",
    "bad_foreign_rank_read.py", "bad_stats_dict.py",
    "relational/bad_plan_push.py", "bad_spill_file_io.py",
    "relational/bad_skew_salt.py", "bad_topo_plan.py",
    "relational/bad_integrity.py", "suppressed.py")


@pytest.mark.parametrize("name", KEPT_FIXTURES)
def test_fixture_fires_reference_rule_lines(name):
    path = os.path.join(BAD, name)
    want = sorted((f.rule, f.line) for f in rlint.lint_file(path))
    got = sorted((f.rule, f.line) for f in plint.lint_file(path))
    assert got == want
    assert bool(want) == (name != "suppressed.py")


@pytest.mark.parametrize("name,rule", [
    ("bad_tainted_branch.py", "CX401"), ("bad_path_dependent.py", "CX402"),
    ("bad_vote_after_collective.py", "CX403"),
    ("bad_raise_post_collective.py", "CX404")])
def test_coherence_fixture_fires_its_rule(name, rule):
    path = os.path.join(COH, name)
    assert [f.rule for f in rcoh.analyze_paths([path]).findings] == [rule]
    assert [f.rule for f in pcoh.analyze_paths([path]).findings] == [rule]


def test_coherence_fixture_package_fires_all_four():
    rep = pcoh.analyze_paths([COH])
    assert sorted(f.rule for f in rep.findings) == [
        "CX401", "CX402", "CX403", "CX404"]


# ---------------------------------------------------------------------------
# (c) the reference's synthetic cases, with the port's transport calls
# ---------------------------------------------------------------------------

#: name -> (reference source, port source); one line each for one line
SYNTHETIC = {
    "taint_through_returns": (
        "def my_rank():\n"
        "    return jax.process_index()\n\n\n"
        "def step(mesh, t):\n"
        "    t = exchange(mesh, t)\n"
        "    r = my_rank()\n"
        "    k = r + 1\n"
        "    if k > 0:\n"
        "        t = t[:1]\n"
        "    return exchange(mesh, t)\n",
        "def my_rank():\n"
        "    return transport.current().pid\n\n\n"
        "def step(env, t):\n"
        "    t = transport.all_to_all_rows(t, [1], [1])\n"
        "    r = my_rank()\n"
        "    k = r + 1\n"
        "    if k > 0:\n"
        "        t = t[:1]\n"
        "    return transport.all_to_all_rows(t, [1], [1])\n"),
    "vote_sanitizes_branch": (
        "def step(mesh, t):\n"
        "    t = exchange(mesh, t)\n"
        "    r = jax.process_index()\n"
        "    voted = consensus_code(mesh, r)\n"
        "    if voted:\n"
        "        t = t[:1]\n"
        "    return exchange(mesh, t)\n",
        "def step(env, t):\n"
        "    t = transport.allgather_rows(t)\n"
        "    r = env.rank\n"
        "    voted = consensus_code(env, r)\n"
        "    if voted:\n"
        "        t = t[:1]\n"
        "    return transport.allgather_rows(t)\n"),
    "vote_before_loop_dominates": (
        "def adopt_plan(mesh, t, plan):\n"
        "    skew_plan_consensus(mesh, plan)\n"
        "    for _ in range(2):\n"
        "        t = split_exchange(mesh, t, plan)\n"
        "    return t\n",
        "def adopt_plan(env, t, plan):\n"
        "    skew_plan_consensus(env, plan.plan_hash())\n"
        "    for _ in range(2):\n"
        "        t = split_exchange(t, ['k'], t, ['k'], plan)\n"
        "    return t\n"),
    "vote_after_collective_fires": (
        "def adopt_plan(mesh, t, plan):\n"
        "    t = split_exchange(mesh, t, plan)\n"
        "    skew_plan_consensus(mesh, plan)\n"
        "    return t\n",
        "def adopt_plan(env, t, plan):\n"
        "    t = split_exchange(t, ['k'], t, ['k'], plan)\n"
        "    skew_plan_consensus(env, plan.plan_hash())\n"
        "    return t\n"),
    "vote_on_one_path_fires": (
        "def adopt_plan(mesh, t, plan, cheap):\n"
        "    if cheap:\n"
        "        skew_plan_consensus(mesh, plan)\n"
        "    return split_exchange(mesh, t, plan)\n",
        "def adopt_plan(env, t, plan, cheap):\n"
        "    if cheap:\n"
        "        skew_plan_consensus(env, plan.plan_hash())\n"
        "    return split_exchange(t, ['k'], t, ['k'], plan)\n"),
    "vote_in_branch_test_dominates": (
        "def maybe_abort(mesh, env):\n"
        "    if drain_requested(env):\n"
        "        drain_abort('preempt')\n",
        "def maybe_abort(env):\n"
        "    if checkpoint.drain_requested(env):\n"
        "        checkpoint.drain_abort('pipelined_join')\n"),
    "suppression_honored": (
        "def tainted(mesh, table, probe, exchange):\n"
        "    out = exchange(mesh, table)\n"
        "    kind, armed = probe('guard')\n"
        "    if armed:  # tracecheck: off[CX401] — fixture for the test\n"
        "        kind = 'armed'\n"
        "    return exchange(mesh, out)\n",
        "def tainted(env, x):\n"
        "    out = transport.all_to_all_rows(x, [1], [1])\n"
        "    kind, armed = recovery.probe('guard')\n"
        "    if armed:  # tracecheck: off[CX401] — fixture for the test\n"
        "        kind = 'armed'\n"
        "    return transport.all_to_all_rows(out, [1], [1])\n"),
    "rank_local_trip_count": (
        "def pull_all(mesh, t):\n"
        "    n = jax.process_index()\n"
        "    for _ in range(n):\n"
        "        t = exchange(mesh, t)\n"
        "    return t\n",
        "def pull_all(env, t):\n"
        "    n = transport.current().first\n"
        "    for _ in range(n):\n"
        "        t = transport.allgather_tensor(t)\n"
        "    return t\n"),
}


def _summary_lines(rep):
    return {k: [int(s.rsplit(":", 1)[1]) for s in v]
            for k, v in rep.vote_summary.items() if k != "preempt"}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_synthetic_case_matches_reference(case):
    ref_src, port_src = SYNTHETIC[case]
    r = rcoh.analyze_source("cylon_tpu/fake/case.py", ref_src)
    p = pcoh.analyze_source("cylon_tpu_torch/fake/case.py", port_src)
    assert [(f.rule, f.line) for f in p.findings] == \
        [(f.rule, f.line) for f in r.findings]
    assert [(f.rule, f.line) for f in p.raw] == \
        [(f.rule, f.line) for f in r.raw]
    assert _summary_lines(p) == _summary_lines(r)
    assert p.findings or p.raw or any(p.vote_summary.values()) or \
        case == "vote_sanitizes_branch"


def test_callgraph_propagates_from_the_transport():
    files = {
        "cylon_tpu_torch/fake/a.py":
            "def leafop(env, t):\n"
            "    return transport.all_to_all_rows(t, [1], [1])\n",
        "cylon_tpu_torch/fake/b.py":
            "def mid(env, t):\n"
            "    return leafop(env, t)\n\n\n"
            "def top(env, t):\n"
            "    return mid(env, t)\n\n\n"
            "def voter(env, x):\n"
            "    return consensus_code(env, x)\n\n\n"
            "def pure(x):\n"
            "    return torch.from_numpy(x)\n",
        "cylon_tpu_torch/fake/c.py":
            "class Column:\n"
            "    def from_numpy(self, x):\n"
            "        return top(None, x)\n",
    }
    an = pcoh.Analyzer(files)
    info = {f.qualname: f for f in an.functions}
    assert info["leafop"].enters_data and info["mid"].enters_data
    assert info["top"].enters_data and info["Column.from_numpy"].enters_data
    assert info["voter"].enters_consensus and not info["voter"].enters_data
    # torch.from_numpy is torch's, never Column.from_numpy
    assert not info["pure"].enters_data
    assert an.classify("transport.barrier") == "data"
    assert an.classify("recovery.footprint_consensus") == "consensus"


# ---------------------------------------------------------------------------
# (d) the port's own fixtures
# ---------------------------------------------------------------------------

TS101_SRC = (
    "import numpy as np\n"
    "import torch\n\n\n"
    "def count_live(mask):\n"
    "    n = int(mask.sum().item())\n"                       # 6
    "    idx = torch.nonzero(mask)\n"                        # 7
    "    rows = idx.cpu()\n"                                 # 8
    "    vals = rows.numpy()\n"                              # 9
    "    flags = mask.tolist()\n"                            # 10
    "    ar = np.asarray(torch.arange(3))\n"                 # 11
    "    ok = np.asarray(rows).tolist()\n"
    "    return n, vals, flags, ar, ok, np.asarray(rows)\n")
TS117_SRC = (
    "import ctypes\n"
    "import subprocess\n\n"
    "import torch\n"
    "from torch.utils import cpp_extension\n\n\n"
    "def sneaky_build(src, so, f):\n"
    "    subprocess.run(['nvcc', '-shared', '-o', so, src], check=True)\n"
    "    subprocess.Popen([_nvcc(), src])\n"                 # 10
    "    subprocess.check_call('g++ -O2 -shared x.cpp', shell=True)\n"
    "    lib = ctypes.CDLL(so)\n"                            # 12
    "    ext = cpp_extension.load('k', [src])\n"             # 13
    "    g = torch.compile(f)\n"                             # 14
    "    subprocess.run(['git', 'status'])\n"
    "    return lib, ext, g, ctypes.sizeof(ctypes.c_int)\n")
CL201_SRC = (
    "from ..parallel import transport\n\n\n"
    "def exchange_rows(env, x):\n"
    "    got = transport.all_to_all_rows(x, [1], [1])\n"
    "    return transport.allgather_array(got)\n\n\n"
    "declare_facade('fake/mover.py', 'exchange_rows', {KINDS})\n")


@pytest.mark.parametrize("path,want", [
    ("cylon_tpu_torch/relational/fake_sync.py",
     [6, 7, 8, 9, 10, 11]),
    ("cylon_tpu_torch/exec/fake_sync.py", [6, 7, 8, 9, 10, 11]),
    ("cylon_tpu_torch/utils/host.py", []),
    ("cylon_tpu_torch/parallel/transport.py", []),
    ("cylon_tpu_torch/frame.py", [])])
def test_ts101_host_read_outside_funnel(path, want):
    got = sorted(f.line for f in plint.lint_source(path, TS101_SRC)
                 if f.rule == "TS101")
    assert got == want


@pytest.mark.parametrize("path,want", [
    ("cylon_tpu_torch/ops/fake_build.py", [9, 10, 11, 12, 13, 14]),
    ("cylon_tpu_torch/exec/compiler.py", []),
    ("cylon_tpu_torch/native/__init__.py", [])])
def test_ts117_raw_build_outside_compile_tier(path, want):
    got = sorted(f.line for f in plint.lint_source(path, TS117_SRC)
                 if f.rule == "TS117")
    assert got == want


@pytest.mark.parametrize("kinds,extra", [
    ("{'all_to_all_rows'}", "['allgather_array']"),
    ("{'all_to_all_rows', 'allgather_array'}", None)])
def test_cl201_undeclared_allgather(kinds, extra):
    files = {"cylon_tpu_torch/fake/mover.py":
             CL201_SRC.replace("{KINDS}", kinds)}
    got = collective_check.check_facades(files)
    if extra is None:
        assert got == []
    else:
        assert [f.rule for f in got] == ["CL201"]
        assert f"undeclared transport kind(s) {extra}" in got[0].message


# ---------------------------------------------------------------------------
# (e, i) the gate as a subprocess
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_gate(tmp_path_factory):
    out = tmp_path_factory.mktemp("gate") / "findings.json"
    res = _gate("--strict", "--fail-stale-suppressions", "--no-cache",
                "--json", str(out))
    return res, json.loads(out.read_text())


def test_port_lints_clean_and_coherent(port_gate):
    res, payload = port_gate
    assert res.returncode == 0, res.stdout + res.stderr
    assert "analysis gate: clean" in res.stderr
    assert payload["version"] == 1 and payload["counts"] == {}
    assert payload["stale_suppressions"] == []
    assert payload["findings"], "the added suppressions are reported"
    for f in payload["findings"]:
        assert set(f) == {"rule", "file", "line", "message", "suppressed"}
        assert f["suppressed"] is True
    line = [ln for ln in res.stderr.splitlines()
            if "dominating vote sites" in ln][0]
    sites = dict(kv.split("=") for kv in line.split(": ")[-1].split(", "))
    for kind in ("skew", "topo", "ckpt", "drain", "preempt"):
        assert int(sites[kind]) >= 1, kind
    assert "collective contracts:" in res.stderr


def test_gate_fails_on_port_fixtures(tmp_path):
    for rel, src in (("cylon_tpu_torch/relational/bad_sync.py", TS101_SRC),
                     ("cylon_tpu_torch/ops/bad_build.py", TS117_SRC),
                     ("cylon_tpu_torch/fake/mover.py",
                      CL201_SRC.replace("{KINDS}", "{'all_to_all_rows'}"))):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    res = _gate("--strict", "--no-cache", str(tmp_path / "cylon_tpu_torch"))
    assert res.returncode == 1, res.stdout + res.stderr
    fired = {ln.split(": ")[1].split()[0] for ln in res.stdout.splitlines()
             if ": " in ln}
    assert fired == {"TS101", "TS117", "CL201"}
    assert res.stdout.splitlines()[0].startswith(str(tmp_path))


def test_list_rules_and_import_load_no_jax():
    code = (
        "import sys\n"
        "from cylon_tpu_torch.analysis.__main__ import main\n"
        "rc = main(['--list-rules'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cylon_tpu'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(rc)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    rules = {ln.split()[0] for ln in res.stdout.splitlines()
             if ln[:2] in ("TS", "CX", "CL", "RT")}
    assert {"TS101", "TS117", "CX401", "CX404", "CL201", "CL202",
            "RT301", "RT302", "RT303"} <= rules
    assert not rules & {"TS102", "TS103", "TS104", "TS106", "TS108",
                        "JX203", "JX204"}
    assert "LOADED []" in res.stdout


# ---------------------------------------------------------------------------
# (f, g, h) the runtime sentinel
# ---------------------------------------------------------------------------

@pytest.fixture
def armed():
    runtime.enable()
    runtime.reset()
    yield runtime.state()
    runtime.disable()


def test_transfer_scope_counts_funnel_pulls():
    import torch
    from cylon_tpu_torch.utils.host import host_array, host_arrays
    assert not runtime.ACTIVE
    with runtime.transfer_scope() as ledger:
        assert runtime.ACTIVE
        host_array(torch.arange(8))
        host_array(np.arange(8))            # already host: no pull
        host_arrays([torch.arange(3), None, np.arange(2)])
    assert not runtime.ACTIVE
    assert dict(ledger) == {"host_array": 1, "host_arrays": 1}
    sites = {site.split(":")[0] for _kind, site in ledger.sites}
    assert sites == {"<outside cylon_tpu_torch>"}


def test_pipelined_join_pull_budget():
    """The reference's budget (tests/test_pipeline.py, overlap on): at
    most 3 more funnel pulls at n_chunks 6 than at n_chunks 3, every pull
    at a site inside the package."""
    rng = np.random.default_rng(0)
    n = 4096
    env = pct.CylonEnv(VirtualMeshConfig(4), device="cpu")
    lt = pct.Table.from_pydict(
        {"k": rng.integers(0, 2000, n).astype(np.int64),
         "a": rng.integers(0, 50, n).astype(np.int64)}, env)
    rt = pct.Table.from_pydict(
        {"k": rng.integers(0, 2000, n).astype(np.int64),
         "b": rng.integers(0, 50, n).astype(np.int64)}, env)

    def pulls(nc):
        with runtime.transfer_scope() as ledger:
            pct.pipelined_join(lt, rt, "k", "k", how="inner", n_chunks=nc)
        assert all(site.startswith(("exec/", "relational/", "parallel/",
                                    "ops/", "core/"))
                   for _k, site in ledger.sites), dict(ledger.sites)
        return sum(ledger.values())

    p3, p6 = pulls(3), pulls(6)
    assert 0 < p3 and p6 - p3 <= 3, (p3, p6)
    assert runtime.check_transfers(runtime.TransferLedger(), 0, "x") == []


def test_armed_state_counts_pulls_by_site(armed):
    import torch
    from cylon_tpu_torch.utils.host import host_array
    host_array(torch.arange(4))
    assert sum(armed.pulls.values()) == 1
    runtime.disable()
    host_array(torch.arange(4))
    assert not runtime.ACTIVE and sum(armed.pulls.values()) == 1


def test_rt301_rt302_through_compile_tier(armed, tmp_path, monkeypatch):
    from cylon_tpu_torch.exec import compiler
    monkeypatch.setattr(compiler, "_LEDGER", {})
    code = ("import sys\na = sys.argv\n"
            "open(a[a.index('-o') + 1], 'wb').write(b'lib')")

    def job(label, sig):
        target = str(tmp_path / f"lib{label}-{sig}.so")
        tmp = target + ".tmp"
        return compiler.Job(label, sig, [sys.executable, "-c", code, "-o",
                                         tmp], tmp, target)

    compiler.build_all([job("k1", "aa"), job("k2", "bb")])
    assert runtime.check_budgets() == []
    compiler.build_all([job("k1", "aa")])           # the same digest again
    assert [r for r, _s, _m in runtime.check_budgets()] == ["RT301"]
    compiler.build_all([job("k3", "cc"), job("k4", "dd")])
    assert [r for r, _s, _m in runtime.check_budgets()] == [
        "RT301", "RT302"]
    assert runtime.check_budgets(build_budget=4) == [
        r for r in runtime.check_budgets() if r[0] == "RT301"]


def test_collective_log_digest_and_cl202(armed):
    for e in (("exchange.counts", "all_gather", "torch.int64", 2),
              ("exchange.all_to_all", "all_to_all", "torch.int32", 2)):
        runtime.note_collective(*e)
    d1, log1 = runtime.collective_digest(), runtime.collective_log()
    runtime.reset()
    for e in log1:
        runtime.note_collective(*e)
    assert runtime.collective_digest() == d1 and len(log1) == 2
    log2 = [log1[0], ("exchange.all_to_all", "all_to_all", "torch.int64",
                      2)]
    assert collective_check.compare_logs({0: log1, 1: list(log1)}) == []
    got = collective_check.compare_logs({0: log1, 1: log2, 2: log1[:1]})
    assert [(f.rule, f.path, f.line) for f in got] == [
        ("CL202", "process1", 1), ("CL202", "process2", 1)]
    assert "logged 2 collectives, process 2 1" in got[1].message


def test_sync_scope_attributes_by_site(monkeypatch):
    """The stray-sync count: each sync warning counted at the innermost
    package frame, the funnel's own apart; on this CUDA-less build the
    mode cannot be set and the scope raises (no fallback)."""
    import torch
    with pytest.raises(RuntimeError, match="no fallback"):
        with runtime.sync_scope():
            pass
    mode = [0]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__(0, 1 if m == "warn"
                                                   else m))
    src = "def f():\n    warnings.warn('called a synchronizing CUDA " \
          "operation')\n"
    fake = {}
    for rel in ("ops/fake.py", "utils/host.py"):
        ns = {"warnings": warnings}
        exec(compile(src, os.path.join(PKG, rel), "exec"), ns)
        fake[rel] = ns["f"]
    with runtime.sync_scope() as counts:
        fake["ops/fake.py"]()
        fake["ops/fake.py"]()
        fake["utils/host.py"]()
        warnings.warn("called a synchronizing CUDA operation")
    assert mode[0] == 0
    assert dict(counts) == {"ops/fake.py:2": 2,
                            "<outside cylon_tpu_torch>": 1}
    assert dict(counts.funnel) == {"utils/host.py:2": 1}
