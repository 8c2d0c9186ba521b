"""Pass 1 — the port's per-file AST lint (port of
``cylon_tpu/analysis/ast_lint.py``), rules TS1xx.

The port is eager PyTorch: it traces no program and jits nothing, so the
reference's traced-region rules have no counterpart (ROADMAP.md "No
counterpart, by decision": TS102, TS103, TS104, TS106, TS108).  What
stays are the facade rules, each keyed to the port's own paths and
names, and three rules reworded for eager code:

* **TS101** a synchronizing host read — ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()`` of a value that is not plainly numpy,
  ``torch.nonzero``, or ``np.asarray``/``np.array`` of a ``torch``
  expression — in ``ops/``, ``relational/``, ``parallel/``, ``exec/``,
  ``stream/`` or ``topo/``, outside the modules that move bytes by
  design: the pull funnel (``utils/host.py``, which counts every pull for
  the runtime sentinel), the transport (``parallel/transport.py``), the
  spill tier (``exec/memory.py``) and the checkpoint pages
  (``exec/checkpoint.py``).  On the card each such read waits for the
  device; through the funnel the wait is named and counted.
* **TS105** OOM classified by message text outside
  ``exec/recovery.py``, the port's fault taxonomy.
* **TS117** a raw kernel build or library load — a subprocess naming
  ``nvcc``/``g++`` (or another C compiler), ``ctypes.CDLL``/
  ``LoadLibrary``, ``torch.utils.cpp_extension.load*`` or
  ``torch.compile`` — outside the compile tier (``exec/compiler.py``,
  ``kernels/__init__.py``, ``native/__init__.py``), whose ledger,
  manifest, intent journal and watchdog must see every build.

The facade rules (the reference's semantics, the port's paths): TS107
checkpoint artifacts, TS109 ledger admission, TS110 streaming state,
TS111 foreign rank directories, TS112 module-level counter tables
(``cylon_tpu_torch/obs/`` exempt), TS113 plan-node stack, TS114 spill
pages, TS115 the skew plan (``relational/skew.py``), TS116 the topology
plan (``cylon_tpu_torch/topo/``), TS118 the integrity facade.

The pass is heuristic by design (a linter, not a verifier); a residual
false positive is silenced with ``# tracecheck: off[RULE]`` and a reason
(:mod:`.rules`).
"""

from __future__ import annotations

import ast
import os
import re

from .rules import Finding, filter_suppressed

_NUMPY_MODULES = {"np", "numpy", "onp"}

#: TS101: the directories whose modules may not read the device
#: directly, and the modules that move bytes by design (path suffixes)
_SYNC_DIRS = ("ops", "relational", "parallel", "exec", "stream", "topo")
_SYNC_OK_FILES = ("utils/host.py", "parallel/transport.py",
                  "exec/memory.py", "exec/checkpoint.py")
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_NUMPY_SYNC_ATTRS = {"asarray", "array", "ascontiguousarray"}

#: TS105: OOM message fragments, and the one module that may match them
_OOM_TEXT_MARKERS = ("resource_exhausted", "out of memory")
_RECOVERY_MODULE = "exec/recovery.py"

#: TS107: checkpoint artifacts belong to exec/checkpoint.py
_CKPT_PIPELINE_FILE = "exec/pipeline.py"
_CKPT_IO_LEAVES = {"save", "savez", "savez_compressed", "load",
                   "dump", "dumps", "loads"}
_IO_ROOTS = _NUMPY_MODULES | {"pickle", "torch"}

#: TS111: the one module that may read another rank's checkpoint dir
_CKPT_SANCTIONED_FILE = "exec/checkpoint.py"
_RANK_DIR_LITERAL = re.compile(r"(^|/)rank(\d|\{|%|$)")

#: TS109: ledger admission/eviction, callable only from the scheduler and
#: the ledger itself
_ADMISSION_FUNCS = {"ensure_headroom", "try_free", "spill_for_retry",
                    "evict_n", "evict_until"}
_ADMISSION_OK_FILES = ("exec/scheduler.py", "exec/memory.py")

#: TS110: a GroupBySink's partial state and the window-lifetime entry
#: points belong to the stream package (and the defining modules)
_SINK_STATE_ATTRS = {"_parts", "_regs", "_adopted", "_pending"}
_SINK_MUTATORS = {"append", "extend", "insert", "clear", "pop", "remove"}
_WINDOW_LIFETIME_FUNCS = {"register_window", "evict_release"}
_STREAM_OK_FILES = ("exec/pipeline.py", "exec/memory.py")

#: TS112: module-level counter tables route through obs/metrics
_STATS_NAME_RE = re.compile(r"^_?[A-Z0-9_]*(STATS|COUNTERS|METRICS)$")
_OBS_PKG_PAIR = "/cylon_tpu_torch/obs/"

#: TS113: the plan-node stack primitives
_PLAN_STACK_FUNCS = {"push_node", "pop_node"}
_PLAN_DIRS = ("relational", "exec", "stream")

#: TS114: spill pages belong to exec/memory.py
_SPILL_SANCTIONED_FILE = "exec/memory.py"
_SPILL_PAGE_RE = re.compile(r"\.spill(\.|$)")

#: TS115: the skew plan facade
_SKEW_FACADE_FILE = "relational/skew.py"
_SKEW_PLAN_FUNCS = {"skew_split_targets", "skew_plan_consensus",
                    "SkewPlan"}
_SKEW_PLAN_FIELDS = {"fanout", "chunk", "start", "home", "src_off"}

#: TS116: the topology facade (a qualified package pair)
_TOPO_PKG_PAIR = "/cylon_tpu_torch/topo/"
_TOPO_PLAN_FUNCS = {"topo_plan_consensus", "TopologyPlan", "hop_counts",
                    "gateway_of"}
_TOPO_PLAN_FIELDS = {"n_slices", "ranks_per_slice", "route", "gateway"}

#: TS117: the compile tier, and what a raw build or load looks like
_BUILD_OK_FILES = ("exec/compiler.py", "kernels/__init__.py",
                   "native/__init__.py")
_SUBPROCESS_LEAVES = {"run", "Popen", "call", "check_call",
                      "check_output", "system"}
_COMPILER_RE = re.compile(
    r"(^|[/\s])(nvcc|g\+\+|gcc|c\+\+|cc|clang|clang\+\+)(\s|$)")
_LOAD_LEAVES = {"CDLL", "PyDLL", "LoadLibrary"}

#: TS118: the integrity facade's primitives, from the operator dirs
_INTEGRITY_DIRS = ("relational", "parallel", "topo")
_INTEGRITY_FUNCS = {"table_fingerprint", "partition_fingerprint",
                    "fingerprint_consensus", "_fingerprint_fn"}


def _func_name(node: ast.expr) -> str:
    """Dotted name of a call target ('torch.nonzero', 'x.item', ...)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _root_name(node) -> str | None:
    """The name at the bottom of a call/attribute/subscript chain."""
    while isinstance(node, (ast.Call, ast.Attribute, ast.Subscript)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


class _Nodes:
    """Every node of a module bucketed by kind, from one walk."""

    def __init__(self, tree: ast.Module):
        self.calls, self.assigns, self.handlers = [], [], []
        self.raises, self.funcs = [], []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                self.calls.append(node)
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                self.assigns.append(node)
            elif isinstance(node, ast.ExceptHandler):
                self.handlers.append(node)
            elif isinstance(node, ast.Raise):
                self.raises.append(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.funcs.append(node)


def _targets(node) -> list:
    return node.targets if isinstance(node, ast.Assign) else [node.target]


class _ModuleLint:
    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.norm = path.replace(os.sep, "/")
        self.parts = self.norm.split("/")
        self.tree = tree
        self.nodes = _Nodes(tree)
        self.findings: list[Finding] = []

    def _in_dirs(self, dirs) -> bool:
        return any(d in self.parts for d in dirs)

    def _in_pkg(self, pair: str) -> bool:
        return pair in "/" + self.norm

    def _emit(self, rule: str, node, msg: str) -> None:
        self.findings.append(
            Finding(rule, self.path, getattr(node, "lineno", 0), msg))

    def run(self) -> list[Finding]:
        for check in (self._check_host_sync, self._check_oom_stringmatch,
                      self._check_ckpt_artifacts,
                      self._check_direct_admission,
                      self._check_foreign_rank_read,
                      self._check_stream_state, self._check_stats_dicts,
                      self._check_plan_stack, self._check_spill_file_io,
                      self._check_skew_plan, self._check_topo_plan,
                      self._check_raw_build, self._check_integrity_facade):
            check()
        return self.findings

    # -- TS101 -------------------------------------------------------------
    def _check_host_sync(self) -> None:
        """TS101: a synchronizing host read outside the funnel (module
        docstring).  ``.item()``/``.tolist()`` of a value built by numpy
        (``np.asarray(x).tolist()``) is a host value already and does not
        fire; neither does ``np.asarray`` of anything but a ``torch``
        expression, which the AST cannot type."""
        if not self._in_dirs(_SYNC_DIRS) or self.norm.endswith(
                _SYNC_OK_FILES):
            return
        for node in self.nodes.calls:
            fname = _func_name(node.func)
            func = node.func
            if (isinstance(func, ast.Attribute)
                    and func.attr in _SYNC_METHODS
                    and not node.args and not node.keywords
                    and _root_name(func.value) not in _NUMPY_MODULES):
                self._emit(
                    "TS101", node,
                    f"`.{func.attr}()` reads a tensor on the host outside "
                    "the utils/host.py funnel — on the card it waits for "
                    "the device; pull through host_array/host_arrays/"
                    "sync_pull so the wait is named and counted (RT303)")
            elif fname == "torch.nonzero":
                self._emit(
                    "TS101", node,
                    "`torch.nonzero` sizes its output from the data and "
                    "waits for the device — outside the utils/host.py "
                    "funnel the wait is unnamed and uncounted")
            elif (isinstance(func, ast.Attribute)
                  and _root_name(func) in _NUMPY_MODULES
                  and func.attr in _NUMPY_SYNC_ATTRS and node.args
                  and _root_name(node.args[0]) == "torch"):
                self._emit(
                    "TS101", node,
                    f"`{fname}` of a torch expression pulls it to the host "
                    "outside the utils/host.py funnel")

    # -- TS105 -------------------------------------------------------------
    def _check_oom_stringmatch(self) -> None:
        """TS105: OOM classification by message text inside an ``except``
        handler — sanctioned only in exec/recovery.py, which owns the
        typed fault taxonomy (``classify``/``is_oom``) and the consensus
        retry ladder."""
        if self.norm.endswith(_RECOVERY_MODULE):
            return
        seen: set[tuple[int, int]] = set()
        for handler in self.nodes.handlers:
            for sub in ast.walk(handler):
                if not (isinstance(sub, ast.Compare) and len(sub.ops) == 1
                        and isinstance(sub.ops[0], (ast.In, ast.NotIn))):
                    continue
                left = sub.left
                if (isinstance(left, ast.Constant)
                        and isinstance(left.value, str)
                        and any(m in left.value.lower()
                                for m in _OOM_TEXT_MARKERS)):
                    key = (sub.lineno, sub.col_offset)
                    if key in seen:
                        continue        # nested handlers walk it again
                    seen.add(key)
                    self._emit(
                        "TS105", sub,
                        f"except handler classifies OOM by string-matching "
                        f"({left.value!r}) — use the typed fault taxonomy "
                        "(cylon_tpu_torch.exec.recovery.classify / is_oom);"
                        " ad-hoc matching bypasses the rank-coherent "
                        "recovery ladder")

    # -- TS107 / TS111 / TS114 ------------------------------------------------
    def _is_io(self, fname: str) -> bool:
        parts = fname.split(".")
        return fname == "open" or (parts[-1] in _CKPT_IO_LEAVES
                                   and parts[0] in _IO_ROOTS)

    def _check_ckpt_artifacts(self) -> None:
        """TS107: ``open``/``np.save``/``torch.save``/``pickle.*`` of a
        checkpoint-directory path in ``relational/`` or
        ``exec/pipeline.py`` — durable artifacts outside
        exec/checkpoint.py carry no page hash and skip the two-phase
        rank-coherent manifest commit."""
        if not ("relational" in self.parts
                or self.norm.endswith(_CKPT_PIPELINE_FILE)):
            return
        for node in self.nodes.calls:
            fname = _func_name(node.func)
            if self._is_io(fname) and _mentions_ckpt_path(node):
                self._emit(
                    "TS107", node,
                    f"`{fname}` writes/reads a checkpoint artifact outside "
                    "exec/checkpoint.py — durable piece state goes through "
                    "the checkpoint Stage (content-hashed pages, two-phase "
                    "rank-coherent manifest commit)")

    def _check_foreign_rank_read(self) -> None:
        """TS111: a ``rank<r>`` checkpoint path built off the ckpt dir
        outside exec/checkpoint.py, whose re-shard path is the one
        cross-rank reader (sha-verified pages, the manifest generation,
        the resume vote)."""
        if self.norm.endswith(_CKPT_SANCTIONED_FILE):
            return
        for node in self.nodes.calls:
            if _mentions_ckpt_path(node) and _mentions_rank_dir(node):
                self._emit(
                    "TS111", node,
                    f"`{_func_name(node.func)}` constructs a rank<r> "
                    "checkpoint path outside exec/checkpoint.py — foreign "
                    "rank directories are read only by the re-shard path "
                    "(Stage.load_foreign_pieces), which sha-verifies pages, "
                    "resolves the manifest generation and votes the "
                    "adoption")

    def _check_spill_file_io(self) -> None:
        """TS114: spill page IO or a spill path build outside
        exec/memory.py (pages hashed at demote, verified at promote,
        retried and counted only behind the ledger)."""
        if self.norm.endswith(_SPILL_SANCTIONED_FILE):
            return
        for node in self.nodes.calls:
            fname = _func_name(node.func)
            if ((self._is_io(fname) or fname.split(".")[-1] == "join")
                    and _mentions_spill_path(node)):
                self._emit(
                    "TS114", node,
                    f"`{fname}` constructs or touches a spill page file "
                    "outside exec/memory.py — disk-tier pages are hashed, "
                    "retried and accounted only behind the ledger facade "
                    "(demote/promote_host/upload_window)")

    # -- TS109 -------------------------------------------------------------
    def _check_direct_admission(self) -> None:
        """TS109: a ledger admission/eviction entry point called outside
        exec/scheduler.py and exec/memory.py — admission goes through
        the scheduler's facades (admit_allocation / free_pressure /
        spill_retry) so per-tenant footprints stay attributed."""
        if self.norm.endswith(_ADMISSION_OK_FILES):
            return
        for node in self.nodes.calls:
            fname = _func_name(node.func)
            if fname.split(".")[-1] in _ADMISSION_FUNCS:
                self._emit(
                    "TS109", node,
                    f"`{fname}` calls a ledger admission/eviction entry "
                    "point directly — admission is scheduler-mediated "
                    "(cylon_tpu_torch.exec.scheduler.admit_allocation / "
                    "free_pressure / spill_retry)")

    # -- TS110 -------------------------------------------------------------
    def _check_stream_state(self) -> None:
        """TS110: a GroupBySink's partial state written or mutated, or the
        window-lifetime entry points called, outside
        cylon_tpu_torch/stream/ and the defining modules."""
        if "stream" in self.parts or self.norm.endswith(_STREAM_OK_FILES):
            return
        for node in self.nodes.assigns:
            for tgt in _targets(node):
                if (isinstance(tgt, ast.Attribute)
                        and tgt.attr in _SINK_STATE_ATTRS):
                    self._emit(
                        "TS110", node,
                        f"write to sink partial state `.{tgt.attr}` "
                        "outside cylon_tpu_torch/stream/ — go through the "
                        "GroupBySink absorb/snapshot API")
        for node in self.nodes.calls:
            fname = _func_name(node.func)
            func = node.func
            if fname.split(".")[-1] in _WINDOW_LIFETIME_FUNCS:
                self._emit(
                    "TS110", node,
                    f"`{fname}` manages window-lifetime ledger state "
                    "outside cylon_tpu_torch/stream/ — window buffers are "
                    "registered at append and retired by the watermark "
                    "close (device → host → released)")
            elif (isinstance(func, ast.Attribute)
                  and func.attr in _SINK_MUTATORS
                  and isinstance(func.value, ast.Attribute)
                  and func.value.attr in _SINK_STATE_ATTRS):
                self._emit(
                    "TS110", node,
                    f"mutation of sink partial state "
                    f"`.{func.value.attr}.{func.attr}()` outside "
                    "cylon_tpu_torch/stream/")

    # -- TS112 -------------------------------------------------------------
    def _check_stats_dicts(self) -> None:
        """TS112: a module-level dict literal (or ``dict()`` call) bound
        to a counter-table name (``*STATS``/``*COUNTERS``/``*METRICS``)
        outside cylon_tpu_torch/obs/.  A ``metrics.group(...)`` view
        under the same name is the sanctioned form and does not fire."""
        if self._in_pkg(_OBS_PKG_PAIR):
            return
        for node in self.tree.body:
            if isinstance(node, ast.AnnAssign):
                targets = [node.target] if node.value is not None else []
            elif isinstance(node, ast.Assign):
                targets = node.targets
            else:
                continue
            value = node.value
            if not (isinstance(value, (ast.Dict, ast.DictComp))
                    or (isinstance(value, ast.Call)
                        and _func_name(value.func) == "dict")):
                continue
            for tgt in targets:
                if (isinstance(tgt, ast.Name)
                        and _STATS_NAME_RE.match(tgt.id)):
                    self._emit(
                        "TS112", node,
                        f"module-level mutable counter table `{tgt.id}` "
                        "outside cylon_tpu_torch/obs/ — route counters "
                        "through the metrics registry (cylon_tpu_torch.obs."
                        "metrics counter/group/namespace) so exposition, "
                        "snapshots and bench_detail see every counter")

    # -- TS113 -------------------------------------------------------------
    def _check_plan_stack(self) -> None:
        """TS113: ``push_node``/``pop_node`` called in relational/, exec/
        or stream/ — plan nodes open through ``plan.node(...)``/
        ``plan.annotate(...)``, whose balanced enter/exit keeps the
        query's node stack whole across fault unwinds."""
        if not self._in_dirs(_PLAN_DIRS) or self._in_pkg(_OBS_PKG_PAIR):
            return
        for node in self.nodes.calls:
            fname = _func_name(node.func)
            if fname.split(".")[-1] in _PLAN_STACK_FUNCS:
                self._emit(
                    "TS113", node,
                    f"`{fname}` manipulates the plan-node stack directly — "
                    "open plan nodes through the cylon_tpu_torch.obs.plan "
                    "context-manager facade (plan.node(...) / "
                    "plan.annotate(...))")

    # -- TS115 / TS116 -------------------------------------------------------
    def _check_skew_plan(self) -> None:
        """TS115: the split-targets primitive, the plan vote or the
        ``SkewPlan`` constructor called, or a plan's salted split-set
        field assigned, outside relational/skew.py."""
        if self.norm.endswith(_SKEW_FACADE_FILE):
            return
        for node in self.nodes.calls:
            fname = _func_name(node.func)
            if fname.split(".")[-1] in _SKEW_PLAN_FUNCS:
                self._emit(
                    "TS115", node,
                    f"`{fname}` makes a skew-plan decision outside the "
                    "relational/skew.py plan facade — go through detect/"
                    "finalize_or_none/adopt/split_exchange so every rank "
                    "enters one voted exchange plan")
        for node in self.nodes.assigns:
            for t in _targets(node):
                if (isinstance(t, ast.Attribute)
                        and t.attr in _SKEW_PLAN_FIELDS
                        and isinstance(t.value, ast.Name)
                        and "plan" in t.value.id.lower()):
                    self._emit(
                        "TS115", node,
                        f"assignment to `{t.value.id}.{t.attr}` mutates a "
                        "SkewPlan's salted split set outside the "
                        "relational/skew.py facade — a post-vote mutation "
                        "desyncs the plan hash the ranks agreed on")

    def _check_topo_plan(self) -> None:
        """TS116: the plan vote, the ``TopologyPlan`` constructor or the
        hop-count/gateway primitives called, or a plan's tier fields
        assigned, outside cylon_tpu_torch/topo/."""
        if self._in_pkg(_TOPO_PKG_PAIR):
            return
        for node in self.nodes.calls:
            fname = _func_name(node.func)
            if fname.split(".")[-1] in _TOPO_PLAN_FUNCS:
                self._emit(
                    "TS116", node,
                    f"`{fname}` makes a topology decision outside the "
                    "cylon_tpu_torch/topo plan facade — go through "
                    "topology/hier_plan/ensure_adopted/two_hop so every "
                    "rank routes one voted hop plan")
        for node in self.nodes.assigns:
            for t in _targets(node):
                if (isinstance(t, ast.Attribute)
                        and t.attr in _TOPO_PLAN_FIELDS
                        and isinstance(t.value, ast.Name)
                        and ("topo" in t.value.id.lower()
                             or "plan" in t.value.id.lower())):
                    self._emit(
                        "TS116", node,
                        f"assignment to `{t.value.id}.{t.attr}` mutates a "
                        "TopologyPlan's tier map outside the "
                        "cylon_tpu_torch/topo facade — a post-vote "
                        "mutation desyncs the plan hash and the hop "
                        "groups' membership")

    # -- TS117 -------------------------------------------------------------
    def _check_raw_build(self) -> None:
        """TS117: a raw kernel build or library load outside the compile
        tier (module docstring)."""
        if self.norm.endswith(_BUILD_OK_FILES):
            return
        for node in self.nodes.calls:
            fname = _func_name(node.func)
            parts = fname.split(".")
            leaf = parts[-1]
            what = None
            if leaf in _LOAD_LEAVES and (len(parts) == 1 or {
                    "ctypes", "cdll"} & set(parts[:-1])):
                what = "a raw library load"
            elif "cpp_extension" in parts[:-1] and leaf.startswith("load"):
                what = "a raw torch extension build"
            elif fname == "torch.compile":
                what = "a torch.compile program"
            elif (leaf in _SUBPROCESS_LEAVES
                  and (parts[0] in ("subprocess", "os") or leaf == "Popen")
                  and _mentions_compiler(node)):
                what = "a raw compiler subprocess"
            if what is not None:
                self._emit(
                    "TS117", node,
                    f"`{fname}` is {what} outside the compile tier — build "
                    "and load through kernels.build/load or native/ "
                    "(exec/compiler.build_all, admit) so the ledger, the "
                    "sha256 manifest, the intent journal and the watchdog "
                    "see it")

    # -- TS118 -------------------------------------------------------------
    def _check_integrity_facade(self) -> None:
        """TS118: a fingerprint primitive called, or ``DataIntegrityError``
        constructed or raised, in relational/, parallel/ or topo/ — the
        exec/integrity verbs vote the fingerprint before any
        raise/proceed decision and count every check."""
        if not self._in_dirs(_INTEGRITY_DIRS):
            return
        for node in self.nodes.calls:
            fname = _func_name(node.func)
            last = fname.split(".")[-1]
            if last in _INTEGRITY_FUNCS:
                self._emit(
                    "TS118", node,
                    f"`{fname}` computes or votes a content fingerprint "
                    "outside the exec/integrity audit facade — use its "
                    "verbs (verify_exchange/audit_table/"
                    "audit_restored_table) so the vote precedes the "
                    "raise/proceed decision and the check is counted")
            elif last == "DataIntegrityError":
                self._emit(
                    "TS118", node,
                    "`DataIntegrityError` constructed outside the "
                    "exec/integrity audit facade — a rank that raises it "
                    "alone skips the consensus vote")
        for node in self.nodes.raises:
            if isinstance(node.exc, ast.Name) \
                    and node.exc.id == "DataIntegrityError":
                self._emit(
                    "TS118", node,
                    "`raise DataIntegrityError` outside the exec/integrity "
                    "audit facade")


def _strings_in(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            yield sub.value


def _mentions_rank_dir(node: ast.Call) -> bool:
    """A string literal (an f-string's literal part included) naming a
    ``rank<r>`` directory segment in the call's argument subtree."""
    return any(_RANK_DIR_LITERAL.search(s) for s in _strings_in(node))


def _mentions_spill_path(node: ast.Call) -> bool:
    """A ``.spill`` page-file literal, a ``*SPILL_DIR`` variable name or a
    ``spill_dir``-named name or attribute in the call's subtree."""
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                and ("SPILL_DIR" in sub.value
                     or _SPILL_PAGE_RE.search(sub.value))):
            return True
        if isinstance(sub, ast.Name) and "spill_dir" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) \
                and "spill_dir" in sub.attr.lower():
            return True
    return False


def _mentions_ckpt_path(node: ast.Call) -> bool:
    """The checkpoint directory (``CYLON_TPU_TORCH_CKPT_DIR`` or a
    ckpt-named name, attribute or constant) in the call's subtree."""
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                and "CKPT" in sub.value.upper()):
            return True
        if isinstance(sub, ast.Name) and "ckpt" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "ckpt" in sub.attr.lower():
            return True
    return False


def _mentions_compiler(node: ast.Call) -> bool:
    """A C/CUDA compiler named in the call's subtree: a literal whose
    word is ``nvcc``/``g++``/``gcc``/``clang``/..., or an ``nvcc``-named
    name or attribute (a helper that finds it)."""
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                and _COMPILER_RE.search(sub.value)):
            return True
        if isinstance(sub, ast.Name) and "nvcc" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "nvcc" in sub.attr.lower():
            return True
    return False


def lint_source_raw(path: str, source: str):
    """``(findings, def_spans)`` before suppression filtering:
    ``def_spans`` is ``[(lineno, end_lineno), ...]`` of every function
    def, which applying (or auditing) the suppressions needs."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("TS101", path, e.lineno or 0,
                        f"syntax error prevents linting: {e.msg}")], []
    lint = _ModuleLint(path, tree)
    raw = lint.run()
    spans = [(fn.lineno, getattr(fn, "end_lineno", fn.lineno))
             for fn in lint.nodes.funcs]
    return raw, spans


def lint_source(path: str, source: str) -> list[Finding]:
    raw, spans = lint_source_raw(path, source)
    return filter_suppressed(raw, {path: source}, {path: spans})


def lint_file(path: str) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        return lint_source(path, f.read())


def iter_py_files(paths):
    """Every ``.py`` file under the given files and directories, sorted
    within each directory."""
    for root in paths:
        if os.path.isfile(root):
            yield root
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git"))
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


def lint_paths(paths) -> list[Finding]:
    """Lint every ``.py`` file under the given files/directories."""
    findings = []
    for path in iter_py_files(paths):
        findings.extend(lint_file(path))
    return findings
