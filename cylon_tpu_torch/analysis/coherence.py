"""Pass 2 — the port's interprocedural collective-coherence analyzer
(port of ``cylon_tpu/analysis/coherence.py``), rules CX4xx.

Every vote of the port — the fault ladder's code, the spill and
checkpoint epochs, the skew and topology plan hashes, the drain, the
watermark, the scheduler's picks — exists to keep one discipline:

    *no rank-local control flow decides anything after a collective has
    been entered, and every plan vote dominates its first dependent
    collective.*

The pass is static and imports nothing of the package.

1. **Call graph.**  Every top-level function and method of the analyzed
   tree is indexed by leaf name; call edges resolve by leaf.  A call
   rooted at an outside module (``torch.from_numpy``, ``np.asarray``,
   ``os.replace``, ...) never resolves into the tree: the leaf alone
   would tie ``torch.from_numpy`` to ``Column.from_numpy``.  Each
   function is marked with whether it can *enter a data collective* and
   whether it can *enter a consensus vote*.  The seeds:

   * the transport (``parallel/transport.py``): ``all_reduce_max``,
     ``allgather_array``, ``allgather_tensor``, ``allgather_rows``,
     ``allgather_counts``, ``all_to_all_rows``, ``broadcast``,
     ``barrier`` — every ``torch.distributed`` call of the port sits in
     one of them, behind ``_guarded``;
   * the collective facades above it, so single-file fixtures resolve
     without the tree: ``parallel/shuffle.exchange`` and
     ``_exchange_procs``, ``relational/skew.split_exchange``,
     ``topo/exchange.two_hop``, the ``parallel/collectives`` table ops,
     the env's ``allgather``/``bcast``/``allreduce``;
   * the votes of ``exec/recovery.py`` (:data:`CONSENSUS_LEAVES`), each
     one ``all_reduce_max`` under the serving namespace, and the
     integrity facade's verbs, which vote a fingerprint before they
     raise or proceed.  A vote is consensus, never data.

   **The host pull funnel stays out of propagation.**  In a
   multi-process world ``utils/host.host_array`` gathers through
   ``transport.allgather_array``, so it is a collective.  Every operator
   reads its count sidecars, capacities and splitters through it, at
   points that the operator's own collectives already fix (the values
   pulled are replicated, their shapes the same in every process);
   marking each such read "between collectives" would bury the findings
   this pass exists for.  The funnel's order is held at run time
   instead: the runtime sentinel logs every collective, the funnel's
   allgathers included, and :mod:`.collective_check` (CL202) compares
   the processes' logs.  The rank report and the comm matrix
   (``obs/rank_report.py``, ``obs/comm.py``) stay out for the
   reference's reason: their allgathers fire from diagnostic paths.

2. **Taint.**  Rank-local sources: this process's index (``.pid``,
   ``.local_ranks``, ``.first``/``.ranks`` of ``transport.current()`` or
   a ``Proc``, ``env.rank``, ``dist.get_rank``), injector state
   (``recovery.probe``/``maybe_inject``/``injected``), caught
   exceptions, file IO, the wall clock, the SIGTERM latch
   (``preempt.requested``), the device's memory counters
   (``torch.cuda.mem_get_info``/``memory_allocated``/
   ``max_memory_allocated``/``memory_reserved``), and per-process shapes
   off host pulls (``len(host_array(...))``, ``host_array(...).shape``).
   Taint flows through assignments and returns.  A consensus call
   sanitizes: its result is the same everywhere.

3. **Checks** (the reference's):

   * **CX401** — a tainted ``if``/``while`` whose arms issue no data
     collective, after one data collective and before the next, with no
     vote between;
   * **CX402** — a tainted branch whose arms issue different data
     collective sequences, or a data collective under a rank-local trip
     count;
   * **CX403** — a function holding a plan vote and its dependent
     collective (:data:`VOTE_KINDS`: skew → ``split_exchange``, topo →
     ``two_hop``, ckpt commit → the manifest's ``os.replace``, drain →
     ``drain_abort``, preempt → ``_begin_preempt_drain``) must run the
     vote first and on every path to the dependent;
   * **CX404** — an untyped raise from an except handler or a tainted
     path after a data collective, with no vote between.

Known under-approximations, kept so the gate stays quiet on clean code:
taint does not flow through call arguments, ``try`` bodies are
transparent to dominance, call edges resolve by leaf name and skip a set
of generic names.  Suppression uses the shared grammar
(``# tracecheck: off[CX401]``, :mod:`.rules`).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from .rules import Finding, filter_suppressed

# --------------------------------------------------------------------------
# seeds

#: the transport's collectives (parallel/transport.py): each runs one
#: torch.distributed collective (or a pair) behind ``_guarded``
TRANSPORT_KINDS = frozenset({
    "all_reduce_max", "allgather_array", "allgather_tensor",
    "allgather_rows", "allgather_counts", "all_to_all_rows", "broadcast",
    "barrier",
})

#: the votes: exec/recovery.py's wires and the integrity facade's verbs
CONSENSUS_LEAVES = frozenset({
    "_consensus_wire", "_ns_consensus", "_min_consensus",
    "consensus_code", "guard_consensus", "spill_consensus",
    "count_consensus", "preempt_consensus", "footprint_consensus",
    "drain_consensus", "ckpt_commit_consensus", "ckpt_resume_consensus",
    "watermark_consensus", "_plan_hash_consensus", "skew_plan_consensus",
    "topo_plan_consensus", "fingerprint_consensus",
    "audit_table", "verify_exchange", "audit_restored_table",
})

#: collective facades above the transport, classed as data without the
#: tree (single-file fixtures and synthetic modules)
DATA_FACADE_LEAVES = TRANSPORT_KINDS | frozenset({
    "exchange", "_exchange_procs", "split_exchange", "two_hop",
    "allgather_table", "gather_table", "bcast_table", "allreduce",
    "allgather", "bcast",
})

#: rank-local taint sources, by the call's leaf name
SOURCE_LEAVES = frozenset({
    "probe", "maybe_inject", "injected",                  # injector state
    "perf_counter", "monotonic", "time_ns", "process_time",  # wall clock
    "open", "listdir", "stat", "scandir",                 # file IO
    "get_rank",                                           # dist.get_rank
    "mem_get_info", "memory_allocated", "max_memory_allocated",
    "memory_reserved",                                    # device memory
})

#: sources that need a dotted qualifier (the bare leaf is too generic)
SOURCE_QUALIFIED = frozenset({
    "time.time", "os.path.exists", "os.path.isfile", "os.path.getsize",
    "os.path.getmtime", "os.path.islink", "preempt.requested",
})

#: attribute reads that name this process: anywhere (``pid``,
#: ``local_ranks``), off a process handle (``first``, ``ranks``) or off
#: an env (``rank``)
_INDEX_ATTRS = frozenset({"pid", "local_ranks"})
_PROC_INDEX_ATTRS = frozenset({"first", "ranks"})
_PROC_CTORS = frozenset({"current", "Proc"})

#: host-pull funnels: ``len(host_array(...))``/``host_array(..).shape``
#: taint (per-process shapes); the pulled values do not
_HOST_PULL_LEAVES = frozenset({"host_array", "host_arrays",
                               "host_shard_blocks"})

#: leaf names too generic to resolve through the call graph
_GENERIC_LEAVES = frozenset({
    "close", "flush", "write", "read", "get", "put", "update", "reset",
    "clear", "copy", "items", "keys", "values", "append", "add", "pop",
    "extend", "join", "split", "run", "start", "stop", "send", "next",
})

#: modules outside the package: a call rooted at one of them is theirs
_OUTSIDE_ROOTS = frozenset({
    "torch", "np", "numpy", "dist", "os", "sys", "math", "time", "json",
    "pickle", "hashlib", "threading", "ctypes", "shutil", "subprocess",
    "warnings", "itertools", "functools", "collections", "re", "io",
    "struct", "random", "tempfile", "signal", "contextlib", "operator",
    "datetime", "bisect", "heapq", "queue", "weakref", "gc", "zlib",
    "atexit", "copy", "traceback", "inspect", "socket", "platform",
    "glob", "errno", "logging", "pathlib", "secrets", "string",
    "statistics", "binascii", "base64", "mmap", "multiprocessing",
    "concurrent", "argparse", "uuid", "array",
})

#: CX403's vote-dominance contract: per plan kind, the votes (and the
#: facades that take them) and the dependent collectives whose shape the
#: vote decides; a dotted spec matches the call path at a dot boundary
VOTE_KINDS = {
    "skew": {
        "votes": frozenset({"skew_plan_consensus", "adopt"}),
        "deps": frozenset({"split_exchange", "skew_split_targets"}),
    },
    "topo": {
        "votes": frozenset({"topo_plan_consensus", "ensure_adopted"}),
        "deps": frozenset({"two_hop"}),
    },
    "ckpt": {
        "votes": frozenset({"ckpt_commit_consensus"}),
        "deps": frozenset({"os.replace"}),
    },
    "drain": {
        "votes": frozenset({"drain_consensus", "drain_requested"}),
        "deps": frozenset({"drain_abort"}),
    },
    "preempt": {
        "votes": frozenset({"preempt_consensus"}),
        "deps": frozenset({"_begin_preempt_drain"}),
    },
}

#: the port's typed faults (cylon_tpu_torch/status.py); the harvest adds
#: every subclass found in the analyzed tree
DEFAULT_TYPED_STATUS = frozenset({
    "CylonError", "InvalidError", "PredictedResourceExhausted",
    "DeviceOOMError", "CapacityOverflowError", "RankDesyncError",
    "ResumableAbort", "CheckpointCorruptError", "CylonTypeError",
    "CylonKeyError", "CylonIndexError", "CylonIOError",
    "NotImplementedCylonError", "ExecutionError",
    "AdmissionTimeoutError", "RequeueOverflowError", "KernelError",
    "DeviceUnavailableError", "DataIntegrityError",
    "CompileQuarantinedError", "CompileTimeoutError",
})

#: modules whose collectives never propagate to callers (module
#: docstring)
_NO_PROPAGATE_SUFFIXES = ("utils/host.py", "obs/comm.py",
                          "obs/rank_report.py")

#: Python builtins: a bare call is the builtin and never resolves
_PY_BUILTINS = frozenset({
    "max", "min", "sum", "abs", "len", "sorted", "any", "all", "map",
    "filter", "round", "hash", "id", "iter", "print", "repr", "str",
    "int", "float", "bool", "list", "dict", "set", "tuple", "type",
    "getattr", "setattr", "hasattr", "isinstance", "enumerate", "zip",
    "range", "format", "divmod",
})


# --------------------------------------------------------------------------
# small AST helpers

def _call_name(node: ast.Call) -> str:
    """Dotted name of the call target ('' when not a name chain)."""
    parts = []
    t = node.func
    while isinstance(t, ast.Attribute):
        parts.append(t.attr)
        t = t.value
    if isinstance(t, ast.Name):
        parts.append(t.id)
    elif not parts:
        return ""
    return ".".join(reversed(parts))


def _leaf(fname: str) -> str:
    return fname.rsplit(".", 1)[-1]


def _outside(fname: str) -> bool:
    """A dotted call rooted at a module outside the package."""
    return "." in fname and fname.split(".", 1)[0] in _OUTSIDE_ROOTS


def _matches_spec(fname: str, spec: str) -> bool:
    """Dotted specs match at a dot boundary; bare specs match the leaf."""
    if "." in spec:
        return fname == spec or fname.endswith("." + spec)
    return _leaf(fname) == spec


def _calls_in(node: ast.AST):
    """Every call under ``node``, nested function defs skipped (their
    bodies run at their own call sites); lambdas included (applied in
    place: retry thunks, key functions)."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and n is not node:
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


def _names_in(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            yield n.id


def _target_roots(target: ast.AST):
    """Root names bound by an assignment target (tuple-aware)."""
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _target_roots(elt)
    elif isinstance(target, ast.Starred):
        yield from _target_roots(target.value)
    elif isinstance(target, (ast.Attribute, ast.Subscript)):
        t = target
        while isinstance(t, (ast.Attribute, ast.Subscript)):
            t = t.value
        if isinstance(t, ast.Name):
            yield t.id


def _last_name(node) -> str:
    """The last name of an attribute chain (``self.env`` → ``env``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _harvest_typed_status(trees) -> frozenset[str]:
    """DEFAULT_TYPED_STATUS plus every class in the analyzed tree whose
    base chain reaches a typed name."""
    typed = set(DEFAULT_TYPED_STATUS)
    classes = []
    for tree in trees:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                bases = {b.id if isinstance(b, ast.Name) else b.attr
                         for b in node.bases
                         if isinstance(b, (ast.Name, ast.Attribute))}
                classes.append((node.name, bases))
    for _ in range(3):
        grew = False
        for name, bases in classes:
            if name not in typed and bases & typed:
                typed.add(name)
                grew = True
        if not grew:
            break
    return frozenset(typed)


# --------------------------------------------------------------------------
# function index + call graph

@dataclass
class FuncInfo:
    qualname: str                  # module-relative: Class.method / func
    path: str
    node: ast.AST
    leaf: str = ""
    #: leaf names of the calls this body may resolve into the tree
    calls: frozenset = frozenset()
    no_propagate: bool = False
    enters_data: bool = False
    enters_consensus: bool = False
    returns_tainted: bool = False


def _index_functions(path: str, tree: ast.Module, no_propagate: bool):
    """Top-level functions and class methods; a nested def's calls count
    for its enclosing function (a per-shard closure issuing a collective
    makes its enclosing function collective-entering)."""
    out = []

    def add(node, prefix=""):
        leaves = set()
        for call in ast.walk(node):
            if isinstance(call, ast.Call):
                fname = _call_name(call)
                if fname and not _outside(fname):
                    leaves.add(_leaf(fname))
        out.append(FuncInfo(qualname=prefix + node.name, path=path,
                            node=node, leaf=node.name,
                            calls=frozenset(leaves),
                            no_propagate=no_propagate))

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            add(node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    add(sub, prefix=node.name + ".")
    return out


def _resolvable(leaf: str) -> bool:
    return leaf not in _GENERIC_LEAVES and leaf not in _PY_BUILTINS


# --------------------------------------------------------------------------
# per-function linear scan

@dataclass
class _Site:
    order: int
    line: int
    blocks: tuple
    fname: str


@dataclass
class _BranchCheck:
    line: int
    start: int                 # event order at branch entry
    end: int                   # event order after both arms
    names: tuple               # tainted names steering the branch
    kind: str                  # 'if' | 'while' | 'for'
    arm_seqs: tuple            # (body data seq, orelse data seq)
    arm_consensus: bool        # either arm votes → sanctioned
    in_loop_data: bool         # inside a loop whose body enters data


@dataclass
class _RaiseCheck:
    line: int
    order: int
    in_handler: bool
    on_tainted_path: bool
    expr_tainted: bool
    typed: bool
    bare: bool


class _FuncScan:
    """One linear pass over a function body: taint, entering events in
    program order, branch/raise candidates, CX403 vote/dep sites."""

    def __init__(self, analyzer, info: FuncInfo):
        self.an = analyzer
        self.info = info
        self.tainted: set[str] = set()
        #: names bound to a process handle (``transport.current()``)
        self.procs: set[str] = set()
        self.order = 0
        self.events: list[tuple[int, str]] = []   # (order, kind)
        self.branches: list[_BranchCheck] = []
        self.raises: list[_RaiseCheck] = []
        self.votes: dict[str, list[_Site]] = {k: [] for k in VOTE_KINDS}
        self.deps: dict[str, list[_Site]] = {k: [] for k in VOTE_KINDS}
        self.returns_tainted = False

    def _classify(self, fname: str) -> str | None:
        return self.an.classify(fname)

    def _record_calls(self, expr, blocks):
        """Record entering events + vote/dep sites for every call in an
        expression."""
        if expr is None:
            return
        for call in self.an.calls_in(expr):
            fname = _call_name(call)
            if not fname:
                continue
            kind = self._classify(fname)
            self.order += 1
            if kind:
                self.events.append((self.order, kind))
            roles = self.an.vote_roles(fname)
            if roles:
                site = _Site(self.order, call.lineno, blocks, fname)
                for vk, role in roles:
                    (self.votes if role == "votes" else self.deps)[vk] \
                        .append(site)

    # -- taint ------------------------------------------------------------

    def _is_source_call(self, call: ast.Call) -> bool:
        fname = _call_name(call)
        if not fname:
            return False
        if _leaf(fname) in SOURCE_LEAVES:
            return True
        if any(_matches_spec(fname, q) for q in SOURCE_QUALIFIED):
            return True
        return self.an.returns_tainted(fname)

    def _is_proc(self, node) -> bool:
        if isinstance(node, ast.Call):
            return _leaf(_call_name(node)) in _PROC_CTORS
        return (isinstance(node, ast.Name) and node.id in self.procs) \
            or "proc" in _last_name(node).lower()

    def _index_read(self, node) -> bool:
        """An attribute read naming this process (module docstring)."""
        if not isinstance(node, ast.Attribute):
            return False
        if node.attr in _INDEX_ATTRS:
            return True
        if node.attr in _PROC_INDEX_ATTRS:
            return self._is_proc(node.value)
        return node.attr == "rank" and _last_name(node.value) == "env"

    def _expr_tainted(self, expr) -> bool:
        if expr is None:
            return False
        calls = list(self.an.calls_in(expr))
        # a consensus vote anywhere in the expression sanitizes it
        for call in calls:
            fname = _call_name(call)
            if fname and self._classify(fname) == "consensus":
                return False
        for name in self.an.names_in(expr):
            if name in self.tainted:
                return True
        for call in calls:
            if self._is_source_call(call):
                return True
            # per-process shape off a host pull: len(pull(...))
            if _leaf(_call_name(call)) == "len" and call.args:
                if self._has_host_pull(call.args[0]):
                    return True
        for n in self.an.attrs_in(expr):
            if self._index_read(n):
                return True
            if n.attr in ("shape", "nbytes") \
                    and self._has_host_pull(n.value):
                return True
        return False

    def _has_host_pull(self, expr) -> bool:
        return any(_leaf(_call_name(c)) in _HOST_PULL_LEAVES
                   for c in self.an.calls_in(expr))

    def _assign(self, targets, value):
        if (len(targets) == 1 and isinstance(targets[0], ast.Tuple)
                and isinstance(value, ast.Tuple)
                and len(targets[0].elts) == len(value.elts)
                and not any(isinstance(e, ast.Starred)
                            for e in targets[0].elts + value.elts)):
            # ``a, b = x, y``: each name takes its own value's taint
            for t, v in zip(targets[0].elts, value.elts):
                self._assign([t], v)
            return
        roots = [r for t in targets for r in _target_roots(t)]
        if value is not None and self._expr_tainted(value):
            self.tainted.update(roots)
        else:
            self.tainted.difference_update(roots)
        if value is not None and isinstance(value, ast.Call) \
                and self._is_proc(value):
            self.procs.update(roots)

    # -- arm summaries ----------------------------------------------------

    def _data_seq(self, stmts) -> tuple:
        """Ordered leaf names of data-entering calls in a block."""
        seq = []
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for call in self.an.calls_in(stmt):
                fname = _call_name(call)
                if fname and self._classify(fname) == "data":
                    seq.append(_leaf(fname))
        return tuple(seq)

    def _has_consensus(self, stmts) -> bool:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for call in self.an.calls_in(stmt):
                fname = _call_name(call)
                if fname and self._classify(fname) == "consensus":
                    return True
        return False

    # -- the walk ---------------------------------------------------------

    def run(self):
        self._scan(self.info.node.body, blocks=(), guard=False,
                   taintpath=False, in_handler=False, in_loop_data=False)
        return self

    def _scan(self, stmts, **kw):
        for stmt in stmts:
            self._scan_stmt(stmt, **kw)

    def _scan_stmt(self, stmt, *, blocks, guard, taintpath, in_handler,
                   in_loop_data):
        kw = dict(blocks=blocks, guard=guard, taintpath=taintpath,
                  in_handler=in_handler, in_loop_data=in_loop_data)
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.Assign):
            self._record_calls(stmt.value, blocks)
            self._assign(stmt.targets, stmt.value)
        elif isinstance(stmt, ast.AnnAssign):
            self._record_calls(stmt.value, blocks)
            self._assign([stmt.target], stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            self._record_calls(stmt.value, blocks)
            if self._expr_tainted(stmt.value):
                self.tainted.update(_target_roots(stmt.target))
        elif isinstance(stmt, ast.Expr):
            self._record_calls(stmt.value, blocks)
        elif isinstance(stmt, ast.Return):
            self._record_calls(stmt.value, blocks)
            if stmt.value is not None and self._expr_tainted(stmt.value):
                self.returns_tainted = True
        elif isinstance(stmt, ast.Raise):
            self._record_calls(stmt.exc, blocks)
            self._raise(stmt, guard=guard, taintpath=taintpath,
                        in_handler=in_handler)
        elif isinstance(stmt, ast.If):
            self._branch(stmt, stmt.body, stmt.orelse, kind="if", **kw)
        elif isinstance(stmt, ast.While):
            self._branch(stmt, stmt.body, stmt.orelse, kind="while", **kw)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._for(stmt, **kw)
        elif isinstance(stmt, ast.Try):
            self._try(stmt, **kw)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._record_calls(item.context_expr, blocks)
                if item.optional_vars is not None \
                        and self._expr_tainted(item.context_expr):
                    self.tainted.update(_target_roots(item.optional_vars))
            self._scan(stmt.body, **kw)
        else:   # assert, del, ...: the calls in child expressions
            self._record_calls(stmt, blocks)

    def _branch(self, stmt, body, orelse, *, kind, blocks, guard,
                taintpath, in_handler, in_loop_data):
        self._record_calls(stmt.test, blocks)
        test_consensus = any(
            self._classify(_call_name(c)) == "consensus"
            for c in self.an.calls_in(stmt.test) if _call_name(c))
        test_tainted = (not test_consensus
                        and self._expr_tainted(stmt.test))
        start = self.order
        arm_guard = guard or test_consensus
        arm_taint = taintpath or test_tainted
        body_in_loop = in_loop_data or (
            kind == "while" and bool(self._data_seq(body)))
        frame = (id(stmt), kind)
        self._scan(body, blocks=blocks + ((*frame, "body"),),
                   guard=arm_guard, taintpath=arm_taint,
                   in_handler=in_handler, in_loop_data=body_in_loop)
        saved = set(self.tainted)
        self._scan(orelse, blocks=blocks + ((*frame, "else"),),
                   guard=arm_guard, taintpath=arm_taint,
                   in_handler=in_handler, in_loop_data=in_loop_data)
        # a name tainted on either arm stays tainted after the join
        self.tainted |= saved
        end = self.order
        if test_tainted and not guard:
            names = tuple(sorted(self.an.names_in(stmt.test) & self.tainted))
            body_seq = self._data_seq(body)
            if kind == "while" and body_seq:
                # rank-local trip count over a data collective
                arms, voted = (body_seq, ("<loop-exit>",)), False
            else:
                arms = (body_seq, self._data_seq(orelse))
                voted = (self._has_consensus(body)
                         or self._has_consensus(orelse))
            self.branches.append(_BranchCheck(
                stmt.lineno, start, end, names, kind, arms, voted,
                in_loop_data))

    def _for(self, stmt, *, blocks, guard, taintpath, in_handler,
             in_loop_data):
        self._record_calls(stmt.iter, blocks)
        iter_tainted = self._expr_tainted(stmt.iter)
        if iter_tainted:
            self.tainted.update(_target_roots(stmt.target))
        else:
            self.tainted.difference_update(_target_roots(stmt.target))
        iter_tainted = iter_tainted and not guard
        start = self.order
        body_seq = self._data_seq(stmt.body)
        self._scan(stmt.body, blocks=blocks + ((id(stmt), "for", "body"),),
                   guard=guard, taintpath=taintpath or iter_tainted,
                   in_handler=in_handler,
                   in_loop_data=in_loop_data or bool(body_seq))
        self._scan(stmt.orelse, blocks=blocks, guard=guard,
                   taintpath=taintpath, in_handler=in_handler,
                   in_loop_data=in_loop_data)
        if iter_tainted and body_seq:
            names = tuple(sorted(self.an.names_in(stmt.iter) & self.tainted))
            self.branches.append(_BranchCheck(
                stmt.lineno, start, self.order, names, "for",
                (body_seq, ("<loop-exit>",)), False, in_loop_data))

    def _try(self, stmt, *, blocks, guard, taintpath, in_handler,
             in_loop_data):
        # the try body is transparent (it runs unconditionally up to a
        # fault); handlers are branches and taint their bound name
        kw = dict(guard=guard, taintpath=taintpath,
                  in_loop_data=in_loop_data)
        self._scan(stmt.body, blocks=blocks, in_handler=in_handler, **kw)
        for i, handler in enumerate(stmt.handlers):
            if handler.name:
                self.tainted.add(handler.name)
            self._scan(handler.body,
                       blocks=blocks + ((id(stmt), "except", i),),
                       in_handler=True, **kw)
            if handler.name:
                self.tainted.discard(handler.name)
        self._scan(stmt.orelse, blocks=blocks + ((id(stmt), "try", "else"),),
                   in_handler=in_handler, **kw)
        self._scan(stmt.finalbody, blocks=blocks, in_handler=in_handler,
                   **kw)

    def _raise(self, stmt, *, guard, taintpath, in_handler):
        exc = stmt.exc
        bare = exc is None or isinstance(exc, ast.Name)  # re-raise
        typed = False
        if isinstance(exc, ast.Call):
            ctor = _leaf(_call_name(exc))
            typed = ctor in self.an.typed_status or ctor == "make_fault"
        self.order += 1
        self.raises.append(_RaiseCheck(
            stmt.lineno, self.order, in_handler and not guard,
            taintpath and not guard,
            (not bare and exc is not None and self._expr_tainted(exc)
             and not guard),
            typed, bare))


# --------------------------------------------------------------------------
# the analyzer

@dataclass
class Report:
    """Outcome of a coherence run: suppression-filtered findings, the
    raw pre-suppression list, the CX403 summary (kind -> "path:line" of
    every vote proven to dominate its first dependent), the files
    analyzed and every def's span per file (for suppressions)."""
    findings: list[Finding] = field(default_factory=list)
    raw: list[Finding] = field(default_factory=list)
    vote_summary: dict = field(default_factory=dict)
    files: list[str] = field(default_factory=list)
    spans: dict = field(default_factory=dict)


class Analyzer:
    def __init__(self, files: dict[str, str]):
        self.files = files
        self.trees: dict[str, ast.Module] = {}
        self.functions: list[FuncInfo] = []
        self.by_leaf: dict[str, list[FuncInfo]] = {}
        self._syntax_errors: list[Finding] = []
        self._parse()
        self.typed_status = _harvest_typed_status(self.trees.values())
        self._propagate()
        self._classify_cache: dict[str, str | None] = {}
        self._calls_cache: dict[int, list] = {}
        self._names_cache: dict[int, frozenset] = {}
        self._attrs_cache: dict[int, list] = {}
        self._roles_cache: dict[str, tuple] = {}

    def calls_in(self, node) -> list:
        """:func:`_calls_in`, memoized by node (the returns-taint
        fixpoint scans every body several times)."""
        got = self._calls_cache.get(id(node))
        if got is None:
            got = self._calls_cache[id(node)] = list(_calls_in(node))
        return got

    def attrs_in(self, node) -> list:
        got = self._attrs_cache.get(id(node))
        if got is None:
            got = self._attrs_cache[id(node)] = [
                n for n in ast.walk(node) if isinstance(n, ast.Attribute)]
        return got

    def vote_roles(self, fname: str) -> tuple:
        """``((kind, 'votes' | 'deps'), ...)`` of a call name under
        :data:`VOTE_KINDS`."""
        got = self._roles_cache.get(fname)
        if got is None:
            got = self._roles_cache[fname] = tuple(
                (kind, role) for kind, spec in VOTE_KINDS.items()
                for role in ("votes", "deps")
                if any(_matches_spec(fname, s) for s in spec[role]))
        return got

    def names_in(self, node) -> frozenset:
        got = self._names_cache.get(id(node))
        if got is None:
            got = self._names_cache[id(node)] = frozenset(_names_in(node))
        return got

    # -- construction -----------------------------------------------------

    def _parse(self):
        for path, source in sorted(self.files.items()):
            try:
                tree = ast.parse(source, filename=path)
            except SyntaxError as e:
                self._syntax_errors.append(Finding(
                    "CX401", path, e.lineno or 0,
                    f"syntax error prevents coherence analysis: {e.msg}"))
                continue
            self.trees[path] = tree
            nop = path.replace(os.sep, "/").endswith(_NO_PROPAGATE_SUFFIXES)
            self.functions.extend(_index_functions(path, tree, nop))
        for fi in self.functions:
            self.by_leaf.setdefault(fi.leaf, []).append(fi)

    def callees(self, fi: FuncInfo):
        """The functions ``fi``'s calls may resolve to (leaf edges)."""
        for leaf in fi.calls:
            if not _resolvable(leaf):
                continue
            for callee in self.by_leaf.get(leaf, ()):
                if not callee.no_propagate and callee is not fi:
                    yield callee

    def _propagate(self):
        """Fixed point for enters_data / enters_consensus over leaf-name
        call edges."""
        for fi in self.functions:
            if fi.leaf in CONSENSUS_LEAVES:
                # a vote is consensus, never data, though its body runs
                # the transport's all_reduce_max
                fi.enters_consensus = True
                continue
            if fi.leaf in TRANSPORT_KINDS or fi.calls & DATA_FACADE_LEAVES:
                fi.enters_data = True
            if fi.calls & CONSENSUS_LEAVES:
                fi.enters_consensus = True
        changed = True
        while changed:
            changed = False
            for fi in self.functions:
                if fi.leaf in CONSENSUS_LEAVES:
                    continue
                if fi.enters_data and fi.enters_consensus:
                    continue
                for callee in self.callees(fi):
                    if callee.enters_data and not fi.enters_data:
                        fi.enters_data = changed = True
                    if callee.enters_consensus and not fi.enters_consensus:
                        fi.enters_consensus = changed = True

    # -- queries used by _FuncScan ---------------------------------------

    def classify(self, fname: str) -> str | None:
        """'data' | 'consensus' | None for a call target name."""
        if fname in self._classify_cache:
            return self._classify_cache[fname]
        leaf = _leaf(fname)
        out = None
        if _outside(fname):
            out = None
        elif leaf in CONSENSUS_LEAVES:
            out = "consensus"
        elif leaf in DATA_FACADE_LEAVES:
            out = "data"
        elif leaf not in _GENERIC_LEAVES \
                and not (leaf in _PY_BUILTINS and "." not in fname):
            cands = [f for f in self.by_leaf.get(leaf, ())
                     if not f.no_propagate]
            if any(f.enters_data for f in cands):
                out = "data"
            elif any(f.enters_consensus for f in cands):
                out = "consensus"
        self._classify_cache[fname] = out
        return out

    def returns_tainted(self, fname: str) -> bool:
        leaf = _leaf(fname)
        if leaf in _GENERIC_LEAVES or _outside(fname) \
                or (leaf in _PY_BUILTINS and "." not in fname):
            return False
        cands = self.by_leaf.get(leaf, ())
        return bool(cands) and all(f.returns_tainted for f in cands)

    # -- the run ----------------------------------------------------------

    def run(self) -> Report:
        # returns-taint fixpoint: rescan until the bits are stable
        scans = {}
        for _ in range(5):
            scans = {id(fi): _FuncScan(self, fi).run()
                     for fi in self.functions}
            changed = False
            for fi in self.functions:
                rt = scans[id(fi)].returns_tainted
                if rt != fi.returns_tainted:
                    fi.returns_tainted = rt
                    changed = True
            if not changed:
                break

        raw = list(self._syntax_errors)
        summary = {k: [] for k in VOTE_KINDS}
        for fi in self.functions:
            scan = scans[id(fi)]
            raw.extend(self._check_branches(fi, scan))
            raw.extend(self._check_raises(fi, scan))
            raw.extend(self._check_votes(fi, scan, summary))
        raw.sort(key=lambda f: (f.path, f.line, f.rule))
        spans = {p: def_spans(t) for p, t in self.trees.items()}
        return Report(findings=filter_suppressed(raw, self.files, spans),
                      raw=raw, vote_summary=summary,
                      files=sorted(self.trees), spans=spans)

    # -- checks -----------------------------------------------------------

    def _check_branches(self, fi, scan):
        for b in scan.branches:
            who = ", ".join(b.names) if b.names else "a rank-local value"
            if b.arm_seqs[0] != b.arm_seqs[1]:
                if b.kind in ("while", "for"):
                    msg = (f"data collective {'/'.join(b.arm_seqs[0])} "
                           f"under a rank-local trip count ({who}) in "
                           f"{fi.qualname} — processes can run different "
                           f"iteration counts and desync the sequence")
                else:
                    msg = (f"branch on {who} issues different collective "
                           f"sequences per arm "
                           f"({'/'.join(b.arm_seqs[0]) or 'none'} vs "
                           f"{'/'.join(b.arm_seqs[1]) or 'none'}) in "
                           f"{fi.qualname}")
                yield Finding("CX402", fi.path, b.line, msg)
                continue
            if b.arm_seqs[0] or b.arm_consensus:
                continue    # identical sequences, or an arm votes
            before = b.in_loop_data or any(
                k == "data" for o, k in scan.events if o <= b.start)
            if not before:
                continue
            nxt = next((k for o, k in scan.events if o > b.end), None)
            if nxt == "data" or (nxt is None and b.in_loop_data):
                yield Finding(
                    "CX401", fi.path, b.line,
                    f"rank-local branch on {who} between two data "
                    f"collectives in {fi.qualname} with no intervening "
                    f"consensus vote")

    def _check_raises(self, fi, scan):
        for r in scan.raises:
            if r.bare or r.typed:
                continue
            if not (r.in_handler or r.on_tainted_path or r.expr_tainted):
                continue
            last_data = max((o for o, k in scan.events
                             if k == "data" and o < r.order), default=None)
            if last_data is None:
                continue
            if any(k == "consensus" for o, k in scan.events
                   if last_data < o < r.order):
                continue
            yield Finding(
                "CX404", fi.path, r.line,
                f"untyped rank-local raise in {fi.qualname} after a data "
                f"collective with no consensus vote in between — raise a "
                f"CylonError subclass (recovery.make_fault) after a "
                f"consensus'd code")

    def _check_votes(self, fi, scan, summary):
        for kind in VOTE_KINDS:
            deps, votes = scan.deps[kind], scan.votes[kind]
            if not deps or not votes:
                continue
            first = min(deps, key=lambda s: s.order)
            dominating = [v for v in votes if v.order < first.order
                          and v.blocks == first.blocks[:len(v.blocks)]]
            if dominating:
                summary[kind].append(f"{fi.path}:{dominating[0].line}")
            else:
                yield Finding(
                    "CX403", fi.path, votes[0].line,
                    f"{kind} plan vote ({votes[0].fname}) does not "
                    f"dominate its first dependent collective "
                    f"({first.fname}, line {first.line}) in "
                    f"{fi.qualname} — the vote must run before, and on "
                    f"every path to, the collective whose shape it "
                    f"decides")


def def_spans(tree: ast.Module) -> list:
    """``(lineno, end_lineno)`` of every def in a module, nested ones
    included — a suppression on a def line covers its body."""
    return [(n.lineno, getattr(n, "end_lineno", n.lineno))
            for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


# --------------------------------------------------------------------------
# public entry points

def analyze_files(files: dict[str, str]) -> Report:
    """Run the coherence pass over in-memory sources (path -> source)."""
    return Analyzer(files).run()


def analyze_source(path: str, source: str) -> Report:
    return analyze_files({path: source})


def read_files(paths) -> dict[str, str]:
    """path -> source of every ``.py`` file under ``paths``."""
    from .ast_lint import iter_py_files
    files = {}
    for path in iter_py_files(paths):
        with open(path, encoding="utf-8") as f:
            files[path] = f.read()
    return files


def analyze_paths(paths) -> Report:
    """Run the coherence pass over files/directories (the call graph
    spans every file, so interprocedural marks resolve)."""
    return analyze_files(read_files(paths))
