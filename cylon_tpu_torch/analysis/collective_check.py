"""The collective contracts (the port's counterpart of
``cylon_tpu/analysis/jaxpr_check.py``), rules CL2xx.

The reference traces each registered jit program factory and checks
its jaxpr: no collective under a ``cond`` or a data-dependent ``while``
(JX201, JX202), the collective set equal to the declaration (JX205), no
row-scale int32 → int64 widening (JX203), host callbacks within budget
(JX204).  In the port's eager Python a collective under a rank-dependent
branch or loop is what the coherence pass reports (CX401, CX402); JX203
and JX204 have no counterpart (ROADMAP.md "No counterpart, by
decision": nothing is traced under x64, and host pulls are RT303's).
This module adds:

* **CL201** (static, ``--strict``): for each facade declared in
  :mod:`.registry` (and each ``declare_facade(...)`` call found in the
  analyzed sources, so a fixture can declare its own), the transport
  kinds reachable from it in the call graph differ from its
  declaration.  The call graph here is stricter than the coherence
  pass's leaf-name graph: a call resolves only to a function of its own
  module (``f(...)``), a name imported from another module of the tree
  (``from .m import f``), a function of an imported module
  (``transport.f(...)``), or a method of its own class
  (``self.f(...)``) — so two methods that share a name never tie two
  facades' contracts together.  A call ``<x>.<kind>(...)`` whose target
  is a transport kind (:data:`~.coherence.TRANSPORT_KINDS`) records the
  kind and is not followed further.
* **CL202** (runtime): two processes of one world logged different
  collective sequences.  The runtime sentinel (:mod:`.runtime`) logs,
  while armed, every collective ``parallel/transport._guarded`` runs as
  ``(site, kind, dtype, group size)`` with a running digest;
  :func:`compare_logs` names the first index where two logs differ.
"""

from __future__ import annotations

import ast
import os

from .coherence import TRANSPORT_KINDS
from .rules import Finding

#: the package whose modules the call graph resolves
PACKAGE = "cylon_tpu_torch"


def _module_of(path: str) -> str | None:
    """``parallel/shuffle.py`` for ``.../cylon_tpu_torch/parallel/
    shuffle.py`` (the last package segment wins), None outside it."""
    parts = path.replace(os.sep, "/").split("/")
    if PACKAGE not in parts:
        return None
    i = len(parts) - 1 - parts[::-1].index(PACKAGE)
    return "/".join(parts[i + 1:])


def _dotted_to_module(dotted: str, known: set) -> str | None:
    """A module path of the tree for a dotted package-relative name:
    ``a/b.py`` or the package ``a/b/__init__.py``."""
    base = dotted.replace(".", "/")
    for cand in (base + ".py", base + "/__init__.py"):
        if cand in known:
            return cand
    return None


class CallGraph:
    """Functions of the analyzed tree by (module, qualname), with the
    stricter resolution described in the module docstring."""

    def __init__(self, files: dict[str, str]):
        self.funcs: dict[tuple, ast.AST] = {}
        self.paths: dict[str, str] = {}          # module -> file path
        trees = {}
        for path, source in sorted(files.items()):
            mod = _module_of(path)
            if mod is None:
                continue
            try:
                trees[mod] = ast.parse(source, filename=path)
            except SyntaxError:
                continue
            self.paths[mod] = path
        known = set(trees)
        self.imports: dict[str, dict] = {}
        for mod, tree in trees.items():
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.funcs[(mod, node.name)] = node
                elif isinstance(node, ast.ClassDef):
                    for sub in node.body:
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                            self.funcs[(mod, f"{node.name}.{sub.name}")] = \
                                sub
            self.imports[mod] = self._imports(mod, tree, known)

    @staticmethod
    def _imports(mod: str, tree: ast.Module, known: set) -> dict:
        """alias -> ("module", module) | ("func", module, name), from
        every import statement of the module (function-level ones
        included: the port imports lazily)."""
        pkg = mod.split("/")[:-1]
        out = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if node.level:
                    up = pkg[:len(pkg) - (node.level - 1)] \
                        if node.level > 1 else pkg
                    base = ".".join(up + ([node.module] if node.module
                                          else []))
                elif (node.module or "").split(".")[0] == PACKAGE:
                    base = node.module.split(".", 1)[1] \
                        if "." in node.module else ""
                else:
                    continue
                for a in node.names:
                    full = f"{base}.{a.name}" if base else a.name
                    sub = _dotted_to_module(full, known)
                    if sub is not None:
                        out[a.asname or a.name] = ("module", sub)
                        continue
                    owner = _dotted_to_module(base, known) if base else None
                    if owner is not None:
                        out[a.asname or a.name] = ("func", owner, a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.split(".")[0] == PACKAGE and a.asname:
                        sub = _dotted_to_module(
                            a.name.split(".", 1)[1], known) \
                            if "." in a.name else None
                        if sub is not None:
                            out[a.asname] = ("module", sub)
        return out

    def _lookup(self, mod: str, name: str, depth: int = 0):
        """(module, qualname) of ``name`` as module ``mod`` exports it,
        through re-exports."""
        if (mod, name) in self.funcs:
            return (mod, name)
        alias = self.imports.get(mod, {}).get(name)
        if alias is not None and alias[0] == "func" and depth < 4:
            return self._lookup(alias[1], alias[2], depth + 1)
        return None

    def resolve(self, mod: str, cls: str | None, call: ast.Call):
        """('kind', kind) for a transport call, ('func', key) for a
        resolved function, or None."""
        f = call.func
        imports = self.imports.get(mod, {})
        if isinstance(f, ast.Name):
            key = self._lookup(mod, f.id)
            if key is not None and key[0] == "parallel/transport.py" \
                    and key[1] in TRANSPORT_KINDS:
                return ("kind", key[1])
            return None if key is None else ("func", key)
        if not (isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)):
            return None
        base, leaf = f.value.id, f.attr
        if base == "self" and cls is not None:
            key = (mod, f"{cls}.{leaf}")
            return ("func", key) if key in self.funcs else None
        alias = imports.get(base)
        if alias is not None and alias[0] == "module":
            if alias[1] == "parallel/transport.py" \
                    and leaf in TRANSPORT_KINDS:
                return ("kind", leaf)
            key = self._lookup(alias[1], leaf)
            return None if key is None else ("func", key)
        if base == "transport" and leaf in TRANSPORT_KINDS:
            return ("kind", leaf)      # a fixture without the transport
        return None

    def reachable_kinds(self, key: tuple) -> frozenset:
        """Transport kinds reachable from function ``key``."""
        kinds, seen, stack = set(), {key}, [key]
        while stack:
            mod, qual = stack.pop()
            cls = qual.split(".")[0] if "." in qual else None
            for node in ast.walk(self.funcs[(mod, qual)]):
                if not isinstance(node, ast.Call):
                    continue
                got = self.resolve(mod, cls, node)
                if got is None:
                    continue
                if got[0] == "kind":
                    kinds.add(got[1])
                elif got[1] not in seen:
                    seen.add(got[1])
                    stack.append(got[1])
        return frozenset(kinds)


def _harvest_declarations(files: dict[str, str]) -> list:
    """``declare_facade("module", "qualname", {...kinds})`` calls with
    literal arguments in the analyzed sources."""
    from .registry import FacadeDecl
    out = []
    for path, source in files.items():
        if "declare_facade" not in source or _module_of(path) == \
                "analysis/registry.py":
            continue            # the registry's own are loaded already
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            continue
        for call in ast.walk(tree):
            if not (isinstance(call, ast.Call) and len(call.args) == 3):
                continue
            f = call.func
            name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", "")
            if name != "declare_facade":
                continue
            try:
                mod, qual, kinds = (ast.literal_eval(a) for a in call.args)
            except ValueError:
                continue        # the registry's own loops: not literal
            out.append((path, call.lineno,
                        FacadeDecl(mod, qual, frozenset(kinds))))
    return out


def check_facades(files: dict[str, str], decls=None) -> list[Finding]:
    """CL201 over the analyzed sources: every declared facade whose
    module is among them, against its reachable transport kinds."""
    from . import registry
    graph = CallGraph(files)
    todo = []
    if decls is None:
        for d in registry.all_declarations():
            if d.module in graph.paths:
                todo.append((graph.paths[d.module], 0, d))
        todo.extend(_harvest_declarations(files))
    else:
        todo = [(graph.paths.get(d.module, d.module), 0, d) for d in decls]
    findings = []
    for path, line, d in todo:
        key = (d.module, d.qualname)
        if key not in graph.funcs:
            if d.module in graph.paths:
                findings.append(Finding(
                    "CL201", path, line,
                    f"declared collective facade {d.name} is not defined "
                    "(renamed or removed: update analysis/registry.py)"))
            continue
        got = graph.reachable_kinds(key)
        if got == d.kinds:
            continue
        parts = []
        extra, missing = sorted(got - d.kinds), sorted(d.kinds - got)
        if extra:
            parts.append(f"undeclared transport kind(s) {extra}")
        if missing:
            parts.append(f"declared kind(s) {missing} unreachable")
        findings.append(Finding(
            "CL201", path, line or graph.funcs[key].lineno,
            f"collective facade {d.name}: " + "; ".join(parts)
            + " — its communication contract changed; say so in "
            "analysis/registry.py"))
    return findings


# --------------------------------------------------------------------------
# CL202: the processes' collective logs

def compare_logs(logs: dict) -> list[Finding]:
    """CL202 over ``{process: log}``, each log a list of ``(site, kind,
    dtype, group size)`` entries in order: one finding per process whose
    log differs from the first process's, naming the first index where
    they part (or the shorter log's end)."""
    items = sorted(logs.items())
    if not items:
        return []
    ref_p, ref = items[0]
    out = []
    for p, log in items[1:]:
        n = min(len(ref), len(log))
        at = next((i for i in range(n) if tuple(ref[i]) != tuple(log[i])),
                  None)
        if at is None and len(ref) == len(log):
            continue
        if at is None:
            at = n
            what = (f"process {ref_p} logged {len(ref)} collectives, "
                    f"process {p} {len(log)}")
        else:
            what = (f"process {ref_p} ran {tuple(ref[at])}, process {p} "
                    f"{tuple(log[at])}")
        out.append(Finding(
            "CL202", f"process{p}", at,
            f"collective sequences part at index {at}: {what} — the "
            "processes entered mismatched collectives"))
    return out
