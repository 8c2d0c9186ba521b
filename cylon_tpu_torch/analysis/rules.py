"""Rule registry, findings and the suppression grammar of the port's
analysis gate (port of ``cylon_tpu/analysis/rules.py``).

Rule families:

* ``TS1xx`` — AST lint (:mod:`.ast_lint`): source-level hazards of one
  file;
* ``CX4xx`` — collective coherence (:mod:`.coherence`): rank-local
  control flow between collectives and plan-vote dominance, across the
  call graph;
* ``CL2xx`` — collective contracts (:mod:`.collective_check`): each
  collective facade's transport kinds against its declaration
  (:mod:`.registry`), and the processes' collective logs against each
  other;
* ``RT3xx`` — the runtime sentinel (:mod:`.runtime`): funnel pulls,
  kernel builds and the collective log, counted while armed.

Suppression: a trailing comment ``# tracecheck: off[TS101]`` (comma-
separated rule ids, or bare ``off`` for all rules) on the flagged line or
on the enclosing ``def`` line silences the finding; a bare ``#
tracecheck: off`` within the first five lines silences the whole file.
Only real comment tokens count, so a docstring that quotes the grammar
suppresses nothing.  The gate never inserts a suppression.
"""

from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass

RULES = {
    "TS101": "synchronizing host read outside the utils/host.py funnel "
             "in ops/, relational/, parallel/, exec/, stream/ or topo/ "
             "(.item(), .tolist(), .cpu(), .numpy(), torch.nonzero, "
             "np.asarray/np.array of a torch expression) — the "
             "sanctioned modules are the funnel (utils/host.py) and the "
             "modules that move bytes by design: the transport "
             "(parallel/transport.py), the spill tier (exec/memory.py) "
             "and the checkpoint pages (exec/checkpoint.py)",
    "TS105": "except handler classifies OOM by string-matching outside "
             "the port's fault taxonomy (exec/recovery.py)",
    "TS107": "checkpoint artifact written outside exec/checkpoint.py "
             "(direct open/np.save/pickle of CYLON_TPU_TORCH_CKPT_DIR "
             "paths bypasses the page-hash/two-phase-manifest protocol)",
    "TS109": "direct ledger admission/eviction call outside "
             "exec/scheduler.py and exec/memory.py (admission must be "
             "scheduler-mediated so multi-tenant footprints and "
             "cross-tenant evictions stay attributed)",
    "TS110": "GroupBySink partials mutated or window-lifetime state "
             "registered/evicted outside cylon_tpu_torch/stream/ (and "
             "the defining modules exec/pipeline.py, exec/memory.py)",
    "TS111": "foreign-rank checkpoint directory read outside "
             "exec/checkpoint.py (a rank<r> path constructed off the "
             "ckpt dir skips the re-shard path's sha verification, "
             "generation scan and resume consensus)",
    "TS112": "module-level mutable counter dict (_STATS-style table) "
             "outside cylon_tpu_torch/obs/ — counters route through the "
             "metrics registry facade (cylon_tpu_torch.obs.metrics)",
    "TS113": "plan-node push/pop outside the obs/plan.py context-manager "
             "facade in relational/, exec/ or stream/",
    "TS114": "spill-file path construction or raw spill page IO outside "
             "exec/memory.py (CYLON_TPU_TORCH_SPILL_DIR pages are "
             "hashed, retried and accounted only behind the ledger)",
    "TS115": "skew-plan decision (split targets, SkewPlan construction, "
             "salt assignment, plan vote) outside the relational/skew.py "
             "plan facade",
    "TS116": "topology decision (TopologyPlan construction, gateway "
             "assignment, hop counts, plan vote) outside the "
             "cylon_tpu_torch/topo facade",
    "TS117": "raw kernel build or library load (an nvcc/g++ subprocess, "
             "ctypes.CDLL/LoadLibrary, torch.utils.cpp_extension.load*, "
             "torch.compile) outside the compile tier (exec/compiler.py, "
             "kernels/__init__.py, native/__init__.py)",
    "TS118": "fingerprint computation or DataIntegrityError raised "
             "outside the exec/integrity audit facade",
    "CX401": "rank-local branch between two collectives without an "
             "intervening consensus vote (a value tainted by a "
             "rank-local source — this process's index, injector "
             "state, a caught exception, file IO, the wall clock, the "
             "device's memory counters — steers control flow after one "
             "collective and before the next)",
    "CX402": "path-dependent collective sequence — a branch or loop on "
             "a rank-local value issues different collectives on its "
             "arms (or a data collective under a rank-local trip count)",
    "CX403": "plan/epoch vote does not dominate its first dependent "
             "collective (skew, topo, ckpt commit, drain, preempt)",
    "CX404": "rank-local raise after a collective was entered without a "
             "consensus'd typed status",
    "CL201": "the transport kinds reachable from a declared collective "
             "facade differ from its declaration (analysis/registry.py)",
    "CL202": "two processes of one world logged different collective "
             "sequences (the runtime sentinel's collective log)",
    "RT301": "a kernel library built twice for one source-and-flags "
             "digest in one process",
    "RT302": "more distinct kernel builds in one process than the budget",
    "RT303": "an op made more funnel pulls than its declared budget",
}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


_SUPPRESS_RE = re.compile(
    r"#\s*tracecheck:\s*off(?:\[(?P<rules>[A-Z0-9,\s]+)\])?")


def _comment_lines(source: str) -> set[int] | None:
    """1-based line numbers holding a real ``#`` comment token, or None
    when the source does not tokenize."""
    lines: set[int] = set()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                lines.add(tok.start[0])
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return None
    return lines


def suppressions(source: str) -> dict[int, set[str] | None]:
    """Per-line suppression map: line -> set of rule ids, or None = all.
    Line numbers are 1-based, matching ast/Finding."""
    comments = _comment_lines(source)
    out: dict[int, set[str] | None] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        if comments is not None and i not in comments:
            continue
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        ids = m.group("rules")
        out[i] = (None if ids is None
                  else {r.strip() for r in ids.split(",") if r.strip()})
    return out


def file_suppressed(source: str) -> bool:
    comments = _comment_lines(source)
    for i, text in enumerate(source.splitlines()[:5], start=1):
        if comments is not None and i not in comments:
            continue
        m = _SUPPRESS_RE.search(text)
        if m and m.group("rules") is None:
            return True
    return False


def is_suppressed(finding: Finding, sup: dict, def_lines: list[int]) -> bool:
    """``def_lines``: line numbers of enclosing function defs (innermost
    first) — a suppression on a def line covers its whole body."""
    for line in [finding.line, *def_lines]:
        rules = sup.get(line, "missing")
        if rules == "missing":
            continue
        if rules is None or finding.rule in rules:
            return True
    return False


def enclosing_def_lines(spans, line: int) -> list[int]:
    """Def-statement lines of every ``(start, end)`` span containing
    ``line``, innermost first."""
    return sorted((s for s, e in spans if s <= line <= e), reverse=True)


def filter_suppressed(raw, sources: dict, spans_by_file: dict) -> list:
    """``raw`` findings without the suppressed ones (file-level off,
    a line comment, or a comment on an enclosing def)."""
    out, sup_cache, off_cache = [], {}, {}
    for f in raw:
        if f.path not in off_cache:
            src = sources.get(f.path, "")
            off_cache[f.path] = file_suppressed(src)
            sup_cache[f.path] = suppressions(src)
        if off_cache[f.path]:
            continue
        defs = enclosing_def_lines(spans_by_file.get(f.path, ()), f.line)
        if not is_suppressed(f, sup_cache[f.path], defs):
            out.append(f)
    return out
