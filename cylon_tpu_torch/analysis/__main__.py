"""The port's analysis gate (the counterpart of
``scripts/check_trace_safety.py``).

Usage:
    python -m cylon_tpu_torch.analysis [paths...]     # AST + CX passes
    python -m cylon_tpu_torch.analysis --strict       # + CL201
    python -m cylon_tpu_torch.analysis --list-rules
    python -m cylon_tpu_torch.analysis --audit-suppressions
    python -m cylon_tpu_torch.analysis --json out.json

The default path is the ``cylon_tpu_torch`` package.  Stages:

1. **AST lint** (TS1xx) — per file;
2. **collective coherence** (CX4xx) — the whole tree's call graph;
3. **collective contracts** (CL201, ``--strict`` only) — each declared
   facade's reachable transport kinds against ``analysis/registry.py``.

Stages 1 and 2 are cached under ``.tracecheck_cache/`` beside the
package (``torch_ast.json``, ``torch_cx.json``: files of their own),
keyed on content hashes of the analyzed files and of the analyzer's
modules; ``--no-cache`` bypasses it.  ``--audit-suppressions`` reports
``# tracecheck: off[...]`` comments whose rules no longer fire on the
lines they cover; ``--fail-stale-suppressions`` fails the gate on one.
``--json FILE`` writes every finding, suppressed ones included and
flagged, in the reference gate's schema.

Exit status: 0 when nothing fires unsuppressed, 1 when a rule fires
(each printed as ``file:line: RULE message``), 2 on usage errors.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(os.path.dirname(PKG_DIR), ".tracecheck_cache")
CACHE_VERSION = 1
_ANALYZER_FILES = ("rules.py", "ast_lint.py", "coherence.py")


def _analyzer_hash() -> str:
    """Content hash of the analyzer's modules: a rule change invalidates
    every cache entry."""
    base = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256(str(CACHE_VERSION).encode())
    for name in _ANALYZER_FILES:
        with open(os.path.join(base, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _load_cache(name: str, analyzer_hash: str) -> dict:
    try:
        with open(os.path.join(CACHE_DIR, name), encoding="utf-8") as f:
            data = json.load(f)
        if data.get("analyzer") == analyzer_hash:
            return data
    except (OSError, ValueError):
        pass
    return {"analyzer": analyzer_hash}


def _store_cache(name: str, data: dict) -> None:
    try:
        os.makedirs(CACHE_DIR, exist_ok=True)
        tmp = os.path.join(CACHE_DIR, f"{name}.{os.getpid()}.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f)
        os.replace(tmp, os.path.join(CACHE_DIR, name))
    except OSError:
        pass          # the cache is best-effort; the gate still ran


def _to_list(f):
    return [f.rule, f.path, f.line, f.message]


def _from_list(item):
    from .rules import Finding
    return Finding(*item)


def _ast_stage(files: dict, ah: str, use_cache: bool):
    """Per-file AST lint with content-hash skipping.  Returns ``(kept,
    raw, spans_by_file, n_cached)``."""
    from . import ast_lint
    from .rules import filter_suppressed
    cache = _load_cache("torch_ast.json", ah) if use_cache else {}
    entries = cache.setdefault("files", {})
    kept, raw, spans_by_file, n_cached = [], [], {}, 0
    for path, source in sorted(files.items()):
        sha = hashlib.sha256(source.encode()).hexdigest()
        ent = entries.get(path)
        if ent is not None and ent.get("sha") == sha:
            n_cached += 1
        else:
            file_raw, spans = ast_lint.lint_source_raw(path, source)
            file_kept = filter_suppressed(file_raw, {path: source},
                                          {path: spans})
            ent = entries[path] = {
                "sha": sha, "kept": [_to_list(f) for f in file_kept],
                "raw": [_to_list(f) for f in file_raw], "spans": spans}
        kept.extend(_from_list(i) for i in ent["kept"])
        raw.extend(_from_list(i) for i in ent["raw"])
        spans_by_file[path] = [tuple(s) for s in ent["spans"]]
    if use_cache:
        _store_cache("torch_ast.json", cache)
    return kept, raw, spans_by_file, n_cached


def _cx_stage(files: dict, ah: str, use_cache: bool):
    """The whole-tree coherence pass, cached on the hash of every
    analyzed file (the call graph spans them all)."""
    from . import coherence
    h = hashlib.sha256()
    for path, source in sorted(files.items()):
        h.update(path.encode())
        h.update(hashlib.sha256(source.encode()).digest())
    tree_sha = h.hexdigest()
    cache = _load_cache("torch_cx.json", ah) if use_cache else {}
    trees = cache.setdefault("trees", {})
    ent = trees.get(tree_sha)
    if ent is not None:
        return ([_from_list(i) for i in ent["kept"]],
                [_from_list(i) for i in ent["raw"]],
                ent["vote_summary"], True)
    report = coherence.analyze_files(files)
    if use_cache:
        while len(trees) >= 8:
            trees.pop(next(iter(trees)))
        trees[tree_sha] = {
            "kept": [_to_list(f) for f in report.findings],
            "raw": [_to_list(f) for f in report.raw],
            "vote_summary": report.vote_summary}
        _store_cache("torch_cx.json", cache)
    return report.findings, report.raw, report.vote_summary, False


def audit_suppressions(files: dict, raw, spans_by_file) -> list:
    """Stale suppressions: every ``# tracecheck: off[...]`` comment none
    of whose rules fires (before suppression) on the lines it covers.
    Returns ``[(path, line, rules-or-None), ...]``."""
    from .rules import suppressions
    raw_by_file = {}
    for f in raw:
        raw_by_file.setdefault(f.path, []).append(f)
    dead = []
    for path, source in sorted(files.items()):
        sup = suppressions(source)
        if not sup:
            continue
        file_raw = raw_by_file.get(path, [])
        spans = spans_by_file.get(path, [])
        n_lines = source.count("\n") + 1
        for line, rules in sorted(sup.items()):
            covered = {line}
            for s, e in spans:
                if s == line:                 # a comment on the def line
                    covered.update(range(s, e + 1))
            if rules is None and line <= 5:   # file-level off
                covered.update(range(1, n_lines + 1))
            if not any(f.line in covered
                       and (rules is None or f.rule in rules)
                       for f in file_raw):
                dead.append((path, line, rules))
    return dead


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cylon_tpu_torch.analysis",
        description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=[PKG_DIR],
                    help="files/directories to analyze (default: the "
                         "cylon_tpu_torch package)")
    ap.add_argument("--strict", action="store_true",
                    help="also check the collective facades' declared "
                         "transport kinds (CL201)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore and do not write .tracecheck_cache/")
    ap.add_argument("--json", metavar="FILE", dest="json_out",
                    help="write every finding (suppressed included, "
                         "flagged) as JSON")
    ap.add_argument("--audit-suppressions", action="store_true",
                    help="report stale tracecheck suppression comments "
                         "and exit (no gate verdict)")
    ap.add_argument("--fail-stale-suppressions", action="store_true",
                    help="fail the gate when a stale suppression is found")
    args = ap.parse_args(argv)

    from .rules import RULES
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    from .coherence import read_files
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"error: no such path: {', '.join(missing)}", file=sys.stderr)
        return 2
    files = read_files(args.paths)
    use_cache = not args.no_cache
    ah = _analyzer_hash()
    ast_kept, ast_raw, spans_by_file, n_cached = _ast_stage(
        files, ah, use_cache)
    print(f"ast lint: {len(files)} files ({n_cached} cached)",
          file=sys.stderr)
    cx_kept, cx_raw, vote_summary, cx_cached = _cx_stage(
        files, ah, use_cache)
    votes = ", ".join(f"{k}={len(v)}" for k, v in sorted(vote_summary.items()))
    print(f"coherence pass: {'cached' if cx_cached else 'ran'}; "
          f"dominating vote sites: {votes}", file=sys.stderr)
    findings = ast_kept + cx_kept
    raw = ast_raw + cx_raw
    dead = audit_suppressions(files, raw, spans_by_file)
    if args.audit_suppressions:
        for path, line, rules in dead:
            what = "all rules" if rules is None else ",".join(sorted(rules))
            print(f"{path}:{line}: stale suppression ({what} — nothing "
                  "fires on the covered lines)")
        print(f"suppression audit: {len(dead)} stale" if dead
              else "suppression audit: clean", file=sys.stderr)
        return 0
    for path, line, rules in dead:
        what = "all rules" if rules is None else ",".join(sorted(rules))
        print(f"warning: stale suppression at {path}:{line} ({what})",
              file=sys.stderr)

    if args.strict:
        from .collective_check import check_facades
        from .registry import all_declarations
        cl = check_facades(files)
        findings.extend(cl)
        raw.extend(cl)
        print(f"collective contracts: {len(all_declarations())} facades "
              "declared", file=sys.stderr)

    if args.json_out:
        kept_keys = {(f.rule, f.path, f.line, f.message) for f in findings}
        counts: dict = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        payload = {
            "version": 1,
            "findings": [
                {"rule": f.rule, "file": f.path, "line": f.line,
                 "message": f.message,
                 "suppressed": (f.rule, f.path, f.line, f.message)
                 not in kept_keys}
                for f in raw],
            "stale_suppressions": [
                {"file": p, "line": ln,
                 "rules": sorted(r) if r is not None else None}
                for p, ln, r in dead],
            "counts": counts,
        }
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.json_out}", file=sys.stderr)

    for f in findings:
        print(f)
    if args.fail_stale_suppressions and dead:
        print(f"\n{len(dead)} stale suppression(s)", file=sys.stderr)
        return 1
    if findings:
        counts = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        summary = ", ".join(f"{r}x{n}" for r, n in sorted(counts.items()))
        print(f"\n{len(findings)} finding(s): {summary}", file=sys.stderr)
        return 1
    print("analysis gate: clean", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
