"""EXPLAIN / ANALYZE plan inspector — print and diff saved plan trees
(port of ``scripts/explain.py``).

Usage:
    python -m cylon_tpu_torch.obs.explain PLAN.json        # annotated tree
    python -m cylon_tpu_torch.obs.explain A.json B.json    # diff two runs

Accepts a raw ``QueryPlan.to_dict()`` payload (what
``obs.explain_analyze(...).to_dict()`` serializes) or a bench JSON that
carries one — ``detail.plan``, ``detail.plans.<q>`` (the first query is
shown; name one with ``A.json:q5``) or ``detail.q13_plan``.

The diff aligns the two trees positionally, flags structural divergence
(a different op or child count means the engine chose a different plan:
route flips, chunk-count changes), and reports per-node deltas of self
seconds, rows and exchanged bytes for structurally matching nodes.  Runs
whose comm matrix carries the multi-slice tier split (topo/, armed
multi-slice runs) also render and diff the tiers' payload, padded wire
and message totals.  The text is the reference script's, line for line.

Importing this module binds the package attribute ``obs.explain`` to it
(the import system sets a submodule on its package), where ``obs``
exports :func:`.plan.explain`; the module is therefore callable and
forwards to that function, so ``obs.explain(fn, ...)`` keeps working.
"""

from __future__ import annotations

import json
import sys
import types

from .plan import render_tree


def load_plan(spec: str) -> dict:
    """Load a plan payload from ``path`` or ``path:query``."""
    path, _, qname = spec.partition(":")
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if "roots" in doc:
        return doc
    det = doc.get("detail", doc)
    if qname:
        plans = det.get("plans", {})
        if qname in plans:
            return plans[qname]
        if f"{qname}_plan" in det:
            return det[f"{qname}_plan"]
        raise SystemExit(f"no plan for query {qname!r} in {path}")
    for key in ("plan", "q13_plan"):
        if key in det:
            return det[key]
    plans = det.get("plans")
    if plans:
        return plans[sorted(plans)[0]]
    raise SystemExit(f"no plan payload found in {path}")


def _flatten(d: dict, path: str = "") -> list[tuple[str, dict]]:
    me = f"{path}/{d['op']}"
    out = [(me, d)]
    for i, c in enumerate(d.get("children", ())):
        out.extend(_flatten(c, f"{me}[{i}]"))
    return out


def _why_skew(path: str, hh: dict | None, plan: dict | None) -> str:
    """The "why this plan" line for a hash↔skew_split route flip: the
    heavy-hitter profile's ``est_rows_per_rank``
    names the concentration the CURRENT partitioner would produce —
    the number a split plan's balanced layout is judged against — and
    the voted plan's key count + fan-out says what the split bought."""
    bits = [f"? why: {path}"]
    if hh and hh.get("est_rows_per_rank"):
        per = hh["est_rows_per_rank"]
        tot = sum(per) or 1
        hot_r = max(range(len(per)), key=per.__getitem__)
        even = tot / max(len(per), 1)
        bits.append(f"hash plan would land ≈{per[hot_r]:,} rows "
                    f"({per[hot_r] / tot:.1%}) on rank {hot_r} "
                    f"(even share ≈{even:,.0f})")
    if hh and hh.get("est_max_rank_share") is not None:
        bits.append(f"est_max_rank_share={hh['est_max_rank_share']:.3f}")
    if plan:
        bits.append(f"split plan: {plan.get('keys')} key(s), "
                    f"fanout={plan.get('fanout')}, "
                    f"hash={plan.get('plan_hash')}")
    return "\n    ".join(bits)


def _tier_lines(plan: dict, prefix: str = "") -> list[str]:
    """The comm matrix's tier split (topo/ — armed multi-slice runs
    embed it at comm_matrix.tiers), rendered as the per-tier
    payload/wire/message summary."""
    t = (plan.get("comm_matrix") or {}).get("tiers")
    if not t:
        return []
    return [f"{prefix}tiers ({t['n_slices']} slices, routes "
            f"{t.get('routes')}):",
            f"{prefix}  ici: rows={t['ici_rows']:,} "
            f"bytes={t['ici_bytes']:,} wire={t['ici_wire_bytes']:,} "
            f"messages={t['ici_messages']:,}",
            f"{prefix}  dcn: rows={t['dcn_rows']:,} "
            f"bytes={t['dcn_bytes']:,} wire={t['dcn_wire_bytes']:,} "
            f"messages={t['dcn_messages']:,}"]


def _diff_tiers(a: dict, b: dict) -> list[str]:
    """Tier-split delta between two runs — how a route change (flat ↔
    two-hop) moved the cross-slice traffic: payload rows are
    route-invariant, so the load-bearing deltas are the DCN message
    count (~1/R under the two-hop route) and the padded wire bytes."""
    ta = (a.get("comm_matrix") or {}).get("tiers")
    tb = (b.get("comm_matrix") or {}).get("tiers")
    if not ta and not tb:
        return []
    if not ta or not tb:
        have = "B" if tb else "A"
        return [f"! comm tier split present only in {have} "
                "(single-slice vs multi-slice topology)"]
    lines = []
    for k, label in (("dcn_messages", "DCN messages"),
                     ("dcn_wire_bytes", "DCN wire bytes"),
                     ("dcn_rows", "DCN payload rows"),
                     ("ici_wire_bytes", "ICI wire bytes")):
        va, vb = ta.get(k, 0), tb.get(k, 0)
        if va != vb:
            ratio = f" ({vb / va:.3f}x)" if va else ""
            lines.append(f"! tier {label}: {va:,} -> {vb:,}{ratio}")
    if ta.get("routes") != tb.get("routes"):
        lines.append(f"! tier routes: {ta.get('routes')} -> "
                     f"{tb.get('routes')}")
    return lines


def diff_plans(a: dict, b: dict) -> str:
    """Human-readable diff of two plan payloads (see module docstring)."""
    fa = [p for r in a.get("roots", ()) for p in _flatten(r)]
    fb = [p for r in b.get("roots", ()) for p in _flatten(r)]
    lines = []
    n = max(len(fa), len(fb))
    for i in range(n):
        if i >= len(fa):
            lines.append(f"+ only in B: {fb[i][0]}")
            continue
        if i >= len(fb):
            lines.append(f"- only in A: {fa[i][0]}")
            continue
        pa, da = fa[i]
        pb, db = fb[i]
        if pa != pb or da["op"] != db["op"]:
            lines.append(f"! structure diverges at #{i}: A={pa} B={pb}")
            continue
        attrs_a, attrs_b = da.get("attrs", {}), db.get("attrs", {})
        for k in sorted(set(attrs_a) | set(attrs_b)):
            if attrs_a.get(k) != attrs_b.get(k):
                lines.append(f"! {pa} attr {k}: "
                             f"{attrs_a.get(k)!r} -> {attrs_b.get(k)!r}")
        route_a, route_b = attrs_a.get("route"), attrs_b.get("route")
        if route_a != route_b and "skew_split" in (route_a, route_b):
            # hash ↔ skew_split flip: explain WHY from the profile of
            # whichever run carries one (analyze-mode key profiles) and
            # from the split side's voted plan summary
            hh = da.get("heavy_hitters") or db.get("heavy_hitters")
            split_attrs = attrs_a if route_a == "skew_split" else attrs_b
            lines.append(_why_skew(pa, hh, split_attrs.get("skew_plan")))
        deltas = []
        for k, fmt in (("self_s", "{:+.4f}s"), ("rows_out", "{:+d}"),
                       ("bytes_exchanged", "{:+d}B")):
            va, vb = da.get(k), db.get(k)
            if va is not None and vb is not None and va != vb:
                deltas.append(f"{k} " + fmt.format(
                    (vb - va) if isinstance(va, (int, float)) else 0))
        if deltas:
            lines.append(f"  {pa}: " + ", ".join(deltas))
    lines.extend(_diff_tiers(a, b))
    ra, rb = a.get("reconcile"), b.get("reconcile")
    if ra and rb:
        lines.append(f"total: {ra['phase_s']}s -> {rb['phase_s']}s "
                     f"({rb['phase_s'] - ra['phase_s']:+.4f}s)")
    return "\n".join(lines) if lines else "plans are identical"


def main(argv: list[str]) -> int:
    if len(argv) not in (2, 3) or argv[1] in ("-h", "--help"):
        print(__doc__)
        return 2
    a = load_plan(argv[1])
    if len(argv) == 2:
        print(render_tree(a))
        for line in _tier_lines(a):
            print(line)
        return 0
    b = load_plan(argv[2])
    print(diff_plans(a, b))
    return 0


class _CallableModule(types.ModuleType):
    """This module, callable as :func:`.plan.explain` (module
    docstring)."""

    def __call__(self, fn, *args, **kwargs):
        from .plan import explain
        return explain(fn, *args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule

if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
