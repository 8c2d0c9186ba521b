"""Query plan profiler: EXPLAIN and EXPLAIN ANALYZE (port of
``cylon_tpu/obs/plan.py``).

Every distributed operator entry (relational/join, groupby, sort, setops,
repart, exec/pipeline) opens a typed :class:`PlanNode` on a query-scoped
stack while it runs: the operator, its keys, the route it took
(broadcast, hash, skew split, range pipeline), chunk counts, piece caps
and the spill and checkpoint flags.  With no profile active a node is one
thread-local load per operator call: no node, no allocation, no timing,
no device work.

:func:`explain` runs a query and returns the static tree;
:func:`explain_analyze` adds per node:

* seconds: a node-scoped ``utils/timing`` attribution scope, innermost
  while the node runs, so a node's phase table holds its SELF time, and
  the tables' per-region sums reconcile with the process-wide phase table
  (:meth:`QueryPlan.reconcile`); ``.block`` regions split each node into
  dispatch and wait seconds;
* rows in and out, from the host-known valid counts (no wait);
* rows and bytes exchanged, recorded by ``parallel/shuffle.exchange``
  into the innermost node (and, with the comm matrix armed, into
  obs/comm);
* the spill, checkpoint and recovery counters' deltas over the node's
  window (children included);
* a Misra-Gries heavy-hitter profile (obs/sketch) over sampled key values
  (``profile_keys=True``), with the hottest rank's estimated share.

Nodes open only through :func:`node` (attributes found later through
:func:`annotate`); call sites guard their bookkeeping on ``if pn:``.
``explain_analyze(family=...)`` records the run's peak ledger bytes as
the admission history of a serving shape family
(exec/scheduler.note_family_peak).
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["PlanNode", "QueryPlan", "node", "annotate", "active",
           "current", "explain", "explain_analyze", "record_exchange",
           "profile_keys", "key_profile", "render_tree"]

#: default Misra-Gries capacity of a node's key profile
SKETCH_K = 16

_TLS = threading.local()


def _profile():
    return getattr(_TLS, "profile", None)


def active() -> bool:
    """A query profile is collecting on this thread (one TLS load)."""
    return getattr(_TLS, "profile", None) is not None


class PlanNode:
    """One operator invocation in a query's plan tree."""

    __slots__ = ("op", "attrs", "children", "rows_in", "rows_out",
                 "rows_exchanged", "bytes_exchanged", "exchanges",
                 "phases", "dispatch_s", "block_s", "seconds", "events",
                 "heavy", "_scope", "_scope_cm", "_ev0")

    def __init__(self, op: str, attrs: dict):
        self.op = op
        self.attrs = dict(attrs)
        self.children: list[PlanNode] = []
        self.rows_in = None
        self.rows_out = None
        self.rows_exchanged = 0
        self.bytes_exchanged = 0
        self.exchanges: list[dict] = []
        self.phases = None          # self-time region table (analyze)
        self.dispatch_s = None
        self.block_s = None
        self.seconds = None         # self seconds, children excluded
        self.events = None          # counter deltas, children included
        self.heavy = None           # Misra-Gries key profile
        self._scope = None
        self._scope_cm = None
        self._ev0 = None

    def __bool__(self) -> bool:
        return True

    def set(self, **kw) -> None:
        """Set ``rows_in``/``rows_out``, or extend ``attrs``."""
        for k, v in kw.items():
            if k in ("rows_in", "rows_out"):
                setattr(self, k, int(v))
            else:
                self.attrs[k] = v

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    # -- reporting --------------------------------------------------------
    def total_seconds(self) -> float:
        """Inclusive seconds: self plus children."""
        own = self.seconds or 0.0
        return own + sum(c.total_seconds() for c in self.children)

    def total_bytes_exchanged(self) -> int:
        return self.bytes_exchanged \
            + sum(c.total_bytes_exchanged() for c in self.children)

    def static_dict(self) -> dict:
        """The measurement-free tree: two runs of one query give equal
        static dicts."""
        return {"op": self.op,
                "attrs": {k: self.attrs[k] for k in sorted(self.attrs)},
                "children": [c.static_dict() for c in self.children]}

    def to_dict(self) -> dict:
        out = {"op": self.op,
               "attrs": {k: self.attrs[k] for k in sorted(self.attrs)}}
        if self.rows_in is not None:
            out["rows_in"] = self.rows_in
        if self.rows_out is not None:
            out["rows_out"] = self.rows_out
        if self.rows_exchanged:
            out["rows_exchanged"] = self.rows_exchanged
            out["bytes_exchanged"] = self.bytes_exchanged
        if self.seconds is not None:
            out["self_s"] = round(self.seconds, 6)
            out["dispatch_s"] = round(self.dispatch_s, 6)
            out["block_s"] = round(self.block_s, 6)
            out["total_s"] = round(self.total_seconds(), 6)
        if self.phases:
            out["phases"] = self.phases
        if self.events:
            out["events"] = self.events
        if self.heavy is not None:
            out["heavy_hitters"] = self.heavy
        out["children"] = [c.to_dict() for c in self.children]
        return out


class _NoopNode:
    """The unarmed stand-in: falsy, swallows every write."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def set(self, **kw) -> None:
        pass

    def annotate(self, **attrs) -> None:
        pass


_NOOP = _NoopNode()


class QueryPlan:
    """The result of :func:`explain` / :func:`explain_analyze`."""

    def __init__(self, mode: str):
        self.mode = mode            # "explain" | "analyze"
        self.roots: list[PlanNode] = []
        self.result = None          # the profiled callable's return value
        self.global_phases: dict = {}
        self.comm: dict | None = None
        self.keys_enabled = True
        self._outer = None

    def static_dict(self) -> dict:
        return {"mode": "explain",
                "roots": [r.static_dict() for r in self.roots]}

    def to_dict(self) -> dict:
        out = {"mode": self.mode,
               "roots": [r.to_dict() for r in self.roots]}
        if self.mode == "analyze":
            out["global_phases"] = self.global_phases
            out["reconcile"] = self.reconcile()
        if self.comm is not None:
            out["comm_matrix"] = self.comm
        return out

    def render(self) -> str:
        return render_tree(self.to_dict())

    def reconcile(self) -> dict:
        """Per-region seconds summed over every node's SELF table against
        the process-wide phase table of the run: both saw the same region
        durations, grouped differently, so they agree to float summation
        order.  Regions that ran outside every node land in
        ``unattributed_s``."""
        per_name: dict = {}

        def walk(n: PlanNode):
            for k, v in (n.phases or {}).items():
                per_name[k] = per_name.get(k, 0.0) + v["s"]
            for c in n.children:
                walk(c)

        for r in self.roots:
            walk(r)
        node_s = sum(per_name.values())
        glob_s = sum(v["s"] for v in self.global_phases.values())
        return {"node_s": round(node_s, 6),
                "phase_s": round(glob_s, 6),
                "unattributed_s": round(glob_s - node_s, 6),
                "per_phase_node_s": {k: round(v, 6)
                                     for k, v in sorted(per_name.items())}}


# ---------------------------------------------------------------------------
# the context-manager facade
# ---------------------------------------------------------------------------

def _push_node(op: str, attrs: dict, prof: QueryPlan) -> PlanNode:
    n = PlanNode(op, attrs)
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    if stack:
        stack[-1].children.append(n)
    else:
        prof.roots.append(n)
    stack.append(n)
    return n


def _pop_node(n: PlanNode) -> None:
    stack = getattr(_TLS, "stack", None)
    if stack and stack[-1] is n:
        stack.pop()


def current() -> PlanNode | None:
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


def annotate(**attrs) -> None:
    """Merge attributes into the current node (a route decided deep
    inside an operator).  No-op without an active profile."""
    if getattr(_TLS, "profile", None) is None:
        return
    n = current()
    if n is not None:
        n.annotate(**attrs)


def _event_counters() -> tuple:
    from ..exec import recovery
    from . import metrics
    return (metrics.counter("memory_spill_events").value,
            metrics.counter("ckpt_checkpoint_events").value,
            len(recovery.recovery_events()))


class _NodeCtx:
    """One operator's context manager: a no-op without a profile;
    otherwise a pushed node and, in analyze mode, a node-scoped
    attribution scope whose table becomes the node's self-time phases."""

    __slots__ = ("_op", "_attrs", "_node", "_prof")

    def __init__(self, op: str, attrs: dict):
        self._op = op
        self._attrs = attrs
        self._node = None
        self._prof = None

    def __enter__(self):
        prof = getattr(_TLS, "profile", None)
        if prof is None:
            return _NOOP
        self._prof = prof
        n = self._node = _push_node(self._op, self._attrs, prof)
        if prof.mode == "analyze":
            from ..utils import timing
            n._scope_cm = timing.attribution_scope(f"plan:{self._op}")
            n._scope = n._scope_cm.__enter__()
            n._ev0 = _event_counters()
        return n

    def __exit__(self, exc_type, exc, tb):
        n = self._node
        if n is None:
            return False
        if n._scope_cm is not None:
            n._scope_cm.__exit__(exc_type, exc, tb)
            sc, n._scope, n._scope_cm = n._scope, None, None
            from ..utils import timing
            n.phases = sc.detail()
            n.seconds = sc.total_seconds()
            dispatch, block = timing.split_snapshot(sc.snapshot())
            n.dispatch_s = sum(dispatch.values())
            n.block_s = sum(block.values())
            ev1 = _event_counters()
            n.events = {k: max(b - a, 0) for k, (a, b) in zip(
                ("spill_events", "checkpoint_events", "recovery_events"),
                zip(n._ev0, ev1))}
            # a scope enclosing the whole profile (a serving session)
            # takes each node's self table once, so it sees the same
            # seconds with profiling on or off
            outer = self._prof._outer
            if outer is not None:
                outer.absorb(sc)
        _pop_node(n)
        return False


def node(op: str, **attrs) -> _NodeCtx:
    """Open a plan node for one operator invocation::

        with plan.node("join", how=how, on=tuple(left_on)) as pn:
            ...
            if pn:
                pn.set(rows_out=out.row_count)

    Yields the :class:`PlanNode` (truthy) with a profile active, else a
    falsy no-op stand-in, so ``if pn:`` keeps the unarmed path free."""
    return _NodeCtx(op, attrs)


# ---------------------------------------------------------------------------
# exchange and key-profile recording
# ---------------------------------------------------------------------------

def record_exchange(counts, row_bytes: int, site: str = "exchange",
                    tiers: dict | None = None) -> None:
    """Attach one exchange's totals to the innermost node and, only with
    the comm matrix armed, accumulate its (src, dst) matrix.  The
    exchange calls this only when a profile is active or the matrix is
    armed; a profile alone leaves obs/comm's state untouched, so a later
    armed report still equals its own counter deltas.  ``tiers`` (a
    topology of two or more slices, parallel/shuffle._tier_counters)
    passes to the comm matrix, and the node's exchange record gets its
    ``route``."""
    import numpy as np
    from . import comm
    rows = int(np.asarray(counts).sum())
    nbytes = rows * int(row_bytes)
    if comm.armed():
        comm.record(counts, row_bytes, site=site, tiers=tiers)
    n = current()
    if n is not None:
        n.rows_exchanged += rows
        n.bytes_exchanged += nbytes
        ent = {"site": site, "rows": rows, "bytes": nbytes}
        if tiers is not None:
            ent["route"] = tiers["route"]
        n.exchanges.append(ent)


def profile_keys(pn, table, key_names, k: int = SKETCH_K) -> None:
    """Attach a heavy-hitter profile of ``table``'s key columns to node
    ``pn`` in an analyze run that asked for key profiles; one truthiness
    check otherwise."""
    if not pn:
        return
    prof = _profile()
    if prof is None or prof.mode != "analyze" or not prof.keys_enabled:
        return
    pn.heavy = key_profile(table, key_names, k=k)


def key_profile(table, key_names, k: int = SKETCH_K,
                m: int | None = None) -> dict | None:
    """Heavy-hitter profile of ``table``'s key columns from an evenly
    spaced per-shard sample (relational/common.sample_keys): the heavy
    keys with their estimated shares, the top key's share, and
    ``est_rows_per_rank``, each tracked key placed on its hash partition
    and the untracked rest spread evenly — the per-rank rows plain hash
    partitioning would give.  None for an empty table."""
    import numpy as np

    from ..ops.hashing import partition_of
    from ..relational.common import sample_keys
    from .sketch import MisraGries

    key_names = [key_names] if isinstance(key_names, str) else list(key_names)
    sampled = sample_keys(table, key_names, m=m, with_hashes=True)
    if sampled is None:
        return None
    values, weights, total_rows, hashes = sampled
    mg = MisraGries(k=k)
    mg.update(values, weights)
    w = table.env.world_size
    shares = mg.shares()
    heavy = [{"key": kv, "share": round(sh, 6), "err": round(err, 6)}
             for kv, sh, err in shares if sh > max(err, 1.0 / (2 * k))]
    top = shares[0][1] if shares else 0.0
    covered = min(sum(sh for _, sh, _ in shares), 1.0)
    id2hash = {}
    for v, h in zip(values.tolist(), hashes.tolist()):
        id2hash.setdefault(v, int(h))
    per_rank = np.full(w, (1.0 - covered) / w * total_rows)
    for kv, sh, _err in shares:
        h = id2hash.get(kv)
        if h is None:
            per_rank += sh * total_rows / w
        else:
            per_rank[partition_of(h, w)] += sh * total_rows
    return {
        "keys": key_names,
        "sampled": int(len(values)),
        "rows": int(total_rows),
        "k": k,
        "heavy": heavy,
        "max_key_share": round(top, 6),
        "est_max_rank_share": round(top + max(1.0 - covered, 0.0) / w, 6),
        "est_rows_per_rank": [int(round(x)) for x in per_rank],
    }


# ---------------------------------------------------------------------------
# explain / explain_analyze
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _query_profile(mode: str):
    if getattr(_TLS, "profile", None) is not None:
        from ..status import InvalidError
        raise InvalidError("a query profile is already active on this "
                           "thread — explain/explain_analyze do not nest")
    prof = QueryPlan(mode)
    if mode == "analyze":
        from ..utils import timing
        prof._outer = timing._scope()
    _TLS.profile = prof
    _TLS.stack = []
    try:
        yield prof
    finally:
        _TLS.profile = None
        _TLS.stack = []


def explain(fn, *args, **kwargs) -> QueryPlan:
    """Run ``fn(*args, **kwargs)`` collecting the plan: the STATIC tree
    (operators, keys, routes, chunking), no timing, sampling or counter
    reads.  The query runs (plans are discovered by running)."""
    with _query_profile("explain") as prof:
        prof.result = fn(*args, **kwargs)
    return prof


def explain_analyze(fn, *args, reset_timings: bool = True,
                    profile_keys: bool = True, family: str | None = None,
                    **kwargs) -> QueryPlan:
    """:func:`explain` plus measurements.  Timing is armed for the call
    (``async`` unless the caller's mode is on already; the caller's mode
    comes back after), the phase table is reset first
    (``reset_timings=False`` accumulates), the query runs under per-node
    attribution scopes, and the phase table is kept for
    :meth:`QueryPlan.reconcile`.  With the comm matrix armed its report is
    attached as ``comm_matrix``.  ``profile_keys=False`` skips the
    per-node key sampling, the one part that adds device work and host
    pulls of its own.  ``family`` names the query's admission shape
    family: the run's peak ledger bytes are recorded against it
    (exec/scheduler.note_family_peak), and a serving session submitted
    with that ``shape_family`` is admitted at min(declared, observed
    peak x safety factor)."""
    from ..utils import timing
    from . import comm

    prev = timing.mode()
    if prev is None:
        timing.enable("async")
    if reset_timings:
        timing.reset()
    if comm.armed():
        comm.reset()
    try:
        with _query_profile("analyze") as prof:
            prof.keys_enabled = bool(profile_keys)
            prof.result = fn(*args, **kwargs)
            prof.global_phases = timing.detail()
    finally:
        timing.enable(prev)
    if comm.armed():
        prof.comm = comm.report()
    if family is not None:
        from ..exec import memory, scheduler
        scheduler.note_family_peak(
            family, int(memory.stats()["peak_ledger_bytes"]))
    return prof


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _node_line(d: dict) -> str:
    bits = [d["op"]]
    attrs = d.get("attrs") or {}
    if attrs:
        bits.append("[" + " ".join(f"{k}={attrs[k]}"
                                   for k in sorted(attrs)) + "]")
    rio = []
    if "rows_in" in d:
        rio.append(f"rows={d['rows_in']}")
    if "rows_out" in d:
        rio.append(f"out={d['rows_out']}")
    if d.get("bytes_exchanged"):
        rio.append(f"xchg={d['bytes_exchanged']}B")
    if "total_s" in d:
        rio.append(f"self={d['self_s']:.4f}s total={d['total_s']:.4f}s "
                   f"(dispatch {d['dispatch_s']:.4f} / "
                   f"block {d['block_s']:.4f})")
    if rio:
        bits.append("(" + ", ".join(rio) + ")")
    hh = d.get("heavy_hitters")
    if hh and hh.get("heavy"):
        top = hh["heavy"][0]
        bits.append(f"hot[{top['key']}≈{top['share']:.1%}]")
    if hh and hh.get("est_rows_per_rank"):
        per = hh["est_rows_per_rank"]
        tot = sum(per) or 1
        hot_r = max(range(len(per)), key=per.__getitem__)
        bits.append(f"rank_max[r{hot_r}≈{per[hot_r] / tot:.1%} of rows]")
    return " ".join(bits)


def render_tree(plan_dict: dict) -> str:
    """ASCII tree of a :meth:`QueryPlan.to_dict` payload."""
    lines = [f"query plan ({plan_dict.get('mode', 'explain')})"]

    def walk(d, prefix, last):
        lines.append(prefix + ("└─ " if last else "├─ ") + _node_line(d))
        kids = d.get("children") or []
        for i, c in enumerate(kids):
            walk(c, prefix + ("   " if last else "│  "),
                 i == len(kids) - 1)

    roots = plan_dict.get("roots") or []
    for i, r in enumerate(roots):
        walk(r, "", i == len(roots) - 1)
    rec = plan_dict.get("reconcile")
    if rec:
        lines.append(f"phases: node {rec['node_s']}s / global "
                     f"{rec['phase_s']}s (unattributed "
                     f"{rec['unattributed_s']}s)")
    return "\n".join(lines)
