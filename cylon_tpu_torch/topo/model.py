"""The multi-slice topology model: slice maps, gateway assignment and the
topology plan (port of ``cylon_tpu/topo/model.py``).

A two-tier fabric joins the ranks inside a slice with a fast link (one
card's memory, or NVLink between the cards of a node: the reference's
ICI) and the slices with a slower one (InfiniBand or Ethernet between
nodes: the reference's DCN).  The reports keep the reference's names:
"ici" is the tier inside a slice, "dcn" the tier across slices.

1. **Discovery.** ``CYLON_TPU_TORCH_SLICES=<n>`` declares n contiguous
   slices over the world's ranks (config.SLICES_ENV; read once,
   :func:`_reslice` re-reads it).  A declaration counts only when
   ``2 <= n <= W`` and n divides W; anything else is one slice, never an
   error.  Without a declaration a multi-process world
   (ctx/context.DistributedConfig) groups its processes by host: the
   processes of one host form a slice (:func:`host_slices`), where the
   reference reads its devices' ``slice_index``.  Only a uniform layout
   whose slices are contiguous process blocks counts.

2. **Slice-major layout.** Rank r lives in slice ``r // R`` at local
   index ``r % R`` (R ranks per slice).  The port numbers a distributed
   world process-major, so a slice of whole processes is slice-major
   already.

3. **Gateways.** Hop 1 of the two-hop route sends a row bound for rank d
   to the rank of its own slice whose local index is ``d % R``
   (:func:`gateway_of`); hop 2 is then one aggregated exchange between
   ranks of the same local index.

4. **Plan and vote.** The route choice is a :class:`TopologyPlan` whose
   sha256 hash is voted (exec/recovery.topo_plan_consensus,
   ``Code.TopoPlan``) once per env layout before the first hierarchical
   exchange.  Across processes the route also needs every slice to be
   made of whole processes (``R % V == 0``); otherwise the plan routes
   flat, on every process alike.

On a single-slice topology :func:`hier_plan` is one cached lookup that
returns None: no vote, no collective, no host sync.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from .. import config

__all__ = ["Topology", "TopologyPlan", "topology", "hier_plan",
           "ensure_adopted", "last_plan", "tier_split", "gateway_of",
           "slice_major_order", "declared_slices", "host_slices"]

#: the declaration, read once at the first topology() (None: unread)
_DECLARED: list = [None]

#: plan identities voted in this process: (env layout, transport
#: generation, plan hash)
_ADOPTED: set = set()

#: the most recently voted plan
_LAST: list = [None]

#: (kind, env layout, declared[, armed]) -> Topology / TopologyPlan
_CACHE: dict = {}


def declared_slices() -> int | None:
    """The ``CYLON_TPU_TORCH_SLICES`` declaration (cached), or None."""
    d = _DECLARED[0]
    if d is None:
        raw = os.environ.get(config.SLICES_ENV, "")
        try:
            d = int(raw) if raw else 0
        except ValueError:
            d = 0
        _DECLARED[0] = d
    return d if d > 0 else None


def _reslice() -> None:
    """Read the declaration again at the next topology(), and forget the
    voted plans: a re-declared world is a new topology and votes
    again."""
    _DECLARED[0] = None
    _ADOPTED.clear()
    _LAST[0] = None
    _CACHE.clear()


class Topology:
    """The tier model of one world: ``world`` ranks in ``n_slices``
    uniform slices of ``ranks_per_slice``, slice-major."""

    __slots__ = ("world", "n_slices", "ranks_per_slice", "source")

    def __init__(self, world: int, n_slices: int, source: str):
        self.world = int(world)
        self.n_slices = int(n_slices)
        self.ranks_per_slice = self.world // max(self.n_slices, 1)
        self.source = source      # "env" | "device" | "single"

    def slice_of(self, rank: int) -> int:
        return int(rank) // self.ranks_per_slice

    def slice_ids(self) -> np.ndarray:
        """(W,) int32 per-rank slice ids, the key the comm matrix splits
        its tiers on."""
        return (np.arange(self.world, dtype=np.int32)
                // self.ranks_per_slice)

    def cross_mask(self) -> np.ndarray:
        """(W, W) bool: cell (s, d) crosses slices."""
        sid = self.slice_ids()
        return sid[:, None] != sid[None, :]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Topology(world={self.world}, slices={self.n_slices}x"
                f"{self.ranks_per_slice}, source={self.source})")


def _device_slices(devices) -> list | None:
    """Per-device slice ids from a ``slice_index`` attribute, or None when
    one is absent or all are equal."""
    ids = []
    for d in devices:
        s = getattr(d, "slice_index", None)
        if s is None:
            return None
        ids.append(int(s))
    return ids if len(set(ids)) > 1 else None


def slice_major_order(devices) -> list:
    """``devices`` reordered slice-major (stable within a slice) when each
    carries a ``slice_index``; otherwise untouched."""
    ids = _device_slices(devices)
    if ids is None:
        return list(devices)
    order = sorted(range(len(devices)), key=lambda i: (ids[i], i))
    return [devices[i] for i in order]


def host_slices(hosts, local_world: int) -> list | None:
    """Per-rank slice ids of a process-major world whose process p runs
    on ``hosts[p]`` with ``local_world`` ranks: the processes of one host
    form a slice, numbered in order of first appearance.  None (one
    slice) when every process shares a host, and when the layout is not
    uniform or a host's processes are not one contiguous block."""
    first: dict = {}
    ids = [first.setdefault(h, len(first)) for h in hosts]
    if len(first) < 2:
        return None
    per = [ids.count(s) for s in range(len(first))]
    if len(set(per)) != 1 or ids != sorted(ids):
        return None
    return [s for s in ids for _ in range(int(local_world))]


def _env_ident(env) -> tuple:
    """The env's layout: world size, process count, local world and
    device."""
    return (env.world_size, env.process_count, env.local_world,
            str(env.device))


def _env_slices(env) -> list | None:
    from ..parallel import transport
    proc = transport.current(env.world_size)
    if proc is None or proc.nproc < 2 or not proc.hosts:
        return None
    return host_slices(proc.hosts, proc.local)


def _topology_for(env, declared: int | None) -> Topology:
    key = ("topo", _env_ident(env), declared)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    t = _CACHE[key] = _build_topology(env, declared)
    return t


def _build_topology(env, declared: int | None) -> Topology:
    w = int(env.world_size)
    if declared is not None:
        if 2 <= declared <= w and w % declared == 0:
            return Topology(w, declared, "env")
        return Topology(w, 1, "single")
    ids = _env_slices(env)
    if ids is None:
        return Topology(w, 1, "single")
    n = len(set(ids))
    per = [ids.count(s) for s in sorted(set(ids))]
    if len(set(per)) != 1 or ids != sorted(ids):
        return Topology(w, 1, "single")
    return Topology(w, n, "device")


def topology(env) -> Topology:
    """The (cached) tier model of ``env``'s world."""
    return _topology_for(env, declared_slices())


def gateway_of(dest: int, src_slice: int, ranks_per_slice: int) -> int:
    """Hop 1's gateway: the rank of ``src_slice`` whose local index is
    ``dest``'s, where rows bound for global rank ``dest`` gather."""
    return src_slice * ranks_per_slice + (dest % ranks_per_slice)


class TopologyPlan:
    """The voted route choice of one world: the tier map, the gateway
    scheme and flat or hierarchical, with a canonical hash over every
    field that shapes the collectives."""

    __slots__ = ("world", "n_slices", "ranks_per_slice", "route",
                 "gateway", "source", "_hash")

    def __init__(self, topo: Topology, route: str):
        self.world = topo.world
        self.n_slices = topo.n_slices
        self.ranks_per_slice = topo.ranks_per_slice
        self.route = route                 # "hierarchical" | "flat"
        self.gateway = "local-index"       # the one scheme
        self.source = topo.source
        self._hash = None

    def plan_hash(self) -> int:
        """The 64-bit plan identity: the first 8 bytes of a sha256 of the
        collective-shaping fields, the reference's value for the same
        world and declaration."""
        if self._hash is None:
            h = hashlib.sha256()
            h.update(repr((self.world, self.n_slices,
                           self.ranks_per_slice, self.route,
                           self.gateway)).encode())
            self._hash = int.from_bytes(h.digest()[:8], "big")
        return self._hash

    def summary(self) -> dict:
        """The JSON-friendly decision record."""
        return {"route": self.route,
                "n_slices": int(self.n_slices),
                "ranks_per_slice": int(self.ranks_per_slice),
                "gateway": self.gateway,
                "source": self.source,
                "plan_hash": format(self.plan_hash(), "016x")}


def _plan_for(env, declared: int | None, armed: bool) -> TopologyPlan:
    key = ("plan", _env_ident(env), declared, armed)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    topo = _topology_for(env, declared)
    r_ = topo.ranks_per_slice
    hier = (armed and topo.n_slices >= 2 and r_ >= 2
            and (env.process_count == 1 or r_ % env.local_world == 0))
    plan = _CACHE[key] = TopologyPlan(topo,
                                      "hierarchical" if hier else "flat")
    return plan


def hier_plan(env) -> TopologyPlan | None:
    """The world's plan when it routes hierarchically, else None (one
    cached lookup).  ``ranks_per_slice == 1`` routes flat: hop 2 would be
    the whole exchange and hop 1 pure overhead; so does a multi-process
    world whose slices are not whole processes."""
    plan = _plan_for(env, declared_slices(), config.TOPO_SHUFFLE)
    return plan if plan.route == "hierarchical" else None


def ensure_adopted(env, plan: TopologyPlan) -> None:
    """Vote the plan's hash (``Code.TopoPlan``) once per (env layout,
    plan), before the first hierarchical exchange; a process whose plan
    differs raises ``RankDesyncError`` there.  In a multi-process world
    the hops' process subgroups are made after the vote
    (parallel/transport.hop_groups)."""
    from ..parallel import transport
    proc = transport.current(env.world_size)
    ident = (_env_ident(env), None if proc is None else proc.generation,
             plan.plan_hash())
    if ident in _ADOPTED:
        return
    from ..exec.recovery import topo_plan_consensus
    from ..obs import metrics as _metrics
    topo_plan_consensus(env, plan.plan_hash())
    if proc is not None and proc.nproc > 1:
        transport.hop_groups(plan.n_slices, plan.ranks_per_slice)
    _ADOPTED.add(ident)
    _LAST[0] = plan
    _metrics.counter("topo_plans_voted").inc()


def last_plan() -> TopologyPlan | None:
    """The most recently voted plan (None while every exchange routed
    flat)."""
    return _LAST[0]


def tier_split(counts: np.ndarray, topo: Topology) -> tuple[int, int]:
    """(ici_rows, dcn_rows) of one exchange's count matrix: same-slice
    cells stay inside a slice, cross-slice cells cross once whichever
    route carries them."""
    c = np.asarray(counts, np.int64)
    if topo.n_slices <= 1:
        return int(c.sum()), 0
    cross = topo.cross_mask()
    dcn = int(c[cross].sum())
    return int(c.sum()) - dcn, dcn
