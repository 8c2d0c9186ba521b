"""The collective facades' declared transport kinds (the port's
counterpart of ``cylon_tpu/analysis/registry.py``'s program
declarations).

The reference declares, per jit program factory, the collectives its
traced program must hold, and its jaxpr pass checks them (JX205).  The
port traces nothing: its collectives are the transport's functions
(``parallel/transport.py``), called from eager Python.  So the
declaration is per *facade*: the function an operator calls, and the set
of transport kinds (:data:`~.coherence.TRANSPORT_KINDS`) that its call
graph may reach, the host funnel's allgathers included.
:mod:`.collective_check` (CL201, ``--strict``) holds each declared
facade's reachable kinds equal to its declaration: a facade that grows a
collective, or loses one, changes its communication contract and must
say so here.

Import-light: nothing here imports the package or torch.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FacadeDecl:
    #: the defining module's path under the package (``parallel/shuffle.py``)
    module: str
    #: the function's module-relative name (``exchange``, ``Cls.method``)
    qualname: str
    #: transport kinds its call graph may reach
    kinds: frozenset

    @property
    def name(self) -> str:
        return f"{self.module}::{self.qualname}"


_DECLS: dict[str, FacadeDecl] = {}


def declare_facade(module: str, qualname: str, kinds) -> FacadeDecl:
    d = FacadeDecl(module, qualname, frozenset(kinds))
    _DECLS[d.name] = d
    return d


def all_declarations() -> list[FacadeDecl]:
    return list(_DECLS.values())


_VOTE = {"all_reduce_max"}
#: a fingerprint: the processes' words allgathered (exec/integrity._pull_fp)
_FP = {"allgather_array"}
#: the exchange engine: the rows, the receive guard's vote and the
#: audit's voted fingerprints
_EXCHANGE = {"all_to_all_rows"} | _VOTE | _FP
#: an exchange with its count matrix made first
_SHUFFLE = _EXCHANGE | {"allgather_counts"}

# the transport's composite entries over its primitives
declare_facade("parallel/transport.py", "allgather_array",
               {"allgather_tensor"})
declare_facade("parallel/transport.py", "allgather_rows",
               {"allgather_tensor"})
declare_facade("parallel/transport.py", "allgather_counts",
               {"allgather_tensor"})
declare_facade("parallel/transport.py", "barrier", _VOTE)
# the host funnel: a multi-process pull gathers the other processes' rows
declare_facade("utils/host.py", "host_array", _FP)
declare_facade("utils/host.py", "host_arrays", _FP)
# the exchange engine and its callers
declare_facade("parallel/shuffle.py", "count_targets",
               {"allgather_counts"} | _FP)
declare_facade("parallel/shuffle.py", "_exchange_procs",
               {"all_to_all_rows"})
declare_facade("parallel/shuffle.py", "exchange", _EXCHANGE)
declare_facade("topo/exchange.py", "two_hop", {"all_to_all_rows"})
declare_facade("relational/repart.py", "shuffle_table", _SHUFFLE)
declare_facade("relational/skew.py", "split_exchange",
               _SHUFFLE | {"allgather_tensor"})
# the table collectives
declare_facade("parallel/collectives.py", "allgather_table",
               {"allgather_tensor"})
declare_facade("parallel/collectives.py", "bcast_table", {"broadcast"})
declare_facade("parallel/collectives.py", "allreduce",
               {"allgather_rows"} | _FP)
declare_facade("parallel/collectives.py", "gather_table", _EXCHANGE)
# the votes: one all-reduce(MAX) each (exec/recovery.py)
for _vote in ("_consensus_wire", "consensus_code", "guard_consensus",
              "spill_consensus", "count_consensus", "preempt_consensus",
              "footprint_consensus", "drain_consensus",
              "ckpt_commit_consensus", "ckpt_resume_consensus",
              "watermark_consensus", "skew_plan_consensus",
              "topo_plan_consensus", "fingerprint_consensus"):
    declare_facade("exec/recovery.py", _vote, _VOTE)
# the integrity facade's verbs; the resume audit compares with the
# manifest's recorded value, after the restore's own vote
declare_facade("exec/integrity.py", "verify_exchange", _VOTE | _FP)
declare_facade("exec/integrity.py", "audit_table", _VOTE | _FP)
declare_facade("exec/integrity.py", "audit_restored_table", _FP)
