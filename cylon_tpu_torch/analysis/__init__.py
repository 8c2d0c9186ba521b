"""cylon_tpu_torch.analysis: the port's analysis gate (port of
``cylon_tpu/analysis``).

The reference's gate guards a shard_map/XLA program stack; the port is
eager PyTorch whose collectives are ``torch.distributed`` calls behind
``parallel/transport.py``, whose host pulls go through ``utils/host.py``
and whose compiles are the ``nvcc``/``g++`` builds behind
``exec/compiler.py``.  Four cooperating parts:

1. **AST lint** (:mod:`.ast_lint`, TS1xx) — per-file hazards: host
   syncs outside the funnel, raw builds outside the compile tier, and
   the facade rules (checkpoint, admission, streams, counters, plan
   stack, spill pages, skew and topology plans, integrity);
2. **collective coherence** (:mod:`.coherence`, CX4xx) — the call graph
   from the transport up, taint and vote dominance;
3. **collective contracts** (:mod:`.collective_check`, CL2xx) — each
   declared facade's (:mod:`.registry`) reachable transport kinds, and
   the processes' runtime collective logs against each other;
4. **the runtime sentinel** (:mod:`.runtime`, RT3xx) — funnel pulls,
   kernel builds, the collective log and, on the card, stray syncs;
   armed by ``runtime.enable()`` or ``CYLON_TPU_TORCH_TRACECHECK=1``.

CLI: ``python -m cylon_tpu_torch.analysis [paths] [--strict]
[--list-rules] [--json FILE] [--audit-suppressions]
[--fail-stale-suppressions] [--no-cache]``.  This package imports
neither jax nor anything of ``cylon_tpu``.
"""

from . import runtime  # noqa: F401
from .ast_lint import lint_file, lint_paths, lint_source  # noqa: F401
from .coherence import (analyze_files, analyze_paths,  # noqa: F401
                        analyze_source)
from .collective_check import check_facades, compare_logs  # noqa: F401
from .registry import (FacadeDecl, all_declarations,  # noqa: F401
                       declare_facade)
from .rules import RULES, Finding  # noqa: F401
