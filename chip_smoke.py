"""Smoke run of cylon_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--rows N] [--config3-rows N] [--fact-rows N]
                          [--string-rows N] [--scan-rows N] [--skew-rows N]
                          [--tpch-scale SF] [--oom-rows N]
                          [--stream-batches N] [--ckpt-dir DIR]

Builds the package's CUDA kernels from the sources in this checkout (one
nvcc per source, all at once), holds each against its plain PyTorch
version on the card, then drives the BASELINE workload (bench.py's inner
join of two int64 {k, payload} tables, seed 42, keys uniform in
[0, 0.9 n), then a groupby-sum on the join key) through the package's
public entry points and checks every result against a numpy oracle
(the BASELINE oracle, and the join-type oracle from 16M rows a side,
take their per-key sums on the card with torch, each held equal to
numpy's at 1M rows first):

* the monolithic route, ``join_tables`` -> ``groupby_aggregate``, at 1M
  rows per side and at ``--rows`` per side (default 125M);
* bench.py's pipelined route at ``--rows`` per side on the same tables:
  ``GroupBySink`` + ``pipelined_join(n_chunks=max(2, ceil(rows / 21M)))``
  + ``finalize``, whose splitter probe is K2 and whose pieces' run-start
  gather is K1.

``compile_small`` (its children beside ``joins_small``, below) drives the
compile tier
(exec/compiler.py) with a fresh ``CYLON_TPU_TORCH_COMPILE_CACHE_DIR``:
this process builds K1 and K2 cold through the facade (two ``nvcc``
builds, their seconds, two manifest entries); ``--compile-child``
processes then load them as hits with no build (K1 and K2 bit-equal to
their plain versions at the main path's shapes, on seeded card inputs),
drop and rebuild a copy whose K1 manifest entry is poisoned and one byte
of whose K2 library is flipped (both bit-equal again), die under ``compile.build=kill`` with their intent on disk (the
next child raises ``CompileQuarantinedError``), and raise
``CompileTimeoutError`` under ``compile.build=stall`` with a 2 s budget.
``analysis_gate`` runs beside them too: the port's analysis gate,
``python -m cylon_tpu_torch.analysis --strict --fail-stale-suppressions``,
as a child on this machine's Python, which must exit 0.

Each kernel is also held against its plain version on the inputs its
routes handed it, captured in one more run of each: K1 at the monolithic
route's gather and at one pipelined piece's, K2 at the pipelined probe.
K1 takes its lanes as an (L, M) matrix or as a list of lanes; every small
case runs in both forms.  K2 is checked on both of its kernel paths
(packed keys and the general path) wherever they admit a case's operands,
and timed at the pipelined inputs through its wrapper (``ms``), on a
prepared descriptor (``kernel_ms``), on the same operands one element in
(``scalar_ms``, its scalar-load path) and on its general path
(``general_ms``).  The general path is also timed on the key structures it
serves, at the same rows: the same keys as three int32 operands (read
directly) and as a wide int64 key (hi int32, lo u32: one image row).

The same workload then runs at world sizes above 1, on a
``VirtualMeshConfig`` world (W ranks on the one card; the exchange is a
device-local permutation), both routes each time:

* ``dist_small``: W = 8 and W = 3 at 1M rows per side; besides the
  oracle, every result group must sit on the shard that a numpy copy of
  the reference's row hash (kept here, independent of the package)
  assigns it;
* ``dist_path``: W = 4 at ``--rows`` per side in total, the monolithic
  route timed like the W = 1 one, with its phase split (hash, exchange,
  skew detect, join, fused groupby) and K1 launched once per shard per
  iteration; ``dist_path_unarmed``: the same join with the port's skew
  split off, timed and profiled, so what arming costs a uniform join;
* ``procs_gloo`` and ``procs_nccl``: the multi-process transport
  (ctx/context.DistributedConfig) on the same tables, the parent's
  tables freed first: 2 child processes × 2 ranks over gloo (NCCL
  refuses two ranks on one GPU, so the exchange stages through pinned
  host memory; no card-to-card transport is measured), then 1 process ×
  4 ranks over NCCL.  Each child maps bench.py's tables from ``.npy``
  files the parent writes once, uploads its own ranks' blocks, and runs
  the monolithic join → groupby (a warm-up and best of 3) and
  ``pipelined_join(n_chunks=2)`` into a ``GroupBySink``; both results'
  digests (every shard's rows sorted by key, in rank order) must equal
  ``dist_path``'s, K1 and K2 must launch on the child's shards and equal
  their plain versions on their first launch's inputs there.  Per child:
  s/iteration, the bytes that crossed processes, the staging (pinned
  D2H and H2D), wire, count-allgather, vote and set-up seconds, the
  peak memory and the launches; each gloo child then runs one more
  monolithic iteration with the runtime sentinel armed
  (analysis/runtime.py), and both children's collective logs must hold
  the same length and digest (``collective_logs``);
* ``topo_virtual`` (after ``dist_path_unarmed``, on its tables): W = 4
  in this process declared as 2 slices of 2 ranks
  (``CYLON_TPU_TORCH_SLICES``), so the exchange takes the two-hop route
  (topo/exchange.py) as two device-local hops; the monolithic query, a
  warm-up and best of 3 with the skew split off, its digest equal to
  ``dist_path``'s; s/iteration against ``dist_path_unarmed``, the
  gateway capacity, the peak memory and the tier counters;
* ``procs_topo`` (after ``procs_nccl``; its children start beside the
  gloo ones and wait for a go file): 4 processes × 1 rank over gloo with
  2 slices declared.  Each child times the monolithic query on the
  two-hop route (a warm-up and best of 3), runs it once on the flat
  route and once through ``pipelined_join(n_chunks=2)`` into a
  ``GroupBySink`` on the two-hop route; every digest must equal
  ``dist_path``'s, the plan hash must be one on every child, the two-hop
  route's cross-slice messages half the flat route's (R = 2) over the
  same cross-slice rows, and K1 and K2 launch and equal their plain
  versions on the child's shards.  Per child: each hop's bytes and
  staging and wire seconds, the tier counters of one iteration on each
  route and the peak memory.  Then its operator legs (correctness only,
  ``ops_legs``: the set operations, ``unique``, ``equals``,
  ``pipelined_set_op``, a Series filter, ``loc``/``iloc`` and TPC-H Q3
  and Q8 at SF 0.1 on 1,048,576-row tables) must equal the one-process
  W = 4 world's, which the parent computes first.  One card shows the
  route's code paths and its message count, not a two-tier fabric: the
  wire is loopback TCP;
* ``dist_pipelined_path``: the same tables through the pipelined route,
  ``n_chunks = max(2, ceil(rows per rank / 21M))``, K2 launched on every
  shard;
* at both W = 4 routes, K1 and K2 held bit-equal against their plain
  versions, and timed, on the inputs of their first launch (shard 0),
  captured in each route's attribution run;
* ``obs_path``: observability over the same pipelined step on the same
  tables — the unarmed step (a warm-up, then 3; no file written, no plan
  node, comm entry or trace event); ``obs.explain`` of the pipelined
  step (the ``pipelined_join`` node, route ``range_pipeline``, its
  ``join.piece`` and ``shuffle`` children) and of the monolithic one
  (``join`` route ``hash`` or ``skew_split``, ``groupby`` route
  ``fused_pushdown``); ``obs.explain_analyze`` of the pipelined step
  with the comm matrix and the flight recorder armed (a warm-up, then
  3): each run's ``reconcile()`` within the reference's tolerances, its
  comm matrix's sums equal to the exchange counters' increments, the
  exported Chrome trace parsed with one complete event per region call;
  every result bit-equal to the unarmed one, K2 once per shard and K1
  once per shard and piece per iteration; the registry's Prometheus text
  and JSON snapshot; the key profile of a 90%-hot copy of the key within
  2x of the truth; then the env's ``gather`` (rank 0, in global order),
  ``bcast`` (rank 0's block on every shard), ``allreduce`` (sum, min,
  max against numpy) and ``barrier`` on the left table, timed;
* ``integrity_path``: the integrity tier (exec/integrity.py) on the same
  tables with ``CYLON_TPU_TORCH_AUDIT=1``: the monolithic route armed (a
  warm-up, then 3) in turns with 3 unarmed iterations, the armed digest
  equal to ``dist_path``'s and the audit counters of an iteration (every
  exchange's fingerprint checked and voted, no violation); the pipelined
  route armed, its digest equal to its unarmed run's; the
  ``exchange.corrupt`` drills: a one-shot flip recomputed through the
  4-chunk rung (the groups equal to the unarmed run's), a persistent
  one raising ``DataIntegrityError`` at ``shuffle.recv`` after that one
  retry; an armed configuration-5 split (8,388,608 rows a side, the
  stitch audited, the stitched table equal to the unarmed one); a
  checkpointed pipelined join at 1M rows a side whose last piece's
  recorded fingerprint is tampered, the resume recomputing that piece;
  armed against unarmed seconds and the fingerprint's time, byte bound
  and top aten ops on the 125M-row left table;
* ``analysis_path``: the runtime sentinel (analysis/runtime.py) on the
  same tables: one unarmed and one armed monolithic iteration, one
  unarmed and one armed pipelined one (n_chunks 2), each armed digest
  equal to its unarmed run's; per armed iteration the funnel's pulls
  (utils/host.py) by kind and site, the stray syncs by site (torch's
  CUDA sync debug mode at "warn", the funnel's own apart; no fallback
  if the mode cannot be set), the collective log's length, no kernel
  build in the phase, armed − unarmed seconds and the K1/K2 launches;
* ``exchange``: ``hash_rows`` and ``shuffle_table`` of one side at W = 4,
  timed with CUDA events against their byte bounds, beside one stable
  ``torch.sort`` of the same int32 targets; the count sidecar also at
  W = 8 on as many rows.

Then the sort-based groupby, the sample sort and the DataFrame entry,
each against a numpy oracle:

* ``groupby_small``: 2^18 rows (``SMALL_ROWS``; it was 1M) at
  W = 1 and 3 (``SMALL_WORLDS``) — every groupby op on int64 and
  float64 values (NaN, -0.0) under a nullable key, through the raw
  route, the combine route and the grouped fast path; ``sort_table``
  with both methods, both directions and both null positions, row by row;
  a pipelined join into a ``GroupBySink`` keyed on a payload column;
* ``config3_path``: BASELINE configuration 3, ``DataFrame(...).groupby
  ("k")[["a"]].sum().sort_values("a", ascending=False)`` on 100M rows
  (bench.py's generator), at W = 4 and W = 1: best of 3 after a warm-up,
  rows/s, peak memory, phase split, a profile and the device idle share;
  K1 and K2 must not launch there (no TPU kernel lies on this path);
* ``exchange_gather``: the exchange's row gather on a 4-lane matrix,
  timed beside other forms of the same gather.

Then the join types, the broadcast route and the N-way join:

* ``left_join_path``: the BASELINE tables at ``--rows`` per side on a
  W = 4 world through ``DataFrame(left).merge(DataFrame(right), on="k",
  how="left").groupby("k").sum()``: best of 3 after a warm-up, rows/s,
  peak memory, phase split (shuffle, ``join.sort_count``,
  ``join.materialize``, the groupby), a profile and the device idle
  share; K1 and K2 must not launch (a left join defers nothing);
* ``outer_pipelined_path``: the same tables through ``pipelined_join(
  how="outer", n_chunks=2)`` into a ``GroupBySink`` on ``k``, timed the
  same way; K2 launches once per shard per iteration and is held
  bit-equal to its plain version on shard 0's inputs;
* ``joins_small``: 2^18 rows per side at W = 1 and 3 (``SMALL_WORLDS``)
  — every ``how`` through ``join_tables``; left, right and outer through
  ``pipelined_join`` (n_chunks 3) with and without a ``GroupBySink``; a
  nullable key and a two-column key; the broadcast route with a small
  right side (inner, left, semi, anti) and a small left side (inner,
  right); semi and anti on a probe side where one key holds 40% of the
  rows (the heavy-key spread); ``join_tables_multi`` over three tables,
  inner and left; unsigned min/max and descending sorts, a join with an
  empty side and a groupby of an empty table.  The oracle counts each
  key's rows on both sides with ``np.bincount``; semi and anti rows are
  checked with ``np.isin``, in source order on each shard;
* ``broadcast_path``: a star-schema lookup at W = 4 — ``--fact-rows``
  fact rows (default 125M) over 72,818 keys left-joined to a 65,536-row
  dimension table, then a groupby-sum; the dimension table replicates
  and the fact table never shuffles.

Then the set operations, the redistributions and hashed string keys:

* ``setops_path``: the BASELINE tables at ``--rows`` per side on a W = 4
  world, ``L = df1[["k"]]``, ``R = df2[["k"]]``: ``L.union(R)``,
  ``L.intersect(R)``, ``L.subtract(R)`` and ``df1.drop_duplicates(
  ["k"])``, each best of 3 after a warm-up, with rows/s, peak memory,
  the phase split (hash, exchange, flags with their count pull,
  materialization), a profile and the idle share; the oracle holds each
  result to its key set (every key once) and the kept row of each key;
  K1 and K2 must not launch;
* ``pipelined_setop_path``: ``pipelined_set_op(L, R, "subtract",
  n_chunks=4)`` on the same tables, timed and checked the same way;
* ``repart_path``: ``repartition()`` of the subtraction's uneven output
  onto the even split (timed), then ``head(1000)``, ``tail(1000)`` and
  the middle third, in global order against the host copy;
* ``setops_small``: 2^18 rows at W = 1 and 3 — every set operation
  on two nullable columns (and pipelined at n_chunks 3), unique keep
  first/last on a subset and on all columns, ordered and unordered
  ``equals``, even and specified repartitions, slices across shard
  boundaries, and a hashed-string join, groupby and sort (the crossover
  lowered to this size through the config knob), each against numpy;
* ``strings_path``: two ``--string-rows`` tables (default 4,194,304)
  keyed by TPC-H's ``C_NAME`` format of bench.py's keys, above the
  crossover, so the keys hash on ingest (``setup_s``):
  ``merge(on="name").groupby("name").sum().sort_values("name")`` at
  W = 4, best of 3, decoded names and sums against numpy.

Then the Series, the index, the streamed scan join and the breadth of
the API, on bench.py's tables at ``--scan-rows`` per side (default
125,829,120) at W = 4:

* ``series_path``: TPC-H Q6's shape on df1 with a float64 column about
  5% null — a mask of three comparisons combined with ``&``, the filter
  ``df1[mask]``, two columns derived through ``__setitem__``, ``sum``,
  ``mean``, ``count`` and ``nunique``, then ``set_index("k").loc[lo:hi]``,
  an ``iloc`` range and ``isna``/``fillna``/``dropna``/``where``: best of
  3 after a warm-up, each step's time, peak memory, the idle share; no
  kernel launches;
* ``scan_join_path``: df1 as 8 batches (``Table``s made from the host
  arrays as the scan reaches them) through ``pipelined_scan_join`` against
  df2 resident, into a ``GroupBySink``; equal to the BASELINE join →
  groupby oracle, timed beside ``dist_path``; K1's launches there, and
  K1 held bit-equal to its plain version (and timed) on the first batch's
  shard 0 inputs, captured in a run with the fused pushdown's density
  gate opened;
* ``breadth_small``: 2^18 rows at W = 1 and 3 — decimal keys and
  payloads of mixed scales through a join, a groupby sum, a sort, a
  concat and a set op; a list payload through a join and a filter, and
  its typed refusal as a key; Series ops with nulls, ``loc``, ``iloc``
  and ``Row``/``Scalar``.

Then the adaptive skew split and TPC-H, BASELINE configurations 5 and 4:

* ``skew_small`` (with ``tpch_small``, in a ``--side-child`` process
  beside ``breadth_small`` and ``recovery_small``): 2^18 rows a side,
  90% of the probe rows on one key, at
  W = 1 (the route off) and 3 (``SMALL_WORLDS``) — every join type, a
  two-column key, a float64 key, a heavy NULL key and a dictionary-string
  key, each held
  to its rows per key (``np.bincount``), on the even layout, and row for
  row equal to the same join unsplit; the fused join → groupby-sum (the
  heavy partials combined), a min/max groupby that takes the split
  output unstitched, and the replication guard (a build side heavy on
  the same key keeps the hash plan);
* ``skew_path``: bench.py's ``--skew=0.9`` tables at ``--skew-rows`` per
  side (default 125,829,120) at W = 4 through ``join_tables`` ->
  ``groupby_aggregate`` (the fused pushdown with the heavy partials
  combined): best of 3 after a warm-up, rows/s, peak memory, the phase
  split (detect, exact counts, the split exchange, the join, the fused
  groupby, the combine), a profile and the idle share, the probe's
  shards after the split exchange (largest within 1.25x the mean), the
  plan's ``summary()``, K1 and K2 launches with the group densities the
  pushdown met; the materialized inner join with its stitch timed; the
  same query unsplit (the port's switch off) at the largest size the
  card takes; all against the join -> groupby oracle;
* ``tpch_small``: all 21 TPC-H queries at SF 0.05 on the card at W = 1,
  4 and 8, each held against the same query of the port on the CPU on
  the same generated tables (integers, dates and strings equal, floats
  to rtol 1e-9 plus 64·eps·Σ(|v| + v²) over the tables' floats);
* ``tpch_path``: TPC-H at ``--tpch-scale`` (default SF 5; SF 10 before
  PR 13) at W = 8, drawn by a low-priority background process of this
  script (``--tpch-gen``) started after the build and pickled (the
  phase's ``gen_s`` is the wait and the load), the upload's seconds,
  then Q1,
  Q3, Q5 and Q6, each
  best of 3 after a warm-up with its peak memory, phase split, profile,
  idle share and K1/K2 launches, against numpy oracles (the keys are
  aranges, so each join is an index lookup); then ``tpch_sentinel``: Q3
  and Q5 once unarmed and once with the runtime sentinel armed, the
  armed answer's digest equal to the unarmed one's, the funnel's pulls
  and the stray syncs by site.

Then recovery: the spill tiers, the retry ladder and a real device OOM:

* ``spill_path`` (after ``scan_join_path``, on its tables): the W = 4
  pipelined route (GroupBySink + ``pipelined_join``, n_chunks 2)
  unspilled, then under a ledger budget (``CYLON_TPU_TORCH_HBM_BUDGET``)
  reckoned from the ledger — the piece loop's admissions less the left
  packed source — so that source evicts to pinned host memory and every
  one of its windows is uploaded: best of 3 after a warm-up each, the
  budget, the bytes evicted and uploaded per iteration, the uploads'
  device time and the share of it that overlapped kernels, the prefetch
  depth (1), both peaks and idle shares, K1/K2 launches; bit-equal to the
  unspilled result and to the oracle; K1 and K2 held bit-equal to their
  plain versions on the spilled route's first-launch inputs (shard 0);
  then (``depth2``) under a budget that still evicts the left source and
  holds two window pairs, so the next piece's windows upload before the
  current piece joins (prefetch depth 2): best of 3, peak, the uploads'
  overlap, bit-equal to the unspilled result, the same bytes uploaded;
* ``recovery_small`` (after ``breadth_small``): 2^18 rows a side at W = 1
  and 3 — pipelined inner, left and outer joins (n_chunks 3) with
  and without a ``GroupBySink`` and ``pipelined_set_op``, under a 4 KiB
  device budget (every source evicts) and then with a 4 KiB host budget
  and a temporary spill directory (pages written, verified, read back,
  the directory empty after), each equal to the same run unbudgeted and
  to numpy; injected faults with their expected ``recovery_events()``:
  ``groupby.device_oom=device_oom`` (the 4-chunk rung),
  ``join.piece_cap=capacity`` (the cap-halving rung),
  ``spill.upload=spill_stall`` under a 0.5 s watchdog (a
  ``RankDesyncError``), ``groupby.device_oom=desync`` (no rung: the
  typed abort) and, at W > 1, ``shuffle.recv_guard=predicted`` with a
  spillable source resident (the spill rung);
* ``chaos_soak`` (a child process beside ``breadth_small`` and
  ``recovery_small``): the port's soak, ``python -m
  cylon_tpu_torch.exec.chaos_soak --rows 67108864 --chunks 4 --world 4
  --seed 5 --schedules 4`` — its four pinned fault schedules (the two
  drawn ones of ``--schedules 6`` cut for the time limit), each in child
  processes that are SIGKILLed and resumed, sharing one compile
  directory; the baseline equal to a numpy
  oracle (an int64 sort and ``np.add.reduceat``), launching K1 and K2,
  the first launch of each bit-equal to its plain version; every
  schedule converged: each one's outcome and seconds, and the children's
  K1 and K2 launches (added to the kernels line).  Beside it, in this
  process (``local_rank``): ``LOCAL_RANK`` set to the card count, with no
  device named, makes ``DistributedConfig`` raise
  ``DeviceUnavailableError`` before any rendezvous, and the last card's
  ``LOCAL_RANK`` picks that card;
* ``oom_path`` (last): the monolithic join → groupby at W = 1 and
  ``--oom-rows`` a side (default 402,653,184; BASELINE-shaped tables
  drawn on the card, not bench.py's draw), which the card cannot
  hold: the first attempt must raise ``torch.cuda.OutOfMemoryError``,
  classified ``DeviceOOMError``, and the ladder's chunked retry must give
  the oracle's answer; the failed attempt's and the recovery's times and
  peaks, the events and the ladder that caught it.  Any other phase fails
  if it records a recovery event.

Then durable checkpoints (exec/checkpoint.py, exec/preempt.py), under a
fresh checkpoint root in ``--ckpt-dir`` (default the system's temporary
directory), removed at the end:

* ``ckpt_path`` (after ``spill_path``, on its tables; it fails unless the
  root's disk holds the tables and four checkpoints): ``GroupBySink`` +
  ``pipelined_join(n_chunks=4)`` + ``finalize`` at W = 4 in this
  process, unarmed (best of 3 after a warm-up) and armed (a warm-up and
  one timed run: it is host-bound) — seconds, peak
  memory, bytes checkpointed, the write side's D2H, encode, sha256, file
  write and commit regions; bit-equal to each other and to the oracle,
  and the unarmed run writes nothing.  Then child processes of this
  script (``--ckpt-child``) on the same tables, from ``.npy`` files
  written once: one SIGKILLed by an injected ``ckpt.write`` ``kill`` at
  its third write (rc -9; the manifest holds pieces 0 and 1, every page
  it names verifies); its resume at W = 4 (2 pieces fast-forwarded, K1
  only on the 2 recomputed pieces, K2 once per shard; K1 and K2 held
  bit-equal to their plain versions on its first launches' inputs); one
  with a preemption grace armed and a ``term`` injected at its second
  write, which must drain into a ``ResumableAbort`` naming the root —
  with the flight recorder armed (``CYLON_TPU_TORCH_TRACE``), leaving a
  ``TRACE_POSTMORTEM.json`` in the root whose last events hold
  ``ckpt.write`` spans — and its resume; the armed leg's complete W = 4
  stage resumed at W = 2 (every piece re-sharded, the mismatch counted
  once) and a second W = 2 resume (a plain fast-forward).  The three
  chains (kill and resume; drain and resume; the two W = 2 resumes) run
  side by side, so three children share the card at a time and each
  child's seconds are timed beside others'.  Each
  child's result is held
  bit-equal to the uninterrupted run (a digest of its rows sorted by
  key); a child that exits otherwise than expected fails the phase;
* ``procs_ckpt`` (after ``ckpt_path``, on its tables; its children start
  before ``ckpt_path`` and wait for a go file): the same workload as
  2 processes × 2 ranks over gloo (``--procs-child``), every child under
  a 20 s exchange watchdog: an armed run (each process writes its own
  ranks' blocks into ``rank<process>/`` of one root; one manifest epoch
  on both, the shard digest equal to ``ckpt_path``'s), and beside it a
  kill chain: process 0 SIGKILLed at its third ``ckpt.write`` (rc -9),
  process 1 raising ``RankDesyncError`` at its commit vote (exit 4),
  then a 2 × 2 resume (2 pieces fast-forwarded on both, one epoch, the
  same digest); the armed run's complete stage is then resumed in one
  process at ``VirtualMeshConfig(4)`` (one process for two: a new
  process layout of the same world) and, from a hard-linked copy, at
  ``VirtualMeshConfig(2)``, both through the re-shard path with the
  uninterrupted digest, two ``--ckpt-child`` processes side by side
  (started with the others, behind a go file).  Per process: each run's seconds, the bytes
  written and the ``ckpt.d2h``/``encode``/``sha``/``file_write``/
  ``commit`` regions; K1 and K2 held bit-equal on every armed and
  resumed child's first launches;
* ``ckpt_small``: tests/test_checkpoint.py's scenarios at 2^18 rows a side
  and W = 1 and 3 (``SMALL_WORLDS``) — sinkless and sink resume, a partial prefix, a
  corrupt page (recomputed), a plan-token mismatch (started over), a
  staged-only manifest (ignored), a persistent injected ``device_oom``
  after two commits (the ladder's final rung, a ``ResumableAbort``, then
  the resume) — and the re-shards 4 -> 2, 4 -> 1 and 2 -> 4, each held
  to the uninterrupted run.

Then the serving tier (exec/scheduler.py, exec/session.py,
exec/fleet.py), after ``tpch_small``:

* ``serve_path``: on ``tpch_path``'s tables (same process, before they
  are freed), four tenants running bench_serving's mixes 0-3 in a closed
  loop of 3 queries each (t0 qpipe, Q6, Q1; t1 qpipe, Q12, qpipe; t2 Q3,
  Q14, Q15; t3 Q5, Q17, Q5; qpipe is lineitem ⋈ orders through
  ``pipelined_join(n_chunks=4)`` into a ``GroupBySink`` on l_orderkey):
  each tenant alone first (the solo pass; Q1, Q3, Q5, Q6 against
  ``tpch_oracle``, qpipe against a numpy ``bincount``), then all four
  under ``QueryScheduler(policy="fair")`` with bench_serving's "auto"
  budgets (admission: 1.05 x the two smallest footprints; ledger: 1.6 x
  one qpipe's peak ledger bytes).  Every answer's digest equals its solo
  run's; at least one admission wait and one cross-tenant eviction; K2
  launches in qpipe's phase 1.  Per-tenant p50/p99 latency, lineitem
  rows served per second, the concurrent wall time against the sum of
  the solo times, slices and park seconds, K1/K2 launches and the peak
  ledger bytes;
* ``serve_path_preempt``: the same tenants under ``priority`` with
  checkpoints armed for the pass, t3 submitted at priority 5 from t0's
  loop: at least one preemption, a requeue, the victim's committed
  pieces fast-forwarded in process (outcome ``preempted_requeued``), and
  every answer bit-equal to its solo run;
* ``serve_small`` (2^18 rows a side): an ``AdmissionTimeoutError`` and a
  ``RequeueOverflowError`` (W = 1); at W = 4 an eviction by tenant t1
  of tenant t0's resident source while t0 holds a prepared piece (its
  window uploaded, not yet consumed), t0 bit-equal to its solo run; a
  fleet drain to ``resize_target`` 2 with its ``FLEET_RESIZE.json``,
  then a child process relaunched at W = 2 with resume, every tenant
  completed and bit-equal; a child killed by ``ckpt.write::2=kill@t0``
  and its resume, t0's committed pieces fast-forwarded, every tenant
  bit-equal;
* ``procs_serve`` (after ``stream_serve``; its children start before
  ``tpch_path``, load the pickled tables and wait for a go file):
  ``serve_path``'s four tenants as 2 processes × 4 ranks (W = 8) over
  gloo, each tenant running its mix once, ``fair`` first, then the
  preempt leg (``priority``, checkpoints armed under one root for both
  processes, t3 late at priority 5; at least one preemption and requeue
  with fast-forwarded pieces); every answer's digest equal to
  ``serve_path``'s solo answer at W = 8, the schedules the same on both
  processes; per tenant p50/p99, the evictions, the preemptions and the
  votes each process took; K2 held bit-equal on each pass's first
  launch in each process.

Then streaming (stream/: StreamTable, IncrementalView,
TumblingWindowJoin) on scripts/bench_streaming.py's stream: uniform keys,
``qty`` int64 in 1-50, ``amount`` integer cents as float64, event time
``b·60 + U[0, 60)`` with 5% of the rows 3 windows late, windows of 100,
lateness 30, late rows dropped; the view over the bench's aggregations
(sum, count, min, max, mean, var, std of ``amount``, sum of ``qty``), the
window join against ``dims = {k, dim = 7k + 3}``, one row per key:

* ``stream_serve`` (after ``serve_path``, on its tables and world, W =
  8): 16 batches of 4,194,304 rows as a ``kind="stream"`` session beside
  a TPC-H tenant running Q6 then Q1 twice, under ``QueryScheduler(
  policy="fair")``: the view against the from-scratch groupby and numpy
  as in ``stream_path``, every tenant answer's digest equal to its solo
  run's; the sessions' slices, the stream's rows/s and
  ``stream_sessions``;
* ``stream_path`` (after the serving phases): ``--stream-batches``
  batches (default 40, drawn on the card by torch's generator seeded
  0) of 4,194,304 rows over 65,536 keys at W = 4, the
  bench's loop (append, window append, watermark, ``view.read()`` pulled
  to the host): sustained rows/s, p50/p99 append-to-visible staleness,
  watermark lag, windows closed, late rows dropped, window evictions,
  peak device bytes, the ``stream.*`` and ``shuffle.*`` regions' host
  seconds; the final view bit-equal to a from-scratch
  ``groupby_aggregate(st.snapshot())`` in every column but var and std,
  its per-key count, Σ qty and Σ amount equal to numpy's, var and std
  of both within 1e-7 of their values over numpy's exact sums (past
  2^53, the running Σ amount² of a shard, the groupby's float prefix
  sums round; below it they must be bit-equal), every closed window's
  rows equal to a recompute that replays the drop policy in arrival
  order, and after the teardown the ledger and the card's allocated
  bytes back where they started; K1 and K2 not launched;
* ``procs_stream`` (after ``stream_path``; its children start beside it
  and wait for a go file): the stream's first 16 batches as 2 processes
  × 2 ranks over gloo, each process drawing the same batches on the card
  and appending each whole (SPMD ingest): every read and every closed
  window equal to ``stream_path``'s at the same batch (the read's
  columns but var and std bit for bit, var and std within 1e-9 of it;
  each window's rows as a multiset hash); rows/s and p50/p99
  staleness per process; K1 and K2 not launched;
* ``stream_small`` (in a ``--side-child`` process beside
  ``serve_small``): 8 batches of 125,000 rows at W = 1, 4 and 8, the view
  bit-equal to the from-scratch groupby after every batch, var and std
  included (every sum below 2^53), and to numpy's sums; at W = 4 an
  open window evicted under a 4 KiB ledger budget that comes back
  bit-exact at its close, and checkpoints armed: the in-process resume
  fast-forwarding every committed batch, and a W = 4 commit adopted at
  W = 2, each bit-equal to the uninterrupted run.

Each route's kernel counts are set to 0 just before it and read just
after.  Prints one JSON line per phase, then the kernel summary line, then
the card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
nonzero without the last line.  It needs a CUDA device and fails without
one.  ``--string-rows`` must stay at 4,000,000 or more, where
``strings_path``'s names hash.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from cylon_tpu_torch.utils.host import sync_pull

#: published HBM3 bandwidth of one H100 SXM (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: published non-tensor-core float32 rate of one H100 SXM, operations/s:
#: the table's nearest rate for K2's 32-bit integer compares
SCALAR_OPS_PER_S = 67e12
K1_SOURCE = "cylon_tpu_torch/kernels/windowed_gather.cu"
K1_REPLACES = "cylon_tpu/ops/pallas_gather.py:161"
K2_SOURCE = "cylon_tpu_torch/kernels/splitter_probe.cu"
K2_REPLACES = "cylon_tpu/ops/pallas_probe.py:136"
#: bench.py's rows per range piece of the pipelined route
PIECE_ROWS = 21_000_000
#: the time limit of each procs_path leg's processes, together
PROCS_TIMEOUT_S = 300
#: the worlds of groupby_small, joins_small, setops_small, breadth_small,
#: skew_small and recovery_small: one shard and an odd world (W = 4 and
#: 8 left out for the script's time limit; the CPU tests hold each phase
#: at W = 1, 3, 4 and 8 against the reference, and the full-size phases
#: run W = 4 and 8 on the card)
SMALL_WORLDS = (1, 3)
#: rows (per side) of those correctness-only phases and of ckpt_small and
#: serve_small: 2^18 (it was 1M), for the script's time limit
SMALL_ROWS = 1 << 18


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the host clock
    (``clock_s``, ``time.perf_counter``) when it was printed, so the
    differences between lines give each phase's share of the run."""
    if "phase" in obj:
        obj = {**obj, "clock_s": time.perf_counter()}
        # only oom_path and recovery_small's injected cases may retry,
        # and they drain their events before they print
        no_recovery(f"phase {obj['phase']}")
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events), after
    one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_bytes(n_lanes: int, n_idx: int) -> int:
    """Bytes the gather must move: the indices read once, the gathered
    words read once, the output written once, the flag."""
    return 4 * n_idx + 2 * 4 * n_lanes * n_idx + 4


def k1_sector_bytes(n_lanes: int, idx: torch.Tensor) -> int:
    """Bytes any gather from separate lanes moves at least when it reads
    whole 32-byte sectors: every sector of every lane that holds an index,
    plus the output and the indices."""
    sectors = torch.unique_consecutive(idx.to(torch.int64) >> 3).numel()
    n_idx = idx.shape[0]
    return n_lanes * 32 * sectors + 4 * n_lanes * n_idx + 4 * n_idx


def k1_check(wg, label, lanes, idx, window, expect_ok=None, timed=False):
    """Kernel vs plain version on the same card inputs: bit-equal output
    and flag.  ``lanes`` is an (L, M) matrix or a lane list.  Returns the
    phase record."""
    out_k, ok_k = wg.windowed_take_t(lanes, idx, window)
    out_p, ok_p = wg.windowed_take_plain(lanes, idx, window)
    torch.cuda.synchronize()
    if bool(ok_k) != bool(ok_p) or not torch.equal(out_k, out_p):
        raise AssertionError(f"K1 {label}: kernel and plain version differ")
    if expect_ok is not None and bool(ok_k) != expect_ok:
        raise AssertionError(f"K1 {label}: ok={bool(ok_k)}, want {expect_ok}")
    err = int((out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max())
    del out_k
    ls = wg.as_lanes(lanes)
    L, M, S = len(ls), ls[0].shape[0], idx.shape[0]
    rec = {"phase": "k1", "case": label, "L": L, "M": M, "S": S,
           "window": window,
           "form": "matrix" if isinstance(lanes, torch.Tensor) else "lanes",
           "ok": bool(ok_p), "bit_equal": True, "max_abs_err": err}
    del out_p
    if timed:
        nbytes = k1_bytes(L, S)
        sbytes = k1_sector_bytes(L, idx)
        rec.update(
            ms=time_ms(lambda: wg.windowed_take_t(lanes, idx, window)),
            plain_ms=time_ms(lambda: wg.windowed_take_plain(lanes, idx,
                                                            window)))
        # the library yardstick gathers from one matrix: a lane list is
        # stacked for it first, outside the timing
        mat = lanes if isinstance(lanes, torch.Tensor) else torch.stack(ls)
        rec.update(
            library_ms=time_ms(lambda: mat.index_select(1, idx)),
            library="index_select(1, idx) on the (L, M) matrix",
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", sector_bytes=sbytes,
            sector_floor_ms=sbytes / HBM_BYTES_PER_S * 1e3)
        del mat
    return rec


def k1_forms(wg, label, mat, idx, window, expect_ok):
    """One K1 case as a matrix and as a list of separately allocated lanes:
    the kernel's results equal to each other and to the plain version."""
    lanes = [row.clone() for row in mat]
    by_matrix = wg.windowed_take_t(mat, idx, window)
    by_lanes = wg.windowed_take_t(lanes, idx, window)
    torch.cuda.synchronize()
    if not torch.equal(by_matrix[0], by_lanes[0]) \
            or bool(by_matrix[1]) != bool(by_lanes[1]):
        raise AssertionError(f"K1 {label}: matrix and lane list differ")
    del by_matrix, by_lanes
    yield k1_check(wg, f"{label}_matrix", mat, idx, window, expect_ok)
    yield k1_check(wg, f"{label}_lanes", lanes, idx, window, expect_ok)


def keep_k1(lanes, idx, window):
    """K1's arguments as a capture keeps them: the caller clears its lane
    list after the call, so the list is copied."""
    from cylon_tpu_torch.ops import windowed_gather as wg
    return wg.as_lanes(lanes), idx, window


@contextlib.contextmanager
def capturing(mod, name, into: dict, key: str, keep=lambda *a: a):
    """Within the block, the first call of ``mod.name`` also stores
    ``keep(*args)`` in ``into[key]``; the call itself goes through."""
    launch = getattr(mod, name)

    def first(*args):
        if key not in into:
            into[key] = keep(*args)
        return launch(*args)

    setattr(mod, name, first)
    try:
        yield
    finally:
        setattr(mod, name, launch)


#: the keys of a K1 / K2 check that the kernels line repeats per route
K1_KEYS = ("M", "S", "window", "max_abs_err", "ms", "plain_ms", "bound_ms",
           "sector_bytes", "sector_floor_ms", "library_ms")
K2_KEYS = ("K", "S", "cap", "variant", "max_abs_err", "ms", "kernel_ms",
           "plain_ms", "bound_ms", "bound_by", "library_ms")


def small_cases(rng, n_rows, n_lanes, seg, pattern, dev):
    """tests/test_pallas_gather.py's inputs, on the card."""
    mat = rng.integers(0, 1 << 32, (n_lanes, n_rows), dtype=np.uint32)
    if pattern == "dense":
        k = min(int(n_rows * 0.45), seg)
        real = np.sort(rng.choice(n_rows - 1, k, replace=False))
    elif pattern == "skewed":
        k = min(int(n_rows * 0.45), seg)
        real = np.sort(rng.choice(n_rows // 8, k - 1, replace=False))
        real = np.concatenate([real, [n_rows - 1]])
    else:
        real = np.zeros(0, np.int64)
    idx = np.full(seg, n_rows - 1, np.int32)
    idx[:len(real)] = real
    return (torch.from_numpy(mat.view(np.int32)).to(dev),
            torch.from_numpy(idx).to(dev))


K2_VARIANTS = ("packed", "general")


def k2_check(sp, label, ops, sops, timed=False):
    """K2 vs its plain version on the same card inputs: bit-equal counts,
    from the wrapper and from the other kernel path where it admits the
    operands.  With ``timed``, also the library yardstick: one
    ``torch.searchsorted`` with int32 output over the key tuple packed into
    one int64 word (K <= 2; the packing pass is not timed), itself checked
    equal."""
    from cylon_tpu_torch.ops import pack
    got = sp.count_ge_splitters(ops, sops)
    want = sp.count_ge_splitters_plain(ops, sops)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"K2 {label}: kernel and plain version differ")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    del got
    plan = sp.plan(ops, sops)
    checked = []
    for variant, name in enumerate(K2_VARIANTS):
        if ops[0].is_cuda and variant != plan.variant \
                and sp.admits(variant, ops):
            alt = sp.run(sp.prepare(ops, sops, variant))
            if not torch.equal(alt, want):
                raise AssertionError(f"K2 {label}: the {name} variant and "
                                     "the plain version differ")
            checked.append(name)
            del alt
    del want
    cap, S, K = ops[0].shape[0], sops[0].shape[0], len(ops)
    rec = {"phase": "k2", "case": label, "K": K, "S": S, "cap": cap,
           "widths": [str(o.dtype) for o in ops],
           "variant": K2_VARIANTS[plan.variant], "vec": plan.vec,
           "other_variants_equal": checked, "bit_equal": True,
           "max_abs_err": err}
    if timed:
        probe = sp.prepare(ops, sops)
        # the same rows one element in: the kernel's scalar-load path
        shifted = tuple(o[1:] for o in ops)
        if sp.plan(shifted, sops).vec:
            raise AssertionError(f"K2 {label}: shifted operands aligned")
        general = sp.prepare(ops, sops, sp.VARIANT_GENERAL) \
            if plan.variant != sp.VARIANT_GENERAL else None
        nbytes = (sum(o.numel() * o.element_size() for o in ops)
                  + sum(so.numel() * so.element_size() for so in sops)
                  + 4 * cap)
        n_ops = 2 * K * S * cap          # one > and one == per operand
        rec.update(
            ms=time_ms(lambda: sp.count_ge_splitters(ops, sops)),
            kernel_ms=time_ms(lambda: sp.run(probe)),
            scalar_ms=time_ms(lambda: sp.count_ge_splitters(shifted, sops)),
            general_ms=None if general is None
            else time_ms(lambda: sp.run(general)),
            plain_ms=time_ms(lambda: sp.count_ge_splitters_plain(ops, sops)),
            bytes=nbytes, bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                       n_ops / SCALAR_OPS_PER_S) * 1e3,
            bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            ops_bound_ms=n_ops / SCALAR_OPS_PER_S * 1e3,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S
            >= n_ops / SCALAR_OPS_PER_S else "operations",
            library_ms=None)
        if K == 2 and all(o.dtype == torch.int32 for o in ops):
            # what one elementwise call reaches on the same 12 bytes a row
            rec["elementwise_ms"] = time_ms(
                lambda: torch.bitwise_xor(ops[0], ops[1]))
        del probe, shifted, general
        kinds = ("i",) * K
        words = pack.sort_words(pack.KeyOps(tuple(ops), kinds))
        swords = pack.sort_words(pack.KeyOps(tuple(sops), kinds))
        if len(words) == 1:
            rw, sw = words[0][0], swords[0][0]
            lib = torch.searchsorted(sw, rw, right=True, out_int32=True)
            if not torch.equal(lib, sp.count_ge_splitters(ops, sops)):
                raise AssertionError(f"K2 {label}: searchsorted yardstick "
                                     "differs")
            del lib
            rec["library_ms"] = time_ms(lambda: torch.searchsorted(
                sw, rw, right=True, out_int32=True))
            rec["library"] = ("torch.searchsorted(right=True, out_int32="
                              "True) over one packed int64 word per row; "
                              "packing not timed")
        del words, swords
    return rec


def k2_cases(sp, dev):
    """K2 against its plain version: the operand shapes of the pipelined
    join (tests/test_torch_splitter_probe.py's cases) at 1M rows, built by
    the package's own key_operands from seeded numpy keys."""
    from cylon_tpu_torch.ops import pack
    rng = np.random.default_rng(7)
    cap = 1 << 20

    def operands(cols, valids, narrow, live):
        mask = torch.arange(cap, device=dev) < live
        ko = pack.key_operands(
            [torch.from_numpy(c).to(dev) for c in cols],
            [None if v is None else torch.from_numpy(v).to(dev)
             for v in valids], row_mask=mask, pad_key=4,
            need_null_flags=tuple(v is not None for v in valids),
            narrow32=narrow)
        return ko.ops

    def splitters(ops, n_split, n_sent=0, rows=()):
        # rows of the table (so some rows equal a splitter; ``rows`` among
        # them), then repeats of the +inf sentinel slot (liveness = pad key)
        order = torch.from_numpy(np.sort(np.concatenate([rng.integers(
            0, cap, n_split - n_sent - len(rows)),
            np.asarray(rows, np.int64)]))).to(dev)
        return tuple(torch.cat([o[order], torch.full(
            (n_sent,), 4 if j == 0 else 0, dtype=o.dtype, device=dev)])
            for j, o in enumerate(ops))

    narrow = operands([rng.integers(0, 900_000, cap)], [None], (True,),
                      cap - 4099)
    hi = rng.integers(-3, 3, cap).astype(np.int64)
    lo = rng.integers(0, 1 << 32, cap, dtype=np.uint64).astype(np.int64)
    lo[:4096] = 0x80000000
    lo[4096:8192] = 0x7FFFFFFF
    wide = operands([(hi << 32) | lo], [None], (False,), cap)
    nullable = operands([rng.integers(-50, 50, cap).astype(np.int32)],
                        [rng.random(cap) > 0.2], (False,), cap - 1)
    many = operands([rng.integers(-2**40, 2**40, cap) for _ in range(4)],
                    [rng.random(cap) > 0.1 for _ in range(4)],
                    (False,) * 4, cap - 17)
    f64 = rng.normal(size=cap)
    f64[rng.integers(0, cap, 4096)] = np.nan
    f64[rng.integers(0, cap, 4096)] = -0.0
    f64[rng.integers(0, cap, 4096)] = 0.0
    f64[rng.integers(0, cap, 1024)] = np.inf
    f64[rng.integers(0, cap, 1024)] = -np.inf
    fvalid = rng.random(cap) > 0.1
    floats = operands([f64], [fvalid], (False,), cap - 3)
    # splitter rows holding NaN, +inf, -inf and -0.0
    special = np.array([np.flatnonzero(fvalid & m)[0] for m in (
        np.isnan(f64), f64 == np.inf, f64 == -np.inf,
        (f64 == 0) & np.signbit(f64))], np.int64)
    yield k2_check(sp, "narrow_K2_S5", narrow, splitters(narrow, 5, 1))
    one = narrow[1:]
    yield k2_check(sp, "narrow_K1_S5", one, splitters(one, 5, 1))
    yield k2_check(sp, "wide_K3_S13_lo_across_2^31", wide,
                   splitters(wide, 13, 1))
    yield k2_check(sp, "nullable_K3_S7", nullable,
                   splitters(nullable, 7, 1))
    yield k2_check(sp, "narrow_S1", narrow, splitters(narrow, 1))
    yield k2_check(sp, "narrow_S128_dup_sentinel", narrow,
                   splitters(narrow, 128, 9))
    yield k2_check(sp, "wide_S128", wide, splitters(wide, 128, 2))
    yield k2_check(sp, "many_K13_S31", many, splitters(many, 31, 3))
    yield k2_check(sp, "narrow_S600", narrow, splitters(narrow, 600, 1))
    yield k2_check(sp, "nullable_f64_K3_S9_nan_zeros_inf", floats,
                   splitters(floats, 9, 1, special))
    yield k2_check(sp, "nullable_f64_S128", floats,
                   splitters(floats, 128, 2, special))
    # an f64 operand as the kernel may meet it unbuilt: both zero signs and
    # NaNs of both signs, among rows and splitters alike
    pool = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, 1.0, -1.0])
    raw = (torch.from_numpy(rng.choice(pool, cap)).to(dev),)
    yield k2_check(sp, "raw_f64_K1_signed_zeros_and_nans", raw,
                   (torch.from_numpy(pool[[0, 1, 3, 2, 7, 4]]).to(dev),))
    ragged = tuple(o[:cap - 333] for o in narrow)
    yield k2_check(sp, "ragged_cap", ragged, splitters(ragged, 5, 1))
    # every cap % 4 tail of the 4-row load groups, on both paths, with and
    # without image rows
    for tail in (1, 2, 3):
        for prefix, ops in (("", narrow), ("wide_", wide)):
            cut = tuple(o[:cap - 4 + tail] for o in ops)
            yield k2_check(sp, f"{prefix}cap_mod4_{tail}", cut,
                           splitters(cut, 5, 1))
    # operand views one element in, not 16-byte aligned: the scalar loads
    # of both paths and of the image rows' writer
    for name, ops in (("int32", narrow), ("f64", floats), ("wide", wide)):
        view = tuple(o[1:] for o in ops)
        yield k2_check(sp, f"unaligned_{name}_view", view,
                       splitters(view, 7, 1))
    # splitter images beyond shared memory: the wrapper raises, it never
    # computes the plain version on the card, and launches nothing (on the
    # general path, not even the image rows' writer)
    from cylon_tpu_torch.status import KernelError
    for dtype, label in ((torch.int32, "S65536_beyond_shared_memory"),
                         (torch.int64, "u32_S65536_beyond_shared_memory")):
        before = sp.COUNTS["launches"]
        try:
            sp.count_ge_splitters(
                (torch.zeros(1024, dtype=dtype, device=dev),),
                (torch.zeros(1 << 16, dtype=dtype, device=dev),))
        except KernelError as e:
            if sp.COUNTS["launches"] != before:
                raise AssertionError(f"K2 {label} counted a launch") from e
            yield {"phase": "k2", "case": label,
                   "raised": type(e).__name__, "message": str(e)}
        else:
            raise AssertionError(f"K2 {label}: no error raised")


#: the reference's hash constants (cylon_tpu/ops/hashing.py), for the
#: numpy copy below
GOLD = 0x9E3779B9


def np_partition_of(keys: np.ndarray, world: int) -> np.ndarray:
    """The reference's target rank of each int64 key, in numpy: its u32
    murmur3-finalizer row hash over the key's (lo, hi) lanes, then the
    mask (power-of-two world) or the modulo.  Independent of the
    package's torch code, so a wrong hash on the card cannot pass."""
    k = np.asarray(keys, np.int64)
    h = np.full(k.shape, GOLD, np.uint32)
    with np.errstate(over="ignore"):
        for lane in ((k & 0xFFFFFFFF).astype(np.uint32),
                     ((k >> 32) & 0xFFFFFFFF).astype(np.uint32)):
            z = h ^ (lane + np.uint32(GOLD) + (h << np.uint32(6))
                     + (h >> np.uint32(2)))
            z = (z ^ (z >> np.uint32(16))) * np.uint32(0x85EBCA6B)
            z = (z ^ (z >> np.uint32(13))) * np.uint32(0xC2B2AE35)
            h = z ^ (z >> np.uint32(16))
    if world & (world - 1) == 0:
        return (h & np.uint32(world - 1)).astype(np.int64)
    return (h % np.uint32(world)).astype(np.int64)


#: keys from which :func:`stable_order` sorts on the card
STABLE_ORDER_CARD_ROWS = 1 << 20


def stable_order(k) -> np.ndarray:
    """``np.argsort(k, kind="stable")``: the same permutation, both sorts
    being stable.  Signed-integer keys from ``STABLE_ORDER_CARD_ROWS`` on
    are sorted on the card, where numpy's stable sort takes seconds per
    10^7 keys; others, or a card without room, on the host."""
    k = np.asarray(k)
    if k.dtype.kind == "i" and len(k) >= STABLE_ORDER_CARD_ROWS \
            and torch.cuda.is_available():
        try:
            t = torch.from_numpy(np.ascontiguousarray(k)).cuda()
            return torch.sort(t, stable=True).indices.cpu().numpy()
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
    return np.argsort(k, kind="stable")


def check_dist(g, orc, world: int, label: str) -> int:
    """A W-shard groupby result against the oracle: the same groups and
    sums once sorted by key, each shard's keys ascending, and every group
    on the shard the reference's hash assigns it."""
    out = g.to_pydict()
    order = stable_order(out["k"])
    for name in ("k", "a_sum", "b_sum"):
        if not np.array_equal(out[name][order], orc[name]):
            raise AssertionError(f"{label}: column {name} differs from the "
                                 "numpy oracle")
    vc, cap = g.valid_counts, g.capacity
    keys = g.column("k").data.cpu().numpy()
    for r in range(world):
        kr = keys[r * cap:r * cap + int(vc[r])]
        if len(kr) > 1 and not bool(np.all(np.diff(kr) > 0)):
            raise AssertionError(f"{label}: shard {r}'s keys not ascending")
        if not np.array_equal(np_partition_of(kr, world),
                              np.full(len(kr), r)):
            raise AssertionError(f"{label}: a group of shard {r} belongs "
                                 "elsewhere by the reference's hash")
    return len(out["k"])


def baseline_inputs(n: int, seed: int = 42, unique: float = 0.9):
    """bench.py's BASELINE tables (same generator, same draw order)."""
    rng = np.random.default_rng(seed)
    mv = max(int(n * unique), 1)
    lk = rng.integers(0, mv, n).astype(np.int64)
    a = rng.integers(0, mv, n).astype(np.int64)
    rk = rng.integers(0, mv, n).astype(np.int64)
    b = rng.integers(0, mv, n).astype(np.int64)
    return {"k": lk, "a": a}, {"k": rk, "b": b}, mv


def oracle(left, right, mv):
    """Per key: L, R, SA, SB; the join→groupby answer is keys where L>0
    and R>0, sum_a = SA·R, sum_b = SB·L.  With a card the four per-key
    sums are taken there (:func:`card_oracle`; a host bincount of
    402,653,184 keys takes tens of seconds), else by :func:`host_oracle`;
    both are exact and give the same arrays."""
    if torch.cuda.is_available():
        return card_oracle(left, right, mv)
    return host_oracle(left, right, mv)


def card_inputs(n: int, seed: int, device, unique: float = 0.9):
    """BASELINE-shaped tables drawn on the card: int64 keys and payloads
    uniform in [0, 0.9 n), from a seeded device generator (the data is
    not bench.py's draw; the oracle takes these tensors).  No host
    generation and no upload: the setup of a size whose numpy draw takes
    tens of seconds."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mv = max(int(n * unique), 1)

    def draw():
        return torch.randint(0, mv, (n,), dtype=torch.int64, device=device,
                             generator=gen)

    lk, a = draw(), draw()
    rk, b = draw(), draw()
    return {"k": lk, "a": a}, {"k": rk, "b": b}, mv


def device_table(ct, cols: dict, env):
    """A world-1 Table over device int64 tensors of a family-capacity
    length, with the bounds ingest would give them."""
    from cylon_tpu_torch.core.column import Column
    from cylon_tpu_torch.core.dtypes import LogicalType
    return ct.Table({name: Column(t, LogicalType.INT64, None,
                                  bounds=(int(t.min()), int(t.max())))
                     for name, t in cols.items()}, env)


def card_oracle(left, right, mv):
    """:func:`oracle` with the per-key counts and sums as int64
    ``bincount``/``index_add_`` on the card (exact: every partial sum
    stays below 2^53), pulled to numpy."""
    dev = torch.device("cuda")

    def per_key(k, v):
        kt = torch.as_tensor(k).to(dev)
        cnt = torch.bincount(kt, minlength=mv)
        tot = torch.zeros(mv, dtype=torch.int64, device=dev).index_add_(
            0, kt, torch.as_tensor(v).to(dev))
        return cnt, tot

    L, sa = per_key(left["k"], left["a"])
    R, sb = per_key(right["k"], right["b"])
    if max(int(sa.max()) * int(R.max()), int(sb.max()) * int(L.max())) \
            >= 2 ** 53:
        raise AssertionError("oracle sums leave the exact float64 range")
    keep = (L > 0) & (R > 0)
    out = {"k": keep.nonzero().squeeze(1), "a_sum": (sa * R)[keep],
           "b_sum": (sb * L)[keep], "L": L, "R": R, "sa": sa,
           "keep": keep}
    rows = int((L * R).sum())
    out = {name: t.cpu().numpy() for name, t in out.items()}
    del L, R, sa, sb, keep
    torch.cuda.empty_cache()
    return {**out, "rows": rows}


def host_oracle(left, right, mv):
    """:func:`oracle` by numpy ``bincount``: float64 weights, exact since
    every partial sum stays below 2^53."""
    L = np.bincount(left["k"], minlength=mv)
    R = np.bincount(right["k"], minlength=mv)
    sa = np.bincount(left["k"], left["a"], minlength=mv)
    sb = np.bincount(right["k"], right["b"], minlength=mv)
    if max(sa.max() * R.max(), sb.max() * L.max()) >= 2.0 ** 53:
        raise AssertionError("oracle sums leave the exact float64 range")
    keep = (L > 0) & (R > 0)
    return {"k": np.nonzero(keep)[0],
            "a_sum": (sa.astype(np.int64) * R)[keep],
            "b_sum": (sb.astype(np.int64) * L)[keep],
            "rows": int((L * R).sum()), "L": L, "R": R,
            "sa": sa.astype(np.int64), "keep": keep}


def check_groupby(g, orc, label):
    out = g.to_pydict()
    for name in ("k", "a_sum", "b_sum"):
        if not np.array_equal(out[name], orc[name]):
            raise AssertionError(f"{label}: column {name} differs from the "
                                 "numpy oracle")
    if len(out["k"]) > 1 and not bool(np.all(np.diff(out["k"]) > 0)):
        raise AssertionError(f"{label}: keys not ascending")
    return len(out["k"])


def step(ct, lt, rt, times=None):
    """One BASELINE iteration through the public entry points."""
    t0 = time.perf_counter()
    j = ct.join_tables(lt, rt, "k", "k", how="inner")
    t1 = time.perf_counter()
    g = ct.groupby_aggregate(j, "k", [("a", "sum"), ("b", "sum")])
    sync_pull(g.column("k").data)
    t2 = time.perf_counter()
    if times is not None:
        times.append({"join_s": t1 - t0, "groupby_s": t2 - t1,
                      "total_s": t2 - t0})
    return g


def pipelined_step(ct, lt, rt, n_chunks, times=None):
    """bench.py's pipelined BASELINE iteration through the public entry
    points: GroupBySink + pipelined_join + finalize."""
    t0 = time.perf_counter()
    sink = ct.GroupBySink("k", [("a", "sum"), ("b", "sum")])
    ct.pipelined_join(lt, rt, "k", "k", how="inner", n_chunks=n_chunks,
                      sink=sink)
    t1 = time.perf_counter()
    g = sink.finalize()
    sync_pull(g.column("k").data)
    t2 = time.perf_counter()
    if times is not None:
        times.append({"join_and_sink_s": t1 - t0, "finalize_s": t2 - t1,
                      "total_s": t2 - t0})
    return g


def profile_step(ct, lt, rt, top: int = 12, step_fn=None) -> dict:
    """One BASELINE iteration under torch.profiler: device time by kernel
    and by aten op, and the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e, self_only):
        for name in (("self_device_time_total", "self_cuda_time_total")
                     if self_only else
                     ("device_time_total", "cuda_time_total")):
            v = getattr(e, name, None)
            if v is not None:
                return float(v)
        return 0.0

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (step_fn or step)(ct, lt, rt)
    wall_s = time.perf_counter() - t0
    evs = prof.key_averages()
    kern = [e for e in evs if str(getattr(e, "device_type", "")).endswith(
        "CUDA")]
    busy_us = sum(dev_us(e, True) for e in kern)
    ops = [e for e in evs if e.key.startswith("aten::")]
    return {
        "phase": "profile", "wall_s": wall_s, "device_busy_s": busy_us / 1e6,
        "aten_stack_ms": sum(dev_us(e, False) for e in ops
                             if e.key == "aten::stack") / 1e3,
        "device_idle_share_profiled": 1.0 - busy_us / 1e6 / wall_s,
        "kernels_ms": [[e.key[:80], dev_us(e, True) / 1e3, e.count]
                       for e in sorted(kern, key=lambda e: -dev_us(e, True))
                       [:top]],
        "aten_ops_ms": [[e.key, dev_us(e, False) / 1e3, e.count]
                        for e in sorted(ops, key=lambda e: -dev_us(e, False))
                        [:top]]}


def obs_files() -> dict:
    """The files in the working directory and the temporary directory:
    an unarmed run must add none."""
    import os
    import tempfile
    return {d: sorted(os.listdir(d)) for d in (os.getcwd(),
                                               tempfile.gettempdir())}


def same_result(a, b, label: str) -> None:
    """Two results of one query on one world: the same layout, every
    column equal bit for bit on the device."""
    if not np.array_equal(a.valid_counts, b.valid_counts) \
            or a.column_names != b.column_names:
        raise AssertionError(f"{label}: the layout differs from the "
                             "unarmed run")
    for name in a.column_names:
        if not torch.equal(a.column(name).data, b.column(name).data):
            raise AssertionError(f"{label}: column {name} differs from "
                                 "the unarmed run")


def same_groups(a, b, label: str) -> None:
    """Two join → groupby results on one world with the same groups on
    each shard, in the same order, their sums equal bit for bit (the
    routes may pad their shards differently)."""
    if not np.array_equal(a.valid_counts, b.valid_counts):
        raise AssertionError(f"{label}: groups per shard differ")
    ca, cb = a.capacity, b.capacity
    for name in ("k", "a_sum", "b_sum"):
        da, db = a.column(name).data, b.column(name).data
        for r, v in enumerate(np.asarray(a.valid_counts, np.int64)):
            if not torch.equal(da[r * ca:r * ca + v], db[r * cb:r * cb + v]):
                raise AssertionError(f"{label}: shard {r}'s {name} differs")


def obs_path(ct, lt, rt, left: dict, orc: dict, n: int, nc: int,
             need_k1: bool) -> dict:
    """Observability over the W = 4 pipelined BASELINE step on
    ``dist_pipelined_path``'s tables (module docstring): the unarmed run
    (no file, no trace event, no plan node, no comm entry), ``explain``
    of the pipelined and the monolithic step, ``explain_analyze`` with
    the comm matrix and the flight recorder armed (a warm-up, then 3
    runs), the registry's exposition, then the env's collectives on the
    left table."""
    import os
    import tempfile
    from cylon_tpu_torch.core.column import Column
    from cylon_tpu_torch.obs import comm, metrics, plan, rank_report, trace
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    from cylon_tpu_torch.utils import timing
    w = lt.env.world_size
    env = lt.env
    rec = {"phase": "obs_path", "world": w, "rows_per_side": n,
           "n_chunks": nc}

    total = {"splitter_probe": 0, "windowed_gather": 0}

    def launches():
        """The launches since the counts were last set to 0, added to the
        phase's total."""
        got = {"splitter_probe": sp.COUNTS["launches"],
               "windowed_gather": wg.COUNTS["launches"]}
        for key in total:
            total[key] += got[key]
        wg.reset_counts()
        sp.reset_counts()
        return got

    def expect(counts, runs, label):
        if counts["splitter_probe"] != w * runs or (
                need_k1 and counts["windowed_gather"] != w * nc * runs):
            raise AssertionError(f"obs_path {label}: kernel launches "
                                 f"{counts}, expected K2 {w} and K1 "
                                 f"{w * nc} per iteration")

    # -- unarmed: every switch off, nothing recorded or written ------------
    if (trace.armed() or comm.armed() or plan.active() or rank_report.armed()
            or os.environ.get("CYLON_TPU_TORCH_METRICS_JSON")
            or timing._TRACE[0] is not None):
        raise AssertionError("obs_path: an observability switch is on")

    def refuse(what):
        def boom(*a, **k):
            raise AssertionError(f"obs_path unarmed: {what}")
        return boom

    files0 = obs_files()
    push, record = plan._push_node, comm.record
    plan._push_node = refuse("a plan node was opened")
    comm.record = refuse("a comm entry was recorded")
    wg.reset_counts()
    sp.reset_counts()
    times = []
    try:
        for _ in range(4):                          # a warm-up, then 3
            base = pipelined_step(ct, lt, rt, nc, times)
    finally:
        plan._push_node, comm.record = push, record
    rec["unarmed_kernel_launches"] = launches()
    expect(rec["unarmed_kernel_launches"], 4, "unarmed")
    if obs_files() != files0 or comm.matrix() is not None:
        raise AssertionError("obs_path unarmed: a file or a comm entry "
                             "appeared")
    check_dist(base, orc, w, "obs_path unarmed")
    unarmed_best = min(t["total_s"] for t in times[1:])
    rec["unarmed"] = {"iterations": times, "best_s": unarmed_best,
                      "files_written": 0, "trace_events": 0,
                      "plan_nodes": 0, "comm_entries": 0}

    # -- explain: the static trees ----------------------------------------
    t0 = time.perf_counter()
    qp = ct.obs.explain(pipelined_step, ct, lt, rt, nc)
    rec["explain_s"] = time.perf_counter() - t0
    rec["explain_kernel_launches"] = launches()
    expect(rec["explain_kernel_launches"], 1, "explain")
    same_result(qp.result, base, "obs_path explain")
    root = qp.roots[0]
    kids = [c.op for c in root.children]
    if (root.op != "pipelined_join" or root.attrs.get("route")
            != "range_pipeline" or root.attrs.get("n_ranges") != nc
            or kids.count("join.piece") != nc or kids.count("shuffle") != 2):
        raise AssertionError(f"obs_path explain: tree {qp.static_dict()}")
    rec["explain_tree"] = qp.static_dict()
    qm = ct.obs.explain(step, ct, lt, rt)
    same_groups(qm.result, base, "obs_path explain (monolithic)")
    rec["explain_monolithic_kernel_launches"] = launches()
    if need_k1 and rec["explain_monolithic_kernel_launches"][
            "windowed_gather"] != w:
        raise AssertionError("obs_path explain (monolithic): K1 launches "
                             f"{rec['explain_monolithic_kernel_launches']}")
    roots = {r.op: r for r in qm.roots}
    if roots["join"].attrs.get("route") not in ("hash", "skew_split") or \
            roots["groupby"].attrs.get("route") != "fused_pushdown":
        raise AssertionError(f"obs_path explain (monolithic): tree "
                             f"{qm.static_dict()}")
    rec["explain_monolithic_tree"] = qm.static_dict()
    del qp, qm, roots, root

    # -- explain_analyze with the comm matrix and the recorder armed ------
    with tempfile.TemporaryDirectory(prefix="obs_path_") as tmp:
        comm.arm()
        comm.reset()
        trace.arm(path=os.path.join(tmp, "trace.json"))
        runs, expected_x = [], {}
        try:
            for i in range(4):                      # a warm-up, then 3
                rows0 = metrics.counter("exchange_rows_total").value
                bytes0 = metrics.counter("exchange_bytes_total").value
                times = []
                t0 = time.perf_counter()
                qa = ct.obs.explain_analyze(pipelined_step, ct, lt, rt, nc,
                                            times)
                wall = time.perf_counter() - t0
                same_result(qa.result, base, f"obs_path analyze run {i}")
                events = dict(timing._EVENT_COUNTS)
                for name, v in qa.global_phases.items():
                    expected_x[name] = expected_x.get(name, 0) \
                        + v["n"] - events.get(name, 0)
                recn = qa.reconcile()
                bad = [k for k, s in recn["per_phase_node_s"].items()
                       if abs(s - qa.global_phases[k]["s"])
                       > max(2e-3, 1e-4 * abs(qa.global_phases[k]["s"]))]
                if recn["node_s"] > recn["phase_s"] + 1e-6 or abs(
                        recn["unattributed_s"]) > max(
                            0.05 * recn["phase_s"], 0.02) or bad:
                    raise AssertionError(f"obs_path analyze run {i}: "
                                         f"reconcile {recn}, regions {bad}")
                cm = qa.comm
                drows = metrics.counter("exchange_rows_total").value - rows0
                dbytes = metrics.counter("exchange_bytes_total").value \
                    - bytes0
                mr, mb = np.asarray(cm["rows"]), np.asarray(cm["bytes"])
                # the matrix and the counters are two records of the same
                # count matrix; the inputs give an independent total: each
                # live row of both sides crosses the exchange once a run
                if (int(mr.sum()) != 2 * n or int(mr.sum()) != drows
                        or int(mb.sum()) != dbytes
                        or cm["total_rows"] != drows
                        or mb.sum(axis=1).tolist() != cm["row_sums_bytes"]
                        or mb.sum(axis=0).tolist() != cm["col_sums_bytes"]):
                    raise AssertionError(f"obs_path analyze run {i}: comm "
                                         f"matrix {cm} against counter "
                                         f"deltas {drows} rows, {dbytes} B")
                prof = qa.roots[0].heavy
                if prof is None or prof["heavy"] or \
                        prof["max_key_share"] >= 0.05:
                    raise AssertionError(f"obs_path analyze: key profile "
                                         f"{prof} on uniform keys")
                runs.append({"s": times[0]["total_s"], "wall_s": wall,
                             "reconcile": {k: recn[k] for k in (
                                 "node_s", "phase_s", "unattributed_s")},
                             "comm_total_rows": cm["total_rows"],
                             "comm_total_bytes": cm["total_bytes"]})
                del qa
            rec["analyze_kernel_launches"] = launches()
            expect(rec["analyze_kernel_launches"], 4, "analyze")
            rec["comm_matrix_rows"] = cm["rows"]
            rec["comm_matrix_bytes"] = cm["bytes"]
            rec["comm_exchanges_per_run"] = cm["exchanges"]
            rec_t = trace.recorder()
            n_events, dropped = rec_t._n, rec_t.dropped
            path = trace.export()
            size = os.path.getsize(path)
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            got_x = {}
            for e in doc["traceEvents"]:
                if e["ph"] == "X":
                    got_x[e["name"]] = got_x.get(e["name"], 0) + 1
            dispatch = got_x.pop("pipe.piece_dispatch", 0)
            want_x = {k: v for k, v in expected_x.items() if v}
            if dropped or got_x != want_x or dispatch != 4 * nc:
                raise AssertionError(
                    f"obs_path trace: complete events {got_x} (and "
                    f"{dispatch} piece dispatches), regions called "
                    f"{want_x}, {dropped} dropped")
            inflight = [e for e in doc["traceEvents"]
                        if e["name"] == "sink.chunk_inflight"]
            rec["trace"] = {"events": n_events, "dropped": dropped,
                            "exported_bytes": size,
                            "complete_events": sum(got_x.values()),
                            "piece_dispatch_spans": dispatch,
                            "sink_inflight_pairs": len(inflight) // 2}
            # the registry's exposition after the runs
            text = metrics.prometheus_text()
            fams = ("cylon_tpu_torch_exchange_rows_total",
                    "cylon_tpu_torch_exchange_bytes_total",
                    "cylon_tpu_torch_memory_ledger_bytes",
                    "cylon_tpu_torch_memory_spill_events",
                    "cylon_tpu_torch_ckpt_checkpoint_events")
            missing = [f for f in fams if f not in text]
            snap_path = os.path.join(tmp, "metrics.json")
            metrics.write_snapshot(snap_path)
            with open(snap_path, encoding="utf-8") as f:
                snap = json.load(f)["metrics"]
            if missing or "exchange_rows_total" not in snap \
                    or "phases" not in snap:
                raise AssertionError(f"obs_path metrics: families missing "
                                     f"{missing}, snapshot keys "
                                     f"{sorted(snap)[:20]}")
            rec["prometheus_lines"] = len(text.splitlines())
            rec["snapshot_bytes"] = os.path.getsize(snap_path)
        finally:
            trace.disarm()
            comm.arm(False)
            comm.reset()
            timing.reset()
    armed_best = min(r["s"] for r in runs[1:])
    rec.update(analyze_runs=runs, analyze_best_s=armed_best,
               unarmed_best_s=unarmed_best,
               arming_cost_s=armed_best - unarmed_best)

    # -- the key profile names a hot key ----------------------------------
    k = lt.column("k")
    gen = torch.Generator(device=k.data.device).manual_seed(9)
    hot = int(orc["k"][len(orc["k"]) // 2])
    kh = torch.where(torch.rand(k.data.shape, device=k.data.device,
                                generator=gen) < 0.9,
                     torch.full((), hot, dtype=k.data.dtype,
                                device=k.data.device), k.data)
    hot_t = lt.with_columns({"k": Column(kh, k.type, k.validity,
                                         k.dictionary)})
    vc = torch.as_tensor(np.asarray(lt.valid_counts),
                         device=kh.device)
    cap = lt.capacity
    live = (torch.arange(cap, device=kh.device)[None, :]
            < vc[:, None]).reshape(-1)
    truth = int(((kh == hot) & live).sum()) / n
    t0 = time.perf_counter()
    prof = ct.obs.plan.key_profile(hot_t, "k")
    top = prof["heavy"][0] if prof["heavy"] else {}
    if top.get("key") != hot or not truth / 2 <= top["share"] <= truth * 2:
        raise AssertionError(f"obs_path key profile: {prof}, hot key {hot} "
                             f"at {truth}")
    rec["key_profile"] = {"hot_key": hot, "true_share": truth,
                          "profile_share": top["share"],
                          "sampled": prof["sampled"],
                          "s": time.perf_counter() - t0}
    del kh, hot_t, live, k

    # -- the env's collectives on the left table ---------------------------
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    coll = {}
    g, coll["gather_s"] = timed(lambda: env.gather(lt, 0))
    if [int(x) for x in g.valid_counts] != [n] + [0] * (w - 1):
        raise AssertionError(f"obs_path gather: counts {g.valid_counts}")
    for name in ("k", "a"):
        host = torch.from_numpy(left[name]).to(g.column(name).data.device)
        if not torch.equal(g.column(name).data[:n], host):
            raise AssertionError(f"obs_path gather: column {name} is not "
                                 "the host copy in global order")
        del host
    del g
    b, coll["bcast_s"] = timed(lambda: env.bcast(lt, 0))
    if [int(x) for x in b.valid_counts] != [int(lt.valid_counts[0])] * w:
        raise AssertionError(f"obs_path bcast: counts {b.valid_counts}")
    for name in ("k", "a"):
        blocks = b.column(name).data.view(w, -1)
        src = lt.column(name).data.view(w, -1)[0]
        if not all(torch.equal(blocks[r], src) for r in range(w)):
            raise AssertionError(f"obs_path bcast: a shard's {name} differs "
                                 "from rank 0's")
    del b, blocks, src
    chunk = int(lt.valid_counts[0])
    host = np.zeros((w, cap), np.int64)
    vcs = np.asarray(lt.valid_counts, np.int64)
    for r in range(w):
        host[r, :vcs[r]] = left["k"][r * chunk:r * chunk + vcs[r]]
    ident = {"sum": 0, "min": np.iinfo(np.int64).max,
             "max": np.iinfo(np.int64).min}
    for op in ("sum", "min", "max"):
        red, coll[f"allreduce_{op}_s"] = timed(
            lambda: env.allreduce(lt.column("k"), op, lt.valid_counts))
        masked = np.where(np.arange(cap)[None, :] < vcs[:, None], host,
                          ident[op])
        want = getattr(masked, op)(axis=0)
        if red.dtype != np.int64 or not np.array_equal(red, want):
            raise AssertionError(f"obs_path allreduce {op}: differs from "
                                 "numpy")
    del host, masked
    _, coll["barrier_s"] = timed(env.barrier)
    rec["collectives"] = coll
    launches()
    rec["kernel_counts"] = {key: {"launches": v} for key, v in total.items()}
    rec["oracle"] = "equal"
    torch.cuda.empty_cache()
    return rec


#: rows per side of integrity_path's skew split (configuration 5's
#: shape) and of its checkpoint drill
INTEGRITY_SKEW_ROWS = 8_388_608
INTEGRITY_CKPT_ROWS = 1_000_000
#: the audit counters integrity_path reports per armed iteration
AUDIT_KEYS = ("conservation_checks", "fingerprint_checks",
              "fingerprint_votes", "violations", "manifest_fps",
              "manifest_audits", "corruptions_injected")


@contextlib.contextmanager
def audit_armed(on: bool = True):
    """``CYLON_TPU_TORCH_AUDIT`` set for the block (the switch is cached:
    read again on both edges)."""
    import os
    from cylon_tpu_torch.exec import integrity
    old = os.environ.get("CYLON_TPU_TORCH_AUDIT")
    os.environ["CYLON_TPU_TORCH_AUDIT"] = "1" if on else "0"
    integrity.rearm()
    try:
        yield integrity
    finally:
        if old is None:
            os.environ.pop("CYLON_TPU_TORCH_AUDIT", None)
        else:
            os.environ["CYLON_TPU_TORCH_AUDIT"] = old
        integrity.rearm()


def audit_delta(before: dict) -> dict:
    from cylon_tpu_torch.exec import integrity
    now = integrity.stats()
    return {k: now[k] - before[k] for k in AUDIT_KEYS}


def columns_digest(t) -> str:
    """sha256 over a table's columns (sorted by name), data and validity,
    shard by shard in layout order: equal digests, equal tables."""
    import hashlib
    h = hashlib.sha256()
    h.update(np.asarray(t.valid_counts, np.int64).tobytes())
    for name, (d, v) in sorted(t.host_columns().items()):
        h.update(name.encode())
        h.update(np.ascontiguousarray(d).tobytes())
        if v is not None:
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def integrity_path(ct, lt, rt, orc, n: int, nc: int, need_k1: bool,
                   w4: dict, device=None, profile: bool = True) -> dict:
    """``integrity_path`` (module docstring): dist_path's W = 4 tables with
    the audit armed (``CYLON_TPU_TORCH_AUDIT=1``).  The monolithic route a
    warm-up then 3 iterations armed, alternating with 3 unarmed ones: the
    armed digest must equal dist_path's, the audit counters per iteration
    are reported (fingerprints checked and voted, no violation).  The
    pipelined route armed, its digest equal to its unarmed run's.  The
    ``exchange.corrupt`` drills on the monolithic route: a one-shot flip
    is recomputed (one integrity retry, the result's groups equal to the
    unarmed run's), a persistent one raises ``DataIntegrityError`` at
    ``shuffle.recv`` after one retry.  An armed configuration-5 split at
    ``INTEGRITY_SKEW_ROWS`` a side (the stitch audited, its table equal
    to the unarmed one's), and an armed checkpointed pipelined join at
    ``INTEGRITY_CKPT_ROWS`` a side whose last piece's recorded
    fingerprint is tampered: the resume recomputes that piece, never
    adopts it.  Reports armed against unarmed seconds and the
    fingerprint's time and top aten ops on the 125M-row left table."""
    import os
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.exec import integrity
    from cylon_tpu_torch.exec import recovery
    from cylon_tpu_torch.relational import skew
    from cylon_tpu_torch.status import DataIntegrityError
    w = lt.env.world_size
    rec = {"phase": "integrity_path", "world": w, "rows_per_side": n}
    recovery_events()
    # the monolithic route, armed against unarmed, in turns
    times = {"armed": [], "unarmed": []}
    kernel_counts(reset=True)
    per_iter = []
    with audit_armed():
        g = step(ct, lt, rt)                    # the armed warm-up
        del g
    turns = (False, True, True, False, False, True)
    for i, armed in enumerate(turns):
        with audit_armed(armed):
            before = integrity.stats()
            g = step(ct, lt, rt, times["armed" if armed else "unarmed"])
            if armed:
                per_iter.append(audit_delta(before))
            if i == 0:
                ref_groups = result_digest(g)
            elif i == len(turns) - 1:
                check_dist(g, orc, w, "integrity_path armed")
                digest = shard_digest(g)
            del g
    mono = kernel_counts()
    if digest != w4["dist_path"]["digest"]:
        raise AssertionError(f"integrity_path: the armed digest {digest} "
                             "differs from dist_path's")
    if any(d["fingerprint_checks"] < 1 or d["violations"]
           or d["fingerprint_votes"] != d["fingerprint_checks"]
           for d in per_iter) or any(d != per_iter[0] for d in per_iter):
        raise AssertionError(f"integrity_path: audit counters {per_iter}")
    if mono["windowed_gather"]["launches"] not in (
            (7 * w,) if need_k1 else (0, 7 * w)):
        raise AssertionError(f"integrity_path kernel counts {mono}")
    no_recovery("integrity_path monolithic")
    best = {k: min(t["total_s"] for t in v) for k, v in times.items()}
    rec.update(iterations=times, armed_best_s=best["armed"],
               unarmed_best_s=best["unarmed"],
               armed_cost_s=best["armed"] - best["unarmed"],
               audit_per_iteration=per_iter[0])
    torch.cuda.empty_cache()

    # the pipelined route, armed, against its own unarmed run
    ptimes = {"armed": [], "unarmed": []}
    pdig = {}
    for i, armed in enumerate((False, True, True, False)):
        with audit_armed(armed):
            before = integrity.stats()
            g = pipelined_step(ct, lt, rt, nc,
                               ptimes["armed" if armed else "unarmed"])
            if i in (0, 2):
                pdig[armed] = shard_digest(g)
            if armed:
                pdelta = audit_delta(before)
            del g
    if pdig[True] != pdig[False] or pdelta["fingerprint_checks"] < 1 \
            or pdelta["violations"]:
        raise AssertionError(f"integrity_path pipelined: digests {pdig}, "
                             f"audit {pdelta}")
    # the unarmed pipelined digest, which analysis_path holds its armed
    # run to
    w4["pipelined_digest"] = pdig[False]
    no_recovery("integrity_path pipelined")
    counts = kernel_counts()
    if counts["splitter_probe"]["launches"] != 4 * w:
        raise AssertionError(f"integrity_path kernel counts {counts}")
    rec["kernel_counts"] = counts
    rec["pipelined"] = {
        "n_chunks": nc, "iterations": ptimes,
        "armed_s": min(t["total_s"] for t in ptimes["armed"]),
        "unarmed_s": min(t["total_s"] for t in ptimes["unarmed"]),
        "audit_per_iteration": pdelta, "digest": "equal to unarmed"}
    torch.cuda.empty_cache()

    # the exchange.corrupt drills
    drills = {}
    with audit_armed():
        recovery.install_faults("exchange.corrupt=corrupt")
        try:
            before = integrity.stats()
            t0 = time.perf_counter()
            g = step(ct, lt, rt)
            got = result_digest(g)
            drills["once_s"] = time.perf_counter() - t0
            del g
            # read before the injector is disarmed, which clears the log
            ev = recovery_events()
        finally:
            recovery.install_faults("")
        drills["once_events"] = ev
        drills["once_audit"] = audit_delta(before)
        if got != ref_groups or [e for e in ev if e[1] == "integrity"] != [
                ("join", "integrity", "retry_chunks_4")] \
                or drills["once_audit"]["corruptions_injected"] != 1:
            raise AssertionError(f"integrity_path one-shot drill: {got}, "
                                 f"events {ev}, audit {drills}")
        torch.cuda.empty_cache()
        recovery.install_faults("exchange.corrupt::*=corrupt")
        try:
            t0 = time.perf_counter()
            step(ct, lt, rt)
            raise AssertionError("integrity_path: the persistent drill "
                                 "returned a result")
        except DataIntegrityError as e:
            drills["always"] = {"error": type(e).__name__, "site": e.site,
                                "phase": e.phase,
                                "s": time.perf_counter() - t0}
            ev = recovery_events()
        finally:
            recovery.install_faults("")
        drills["always_events"] = ev
        if drills["always"]["site"] != "shuffle.recv" or [
                e[2] for e in ev if e[1] == "integrity"] != [
                "retry_chunks_4", "abort"]:
            raise AssertionError(f"integrity_path persistent drill: {drills}")
    rec["drills"] = drills
    torch.cuda.empty_cache()

    # one armed configuration-5 split: the stitch audited
    left, right, _mv, _hot = skew_inputs(INTEGRITY_SKEW_ROWS)
    env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
    slt = ct.Table.from_pydict(left, env)
    srt = ct.Table.from_pydict(right, env)
    del left, right
    sk = {}
    for armed in (False, True):
        with audit_armed(armed):
            before = integrity.stats()
            j = ct.join_tables(slt, srt, "k", "k")
            t0 = time.perf_counter()
            sk[armed] = columns_digest(j)
            sk[f"s{int(armed)}"] = time.perf_counter() - t0
            if armed:
                sdelta = audit_delta(before)
                plan = skew.last_plan()
            del j
    if sk[True] != sk[False] or plan is None \
            or sdelta["fingerprint_checks"] < 1 or sdelta["violations"]:
        raise AssertionError(f"integrity_path skew: {sk}, audit {sdelta}")
    no_recovery("integrity_path skew")
    rec["skew"] = {"rows_per_side": INTEGRITY_SKEW_ROWS,
                   "plan": plan.summary(), "audit": sdelta,
                   "materialize_unarmed_s": sk["s0"],
                   "materialize_armed_s": sk["s1"],
                   "table": "equal to unarmed"}
    del slt, srt
    torch.cuda.empty_cache()

    # a checkpointed run whose recorded fingerprint is tampered
    left, right, mv = baseline_inputs(INTEGRITY_CKPT_ROWS, seed=37)
    corc = oracle(left, right, mv)
    clt = ct.Table.from_pydict(left, env)
    crt = ct.Table.from_pydict(right, env)
    import shutil
    import tempfile
    croot = tempfile.mkdtemp(prefix="cylon_integrity_")
    try:
        with audit_armed(), ckpt_env(CKPT_DIR=croot) as checkpoint:
            g = pipelined_step(ct, clt, crt, CKPT_CHUNKS)
            want = result_digest(g)
            check_dist(g, corc, w, "integrity_path checkpointed")
            del g
            pieces = checkpoint.stats()["checkpoint_events"]
        man = manifest_of(croot)
        last = sorted(man["pieces"], key=int)[-1]
        fps = [man["pieces"][p]["fp"] for p in man["pieces"]]
        if any(fp is None for fp in fps):
            raise AssertionError(f"integrity_path: an armed manifest "
                                 f"recorded no fingerprint: {fps}")
        path = os.path.join(man.pop("dir"), "MANIFEST.json")
        man["pieces"][last]["fp"] ^= 1
        with open(path, "w", encoding="utf-8") as f:
            json.dump(man, f)
        recovery_events()
        with audit_armed(), ckpt_env(CKPT_DIR=croot, RESUME=1) as checkpoint:
            before = integrity.stats()
            t0 = time.perf_counter()
            g = pipelined_step(ct, clt, crt, CKPT_CHUNKS)
            resume_s = time.perf_counter() - t0
            got = result_digest(g)
            del g
            st = checkpoint.stats()
            cdelta = audit_delta(before)
            ev = recovery_events()      # before ckpt_env clears the log
    finally:
        shutil.rmtree(croot, ignore_errors=True)
    if got != want or st["resume_fast_forwarded_pieces"] != pieces - 1 \
            or ("ckpt.load", "corrupt", "recompute") not in ev \
            or cdelta["violations"] != 1:
        raise AssertionError(f"integrity_path tampered resume: {got} vs "
                             f"{want}, counters {st}, events {ev}, audit "
                             f"{cdelta}")
    rec["ckpt_tampered_resume"] = {
        "rows_per_side": INTEGRITY_CKPT_ROWS, "pieces": pieces,
        "fast_forwarded": st["resume_fast_forwarded_pieces"],
        "recomputed": pieces - st["resume_fast_forwarded_pieces"],
        "events": ev, "audit": cdelta, "resume_s": resume_s,
        "digest": "equal to the uninterrupted run"}
    del clt, crt
    torch.cuda.empty_cache()

    # the fingerprint itself on the 125M-row left table: its time, the
    # bytes it must read, and its top aten ops
    fp_bytes = sum(c.data.numel() * c.data.element_size()
                   for c in lt.columns.values())
    rec["fingerprint"] = {
        "rows": int(lt.column("k").data.shape[0]), "bytes": fp_bytes,
        "ms": time_ms(lambda: integrity.table_fingerprint(lt), reps=3),
        "bound_ms": fp_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    if profile:
        prof = profile_step(ct, lt, rt, top=10, step_fn=lambda c, a, b:
                            integrity.table_fingerprint(a))
        rec["fingerprint"]["aten_ops_ms"] = prof["aten_ops_ms"]
        rec["fingerprint"]["kernels_ms"] = prof["kernels_ms"][:6]
    torch.cuda.empty_cache()
    rec["oracle"] = ("equal; armed digests equal to unarmed; drills "
                     "recomputed and typed")
    return rec


@contextlib.contextmanager
def sentinel_armed(on_cuda: bool):
    """The runtime sentinel (analysis/runtime.py) armed for the block,
    counting the funnel's pulls and, on the card, the stray syncs.
    Yields ``(pulls, syncs)``; the sentinel's log and builds are read
    inside the block."""
    from cylon_tpu_torch.analysis import runtime
    was = runtime.enabled()
    runtime.enable()
    runtime.reset()
    try:
        with runtime.transfer_scope() as pulls, \
                (runtime.sync_scope() if on_cuda else
                 contextlib.nullcontext(runtime.SyncCounts())) as syncs:
            yield pulls, syncs
    finally:
        if not was:
            runtime.disable()


def sentinel_counts(pulls, syncs) -> dict:
    """A sentinel block's counts: funnel pulls by kind and by kind and
    site, stray syncs by site and the funnel's own syncs by site."""
    return {"pulls": dict(pulls),
            "pull_sites": {f"{k}@{site}": v
                           for (k, site), v in sorted(pulls.sites.items())},
            "stray_syncs": dict(sorted(syncs.items())),
            "stray_syncs_total": sum(syncs.values()),
            "funnel_syncs": dict(sorted(syncs.funnel.items())),
            "funnel_syncs_total": sum(syncs.funnel.values())}


def analysis_path(ct, lt, rt, n: int, nc: int, need_k1: bool,
                  w4: dict) -> dict:
    """``analysis_path`` (module docstring): the runtime sentinel on
    dist_path's W = 4 tables.  Per route (monolithic; pipelined at
    ``nc`` chunks) a warm-up, one unarmed and one armed iteration, the
    armed digest equal to the unarmed runs' of this process
    (``dist_path``'s, ``integrity_path``'s unarmed pipelined one); per
    armed iteration the funnel's pulls by kind and site, the stray syncs
    by site (the card's sync debug mode, the funnel's own apart), the
    collective log (empty in one process), the kernel builds of the phase
    (0) and armed − unarmed seconds."""
    from cylon_tpu_torch.analysis import runtime
    from cylon_tpu_torch.exec import compiler
    w = lt.env.world_size
    on_cuda = lt.env.on_cuda
    rec = {"phase": "analysis_path", "world": w, "rows_per_side": n,
           "n_chunks": nc}
    recovery_events()
    builds0 = compiler.stats()["cache_misses"]
    kernel_counts(reset=True)
    for route, run, want in (
            ("monolithic", lambda times: step(ct, lt, rt, times),
             w4["dist_path"]["digest"]),
            ("pipelined", lambda times: pipelined_step(ct, lt, rt, nc,
                                                       times),
             w4["pipelined_digest"])):
        times = []
        for _ in range(2):                      # a warm-up, then unarmed
            run(times)
        with sentinel_armed(on_cuda) as (pulls, syncs):
            g = run(times)
            log = runtime.collective_log()
            budgets = runtime.check_budgets()
            built = sum(runtime.state().builds.values())
        armed = shard_digest(g)
        del g
        if armed != want:
            raise AssertionError(f"analysis_path {route}: armed digest "
                                 f"{armed}, unarmed {want}")
        if budgets or built:
            raise AssertionError(f"analysis_path {route}: {built} kernel "
                                 f"builds armed, budgets {budgets}")
        rec[route] = {"iterations": times,
                      "unarmed_s": times[1]["total_s"],
                      "armed_s": times[2]["total_s"],
                      "armed_minus_unarmed_s":
                          times[2]["total_s"] - times[1]["total_s"],
                      "collective_log_len": len(log), "digest": armed,
                      **sentinel_counts(pulls, syncs)}
    counts = kernel_counts()
    if need_k1 and (counts["windowed_gather"]["launches"] < 1
                    or counts["splitter_probe"]["launches"] < 1):
        raise AssertionError(f"analysis_path kernel counts {counts}")
    rec["kernel_counts"] = counts
    rec["kernel_builds"] = compiler.stats()["cache_misses"] - builds0
    if rec["kernel_builds"]:
        raise AssertionError(f"analysis_path built {rec['kernel_builds']} "
                             "kernel libraries")
    no_recovery("analysis_path")
    rec["oracle"] = "armed digests equal to unarmed; no kernel build"
    return rec


def dist_phases(ct, left, right, orc, n: int, need_k1: bool, routes: dict,
                device=None) -> dict:
    """The W > 1 phases (module docstring): ``dist_small`` at W = 8 and 3,
    then ``dist_path``, ``dist_pipelined_path`` and ``exchange`` at W = 4
    on the host arrays ``left``/``right`` of ``n`` rows per side, whose
    oracle is ``orc``.  Adds each route's kernel counts to ``routes``.
    Returns ``routes`` and the W = 4 kernel checks: K1 and K2 held against
    their plain versions, and timed, on the inputs of their first launch
    (shard 0) in each W = 4 route.  ``device`` is the card unless a
    rehearsal passes the CPU."""
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    from cylon_tpu_torch.utils import timing
    sleft, sright, smv = baseline_inputs(1_000_000)
    sorc = oracle(sleft, sright, smv)
    for w in (8, 3):
        envw = ct.CylonEnv(VirtualMeshConfig(w), device=device)
        lt = ct.Table.from_pydict(sleft, envw)
        rt = ct.Table.from_pydict(sright, envw)
        wg.reset_counts()
        groups = check_dist(step(ct, lt, rt), sorc, w,
                            f"dist_small W={w} monolithic")
        mono = {"windowed_gather": dict(wg.COUNTS)}
        wg.reset_counts()
        sp.reset_counts()
        nc = max(2, -(-(1_000_000 // w) // PIECE_ROWS))
        check_dist(pipelined_step(ct, lt, rt, nc), sorc, w,
                   f"dist_small W={w} pipelined")
        pipe = {"splitter_probe": dict(sp.COUNTS),
                "windowed_gather": dict(wg.COUNTS)}
        if pipe["splitter_probe"]["launches"] != w:
            raise AssertionError(f"dist_small W={w}: K2 counts {pipe}, "
                                 f"expected one launch per shard")
        routes[f"monolithic_w{w}_1M"] = mono["windowed_gather"]
        routes[f"pipelined_w{w}_1M"] = pipe
        emit({"phase": "dist_small", "world": w, "rows_per_side": 1_000_000,
              "n_chunks": nc, "groups": groups, "oracle": "equal",
              "placement": "every group on the reference hash's shard",
              "kernel_counts": {"monolithic": mono, "pipelined": pipe}})
        del lt, rt, envw
    del sleft, sright, sorc

    # dist_path: W = 4 at --rows per side in total, the monolithic route
    w = 4
    env4 = ct.CylonEnv(VirtualMeshConfig(w), device=device)
    t0 = time.perf_counter()
    lt, rt = ct.Table.from_pydict(left, env4), ct.Table.from_pydict(right,
                                                                    env4)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wg.reset_counts()
    times = []
    g = step(ct, lt, rt, times)                 # warm-up (first sight)
    for _ in range(3):
        g = step(ct, lt, rt, times)
    d_counts = dict(wg.COUNTS)
    d_peak = torch.cuda.max_memory_allocated()
    n_groups = check_dist(g, orc, w, "dist_path")
    # the W = 4 result's digest, layout included: procs_path's children
    # must reach it
    digest = shard_digest(g)
    del g
    if d_counts["redispatches"] != 0 or d_counts["launches"] not in (
            (4 * w,) if need_k1 else (0, 4 * w)):
        raise AssertionError(f"dist_path windowed gather counts {d_counts}:"
                             f" expected {w} launches per iteration (one "
                             "per shard) and no redispatch")
    # the attribution run also keeps shard 0's K1 inputs
    split, captured, w4 = [], {}, {}
    timing.enable("block")
    timing.reset()
    with capturing(wg, "windowed_take_t", captured, "mono", keep_k1):
        check_dist(step(ct, lt, rt, split), orc, w,
                   "dist_path attribution run")
    phases = timing.snapshot()
    timing.enable(None)
    dbest = min(t["total_s"] for t in times[1:])
    emit({"phase": "dist_path", "world": w, "rows_per_side": n,
          "groups": n_groups, "setup_s": setup_s, "iterations": times,
          "best_s": dbest, "rows_per_s": 2 * n / dbest,
          "peak_mem_bytes": d_peak, "oracle": "equal",
          "kernel_counts": {"windowed_gather": d_counts},
          "phase_split_s": {
              "hash_both_sides": phases.get("shuffle.hash", 0.0),
              "exchange_both_sides": phases.get("shuffle.exchange", 0.0),
              "shuffle_total": phases.get("join.shuffle", 0.0),
              "skew_detect": phases.get("skew.detect", 0.0),
              "join": split[0]["join_s"] - phases.get("join.shuffle", 0.0),
              "fused_groupby": split[0]["groupby_s"],
              "total": split[0]["total_s"]}})
    routes["monolithic_w4"] = d_counts
    w4["dist_path"] = {"best_s": dbest, "peak_mem_bytes": d_peak,
                       "digest": digest}
    if "mono" in captured:
        w4["k1_monolithic"] = k1_check(wg, "w4_monolithic_shard0",
                                       *captured.pop("mono"), True,
                                       timed=True)
        emit(w4["k1_monolithic"])
    elif need_k1:
        raise AssertionError("dist_path: the attribution run launched no K1")
    torch.cuda.empty_cache()
    prof = profile_step(ct, lt, rt)
    prof["phase"] = "profile_dist"
    prof["device_idle_share_of_best"] = 1.0 - prof["device_busy_s"] / dbest
    emit(prof)

    # the same uniform join with the port's split off: what the armed
    # route's detect (a sample pull, the sketch on the host) costs a join
    # that finds no heavy key, in time and in device idle share
    from cylon_tpu_torch import config as pconfig
    utimes = []
    pconfig.SKEW_SPLIT = False
    try:
        for _ in range(4):                      # a warm-up, then 3
            g = step(ct, lt, rt, utimes)
        check_dist(g, orc, w, "dist_path unarmed")
        del g
        torch.cuda.empty_cache()
        uprof = profile_step(ct, lt, rt)
    finally:
        pconfig.SKEW_SPLIT = True
    ubest = min(t["total_s"] for t in utimes[1:])
    w4["dist_path_unarmed_best_s"] = ubest
    emit({"phase": "dist_path_unarmed", "world": w, "rows_per_side": n,
          "iterations": utimes, "best_s": ubest, "armed_best_s": dbest,
          "arming_cost_s": dbest - ubest,
          "armed_skew_detect_s": phases.get("skew.detect", 0.0),
          "device_idle_share_of_best": 1.0 - uprof["device_busy_s"] / ubest,
          "armed_device_idle_share_of_best":
              prof["device_idle_share_of_best"], "oracle": "equal"})

    # topo_virtual: the same tables declared as 2 slices of 2 ranks, so
    # the exchange runs the two-hop route as two device-local hops
    trec = topo_virtual(ct, lt, rt, orc, n, need_k1, w4)
    routes["topo_virtual_w4"] = trec["kernel_counts"]
    emit(trec)
    del trec

    # dist_pipelined_path: the same tables through the pipelined route
    nc = max(2, -(-(n // w) // PIECE_ROWS))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wg.reset_counts()
    sp.reset_counts()
    times = []
    g = pipelined_step(ct, lt, rt, nc, times)           # warm-up
    for _ in range(3):
        g = pipelined_step(ct, lt, rt, nc, times)
    dp_counts = {"splitter_probe": dict(sp.COUNTS),
                 "windowed_gather": dict(wg.COUNTS)}
    dp_peak = torch.cuda.max_memory_allocated()
    n_groups = check_dist(g, orc, w, "dist_pipelined_path")
    del g
    if dp_counts["splitter_probe"]["launches"] != 4 * w or (
            need_k1 and dp_counts["windowed_gather"]["launches"]
            != 4 * w * nc):
        raise AssertionError(f"dist_pipelined_path kernel counts "
                             f"{dp_counts}: expected K2 once per shard and "
                             "K1 once per shard and piece per iteration")
    # the attribution run also keeps shard 0's K2 inputs and its first
    # piece's K1 inputs
    timing.enable("block")
    timing.reset()
    t0 = time.perf_counter()
    with capturing(sp, "count_ge_splitters", captured, "probe"), \
            capturing(wg, "windowed_take_t", captured, "piece", keep_k1):
        check_dist(pipelined_step(ct, lt, rt, nc), orc, w,
                   "dist_pipelined_path attribution run")
    attributed_s = time.perf_counter() - t0
    phases = timing.snapshot()
    timing.enable(None)
    dpbest = min(t["total_s"] for t in times[1:])
    emit({"phase": "dist_pipelined_path", "world": w, "rows_per_side": n,
          "n_chunks": nc, "groups": n_groups, "iterations": times,
          "best_s": dpbest, "rows_per_s": 2 * n / dpbest,
          "peak_mem_bytes": dp_peak, "oracle": "equal",
          "kernel_counts": dp_counts, "phase_split_s": phases,
          "phase_split_total_s": attributed_s})
    routes["pipelined_w4"] = dp_counts
    if "piece" in captured:
        w4["k1_pipelined_piece"] = k1_check(
            wg, "w4_pipelined_shard0_piece0", *captured.pop("piece"),
            timed=True)
        emit(w4["k1_pipelined_piece"])
    elif need_k1:
        raise AssertionError("dist_pipelined_path: the attribution run "
                             "launched no K1")
    w4["k2_pipelined"] = k2_check(sp, "w4_pipelined_shard0",
                                  *captured.pop("probe"), timed=True)
    emit(w4["k2_pipelined"])
    torch.cuda.empty_cache()

    # obs_path: observability over the same step on the same tables
    orec = obs_path(ct, lt, rt, left, orc, n, nc, need_k1)
    routes["obs_path_w4"] = orec["kernel_counts"]
    emit(orec)
    del orec

    # integrity_path: the audit armed on the same tables, the drills
    irec = integrity_path(ct, lt, rt, orc, n, nc, need_k1, w4,
                          device=device)
    routes["integrity_path_w4"] = irec["kernel_counts"]
    emit(irec)
    del irec

    # analysis_path: the runtime sentinel armed on the same tables
    arec = analysis_path(ct, lt, rt, n, nc, need_k1, w4)
    routes["analysis_path_w4"] = arec["kernel_counts"]
    emit(arec)
    del arec

    # exchange: hash_rows and shuffle_table of one side at W = 4
    from cylon_tpu_torch.ops import hashing
    from cylon_tpu_torch.parallel import shuffle as pshuf
    from cylon_tpu_torch.relational import repart
    torch.cuda.empty_cache()
    key = lt.column("k").data
    rows = key.shape[0]
    tgt = pshuf.hash_targets(env4, [key], [None], lt.valid_counts)
    pairs = pshuf.count_targets(env4, tgt)
    out = repart.shuffle_table(lt, ["k"])
    ocap = out.capacity
    okeys = out.column("k").data
    for r in range(w):                  # rows landed where the hash says
        kr = okeys[r * ocap:r * ocap + min(int(out.valid_counts[r]),
                                           1 << 20)].cpu().numpy()
        if not np.array_equal(np_partition_of(kr, w), np.full(len(kr), r)):
            raise AssertionError(f"exchange: a row of shard {r} belongs "
                                 "elsewhere by the reference's hash")
    flat, _ = repart._flatten_for_exchange(lt)
    del out, okeys
    env8 = ct.CylonEnv(VirtualMeshConfig(8), device=device)
    tgt8 = torch.randint(0, 9, (rows,), dtype=torch.int32, device=key.device,
                         generator=torch.Generator(
                             device=key.device).manual_seed(8))
    if int(pshuf.count_targets(env8, tgt8).sum()) \
            != int((tgt8 < 8).sum()):
        raise AssertionError("count_targets at W=8 lost rows")
    hash_bytes = 8 * rows + 8 * rows            # int64 keys in, hashes out
    in_bytes = sum(c.data.numel() * c.data.element_size()
                   for c in lt.columns.values())
    shuffle_bytes = in_bytes + in_bytes // lt.capacity * ocap
    xrec = {"phase": "exchange", "world": w, "rows": rows,
            "rows_per_dest": [int(x) for x in pairs.sum(axis=0)],
            "out_cap": ocap,
            "hash_rows_ms": time_ms(lambda: hashing.hash_rows([key])),
            "hash_bytes": hash_bytes,
            "hash_bound_ms": hash_bytes / HBM_BYTES_PER_S * 1e3,
            "hash_targets_ms": time_ms(lambda: pshuf.hash_targets(
                env4, [key], [None], lt.valid_counts)),
            "count_targets_ms": time_ms(lambda: pshuf.count_targets(env4,
                                                                    tgt)),
            # the count's work grows as W^2: the same rows as 8 shards
            "count_targets_w8_ms": time_ms(lambda: pshuf.count_targets(
                env8, tgt8)),
            "exchange_ms": time_ms(lambda: pshuf.exchange(env4, tgt, pairs,
                                                          flat), reps=3),
            "target_sort_uint8_ms": time_ms(lambda: torch.sort(
                tgt.to(torch.uint8), stable=True)),
            "shuffle_table_ms": time_ms(lambda: repart.shuffle_table(
                lt, ["k"]), reps=3),
            "shuffle_bytes": shuffle_bytes,
            "shuffle_bound_ms": shuffle_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": time_ms(lambda: torch.sort(tgt, stable=True)),
            "library": "torch.sort(int32 targets, stable=True)"}
    emit(xrec)
    del flat, tgt, tgt8, lt, rt, key
    torch.cuda.empty_cache()
    return routes, w4


# ---------------------------------------------------------------------------
# the sort-based groupby, the sample sort and the DataFrame entry
# ---------------------------------------------------------------------------

#: every op of the groupby, as (op, q) — median and quantile both
SMALL_OPS = (("sum", None), ("count", None), ("min", None), ("max", None),
             ("mean", None), ("var", None), ("std", None), ("sumsq", None),
             ("nunique", None), ("median", None), ("quantile", 0.25))
ASSOC_OPS = ("sum", "count", "min", "max", "mean", "var", "std", "sumsq")
#: BASELINE configuration 3: 100M rows in total
CONFIG3_ROWS = 100_000_000


def small_groupby_inputs(n: int, seed: int = 7):
    """groupby_small's host columns: a nullable int64 key (1% null) over
    50,000 values, int64 values, float64 values with 2% NaN and 1% -0.0,
    and a row id; plus a join pair whose left side carries a payload
    group column ``g``."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 50_000, n).astype(np.int64)
    kvalid = rng.random(n) > 0.01
    k[~kvalid] = 0
    f = rng.normal(size=n)
    f[rng.random(n) < 0.01] = -0.0
    f[rng.random(n) < 0.02] = np.nan
    cols = {"k": k, "kvalid": kvalid,
            "i": rng.integers(-10**6, 10**6, n).astype(np.int64), "f": f,
            "rid": np.arange(n, dtype=np.int64)}
    mv = max(int(n * 0.9), 1)
    left = {"k": rng.integers(0, mv, n).astype(np.int64),
            "g": rng.integers(0, 1000, n).astype(np.int64),
            "a": rng.integers(0, 1000, n).astype(np.int64)}
    right = {"k": rng.integers(0, mv, n // 2).astype(np.int64),
             "b": rng.integers(0, 1000, n // 2).astype(np.int64)}
    return cols, left, right, mv


def small_table(ct, cols, env):
    from cylon_tpu_torch.core.dtypes import LogicalType
    key = ct.Column(cols["k"], LogicalType.INT64, cols["kvalid"],
                    bounds=(int(cols["k"].min()), int(cols["k"].max())))
    return ct.Table.from_host_columns(
        {"k": key, **{c: ct.Column.from_numpy(cols[c])
                      for c in ("i", "f", "rid")}}, env)


def np_agg(inv, ng, v, op, q=None):
    """numpy oracle of one aggregation over group ids ``inv``: (values,
    validity or None), NaN skipped, var/std with ddof 1 (from the sum of
    squares, as the reference computes them), quantiles by linear
    interpolation."""
    m = ~np.isnan(v) if v.dtype.kind == "f" else np.ones(len(v), bool)
    g, x = inv[m], v[m]
    cnt = np.bincount(g, minlength=ng)
    if op == "count":
        return cnt.astype(np.int64), None
    xf = x.astype(np.float64)
    s = np.bincount(g, weights=xf, minlength=ng)
    if op == "sum":
        return (s.astype(np.int64) if v.dtype.kind == "i" else s), None
    if op == "sumsq":
        return np.bincount(g, weights=xf * xf, minlength=ng), None
    ok = cnt > 0
    order = np.lexsort((x, g))
    xs, gs = x[order], g[order]
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    last = max(len(xs) - 1, 0)
    if op == "min":
        return xs[np.minimum(starts, last)], ok
    if op == "max":
        return xs[np.clip(starts + cnt - 1, 0, last)], ok
    c = np.maximum(cnt, 1)
    if op == "mean":
        return s / c, ok
    if op in ("var", "std"):
        # the reference's formula, from the sums: (E[x²] - mean²)·c/(c-1)
        sq = np.bincount(g, weights=xf * xf, minlength=ng)
        var = np.maximum(sq / c - (s / c) ** 2, 0.0) * (
            c / np.maximum(cnt - 1, 1))
        return (np.sqrt(var) if op == "std" else var), cnt > 1
    if op == "nunique":
        first = np.ones(len(xs), bool)
        first[1:] = (xs[1:] != xs[:-1]) | (gs[1:] != gs[:-1])
        return np.bincount(gs[first], minlength=ng).astype(np.int64), None
    q = 0.5 if op == "median" else q
    posf = q * np.maximum(cnt - 1, 0).astype(np.float64)
    lo, hi = np.floor(posf).astype(np.int64), np.ceil(posf).astype(np.int64)
    vlo = xs[np.clip(starts + lo, 0, last)].astype(np.float64)
    vhi = xs[np.clip(starts + hi, 0, last)].astype(np.float64)
    return vlo + (vhi - vlo) * (posf - lo), ok


def small_aggs(ops=None):
    out = []
    for c in ("i", "f"):
        for op, q in SMALL_OPS:
            if ops is None or op in ops:
                out.append((c, op) if q is None else (c, op, q))
    return out


def agg_name(a) -> str:
    return f"{a[0]}_quantile_{a[2]:g}" if a[1] == "quantile" \
        else f"{a[0]}_{a[1]}"


def small_oracle(cols) -> tuple:
    """The numpy answer of every aggregation of groupby_small: the group
    keys (a null key is one group, -1 here) and per result name (values,
    validity or None, float tolerance)."""
    gid = np.where(cols["kvalid"], cols["k"], -1)
    keys, inv = np.unique(gid, return_inverse=True)
    want = {}
    for a in small_aggs():
        v = cols[a[0]]
        vals, valid = np_agg(inv, len(keys), v, a[1],
                             a[2] if len(a) > 2 else None)
        vf = v.astype(np.float64)
        scale = float(np.nansum(np.abs(vf)) + np.nansum(vf * vf))
        atol = 64 * np.finfo(np.float64).eps * scale
        # |sqrt(x) - sqrt(y)| <= sqrt(|x - y|): a std holds to the root of
        # its variance's bound
        want[agg_name(a)] = (vals, valid,
                             np.sqrt(atol) if a[1] == "std" else atol)
    return keys, want


def check_small_groupby(g, orc, aggs, label: str) -> int:
    """A groupby of groupby_small's table against the numpy oracle: the
    same groups, every result value and validity; integers exact, floats
    to rtol 1e-9 plus 64·eps·sum(|v| + v²) over the payload (its square
    root for a std): a sum comes from a prefix-sum difference, whose
    error grows with the magnitudes summed before it."""
    keys, want = orc
    host = g.host_columns()
    kd, kv = host["k"]
    pg = np.where(kv if kv is not None else True, kd, -1)
    order = stable_order(pg)
    if not np.array_equal(pg[order], keys):
        raise AssertionError(f"{label}: group keys differ from the oracle")
    for a in aggs:
        name = agg_name(a)
        vals, wvalid, atol = want[name]
        data, valid = host[name]
        data = data[order]
        ok = np.ones(len(keys), bool) if wvalid is None else wvalid
        if (valid is None) != (wvalid is None) or (
                valid is not None and not np.array_equal(valid[order], ok)):
            raise AssertionError(f"{label}: {name} validity differs")
        if data.dtype.kind == "f":
            good = np.allclose(data[ok], vals[ok], rtol=1e-9, atol=atol)
        else:
            good = np.array_equal(data[ok], vals[ok])
        if not good:
            raise AssertionError(f"{label}: {name} differs from the oracle")
    return len(keys)


def sort_order_oracle(cols, descending: bool, nulls_first: bool):
    """The rows' order after sort_table(["k", "f"]): the stable global
    order, null keys first or last, -0.0 equal to 0.0, NaN after every
    number in either direction."""
    k, f = cols["k"], cols["f"]
    sign = -1 if descending else 1
    kflag = np.where(cols["kvalid"], 1, 0 if nulls_first else 2)
    kval = np.where(cols["kvalid"], sign * k, 0)
    nan = np.isnan(f)
    fval = np.where(nan, 0.0, sign * f) + 0.0     # -0.0 -> 0.0
    return np.lexsort((fval, nan, kval, kflag))


def check_sorted(out, order, label: str):
    """sort_table's output holds the rows in the oracle's ``order``, shard
    after shard, and says so (``grouped_by``)."""
    rid = out.host_columns()["rid"][0]
    if not np.array_equal(rid, order):
        raise AssertionError(f"{label}: rows out of order")
    if out.grouped_by != ("k", "f"):
        raise AssertionError(f"{label}: grouped_by {out.grouped_by}")


def np_sink_oracle(left, right, mv):
    """pipelined inner join -> groupby on the left payload ``g``: per g,
    sum of a·R[k] and of SB[k] (R: right rows per key, SB: their b sum)."""
    R = np.bincount(right["k"], minlength=mv)
    SB = np.bincount(right["k"], right["b"], minlength=mv).astype(np.int64)
    r = R[left["k"]]
    keep = r > 0
    ng = int(left["g"].max()) + 1
    a_sum = np.bincount(left["g"], left["a"] * r, minlength=ng)
    b_sum = np.bincount(left["g"], SB[left["k"]], minlength=ng)
    gs = np.nonzero(np.bincount(left["g"][keep], minlength=ng))[0]
    return gs, a_sum[gs].astype(np.int64), b_sum[gs].astype(np.int64)


def groupby_small(ct, worlds=(1, 3, 4, 8), n: int = 1_000_000,
                  device=None) -> dict:
    """The sort-based groupby, the sample sort and the non-disjoint sink
    at ``n`` rows, world by world, each against its numpy oracle."""
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.relational import groupby as rgb
    cols, left, right, mv = small_groupby_inputs(n)
    orc = small_oracle(cols)
    sink_orc = np_sink_oracle(left, right, mv)
    variants = (("initial", False, False), ("initial", True, True),
                ("regular", False, True), ("regular", True, False))
    orders = {(d, f): sort_order_oracle(cols, d, f)
              for _, d, f in variants}
    recs = {}
    for w in worlds:
        t0 = time.perf_counter()
        env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
        t = small_table(ct, cols, env)
        rgb.reset_counts()
        every = small_aggs()
        groups = check_small_groupby(ct.groupby_aggregate(t, "k", every),
                                     orc, every, f"groupby_small W={w} raw")
        assoc = small_aggs(ASSOC_OPS)
        check_small_groupby(ct.groupby_aggregate(t, "k", assoc), orc,
                            assoc, f"groupby_small W={w} "
                            f"{'combine' if w > 1 else 'raw'} route")
        sorts = []
        for method, desc, nfirst in variants:
            s = ct.sort_table(t, ["k", "f"], ascending=not desc,
                              nulls_position="first" if nfirst else "last",
                              method=method)
            check_sorted(s, orders[(desc, nfirst)],
                         f"groupby_small W={w} sort {method} "
                         f"desc={desc} nulls_first={nfirst}")
            sorts.append(f"{method}/{'desc' if desc else 'asc'}/"
                         f"nulls_{'first' if nfirst else 'last'}")
        # a groupby on the sorted table takes the grouped fast path
        s = ct.sort_table(t, "k")
        check_small_groupby(ct.groupby_aggregate(s, "k", every), orc, every,
                            f"groupby_small W={w} grouped fast path")
        dispatches = dict(rgb.COUNTS)
        # pipelined join into a GroupBySink keyed on the payload column:
        # groups span pieces, so the partials combine (non-disjoint)
        lt = ct.Table.from_pydict(left, env)
        rt = ct.Table.from_pydict(right, env)
        sink = ct.GroupBySink("g", [("a", "sum"), ("b", "sum")])
        ct.pipelined_join(lt, rt, "k", "k", how="inner", n_chunks=2,
                          sink=sink)
        if sink._disjoint:
            raise AssertionError("groupby_small: a sink on g took the "
                                 "disjoint combine")
        out = sink.finalize().to_pydict()
        o = stable_order(out["g"])
        for name, want in zip(("g", "a_sum", "b_sum"), sink_orc):
            if not np.array_equal(out[name][o], want):
                raise AssertionError(f"groupby_small W={w}: sink column "
                                     f"{name} differs from the oracle")
        recs[w] = {"groups": groups, "sorts": sorts,
                   "groupby_dispatches": dispatches,
                   "sink_groups": len(sink_orc[0]),
                   "seconds": time.perf_counter() - t0}
        del t, s, lt, rt, sink, env
    return recs


def config3_inputs(n: int, seed: int = 42):
    """bench.py's generator and draw order: k, then a, both uniform int64
    in [0, 0.9 n)."""
    rng = np.random.default_rng(seed)
    mv = max(int(n * 0.9), 1)
    k = rng.integers(0, mv, n).astype(np.int64)
    a = rng.integers(0, mv, n).astype(np.int64)
    return k, a, mv


def config3_oracle(k, a, mv):
    """groupby-sum oracle: per key in [0, mv), whether it occurs and its
    sum — int64 on the card, numpy's float64 bincount on the host (every
    sum stays below 2^53, so exact)."""
    if torch.cuda.is_available():
        # int64 sums on the card (numpy's two bincounts took seconds)
        kt = torch.from_numpy(k).cuda()
        cnt = torch.bincount(kt, minlength=mv)
        tot = torch.zeros(mv, dtype=torch.int64, device=kt.device)
        tot.index_add_(0, kt, torch.from_numpy(a).cuda())
        return (cnt > 0).cpu().numpy(), tot.cpu().numpy()
    cnt = np.bincount(k, minlength=mv)
    s = np.bincount(k, a, minlength=mv)
    if s.max() >= 2.0 ** 53:
        raise AssertionError("oracle sums leave the exact float64 range")
    return cnt > 0, s.astype(np.int64)


def check_config3(out, orc, label: str) -> int:
    """The query's output against the oracle: the multiset of (k, a)
    rows equals numpy's groupby-sum, each key once, and a non-increasing
    over the shard-major live rows."""
    present, sums = orc
    host = out.table.host_columns()
    k, a = host["k"][0], host["a"][0]
    seen = key_counts(k, len(present))
    if len(seen) != len(present) or not np.array_equal(seen, present):
        raise AssertionError(f"{label}: keys differ from the oracle or "
                             "repeat")
    at = np.zeros(len(present), np.int64)
    at[k] = a
    if not np.array_equal(at[present], sums[present]):
        raise AssertionError(f"{label}: sums differ from the oracle")
    if len(a) > 1 and not bool(np.all(np.diff(a) <= 0)):
        raise AssertionError(f"{label}: a is not non-increasing")
    return len(k)


def config3_query(df, times=None):
    """BASELINE configuration 3 through the DataFrame entry."""
    t0 = time.perf_counter()
    out = df.groupby("k")[["a"]].sum().sort_values("a", ascending=False)
    sync_pull(out.table.column("a").data)
    if times is not None:
        times.append(time.perf_counter() - t0)
    return out


#: configuration 3's phases and the timing regions that hold them
CONFIG3_PHASES = {"combine": "groupby.combine",
                  "intermediates_shuffle": "groupby.shuffle",
                  "final": "groupby.final", "raw_groupby": "groupby.raw",
                  "sample": "sort.sample", "range_exchange": "sort.exchange",
                  "local_sort": "sort.local"}


def config3_path(ct, k, a, orc, w: int, device=None,
                 profile: bool = True) -> dict:
    """BASELINE configuration 3 at world size ``w``: warm-up, best of 3,
    the phase split (one more iteration with a device wait after each
    phase), one profiled iteration; K1 and K2 launches counted over the
    timed run (both expected 0: no TPU kernel lies on this path)."""
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    from cylon_tpu_torch.relational import groupby as rgb
    from cylon_tpu_torch.utils import timing
    n = len(k)
    env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    df = ct.DataFrame({"k": k, "a": a}, env=env)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    wg.reset_counts()
    sp.reset_counts()
    rgb.reset_counts()
    first = []
    out = config3_query(df, first)             # warm-up (first sight)
    warm = dict(rgb.COUNTS)
    rgb.reset_counts()
    times = []
    for _ in range(3):
        out = config3_query(df, times)
    counts = {"windowed_gather": dict(wg.COUNTS),
              "splitter_probe": dict(sp.COUNTS),
              "groupby_warmup": warm, "groupby_timed": dict(rgb.COUNTS)}
    peak = torch.cuda.max_memory_allocated()
    groups = check_config3(out, orc, f"config3_path W={w}")
    del out
    if counts["windowed_gather"]["launches"] or \
            counts["splitter_probe"]["launches"]:
        raise AssertionError(f"config3_path W={w}: kernel counts {counts}; "
                             "no TPU kernel lies on this path")
    if counts["groupby_timed"]["redispatches"]:
        raise AssertionError(f"config3_path W={w}: the timed iterations "
                             f"redispatched: {counts}")
    timing.enable("block")
    timing.reset()
    t0 = time.perf_counter()
    out = config3_query(df)
    split_total = time.perf_counter() - t0
    phases = timing.snapshot()
    timing.enable(None)
    check_config3(out, orc, f"config3_path W={w} split")
    del out
    best = min(times)
    rec = {"phase": "config3_path", "world": w, "rows": n,
           "rows_per_rank": -(-n // w), "groups": groups,
           "query": 'DataFrame({"k", "a"}).groupby("k")[["a"]].sum()'
                    '.sort_values("a", ascending=False)',
           "setup_s": setup_s, "first_s": first[0], "iterations": times,
           "best_s": best, "rows_per_s": n / best, "peak_mem_bytes": peak,
           "oracle": "equal", "kernel_counts": counts,
           "phase_split_s": {p: phases[r] for p, r in CONFIG3_PHASES.items()
                             if r in phases},
           "phase_split_regions_s": phases,
           "phase_split_total_s": split_total}
    if profile:
        prof = profile_step(ct, df, None, top=14,
                            step_fn=lambda c, d, _: config3_query(d))
        rec["profile"] = {
            "device_busy_s": prof["device_busy_s"],
            "device_idle_share_of_best": 1.0 - prof["device_busy_s"] / best,
            "kernels_ms": prof["kernels_ms"],
            "aten_ops_ms": prof["aten_ops_ms"]}
    del df, env
    torch.cuda.empty_cache()
    return rec


def exchange_gather_forms(dev, rows: int = 15_728_640, seed: int = 5) -> dict:
    """The exchange's per-destination row gather (``torch.index_select``
    into a preallocated block, parallel/shuffle.exchange) on a ``(rows, 4)``
    int32 lane matrix — two int64 columns without bounds, as the
    configuration-3 tables carry — at a random permutation, beside other
    forms of the same gather: advanced indexing, four 1-D lane gathers, the
    matrix viewed as ``(rows, 2)`` int64, and a 2-lane matrix (8-byte rows,
    the BASELINE tables' narrow keys).  CUDA-event means; every form must
    give the same rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mat = torch.randint(-(1 << 31), (1 << 31) - 1, (rows, 4),
                        dtype=torch.int32, device=dev, generator=gen)
    idx = torch.randperm(rows, device=dev, generator=gen)
    out = torch.empty_like(mat)
    lanes = [mat[:, j].contiguous() for j in range(4)]
    wide = mat.view(torch.int64)
    narrow = mat[:, :2].contiguous()
    torch.index_select(mat, 0, idx, out=out)
    if not (torch.equal(out, mat[idx]) and torch.equal(
            out.view(torch.int64), torch.index_select(wide, 0, idx))
            and all(torch.equal(out[:, j], torch.index_select(lane, 0, idx))
                    for j, lane in enumerate(lanes))):
        raise AssertionError("exchange_gather: the gather forms differ")
    nbytes = 8 + 2 * 16 * rows + 8 * rows     # rows read and written, idx
    rec = {"phase": "exchange_gather", "rows": rows, "lanes": 4,
           "index_select_out_ms": time_ms(
               lambda: torch.index_select(mat, 0, idx, out=out)),
           "advanced_index_ms": time_ms(lambda: mat[idx]),
           "per_lane_index_select_ms": time_ms(
               lambda: [torch.index_select(x, 0, idx) for x in lanes]),
           "int64_view_index_select_ms": time_ms(
               lambda: torch.index_select(wide, 0, idx)),
           "two_lane_index_select_ms": time_ms(
               lambda: torch.index_select(narrow, 0, idx)),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes"}
    del mat, idx, out, lanes, wide, narrow
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# the join types, the broadcast route and the N-way join
# ---------------------------------------------------------------------------

JOIN_HOWS = ("inner", "left", "right", "outer")
#: the materializing join's phases and the timing regions that hold them
JOIN_PHASES = {"shuffle": "join.shuffle", "sort_count": "join.sort_count",
               "materialize": "join.materialize"}


def how_oracle(lk, a, rk, b, n_keys: int, how: str) -> dict:
    """The ``how`` join of {k: lk, a} with {k: rk, b}, per key id in
    [0, n_keys): its output rows, and over the valid payloads the sum and
    count of ``a`` and of ``b`` (int64).  A matched key gives L·R rows;
    an unmatched left (right) key gives L (R) rows with a null ``b``
    (``a``) where the join type keeps it.  The payloads are non-negative
    and each key's sums (sa·R, sb·L) stay below 2^53 (both checked, key
    by key), so these float64 bincounts and :func:`check_join`'s are
    exact.  From ``HOW_ORACLE_CARD_ROWS`` rows a side the four per-key
    reductions run on the card (:func:`how_oracle_card`)."""
    if torch.cuda.is_available() \
            and min(len(lk), len(rk)) >= HOW_ORACLE_CARD_ROWS:
        return how_oracle_card(lk, a, rk, b, n_keys, how,
                               torch.device("cuda"))
    L = np.bincount(lk, minlength=n_keys)
    R = np.bincount(rk, minlength=n_keys)
    sa = np.bincount(lk, a, minlength=n_keys)
    sb = np.bincount(rk, b, minlength=n_keys)
    if min(np.min(a, initial=0), np.min(b, initial=0)) < 0 \
            or max((sa * np.maximum(R, 1)).max(initial=0),
                   (sb * np.maximum(L, 1)).max(initial=0)) >= 2.0 ** 53:
        raise AssertionError("oracle sums leave the exact range")
    SA, SB = sa.astype(np.int64), sb.astype(np.int64)
    both = (L > 0) & (R > 0)
    lonly = (L > 0) & (R == 0) & (how in ("left", "outer"))
    ronly = (L == 0) & (R > 0) & (how in ("right", "outer"))
    LR = np.where(both, L * R, 0)
    return {"rows": LR + np.where(lonly, L, 0) + np.where(ronly, R, 0),
            "sa": np.where(both, SA * R, 0) + np.where(lonly, SA, 0),
            "ca": LR + np.where(lonly, L, 0),
            "sb": np.where(both, SB * L, 0) + np.where(ronly, SB, 0),
            "cb": LR + np.where(ronly, R, 0)}


#: the rows a side from which :func:`how_oracle` counts on the card (its
#: numpy bincounts take ≈ 10 s a call at 125M rows)
HOW_ORACLE_CARD_ROWS = 16_000_000


def how_oracle_card(lk, a, rk, b, n_keys: int, how: str, dev) -> dict:
    """:func:`how_oracle` with the per-key counts and sums as int64
    ``bincount``/``index_add_`` on ``dev`` (exact integers, as the float64
    bincounts are below 2^53), the per-key formulas there too, pulled to
    numpy.  Held equal to the numpy version at 1M rows each run
    (:func:`check_how_oracle_card`)."""
    def per_key(k, v):
        kt = torch.from_numpy(np.ascontiguousarray(k)).to(dev)
        cnt = torch.bincount(kt, minlength=n_keys)
        tot = torch.zeros(n_keys, dtype=torch.int64, device=dev).index_add_(
            0, kt, torch.from_numpy(np.ascontiguousarray(v)).to(dev))
        return cnt, tot

    if min(np.min(a, initial=0), np.min(b, initial=0)) < 0:
        raise AssertionError("oracle payloads must be non-negative")
    L, SA = per_key(lk, a)
    R, SB = per_key(rk, b)
    if max(float((SA.double() * R.clamp_min(1).double()).max()),
           float((SB.double() * L.clamp_min(1).double()).max())) >= 2.0**53:
        raise AssertionError("oracle sums leave the exact range")
    both = (L > 0) & (R > 0)
    lonly = (L > 0) & (R == 0) & (how in ("left", "outer"))
    ronly = (L == 0) & (R > 0) & (how in ("right", "outer"))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    LR = torch.where(both, L * R, zero)
    out = {"rows": LR + torch.where(lonly, L, zero)
           + torch.where(ronly, R, zero),
           "sa": torch.where(both, SA * R, zero)
           + torch.where(lonly, SA, zero),
           "ca": LR + torch.where(lonly, L, zero),
           "sb": torch.where(both, SB * L, zero)
           + torch.where(ronly, SB, zero),
           "cb": LR + torch.where(ronly, R, zero)}
    return {name: t.cpu().numpy() for name, t in out.items()}


def check_how_oracle_card(dev, n: int = 1_000_000) -> None:
    """:func:`how_oracle_card` equal to the numpy oracle for every join
    type on bench.py's tables at ``n`` rows a side."""
    left, right, mv = baseline_inputs(n, seed=3)
    for how in JOIN_HOWS:
        host = how_oracle(left["k"], left["a"], right["k"], right["b"], mv,
                          how)
        card = how_oracle_card(left["k"], left["a"], right["k"],
                               right["b"], mv, how, dev)
        if any(not np.array_equal(host[f], card[f]) for f in host):
            raise AssertionError(f"how_oracle_card({how}) differs from "
                                 "numpy's")


def key_ids(host, n_keys: int, second=None) -> np.ndarray:
    """Key id of each output row: ``k`` (a null key the last id), or
    ``k·4 + second`` for the two-column key."""
    k, kv = host["k"]
    if second is not None:
        k = k * 4 + host[second][0]
    return k if kv is None else np.where(kv, k, n_keys - 1)


def check_join(out, orc, label: str, second=None, kid=None) -> int:
    """A join's output rows against :func:`how_oracle`: per key, the rows
    and the sums and counts of the valid payloads.  ``kid``: the output
    rows' key ids when the key is not an integer column (a float or a
    string key mapped back to its id)."""
    host = out.host_columns()
    n_keys = len(orc["rows"])
    if kid is None:
        kid = key_ids(host, n_keys, second)
    got = {"rows": np.bincount(kid, minlength=n_keys)}
    for col, s, c in (("a", "sa", "ca"), ("b", "sb", "cb")):
        d, v = host[col]
        v = np.ones(len(d), bool) if v is None else v
        got[s] = np.bincount(kid[v], d[v], minlength=n_keys).astype(np.int64)
        got[c] = np.bincount(kid[v], minlength=n_keys)
    for name, want in orc.items():
        if not np.array_equal(got[name], want):
            raise AssertionError(f"{label}: per-key {name} differs from the "
                                 "numpy oracle")
    return int(orc["rows"].sum())


def check_join_sums(g, orc, label: str, names=("a_sum", "b_sum")) -> int:
    """A join→groupby-sum on the key against :func:`how_oracle`: one row
    per key the join emits, sums over the valid payloads (an all-null
    group sums to 0, a valid 0, as the reference sums it)."""
    host = g.host_columns()
    k = host["k"][0]
    order = stable_order(k)
    if not np.array_equal(k[order], np.nonzero(orc["rows"] > 0)[0]):
        raise AssertionError(f"{label}: group keys differ from the oracle")
    for name, want in zip(names, ("sa", "sb")):
        d, v = host[name]
        if v is not None and not v.all():
            raise AssertionError(f"{label}: {name} has null groups")
        if not np.array_equal(d[order], orc[want][orc["rows"] > 0]):
            raise AssertionError(f"{label}: {name} differs from the oracle")
    return len(k)


def check_semi(out, match, lk, how: str, label: str) -> int:
    """A semi/anti join's output: exactly the left rows (by row id ``i``)
    whose key has (has no) match, each shard's rows in source order (the
    exchange keeps (source rank, source position) order)."""
    i = out.host_columns()["i"][0]
    want = np.nonzero(match[lk] == (how == "semi"))[0]
    if not np.array_equal(np.sort(i), want):
        raise AssertionError(f"{label}: rows differ from np.isin's")
    bounds = np.concatenate([[0], np.cumsum(out.valid_counts)])
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi - lo > 1 and not bool(np.all(np.diff(i[lo:hi]) > 0)):
            raise AssertionError(f"{label}: a shard's rows out of order")
    return len(i)


def joins_small_inputs(n: int, seed: int = 11) -> dict:
    """joins_small's host columns: bench.py-like keys uniform in
    [0, 0.9 n) on both sides with int64 payloads and a left row id;
    validity masks (1% null) for the nullable-key case; a second key
    column in [0, 4); a left key column where one key holds 40% of the
    rows; a 1,000-row side for the broadcast route; a third table (n/4
    rows) for the N-way join; and unsigned columns for the repairs."""
    rng = np.random.default_rng(seed)
    mv = max(int(n * 0.9), 1)
    d = {"mv": mv, "lk": rng.integers(0, mv, n), "a": rng.integers(0, mv, n),
         "rk": rng.integers(0, mv, n), "b": rng.integers(0, mv, n),
         "lvalid": rng.random(n) > 0.01, "rvalid": rng.random(n) > 0.01,
         "lc": rng.integers(0, 4, n), "rc": rng.integers(0, 4, n),
         "sk": rng.integers(0, mv, 1000), "sv": rng.integers(0, mv, 1000),
         "ck": rng.integers(0, mv, n // 4), "cv": rng.integers(0, mv, n // 4),
         "g": rng.integers(0, 50, n)}
    skew = d["lk"].copy()
    skew[rng.random(n) < 0.4] = 7
    d["lk_skew"] = skew
    for bits in (16, 32, 64):
        top = (1 << bits) - 1
        u = rng.integers(0, top, n, dtype=np.uint64, endpoint=True)
        u[:2] = (0, top)
        d[f"u{bits}"] = u.astype(f"uint{bits}")
    d["uvalid"] = d["g"] != 7            # group 7: every value null
    return d


def joins_small_world(ct, d: dict, w: int, device=None) -> dict:
    """Every check of joins_small at world size ``w`` (module docstring);
    returns the counts of what ran."""
    from cylon_tpu_torch.core.dtypes import LogicalType
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.parallel import shuffle as pshuf
    from cylon_tpu_torch.utils import timing
    env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
    n, mv = len(d["lk"]), d["mv"]
    rid = np.arange(n, dtype=np.int64)
    lt = ct.Table.from_pydict({"k": d["lk"], "a": d["a"], "i": rid}, env)
    rt = ct.Table.from_pydict({"k": d["rk"], "b": d["b"]}, env)
    rec = {"world": w}
    orcs = {how: how_oracle(d["lk"], d["a"], d["rk"], d["b"], mv, how)
            for how in JOIN_HOWS}
    for how in JOIN_HOWS:
        check_join(ct.join_tables(lt, rt, "k", "k", how=how), orcs[how],
                   f"joins_small W={w} {how}")
    match = np.bincount(d["rk"], minlength=mv) > 0
    for how in ("semi", "anti"):
        check_semi(ct.join_tables(lt, rt, "k", "k", how=how), match,
                   d["lk"], how, f"joins_small W={w} {how}")
    for how in ("left", "right", "outer"):
        check_join(ct.pipelined_join(lt, rt, "k", "k", how=how, n_chunks=3),
                   orcs[how], f"joins_small W={w} pipelined {how}")
        sink = ct.GroupBySink("k", [("a", "sum"), ("b", "sum")])
        ct.pipelined_join(lt, rt, "k", "k", how=how, n_chunks=3, sink=sink)
        check_join_sums(sink.finalize(), orcs[how],
                        f"joins_small W={w} pipelined {how} sink")
    rec["hows"] = list(JOIN_HOWS) + ["semi", "anti"]
    rec["pipelined_hows"] = ["left", "right", "outer"]

    # a nullable key (null matches null) and a two-column key
    def keyed(k, valid, **cols):
        key = ct.Column(k, LogicalType.INT64, valid,
                        bounds=(int(k.min()), int(k.max())))
        return ct.Table.from_host_columns(
            {"k": key, **{c: ct.Column.from_numpy(v)
                          for c, v in cols.items()}}, env)
    ltn = keyed(d["lk"], d["lvalid"], a=d["a"])
    rtn = keyed(d["rk"], d["rvalid"], b=d["b"])
    lkn = np.where(d["lvalid"], d["lk"], mv)
    rkn = np.where(d["rvalid"], d["rk"], mv)
    for how in ("inner", "outer"):
        check_join(ct.join_tables(ltn, rtn, "k", "k", how=how),
                   how_oracle(lkn, d["a"], rkn, d["b"], mv + 1, how),
                   f"joins_small W={w} nullable key {how}")
    lt2 = ct.Table.from_pydict({"k": d["lk"], "c": d["lc"], "a": d["a"]},
                               env)
    rt2 = ct.Table.from_pydict({"k": d["rk"], "c": d["rc"], "b": d["b"]},
                               env)
    for how in ("inner", "left"):
        check_join(ct.join_tables(lt2, rt2, ["k", "c"], ["k", "c"], how=how),
                   how_oracle(d["lk"] * 4 + d["lc"], d["a"],
                              d["rk"] * 4 + d["rc"], d["b"], mv * 4, how),
                   f"joins_small W={w} two-column key {how}", second="c")
    del ltn, rtn, lt2, rt2

    # the broadcast route: a 1,000-row side against n rows
    small_r = ct.Table.from_pydict({"k": d["sk"], "b": d["sv"]}, env)
    small_l = ct.Table.from_pydict({"k": d["sk"], "a": d["sv"]}, env)
    smatch = np.bincount(d["sk"], minlength=mv) > 0
    routes = []
    for lhs, rhs, how in [(lt, small_r, h) for h in ("inner", "left", "semi",
                                                      "anti")] \
            + [(small_l, rt, h) for h in ("inner", "right")]:
        timing.reset()
        out = ct.join_tables(lhs, rhs, "k", "k", how=how)
        label = f"joins_small W={w} broadcast {how}"
        if how in ("semi", "anti"):
            check_semi(out, smatch, d["lk"], how, label)
        elif lhs is lt:
            check_join(out, how_oracle(d["lk"], d["a"], d["sk"], d["sv"], mv,
                                       how), label)
        else:
            check_join(out, how_oracle(d["sk"], d["sv"], d["rk"], d["b"], mv,
                                       how), label)
        taken = timing.counts().get("join.broadcast", 0)
        if taken != int(w > 1) or (w > 1 and out.grouped_by is not None):
            raise AssertionError(f"{label}: route taken {taken} times, "
                                 f"grouped_by {out.grouped_by}")
        routes.append(f"{'right' if lhs is lt else 'left'}-{how}")
    rec["broadcast"] = routes

    # semi and anti on a probe side where one key holds 40% of the rows
    lts = ct.Table.from_pydict({"k": d["lk_skew"], "a": d["a"], "i": rid},
                               env)
    spread = []
    orig = pshuf.skew_targets
    pshuf.skew_targets = lambda *x: spread.append(1) or orig(*x)
    try:
        for how in ("semi", "anti"):
            check_semi(ct.join_tables(lts, rt, "k", "k", how=how), match,
                       d["lk_skew"], how, f"joins_small W={w} skewed {how}")
    finally:
        pshuf.skew_targets = orig
    if len(spread) != (2 if w > 1 else 0):
        raise AssertionError(f"joins_small W={w}: the semi/anti spread ran "
                             f"{len(spread)} times")
    rec["skewed_semi_anti_spread"] = len(spread)
    del lts, small_l, small_r

    # the N-way join of three tables
    ct3 = ct.Table.from_pydict({"k": d["ck"], "c": d["cv"]}, env)
    L = np.bincount(d["lk"], minlength=mv)
    R = np.bincount(d["rk"], minlength=mv)
    C = np.bincount(d["ck"], minlength=mv)
    SA = np.bincount(d["lk"], d["a"], minlength=mv).astype(np.int64)
    SC = np.bincount(d["ck"], d["cv"], minlength=mv).astype(np.int64)
    for how in ("inner", "left"):
        out = ct.join_tables_multi([lt, rt, ct3], ["k", "k", "k"], how=how)
        r1, c1 = (R, C) if how == "inner" else (np.maximum(R, 1),
                                                np.maximum(C, 1))
        host = out.host_columns()
        k = host["k"][0]
        cd, cv = host["c"]
        cv = np.ones(len(cd), bool) if cv is None else cv
        for name, got, want in (
                ("rows", np.bincount(k, minlength=mv), L * r1 * c1),
                ("a", np.bincount(k, host["a"][0], minlength=mv),
                 SA * r1 * c1),
                ("c", np.bincount(k[cv], cd[cv], minlength=mv),
                 SC * L * r1)):
            if not np.array_equal(got.astype(np.int64), want):
                raise AssertionError(f"joins_small W={w} join_tables_multi "
                                     f"{how}: {name} differs")
        if out.grouped_by is not None:
            raise AssertionError("join_tables_multi: grouped_by is set")
    rec["multi"] = ["inner", "left"]
    del ct3

    # the repairs: unsigned min/max and descending sort, an empty side,
    # a zero-capacity groupby
    ucols = {"g": ct.Column.from_numpy(d["g"])}
    for bits in (16, 32, 64):
        u = d[f"u{bits}"]
        ucols[f"u{bits}"] = ct.Column(u, LogicalType(f"uint{bits}"),
                                      d["uvalid"])
    ut = ct.Table.from_host_columns(ucols, env)
    aggs = [(f"u{bits}", op) for bits in (16, 32, 64)
            for op in ("min", "max")]
    host = ct.groupby_aggregate(ut, "g", aggs).host_columns()
    order = stable_order(host["g"][0])
    gv = d["g"][d["uvalid"]]
    for col, op in aggs:
        u = d[col]
        # an all-null group holds the reduction's identity
        want = np.full(50, np.iinfo(u.dtype).max if op == "min" else 0,
                       u.dtype)
        (np.minimum if op == "min" else np.maximum).at(want, gv,
                                                       u[d["uvalid"]])
        data, valid = host[f"{col}_{op}"]
        if not (np.array_equal(data[order], want)
                and np.array_equal(valid[order], np.arange(50) != 7)):
            raise AssertionError(f"joins_small W={w}: unsigned {op} of "
                                 f"{col} differs")
    nv = int(d["uvalid"].sum())
    for bits in (16, 32, 64):
        # the values descending, then the nulls (nulls_position "last")
        got, gv = ct.sort_table(ut, f"u{bits}", ascending=False) \
            .host_columns()[f"u{bits}"]
        want = np.sort(d[f"u{bits}"][d["uvalid"]])[::-1]
        if not (np.array_equal(got[:nv], want) and gv[:nv].all()
                and not gv[nv:].any()):
            raise AssertionError(f"joins_small W={w}: descending sort of "
                                 f"u{bits} differs")
    del ut
    empty = ct.Table.from_pydict({"k": np.zeros(0, np.int64),
                                  "a": np.zeros(0, np.int64)}, env)
    for how, rows in (("inner", 0), ("right", n)):
        out = ct.join_tables(empty, rt, "k", "k", how=how)
        if out.row_count != rows or (w > 1) != (out.grouped_by is None):
            raise AssertionError(f"joins_small W={w}: empty-side {how} join "
                                 f"rows {out.row_count}, grouped_by "
                                 f"{out.grouped_by}")
    g0 = ct.groupby_aggregate(empty, "k", [("a", "sum"), ("a", "min")])
    if g0.row_count or g0.column_names != ["k", "a_sum", "a_min"]:
        raise AssertionError(f"joins_small W={w}: empty groupby "
                             f"{g0.column_names}, {g0.row_count} rows")
    rec["repairs"] = ["unsigned min/max", "unsigned descending sort",
                      "empty side", f"capacity-{empty.capacity} groupby"]
    return rec


def joins_small(ct, worlds=(1, 3, 4, 8), n: int = 1_000_000,
                device=None) -> list:
    """Every join type, route and repair of the slice at ``n`` rows per
    side, world by world, each against its numpy oracle."""
    d = joins_small_inputs(n)
    recs = []
    for w in worlds:
        t0 = time.perf_counter()
        rec = joins_small_world(ct, d, w, device)
        rec["seconds"] = time.perf_counter() - t0
        recs.append(rec)
    return recs


def timed_path(label: str, query, check, phase_names: dict,
               profile: bool = True) -> dict:
    """Warm-up, best of 3, the peak memory, K1 and K2 launches over the
    warm-up and the timed runs, the phase split (one more run with a
    device wait after each timing region) and one profiled run: the
    record of a full-size phase.  ``query(times)`` runs the phase's query
    once (appending its seconds) and returns its result; ``check``
    holds a result to the oracle and returns its group count."""
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    from cylon_tpu_torch.utils import timing
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wg.reset_counts()
    sp.reset_counts()
    first, times = [], []
    out = query(first)                          # warm-up (first sight)
    for _ in range(3):
        out = query(times)
    counts = {"windowed_gather": dict(wg.COUNTS),
              "splitter_probe": dict(sp.COUNTS)}
    peak = torch.cuda.max_memory_allocated()
    groups = check(out, label)
    del out
    timing.enable("block")
    timing.reset()
    split = []
    out = query(split)
    phases = timing.snapshot()
    timing.enable(None)
    check(out, f"{label} split")
    del out
    split_total = split[0]
    best = min(times)
    split = {p: phases[r] for p, r in phase_names.items() if r in phases}
    split["rest"] = split_total - sum(split.values())
    rec = {"first_s": first[0], "iterations": times, "best_s": best,
           "peak_mem_bytes": peak, "groups": groups, "oracle": "equal",
           "kernel_counts": counts, "phase_split_s": split,
           "phase_split_regions_s": phases,
           "phase_split_total_s": split_total}
    if profile:
        torch.cuda.empty_cache()
        prof = profile_step(None, None, None, top=12,
                            step_fn=lambda *_: query([]))
        rec["profile"] = {
            "device_busy_s": prof["device_busy_s"],
            "device_idle_share_of_best": 1.0 - prof["device_busy_s"] / best,
            "kernels_ms": prof["kernels_ms"],
            "aten_ops_ms": prof["aten_ops_ms"]}
    return rec


def frame_query(lhs, rhs, how: str):
    """``lhs.merge(rhs, on="k", how=how).groupby("k").sum()``, waited on;
    appends its seconds to ``times``."""
    def run(times):
        t0 = time.perf_counter()
        out = lhs.merge(rhs, on="k", how=how).groupby("k").sum()
        sync_pull(out.table.column("k").data)
        times.append(time.perf_counter() - t0)
        return out
    return run


def left_join_path(ct, left, right, mv: int, device=None) -> dict:
    """The BASELINE tables at W = 4 through ``DataFrame(left).merge(
    DataFrame(right), on="k", how="left").groupby("k").sum()``."""
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    n = len(left["k"])
    orc = how_oracle(left["k"], left["a"], right["k"], right["b"], mv,
                     "left")
    env = ct.CylonEnv(VirtualMeshConfig(4), device=device)
    t0 = time.perf_counter()
    lhs = ct.DataFrame(left, env=env)
    rhs = ct.DataFrame(right, env=env)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rec = timed_path(
        "left_join_path", frame_query(lhs, rhs, "left"),
        lambda out, label: check_join_sums(out.table, orc, label,
                                           ("a", "b")),
        {**JOIN_PHASES, "groupby": "groupby.raw"})
    del lhs, rhs, env
    rec.update({"phase": "left_join_path", "world": 4, "rows_per_side": n,
                "join_rows": int(orc["rows"].sum()),
                "query": 'DataFrame(left).merge(DataFrame(right), on="k", '
                         'how="left").groupby("k").sum()',
                "setup_s": setup_s, "rows_per_s": 2 * n / rec["best_s"]})
    if any(v["launches"] for v in rec["kernel_counts"].values()):
        raise AssertionError(f"left_join_path: kernel counts "
                             f"{rec['kernel_counts']}; a left join defers "
                             "nothing, so neither kernel runs")
    return rec


def outer_pipelined_path(ct, left, right, mv: int, device=None) -> dict:
    """The BASELINE tables at W = 4 through ``pipelined_join(how="outer",
    n_chunks=2)`` into a ``GroupBySink`` on ``k``: K2 once per shard per
    iteration, held bit-equal to its plain version on shard 0's inputs."""
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.ops import splitter_probe as sp
    w, n = 4, len(left["k"])
    orc = how_oracle(left["k"], left["a"], right["k"], right["b"], mv,
                     "outer")
    env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
    t0 = time.perf_counter()
    lt, rt = ct.Table.from_pydict(left, env), ct.Table.from_pydict(right,
                                                                   env)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def query(times):
        t0 = time.perf_counter()
        sink = ct.GroupBySink("k", [("a", "sum"), ("b", "sum")])
        ct.pipelined_join(lt, rt, "k", "k", how="outer", n_chunks=2,
                          sink=sink)
        g = sink.finalize()
        sync_pull(g.column("k").data)
        times.append(time.perf_counter() - t0)
        return g

    rec = timed_path("outer_pipelined_path", query,
                     lambda g, label: check_join_sums(g, orc, label),
                     {"shuffle": "join.shuffle",
                      "build_sort": "pipe.build_sort",
                      "bounds": "pipe.bounds", "targets": "pipe.targets",
                      "probe_sort": "pipe.probe_sort",
                      "phase_sync": "pipe.phase_sync", "pack": "pipe.pack",
                      "piece_join": "pipe.piece_join",
                      "consume": "pipe.consume"})
    k2 = rec["kernel_counts"]["splitter_probe"]["launches"]
    if k2 != 4 * w:
        raise AssertionError(f"outer_pipelined_path: K2 launched {k2} "
                             f"times, expected {w} per iteration")
    captured = {}
    with capturing(sp, "count_ge_splitters", captured, "probe"):
        check_join_sums(query([]), orc, "outer_pipelined_path capture run")
    del lt, rt, env
    torch.cuda.empty_cache()
    rec["k2_shard0"] = k2_check(sp, "outer_pipelined_shard0",
                                *captured.pop("probe"), timed=True)
    rec.update({"phase": "outer_pipelined_path", "world": w,
                "rows_per_side": n, "n_chunks": 2,
                "join_rows": int(orc["rows"].sum()), "setup_s": setup_s,
                "rows_per_s": 2 * n / rec["best_s"]})
    return rec


#: broadcast_path: a fact table over 72,818 keys joined to a 65,536-row
#: dimension table, so about 10% of the fact rows find no dimension row
FACT_ROWS, FACT_KEYS, DIM_ROWS = 125_000_000, 72_818, 65_536


def broadcast_path(ct, n_fact: int = FACT_ROWS, device=None) -> dict:
    """A star-schema lookup at W = 4: ``fact.merge(dim, on="k",
    how="left").groupby("k").sum()``.  The dimension table is at the
    broadcast cutover, so it replicates and the fact table never
    shuffles (``join.broadcast`` once per query, no join shuffle)."""
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.relational import join as pjoin
    from cylon_tpu_torch.utils import timing
    rng = np.random.default_rng(42)
    fk = rng.integers(0, FACT_KEYS, n_fact)
    fa = rng.integers(0, 1_000_000, n_fact)
    dk = rng.permutation(DIM_ROWS).astype(np.int64)
    db = rng.integers(0, 1_000_000, DIM_ROWS)
    orc = how_oracle(fk, fa, dk, db, FACT_KEYS, "left")
    env = ct.CylonEnv(VirtualMeshConfig(4), device=device)
    t0 = time.perf_counter()
    fact = ct.DataFrame({"k": fk, "a": fa}, env=env)
    dim = ct.DataFrame({"k": dk, "b": db}, env=env)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    del fk, fa
    rec = timed_path(
        "broadcast_path", frame_query(fact, dim, "left"),
        lambda out, label: check_join_sums(out.table, orc, label,
                                           ("a", "b")),
        {**JOIN_PHASES, "combine": "groupby.combine",
         "intermediates_shuffle": "groupby.shuffle",
         "final": "groupby.final"})
    # the route, counted on one more query
    shuffles = []
    orig = pjoin.shuffle_table
    pjoin.shuffle_table = lambda *a, **k: shuffles.append(1) or orig(*a, **k)
    timing.reset()
    try:
        check_join_sums(frame_query(fact, dim, "left")([]).table, orc,
                        "broadcast_path route run", ("a", "b"))
    finally:
        pjoin.shuffle_table = orig
    taken = timing.counts().get("join.broadcast", 0)
    if taken != 1 or shuffles:
        raise AssertionError(f"broadcast_path: the broadcast route ran "
                             f"{taken} times, the join shuffled "
                             f"{len(shuffles)} tables")
    del fact, dim, env
    rec.update({"phase": "broadcast_path", "world": 4, "fact_rows": n_fact,
                "fact_keys": FACT_KEYS, "dim_rows": DIM_ROWS,
                "join_rows": int(orc["rows"].sum()),
                "unmatched_fact_rows": int(orc["rows"][DIM_ROWS:].sum()),
                "query": 'fact.merge(dim, on="k", how="left")'
                         '.groupby("k").sum()',
                "broadcast_routes": taken, "join_shuffles": len(shuffles),
                "setup_s": setup_s,
                "rows_per_s": (n_fact + DIM_ROWS) / rec["best_s"]})
    if any(v["launches"] for v in rec["kernel_counts"].values()):
        raise AssertionError(f"broadcast_path: kernel counts "
                             f"{rec['kernel_counts']}; no TPU kernel lies on "
                             "this path")
    return rec


# -- set operations, unique, equals, repartition, hashed string keys -------

#: strings_path: rows per table; TPC-H's C_NAME format on bench.py's keys
STRING_ROWS = 4_194_304
NAME_FORMAT = "Customer#%09d"


def setops_small_inputs(n: int, seed: int = 13):
    """Two tables of a nullable int64 key ``k`` (2% null, each value about
    8 times) and a nullable int64 ``g`` in [0, 3) (2% null); the first
    also a row id ``i``.  The second's keys overlap the first's upper
    half."""
    rng = np.random.default_rng(seed)

    def side(m, lo):
        k = rng.integers(lo, lo + max(m // 8, 1), m).astype(np.int64)
        kvalid = rng.random(m) > 0.02
        k[~kvalid] = 0
        g = rng.integers(0, 3, m).astype(np.int64)
        gvalid = rng.random(m) > 0.02
        g[~gvalid] = 0
        return {"k": k, "kvalid": kvalid, "g": g, "gvalid": gvalid}

    a = side(n, 0)
    a["i"] = np.arange(n, dtype=np.int64)
    return a, side(n // 2, n // 16)


def setops_table(ct, cols, env, names=("k", "g", "i")):
    from cylon_tpu_torch.core.dtypes import LogicalType
    out = {}
    for c in names:
        if c not in cols:
            continue
        d, v = cols[c], cols.get(c + "valid")
        out[c] = ct.Column(d, LogicalType.INT64, v,
                           bounds=(int(d.min()), int(d.max())))
    return ct.Table.from_host_columns(out, env)


def row_codes(k, kv, g, gv) -> np.ndarray:
    """One int64 per (k, g) row value, a null its own value."""
    kc = np.where(kv, k + 1, 0) if kv is not None else k + 1
    gc = np.where(gv, g + 1, 0) if gv is not None else g + 1
    return kc * 4 + gc


def out_codes(t) -> np.ndarray:
    host = t.host_columns()
    return row_codes(*host["k"], *host["g"])


def check_set(got: np.ndarray, want: np.ndarray, label: str) -> int:
    """``got`` (row codes in any order) must be exactly the sorted unique
    ``want``: the same rows, each once."""
    if not np.array_equal(np.sort(got), want):
        raise AssertionError(f"{label}: {len(got)} rows differ from the "
                             f"numpy oracle's {len(want)}")
    return len(got)


def check_ids(t, want: np.ndarray, label: str) -> int:
    """The row ids ``i`` of ``t`` in global order must be ``want``."""
    got = t.host_columns()["i"][0]
    if not np.array_equal(got, want):
        raise AssertionError(f"{label}: row ids differ from the host copy")
    return len(got)


def strings_tables(ct, left, right, names, env):
    """The BASELINE pair keyed by ``NAME_FORMAT`` names of their int keys,
    one int64 payload each; hashed on ingest."""
    lt = ct.DataFrame({"name": names[left["k"]], "a": left["a"]}, env=env)
    rt = ct.DataFrame({"name": names[right["k"]], "b": right["b"]}, env=env)
    return lt, rt


def strings_oracle(left, right, mv: int) -> dict:
    """``merge(on="name").groupby("name").sum().sort_values("name")`` in
    numpy on the int keys: the names sort as their zero-padded keys do."""
    orc = how_oracle(left["k"], left["a"], right["k"], right["b"], mv,
                     "inner")
    keep = orc["rows"] > 0
    return {"keys": np.flatnonzero(keep), "a": orc["sa"][keep],
            "b": orc["sb"][keep]}


def strings_query(lt, rt):
    def run(times):
        t0 = time.perf_counter()
        out = lt.merge(rt, on="name").groupby("name").sum() \
            .sort_values("name")
        sync_pull(out.table.column("name").data)
        times.append(time.perf_counter() - t0)
        return out
    return run


def check_strings(out, orc, names, label: str) -> int:
    """Names decoded through the column's value store, in order, and the
    sums."""
    got = out.table.to_pydict()
    if not np.array_equal(got["name"], names[orc["keys"]]):
        raise AssertionError(f"{label}: names or their order differ from "
                             "the numpy oracle")
    for c in ("a", "b"):
        if not np.array_equal(got[c], orc[c]):
            raise AssertionError(f"{label}: {c} sums differ from the oracle")
    return len(orc["keys"])


def setops_small_world(ct, a, b, w: int, device=None) -> dict:
    """Every set operation, unique, equals, repartition and row range of
    this slice on one world, each against numpy."""
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
    n = len(a["k"])
    ta, tb = setops_table(ct, a, env), setops_table(ct, b, env)
    pa, pb = ta.project(["k", "g"]), tb.project(["k", "g"])
    ca = row_codes(a["k"], a["kvalid"], a["g"], a["gvalid"])
    cb = row_codes(b["k"], b["kvalid"], b["g"], b["gvalid"])
    want = {"union": np.union1d(ca, cb), "intersect": np.intersect1d(ca, cb),
            "subtract": np.setdiff1d(ca, cb)}
    rec = {"world": w, "rows": n}
    for op, exp in want.items():
        rec[op] = check_set(out_codes(ct.set_operation(pa, pb, op)), exp,
                            f"setops_small W={w} {op}")
        rec[f"pipelined_{op}"] = check_set(
            out_codes(ct.pipelined_set_op(pa, pb, op, n_chunks=3)), exp,
            f"setops_small W={w} pipelined {op}")
    # unique on a subset (keep first / last) and on every column
    kc = np.where(a["kvalid"], a["k"] + 1, 0)
    _, first = np.unique(kc, return_index=True)
    _, rlast = np.unique(kc[::-1], return_index=True)
    for keep, rows in (("first", first), ("last", n - 1 - rlast)):
        u = ct.unique_table(ta, ["k"], keep)
        got = np.sort(u.host_columns()["i"][0])
        if not np.array_equal(got, np.sort(rows)):
            raise AssertionError(f"setops_small W={w}: unique keep={keep} "
                                 "kept other rows")
        rec[f"unique_{keep}"] = len(got)
    rec["unique_all"] = check_set(out_codes(ct.unique_table(pa)),
                                  np.unique(ca), f"setops_small W={w} unique")
    # equals: ordered and unordered
    perm = np.random.default_rng(w).permutation(n)
    shuffled = setops_table(ct, {c: x[perm] for c, x in a.items()}, env)
    changed = {c: x.copy() for c, x in a.items()}
    changed["g"][n // 2] += 1
    changed = setops_table(ct, changed, env)
    same = setops_table(ct, a, env)
    eq = (ct.equals(ta, same), ct.equals(ta, shuffled),
          ct.equals(ta, shuffled, ordered=False), ct.equals(ta, changed))
    if eq != (True, False, True, False):
        raise AssertionError(f"setops_small W={w}: equals answered {eq}")
    # repartition: even after an uneven slice, then a specified split
    lo, ln = n // 7, n // 2
    s = ct.slice_table(ta, lo, ln)
    ids = np.arange(lo, lo + ln)
    r = ct.repartition(s)
    if not np.array_equal(r.valid_counts, even_counts(ln, w)):
        raise AssertionError(f"setops_small W={w}: repartition counts "
                             f"{r.valid_counts}")
    check_ids(r, ids, f"setops_small W={w} repartition even")
    dest = np.zeros(w, np.int64)
    dest[-1] = ln - 7 * (w - 1)
    dest[:-1] = 7
    r2 = ct.repartition(r, dest)
    if not np.array_equal(r2.valid_counts, dest):
        raise AssertionError(f"setops_small W={w}: specified counts "
                             f"{r2.valid_counts}")
    check_ids(r2, ids, f"setops_small W={w} repartition specified")
    # row ranges across shard boundaries (ingest: blocks of ceil(n / w))
    chunk = -(-n // w)
    for name, t, want_ids in (
            ("slice", ct.slice_table(ta, chunk - 10, chunk + 20),
             np.arange(chunk - 10, min(2 * chunk + 10, n))),
            ("head", ct.head(ta, chunk + 3), np.arange(min(chunk + 3, n))),
            ("tail", ct.tail(ta, chunk + 5),
             np.arange(max(n - chunk - 5, 0), n))):
        rec[name] = check_ids(t, want_ids, f"setops_small W={w} {name}")
    return rec


def even_counts(total: int, w: int) -> np.ndarray:
    base, extra = divmod(int(total), w)
    return np.asarray([base + (i < extra) for i in range(w)], np.int64)


def strings_small(ct, w: int, n: int, device=None) -> int:
    """A hashed-string join, groupby and sort at ``n`` rows per side, the
    crossover forced down to this size through the config knobs."""
    from cylon_tpu_torch import config
    from cylon_tpu_torch.core.column import HashedStrings
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    left, right, mv = baseline_inputs(n, seed=5)
    names = np.asarray([NAME_FORMAT % i for i in range(mv)], dtype=object)
    saved = config.STRING_HASH_MIN_ROWS
    config.STRING_HASH_MIN_ROWS = min(saved, n)
    try:
        env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
        lt, rt = strings_tables(ct, left, right, names, env)
    finally:
        config.STRING_HASH_MIN_ROWS = saved
    if not isinstance(lt.table.column("name").dictionary, HashedStrings):
        raise AssertionError("strings_small: the names did not hash")
    return check_strings(strings_query(lt, rt)([]),
                         strings_oracle(left, right, mv), names,
                         f"strings_small W={w}")


def setops_small(ct, worlds=(1, 3, 4, 8), n: int = 1_000_000,
                 device=None) -> list:
    a, b = setops_small_inputs(n)
    recs = []
    for w in worlds:
        t0 = time.perf_counter()
        rec = setops_small_world(ct, a, b, w, device)
        rec["strings_groups"] = strings_small(ct, w, n // 4, device)
        rec["seconds"] = time.perf_counter() - t0
        recs.append(rec)
    return recs


SETOP_PHASES = {"hash": "shuffle.hash", "exchange": "shuffle.exchange",
                "flags": "setop.flags", "materialize": "setop.materialize"}
UNIQUE_PHASES = {"hash": "shuffle.hash", "exchange": "shuffle.exchange",
                 "flags": "unique.flags", "materialize": "unique.materialize"}


def key_counts(keys: np.ndarray, mv: int) -> np.ndarray:
    """Rows per key id in ``[0, mv)``, an int64 host array: one
    ``bincount`` on the card when there is one (numpy's over 125M keys
    took seconds of ``setops_path``), numpy's on the host."""
    if torch.cuda.is_available():
        return torch.bincount(torch.from_numpy(np.ascontiguousarray(keys))
                              .cuda(), minlength=mv).cpu().numpy()
    return np.bincount(keys, minlength=mv)


def key_presence_check(expected: np.ndarray, mv: int, first=None, a=None):
    """``expected``: a bool per key id; the result must hold each of those
    keys exactly once (and, given ``first``, its first row's ``a``)."""
    def check(out, label):
        host = out.table.host_columns()
        keys = host["k"][0]
        if not np.array_equal(key_counts(keys, mv),
                              expected.astype(np.int64)):
            raise AssertionError(f"{label}: key set differs from numpy")
        if first is not None and not np.array_equal(host["a"][0],
                                                     a[first[keys]]):
            raise AssertionError(f"{label}: not each key's first row")
        return len(keys)
    return check


def frame_run(fn):
    """``fn()``, a DataFrame query, waited on; appends its seconds."""
    def run(times):
        t0 = time.perf_counter()
        out = fn()
        sync_pull(out.table.column("k").data)
        times.append(time.perf_counter() - t0)
        return out
    return run


def no_kernels(rec: dict, label: str) -> None:
    if any(v["launches"] for v in rec["kernel_counts"].values()):
        raise AssertionError(f"{label}: kernel counts "
                             f"{rec['kernel_counts']}; no TPU kernel lies "
                             "on this path")


def setops_paths(ct, left, right, mv: int, device=None,
                 profile: bool = True) -> list:
    """The BASELINE tables at W = 4: ``L.union(R)``, ``L.intersect(R)``,
    ``L.subtract(R)`` on the key columns, ``df1.drop_duplicates(["k"])``
    on the full table (``setops_path``); ``pipelined_set_op(L, R,
    "subtract", n_chunks=4)`` (``pipelined_setop_path``); and the
    repartition of the subtraction's uneven output with head, tail and a
    slice of its middle third (``repart_path``)."""
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    n = len(left["k"])
    env = ct.CylonEnv(VirtualMeshConfig(4), device=device)
    t0 = time.perf_counter()
    df1 = ct.DataFrame(left, env=env)
    df2 = ct.DataFrame(right, env=env)
    L, R = df1[["k"]], df2[["k"]]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pres_l = key_counts(left["k"], mv) > 0
    pres_r = key_counts(right["k"], mv) > 0
    first = np.empty(mv, np.int64)
    # reversed fancy assignment: the last write, each key's first row, wins
    first[left["k"][::-1]] = np.arange(n - 1, -1, -1)
    recs = []
    for op, want, rows, fn in (
            ("union", pres_l | pres_r, 2 * n, lambda: L.union(R)),
            ("intersect", pres_l & pres_r, 2 * n, lambda: L.intersect(R)),
            ("subtract", pres_l & ~pres_r, 2 * n, lambda: L.subtract(R)),
            ("drop_duplicates", pres_l, n,
             lambda: df1.drop_duplicates(["k"]))):
        dd = op == "drop_duplicates"
        rec = timed_path(
            f"setops_path {op}", frame_run(fn),
            key_presence_check(want, mv, first if dd else None,
                               left["a"] if dd else None),
            UNIQUE_PHASES if dd else SETOP_PHASES, profile=profile)
        no_kernels(rec, f"setops_path {op}")
        rec.update({"phase": "setops_path", "query": op, "world": 4,
                    "rows_per_side": n, "rows_in": rows,
                    "setup_s": setup_s, "rows_per_s": rows / rec["best_s"]})
        recs.append(rec)
    rec = timed_path(
        "pipelined_setop_path",
        frame_run(lambda: ct.DataFrame.from_table(ct.pipelined_set_op(
            L.table, R.table, "subtract", n_chunks=4))),
        key_presence_check(pres_l & ~pres_r, mv),
        {**SETOP_PHASES, "unique_flags": "unique.flags",
         "unique_materialize": "unique.materialize"}, profile=profile)
    no_kernels(rec, "pipelined_setop_path")
    rec.update({"phase": "pipelined_setop_path", "query": "subtract",
                "n_chunks": 4, "world": 4, "rows_per_side": n,
                "rows_in": 2 * n, "rows_per_s": 2 * n / rec["best_s"]})
    recs.append(rec)
    recs.append(repart_path(ct, L.subtract(R).table))
    return recs


def repart_path(ct, sub) -> dict:
    """``repartition()`` of an uneven table onto the even split (best of 3
    after a warm-up), then ``head(1000)``, ``tail(1000)`` and
    ``slice_table(n/3, n/3)``, each in global order against the host
    copy."""
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    host = sub.host_columns()["k"][0]
    total, w = len(host), sub.env.world_size
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wg.reset_counts()
    sp.reset_counts()
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        r = ct.repartition(sub)
        sync_pull(r.column("k").data)
        times.append(time.perf_counter() - t0)
    counts = {"windowed_gather": dict(wg.COUNTS),
              "splitter_probe": dict(sp.COUNTS)}
    peak = torch.cuda.max_memory_allocated()
    if not np.array_equal(r.valid_counts, even_counts(total, w)):
        raise AssertionError(f"repart_path: counts {r.valid_counts}")
    if not np.array_equal(r.host_columns()["k"][0], host):
        raise AssertionError("repart_path: global order changed")
    third = total // 3
    t0 = time.perf_counter()
    pieces = {"head": (ct.head(r, 1000), host[:1000]),
              "tail": (ct.tail(r, 1000), host[total - 1000:]),
              "slice": (ct.slice_table(r, third, third),
                        host[third:2 * third])}
    sync_pull(pieces["slice"][0].column("k").data)
    ranges_s = time.perf_counter() - t0
    for name, (t, want) in pieces.items():
        if not np.array_equal(t.host_columns()["k"][0], want):
            raise AssertionError(f"repart_path: {name} differs from the "
                                 "host copy")
    rec = {"phase": "repart_path", "world": w, "rows": total,
           "counts_before": [int(x) for x in sub.valid_counts],
           "counts_after": [int(x) for x in r.valid_counts],
           "iterations": times[1:], "first_s": times[0],
           "best_s": min(times[1:]), "rows_per_s": total / min(times[1:]),
           "peak_mem_bytes": peak, "ranges_s": ranges_s,
           "kernel_counts": counts, "oracle": "equal"}
    no_kernels(rec, "repart_path")
    return rec


def strings_path(ct, n: int = STRING_ROWS, device=None,
                 profile: bool = True) -> dict:
    """Two ``n``-row tables keyed by ``NAME_FORMAT`` names of bench.py's
    keys (above the crossover, so their codes hash on ingest) at W = 4:
    ``merge(on="name").groupby("name").sum().sort_values("name")``."""
    from cylon_tpu_torch.core.column import HashedStrings
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    left, right, mv = baseline_inputs(n)
    t0 = time.perf_counter()
    names = np.asarray([NAME_FORMAT % i for i in range(mv)], dtype=object)
    names_s = time.perf_counter() - t0
    env = ct.CylonEnv(VirtualMeshConfig(4), device=device)
    t0 = time.perf_counter()
    lt, rt = strings_tables(ct, left, right, names, env)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if not isinstance(lt.table.column("name").dictionary, HashedStrings):
        raise AssertionError("strings_path: the names did not hash")
    orc = strings_oracle(left, right, mv)
    rec = timed_path("strings_path", strings_query(lt, rt),
                     lambda out, label: check_strings(out, orc, names,
                                                      label),
                     {**JOIN_PHASES, "groupby": "groupby.raw",
                      "string_lanes": "sort.string_lanes",
                      "sort_sample": "sort.sample",
                      "sort_exchange": "sort.exchange",
                      "sort_local": "sort.local"}, profile=profile)
    rec.update({"phase": "strings_path", "world": 4, "rows_per_side": n,
                "distinct_names": mv, "names_s": names_s,
                "setup_s": setup_s, "rows_per_s": 2 * n / rec["best_s"]})
    return rec


#: series_path / scan_join_path: bench.py's df1 at 125,829,120 rows, read
#: by the scan as 8 batches of 15,728,640 rows
SCAN_ROWS, SCAN_BATCHES = 125_829_120, 8
#: series_path's nullable float64 column: about this share of rows null
SERIES_NULL_SHARE = 0.05
#: series_path's query: keys in [mv/4, mv/2), payloads below mv/2
SERIES_PHASES = {"filter": "q.filter", "derive": "q.derive",
                 "reduce": "q.reduce", "nunique": "q.nunique",
                 "loc": "q.loc", "iloc": "q.iloc", "nulls": "q.nulls"}
#: the fused pushdown's segment space below which K1 is never asked for
#: (relational/fused._win_size)
K1_MIN_SEGMENTS = 1 << 20
SCAN_PHASES = {"ingest": "scan.ingest", "shuffle": "join.shuffle",
               "scan_join": "pipe.scan_join", "consume": "pipe.consume"}


def series_inputs(left: dict, seed: int = 42):
    """x: float64 values with a validity mask, about SERIES_NULL_SHARE of
    the rows null, drawn from the seed (after bench.py's own draws)."""
    rng = np.random.default_rng([seed, 8])
    n = len(left["k"])
    return rng.standard_normal(n) * 100.0, rng.random(n) >= SERIES_NULL_SHARE


def series_frame(ct, left: dict, x, valid, env):
    """df1's k and a plus the nullable x, through ``Table.from_host_columns``
    (a float column with a validity mask: the dtype-faithful ingest)."""
    from cylon_tpu_torch.core.dtypes import LogicalType
    cols = {"k": ct.Column.from_numpy(left["k"]),
            "a": ct.Column.from_numpy(left["a"]),
            "x": ct.Column(x, LogicalType.FLOAT64, valid)}
    return ct.DataFrame(_table=ct.Table.from_host_columns(cols, env))


def series_query(df, mv: int):
    """TPC-H Q6's shape on df1: a mask of three comparisons combined with
    ``&``, ``df[mask]``, two derived columns through ``__setitem__``,
    ``sum``/``mean``/``count``/``nunique``; then ``set_index("k").loc[lo:
    hi]``, an ``iloc`` range and ``isna``/``fillna``/``dropna``/``where``
    on the nullable column.  Each step is a timing region; the result is
    a dict of host scalars."""
    from cylon_tpu_torch.utils import timing
    lo, hi, acut, n = mv // 4, mv // 2, mv // 2, len(df)

    def run(times):
        out = {}
        t0 = time.perf_counter()
        with timing.region("q.filter"):
            m = (df["k"] >= lo) & (df["k"] < hi) & (df["a"] < acut)
            f = df[m]
        with timing.region("q.derive"):
            f["rev"] = f["a"] * 3 - f["k"]
            f["y"] = f["x"] * 0.5 + 1.0
            sync_pull(f.table.column("y").data)
        with timing.region("q.reduce"):
            out["rev_sum"] = f["rev"].sum()
            out["y_mean"] = f["y"].mean()
            out["y_count"] = f["y"].count()
        with timing.region("q.nunique"):
            out["k_nunique"] = f["k"].nunique()
        with timing.region("q.loc"):
            li = df.set_index("k").loc[lo:hi]
            out["loc_rows"] = len(li)
            out["loc_a_sum"] = li["a"].sum()
        with timing.region("q.iloc"):
            il = df.iloc[n // 3:n // 3 + n // 10]
            out["iloc_rows"] = len(il)
            out["iloc_a_sum"] = il["a"].sum()
        with timing.region("q.nulls"):
            xs = df["x"]
            out["isna"] = xs.isna().sum()
            out["fillna_sum"] = xs.fillna(0.0).sum()
            out["dropna_rows"] = len(df.dropna(subset=["x"]))
            out["where_count"] = xs.where(df["k"] < hi).count()
        times.append(time.perf_counter() - t0)
        return out
    return run


def series_oracle(left: dict, x, valid, mv: int) -> dict:
    """series_query's answers in numpy.  Integer sums are exact (below
    2^63); a float sum carries its tolerance (``tol``)."""
    k, a = left["k"], left["a"]
    lo, hi, acut, n = mv // 4, mv // 2, mv // 2, len(k)
    m = (k >= lo) & (k < hi) & (a < acut)
    y = x[m & valid] * 0.5 + 1.0
    loc = (k >= lo) & (k <= hi)
    il = slice(n // 3, n // 3 + n // 10)
    eps = np.finfo(np.float64).eps
    return {"rev_sum": int((a[m] * 3 - k[m]).sum()),
            "y_mean": float(y.sum() / len(y)), "y_count": len(y),
            "k_nunique": len(np.unique(k[m])),
            "loc_rows": int(loc.sum()), "loc_a_sum": int(a[loc].sum()),
            "iloc_rows": n // 10, "iloc_a_sum": int(a[il].sum()),
            "isna": int((~valid).sum()),
            "fillna_sum": float(x[valid].sum()),
            "dropna_rows": int(valid.sum()),
            "where_count": int((valid & (k < hi)).sum()),
            # a tree-ordered float64 sum of n values is within
            # 64·eps·Σ|v| of any other (tests/test_torch_groupby_sort.py)
            "tol": {"y_mean": 64 * eps * float(np.abs(y).sum()) / len(y),
                    "fillna_sum": 64 * eps * float(np.abs(x[valid]).sum())}}


def check_series(out: dict, orc: dict, label: str) -> int:
    for key, want in orc.items():
        if key == "tol":
            continue
        got = out[key]
        tol = orc["tol"].get(key)
        if (abs(got - want) > tol) if tol is not None else got != want:
            raise AssertionError(f"{label}: {key} {got!r}, numpy says "
                                 f"{want!r}")
    return out["y_count"]


def series_path(ct, left: dict, mv: int, device=None,
                profile: bool = True) -> dict:
    """series_query on df1 at W = 4: best of 3 after a warm-up, each
    step's time, the peak memory, the idle share; no kernel launches."""
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    env = ct.CylonEnv(VirtualMeshConfig(4), device=device)
    x, valid = series_inputs(left)
    t0 = time.perf_counter()
    df = series_frame(ct, left, x, valid, env)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    orc = series_oracle(left, x, valid, mv)
    del x, valid
    rec = timed_path("series_path", series_query(df, mv),
                     lambda out, label: check_series(out, orc, label),
                     SERIES_PHASES, profile=profile)
    no_kernels(rec, "series_path")
    n = len(left["k"])
    rec.update({"phase": "series_path", "world": 4, "rows": n,
                "selected_rows": rec.pop("groups"), "setup_s": setup_s,
                "null_rows": orc["isna"], "rows_per_s": n / rec["best_s"]})
    return rec


def scan_batches(ct, left: dict, env, batches: int = SCAN_BATCHES):
    """df1 read as ``batches`` Tables of consecutive rows, each made from
    the host arrays as the scan reaches it (region ``scan.ingest``)."""
    from cylon_tpu_torch.utils import timing
    n = len(left["k"])
    step = -(-n // batches)
    for i in range(0, n, step):
        with timing.region("scan.ingest"):
            t = ct.Table.from_pydict({"k": left["k"][i:i + step],
                                      "a": left["a"][i:i + step]}, env)
        yield t


def scan_join_path(ct, left: dict, right: dict, orc: dict, device=None,
                   profile: bool = True) -> dict:
    """``pipelined_scan_join(batches, df2, "k", "k", sink=GroupBySink(
    "k", [("a", "sum"), ("b", "sum")]))`` at W = 4: df1 streamed in
    SCAN_BATCHES batches against df2 resident (shuffled once), equal to
    the BASELINE join → groupby oracle.  K1 launches once per batch and
    shard (the sink's fused pushdown) and is held bit-equal to its plain
    version on the first batch's shard 0 inputs, and timed there."""
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.ops import windowed_gather as wg
    w = 4
    env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
    t0 = time.perf_counter()
    rt = ct.Table.from_pydict(right, env)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def query(times):
        t0 = time.perf_counter()
        sink = ct.GroupBySink("k", [("a", "sum"), ("b", "sum")])
        ct.pipelined_scan_join(scan_batches(ct, left, env), rt, "k", "k",
                               sink=sink)
        g = sink.finalize()
        sync_pull(g.column("k").data)
        times.append(time.perf_counter() - t0)
        return g

    rec = timed_path("scan_join_path", query,
                     lambda g, label: check_dist(g, orc, w, label),
                     SCAN_PHASES, profile=profile)
    k1 = rec["kernel_counts"]["windowed_gather"]
    if rec["kernel_counts"]["splitter_probe"]["launches"] != 0 \
            or k1["launches"] % 4:
        raise AssertionError(f"scan_join_path: kernel counts "
                             f"{rec['kernel_counts']}; expected no K2 and "
                             "K1 the same number of times per iteration")
    # K1's inputs on the first batch's shard 0: the fused pushdown takes
    # the windowed gather only above the group density wg.MIN_DENSITY
    # (the reference's gate), which a batch against the whole resident
    # build may not reach; the capture run opens the gate (its window
    # from the measured density) so that K1 sees the batch's real lanes
    # and run starts, and records the densities it met
    from cylon_tpu_torch.relational import fused
    captured, seen = {}, []
    gate = fused._win_size

    def opened(env_, sc, dens):
        seen.append(dens)
        return wg.pick_window(dens) if sc >= K1_MIN_SEGMENTS else 0

    fused._SEG_CACHE.clear()
    fused._win_size = opened
    try:
        with capturing(wg, "windowed_take_t", captured, "scan", keep_k1):
            check_dist(query([]), orc, w, "scan_join_path capture run")
    finally:
        fused._win_size = gate
        fused._SEG_CACHE.clear()
    del rt, env
    torch.cuda.empty_cache()
    if "scan" not in captured:
        raise AssertionError("scan_join_path: the capture run launched no "
                             "K1")
    rec["k1_first_batch"] = k1_check(wg, "scan_join_first_batch_shard0",
                                     *captured.pop("scan"), timed=True)
    rec["group_densities_seen"] = seen[:2 * SCAN_BATCHES]
    rec["k1_min_density"] = wg.MIN_DENSITY
    n = len(left["k"])
    rec.update({"phase": "scan_join_path", "world": w,
                "scan_rows": n, "build_rows": len(right["k"]),
                "batches": SCAN_BATCHES, "batch_rows": -(-n // SCAN_BATCHES),
                "k1_launches_per_iteration": k1["launches"] // 4,
                "setup_s": setup_s,
                "rows_per_s": (n + len(right["k"])) / rec["best_s"]})
    return rec


def breadth_inputs(n: int, seed: int = 17) -> dict:
    """breadth_small's host columns: a key over n/8 values, a decimal key
    (its quarters, scale 2 on the left and 3 on the right), a decimal
    payload (tenths, scale 1), an int64 payload, a nullable int64 and a
    nullable float64 (2% null each)."""
    rng = np.random.default_rng(seed)
    nk = max(n // 8, 1)
    lk = rng.integers(0, nk, n).astype(np.int64)
    rk = rng.integers(0, nk, n // 2).astype(np.int64)
    return {"nk": nk, "lk": lk, "rk": rk,
            "p": rng.integers(-10_000, 10_000, n).astype(np.int64),
            "b": rng.integers(0, 1000, n // 2).astype(np.int64),
            "v": rng.integers(-50, 50, n).astype(np.int64),
            "vv": rng.random(n) >= 0.02,
            "f": rng.standard_normal(n), "fv": rng.random(n) >= 0.02}


def breadth_small_world(ct, d: dict, w: int, device=None) -> dict:
    """One world of breadth_small (module docstring), against numpy."""
    from cylon_tpu_torch.core.column import DecimalScale, PassthroughValues
    from cylon_tpu_torch.core.dtypes import LogicalType as LT
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
    lk, rk, nk, n = d["lk"], d["rk"], d["nk"], len(d["lk"])
    checks = 0

    def dec(data, scale):
        return ct.Column(data, LT.DECIMAL, None,
                         DecimalScale(max(len(str(int(np.abs(data).max()))),
                                          1), scale),
                         bounds=(int(data.min()), int(data.max())))

    ls = np.empty(n, dtype=object)
    ls[:] = [[i, i % 7] for i in range(n)]
    lt = ct.Table.from_host_columns({
        "k": ct.Column.from_numpy(lk), "m": dec(lk * 25, 2),
        "p": dec(d["p"], 1), "ls": ct.Column(
            np.arange(n, dtype=np.int32), LT.LIST, None,
            PassthroughValues(ls), bounds=(0, n - 1))}, env)
    rt = ct.Table.from_host_columns({
        "m": dec(rk * 250, 3), "b": ct.Column.from_numpy(d["b"])}, env)

    # decimals: a join of mixed scales (rescaled to 3), a groupby sum
    L, R = np.bincount(lk, minlength=nk), np.bincount(rk, minlength=nk)
    sp = np.bincount(lk, d["p"], minlength=nk).astype(np.int64)
    sb = np.bincount(rk, d["b"], minlength=nk).astype(np.int64)
    j = ct.join_tables(lt, rt, "m", "m")
    if j.column("m").dictionary != DecimalScale(
            j.column("m").dictionary.precision, 3):
        raise AssertionError(f"breadth W={w}: join key not at scale 3")
    g = ct.groupby_aggregate(j, "m", [("p", "sum"), ("b", "sum")]) \
        .host_columns()
    keep = (L > 0) & (R > 0)
    order = stable_order(g["m"][0])
    if not (np.array_equal(g["m"][0][order], np.nonzero(keep)[0] * 250)
            and np.array_equal(g["p_sum"][0][order], (sp * R)[keep])
            and np.array_equal(g["b_sum"][0][order], (sb * L)[keep])):
        raise AssertionError(f"breadth W={w}: decimal join→groupby differs")
    checks += 1
    # the list payload rode the join: each row's list names its left row
    jh = j.project(["k", "ls"]).to_pydict()
    first = np.fromiter((v[0] for v in jh["ls"]), np.int64, len(jh["ls"]))
    if len(first) != int((L * R).sum()) or not np.array_equal(
            lk[first], jh["k"]):
        raise AssertionError(f"breadth W={w}: list payload lost its rows")
    checks += 1
    del j, jh, first
    # sort by (decimal key, decimal payload), concat of scales 2 and 3,
    # a set op on rescaled keys, a groupby sum of a decimal payload
    s = ct.sort_table(lt, ["m", "p"]).host_columns()
    o = np.lexsort((d["p"], lk))
    if not (np.array_equal(s["m"][0], lk[o] * 25)
            and np.array_equal(s["p"][0], d["p"][o])):
        raise AssertionError(f"breadth W={w}: decimal sort differs")
    c = ct.concat_tables([lt.project(["m"]), rt.project(["m"])])
    if c.column("m").dictionary.scale != 3 or not np.array_equal(
            np.sort(c.host_columns()["m"][0]),
            np.sort(np.concatenate([lk, rk]) * 250)):
        raise AssertionError(f"breadth W={w}: decimal concat differs")
    both = ct.set_operation(lt.project(["m"]), rt.project(["m"]),
                            "intersect").host_columns()["m"][0]
    if not np.array_equal(np.sort(both), np.nonzero(keep)[0] * 250):
        raise AssertionError(f"breadth W={w}: decimal intersect differs")
    g = ct.groupby_aggregate(lt, "m", [("p", "sum")]).host_columns()
    o = stable_order(g["m"][0])
    if not (np.array_equal(g["m"][0][o], np.nonzero(L)[0] * 25)
            and np.array_equal(g["p_sum"][0][o], sp[L > 0])):
        raise AssertionError(f"breadth W={w}: decimal groupby differs")
    checks += 4
    # the list payload through a filter; its typed refusals as a key
    df = ct.DataFrame(_table=lt)
    f = df[df["k"] % 3 == 0].table.project(["k", "ls"]).to_pydict()
    sel = np.nonzero(lk % 3 == 0)[0]
    if not (np.array_equal(f["k"], lk[sel]) and np.array_equal(
            np.fromiter((v[0] for v in f["ls"]), np.int64, len(sel)), sel)):
        raise AssertionError(f"breadth W={w}: list payload filter differs")
    for call, err in ((lambda: ct.join_tables(lt, lt, "ls", "ls"),
                       ct.CylonTypeError),
                      (lambda: ct.groupby_aggregate(lt, "ls", [("p", "sum")]),
                       ct.InvalidError),
                      (lambda: ct.sort_table(lt, "ls"), ct.InvalidError)):
        try:
            call()
        except err:
            continue
        raise AssertionError(f"breadth W={w}: a list key was accepted")
    checks += 2
    del df, f

    # Series with nulls, loc/iloc, Row/Scalar
    vt = ct.Table.from_host_columns({
        "k": ct.Column.from_numpy(lk),
        "v": ct.Column(d["v"], LT.INT64, d["vv"]),
        "f": ct.Column(d["f"], LT.FLOAT64, d["fv"])}, env)
    df = ct.DataFrame(_table=vt)
    vv, fv = d["vv"], d["fv"]
    s = (df["v"] * 2 + df["k"]).where(df["f"] > 0)
    ok = vv & fv & (d["f"] > 0)
    want = (d["v"] * 2 + lk)[ok]
    got = {"sum": s.sum(), "count": s.count(), "min": s.min(),
           "max": s.max(), "nunique": s.nunique(),
           "isna": df["f"].isna().sum(),
           "mask": len(df[(df["v"] > 0) | (df["f"] < -1)])}
    want = {"sum": int(want.sum()), "count": len(want),
            "min": int(want.min()), "max": int(want.max()),
            "nunique": len(np.unique(want)), "isna": int((~fv).sum()),
            # validity propagates as AND: a null on either side is null
            "mask": int((((d["v"] > 0) | (d["f"] < -1)) & vv & fv).sum())}
    if got != want:
        raise AssertionError(f"breadth W={w}: series {got} != {want}")
    mean = df["f"].mean()
    if abs(mean - d["f"][fv].mean()) > 1e-9:
        raise AssertionError(f"breadth W={w}: mean {mean}")
    checks += 1
    ix = df.set_index("k")
    labels = [int(lk[0]), int(lk[n // 2]), int(lk[-1])]
    got = ix.loc[labels].table.host_columns()["k"][0]
    if not np.array_equal(got, lk[np.isin(lk, labels)]):
        raise AssertionError(f"breadth W={w}: loc by labels differs")
    lo, hi = nk // 3, nk // 3 + 50
    got = ix.loc[lo:hi].table.host_columns()["k"][0]
    if not np.array_equal(got, lk[(lk >= lo) & (lk <= hi)]):
        raise AssertionError(f"breadth W={w}: loc range differs")
    pos = [n - 1, 3, n // 2, 3]
    got = df.iloc[pos].table.host_columns()["k"][0]
    if not np.array_equal(got, lk[pos]) or not np.array_equal(
            df.iloc[n // 4:n // 4 + 1000].table.host_columns()["k"][0],
            lk[n // 4:n // 4 + 1000]):
        raise AssertionError(f"breadth W={w}: iloc differs")
    r = df.row(n // 2 + 1)
    i = n // 2 + 1
    if r["k"] != lk[i] or r["v"] != (int(d["v"][i]) if vv[i] else None) \
            or r.scalar("f").is_null != (not fv[i]) \
            or r.scalar("v").type != LT.INT64:
        raise AssertionError(f"breadth W={w}: row {r.to_dict()}")
    checks += 4
    return {"world": w, "rows": n, "checks": checks}


def breadth_small(ct, worlds=(1, 3, 4, 8), n: int = 1_000_000,
                  device=None) -> list:
    """Decimal keys and payloads (mixed scales) through a join, a groupby
    sum, a sort, a concat and a set op; a list payload through a join and
    a filter, refused as a key; Series ops with nulls, ``loc``, ``iloc``
    and ``Row``/``Scalar`` — at each world size, against numpy.  No
    kernel launches."""
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    d = breadth_inputs(n)
    out = []
    for w in worlds:
        wg.reset_counts()
        sp.reset_counts()
        t0 = time.perf_counter()
        rec = breadth_small_world(ct, d, w, device)
        rec.update({"seconds": time.perf_counter() - t0,
                    "kernel_counts": {"windowed_gather": dict(wg.COUNTS),
                                      "splitter_probe": dict(sp.COUNTS)}})
        out.append(rec)
    return out



#: the skew route's phases and the timing regions that hold them
SKEW_PHASES = {"detect": "skew.detect", "finalize_counts": "skew.finalize",
               "split_exchange": "skew.split_exchange",
               "join_sort_count": "join.sort_count",
               "heavy_partial_combine": "skew.partial_combine"}
#: bench.py --skew=0.9: the probe's share of rows on the one hot key
SKEW_SHARE = 0.9
#: configuration 5 at W = 4: the rows per side in total of dist_path
SKEW_ROWS = 125_829_120


def skew_inputs(n: int, skew: float = SKEW_SHARE, seed: int = 42):
    """bench.py's ``--skew`` tables (same generator, same draw order):
    keys uniform in [0, 0.9 n), a ``skew`` share of probe rows on
    ``hot = max_val // 2``, and ``hot`` exactly once on the build side."""
    rng = np.random.default_rng(seed)
    mv = max(int(n * 0.9), 1)
    hot = np.int64(mv // 2)
    lk = rng.integers(0, mv, n).astype(np.int64)
    lk = np.where(rng.random(n) < skew, hot, lk)
    a = rng.integers(0, mv, n).astype(np.int64)
    rk = rng.integers(0, mv, n).astype(np.int64)
    rk[rk == hot] = hot + 1
    rk[0] = hot
    b = rng.integers(0, mv, n).astype(np.int64)
    return {"k": lk, "a": a}, {"k": rk, "b": b}, mv, int(hot)


def same_rows(a: dict, b: dict, label: str) -> None:
    """Two ``to_pydict`` results equal column by column, row by row."""
    if list(a) != list(b):
        raise AssertionError(f"{label}: columns {list(a)} != {list(b)}")
    for name in a:
        x, y = np.asarray(a[name]), np.asarray(b[name])
        if x.shape != y.shape or not bool(np.all(
                (x == y) | ((x != x) & (y != y)))):
            raise AssertionError(f"{label}: column {name} differs")


def skew_small_inputs(n: int, seed: int = 23) -> dict:
    """skew_small's host columns: bench.py-like keys uniform in [0, mv)
    on both sides, 90% of the probe rows on ``hot`` and ``hot`` once on
    the build side; int64 payloads; a second key column in [0, 4) whose
    hot rows all hold 1; validity masks for the heavy-NULL case (the hot
    rows null on the probe, one null row on the build side)."""
    rng = np.random.default_rng(seed)
    mv = max(int(n * 0.9), 1)
    hot = mv // 2
    lk = rng.integers(0, mv, n)
    is_hot = rng.random(n) < SKEW_SHARE
    lk[is_hot] = hot
    rk = rng.integers(0, mv, n)
    rk[rk == hot] = hot + 1
    rk[0] = hot
    lc = rng.integers(0, 4, n)
    lc[is_hot] = 1
    rc = rng.integers(0, 4, n)
    rc[0] = 1
    rvalid = np.ones(n, bool)
    rvalid[0] = False
    return {"mv": mv, "hot": hot, "lk": lk, "rk": rk,
            "a": rng.integers(0, mv, n), "b": rng.integers(0, mv, n),
            "lc": lc, "rc": rc, "lvalid": ~is_hot, "rvalid": rvalid}


def skew_small_world(ct, d: dict, w: int, device=None) -> dict:
    """Every check of skew_small at world size ``w`` (module docstring);
    returns the plans' summaries by case."""
    from cylon_tpu_torch import config as pconfig
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.relational import skew
    from cylon_tpu_torch.utils import timing
    env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
    n, mv = len(d["lk"]), d["mv"]
    plans = {}

    def run(label, fn):
        """The join under the split, then unsplit (the port's switch off):
        the same rows in the same order; the plan set exactly when
        W > 1; a materialized output on the even layout."""
        skew.record_plan(None)
        out = fn()
        plan = skew.last_plan()
        if (plan is not None) != (w > 1):
            raise AssertionError(f"{label}: plan {plan} at W = {w}")
        if plan is not None:
            plans[label] = plan.summary()
            if not np.array_equal(out.valid_counts,
                                  even_counts(out.row_count, w)):
                raise AssertionError(f"{label}: valid counts "
                                     f"{out.valid_counts} not even")
            if out.grouped_by is not None:
                raise AssertionError(f"{label}: grouped_by {out.grouped_by}")
        got = out.to_pydict()
        pconfig.SKEW_SPLIT = False
        try:
            plain = fn().to_pydict()
        finally:
            pconfig.SKEW_SPLIT = True
        same_rows(got, plain, f"{label} against the unsplit plan")
        return out

    def keyed(k, valid, dtype, **cols):
        key = ct.Column.from_numpy(k.astype(dtype))
        key = ct.Column(key.data, key.type, valid, key.dictionary,
                        bounds=key.bounds)
        return ct.Table.from_host_columns(
            {"k": key, **{c: ct.Column.from_numpy(v)
                          for c, v in cols.items()}}, env)

    lt = ct.Table.from_pydict({"k": d["lk"], "a": d["a"]}, env)
    rt = ct.Table.from_pydict({"k": d["rk"], "b": d["b"]}, env)
    for how in JOIN_HOWS:
        label = f"skew_small W={w} {how}"
        if how == "right":
            # the probe of a right join is its right table
            out = run(label, lambda: ct.join_tables(rt, lt, "k", "k",
                                                    how="right"))
            orc = how_oracle(d["rk"], d["b"], d["lk"], d["a"], mv, "right")
            orc = {"rows": orc["rows"], "sa": orc["sb"], "ca": orc["cb"],
                   "sb": orc["sa"], "cb": orc["ca"]}
        else:
            out = run(label, lambda: ct.join_tables(lt, rt, "k", "k",
                                                    how=how))
            orc = how_oracle(d["lk"], d["a"], d["rk"], d["b"], mv, how)
        check_join(out, orc, label)
        del out

    # a two-column key, a float64 key, a heavy NULL key, a string key
    lt2 = ct.Table.from_pydict({"k": d["lk"], "c": d["lc"], "a": d["a"]},
                               env)
    rt2 = ct.Table.from_pydict({"k": d["rk"], "c": d["rc"], "b": d["b"]},
                               env)
    label = f"skew_small W={w} two-column key"
    out = run(label, lambda: ct.join_tables(lt2, rt2, ["k", "c"], ["k", "c"],
                                            how="inner"))
    check_join(out, how_oracle(d["lk"] * 4 + d["lc"], d["a"],
                               d["rk"] * 4 + d["rc"], d["b"], mv * 4,
                               "inner"), label, second="c")
    del lt2, rt2, out
    ltf = keyed(d["lk"], None, np.float64, a=d["a"])
    rtf = keyed(d["rk"], None, np.float64, b=d["b"])
    label = f"skew_small W={w} float64 key"
    out = run(label, lambda: ct.join_tables(ltf, rtf, "k", "k", how="left"))
    check_join(out, how_oracle(d["lk"], d["a"], d["rk"], d["b"], mv, "left"),
               label, kid=out.host_columns()["k"][0].astype(np.int64))
    del ltf, rtf, out
    ltn = keyed(d["lk"], d["lvalid"], np.int64, a=d["a"])
    rtn = keyed(d["rk"], d["rvalid"], np.int64, b=d["b"])
    label = f"skew_small W={w} heavy NULL key"
    out = run(label, lambda: ct.join_tables(ltn, rtn, "k", "k",
                                            how="inner"))
    check_join(out, how_oracle(np.where(d["lvalid"], d["lk"], mv), d["a"],
                               np.where(d["rvalid"], d["rk"], mv), d["b"],
                               mv + 1, "inner"), label)
    if w > 1 and plans[label]["rows_probe"] != [int((~d["lvalid"]).sum())]:
        raise AssertionError(f"{label}: plan {plans[label]}")
    del ltn, rtn, out
    lts = ct.Table.from_host_columns(
        {"k": d["lnames"], "a": ct.Column.from_numpy(d["a"])}, env)
    rts = ct.Table.from_host_columns(
        {"k": d["rnames"], "b": ct.Column.from_numpy(d["b"])}, env)
    label = f"skew_small W={w} string key"
    out = run(label, lambda: ct.join_tables(lts, rts, "k", "k", how="outer"))
    names = np.asarray(out.to_pydict()["k"], dtype=str)
    check_join(out, how_oracle(d["lk"], d["a"], d["rk"], d["b"], mv,
                               "outer"),
               label, kid=np.char.lstrip(names, "key").astype(np.int64))
    del lts, rts, out, names

    # the fused join -> groupby-sum (the heavy partials combine) and a
    # min/max groupby that declines the pushdown (the split layout taken
    # unstitched)
    orc = how_oracle(d["lk"], d["a"], d["rk"], d["b"], mv, "inner")
    timing.reset()
    skew.record_plan(None)
    g = ct.groupby_aggregate(ct.join_tables(lt, rt, "k", "k"), "k",
                             [("a", "sum"), ("b", "sum")])
    check_join_sums(g, orc, f"skew_small W={w} fused groupby")
    combined = timing.counts().get("skew.partial_combine", 0)
    if combined != int(w > 1) or (skew.last_plan() is None) == (w > 1):
        raise AssertionError(f"skew_small W={w} fused groupby: "
                             f"{combined} heavy-partial combines")
    timing.reset()
    g = ct.groupby_aggregate(ct.join_tables(lt, rt, "k", "k"), "k",
                             [("a", "min"), ("a", "max"), ("b", "sum")])
    host = g.host_columns()
    keys = np.nonzero(orc["rows"] > 0)[0]
    order = stable_order(host["k"][0])
    amin = np.full(mv, np.iinfo(np.int64).max)
    amax = np.full(mv, np.iinfo(np.int64).min)
    np.minimum.at(amin, d["lk"], d["a"])
    np.maximum.at(amax, d["lk"], d["a"])
    if not (np.array_equal(host["k"][0][order], keys)
            and np.array_equal(host["a_min"][0][order], amin[keys])
            and np.array_equal(host["a_max"][0][order], amax[keys])
            and np.array_equal(host["b_sum"][0][order], orc["sb"][keys])):
        raise AssertionError(f"skew_small W={w} min/max groupby differs "
                             "from the oracle")
    elided = timing.counts().get("skew.stitch_elided", 0)
    if elided != int(w > 1) or "join.skew_stitch" in timing.counts():
        raise AssertionError(f"skew_small W={w} min/max groupby: stitch "
                             f"elided {elided} times")
    del g, host

    # the replication guard: the build side heavy on the same key (70% of
    # its 2,000 rows, so that W times them passes twice the build at
    # W >= 3) keeps the hash plan; the broadcast route off and the
    # guard's row floor lowered so that this size reaches it
    nb = 2000
    rkg = d["rk"][:nb].copy()
    rkg[: int(0.7 * nb)] = d["hot"]
    rtg = ct.Table.from_pydict({"k": rkg, "b": d["b"][:nb]}, env)
    saved = (pconfig.BROADCAST_JOIN_ROWS, pconfig.SKEW_GUARD_ROWS)
    pconfig.BROADCAST_JOIN_ROWS, pconfig.SKEW_GUARD_ROWS = 0, 128
    try:
        skew.record_plan(None)
        timing.reset()
        g = ct.groupby_aggregate(ct.join_tables(lt, rtg, "k", "k"), "k",
                                 [("a", "sum"), ("b", "sum")])
    finally:
        pconfig.BROADCAST_JOIN_ROWS, pconfig.SKEW_GUARD_ROWS = saved
    check_join_sums(g, how_oracle(d["lk"], d["a"], rkg, d["b"][:nb], mv,
                                  "inner"),
                    f"skew_small W={w} replication guard")
    if skew.last_plan() is not None \
            or "join.skew_split" in timing.counts():
        raise AssertionError(f"skew_small W={w}: the guard let a heavy "
                             "build key split")
    return {"world": w, "rows_per_side": n, "plans": plans,
            "cases": list(plans) if w > 1 else "route off at W = 1"}


def skew_small(ct, worlds=(1, 3, 4, 8), n: int = 1_000_000,
               device=None) -> list:
    """The skew split's cases at every world size, each against numpy."""
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    d = skew_small_inputs(n)
    # the string keys' host columns (sorted dictionaries), built once
    for side in "lr":
        d[f"{side}names"] = ct.Column.from_numpy(
            np.char.add("key", d[f"{side}k"].astype(str)))
    recs = []
    for w in worlds:
        wg.reset_counts()
        sp.reset_counts()
        rec = skew_small_world(ct, d, w, device)
        rec["kernel_counts"] = {"windowed_gather": dict(wg.COUNTS),
                                "splitter_probe": dict(sp.COUNTS)}
        recs.append(rec)
    return recs


def skew_path(ct, n: int = SKEW_ROWS, device=None,
              profile: bool = True) -> dict:
    """BASELINE configuration 5 at W = 4: bench.py's ``--skew=0.9`` tables
    at ``n`` rows per side through ``join_tables`` -> ``groupby_aggregate
    ("k", sum)``, the fused pushdown with the heavy partials combined;
    best of 3 after a warm-up, phase split, profile, K1/K2 launches and
    the fused pushdown's group densities; the split exchange's probe
    shards; the materialized inner join with its stitch timed; the same
    query unsplit (the port's switch off), at the largest size the card
    takes; everything against the join -> groupby oracle."""
    from cylon_tpu_torch import config as pconfig
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.ops import windowed_gather as wg
    from cylon_tpu_torch.relational import fused
    from cylon_tpu_torch.relational import join as pjoin
    from cylon_tpu_torch.relational import skew
    from cylon_tpu_torch.utils import timing
    w = 4
    t0 = time.perf_counter()
    left, right, mv, hot = skew_inputs(n)
    orc = how_oracle(left["k"], left["a"], right["k"], right["b"], mv,
                     "inner")
    gen_s = time.perf_counter() - t0
    env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
    t0 = time.perf_counter()
    lt = ct.Table.from_pydict(left, env)
    rt = ct.Table.from_pydict(right, env)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    steps = []

    def query(times):
        g = step(ct, lt, rt, steps)
        times.append(steps[-1]["total_s"])
        return g

    # the split exchange alone: the plan and the probe's shards after it
    lsh, rsh, plan = pjoin._shuffle_for_join(lt, rt, ["k"], ["k"], "inner",
                                             env)
    if not isinstance(plan, skew.SkewPlan):
        raise AssertionError(f"skew_path: no plan voted ({plan})")
    probe_shards = [int(c) for c in lsh.valid_counts]
    mean = float(np.mean(probe_shards))
    if max(probe_shards) > 1.25 * mean:
        raise AssertionError(f"skew_path: probe shards {probe_shards} after "
                             "the split exchange exceed 1.25x their mean")
    del lsh, rsh
    dens, gate = [], fused._win_size

    def recording(env_, sc, d_):
        dens.append(d_)
        return gate(env_, sc, d_)

    fused._SEG_CACHE.clear()
    fused._win_size = recording
    try:
        rec = timed_path("skew_path", query,
                         lambda g, label: check_join_sums(g, orc, label),
                         SKEW_PHASES, profile=profile)
    finally:
        fused._win_size = gate
    # the fifth run is timed_path's split run: its groupby is the fused
    # pushdown plus the heavy-partial combine
    rec["phase_split_s"]["fused_groupby"] = (
        steps[4]["groupby_s"]
        - rec["phase_split_regions_s"].get("skew.partial_combine", 0.0))
    rec["phase_split_s"]["rest"] = rec["phase_split_total_s"] - sum(
        v for k_, v in rec["phase_split_s"].items() if k_ != "rest")
    if skew.last_plan() is None:
        raise AssertionError("skew_path: the timed runs took no plan")
    rec.update({"phase": "skew_path", "world": w, "rows_per_side": n,
                "skew": SKEW_SHARE, "hot_key": hot, "gen_s": gen_s,
                "setup_s": setup_s, "rows_per_s": 2 * n / rec["best_s"],
                "plan": plan.summary(), "probe_shards": probe_shards,
                "probe_shard_max_over_mean": max(probe_shards) / mean,
                "group_densities_seen": dens,
                "k1_min_density": wg.MIN_DENSITY,
                "join_rows": int(orc["rows"].sum())})

    # the materialized inner join, its stitch timed (one stitch)
    torch.cuda.empty_cache()
    timing.enable("block")
    timing.reset()
    t0 = time.perf_counter()
    j = ct.join_tables(lt, rt, "k", "k", how="inner", allow_defer=False)
    t1 = time.perf_counter()
    _ = j.column("k")                       # the first access stitches
    sync_pull(j.column("k").data)
    t2 = time.perf_counter()
    regions = timing.snapshot()
    timing.enable(None)
    check_join(j, orc, "skew_path materialized join")
    if not np.array_equal(j.valid_counts, even_counts(j.row_count, w)):
        raise AssertionError(f"skew_path: stitched counts {j.valid_counts}")
    rec["stitch"] = {
        "join_s": t1 - t0, "stitch_s": t2 - t1,
        "regions_s": {r: regions.get(r, 0.0) for r in (
            "skew.stitch_count", "skew.stitch_pos", "skew.stitch_place",
            "place.targets", "place.exchange", "place.sort")},
        "valid_counts": [int(c) for c in j.valid_counts],
        "rows_per_s": int(j.row_count) / (t2 - t1)}
    del j
    torch.cuda.empty_cache()

    # the unsplit leg: the same query with the port's switch off, at the
    # largest size the card takes (halving on a device refusal)
    refusals, size = [], n
    pconfig.SKEW_SPLIT = False
    try:
        while True:
            try:
                if size == n:
                    ul, ur, uorc = lt, rt, orc
                else:
                    sl, sr, smv, _ = skew_inputs(size)
                    uorc = how_oracle(sl["k"], sl["a"], sr["k"], sr["b"],
                                      smv, "inner")
                    ul = ct.Table.from_pydict(sl, env)
                    ur = ct.Table.from_pydict(sr, env)
                utimes = []
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                for _ in range(2):          # a warm-up, then one timed
                    t0 = time.perf_counter()
                    g = step(ct, ul, ur)
                    utimes.append(time.perf_counter() - t0)
                check_join_sums(g, uorc, "skew_path unsplit")
                peak = torch.cuda.max_memory_allocated()
                # the hash plan's probe shards, for the record
                lsh, _, _ = pjoin._shuffle_for_join(ul, ur, ["k"], ["k"],
                                                    "inner", env)
                unsplit_shards = [int(c) for c in lsh.valid_counts]
                del lsh
                break
            except (torch.cuda.OutOfMemoryError, NotImplementedError) as e:
                refusals.append({"rows_per_side": size,
                                 "error": f"{type(e).__name__}: "
                                          f"{str(e)[:300]}"})
                g = ul = ur = None
                torch.cuda.empty_cache()
                size //= 2
                if size < 1_000_000:
                    raise
    finally:
        pconfig.SKEW_SPLIT = True
    torch.cuda.reset_peak_memory_stats()
    del g, ul, ur
    rec["unsplit"] = {"rows_per_side": size, "refusals": refusals,
                      "probe_shards": unsplit_shards,
                      "iterations": utimes, "best_s": utimes[-1],
                      "rows_per_s": 2 * size / utimes[-1],
                      "peak_mem_bytes": peak, "oracle": "equal"}
    del lt, rt, env
    torch.cuda.empty_cache()
    return rec


#: TPC-H's scale of tpch_small and tpch_path (BASELINE configuration 4)
TPCH_SMALL_SCALE = 0.05
#: SF 5 since PR 13 (SF 10 before): the cut that keeps chip_smoke.py
#: inside its time with the serving phases on these tables
TPCH_SCALE = 5.0
TPCH_QUERIES = ("q1", "q3", "q4", "q5", "q6", "q7", "q8", "q9", "q10",
                "q11", "q12", "q13", "q14", "q15", "q16", "q17", "q18",
                "q19", "q20", "q21", "q22")
TPCH_PATH_QUERIES = ("q1", "q3", "q5", "q6")


def tpch_columns(x) -> dict:
    """A TPC-H result's columns as numpy arrays, dates as int64
    nanoseconds: a result frame's, or an oracle's dict as it is."""
    cols = x if isinstance(x, dict) else x.to_pydict()
    out = {}
    for name, c in cols.items():
        c = np.asarray(c)
        if c.dtype.kind == "M":
            c = c.astype("datetime64[ns]").astype(np.int64)
        out[name] = c
    return out


def same_tpch(got, want, label: str, scales=None) -> int:
    """A TPC-H result against the expected one (the same query on the CPU,
    or :func:`tpch_oracle`'s columns): the same columns in the same order,
    integer, date and string columns equal, float columns to rtol 1e-9
    plus atol ``64·eps·S``.  ``S`` is ``scales[name]`` where given (Σ|e|
    over the terms the column sums, for a column whose terms may differ
    in sign), else Σ|y| over the expected column itself: every other
    float column of the 21 queries is a value passed through, or a sum,
    mean or ratio of sums of terms of one sign, so Σ|y| is what its
    values aggregate.  Returns the result's rows."""
    eps64 = np.finfo(np.float64).eps
    scales = scales or {}
    if isinstance(want, float):
        if not abs(got - want) <= (1e-9 + 64 * eps64) * abs(want):
            raise AssertionError(f"{label}: {got} != {want}")
        return 1
    g, w_ = tpch_columns(got), tpch_columns(want)
    if list(g) != list(w_):
        raise AssertionError(f"{label}: columns {list(g)} != {list(w_)}")
    for name, y in w_.items():
        x = g[name]
        if x.shape != y.shape:
            raise AssertionError(f"{label}: {name} has {x.shape} rows, "
                                 f"expected {y.shape}")
        if y.dtype.kind == "f":
            s = scales.get(name, float(np.abs(y).sum()))
            ok = np.allclose(x, y, rtol=1e-9, atol=64 * eps64 * s,
                             equal_nan=True)
        else:
            ok = bool(np.all(x == y))
        if not ok:
            raise AssertionError(f"{label}: column {name} differs")
    return len(next(iter(w_.values()), ()))


def q9_profit_scale(cols: dict) -> float:
    """Σ|amount| over every lineitem row, an upper bound of the terms any
    Q9 group sums (amount = l_extendedprice·(1 − l_discount) −
    ps_supplycost·l_quantity may take either sign)."""
    li, ps = cols["lineitem"], cols["partsupp"]
    q = np.asarray(li["l_quantity"].data, np.float64)
    return float((np.asarray(li["l_extendedprice"].data)
                  * (1.0 - np.asarray(li["l_discount"].data))).sum()
                 + np.asarray(ps["ps_supplycost"].data).max() * q.sum())


def tpch_small(ct, worlds=(1, 4, 8), scale: float = TPCH_SMALL_SCALE,
               device=None) -> list:
    """All 21 TPC-H queries at ``scale`` on the card at each world size,
    each held against the same query of the port on the CPU at W = 1 on
    the same generated tables (computed once: every query's answer is
    the same at every world, which tests/test_torch_tpch.py holds against
    the reference); K1/K2 launches per query."""
    from cylon_tpu_torch import tpch
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    scales = {"q9": {"sum_profit": q9_profit_scale(
        tpch.generate_columns(scale, 0))}}
    cenv = ct.CylonEnv(device="cpu")
    cdfs = tpch.generate_tables(scale, cenv, 0)
    wants: dict = {}
    recs = []
    for w in worlds:
        env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
        dfs = tpch.generate_tables(scale, env, 0)
        launches, rows, card_s = {}, {}, {}
        for q in TPCH_QUERIES:
            wg.reset_counts()
            sp.reset_counts()
            t0 = time.perf_counter()
            got = getattr(tpch, q)(dfs, env=env)
            if not isinstance(got, float):
                sync_pull(got.table.column(got.table.column_names[0]).data)
            card_s[q] = time.perf_counter() - t0
            launches[q] = {"windowed_gather": wg.COUNTS["launches"],
                           "splitter_probe": sp.COUNTS["launches"]}
            if q not in wants:
                wants[q] = getattr(tpch, q)(cdfs, env=cenv)
            same_tpch(got, wants[q], f"tpch_small W={w} {q}", scales.get(q))
            rows[q] = None if isinstance(got, float) else got.table.row_count
        recs.append({"phase": "tpch_small", "world": w, "scale": scale,
                     "queries": len(TPCH_QUERIES), "oracle": "equal",
                     "against": "the port on the CPU at W = 1",
                     "result_rows": rows,
                     "card_first_s": card_s, "kernel_launches": launches})
        del dfs, env
    return recs


def tpch_oracle(cols: dict) -> dict:
    """Q1, Q3, Q5 and Q6 in numpy over the generated host columns; the
    keys c_custkey, o_orderkey, s_suppkey and n_nationkey are aranges, so
    every join is an index lookup and every group an ``np.unique``."""
    from cylon_tpu_torch import tpch

    def h(table, name):
        return np.asarray(cols[table][name].data)

    def strings(table, name, value):
        c = cols[table][name]
        return int(np.searchsorted(c.dictionary, value))

    li = {n: h("lineitem", n) for n in (
        "l_orderkey", "l_suppkey", "l_quantity", "l_extendedprice",
        "l_discount", "l_tax", "l_returnflag", "l_linestatus",
        "l_shipdate")}
    out = {}
    # Q1
    m = li["l_shipdate"] <= tpch._ts("1998-09-02")
    rf_d = cols["lineitem"]["l_returnflag"].dictionary
    ls_d = cols["lineitem"]["l_linestatus"].dictionary
    gid = li["l_returnflag"][m].astype(np.int64) * len(ls_d) \
        + li["l_linestatus"][m]
    u, inv = np.unique(gid, return_inverse=True)
    price, disc = li["l_extendedprice"][m], li["l_discount"][m]
    dp = price * (1.0 - disc)
    cnt = np.bincount(inv)
    out["q1"] = {
        "l_returnflag": rf_d[u // len(ls_d)].astype(str),
        "l_linestatus": ls_d[u % len(ls_d)].astype(str),
        "l_quantity_sum": np.bincount(inv, li["l_quantity"][m]),
        "l_extendedprice_sum": np.bincount(inv, price),
        "disc_price_sum": np.bincount(inv, dp),
        "charge_sum": np.bincount(inv, dp * (1.0 + li["l_tax"][m])),
        "l_quantity_mean": np.bincount(inv, li["l_quantity"][m]) / cnt,
        "l_extendedprice_mean": np.bincount(inv, price) / cnt,
        "l_discount_mean": np.bincount(inv, disc) / cnt,
        "l_orderkey_count": cnt}
    # Q6
    lo, hi = tpch._ts("1994-01-01"), tpch._ts("1995-01-01")
    m = ((li["l_shipdate"] >= lo) & (li["l_shipdate"] < hi)
         & (li["l_discount"] >= 0.06 - 0.011)
         & (li["l_discount"] <= 0.06 + 0.011) & (li["l_quantity"] < 24))
    out["q6"] = float((li["l_extendedprice"][m] * li["l_discount"][m]).sum())
    # Q3
    t = tpch._ts("1995-03-15")
    odate, ocust = h("orders", "o_orderdate"), h("orders", "o_custkey")
    seg = h("customer", "c_mktsegment") == strings(
        "customer", "c_mktsegment", "BUILDING")
    okeep = seg[ocust] & (odate < t)
    m = okeep[li["l_orderkey"]] & (li["l_shipdate"] > t)
    rev = np.bincount(li["l_orderkey"][m],
                      (li["l_extendedprice"] * (1.0 - li["l_discount"]))[m],
                      minlength=len(odate))
    has = np.bincount(li["l_orderkey"][m], minlength=len(odate)) > 0
    keys = np.nonzero(has)[0]
    top = keys[np.lexsort((odate[keys], -rev[keys]))][:10]
    out["q3"] = {"l_orderkey": top, "revenue": rev[top],
                 "o_orderdate": odate[top],
                 "o_shippriority": h("orders", "o_shippriority")[top]}
    # Q5
    lo, hi = tpch._ts("1994-01-01"), tpch._ts("1995-01-01")
    asia = strings("region", "r_name", "ASIA")
    nat_in = h("nation", "n_regionkey") == h("region", "r_regionkey")[
        h("region", "r_name") == asia][0]
    o = li["l_orderkey"]
    cn = h("customer", "c_nationkey")[ocust[o]]
    sn = h("supplier", "s_nationkey")[li["l_suppkey"]]
    m = (odate[o] >= lo) & (odate[o] < hi) & (cn == sn) & nat_in[sn]
    rev = np.bincount(sn[m], (li["l_extendedprice"]
                              * (1.0 - li["l_discount"]))[m], minlength=25)
    nk = np.nonzero(np.bincount(sn[m], minlength=25) > 0)[0]
    nk = nk[stable_order(-rev[nk])]
    nd = cols["nation"]["n_name"].dictionary
    out["q5"] = {"n_name": nd[h("nation", "n_name")[nk]].astype(str),
                 "revenue": rev[nk]}
    return out


class TpchTables:
    """TPC-H's host columns drawn in a background process while earlier
    phases run (``--tpch-gen``: ``tpch.generate_columns(scale, 0)``,
    pickled into a fresh temporary directory, which :meth:`close`
    removes): ``tpch_path`` loads them instead of drawing them, and
    ``procs_serve``'s children load the same file."""

    def __init__(self, scale: float):
        import os
        import tempfile
        self.dir = tempfile.mkdtemp(prefix="cylon_tpch_")
        self.path = os.path.join(self.dir, "tables.pkl")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tpch-gen",
             json.dumps({"scale": scale, "path": self.path})],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.record: dict | None = None

    def wait(self) -> str:
        """The pickled tables' path, once the drawing process ended."""
        if self.record is None:
            so, se = self.proc.communicate(timeout=900)
            if self.proc.returncode != 0:
                raise AssertionError(f"TPC-H generation exited "
                                     f"{self.proc.returncode}\n{se[-4000:]}")
            self.record = json.loads(so.splitlines()[-1])
        return self.path

    def load(self) -> dict:
        import pickle
        with open(self.wait(), "rb") as f:
            return pickle.load(f)

    def close(self) -> None:
        import shutil
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def tpch_gen_child(spec: dict) -> int:
    """``--tpch-gen``: draw TPC-H at ``spec["scale"]`` (seed 0) at a low
    CPU priority and pickle it to ``spec["path"]`` (through a temporary
    file and a rename); prints the seconds."""
    import os
    import pickle
    from cylon_tpu_torch import tpch
    os.nice(10)
    t0 = time.perf_counter()
    cols = tpch.generate_columns(spec["scale"], 0)
    gen_s = time.perf_counter() - t0
    tmp = spec["path"] + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(cols, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, spec["path"])
    print(json.dumps({"gen_s": gen_s, "write_s": time.perf_counter() - t0
                      - gen_s, "bytes": os.path.getsize(spec["path"])}),
          flush=True)
    return 0


def tpch_path(ct, scale: float = TPCH_SCALE, device=None,
              profile: bool = True, serve_root: str | None = None,
              world: int = 8, tables: TpchTables | None = None):
    """BASELINE configuration 4: TPC-H at ``scale`` on a W = 8 world, Q3
    and Q5 with the scans Q1 and Q6, each best of 3 after a warm-up with
    its peak memory, phase split, profile (idle share) and K1/K2
    launches, against a numpy oracle; yields one record per query.  With
    ``serve_root``, :func:`serve_path` runs next on the same tables (its
    checkpoints under that root) and yields its records.  ``tables``: the
    columns drawn in the background (:class:`TpchTables`); ``gen_s`` is
    then the wait and the load."""
    from cylon_tpu_torch import tpch
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    w = world
    t0 = time.perf_counter()
    cols = tpch.generate_columns(scale, 0) if tables is None \
        else tables.load()
    gen_s = time.perf_counter() - t0
    background = None if tables is None else tables.record
    env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
    t0 = time.perf_counter()
    dfs = {name: ct.DataFrame(ct.Table.from_host_columns(c, env))
           for name, c in cols.items()}
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    orc = tpch_oracle(cols)
    if serve_root is not None:
        orc["qpipe"] = qpipe_oracle(cols)
    rows = {name: int(c[next(iter(c))].data.shape[0])
            for name, c in cols.items()}
    del cols
    for q in TPCH_PATH_QUERIES:
        def query(times, q=q):
            t0 = time.perf_counter()
            out = getattr(tpch, q)(dfs, env=env)
            if not isinstance(out, float):
                sync_pull(out.table.column(out.table.column_names[0]).data)
            times.append(time.perf_counter() - t0)
            return out

        rec = timed_path(f"tpch_path {q}", query,
                         lambda out, label, q=q: same_tpch(
                             out, orc[q], label),
                         {"join_shuffle": "join.shuffle",
                          "join_sort_count": "join.sort_count",
                          "join_materialize": "join.materialize",
                          "groupby_raw": "groupby.raw",
                          "groupby_combine": "groupby.combine",
                          "groupby_shuffle": "groupby.shuffle",
                          "groupby_final": "groupby.final",
                          "sort_sample": "sort.sample",
                          "sort_exchange": "sort.exchange",
                          "sort_local": "sort.local",
                          "semi": "join.semi"}, profile=profile)
        rec.update({"phase": "tpch_path", "query": q, "world": w,
                    "scale": scale, "table_rows": rows, "gen_s": gen_s,
                    "drawn_in_background": background,
                    "upload_s": upload_s, "setup_s": gen_s + upload_s,
                    "lineitem_rows_per_s": rows["lineitem"] / rec["best_s"]})
        yield rec
    for rec in tpch_sentinel(dfs, env, orc):
        rec.update({"scale": scale, "table_rows": rows})
        yield rec
    if serve_root is not None:
        for rec in serve_path(ct, dfs, env, orc, rows, serve_root):
            rec.update({"scale": scale, "table_rows": rows})
            yield rec
        rec = stream_serve(ct, dfs, env)
        rec.update({"scale": scale, "table_rows": rows})
        yield rec
    del dfs, env
    torch.cuda.empty_cache()


def tpch_sentinel(dfs, env, orc: dict):
    """Q3 and Q5 on ``tpch_path``'s tables and world, once unarmed and
    once with the runtime sentinel armed: the armed answer's digest equal
    to the unarmed one's (and to the oracle), the funnel's pulls and the
    stray syncs by site.  Yields one record per query."""
    from cylon_tpu_torch import tpch
    for q in ("q3", "q5"):
        query = getattr(tpch, q)
        t0 = time.perf_counter()
        out = query(dfs, env=env)
        wait_result(out)
        unarmed_s = time.perf_counter() - t0
        want = serve_digest(out)
        del out
        with sentinel_armed(env.on_cuda) as (pulls, syncs):
            t0 = time.perf_counter()
            out = query(dfs, env=env)
            wait_result(out)
            armed_s = time.perf_counter() - t0
        same_tpch(out, orc[q], f"tpch_sentinel {q}")
        got = serve_digest(out)
        if got != want:
            raise AssertionError(f"tpch_sentinel {q}: armed digest {got}, "
                                 f"unarmed {want}")
        del out
        yield {"phase": "tpch_sentinel", "query": q,
               "world": env.world_size, "unarmed_s": unarmed_s,
               "armed_s": armed_s, "digest": got,
               "oracle": "armed digest equal to unarmed; equal to numpy",
               **sentinel_counts(pulls, syncs)}


# ---------------------------------------------------------------------------
# recovery: the spill tiers, the retry ladder and a real device OOM
# ---------------------------------------------------------------------------

#: oom_path's rows per side: the monolithic join → groupby peaks at 31.2
#: GB at 125,000,000 rows a side on the card (PERF.md §2), about 100 GB
#: at 3·2^27 rows, past the card's 80 GB; the tables are 12.9 GB
OOM_ROWS = 402_653_184
#: regions of the spilled pipelined route's phase split
SPILL_PHASES = {"shuffle": "join.shuffle", "build_sort": "pipe.build_sort",
                "bounds": "pipe.bounds", "targets": "pipe.targets",
                "probe_sort": "pipe.probe_sort",
                "phase_sync": "pipe.phase_sync", "pack": "pipe.pack",
                "evict": "spill.evict", "upload": "spill.upload",
                "piece_join": "pipe.piece_join", "consume": "pipe.consume"}


@contextlib.contextmanager
def knobs(**values):
    """Set ``cylon_tpu_torch.config`` values for the block."""
    from cylon_tpu_torch import config as pconfig
    old = {k: getattr(pconfig, k) for k in values}
    for k, v in values.items():
        setattr(pconfig, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(pconfig, k, v)


def recovery_events() -> list:
    """The recovery events recorded since the last drain, as (site, kind,
    action) triples, and drain them."""
    from cylon_tpu_torch.exec import recovery
    return [(e["site"], e["kind"], e["action"])
            for e in recovery.drain_events()]


def no_recovery(label: str) -> None:
    """Fail when anything was retried: outside oom_path and the injected
    cases a recovery event is a fault."""
    ev = recovery_events()
    if ev:
        raise AssertionError(f"{label}: recovery events {ev}")


def same_tables(a, b, label: str) -> None:
    """Two tables' live rows equal bit for bit, per shard, validity
    included."""
    if not np.array_equal(np.asarray(a.valid_counts),
                          np.asarray(b.valid_counts)):
        raise AssertionError(f"{label}: shard counts differ")
    ha, hb = a.host_columns(), b.host_columns()
    if list(ha) != list(hb):
        raise AssertionError(f"{label}: columns differ")
    for name in ha:
        (da, va), (db, vb) = ha[name], hb[name]
        if da.dtype != db.dtype or not np.array_equal(da, db) \
                or (va is None) != (vb is None) \
                or (va is not None and not np.array_equal(va, vb)):
            raise AssertionError(f"{label}: column {name} differs")


def spill_pages(root: str) -> list:
    import glob
    import os
    return glob.glob(os.path.join(root, "**", "*.spill.npy"), recursive=True)


def recovery_small(ct, worlds=(1, 3, 4, 8), n: int = 1_000_000,
                   device=None) -> list:
    """The spill tiers and the retry ladder at ``n`` rows a side, at each
    of ``worlds`` (module docstring), each result against numpy and every
    spilled run equal to the same run unspilled."""
    import gc
    import tempfile
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.exec import memory, recovery
    from cylon_tpu_torch.relational.piece import PieceSource
    from cylon_tpu_torch.status import RankDesyncError
    left, right, mv = baseline_inputs(n, seed=31)
    hows = ("inner", "left", "outer")
    orcs = {h: how_oracle(left["k"], left["a"], right["k"], right["b"], mv,
                          h) for h in hows}
    subtract = np.setdiff1d(left["k"], right["k"])
    recs = []
    for w in worlds:
        env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
        lt = ct.Table.from_pydict(left, env)
        rt = ct.Table.from_pydict(right, env)
        lk = ct.Table.from_pydict({"k": left["k"]}, env)
        rk = ct.Table.from_pydict({"k": right["k"]}, env)
        tag = f"recovery_small W={w}"

        def joins():
            out = {}
            for how in hows:
                out[how] = ct.pipelined_join(lt, rt, "k", "k", how=how,
                                             n_chunks=3)
                sink = ct.GroupBySink("k", [("a", "sum"), ("b", "sum")])
                ct.pipelined_join(lt, rt, "k", "k", how=how, n_chunks=3,
                                  sink=sink)
                out[how + "_sink"] = sink.finalize()
            out["subtract"] = ct.pipelined_set_op(lk, rk, "subtract",
                                                  n_chunks=3)
            return out

        def check(out, label):
            for how in hows:
                check_join(out[how], orcs[how], f"{label} {how}")
                check_join_sums(out[how + "_sink"], orcs[how],
                                f"{label} {how} sink")
            if not np.array_equal(np.sort(out["subtract"].to_pydict()["k"]),
                                  subtract):
                raise AssertionError(f"{label} subtract differs")

        gc.collect()
        base = joins()
        check(base, tag)
        no_recovery(tag)
        rec = {"phase": "recovery_small", "world": w, "rows_per_side": n,
               "oracle": "equal"}

        def spilled(label, **kn):
            gc.collect()
            memory.reset_stats()
            with knobs(**kn):
                out = joins()
            st = memory.stats()
            for name, t in out.items():
                same_tables(t, base[name], f"{label} {name}")
            no_recovery(label)
            if st["spill_events"] < 1 or st["bytes_readmitted"] < 1:
                raise AssertionError(f"{label}: nothing spilled ({st})")
            return st

        # forced eviction: every admission evicts the cold packed source
        st = spilled(f"{tag} evicted", HBM_BUDGET_BYTES=4096)
        rec["evicted"] = {k: st[k] for k in ("spill_events", "bytes_spilled",
                                              "readmit_events",
                                              "bytes_readmitted")}
        # the disk tier: host pages past a 4 KiB host budget go to disk
        with tempfile.TemporaryDirectory() as d:
            st = spilled(f"{tag} disk", HBM_BUDGET_BYTES=4096,
                         HOST_BUDGET_BYTES=4096, SPILL_DIR=d)
            if st["disk_pages_demoted"] < 1 or st["bytes_from_disk"] < 1:
                raise AssertionError(f"{tag} disk: no page round trip {st}")
            # a whole registration through every tier and back
            with knobs(HOST_BUDGET_BYTES=4096, SPILL_DIR=d):
                src = PieceSource(lt, 8)
                before = [a.cpu().numpy().tobytes() for a in src.arrs]
                memory.evict(src._reg)
                if memory.demote(src._reg) < 1:
                    raise AssertionError(f"{tag}: demotion wrote nothing")
                after = [a.cpu().numpy().tobytes()
                         for a in memory.readmit(src._reg)]
                if after != before:
                    raise AssertionError(f"{tag}: disk round trip differs")
                promoted = memory.stats()["disk_pages_promoted"]
                del src
            gc.collect()
            left_over = spill_pages(d)
            if left_over or promoted < 1:
                raise AssertionError(f"{tag}: pages left {left_over}, "
                                     f"promoted {promoted}")
            rec["disk"] = {k: st[k] for k in (
                "disk_pages_demoted", "bytes_to_disk", "bytes_from_disk",
                "disk_events")}
            rec["disk"]["pages_promoted_on_readmit"] = promoted
            rec["disk"]["pages_left"] = 0

        # injected faults: each case's events and its answer
        def injected(spec, expect, run, check_out=None, raises=None, **kn):
            gc.collect()
            recovery.install_faults(spec)
            try:
                with knobs(**kn):
                    if raises is None:
                        out = run()
                    else:
                        try:
                            run()
                        except raises as e:
                            out = e
                        else:
                            raise AssertionError(f"{tag} {spec}: no "
                                                 f"{raises.__name__}")
                ev = recovery_events()
            finally:
                recovery.install_faults("")
            if ev != expect:
                raise AssertionError(f"{tag} {spec}: events {ev}, expected "
                                     f"{expect}")
            if check_out is not None:
                check_out(out)
            return {"spec": spec, "events": ev}

        def join_groupby():
            return ct.groupby_aggregate(ct.join_tables(lt, rt, "k", "k"),
                                        "k", [("a", "sum"), ("b", "sum")])

        def sink_run(nc):
            sink = ct.GroupBySink("k", [("a", "sum"), ("b", "sum")])
            ct.pipelined_join(lt, rt, "k", "k", how="inner", n_chunks=nc,
                              sink=sink)
            return sink.finalize()

        def sums(label):
            return lambda g: check_join_sums(g, orcs["inner"], label)

        def at_upload(e):
            if e.site != "spill.upload":
                raise AssertionError(f"{tag}: the stall surfaced at {e.site}")

        cases = [
            injected("groupby.device_oom=device_oom",
                     [("groupby.device_oom", "device_oom", "injected"),
                      ("groupby", "device_oom", "retry_chunks_4")],
                     join_groupby, sums(f"{tag} groupby OOM")),
            injected("join.piece_cap=capacity",
                     [("join.piece_cap", "capacity", "injected"),
                      ("join", "capacity", "retry_chunks_8")],
                     lambda: recovery.run_with_recovery(
                         lambda: sink_run(4), True, sink_run, "join",
                         env=env), sums(f"{tag} piece cap")),
            injected("spill.upload=spill_stall",
                     [("spill.upload", "desync", "watchdog")],
                     lambda: sink_run(3), at_upload,
                     raises=RankDesyncError, HBM_BUDGET_BYTES=4096,
                     EXCHANGE_WATCHDOG_S=0.5),
            injected("groupby.device_oom=desync",
                     [("groupby.device_oom", "desync", "injected"),
                      ("groupby", "desync", "abort")],
                     join_groupby, raises=RankDesyncError)]
        if w > 1:
            # a predicted receive-guard fault with a spillable packed
            # source resident: the spill rung first, no chunk escalation
            aux = PieceSource(ct.Table.from_pydict(left, env), 8)
            cases.append(injected(
                "shuffle.recv_guard=predicted",
                [("join", "predicted", "spill_retry")], join_groupby,
                sums(f"{tag} spill rung")))
            if not aux.spilled:
                raise AssertionError(f"{tag}: the spill rung evicted "
                                     "nothing")
            del aux
        rec["injected"] = cases
        recs.append(rec)
        del lt, rt, lk, rk, base, env
        gc.collect()
        memory.reset_stats()
        torch.cuda.empty_cache()
    return recs


def stream_profile(run) -> dict:
    """One ``run()`` under torch.profiler, read from its trace's
    intervals: the device's busy time as the union of every kernel, copy
    and memset interval on any stream (a sum would count the side
    stream's uploads twice where they overlap kernels), and the
    host-to-device copies' device time with the part of it that
    overlapped kernels on other streams."""
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    evs = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    copies, kernels, busy = [], [], []
    for e in evs:
        cat, name = e.get("cat", ""), e.get("name", "")
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy",
                                             "gpu_memset"):
            continue
        iv = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
              (e.get("args") or {}).get("stream"))
        busy.append(iv)
        if cat == "gpu_memcpy" and "HtoD" in name:
            copies.append(iv)
        elif cat == "kernel":
            kernels.append(iv)

    def union(ivs):
        total, end = 0.0, float("-inf")
        for a, b, _ in sorted(ivs):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    overlap = sum(union([(max(ka, a), min(kb, b), None)
                         for ka, kb, ks in kernels
                         if ks != s and ka < b and kb > a])
                  for a, b, s in copies)
    total = sum(b - a for a, b, _ in copies)
    return {"device_busy_s": union(busy) / 1e6,
            "htod_copies": len(copies), "upload_device_ms": total / 1e3,
            "upload_overlapped_ms": overlap / 1e3,
            "upload_overlap_share": overlap / total if total else 0.0}


def spill_path(ct, left: dict, right: dict, orc: dict, device=None,
               profile: bool = True) -> dict:
    """``dist_pipelined_path``'s route (GroupBySink + pipelined_join) at
    W = 4 on ``left``/``right``, unspilled and then under a device budget
    that holds the piece loop's admissions less one side's packed
    source, so that source lives in pinned host memory through the whole
    piece loop and every one of its windows is uploaded.  Both best of 3
    after a warm-up, bit-equal to each other and to the oracle; the
    evicted and uploaded bytes, the upload's device time and its overlap
    with compute, and K1 and K2 held to their plain versions on the
    spilled route's first-launch inputs (shard 0)."""
    import gc
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.exec import memory
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    w = 4
    n = len(left["k"])
    nc = max(2, -(-(n // w) // PIECE_ROWS))
    env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
    lt, rt = ct.Table.from_pydict(left, env), ct.Table.from_pydict(right,
                                                                   env)

    def query(times):
        t0 = time.perf_counter()
        g = pipelined_step(ct, lt, rt, nc)
        times.append(time.perf_counter() - t0)
        return g

    def check(g, label):
        return check_dist(g, orc, w, label)

    gc.collect()
    plain = timed_path("spill_path unspilled", query, check, SPILL_PHASES,
                       profile=profile)
    no_recovery("spill_path unspilled")
    # the budget, from the ledger: the second admission's balance, less
    # the first packed source, plus the second source and its scratch
    calls, admit = [], memory.ensure_headroom

    def spy(env_, need, scratch=0, site="spill.evict"):
        calls.append((memory.balance(), int(need), int(scratch)))
        return admit(env_, need, scratch, site)

    memory.ensure_headroom = spy
    try:
        g_plain = query([])
    finally:
        memory.ensure_headroom = admit
    if len(calls) != 2:
        raise AssertionError(f"spill_path: admissions {calls}")
    (b0, need_l, scr), (b1, need_r, scr_r) = calls
    budget = b1 - need_l + need_r + scr_r
    depths, loop, depth_fn = [], [], memory.prefetch_depth

    def depth_spy(env_, pair):
        depths.append(depth_fn(env_, pair))
        loop.append((memory.balance(), int(pair)))
        return depths[-1]

    gc.collect()
    with knobs(HBM_BUDGET_BYTES=budget):
        memory.reset_stats()
        memory.prefetch_depth = depth_spy
        try:
            g_spill = query([])
        finally:
            memory.prefetch_depth = depth_fn
        st = memory.stats()
        log = memory.eviction_log()
        same_tables(g_spill, g_plain, "spill_path spilled vs unspilled")
        if st["spill_events"] != 1 or st["bytes_readmitted"] < 1 \
                or set(depths) != {1}:
            raise AssertionError(f"spill_path: one source must evict and "
                                 f"every window upload at prefetch depth "
                                 f"1 ({st}, {log}, {depths})")
        del g_spill
        gc.collect()
        spilled = timed_path("spill_path", query, check, SPILL_PHASES,
                             profile=profile)
        streams = stream_profile(lambda: query([])) if profile else None
        captured = {}
        with capturing(sp, "count_ge_splitters", captured, "probe"), \
                capturing(wg, "windowed_take_t", captured, "piece",
                          keep_k1):
            check_dist(query([]), orc, w, "spill_path capture run")
    no_recovery("spill_path")
    # the prefetch-ahead schedule: a budget that still evicts the first
    # source and holds two window pairs, so prefetch_depth is 2 and piece
    # r+1's windows upload before piece r joins
    two_pairs = max(b for b, _ in loop) + 2 * max(p for _, p in loop)
    if two_pairs >= b1 + need_r + scr_r:
        raise AssertionError(f"spill_path: a budget of two window pairs "
                             f"({two_pairs} B) would not evict")
    depths1 = list(depths)
    depths.clear()
    gc.collect()
    with knobs(HBM_BUDGET_BYTES=two_pairs):
        memory.reset_stats()
        memory.prefetch_depth = depth_spy
        try:
            g_two = query([])
        finally:
            memory.prefetch_depth = depth_fn
        depths2 = list(depths)
        st2 = memory.stats()
        same_tables(g_two, g_plain, "spill_path depth 2 vs unspilled")
        if st2["spill_events"] != 1 or set(depths2) != {2} \
                or st2["bytes_readmitted"] != st["bytes_readmitted"]:
            raise AssertionError(f"spill_path depth 2: one source must "
                                 f"evict and the same windows upload "
                                 f"({st2}, {depths2})")
        del g_two, g_plain
        gc.collect()
        ahead = timed_path("spill_path depth 2", query, check, SPILL_PHASES,
                           profile=False)
        streams2 = stream_profile(lambda: query([])) if profile else None
    no_recovery("spill_path depth 2")
    counts = spilled["kernel_counts"]
    runs = 4                                    # the warm-up and 3 timed
    if counts["splitter_probe"]["launches"] != runs * w \
            or counts["windowed_gather"]["launches"] != runs * w * nc:
        raise AssertionError(f"spill_path kernel counts {counts}: expected "
                             "K2 once per shard and K1 once per shard and "
                             "piece per iteration")
    k1 = k1_check(wg, "w4_spilled_shard0_piece0", *captured.pop("piece"),
                  timed=True)
    k2 = k2_check(sp, "w4_spilled_shard0", *captured.pop("probe"),
                  timed=True)
    del lt, rt, env, captured
    gc.collect()
    memory.reset_stats()
    torch.cuda.empty_cache()
    rec = {"phase": "spill_path", "world": w, "rows_per_side": n,
           "n_chunks": nc, "budget_bytes": budget,
           "admissions": [{"balance": b, "need": nd, "scratch": sc}
                          for b, nd, sc in calls],
           "evicted_owners_per_iteration": log,
           "bytes_evicted_per_iteration": st["bytes_spilled"],
           "bytes_uploaded_per_iteration": st["bytes_readmitted"],
           "windows_uploaded_per_iteration": st["readmit_events"],
           "prefetch_depths": depths1, "streams": streams,
           "best_s": spilled["best_s"],
           "rows_per_s": 2 * n / spilled["best_s"],
           "unspilled_best_s": plain["best_s"],
           "unspilled_rows_per_s": 2 * n / plain["best_s"],
           "iterations": spilled["iterations"],
           "unspilled_iterations": plain["iterations"],
           "peak_mem_bytes": spilled["peak_mem_bytes"],
           "unspilled_peak_mem_bytes": plain["peak_mem_bytes"],
           "groups": spilled["groups"], "oracle": "equal",
           "bit_equal_to_unspilled": True,
           "kernel_counts": counts,
           "unspilled_kernel_counts": plain["kernel_counts"],
           "phase_split_s": spilled["phase_split_s"],
           "unspilled_phase_split_s": plain["phase_split_s"],
           "k1_spilled_piece": k1, "k2_spilled": k2,
           "depth2": {"budget_bytes": two_pairs, "prefetch_depths": depths2,
                      "bytes_uploaded_per_iteration":
                          st2["bytes_readmitted"],
                      "best_s": ahead["best_s"],
                      "rows_per_s": 2 * n / ahead["best_s"],
                      "iterations": ahead["iterations"],
                      "peak_mem_bytes": ahead["peak_mem_bytes"],
                      "streams": streams2,
                      "phase_split_s": ahead["phase_split_s"],
                      "bit_equal_to_unspilled": True}}
    if profile:
        # the idle share from the union of busy intervals: the uploads run
        # on a side stream, so a sum of kernel times can pass the wall
        rec["device_idle_share_of_best"] = \
            1.0 - streams["device_busy_s"] / spilled["best_s"]
        rec["unspilled_device_idle_share_of_best"] = \
            plain["profile"]["device_idle_share_of_best"]
        rec["profile"] = spilled["profile"]
    return rec


def oom_path(ct, n: int = OOM_ROWS, device=None) -> dict:
    """The BASELINE join → groupby-sum through the monolithic entry
    (``join_tables`` → ``groupby_aggregate``) at W = 1 and ``n`` rows a
    side (on the card, BASELINE-shaped tables drawn there,
    :func:`card_inputs`), a size the monolithic route cannot hold: its first
    attempt must raise a real ``torch.cuda.OutOfMemoryError``, classified
    as ``DeviceOOMError``, and the retry ladder's chunked route must give
    the oracle's answer.  One run; the failed attempt's time and peak,
    the recovery's time and peak (the peak counted from the retry's
    start, after the failed attempt's memory was released), the events
    and the ladder (join or groupby) that caught it."""
    from cylon_tpu_torch.exec import recovery
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    t0 = time.perf_counter()
    env = ct.CylonEnv(device=device)
    if env.on_cuda:
        # drawn on the card: a numpy draw of 402M rows a side took ≈ 30 s
        left, right, mv = card_inputs(n, 42, env.device)
        orc = oracle(left, right, mv)
        lt, rt = device_table(ct, left, env), device_table(ct, right, env)
    else:
        left, right, mv = baseline_inputs(n)
        orc = oracle(left, right, mv)
        lt, rt = ct.Table.from_pydict(left, env), ct.Table.from_pydict(
            right, env)
    del left, right
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tables_bytes = torch.cuda.memory_allocated()
    seen, starts = [], []
    classify, empty = recovery.classify, recovery._empty_cache

    def classify_spy(e):
        fault = classify(e)
        seen.append({"error": type(e).__name__,
                     "fault": None if fault is None else type(fault).__name__,
                     "at_s": time.perf_counter() - t1,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                     "message": str(e)[:240]})
        return fault

    def retry_start():
        empty()
        starts.append({"at_s": time.perf_counter() - t1,
                       "allocated_bytes": torch.cuda.memory_allocated()})
        torch.cuda.reset_peak_memory_stats()

    recovery_events()
    wg.reset_counts()
    sp.reset_counts()
    recovery.classify, recovery._empty_cache = classify_spy, retry_start
    t1 = time.perf_counter()
    try:
        g = step(ct, lt, rt)
    finally:
        recovery.classify, recovery._empty_cache = classify, empty
    total_s = time.perf_counter() - t1
    recovery_peak = torch.cuda.max_memory_allocated()
    counts = {"windowed_gather": dict(wg.COUNTS),
              "splitter_probe": dict(sp.COUNTS)}
    events = recovery_events()
    out = g.to_pydict()
    order = stable_order(out["k"])
    for name in ("k", "a_sum", "b_sum"):
        if not np.array_equal(out[name][order], orc[name]):
            raise AssertionError(f"oom_path: {name} differs from the "
                                 "numpy oracle")
    del g, lt, rt, out
    torch.cuda.empty_cache()
    if not seen or seen[0]["error"] != "OutOfMemoryError" \
            or seen[0]["fault"] != "DeviceOOMError":
        raise AssertionError(f"oom_path: the first attempt did not raise "
                             f"torch.cuda.OutOfMemoryError ({seen}); raise "
                             "the size")
    retries = [e for e in events if e[2].startswith("retry_chunks_")]
    if not retries or retries[0][1] != "device_oom" or not starts:
        raise AssertionError(f"oom_path: no chunked retry ({events})")
    card = torch.cuda.get_device_properties(0).total_memory
    if recovery_peak >= card:
        raise AssertionError("oom_path: the recovery's peak reached the "
                             "card's memory")
    return {"phase": "oom_path", "world": 1, "rows_per_side": n,
            "groups": int(len(orc["k"])), "setup_s": setup_s,
            "tables_bytes": tables_bytes, "card_bytes": card,
            "classified": seen, "events": events,
            "caught_by": retries[0][0],
            "failed_attempt_s": seen[0]["at_s"],
            "failed_attempt_peak_bytes": seen[0]["peak_mem_bytes"],
            "retry_starts": starts,
            "recovery_s": total_s - starts[0]["at_s"],
            "recovery_peak_bytes": recovery_peak, "total_s": total_s,
            "kernel_counts": counts, "oracle": "equal"}


# ---------------------------------------------------------------------------
# durable checkpoints: kill and resume, the preemption drain, the re-shard
# ---------------------------------------------------------------------------

#: pieces of the checkpointed pipelined route
CKPT_CHUNKS = 4
#: the exit code of a child that left through a ResumableAbort
DRAIN_RC = 3
#: the write side's timing regions (exec/checkpoint.py)
CKPT_REGIONS = ("ckpt.write", "ckpt.d2h", "ckpt.encode", "ckpt.sha",
                "ckpt.file_write", "ckpt.commit", "ckpt.load",
                "ckpt.reshard")
#: the checkpoint switches, cleared around every unarmed run
CKPT_VARS = ("CYLON_TPU_TORCH_CKPT_DIR", "CYLON_TPU_TORCH_RESUME",
             "CYLON_TPU_TORCH_FAULTS", "CYLON_TPU_TORCH_PREEMPT_GRACE_S")


@contextlib.contextmanager
def ckpt_env(**values):
    """Set the checkpoint switches (``CKPT_DIR``, ``RESUME``, ``FAULTS``
    as ``CYLON_TPU_TORCH_<name>``) for the block, the others unset; a new
    fault spec is installed, the stage sequence and the counters start
    over, as in a fresh process."""
    import os
    from cylon_tpu_torch.exec import checkpoint, recovery
    old = {k: os.environ.pop(k, None) for k in CKPT_VARS}
    for k, v in values.items():
        os.environ[f"CYLON_TPU_TORCH_{k}"] = str(v)
    recovery.install_faults(None)
    checkpoint.reset_stages()
    checkpoint.reset_stats()
    try:
        yield checkpoint
    finally:
        for k in CKPT_VARS:
            os.environ.pop(k, None)
            if old[k] is not None:
                os.environ[k] = old[k]
        recovery.install_faults(None)
        checkpoint.reset_stages()


def result_digest(g) -> dict:
    """sha256 of a sink result's live rows sorted by key (unique per
    group), column by column, and its group count: two results with equal
    digests hold the same groups bit for bit, whatever their layout."""
    import hashlib
    cap = g.capacity
    dev = g.column("k").data.device
    vc = torch.as_tensor(np.asarray(g.valid_counts), device=dev)
    mask = (torch.arange(cap, device=dev)[None, :] < vc[:, None]).reshape(-1)
    k = g.column("k").data[mask]
    order = torch.argsort(k)
    out = {"groups": int(k.shape[0])}
    for name in ("k", "a_sum", "b_sum"):
        col = g.column(name).data[mask][order].cpu().numpy()
        out[name] = hashlib.sha256(np.ascontiguousarray(col)).hexdigest()
    return out


def sorted_rows(t, keys) -> list:
    """A table's live rows as host arrays, sorted by ``keys``."""
    h = t.host_columns()
    names = list(h)
    order = np.lexsort([h[k][0] for k in keys][::-1])
    return [(n, h[n][0][order]) for n in names]


def same_sorted_rows(a, b, keys, label: str) -> None:
    """Two tables' live rows equal bit for bit once sorted by ``keys``
    (their layouts may differ)."""
    ra, rb = sorted_rows(a, keys), sorted_rows(b, keys)
    if [n for n, _ in ra] != [n for n, _ in rb]:
        raise AssertionError(f"{label}: columns differ")
    for (na, xa), (_, xb) in zip(ra, rb):
        if xa.dtype != xb.dtype or not np.array_equal(xa, xb):
            raise AssertionError(f"{label}: column {na} differs")


def manifest_of(root: str) -> dict:
    """The manifest of the one stage under ``root``'s rank0."""
    import os
    rank = os.path.join(root, "rank0")
    stages = sorted(os.listdir(rank))
    if len(stages) != 1:
        raise AssertionError(f"{root}: stages {stages}, expected one")
    with open(os.path.join(rank, stages[0], "MANIFEST.json"),
              encoding="utf-8") as f:
        return {"dir": os.path.join(rank, stages[0]), **json.load(f)}


def verify_pages(man: dict) -> int:
    """Every page and meta sidecar the manifest names verifies its sha256;
    returns their bytes."""
    import hashlib
    import os
    import pickle
    total = 0
    for i, entry in man["pieces"].items():
        with open(os.path.join(man["dir"], entry["meta"]), "rb") as f:
            raw = f.read()
        if hashlib.sha256(raw).hexdigest() != entry["sha"]:
            raise AssertionError(f"piece {i}: meta sidecar fails its hash")
        total += len(raw)
        for page in pickle.loads(raw)["pages"]:
            with open(os.path.join(man["dir"], page["file"]), "rb") as f:
                praw = f.read()
            if hashlib.sha256(praw).hexdigest() != page["sha"]:
                raise AssertionError(f"piece {i}: page {page['file']} "
                                     "fails its hash")
            total += len(praw)
    return total


def shard_digest(g) -> dict:
    """A digest of a BASELINE result's every group, layout included:
    sha256 over the ranks in order of each shard's live rows sorted by
    key (k, a_sum, b_sum).  In a multi-process world each process hashes
    its own shards and one allgather puts the shard digests in rank
    order, so every process gets the digest one process gets of the same
    layout."""
    import hashlib
    from cylon_tpu_torch.parallel import transport
    from cylon_tpu_torch.parallel.shards import shard, span
    w = g.env.world_size
    vc = np.asarray(g.valid_counts, np.int64)
    mine = []
    for r in span(w):
        n = int(vc[r])
        k = shard(g.column("k").data, w, r)[:n]
        order = torch.argsort(k)
        h = hashlib.sha256()
        for name in ("k", "a_sum", "b_sum"):
            col = shard(g.column(name).data, w, r)[:n][order]
            h.update(np.ascontiguousarray(col.cpu().numpy()).tobytes())
        mine.append(np.frombuffer(h.digest(), np.uint8))
    blocks = np.stack(mine)
    if transport.current(w) is not None:
        blocks = transport.allgather_array(blocks, "digest").reshape(w, -1)
    return {"groups": int(vc.sum()),
            "sha256": hashlib.sha256(blocks.tobytes()).hexdigest()}


#: the exchange's always-on tier counters (parallel/shuffle._tier_counters)
TIER_COUNTERS = ("ici_rows", "dcn_rows", "ici_bytes", "dcn_bytes",
                 "ici_wire_bytes", "dcn_wire_bytes", "ici_messages",
                 "dcn_messages")
#: the slices procs_topo and topo_virtual declare
TOPO_SLICES = 2
#: procs_topo's operator legs: rows of their tables, TPC-H scale
OPS_ROWS = 1_048_576
OPS_TPCH_SCALE = 0.1


def tier_counters() -> dict:
    """The tier counters' values now (subtract two readings)."""
    from cylon_tpu_torch.obs import metrics
    return {name: metrics.counter(f"exchange_{name}_total").value
            for name in TIER_COUNTERS}


def tier_delta(before: dict) -> dict:
    now = tier_counters()
    return {k: now[k] - before[k] for k in TIER_COUNTERS}


@contextlib.contextmanager
def slices_declared(n: int):
    """``CYLON_TPU_TORCH_SLICES=n`` for this process while the block runs
    (the topology re-read before and after)."""
    import os
    from cylon_tpu_torch.topo import model as tm
    prev = os.environ.get("CYLON_TPU_TORCH_SLICES")
    os.environ["CYLON_TPU_TORCH_SLICES"] = str(n)
    tm._reslice()
    try:
        yield
    finally:
        if prev is None:
            del os.environ["CYLON_TPU_TORCH_SLICES"]
        else:
            os.environ["CYLON_TPU_TORCH_SLICES"] = prev
        tm._reslice()


def topo_virtual(ct, lt, rt, orc, n: int, need_k1: bool, w4: dict) -> dict:
    """``topo_virtual`` (module docstring): dist_path's W = 4 tables with
    two slices declared, the BASELINE monolithic join → groupby on the
    two-hop route as two device-local hops (the port's skew split off,
    as ``dist_path_unarmed``), a warm-up and best of 3.  The digest must
    equal dist_path's; K1 launches once per shard per iteration.  Reports
    s/iteration against ``dist_path_unarmed``, the gateway capacity
    ``cap1`` (the largest of the run), the peak memory and the tier
    counters of one iteration."""
    from cylon_tpu_torch import config as pconfig
    from cylon_tpu_torch.ops import windowed_gather as wg
    from cylon_tpu_torch.topo import exchange as tx
    from cylon_tpu_torch.topo import model as tm
    w = lt.env.world_size
    caps = []
    prepare = tx.prepare

    def recording(plan, counts):
        prep = prepare(plan, counts)
        caps.append(prep.cap1)
        return prep

    times = []
    tx.prepare = recording
    pconfig.SKEW_SPLIT = False
    try:
        with slices_declared(TOPO_SLICES):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            wg.reset_counts()
            for i in range(4):                  # a warm-up, then 3
                if i == 3:
                    before = tier_counters()
                g = step(ct, lt, rt, times)
            tiers = tier_delta(before)
            counts = dict(wg.COUNTS)
            peak = torch.cuda.max_memory_allocated()
            plan = tm.last_plan()
            check_dist(g, orc, w, "topo_virtual")
            digest = shard_digest(g)
            del g
    finally:
        pconfig.SKEW_SPLIT = True
        tx.prepare = prepare
    if digest != w4["dist_path"]["digest"]:
        raise AssertionError(f"topo_virtual: digest {digest} differs from "
                             f"dist_path's {w4['dist_path']['digest']}")
    if plan is None or plan.route != "hierarchical":
        raise AssertionError("topo_virtual: no hierarchical plan was voted")
    if counts["redispatches"] != 0 or counts["launches"] not in (
            (4 * w,) if need_k1 else (0, 4 * w)):
        raise AssertionError(f"topo_virtual windowed gather counts {counts}"
                             f": expected {w} launches per iteration")
    if not tiers["dcn_messages"] or not tiers["dcn_rows"]:
        raise AssertionError(f"topo_virtual: tier counters {tiers}")
    torch.cuda.empty_cache()
    best = min(t["total_s"] for t in times[1:])
    ubest = w4["dist_path_unarmed_best_s"]
    return {"phase": "topo_virtual", "world": w, "rows_per_side": n,
            "slices": plan.n_slices, "ranks_per_slice": plan.ranks_per_slice,
            "plan": plan.summary(), "iterations": times, "best_s": best,
            "rows_per_s": 2 * n / best, "dist_path_unarmed_best_s": ubest,
            "vs_dist_path_unarmed_s": best - ubest,
            "ratio_to_dist_path_unarmed": best / ubest,
            "cap1": max(caps), "exchanges_per_iteration": len(caps) // 4,
            "peak_mem_bytes": peak, "tiers_per_iteration": tiers,
            "kernel_counts": {"windowed_gather": counts},
            "digest": digest, "oracle": "equal, digest equal to dist_path"}


def table_digest(t) -> str:
    """sha256 of a table's layout and live rows: its valid counts,
    capacity and column names, then each shard's live rows in row order,
    column by column (data, and validity where present), in rank order.
    In a multi-process world each process hashes its own shards and one
    allgather orders them, so every process gets what one process gets
    of the same layout."""
    import hashlib
    from cylon_tpu_torch.parallel import transport
    from cylon_tpu_torch.parallel.shards import shard, span
    w = t.env.world_size
    vc = np.asarray(t.valid_counts, np.int64)
    mine = []
    for r in span(w):
        h = hashlib.sha256()
        live = int(vc[r])
        for name in t.column_names:
            c = t.column(name)
            for x in (c.data, c.validity):
                if x is not None:
                    h.update(np.ascontiguousarray(
                        shard(x, w, r)[:live].cpu().numpy()).tobytes())
        mine.append(np.frombuffer(h.digest(), np.uint8))
    blocks = np.stack(mine)
    if transport.current(w) is not None:
        blocks = transport.allgather_array(blocks, "digest").reshape(w, -1)
    head = repr((vc.tolist(), int(t.capacity), list(t.column_names)))
    return hashlib.sha256(head.encode() + blocks.tobytes()).hexdigest()


def ops_legs(ct, env, n: int = OPS_ROWS,
             scale: float = OPS_TPCH_SCALE) -> dict:
    """procs_topo's operator legs (correctness only), on tables drawn from
    seed 16: union, intersect, subtract, ``unique_table``, ``equals``,
    ``pipelined_set_op``, a Series filter and sum, ``loc``/``iloc``, and
    TPC-H Q3 and Q8 at ``scale``.  Returns each result's
    :func:`table_digest` (the answer itself for ``equals`` and the sum),
    which every process of a world must share with the one-process
    world's."""
    from cylon_tpu_torch import tpch
    rng = np.random.default_rng(16)
    mv = max(n // 8, 1)
    ka = ct.Table.from_pydict({"k": rng.integers(0, mv, n)}, env)
    kb = ct.Table.from_pydict({"k": rng.integers(0, mv, n)}, env)
    keys = rng.integers(0, mv, n)
    t = ct.Table.from_pydict({"k": keys, "a": rng.integers(0, 1000, n)},
                             env)
    out = {}
    for op in ("union", "intersect", "subtract"):
        out[op] = table_digest(ct.set_operation(ka, kb, op))
    out["unique"] = table_digest(ct.unique_table(t, ["k"]))
    out["equals"] = [ct.equals(t, t),
                     ct.equals(t, ct.sort_table(t, "a"), ordered=False),
                     ct.equals(ka, kb)]
    out["pipelined_set_op"] = table_digest(
        ct.pipelined_set_op(ka, kb, "intersect", n_chunks=2))
    df = ct.DataFrame(t)
    s = df["a"]
    out["series_filter"] = table_digest(
        df[(s > 500) & (df["k"] < mv // 2)].table)
    out["series_sum"] = int(s.sum())
    labels = [int(x) for x in keys[[0, n // 2, n - 1]]]
    out["loc"] = table_digest(df.set_index("k").loc[labels].table)
    out["iloc"] = table_digest(df.iloc[5:n // 10].table)
    dfs = tpch.generate_tables(scale, env, seed=0)
    for q in ("q3", "q8"):
        out[f"tpch_{q}"] = table_digest(getattr(tpch, q)(dfs, env=env).table)
    return out


def procs_child(spec: dict) -> int:
    """One process of ``procs_path`` (a ``procs_ckpt``, ``procs_serve`` or
    ``procs_stream`` spec runs that leg's child instead): a
    DistributedConfig world of
    ``spec["nproc"]`` processes × ``spec["local_world"]`` ranks on this
    card.  Maps bench.py's tables (seed 42, ``spec["rows"]`` a side) from
    the parent's ``.npy`` files, uploads its own ranks' blocks, runs the
    monolithic
    join → groupby(sum) as a warm-up plus best of 3, then
    ``pipelined_join(n_chunks=2)`` into a ``GroupBySink``; K1 and K2 are
    held bit-equal to their plain versions on the inputs of their first
    launch in this process.  Prints one JSON line: seconds per
    iteration, the transport's bytes and seconds (staging, wire, count
    allgathers, votes, set-up), peak memory, the kernel launches and
    both results' digests.  A ``procs_topo`` child (two slices declared
    by its parent) times the monolithic query on the two-hop route, runs
    it once on the flat route, records the voted plan, each hop's bytes
    and seconds and the tier counters of one iteration on each route,
    and after its checks runs :func:`ops_legs`."""
    import os
    if spec["leg"] in ("procs_ckpt", "procs_serve", "procs_stream"):
        return globals()[spec["leg"] + "_child"](spec)
    from cylon_tpu_torch import config as pconfig
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    from cylon_tpu_torch.parallel import transport
    _procs_go(spec)
    t_start = time.perf_counter()
    ct, env = _procs_env(spec)
    rec = {"phase": "procs_child", "leg": spec["leg"], "pid": spec["pid"],
           "nproc": spec["nproc"], "local_world": spec["local_world"],
           "backend": env.backend, "world": env.world_size,
           "local_ranks": list(env.local_ranks),
           "setup_s": dict(transport.STATS)["setup_s"]}
    t0 = time.perf_counter()
    # bench.py's tables as the parent drew them, mapped from its files:
    # each process reads (and uploads) its own ranks' blocks
    cols = {name: np.load(os.path.join(spec["data"], f"{name}.npy"),
                          mmap_mode="r") for name in ("lk", "a", "rk", "b")}
    lt = ct.Table.from_pydict({"k": cols["lk"], "a": cols["a"]}, env)
    rt = ct.Table.from_pydict({"k": cols["rk"], "b": cols["b"]}, env)
    del cols
    torch.cuda.synchronize()
    rec["upload_s"] = time.perf_counter() - t0
    env.barrier()
    torch.cuda.reset_peak_memory_stats()
    # the main path, counted: every count 0 just before, read just after
    wg.reset_counts()
    sp.reset_counts()
    transport.reset_stats()
    captured: dict = {}
    times = []
    topo = spec["leg"] == "procs_topo"
    with capturing(wg, "windowed_take_t", captured, "mono", keep_k1):
        g = step(ct, lt, rt, times)             # warm-up (first sight)
    warm_stats = dict(transport.STATS)
    transport.reset_stats()
    for i in range(3):
        if i == 2:
            tiers = tier_counters()
        g = step(ct, lt, rt, times)
    tiers = tier_delta(tiers)
    mono_stats = {k: v / 3 for k, v in transport.STATS.items()}
    rec["monolithic"] = {
        "iterations": times, "best_s": min(t["total_s"] for t in times[1:]),
        "per_iteration": mono_stats, "warm_up": warm_stats,
        "digest": shard_digest(g)}
    del g
    torch.cuda.empty_cache()
    if topo:
        from cylon_tpu_torch.topo import model as tm
        plan = tm.last_plan()
        rec["plan"] = None if plan is None else plan.summary()
        rec["monolithic"]["tiers"] = tiers
        # the flat route once, on the same tables
        transport.reset_stats()
        before = tier_counters()
        ftimes = []
        pconfig.TOPO_SHUFFLE = False
        try:
            g = step(ct, lt, rt, ftimes)
        finally:
            pconfig.TOPO_SHUFFLE = True
        rec["flat"] = {"s": ftimes[0]["total_s"], "iterations": ftimes,
                       "transport": dict(transport.STATS),
                       "tiers": tier_delta(before),
                       "digest": shard_digest(g)}
        del g
        torch.cuda.empty_cache()
    transport.reset_stats()
    ptimes = []
    with capturing(sp, "count_ge_splitters", captured, "probe"), \
            capturing(wg, "windowed_take_t", captured, "piece", keep_k1):
        g = pipelined_step(ct, lt, rt, 2, ptimes)
    rec["pipelined"] = {"n_chunks": 2, "iterations": ptimes,
                        "s": ptimes[0]["total_s"],
                        "transport": dict(transport.STATS),
                        "digest": shard_digest(g)}
    del g
    rec["kernel_counts"] = {"windowed_gather": dict(wg.COUNTS),
                            "splitter_probe": dict(sp.COUNTS)}
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    if spec["leg"] == "procs_gloo":
        rec["sentinel"] = procs_sentinel(ct, lt, rt)
    del lt, rt
    torch.cuda.empty_cache()
    checks = {}
    if "mono" in captured:
        checks["k1_monolithic"] = k1_check(
            wg, f"{spec['leg']}_p{spec['pid']}_monolithic",
            *captured.pop("mono"), True)
    if "piece" in captured:
        checks["k1_piece"] = k1_check(
            wg, f"{spec['leg']}_p{spec['pid']}_piece", *captured.pop("piece"))
    if "probe" in captured:
        checks["k2"] = k2_check(sp, f"{spec['leg']}_p{spec['pid']}",
                                *captured.pop("probe"))
    rec["checks"] = {name: {key: c.get(key) for key in (
        "L", "M", "S", "K", "window", "bit_equal", "max_abs_err")}
        for name, c in checks.items()}
    if topo:
        t0 = time.perf_counter()
        rec["ops"] = ops_legs(ct, env)
        rec["ops_s"] = time.perf_counter() - t0
    env.barrier()
    env.finalize()
    rec["wall_s"] = time.perf_counter() - t_start
    print(json.dumps(rec), flush=True)
    return 0


def procs_sentinel(ct, lt, rt) -> dict:
    """One more monolithic iteration in a ``procs_gloo`` child with the
    runtime sentinel armed: its collective log's length, digest and kinds
    (every process must log the same sequence), the funnel's pulls and
    stray syncs, and the result's digest."""
    from collections import Counter
    from cylon_tpu_torch.analysis import runtime
    times = []
    with sentinel_armed(lt.env.on_cuda) as (pulls, syncs):
        g = step(ct, lt, rt, times)
        log = runtime.collective_log()
        digest = runtime.collective_digest()
    return {"s": times[0]["total_s"], "log_len": len(log),
            "log_digest": digest, "kinds": dict(Counter(e[1] for e in log)),
            "sites": dict(Counter(e[0] for e in log)),
            "digest": shard_digest(g), **sentinel_counts(pulls, syncs)}


def procs_path(ct, left: dict, right: dict, w4: dict) -> list:
    """The multi-process transport on this card (module docstring):
    ``procs_gloo``, 2 processes × 2 ranks over gloo (the exchange stages
    through pinned host memory: NCCL refuses two ranks on one GPU),
    ``procs_nccl``, 1 process × 4 ranks over NCCL, and ``procs_topo``, 4
    processes × 1 rank over gloo with two slices declared (the two-hop
    route).  Each child's result digest must equal the one-process W = 4
    digest (``dist_path``), K1 and K2 must launch on every child's shards
    and equal their plain versions there; each ``procs_topo`` child's
    operator legs must equal the one-process W = 4 world's, which this
    process computes first.  ``left``/``right``: bench.py's host tables,
    which the children map from ``.npy`` files written here once.
    Returns the three phase records."""
    import os
    import shutil
    import tempfile
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    want = w4["dist_path"]["digest"]
    n = len(left["k"])
    t0 = time.perf_counter()
    ops_want = ops_legs(ct, ct.CylonEnv(VirtualMeshConfig(4)))
    ops_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    data = tempfile.mkdtemp(prefix="procs_path_")
    try:
        t0 = time.perf_counter()
        for name, arr in (("lk", left["k"]), ("a", left["a"]),
                          ("rk", right["k"]), ("b", right["b"])):
            np.save(os.path.join(data, f"{name}.npy"), arr)
        save_s = time.perf_counter() - t0
        recs = [dict(rec, tables_save_s=save_s)
                for rec in _procs_legs(data, n, want, w4, ops_want)]
        recs[-1]["parent_ops_s"] = ops_s
        return recs
    finally:
        shutil.rmtree(data, ignore_errors=True)


def _procs_launch(leg: str, nproc: int, v: int, backend, data: str,
                  go: str | None = None, slices: int | None = None) -> list:
    """Start one leg's child processes; with ``go``, they wait for that
    file before they touch the card; ``slices`` declares that many
    slices in their environment."""
    import os
    import socket
    env = dict(os.environ)
    if slices is not None:
        env["CYLON_TPU_TORCH_SLICES"] = str(slices)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sk.getsockname()[1]}"
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--procs-child",
         json.dumps({"leg": leg, "pid": i, "nproc": nproc,
                     "local_world": v, "backend": backend, "addr": addr,
                     "data": data, "go": go})],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(nproc)]


def _procs_collect(leg: str, procs: list, deadline: float) -> list:
    """Each child's JSON line; a child that fails, prints nothing or is
    still running at ``deadline`` (it and its peers are killed) fails
    the leg."""
    results = []
    try:
        for i, p in enumerate(procs):
            try:
                so, se = p.communicate(
                    timeout=max(deadline - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                so, se = p.communicate()
            if p.returncode != 0:
                raise AssertionError(
                    f"{leg}: process {i} exited {p.returncode}\n"
                    f"{so[-2000:]}\n{se[-4000:]}")
            lines = [ln for ln in so.splitlines() if ln.startswith("{")]
            if not lines:
                raise AssertionError(f"{leg}: process {i} printed no "
                                     f"result\n{se[-4000:]}")
            results.append(json.loads(lines[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def _procs_legs(data: str, n: int, want: dict, w4: dict, ops_want: dict):
    """The three legs of :func:`procs_path`, measured one after the other:
    the NCCL child and the ``procs_topo`` children start beside the gloo
    children (their imports overlap that run) and each waits for its go
    file until the leg before it has exited."""
    import os
    gos = [None, os.path.join(data, "go_nccl"), os.path.join(data, "go_topo")]
    t0 = time.perf_counter()
    deadline = t0 + PROCS_TIMEOUT_S
    legs = [("procs_gloo", 2, 2, "gloo"), ("procs_nccl", 1, 4, None),
            ("procs_topo", 4, 1, "gloo")]
    waiting = [_procs_launch(*legs[1], data, gos[1]),
               _procs_launch(*legs[2], data, gos[2], slices=TOPO_SLICES)]
    results, walls = [], []
    try:
        t1 = time.perf_counter()
        results.append(_procs_collect(
            "procs_gloo", _procs_launch(*legs[0], data), deadline))
        walls.append(time.perf_counter() - t1)
        for (leg, *_r), go, procs in zip(legs[1:], gos[1:], waiting):
            open(go, "w").close()
            t1 = time.perf_counter()
            results.append(_procs_collect(leg, procs, deadline))
            walls.append(time.perf_counter() - t1)
    finally:
        for procs in waiting:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    out = []
    for (leg, nproc, v, _b), res, wall in zip(legs, results, walls):
        topo = leg == "procs_topo"
        for r in res:
            for route in ("monolithic", "pipelined") + (
                    ("flat",) if topo else ()):
                if r[route]["digest"] != want:
                    raise AssertionError(
                        f"{leg} process {r['pid']} {route}: digest "
                        f"{r[route]['digest']} differs from the one-process "
                        f"W = 4 digest {want}")
            kc = r["kernel_counts"]
            if kc["windowed_gather"]["launches"] < 1 \
                    or kc["splitter_probe"]["launches"] < 1:
                raise AssertionError(f"{leg} process {r['pid']}: kernel "
                                     f"counts {kc}, expected K1 and K2")
            if not all(c["bit_equal"] for c in r["checks"].values()) \
                    or set(r["checks"]) != {"k1_monolithic", "k1_piece",
                                            "k2"}:
                raise AssertionError(f"{leg} process {r['pid']}: kernel "
                                     f"checks {r['checks']}")
        logs = None
        if leg == "procs_gloo":
            sen = [r["sentinel"] for r in res]
            logs = {"lengths": [x["log_len"] for x in sen],
                    "digests": [x["log_digest"] for x in sen]}
            if len(set(logs["digests"])) != 1 or not sen[0]["log_len"] \
                    or any(x["digest"] != want for x in sen):
                raise AssertionError(f"procs_gloo: the processes' "
                                     f"collective logs differ: {sen}")
        best = max(r["monolithic"]["best_s"] for r in res)
        rec = {
            "phase": leg, "processes": nproc, "local_world": v,
            "world": nproc * v, "backend": res[0]["backend"],
            "rows_per_side": n, "wall_s": wall,
            "best_s_slowest_process": best,
            "dist_path_best_s": w4["dist_path"]["best_s"],
            "dist_path_unarmed_best_s": w4["dist_path_unarmed_best_s"],
            "ratio_to_dist_path": best / w4["dist_path"]["best_s"],
            "ratio_to_dist_path_unarmed":
                best / w4["dist_path_unarmed_best_s"],
            "digest": want, "oracle": "digest equal to dist_path",
            "children": res}
        if logs is not None:
            rec["collective_logs"] = dict(logs, equal=True)
        if topo:
            rec.update(_procs_topo_verdict(res, ops_want))
        out.append(rec)
    torch.cuda.empty_cache()
    return out


def _procs_topo_verdict(res: list, ops_want: dict) -> dict:
    """procs_topo's checks across its children: one voted hierarchical
    plan on every child, the two-hop route's cross-slice messages half
    the flat route's (R = 2) over the same cross-slice rows, and every
    operator leg equal to the one-process world's.  Returns the
    summary."""
    plans = {json.dumps(r.get("plan"), sort_keys=True) for r in res}
    plan = res[0].get("plan")
    if len(plans) != 1 or plan is None or plan["route"] != "hierarchical":
        raise AssertionError(f"procs_topo: plans {plans}")
    for r in res:
        two, flat = r["monolithic"]["tiers"], r["flat"]["tiers"]
        if not two["dcn_messages"] or two["dcn_messages"] \
                * plan["ranks_per_slice"] != flat["dcn_messages"] \
                or two["dcn_rows"] != flat["dcn_rows"]:
            raise AssertionError(f"procs_topo process {r['pid']}: two-hop "
                                 f"tiers {two}, flat {flat}")
        if r["ops"] != ops_want:
            bad = sorted(k for k in ops_want if r["ops"].get(k)
                         != ops_want[k])
            raise AssertionError(f"procs_topo process {r['pid']}: operator "
                                 f"legs {bad} differ from the one-process "
                                 "world's")
    return {"plan": plan,
            "flat_s_slowest_process": max(r["flat"]["s"] for r in res),
            "dcn_messages": {"two_hop": res[0]["monolithic"]["tiers"][
                "dcn_messages"], "flat": res[0]["flat"]["tiers"][
                "dcn_messages"]},
            "ops": sorted(ops_want), "ops_oracle":
                "every child's digest equal to the one-process W = 4 "
                "world's"}


def ckpt_child(spec: dict) -> int:
    """One process of ``ckpt_path``: the BASELINE tables from the
    parent's ``.npy`` files at ``spec["world"]``, one GroupBySink +
    pipelined_join + finalize under the checkpoint switches the parent
    set in the environment.  Prints one JSON line: the run's seconds, K1
    and K2 launches, the checkpoint counters, the recovery events and the
    result's digest; with ``capture``, K1 and K2 also held bit-equal to
    their plain versions on the inputs of their first launch.  A
    ``ResumableAbort`` prints its token and exits ``DRAIN_RC``.  A spec
    with ``serve`` is a :func:`serve_child`."""
    import os
    if spec.get("serve"):
        return serve_child(spec)
    t_start = time.perf_counter()
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.exec import checkpoint, recovery
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    from cylon_tpu_torch.utils import timing
    if spec.get("go"):
        # started early (its imports beside the phase before): wait for
        # the parent's go file
        deadline = time.monotonic() + 900
        while not os.path.exists(spec["go"]):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no go file {spec['go']}")
            time.sleep(0.05)
    data = spec["data"]
    cols = {name: np.load(os.path.join(data, f"{name}.npy"))
            for name in ("lk", "a", "rk", "b")}
    env = ct.CylonEnv(VirtualMeshConfig(spec["world"]),
                      device=spec.get("device"))
    lt = ct.Table.from_pydict({"k": cols["lk"], "a": cols["a"]}, env)
    rt = ct.Table.from_pydict({"k": cols["rk"], "b": cols["b"]}, env)
    del cols
    if env.on_cuda:
        torch.cuda.synchronize()
    rec = {"phase": "ckpt_child", "mode": spec["mode"],
           "world": spec["world"], "pid": os.getpid(),
           "setup_s": time.perf_counter() - t_start}
    wg.reset_counts()
    sp.reset_counts()
    checkpoint.reset_stats()
    captured: dict = {}
    t0 = time.perf_counter()
    try:
        with contextlib.ExitStack() as stack:
            sc = stack.enter_context(timing.attribution_scope())
            if spec.get("capture"):
                stack.enter_context(capturing(sp, "count_ge_splitters",
                                              captured, "probe"))
                stack.enter_context(capturing(wg, "windowed_take_t",
                                              captured, "piece", keep_k1))
            g = pipelined_step(ct, lt, rt, spec["n_chunks"])
    except ct.ResumableAbort as e:
        rec.update(run_s=time.perf_counter() - t0, aborted=True,
                   token=e.token, message=str(e)[:400],
                   stats=checkpoint.stats(), events=recovery_events())
        print(json.dumps(rec), flush=True)
        return DRAIN_RC
    rec["run_s"] = time.perf_counter() - t0
    rec["regions_s"] = {r: v for r, v in sc.snapshot().items()
                        if r in CKPT_REGIONS}
    rec["kernel_counts"] = {"windowed_gather": dict(wg.COUNTS),
                            "splitter_probe": dict(sp.COUNTS)}
    rec["stats"] = checkpoint.stats()
    rec["events"] = recovery_events()
    rec["digest"] = result_digest(g)
    del g, lt, rt
    if spec.get("capture") and env.on_cuda:
        torch.cuda.empty_cache()
        if "piece" in captured:
            rec["k1"] = k1_check(wg, "ckpt_resume_first_recomputed_piece",
                                 *captured.pop("piece"), timed=True)
        rec["k2"] = k2_check(sp, "ckpt_resume_shard0",
                             *captured.pop("probe"), timed=True)
    rec["wall_s"] = time.perf_counter() - t_start
    print(json.dumps(rec), flush=True)
    return 0


def spawn_child(spec: dict, **switches) -> tuple:
    """Start :func:`ckpt_child` in a fresh process under the checkpoint
    switches (``CYLON_TPU_TORCH_<name>``, every other one unset):
    ``(process, start time)`` for :func:`collect_child`."""
    import os
    env = {k: v for k, v in os.environ.items() if k not in CKPT_VARS}
    env.update({f"CYLON_TPU_TORCH_{k}": str(v) for k, v in switches.items()})
    return (subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--ckpt-child", json.dumps(spec)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True), time.perf_counter())


def collect_child(child: tuple, expect_rc: int, label: str) -> dict:
    """Wait for a :func:`spawn_child` process; fails unless it exits
    ``expect_rc``.  Returns its JSON line (empty for a killed child), with
    the process's wall seconds and exit code."""
    p, t0 = child
    try:
        out, err = p.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise
    wall = time.perf_counter() - t0
    if p.returncode != expect_rc:
        raise AssertionError(
            f"{label}: the child exited {p.returncode}, expected "
            f"{expect_rc}\n{out[-2000:]}\n{err[-4000:]}")
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    rec = json.loads(lines[-1]) if lines else {}
    if expect_rc in (0, DRAIN_RC) and not lines:
        raise AssertionError(f"{label}: the child printed no "
                             f"result\n{err[-4000:]}")
    rec.update(process_wall_s=wall, rc=p.returncode)
    return rec


def run_child(spec: dict, expect_rc: int, label: str, **switches) -> dict:
    """Run :func:`ckpt_child` in a fresh process (:func:`spawn_child`) and
    wait for it (:func:`collect_child`)."""
    return collect_child(spawn_child(spec, **switches), expect_rc, label)


def ckpt_inprocess(ct, lt, rt, orc, root: str, nc: int):
    """Unarmed and armed ``GroupBySink`` + ``pipelined_join`` on the W = 4
    tables, best of 3 after a warm-up unarmed and a warm-up and one timed
    run armed, in this process: seconds, peak
    memory, K1/K2 launches, the bytes checkpointed and the write side's
    regions per armed iteration; both results bit-equal to each other (the
    same layout and :func:`result_digest`; the unarmed result is released
    before the armed leg, so the peaks compare) and to the oracle, and
    the unarmed leg writes nothing and enters no checkpoint region.
    Returns the record and the result's digest; the armed leg's complete
    W = 4 stage stays under ``root/armed`` for the re-shard chain."""
    import os
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    from cylon_tpu_torch.utils import timing
    w = lt.env.world_size
    legs = {}
    results = {}
    for leg in ("unarmed", "armed"):
        switches = {"CKPT_DIR": os.path.join(root, "armed")} \
            if leg == "armed" else {}
        with ckpt_env(**switches) as checkpoint:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            wg.reset_counts()
            sp.reset_counts()
            its = []
            # the armed leg is host-bound (one thread writes the pages): a
            # warm-up and one timed run
            for _ in range(2 if leg == "armed" else 4):
                checkpoint.reset_stages()
                checkpoint.reset_stats()
                with timing.attribution_scope() as sc:
                    t0 = time.perf_counter()
                    g = pipelined_step(ct, lt, rt, nc)
                    its.append({"s": time.perf_counter() - t0,
                                "bytes_checkpointed":
                                    checkpoint.stats()["bytes_checkpointed"],
                                "pieces_committed":
                                    checkpoint.stats()["checkpoint_events"],
                                "regions_s": {
                                    r: v for r, v in sc.snapshot().items()
                                    if r in CKPT_REGIONS}})
            counts = {"windowed_gather": dict(wg.COUNTS),
                      "splitter_probe": dict(sp.COUNTS)}
            peak = torch.cuda.max_memory_allocated()
        if leg == "unarmed":
            check_dist(g, orc, w, "ckpt_path unarmed")
            legs["shard_digest"] = shard_digest(g)
        results[leg] = (np.asarray(g.valid_counts).tolist(), g.capacity,
                        result_digest(g))
        del g
        best = min(its[1:], key=lambda it: it["s"])
        legs[leg] = {"iterations": its, "first_s": its[0]["s"],
                     "best_s": best["s"], "peak_mem_bytes": peak,
                     "kernel_counts": counts,
                     "bytes_checkpointed_per_iteration":
                         best["bytes_checkpointed"],
                     "write_split_s": best["regions_s"]}
    if results["armed"] != results["unarmed"]:
        raise AssertionError("ckpt_path: the armed result differs from the "
                             "unarmed one")
    digest = results["unarmed"][2]
    un = legs["unarmed"]
    if un["bytes_checkpointed_per_iteration"] or any(
            it["regions_s"] for it in un["iterations"]):
        raise AssertionError("ckpt_path: the unarmed leg checkpointed")
    if os.listdir(root) != ["armed"]:
        raise AssertionError(f"ckpt_path: files outside the armed root: "
                             f"{os.listdir(root)}")
    legs["armed_overhead_s"] = legs["armed"]["best_s"] - un["best_s"]
    legs["pieces"] = legs["armed"]["iterations"][0]["pieces_committed"]
    return legs, digest


def drain_postmortem(root: str, trace_path: str) -> dict:
    """The drained child's flight-recorder dump: ``TRACE_POSTMORTEM.json``
    in the checkpoint root, naming the abort flush, with the last events
    among them a ``ckpt.write`` span; and its trace exported at exit,
    parseable."""
    import os
    path = os.path.join(root, "TRACE_POSTMORTEM.json")
    if not os.path.exists(path):
        raise AssertionError(f"ckpt_path preempt: no post-mortem in {root}")
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    names = [e["name"] for e in doc["events"]]
    if not doc["reason"].startswith("abort flush") \
            or "ckpt.write" not in names:
        raise AssertionError(f"ckpt_path preempt: post-mortem {doc['reason']}"
                             f" with events {names[-20:]}")
    with open(trace_path, encoding="utf-8") as f:
        exported = json.load(f)["traceEvents"]
    return {"reason": doc["reason"], "events": len(names),
            "ckpt_write_spans": names.count("ckpt.write"),
            "last_events": names[-8:], "last_region": doc["last_region"],
            "bytes": os.path.getsize(path),
            "exported_trace_events": len(exported)}


def ckpt_path(ct, left: dict, right: dict, orc: dict, root: str,
              device=None) -> dict:
    """The checkpointed BASELINE route at W = 4 (module docstring): the
    armed and unarmed legs in this process, then the kill, resume,
    preempt and re-shard children, each held to the uninterrupted
    result."""
    import os
    import shutil
    import threading
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    w, nc = 4, CKPT_CHUNKS
    n = len(left["k"])
    table_bytes = sum(v.nbytes for v in (*left.values(), *right.values()))
    # the tables as .npy once, and at most four checkpoints of the sink's
    # partials (three int64 columns, their pow2 padding)
    need = table_bytes + 4 * 2 * 24 * len(orc["k"])
    free = shutil.disk_usage(root).free
    if free < need:
        raise AssertionError(f"ckpt_path: {free} bytes free under {root}, "
                             f"the phase needs {need}")
    env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
    lt, rt = ct.Table.from_pydict(left, env), ct.Table.from_pydict(right,
                                                                   env)
    rec = {"phase": "ckpt_path", "world": w, "rows_per_side": n,
           "n_chunks": nc, "ckpt_root_free_bytes": free,
           "ckpt_root_needed_bytes": need}
    legs, digest = ckpt_inprocess(ct, lt, rt, orc, root, nc)
    rec.update(legs)
    rec["digest"] = digest
    pieces = rec["pieces"]
    per_it = rec["unarmed"]["kernel_counts"]
    un_k1 = per_it["windowed_gather"]["launches"] // 4
    un_k2 = per_it["splitter_probe"]["launches"] // 4
    del lt, rt
    torch.cuda.empty_cache()

    data = os.path.join(root, "data")
    os.makedirs(data)
    t0 = time.perf_counter()
    for name, arr in (("lk", left["k"]), ("a", left["a"]),
                      ("rk", right["k"]), ("b", right["b"])):
        np.save(os.path.join(data, f"{name}.npy"), arr)
    rec["npy_write_s"] = time.perf_counter() - t0

    def spec(mode, world=w, capture=False):
        return {"mode": mode, "data": data, "world": world,
                "n_chunks": nc, "capture": capture, "device": device}

    def same(child, label):
        if child["digest"] != digest:
            raise AssertionError(f"ckpt_path {label}: result differs from "
                                 "the uninterrupted run")

    on_card = device is None
    a_root = os.path.join(root, "A")

    def kill_chain():
        """The first chain: a SIGKILL at the third write (two pieces
        committed), then its resume at W = 4."""
        kill = run_child(spec("kill"), -9, "ckpt_path kill",
                         CKPT_DIR=a_root,
                         FAULTS="ckpt.write::3=kill")
        man = manifest_of(a_root)
        if sorted(man["pieces"], key=int) != ["0", "1"] or man["complete"]:
            raise AssertionError(f"ckpt_path kill: manifest pieces "
                                 f"{sorted(man['pieces'])}, expected 0 "
                                 "and 1")
        committed_bytes = verify_pages(man)
        named = {e["meta"] for e in man["pieces"].values()}
        stray = sorted(f for f in os.listdir(man["dir"])
                       if f.startswith("piece_") and f.endswith(".meta")
                       and f not in named)
        # resume at W = 4: two pieces fast-forwarded, the rest recomputed
        t_kill_end = time.perf_counter()
        res = run_child(spec("resume", capture=True), 0,
                        "ckpt_path resume",
                        CKPT_DIR=a_root, RESUME=1)
        kill_to_resume_s = time.perf_counter() - t_kill_end
        same(res, "resume")
        st = res["stats"]
        if st["resume_fast_forwarded_pieces"] != 2 \
                or st["checkpoint_events"] != pieces - 2:
            raise AssertionError(f"ckpt_path resume: counters {st}")
        rk = res["kernel_counts"]
        if on_card and (rk["splitter_probe"]["launches"] != un_k2
                        or rk["windowed_gather"]["launches"]
                        != un_k1 * (pieces - 2) // pieces):
            raise AssertionError(f"ckpt_path resume: kernel counts {rk}, "
                                 f"uninterrupted K1 {un_k1}, K2 {un_k2}")
        if not manifest_of(a_root)["complete"]:
            raise AssertionError("ckpt_path resume: the stage is not "
                                 "complete")
        return kill, res, man, committed_bytes, stray, kill_to_resume_s

    def reshard_chain():
        """The third chain, from the in-process armed leg's complete W = 4
        stage: resumed at W = 2 (the elastic re-shard), then a second
        W = 2 resume (a plain fast-forward)."""
        try:
            c_root = os.path.join(root, "armed")
            el = run_child(spec("reshard_w2", world=2), 0,
                           "ckpt_path reshard", CKPT_DIR=c_root, RESUME=1)
            same(el, "reshard")
            st = el["stats"]
            if (st["resume_resharded_pieces"] != pieces
                    or st["resume_world_mismatch"] != 1
                    or st["resume_fast_forwarded_pieces"] != pieces
                    or manifest_of(c_root)["world"] != 2):
                raise AssertionError(f"ckpt_path reshard: counters {st}")
            el2 = run_child(spec("resume_w2", world=2), 0,
                            "ckpt_path second W=2 resume",
                            CKPT_DIR=c_root, RESUME=1)
            same(el2, "second W=2 resume")
            st = el2["stats"]
            if (st["resume_resharded_pieces"] or st["resume_world_mismatch"]
                    or st["checkpoint_events"]
                    or st["resume_fast_forwarded_pieces"] != pieces):
                raise AssertionError(f"ckpt_path second W=2 resume: {st}")
            shutil.rmtree(c_root)
            chain_c.update(el=el, el2=el2)
        except BaseException as e:  # noqa: BLE001 — raised after the join
            chain_c["error"] = e

    def preempt_chain():
        """The second chain, run beside the kill chain: a SIGTERM at the
        second write, drained at the next piece boundary (with the flight
        recorder armed: its post-mortem must land beside the manifests),
        then resumed."""
        try:
            b_root = os.path.join(root, "B")
            pm_trace = os.path.join(root, "preempt_trace.json")
            pre = run_child(spec("preempt"), DRAIN_RC, "ckpt_path preempt",
                            CKPT_DIR=b_root, PREEMPT_GRACE_S=30,
                            FAULTS="ckpt.write::2=term", TRACE=pm_trace)
            if pre["token"] != os.path.abspath(b_root) or not any(
                    e[1:] == ["preempt", "drain"] for e in pre["events"]):
                raise AssertionError(f"ckpt_path preempt: token "
                                     f"{pre['token']}, events "
                                     f"{pre['events']}")
            postmortem = drain_postmortem(b_root, pm_trace)
            drained = pre["stats"]["checkpoint_events"]
            pres = run_child(spec("preempt_resume"), 0,
                             "ckpt_path preempt resume",
                             CKPT_DIR=b_root, RESUME=1)
            same(pres, "preempt resume")
            if pres["stats"]["resume_fast_forwarded_pieces"] != drained:
                raise AssertionError(f"ckpt_path preempt resume: "
                                     f"{pres['stats']}, {drained} pieces "
                                     "were committed")
            shutil.rmtree(b_root)
            chain_b.update(pre=pre, pres=pres, postmortem=postmortem,
                           drained=drained)
        except BaseException as e:  # noqa: BLE001 — raised after the join
            chain_b["error"] = e

    # the three chains run side by side, one child process each at a
    # time, for the script's time limit: every child shares the card (and
    # the host) with the children of the other chains, so its seconds are
    # not those of a child alone
    chain_b: dict = {}
    chain_c: dict = {}
    chains = [threading.Thread(target=preempt_chain),
              threading.Thread(target=reshard_chain)]
    for chain in chains:
        chain.start()
    try:
        kill, res, man, committed_bytes, stray, kill_to_resume_s = \
            kill_chain()
    finally:
        for chain in chains:
            chain.join()
    for box in (chain_b, chain_c):
        if "error" in box:
            raise box["error"]
    pre, pres = chain_b["pre"], chain_b["pres"]
    el, el2 = chain_c["el"], chain_c["el2"]
    postmortem, drained = chain_b["postmortem"], chain_b["drained"]
    children = {"kill": kill, "resume": res, "preempt": pre,
                "preempt_resume": pres, "reshard_w2": el,
                "resume_w2": el2}
    rec.update({
        "uninterrupted_first_s": rec["unarmed"]["first_s"],
        "uninterrupted_best_s": rec["unarmed"]["best_s"],
        "kill_rc": kill["rc"], "kill_process_s": kill["process_wall_s"],
        "manifest_after_kill": sorted(man["pieces"], key=int),
        "committed_bytes_verified": committed_bytes,
        "unnamed_meta_after_kill": stray,
        "resume_fast_forwarded_pieces": 2,
        "resume_run_s": res["run_s"], "resume_setup_s": res["setup_s"],
        "resume_process_s": res["process_wall_s"],
        "kill_to_resume_s": kill_to_resume_s,
        "preempt_rc": pre["rc"], "preempt_token": pre["token"],
        "preempt_pieces_committed": drained,
        "preempt_postmortem": postmortem,
        "reshard_run_s": el["run_s"],
        "reshard_regions_s": el["regions_s"],
        "reshard_process_s": el["process_wall_s"],
        "resume_regions_s": res["regions_s"],
        "second_w2_resume_run_s": el2["run_s"],
        "children": {k: {key: v.get(key) for key in (
            "rc", "setup_s", "run_s", "wall_s", "process_wall_s", "stats",
            "events", "kernel_counts", "regions_s")}
            for k, v in children.items()},
        "oracle": "equal"})
    if on_card:
        if "k1" not in res and un_k1:
            raise AssertionError("ckpt_path resume: K1 was not captured")
        rec["k1_resume"] = res.get("k1")
        rec["k2_resume"] = res.get("k2")
    rec["kernel_counts"] = {
        name: {"launches": rec["unarmed"]["kernel_counts"][name]["launches"]
               + rec["armed"]["kernel_counts"][name]["launches"]
               + sum((c.get("kernel_counts") or {}).get(name, {}).get(
                   "launches", 0) for c in children.values())}
        for name in ("windowed_gather", "splitter_probe")}
    return rec


def ckpt_small(ct, root: str, worlds=(1, 3, 4, 8), n: int = 1_000_000,
               device=None):
    """tests/test_checkpoint.py's scenarios at ``n`` rows a side (module
    docstring), each held to the uninterrupted run; yields one record per
    world and one for the re-shards."""
    import os
    import shutil
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.exec import recovery
    left, right, mv = baseline_inputs(n, seed=31)
    orc = oracle(left, right, mv)
    seq = [0]

    def fresh_root():
        seq[0] += 1
        return os.path.join(root, f"small{seq[0]}")

    def join(lt, rt, nc=CKPT_CHUNKS):
        return ct.pipelined_join(lt, rt, "k", "k", how="inner", n_chunks=nc)

    def sink_run(lt, rt, nc=CKPT_CHUNKS):
        return pipelined_step(ct, lt, rt, nc)

    def expect(st, label, **want):
        bad = {k: (st[k], v) for k, v in want.items() if st[k] != v}
        if bad:
            raise AssertionError(f"ckpt_small {label}: counters {bad}")

    def edit_manifest(r, fn):
        man = manifest_of(r)
        path = os.path.join(man.pop("dir"), "MANIFEST.json")
        fn(man, path)

    for w in worlds:
        env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
        lt = ct.Table.from_pydict(left, env)
        rt = ct.Table.from_pydict(right, env)
        with ckpt_env():
            base_j = join(lt, rt)
            base_s = sink_run(lt, rt)
            base_j3 = join(lt, rt, 3)
        check_dist(base_s, orc, w, f"ckpt_small W={w}")
        cases = {}
        for mode, run, base, same in (
                ("sinkless", join, base_j, same_tables),
                ("sink", sink_run, base_s, same_tables)):
            r = fresh_root()
            with ckpt_env(CKPT_DIR=r) as ck:
                same(run(lt, rt), base, f"ckpt_small W={w} {mode} armed")
                n_p = ck.stats()["checkpoint_events"]
            with ckpt_env(CKPT_DIR=r, RESUME=1) as ck:
                same(run(lt, rt), base, f"ckpt_small W={w} {mode} resume")
                expect(ck.stats(), f"W={w} {mode} resume",
                       resume_fast_forwarded_pieces=n_p,
                       checkpoint_events=0)
            cases[f"{mode}_resume"] = {"pieces": n_p}
            shutil.rmtree(r)
        # partial prefix: the last piece's commit dropped
        r = fresh_root()
        with ckpt_env(CKPT_DIR=r) as ck:
            join(lt, rt)
            n_p = ck.stats()["checkpoint_events"]

        def drop_last(man, path):
            del man["pieces"][str(max(int(k) for k in man["pieces"]))]
            man["epoch"] -= 1
            man["complete"] = False
            with open(path, "w", encoding="utf-8") as f:
                json.dump(man, f)

        edit_manifest(r, drop_last)
        with ckpt_env(CKPT_DIR=r, RESUME=1) as ck:
            same_tables(join(lt, rt), base_j, f"ckpt_small W={w} prefix")
            expect(ck.stats(), f"W={w} prefix",
                   resume_fast_forwarded_pieces=n_p - 1,
                   checkpoint_events=1)
        cases["partial_prefix"] = {"restored": n_p - 1, "recomputed": 1}
        # a corrupt page: the stage recomputes
        man = manifest_of(r)
        page = os.path.join(man["dir"], "piece_0.p0")
        raw = bytearray(open(page, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        with open(page, "wb") as f:
            f.write(bytes(raw))
        with ckpt_env(CKPT_DIR=r, RESUME=1) as ck:
            same_tables(join(lt, rt), base_j, f"ckpt_small W={w} corrupt")
            st = ck.stats()
            expect(st, f"W={w} corrupt", resume_fast_forwarded_pieces=0)
            if st["corrupt_pages"] < 1 or recovery_events() != [
                    ("ckpt.load", "corrupt", "recompute")]:
                raise AssertionError(f"ckpt_small W={w} corrupt: {st}")
        cases["corrupt_page"] = {"recomputed": n_p}
        shutil.rmtree(r)
        # a plan-token mismatch (another chunk count) starts over
        r = fresh_root()
        with ckpt_env(CKPT_DIR=r):
            join(lt, rt)
        with ckpt_env(CKPT_DIR=r, RESUME=1) as ck:
            same_tables(join(lt, rt, 3), base_j3,
                        f"ckpt_small W={w} token mismatch")
            expect(ck.stats(), f"W={w} token mismatch",
                   resume_fast_forwarded_pieces=0)
        shutil.rmtree(r)
        cases["token_mismatch"] = "recomputed"
        # a staged-only manifest is ignored
        r = fresh_root()
        with ckpt_env(CKPT_DIR=r):
            join(lt, rt)
        man = manifest_of(r)
        mpath = os.path.join(man["dir"], "MANIFEST.json")
        os.replace(mpath, mpath + ".staged")
        with ckpt_env(CKPT_DIR=r, RESUME=1) as ck:
            same_tables(join(lt, rt), base_j, f"ckpt_small W={w} staged")
            expect(ck.stats(), f"W={w} staged",
                   resume_fast_forwarded_pieces=0)
        shutil.rmtree(r)
        cases["staged_only"] = "ignored"
        # a persistent device OOM after two commits: the ladder's final
        # rung, then the resume
        r = fresh_root()
        spec = ",".join(f"ckpt.write::{i}=device_oom" for i in range(3, 12))
        with ckpt_env(CKPT_DIR=r, FAULTS=spec) as ck:
            try:
                recovery.run_with_recovery(
                    lambda nc=CKPT_CHUNKS: sink_run(lt, rt, nc), True,
                    lambda nc: sink_run(lt, rt, nc), "sink", env=env)
            except ct.ResumableAbort as e:
                from cylon_tpu_torch.status import DeviceOOMError
                if not isinstance(e.__cause__, DeviceOOMError) \
                        or e.token != os.path.abspath(r):
                    raise
            else:
                raise AssertionError(f"ckpt_small W={w}: no ResumableAbort")
            ev = recovery_events()
            expect(ck.stats(), f"W={w} oom", checkpoint_events=2)
            if ev[-1] != ("sink", "device_oom", "resumable_abort"):
                raise AssertionError(f"ckpt_small W={w} oom: events {ev}")
        with ckpt_env(CKPT_DIR=r, RESUME=1) as ck:
            same_tables(sink_run(lt, rt), base_s, f"ckpt_small W={w} oom")
            expect(ck.stats(), f"W={w} oom resume",
                   resume_fast_forwarded_pieces=2)
        shutil.rmtree(r)
        cases["oom_final_rung"] = {"events": len(ev), "restored": 2}
        yield {"phase": "ckpt_small", "world": w, "rows_per_side": n,
               "cases": cases, "oracle": "equal"}
        del lt, rt, base_j, base_s, base_j3
        torch.cuda.empty_cache()
    # the re-shards, each against the uninterrupted run at the old world
    envs = {}
    reshards = {}
    for w_from, w_to in ((4, 2), (4, 1), (2, 4)):
        tabs = {}
        for w in (w_from, w_to):
            if w not in envs:
                envs[w] = ct.CylonEnv(VirtualMeshConfig(w), device=device)
            tabs[w] = (ct.Table.from_pydict(left, envs[w]),
                       ct.Table.from_pydict(right, envs[w]))
        for mode, run, keys in (("sinkless", join, ["k", "a", "b"]),
                                ("sink", sink_run, ["k"])):
            r = fresh_root()
            with ckpt_env(CKPT_DIR=r) as ck:
                base = run(*tabs[w_from])
                n_p = ck.stats()["checkpoint_events"]
            label = f"ckpt_small {w_from}->{w_to} {mode}"
            with ckpt_env(CKPT_DIR=r, RESUME=1) as ck:
                same_sorted_rows(run(*tabs[w_to]), base, keys, label)
                expect(ck.stats(), label, resume_resharded_pieces=n_p,
                       resume_world_mismatch=1,
                       resume_fast_forwarded_pieces=n_p)
                if recovery_events() != [("ckpt.reshard", "world_mismatch",
                                           "detected")]:
                    raise AssertionError(f"{label}: events")
            with ckpt_env(CKPT_DIR=r, RESUME=1) as ck:
                same_sorted_rows(run(*tabs[w_to]), base, keys,
                                 label + " again")
                expect(ck.stats(), label + " again",
                       resume_resharded_pieces=0, resume_world_mismatch=0,
                       resume_fast_forwarded_pieces=n_p, checkpoint_events=0)
            reshards[f"{w_from}->{w_to}_{mode}"] = {"pieces": n_p}
            shutil.rmtree(r)
        del tabs
        torch.cuda.empty_cache()
    yield {"phase": "ckpt_small", "world": "reshard", "rows_per_side": n,
           "cases": reshards, "oracle": "equal"}


@contextlib.contextmanager
def ckpt_root(parent=None):
    """A fresh checkpoint root (under ``parent``, or the system's
    temporary directory), removed at the end."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="cylon_ckpt_", dir=parent)
    try:
        yield root
    finally:
        shutil.rmtree(root, ignore_errors=True)


def ckpt_phases(ct, left, right, orc, root, device=None,
                small_rows: int = 1_000_000):
    """``ckpt_path`` on ``left``/``right``, then ``procs_ckpt`` on its
    tables (its children start before ``ckpt_path`` and wait), then
    ``ckpt_small`` at ``small_rows`` a side; yields the phase records
    (the K1/K2 checks of the resumed run after ``ckpt_path``'s)."""
    launched = procs_ckpt_launch(root, device)
    try:
        crec = ckpt_path(ct, left, right, orc, root, device=device)
        checks = [crec.pop(key, None) for key in ("k1_resume", "k2_resume")]
        yield crec
        yield from (c for c in checks if c is not None)
        yield procs_ckpt({
            "digest": crec["digest"], "shard_digest": crec["shard_digest"],
            "pieces": crec["pieces"]}, launched, device=device)
    finally:
        for key in ("armed", "kill", "resume"):
            _procs_kill(launched[key])
        _procs_kill([p for p, _t0 in launched["reshard"].values()])
    yield from ckpt_small(ct, root, worlds=SMALL_WORLDS, n=small_rows,
                          device=device)


# ---------------------------------------------------------------------------
# the serving tier: concurrent tenants under admission control
# (exec/scheduler.py, exec/session.py, exec/fleet.py)
# ---------------------------------------------------------------------------

#: bench_serving's per-tenant query mixes 0-3 (scripts/bench_serving.py):
#: tenant i cycles SERVE_MIXES[i] in a closed loop of SERVE_QUERIES
#: queries.  ``qpipe`` is lineitem ⋈ orders through pipelined_join
#: (n_chunks 4) into a GroupBySink: it yields per piece and its packed
#: sources are the spillable state admission manages
SERVE_MIXES = (("qpipe", "q6", "q1"), ("qpipe", "q12"),
               ("q3", "q14", "q15"), ("q5", "q17"))
SERVE_QUERIES = 3
#: the tables each query reads: the footprint estimate's input
SERVE_TABLES = {
    "q1": ("lineitem",), "q3": ("customer", "orders", "lineitem"),
    "q5": ("customer", "orders", "lineitem", "supplier", "nation",
           "region"),
    "q6": ("lineitem",), "q12": ("orders", "lineitem"),
    "q14": ("lineitem", "part"), "q15": ("lineitem", "supplier"),
    "q17": ("lineitem", "part"), "qpipe": ("orders", "lineitem")}
#: serve_small's rows a side and its tenants' pipelined chunks
SERVE_SMALL_ROWS = SMALL_ROWS
SERVE_CHUNKS = 4


def qpipe(ct, dfs):
    """The serving mix's pipelined query: lineitem ⋈ orders into a
    GroupBySink keyed on l_orderkey, quantity and price summed."""
    sink = ct.GroupBySink("l_orderkey", [("l_quantity", "sum"),
                                         ("l_extendedprice", "sum")])
    ct.pipelined_join(dfs["lineitem"].table, dfs["orders"].table,
                      "l_orderkey", "o_orderkey", how="inner",
                      n_chunks=4, sink=sink)
    return sink.finalize()


def qpipe_oracle(cols: dict) -> dict:
    """qpipe in numpy: o_orderkey is an arange, so every lineitem row
    joins, and each order's sums are a ``bincount``."""
    li = cols["lineitem"]
    lk = np.asarray(li["l_orderkey"].data)
    keys = np.unique(lk)
    qty = np.bincount(lk, np.asarray(li["l_quantity"].data)).astype(
        np.int64)
    price = np.bincount(lk, np.asarray(li["l_extendedprice"].data))
    return {"l_orderkey": keys, "l_quantity_sum": qty[keys],
            "l_extendedprice_sum": price[keys]}


def by_key(out, key: str) -> dict:
    """A result's columns sorted by ``key`` (unique per row)."""
    cols = out.to_pydict()
    order = stable_order(cols[key])
    return {name: np.asarray(v)[order] for name, v in cols.items()}


def sort_bits(x: torch.Tensor) -> torch.Tensor:
    """A same-width signed integer view of ``x`` whose sort is a fixed
    order of its bit patterns (bool as int8)."""
    if x.dtype == torch.bool:
        return x.to(torch.int8)
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[x.element_size()]
    return x if x.dtype == signed else x.view(signed)


def serve_digest(out) -> str:
    """sha256 of a query result's raw bytes, its live rows in a canonical
    order (stable sorts on the device by every column's bit pattern, last
    column first), so that layout and row order do not count; a float
    result by its bits.  Two results with equal digests are equal bit for
    bit.  A result that several processes hold is gathered whole first
    (``Table.host_columns``) and sorted on this process's device, so one
    result gives one digest whichever processes hold it."""
    import hashlib
    import struct
    from cylon_tpu_torch.utils.host import host_arrays
    h = hashlib.sha256()
    if isinstance(out, float):
        h.update(struct.pack("<d", out))
        return h.hexdigest()
    t = getattr(out, "table", out)
    dev = t.column(t.column_names[0]).data.device
    cols = []
    if t.env.multi_process:
        for name, (data, valid) in t.host_columns().items():
            cols.append((name, torch.from_numpy(data).to(dev),
                         None if valid is None
                         else torch.from_numpy(valid).to(dev)))
        n = int(np.asarray(t.valid_counts).sum())
    else:
        vc = torch.as_tensor(np.asarray(t.valid_counts), device=dev)
        live = (torch.arange(t.capacity, device=dev)[None, :]
                < vc[:, None]).reshape(-1)
        for name in t.column_names:
            c = t.column(name)
            cols.append((name, c.data[live],
                         None if c.validity is None else c.validity[live]))
        n = int(vc.sum())
    perm = torch.arange(n, device=dev)
    for _, data, valid in reversed(cols):
        for x in (valid, data):
            if x is not None and n:
                perm = perm[torch.sort(sort_bits(x[perm]), stable=True)[1]]
    flat = [x[perm] if x is not None else None
            for _, d, v in cols for x in (d, v)]
    pulled = host_arrays(flat)
    for k, (name, _, _) in enumerate(cols):
        h.update(name.encode())
        for x in pulled[2 * k:2 * k + 2]:
            if x is not None:
                h.update(np.ascontiguousarray(x).tobytes())
        dic = t.column(name).dictionary
        if isinstance(dic, np.ndarray):
            h.update("\x00".join(map(str, dic.tolist())).encode())
    return h.hexdigest()


def wait_result(out) -> None:
    if not isinstance(out, float):
        t = getattr(out, "table", out)
        sync_pull(t.column(t.column_names[0]).data)


def serve_tenant(mix, queries: int, run_query, record: list,
                 on_start=None):
    """A tenant's closed loop: ``queries`` queries cycling ``mix``, each
    recorded in ``record`` as (query, latency, result) as it completes
    (:func:`digest_records` digests the results after the pass, so no
    tenant's latency holds another's digest).  The loop clears ``record``
    on entry: a requeued tenant replays from the top, and its last full
    replay is what counts."""
    def fn():
        if on_start is not None:
            on_start()
        record.clear()
        for k in range(queries):
            q = mix[k % len(mix)]
            t0 = time.perf_counter()
            out = run_query(q)
            wait_result(out)
            record.append({"q": q, "latency_s": time.perf_counter() - t0,
                           "out": out})
            del out
        return len(record)
    return fn


def digest_records(records, check=None) -> None:
    """Replace each record's result by its digest (after ``check(q,
    out)`` where given)."""
    for rec in records:
        out = rec.pop("out")
        if check is not None:
            check(rec["q"], out)
        rec["digest"] = serve_digest(out)
        del out


def serve_pass(env, plans, run_query, policy: str, budget: int,
               ledger_budget: int, queries: int = SERVE_QUERIES,
               late: int = 0, ckpt: str | None = None) -> dict:
    """One concurrent pass of ``plans`` under a QueryScheduler (a plan's
    ``queries``, where given, overrides ``queries``): the
    admission budget ``budget``, the ledger's ``ledger_budget``, and with
    ``late`` the last ``late`` tenants held back and submitted at
    priority 5 from the first tenant's loop; with ``ckpt`` the
    checkpoint root armed for the pass.  Returns the records, sessions,
    seconds, kernel launches and counters, and K2's arguments at its
    first launch in the pass (``k2_probe``)."""
    from cylon_tpu_torch.exec import checkpoint, memory, recovery
    from cylon_tpu_torch.exec.scheduler import QueryScheduler
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    records = {p["name"]: [] for p in plans}
    early, held = plans[:len(plans) - late], plans[len(plans) - late:]
    memory.reset_stats()
    recovery.reset_events()
    sched = QueryScheduler(env, policy=policy, budget_bytes=budget or None)
    fired = []

    def submit(p, priority=0, on_start=None):
        sched.submit(p["name"], serve_tenant(
            p["mix"], p.get("queries", queries), run_query,
            records[p["name"]],
            on_start=on_start), footprint_bytes=p["footprint"],
            priority=priority)

    def submit_late():
        # on the first tenant's thread, under the baton; a requeued
        # replay of that tenant does not submit again
        if fired or not held:
            return
        fired.append(True)
        for p in held:
            submit(p, priority=5)

    switches = {"CKPT_DIR": ckpt} if ckpt else {}
    captured: dict = {}
    with knobs(HBM_BUDGET_BYTES=ledger_budget), ckpt_env(**switches):
        for i, p in enumerate(early):
            submit(p, on_start=submit_late if i == 0 else None)
        wg.reset_counts()
        sp.reset_counts()
        t0 = time.perf_counter()
        with capturing(sp, "count_ge_splitters", captured, "probe"):
            sessions = sched.run()
        if env.on_cuda:
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = {"windowed_gather": dict(wg.COUNTS),
                  "splitter_probe": dict(sp.COUNTS)}
        ck = checkpoint.stats()
        events = [(e["site"], e["kind"], e["action"], e.get("session"))
                  for e in recovery.drain_events()]
    mem = memory.stats()
    for rec in records.values():
        digest_records(rec)
    return {"sched": sched, "sessions": sessions, "records": records,
            "elapsed_s": elapsed, "kernel_counts": counts,
            "memory": mem, "ckpt": ck, "events": events,
            "k2_probe": captured.get("probe")}


def serve_report(run: dict, solo: dict, rows: dict, label: str) -> dict:
    """A pass's record: every tenant's answers bit-equal to its solo run
    (the same queries, digests equal, in order), no failed session; per
    tenant p50/p99 latency, service, park and admission-wait seconds."""
    failures = [f"{s.name}: {type(s.error).__name__}: {s.error}"
                for s in run["sessions"] if s.error is not None]
    if failures:
        raise AssertionError(f"{label}: failed tenants {failures}")
    tenants = {}
    served = 0
    for s in run["sessions"]:
        got, want = run["records"][s.name], solo[s.name]
        if [(g["q"], g["digest"]) for g in got] \
                != [(w_["q"], w_["digest"]) for w_ in want]:
            raise AssertionError(
                f"{label}: tenant {s.name} differs from its solo run: "
                f"{[(g['q'], g['digest'][:12]) for g in got]} against "
                f"{[(w_['q'], w_['digest'][:12]) for w_ in want]}")
        lats = [g["latency_s"] for g in got]
        served += sum(rows["lineitem"] for g in got
                      if "lineitem" in SERVE_TABLES[g["q"]])
        summ = s.summary()
        tenants[s.name] = {
            "mix": [g["q"] for g in got], "latencies_s": lats,
            "p50_latency_s": float(np.percentile(lats, 50)),
            "p99_latency_s": float(np.percentile(lats, 99)),
            "latency_s": summ["latency_s"], "service_s": s.service_s,
            "admission_wait_s": s.admission_wait_s,
            "park_s": s.latency_s - s.service_s - s.admission_wait_s,
            "slices": s.slices, "outcome": s.outcome(),
            "preemptions": s.preemptions, "requeues": s.requeues,
            "pieces_committed": s.pieces_committed,
            "bytes_admitted": s.bytes_admitted,
            "admission_waits": s.admission_waits,
            "recovery_events": [e for e in run["events"]
                                if e[3] == s.name],
            "bit_equal_to_solo": True}
    st = run["sched"].stats()
    return {"elapsed_s": run["elapsed_s"], "tenants": tenants,
            "lineitem_rows_served": served,
            "lineitem_rows_per_s": served / run["elapsed_s"],
            "scheduler": st, "kernel_counts": run["kernel_counts"],
            "peak_ledger_bytes": run["memory"]["peak_ledger_bytes"],
            "cross_session_evictions":
                run["memory"]["cross_session_evictions"],
            "spill_events": run["memory"]["spill_events"],
            "bytes_spilled": run["memory"]["bytes_spilled"],
            "checkpoint": run["ckpt"], "recovery_events": run["events"],
            "slices": st["slices"],
            "park_s": sum(t["park_s"] for t in tenants.values()),
            "bit_equal": True}


def serve_k2(env, label: str, args, timed: bool = False) -> dict:
    """K2 at a serve route's first launch (``args``, as captured): on the
    card held bit-equal to its plain version (:func:`k2_check`); on the
    host, where the wrapper is the plain version, its shapes only."""
    from cylon_tpu_torch.ops import splitter_probe as sp
    if args is None:
        raise AssertionError(f"K2 {label}: the route never launched K2")
    ops, sops = args
    if env.on_cuda:
        return k2_check(sp, label, ops, sops, timed=timed)
    return {"phase": "k2", "case": label, "K": len(ops),
            "S": int(sops[0].shape[0]), "cap": int(ops[0].shape[0]),
            "widths": [str(o.dtype) for o in ops], "bit_equal": None}


def serve_path(ct, dfs, env, orc: dict, rows: dict, root: str) -> list:
    """Four tenants of bench_serving's mixes 0-3 on one world over the
    TPC-H tables ``dfs`` (module docstring): the solo pass, the oracles,
    the "auto" budgets, the concurrent ``fair`` pass, then the preempt leg
    (``priority``, checkpoints armed under ``root``, t3 submitted late at
    priority 5).  Yields one record per leg; each holds, under ``"k2"``,
    K2 at its first launch in the solo pass and in that leg's pass, held
    bit-equal to its plain version (:func:`serve_k2`)."""
    from cylon_tpu_torch import tpch
    from cylon_tpu_torch.exec import memory
    from cylon_tpu_torch.exec.scheduler import estimate_footprint
    from cylon_tpu_torch.ops import splitter_probe as sp

    def run_query(q):
        return qpipe(ct, dfs) if q == "qpipe" \
            else getattr(tpch, q)(dfs, env=env)

    def check(q, out):
        if q == "qpipe":
            same_tpch(by_key(out, "l_orderkey"), orc["qpipe"],
                      "serve_path qpipe")
        elif q in orc:
            same_tpch(out, orc[q], f"serve_path {q}")

    plans = [{"name": f"t{i}", "mix": mix, "footprint": estimate_footprint(
        *[dfs[t] for t in sorted({t for q in mix for t in SERVE_TABLES[q]})])}
        for i, mix in enumerate(SERVE_MIXES)]
    solo, solo_s = {}, {}
    checked = set()

    def check_once(q, out):
        if q not in checked:
            check(q, out)
            checked.add(q)

    captured: dict = {}
    with capturing(sp, "count_ge_splitters", captured, "probe"):
        for p in plans:
            rec: list = []
            t0 = time.perf_counter()
            serve_tenant(p["mix"], SERVE_QUERIES, run_query, rec)()
            solo_s[p["name"]] = time.perf_counter() - t0
            digest_records(rec, check=check_once)
            solo[p["name"]] = rec
    if checked < {"q1", "q3", "q5", "q6", "qpipe"}:
        raise AssertionError(f"serve_path: oracles checked {checked}")
    w = env.world_size
    k2_solo = serve_k2(env, f"serve_solo_w{w}_shard0",
                       captured.pop("probe", None), timed=True)
    # bench_serving's "auto" budgets: admission fits the two smallest
    # tenants together; the ledger holds 1.6 of one qpipe's peak, so two
    # packing tenants evict each other's cold sources
    foots = sorted(p["footprint"] for p in plans)
    budget = int(1.05 * (foots[0] + foots[1]))
    memory.reset_stats()
    wait_result(run_query("qpipe"))
    qpipe_peak = memory.stats()["peak_ledger_bytes"]
    ledger_budget = int(1.6 * qpipe_peak)
    solo_sum = sum(solo_s.values())
    base = {"world": env.world_size, "tenants": len(plans),
            "queries_per_tenant": SERVE_QUERIES,
            "mixes": {p["name"]: list(p["mix"]) for p in plans},
            "footprints": {p["name"]: p["footprint"] for p in plans},
            "admission_budget_bytes": budget,
            "ledger_budget_bytes": ledger_budget,
            "qpipe_peak_ledger_bytes": qpipe_peak,
            "solo_s": solo_s, "solo_sum_s": solo_sum,
            "solo_latencies_s": {k: [r["latency_s"] for r in v]
                                 for k, v in solo.items()},
            "oracle": "equal",
            "oracles": "q1, q3, q5, q6 tpch_oracle; qpipe bincount"}
    run = serve_pass(env, plans, run_query, "fair", budget, ledger_budget)
    k2_fair = serve_k2(env, f"serve_fair_w{w}_shard0", run.pop("k2_probe"))
    conc = serve_report(run, solo, rows, "serve_path fair")
    del run
    st = conc["scheduler"]
    if st["admission_waits"] < 1 or conc["cross_session_evictions"] < 1:
        raise AssertionError(f"serve_path: admission waits "
                             f"{st['admission_waits']}, cross-session "
                             f"evictions {conc['cross_session_evictions']};"
                             " both must be at least 1")
    if env.on_cuda and \
            conc["kernel_counts"]["splitter_probe"]["launches"] < 1:
        raise AssertionError(f"serve_path: K2 launches "
                             f"{conc['kernel_counts']}")
    if conc["recovery_events"]:
        raise AssertionError(f"serve_path: recovery events "
                             f"{conc['recovery_events']}")
    yield {"phase": "serve_path", "policy": "fair", **base, **conc,
           "concurrent_over_solo_sum": conc["elapsed_s"] / solo_sum,
           "k2": {"solo": k2_solo, "fair": k2_fair},
           # for procs_serve, popped before the record is printed
           "_solo": {"solo": solo, "ledger_budget": ledger_budget}}
    # the preempt leg: t3 arrives at priority 5 while t0 and t1 hold the
    # admission budget; the lower-ranked qpipe tenant drains at a piece
    # boundary, requeues and resumes in process past its committed pieces
    import os
    run = serve_pass(env, plans, run_query, "priority", budget,
                     ledger_budget, late=1,
                     ckpt=os.path.join(root, "serve_preempt"))
    k2_pre = serve_k2(env, f"serve_preempt_w{w}_shard0", run.pop("k2_probe"))
    pre = serve_report(run, solo, rows, "serve_path preempt")
    del run
    st = pre["scheduler"]
    victims = [n for n, t in pre["tenants"].items()
               if t["outcome"] == "preempted_requeued"]
    if st["preemptions"] < 1 or st["requeues"] < 1 or not victims \
            or pre["checkpoint"]["resume_fast_forwarded_pieces"] < 1:
        raise AssertionError(f"serve_path preempt: {st}, "
                             f"checkpoint {pre['checkpoint']}")
    if any(e[3] not in victims for e in pre["recovery_events"]) or not any(
            e[1:3] == ("preempt", "drain") for e in pre["recovery_events"]):
        raise AssertionError(f"serve_path preempt: events outside the "
                             f"victim {pre['recovery_events']}")
    yield {"phase": "serve_path_preempt", "policy": "priority",
           "world": env.world_size, "late_tenant": plans[-1]["name"],
           "victims": victims, **pre,
           "concurrent_over_solo_sum": pre["elapsed_s"] / solo_sum,
           "k2": {"preempt": k2_pre}}


def serve_small_cols(n: int, seed: int = 29) -> dict:
    rng = np.random.default_rng(seed)
    return {"lk": rng.integers(0, n // 2, n).astype(np.int64),
            "a": rng.integers(0, 1000, n).astype(np.int64),
            "rk": rng.integers(0, n // 2, n).astype(np.int64),
            "b": rng.integers(0, 1000, n).astype(np.int64)}


def serve_small_tenant(ct, cols: dict, env, i: int, nc: int = SERVE_CHUNKS):
    """serve_small's tenant ``t<i>``: GroupBySink + pipelined_join +
    finalize over the tables with the left payload scaled by ``i + 1`` (so
    tenants' answers differ); returns the result's digest."""
    def fn():
        lt = ct.Table.from_pydict({"k": cols["lk"],
                                   "a": cols["a"] * (i + 1)}, env)
        rt = ct.Table.from_pydict({"k": cols["rk"], "b": cols["b"]}, env)
        return result_digest(pipelined_step(ct, lt, rt, nc))
    return fn


def serve_child(spec: dict) -> int:
    """A process of ``serve_small``: ``spec["tenants"]`` tenants of
    :func:`serve_small_tenant` under a QueryScheduler at
    ``spec["world"]``, from the parent's ``.npy`` files, under the
    switches the parent set.  Prints one JSON line: the digests, outcomes,
    scheduler and checkpoint counters and recovery events."""
    import os
    t_start = time.perf_counter()
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.exec import checkpoint, recovery
    from cylon_tpu_torch.exec.scheduler import QueryScheduler
    cols = {name: np.load(os.path.join(spec["data"], f"{name}.npy"))
            for name in ("lk", "a", "rk", "b")}
    env = ct.CylonEnv(VirtualMeshConfig(spec["world"]),
                      device=spec.get("device"))
    sched = QueryScheduler(env, policy="fifo", max_concurrency=1)
    for i in range(spec["tenants"]):
        sched.submit(f"t{i}", serve_small_tenant(ct, cols, env, i))
    t0 = time.perf_counter()
    sched.run()
    rec = {"phase": "serve_child", "mode": spec["mode"],
           "world": spec["world"], "run_s": time.perf_counter() - t0,
           "digests": {s.name: s.result for s in sched.sessions},
           "outcomes": {s.name: s.outcome() for s in sched.sessions},
           "errors": {s.name: repr(s.error)[:300] for s in sched.sessions
                      if s.error is not None},
           "scheduler": sched.stats(), "stats": checkpoint.stats(),
           "events": [(e["site"], e["kind"], e["action"], e.get("session"))
                      for e in recovery.recovery_events()],
           "wall_s": time.perf_counter() - t_start}
    print(json.dumps(rec), flush=True)
    return 0


def serve_small(ct, root: str, n: int = SERVE_SMALL_ROWS,
                device=None) -> dict:
    """The serving tier's correctness at ``n`` rows a side (module
    docstring): typed admission-deadline and requeue-overflow failures at
    W = 1; at W = 4 an eviction between a prepared piece and its consume,
    a fleet drain with its breadcrumb and a relaunch at W = 2 with
    resume, and a child killed inside tenant t0's checkpoint write,
    resumed; every answer held to its solo run."""
    import gc
    import os
    import shutil
    from cylon_tpu_torch import status
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.exec import fleet, memory, pipeline, scheduler
    from cylon_tpu_torch.exec.scheduler import QueryScheduler
    rec = {"phase": "serve_small", "rows_per_side": n}
    cols = serve_small_cols(n)
    # -- typed failures at W = 1 -------------------------------------------
    env1 = ct.CylonEnv(VirtualMeshConfig(1), device=device)
    solo1 = serve_small_tenant(ct, cols, env1, 0, nc=6)()

    def holder():
        for _ in range(6):
            time.sleep(0.02)
            scheduler.maybe_yield()
        return "held"

    sched = QueryScheduler(env1, policy="fifo", budget_bytes=1000,
                           admission_timeout_s=0.05)
    a = sched.submit("tA", holder, footprint_bytes=600)
    b = sched.submit("tB", lambda: 1, footprint_bytes=600)
    sched.run()
    if a.result != "held" or not isinstance(
            b.error, status.AdmissionTimeoutError) \
            or b.outcome() != "failed_typed" or b.error.session != "tB":
        raise AssertionError(f"serve_small: admission deadline {b.error!r}")
    rec["admission_timeout"] = {"waited_s": b.error.waited_s,
                                "outcome": b.outcome(),
                                "stats": sched.stats()}
    with ckpt_env(CKPT_DIR=os.path.join(root, "overflow")):
        sched = QueryScheduler(env1, policy="priority", max_concurrency=1,
                               requeue_capacity=0)
        runs = []
        fn_a = serve_small_tenant(ct, cols, env1, 0, nc=6)

        def tenant_a():
            runs.append(1)
            if len(runs) == 1:
                sched.submit("tB", serve_small_tenant(ct, cols, env1, 1,
                                                      nc=2), priority=5)
            return fn_a()

        a = sched.submit("tA", tenant_a)
        sched.run()
        tb = next(s for s in sched.sessions if s.name == "tB")
        if not isinstance(a.error, status.RequeueOverflowError) \
                or not isinstance(a.error.__cause__, status.ResumableAbort) \
                or tb.state != "done" or a.outcome() != "failed_typed":
            raise AssertionError(f"serve_small: requeue overflow "
                                 f"{a.error!r}, tB {tb.state}")
        rec["requeue_overflow"] = {"outcome": a.outcome(),
                                   "cause": type(a.error.__cause__).__name__,
                                   "stats": sched.stats()}
    # the failed sessions' tracebacks hold their tables
    del env1, sched, a, b, tb, fn_a, tenant_a
    # -- W = 4: an eviction between a prepared piece and its consume -------
    w = 4
    env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
    solo = {f"t{i}": serve_small_tenant(ct, cols, env, i)()
            for i in range(3)}
    if solo["t0"] != solo1:
        raise AssertionError("serve_small: W = 4 and W = 1 differ")
    calls, admit = [], memory.ensure_headroom

    def spy(env_, need, scratch=0, site="spill.evict"):
        calls.append((memory.balance(), int(need), int(scratch)))
        return admit(env_, need, scratch, site)

    gc.collect()     # no leftover owner may count in the balance
    memory.ensure_headroom = spy
    try:
        serve_small_tenant(ct, cols, env, 0)()
    finally:
        memory.ensure_headroom = admit
    (b0, need_l, _), (b1, need_r, scr_r) = calls[:2]
    # the right source's admission evicts the left one: every left window
    # then uploads from host memory as its piece is prepared
    budget = b1 - b0 - need_l + need_r + scr_r
    seen, orig = {}, pipeline._interleave

    def evict_now():
        seen["readmits_before"] = memory.stats()["readmit_events"]
        seen["evictions_before"] = memory.stats()["cross_session_evictions"]
        # a need the budget cannot hold beside t0's resident source
        scheduler.admit_allocation(env, budget)
        seen["cross_session_evictions"] = \
            memory.stats()["cross_session_evictions"] \
            - seen["evictions_before"]
        return "evicted"

    sched = QueryScheduler(env, policy="priority")

    def boundary():
        # t0 at a piece boundary with the next piece's window prepared
        # (uploaded, not yet consumed): t1 (priority 9) is admitted and
        # runs before t0 consumes it
        if not seen and memory.stats()["readmit_events"] >= 2:
            seen["submitted"] = True
            sched.submit("t1", evict_now, priority=9)
        orig()

    gc.collect()
    with knobs(HBM_BUDGET_BYTES=budget):
        memory.reset_stats()
        pipeline._interleave = boundary
        try:
            t0s = sched.submit("t0", serve_small_tenant(ct, cols, env, 0))
            sched.run()
        finally:
            pipeline._interleave = orig
        st = memory.stats()
    t1s = next((s for s in sched.sessions if s.name == "t1"), None)
    if t0s.result != solo["t0"] or t1s is None or t1s.result != "evicted" \
            or seen.get("cross_session_evictions", 0) < 1 \
            or st["readmit_events"] <= seen["readmits_before"]:
        raise AssertionError(f"serve_small: eviction between prefetch and "
                             f"consume {seen}, {st}, t0 {t0s.error!r}, "
                             f"admissions {calls}, evicted "
                             f"{memory.eviction_log()}")
    rec["evict_between_prefetch_and_consume"] = {
        "budget_bytes": budget, **seen,
        "windows_uploaded": st["readmit_events"],
        "bytes_spilled": st["bytes_spilled"], "bit_equal_to_solo": True}
    # -- a fleet drain at W = 4, relaunched at W = 2 with resume -----------
    data = os.path.join(root, "serve_data")
    os.makedirs(data, exist_ok=True)
    for name, arr in cols.items():
        np.save(os.path.join(data, f"{name}.npy"), arr)
    f_root = os.path.join(root, "fleet")
    with ckpt_env(CKPT_DIR=f_root):
        ctrl = fleet.ResizeController(env, target_world=2,
                                      queue_depth_high=2)
        sched = QueryScheduler(env, policy="fifo", max_concurrency=1,
                               fleet=ctrl)
        for i in range(3):
            sched.submit(f"t{i}", serve_small_tenant(ct, cols, env, i))
        sched.run()
        outcomes = {s.name: s.outcome() for s in sched.sessions}
        crumb_path = os.path.join(f_root, "FLEET_RESIZE.json")
        if sched.resize_target != 2 or not os.path.exists(crumb_path) \
                or not set(outcomes.values()) <= {"completed",
                                                  "drained_resumable"}:
            raise AssertionError(f"serve_small: fleet drain {outcomes}, "
                                 f"target {sched.resize_target}")
        with open(crumb_path, encoding="utf-8") as f:
            crumb = json.load(f)
        if crumb["target_world"] != 2 or crumb["from_world"] != w:
            raise AssertionError(f"serve_small: breadcrumb {crumb}")
        fstats = sched.stats()
    spec = {"serve": True, "data": data, "tenants": 3,
            "device": device}
    k_root = os.path.join(root, "kill")
    # the relaunch at W = 2 and the child killed inside tenant t0's
    # second checkpoint write (its own root) run side by side
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        relaunch = pool.submit(
            run_child, {**spec, "mode": "fleet_relaunch", "world": 2}, 0,
            "serve_small relaunch", CKPT_DIR=f_root, RESUME=1)
        killed = pool.submit(
            run_child, {**spec, "mode": "kill", "world": w}, -9,
            "serve_small kill", CKPT_DIR=k_root,
            FAULTS="ckpt.write::2=kill@t0")
        rel = relaunch.result()
        killed.result()
    if rel["digests"] != solo or set(rel["outcomes"].values()) \
            != {"completed"}:
        raise AssertionError(f"serve_small relaunch: {rel}")
    rec["fleet"] = {"outcomes": outcomes, "breadcrumb": crumb,
                    "stats": fstats,
                    "relaunch": {k: rel[k] for k in (
                        "world", "outcomes", "stats", "scheduler", "run_s",
                        "process_wall_s")}}
    # -- the killed child's resume ------------------------------------------
    res = run_child({**spec, "mode": "kill_resume", "world": w}, 0,
                    "serve_small kill resume", CKPT_DIR=k_root, RESUME=1)
    if res["digests"] != solo or set(res["outcomes"].values()) \
            != {"completed"} \
            or res["stats"]["resume_fast_forwarded_pieces"] < 1:
        raise AssertionError(f"serve_small kill resume: {res}")
    rec["kill_resume"] = {k: res[k] for k in (
        "outcomes", "stats", "scheduler", "events", "run_s",
        "process_wall_s")}
    shutil.rmtree(data, ignore_errors=True)
    rec["oracle"] = "equal to the solo runs"
    return rec


# ---------------------------------------------------------------------------
# streaming (stream/): StreamTable, IncrementalView, TumblingWindowJoin
# ---------------------------------------------------------------------------

#: scripts/bench_streaming.py's view aggregations, window, stride,
#: lateness and seed; its shapes stay, its scale is raised
STREAM_AGGS = [("amount", "sum"), ("amount", "count"), ("amount", "min"),
               ("amount", "max"), ("amount", "mean"), ("amount", "var"),
               ("amount", "std"), ("qty", "sum")]
STREAM_WINDOW = 100
STREAM_STRIDE = 60
STREAM_LATENESS = 30
STREAM_SEED = 0
#: stream_path: 40 batches of 4,194,304 rows over 65,536 keys (the
#: broadcast route's row limit, so every close broadcasts the dims)
STREAM_BATCHES = 40
STREAM_ROWS = 4_194_304
STREAM_KEYS = 65_536
#: stream_serve's batches of the same stream, beside a TPC-H tenant
STREAM_SERVE_BATCHES = 16
#: stream_small: 8 batches of 125,000 rows (1M in all)
STREAM_SMALL_BATCHES = 8
STREAM_SMALL_ROWS = 125_000
#: the slack allowed in the card's allocated bytes after a stream phase
#: is torn down (a leaked chunk or window buffer is ≥ 128 MB here)
STREAM_ALLOC_SLACK = 64 << 20


def stream_batches(n_batches: int, rows: int, keys: int = STREAM_KEYS,
                   seed: int = STREAM_SEED, device=None) -> list:
    """bench_streaming's ``make_batches``: uniform keys, ``qty`` int64 in
    1-50, ``amount`` integer cents as float64 in [100, 100000), event
    time ``b·stride + U[0, stride)`` with 5% of the rows pushed 3 windows
    back.  Drawn on ``device`` (the card when there is one) by torch's
    generator seeded with ``seed``, batch after batch, then pulled as
    numpy arrays: every process that draws the same count of batches of
    the same size on the same kind of device gets the same batches, the
    first ``k`` of them whatever the count."""
    dev = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(lo, hi):
        return torch.randint(lo, hi, (rows,), generator=gen, device=dev)

    out = []
    for b in range(n_batches):
        t = b * STREAM_STRIDE + draw(0, STREAM_STRIDE)
        late = torch.rand(rows, generator=gen, device=dev) < 0.05
        t = torch.where(late & (t >= 3 * STREAM_WINDOW),
                        t - 3 * STREAM_WINDOW, t)
        cols = {"k": draw(0, keys), "qty": draw(1, 51),
                "amount": draw(100, 100_000).to(torch.float64), "t": t}
        out.append({name: x.cpu().numpy() for name, x in cols.items()})
    return out


def stream_objects(ct, env, name: str, keys: int = STREAM_KEYS):
    """The bench's stream, view and window join: the view over
    ``STREAM_AGGS``, the join against ``dims = {k, dim = 7k + 3}``, one
    row per key, ``late_policy="drop"``."""
    from cylon_tpu_torch.stream import (IncrementalView, StreamTable,
                                        TumblingWindowJoin)
    k = np.arange(keys, dtype=np.int64)
    dims = ct.Table.from_pydict({"k": k, "dim": k * 7 + 3}, env)
    st = StreamTable(env, key="k", name=name)
    view = IncrementalView(st, "k", STREAM_AGGS, name=f"{name}_view",
                           env=env)
    wj = TumblingWindowJoin(env, key="k", time_col="t",
                            window=STREAM_WINDOW, build=dims, build_on="k",
                            lateness=STREAM_LATENESS, late_policy="drop",
                            name=f"{name}_wjoin")
    return st, view, wj


def stream_ingest(st, view, wj, batches, each=None) -> dict:
    """The bench's ``ingest()``: per batch ``st.append``, ``wj.append``,
    ``wj.watermark``, then ``view.read()`` pulled to host arrays (the
    append-to-visible staleness stops there); ``each(i)`` after each
    batch, off the clock; then the final watermark.  Returns the rate,
    the staleness and watermark lag and ``closed_at`` (the windows closed
    when each batch arrived: the drop replay's input).  ``each(i, read)``
    gets the read's host columns."""
    staleness, lag, closed_at, checks_s = [], [], [], 0.0
    max_event = -1
    t_loop = time.perf_counter()
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        st.append(b)
        closed_at.append(wj._closed_through)
        wj.append(b)
        wj.watermark()
        read = view.read().host_columns()
        staleness.append(time.perf_counter() - t0)
        max_event = max(max_event, int(b["t"].max()))
        lag.append(max_event - wj._closed_through * STREAM_WINDOW)
        if each is not None:
            t1 = time.perf_counter()
            each(i, read)
            checks_s += time.perf_counter() - t1
    wj.watermark()
    wall = time.perf_counter() - t_loop - checks_s
    rows = sum(len(b["k"]) for b in batches)
    return {"batches": len(batches), "rows": rows, "ingest_wall_s": wall,
            "rows_per_s": rows / wall,
            "staleness_p50_s": float(np.percentile(staleness, 50)),
            "staleness_p99_s": float(np.percentile(staleness, 99)),
            "staleness_s": staleness,
            "watermark_lag_p50": float(np.percentile(lag, 50)),
            "watermark_lag_max": int(max(lag)), "closed_at": closed_at,
            "windows_closed": wj.windows_closed,
            "late_dropped": wj.late_dropped}


#: float64 adds integers exactly up to 2^53
EXACT_F64 = float(1 << 53)
#: var and std need Σ amount² besides the sums the other columns need
STREAM_VAR_COLS = ("amount_var", "amount_std")
#: the largest error allowed in var, and in std², against the exact
#: variance, as a fraction of the terms that cancel in it (Σ amount² over
#: c − 1, never less than var): where a shard's Σ amount² passes 2^53 and
#: the groupby's float64 prefix sums round, the card's largest reading
#: was 1.84e-11 of var (stream_path); where they are exact, ≈ 3e-16
STREAM_VAR_TOL = 1e-9


def stream_exact_var(cnt, s, sq) -> np.ndarray:
    """The exact sample variance (ddof 1) from integer per-key sums:
    ``(c·Σa² − (Σa)²) / (c·(c − 1))`` with the numerator in int64, then
    one division (NaN where c ≤ 1)."""
    c = cnt.astype(np.int64)
    num = c * sq - s * s
    den = c * (c - 1)
    out = np.full(c.shape, np.nan)
    ok = c > 1
    out[ok] = num[ok].astype(np.float64) / den[ok].astype(np.float64)
    return out


def stream_key_sums(batches, keys: int, dev) -> tuple:
    """Exact per-key count, Σ qty, Σ amount and Σ amount² of the host
    batches as int64 numpy arrays: int64 ``bincount``/``index_add_`` on
    the card (the numpy sums took seconds of the phase), numpy's float64
    ``bincount`` on the host (exact below 2^53)."""
    if dev.type == "cuda":
        out = [torch.zeros(keys, dtype=torch.int64, device=dev)
               for _ in range(4)]
        for b in batches:
            k = torch.from_numpy(b["k"]).to(dev)
            a = torch.from_numpy(b["amount"]).to(dev).to(torch.int64)
            out[0] += torch.bincount(k, minlength=keys)
            out[1].index_add_(0, k, torch.from_numpy(b["qty"]).to(dev))
            out[2].index_add_(0, k, a)
            out[3].index_add_(0, k, a * a)
        return tuple(x.cpu().numpy() for x in out)
    cnt = np.zeros(keys, np.int64)
    qty = np.zeros(keys, np.int64)
    amt = np.zeros(keys, np.int64)
    sq = np.zeros(keys, np.int64)
    for b in batches:
        a = b["amount"].astype(np.int64)
        cnt += np.bincount(b["k"], minlength=keys)
        qty += np.bincount(b["k"], b["qty"], minlength=keys).astype(
            np.int64)
        amt += np.bincount(b["k"], a, minlength=keys).astype(np.int64)
        sq += np.bincount(b["k"], a * a, minlength=keys).astype(np.int64)
    return cnt, qty, amt, sq


def stream_verdict(ct, st, view, batches, label: str) -> dict:
    """``view.read()`` held against a from-scratch ``groupby_aggregate(
    st.snapshot())`` and against numpy's exact integer per-key sums:

    * every column but var and std bit-equal to the from-scratch groupby,
      and its count, Σ qty and Σ amount equal to numpy's;
    * var and std bit-equal to the from-scratch groupby's as well while
      every shard's total Σ amount² stays below 2^53 (past it the
      sort-based groupby's float64 prefix sums round, the view's combine
      over the partials and the groupby over the rows each its own way);
    * var and std of both within ``STREAM_VAR_TOL`` of the exact variance
      from numpy's integer count, Σ amount and Σ amount² (errors
      recorded), NaN where the count is at most 1.

    Returns the verdict's record."""
    got = view.read()
    dev = got.column("k").data.device
    snap = st.snapshot()
    want = ct.groupby_aggregate(snap, "k", STREAM_AGGS)
    g, w = by_key(got, "k"), by_key(want, "k")
    keys = STREAM_KEYS
    cnt, qty, amt, sq = stream_key_sums(batches, keys, dev)
    if sq.max() >= EXACT_F64 or int(cnt.max()) * int(sq.max()) >= 1 << 62:
        raise AssertionError(f"{label}: a key's Σ amount² passes 2^53 "
                             "or c·Σ amount² 2^62; the oracle's integer "
                             "sums would round or overflow")
    k = g["k"]
    if list(g) != list(w) or not np.array_equal(k, np.flatnonzero(cnt)):
        raise AssertionError(f"{label}: the view's columns or groups "
                             "differ")
    for c in g:
        if c not in STREAM_VAR_COLS and g[c].tobytes() != w[c].tobytes():
            raise AssertionError(f"{label}: {c} differs from the "
                                 "from-scratch groupby")
    if not (np.array_equal(g["amount_count"], cnt[k])
            and np.array_equal(g["qty_sum"], qty[k])
            and g["amount_sum"].tobytes()
            == amt[k].astype(np.float64).tobytes()):
        raise AssertionError(f"{label}: the view's counts or sums differ "
                             "from numpy's")
    vc = torch.as_tensor(np.asarray(snap.valid_counts), device=dev)
    a = snap.column("amount").data.view(len(snap.valid_counts), -1)
    live = torch.arange(a.shape[1], device=dev)[None, :] < vc[:, None]
    shard_sq = float(torch.where(live, a * a, 0.0).sum(dim=1).max())
    var_bit_equal = all(g[c].tobytes() == w[c].tobytes()
                        for c in STREAM_VAR_COLS)
    if shard_sq < EXACT_F64 and not var_bit_equal:
        raise AssertionError(f"{label}: var/std differ from the "
                             "from-scratch groupby with exact sums")
    exact = stream_exact_var(cnt[k], amt[k], sq[k])
    ok = cnt[k] > 1
    scale = sq[k][ok] / (cnt[k][ok] - 1)
    rec = {"groups": int(k.shape[0]), "bit_equal_but_var_std": True,
           "var_std_bit_equal": var_bit_equal,
           "largest_shard_sum_amount_sq": shard_sq}
    for side, vals in (("view", g), ("from_scratch", w)):
        for c in STREAM_VAR_COLS:
            if not (np.isnan(vals[c][~ok]).all()
                    and np.isfinite(vals[c][ok]).all()):
                raise AssertionError(f"{label}: {side} {c}: NaN where the "
                                     "count passes 1, or a value where "
                                     "it does not")
            v = vals[c][ok] ** 2 if c == "amount_std" else vals[c][ok]
            err = float(np.max(np.abs(v - exact[ok]) / scale, initial=0.0))
            rec[f"{side}_{c}_err"] = err
            if err > STREAM_VAR_TOL:
                raise AssertionError(
                    f"{label}: {side} {c} is {err:.3g} of Σ amount²/(c−1) "
                    f"from the exact variance (largest shard Σ amount² "
                    f"{shard_sq:.4g})")
    return rec


def stream_pack(k, t, qty, amount):
    """One int64 per row, (k, t, qty, amount) in 16, 12, 6 and 17 bits:
    equal multisets of packed rows are equal multisets of rows."""
    return ((k * 4096 + t) * 64 + qty) * 131072 + amount


def stream_windows_equal(wj, batches, closed_at, dev, label: str) -> dict:
    """Every closed window's join equal, by sorted rows, to a recompute
    from the host rows that replays the drop policy in arrival order (a
    row survives only if its window was still open when its batch
    arrived: bench_streaming's ``closed_at`` replay), and every joined
    row's ``dim`` is ``7k + 3``.  Rows are packed to one int64 each and
    sorted on ``dev``."""
    want: dict = {}
    for b, ca in zip(batches, closed_at):
        if int(b["t"].max()) >= 4096 or int(b["k"].max()) >= 65_536:
            raise AssertionError(f"{label}: rows outside the packing")
        wid = b["t"] // STREAM_WINDOW
        keep = wid >= ca
        packed = stream_pack(b["k"], b["t"], b["qty"],
                             b["amount"].astype(np.int64))
        for w in np.unique(wid[keep]):
            want.setdefault(int(w), []).append(packed[keep & (wid == w)])
    closed = [wid for wid, _ in wj.closed]
    ripe = sorted(w for w in want if w < wj._closed_through)
    if sorted(closed) != ripe:
        raise AssertionError(f"{label}: closed windows {closed}, the "
                             f"replay's {ripe}")
    rows = 0
    for wid, out in wj.closed:
        vc = torch.as_tensor(np.asarray(out.valid_counts), device=dev)
        live = (torch.arange(out.capacity, device=dev)[None, :]
                < vc[:, None]).reshape(-1)
        c = {n: out.column(n).data[live]
             for n in ("k", "t", "qty", "amount", "dim")}
        amount = c["amount"].to(torch.int64)
        if not (torch.equal(c["dim"], c["k"] * 7 + 3)
                and torch.equal(amount.to(torch.float64), c["amount"])):
            raise AssertionError(f"{label}: window {wid}: dim or amount")
        got = torch.sort(stream_pack(c["k"], c["t"], c["qty"], amount))[0]
        exp = torch.sort(torch.from_numpy(np.concatenate(want[wid])).to(
            dev))[0]
        if not torch.equal(got, exp):
            raise AssertionError(f"{label}: window {wid}: {got.numel()} "
                                 f"rows against the replay's {exp.numel()}")
        rows += int(got.numel())
    return {"windows_equal": len(closed), "window_rows": rows,
            "open_windows": wj.stats()["open_windows"]}


def stream_teardown(view, wj, st) -> None:
    """Drain the view's sink, retire the window join (its closed results
    and the windows the final watermark left open) and release the
    chunks."""
    view.finalize()
    wj.release()
    st.release()


def kernel_counts(reset: bool = False) -> dict:
    """K1's and K2's counts (after setting them to 0 with ``reset``)."""
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    if reset:
        wg.reset_counts()
        sp.reset_counts()
    return {"windowed_gather": dict(wg.COUNTS),
            "splitter_probe": dict(sp.COUNTS)}


def stream_path(ct, n_batches: int = STREAM_BATCHES,
                rows: int = STREAM_ROWS, world: int = 4,
                device=None) -> dict:
    """The streaming bench at ``n_batches`` of ``rows`` (module
    docstring): sustained rows/s, p50/p99 append-to-visible staleness,
    watermark lag, windows closed, late rows dropped, window evictions,
    the ledger and the card's allocated bytes before the loop and after
    the teardown (equal), peak device bytes and the ``stream.*`` and
    ``shuffle.*`` regions' host seconds; the view bit-equal to the
    from-scratch groupby, its counts and sums equal to numpy's, every
    closed window equal to the replay; K1 and K2 not launched."""
    import gc
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.exec import memory
    from cylon_tpu_torch.utils import timing
    t0 = time.perf_counter()
    batches = stream_batches(n_batches, rows, device=device)
    gen_s = time.perf_counter() - t0
    env = ct.CylonEnv(VirtualMeshConfig(world), device=device)
    st, view, wj = stream_objects(ct, env, "stream_path")
    digests: dict = {"reads": [], "windows": {}, "closed_at_batch": {}}
    var: list = []
    gc.collect()
    if env.on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_allocated() if env.on_cuda else 0
    memory.reset_stats()
    ledger0 = memory.balance()
    kernel_counts(reset=True)
    timing.reset()
    timing.enable("async")
    try:
        rec = stream_ingest(st, view, wj, batches,
                            each=stream_tracker(wj, digests, var))
    finally:
        timing.enable(None)
    counts = kernel_counts()
    regions = {k: v for k, v in timing.snapshot().items()
               if k.startswith(("stream.", "shuffle."))}
    peak = torch.cuda.max_memory_allocated() if env.on_cuda else None
    mem = memory.stats()
    ledger_loop = memory.balance()
    t1 = time.perf_counter()
    verdict = stream_verdict(ct, st, view, batches, "stream_path")
    wins = stream_windows_equal(wj, batches, rec.pop("closed_at"),
                                env.device, "stream_path")
    check_s = time.perf_counter() - t1
    stats = {"view": view.stats(), "stream": st.stats(),
             "window": wj.stats()}
    stream_teardown(view, wj, st)
    del view, wj, st
    gc.collect()
    ledger1 = memory.balance()
    alloc1 = torch.cuda.memory_allocated() if env.on_cuda else 0
    if ledger1 != ledger0 or alloc1 - alloc0 > STREAM_ALLOC_SLACK:
        raise AssertionError(f"stream_path: the ledger {ledger0} -> "
                             f"{ledger1} B, allocated {alloc0} -> {alloc1} "
                             "B after the teardown")
    if not 1 <= rec["windows_closed"] <= mem["window_evictions"]:
        raise AssertionError(f"stream_path: {rec['windows_closed']} "
                             f"windows closed, {mem['window_evictions']} "
                             "buffers retired")
    out = {"phase": "stream_path", "world": world, "rows_per_batch": rows,
           "keys": STREAM_KEYS, "window": STREAM_WINDOW,
           "stride": STREAM_STRIDE, "lateness": STREAM_LATENESS,
           "gen_s": gen_s, **rec, **verdict, **wins,
           "window_evictions": mem["window_evictions"],
           "spill_events": mem["spill_events"],
           "bytes_spilled": mem["bytes_spilled"],
           "ledger_before_bytes": ledger0,
           "ledger_loop_end_bytes": ledger_loop,
           "ledger_after_bytes": ledger1,
           "allocated_before_bytes": alloc0, "allocated_after_bytes": alloc1,
           "peak_mem_bytes": peak,
           "peak_ledger_bytes": mem["peak_ledger_bytes"],
           "regions_s": regions, "check_s": check_s, "stats": stats,
           "kernel_counts": counts, "oracle": "equal", "windows": "equal",
           "ledger_drained": True,
           # every read's and closed window's digest, for procs_stream,
           # popped before the record is printed
           "_digests": {"digests": digests, "var": var[:PROCS_STREAM_BATCHES],
                        "rows_per_s_first": PROCS_STREAM_BATCHES * rows / sum(
                            rec["staleness_s"][:PROCS_STREAM_BATCHES])}}
    no_kernels(out, "stream_path")
    return out


def stream_small(ct, root: str, worlds=(1, 4, 8),
                 n_batches: int = STREAM_SMALL_BATCHES,
                 rows: int = STREAM_SMALL_ROWS, device=None) -> list:
    """The stream at ``n_batches`` of ``rows`` (1M rows) at each W: the
    view bit-equal to the from-scratch groupby after every batch, the
    oracle, the windows and the drained ledger; at W = 4 also the spill
    leg (:func:`stream_spill_leg`) and the checkpoint legs under ``root``
    (:func:`stream_ckpt_legs`)."""
    import gc
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.exec import memory
    batches = stream_batches(n_batches, rows, seed=STREAM_SEED + 1)
    recs = []
    for w in worlds:
        tag = f"stream_small W={w}"
        env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
        memory.reset_stats()
        ledger0 = memory.balance()
        st, view, wj = stream_objects(ct, env, f"small{w}")
        kernel_counts(reset=True)
        seen = []
        rec = stream_ingest(st, view, wj, batches,
                            each=lambda i, _read: seen.append(
                                stream_verdict(ct, st, view, batches[:i + 1],
                                               f"{tag} batch {i}")))
        counts = kernel_counts()
        if not all(v["var_std_bit_equal"] for v in seen):
            raise AssertionError(f"{tag}: var/std differ at {seen}")
        wins = stream_windows_equal(wj, batches, rec.pop("closed_at"),
                                    env.device, tag)
        stream_teardown(view, wj, st)
        del view, wj, st
        gc.collect()
        if memory.balance() != ledger0:
            raise AssertionError(f"{tag}: the ledger did not drain")
        r = {"phase": "stream_small", "world": w, **wins, **seen[-1],
             "windows_closed": rec["windows_closed"],
             "late_dropped": rec["late_dropped"],
             "rows_per_s": rec["rows_per_s"],
             "window_evictions": memory.stats()["window_evictions"],
             "kernel_counts": counts, "view_bit_equal_every_batch": True,
             "oracle": "equal", "ledger_drained": True}
        no_kernels(r, tag)
        if w == 4:
            r["spill"] = stream_spill_leg(ct, env, batches, tag)
            r["ckpt"] = stream_ckpt_legs(ct, batches, root, device, tag)
        recs.append(r)
    return recs


def stream_spill_leg(ct, env, batches, tag: str) -> dict:
    """The stream under a 4 KiB ledger budget: every admission evicts the
    open windows to host memory, and each comes back bit-exact at its
    close (the windows against the replay, the view against the
    from-scratch groupby)."""
    from cylon_tpu_torch.exec import memory
    memory.reset_stats()
    with knobs(HBM_BUDGET_BYTES=4096):
        st, view, wj = stream_objects(ct, env, "small_spill")
        rec = stream_ingest(st, view, wj, batches)
        verdict = stream_verdict(ct, st, view, batches, f"{tag} spilled")
        wins = stream_windows_equal(wj, batches, rec.pop("closed_at"),
                                    env.device, f"{tag} spilled")
        mem = memory.stats()
        stream_teardown(view, wj, st)
    if mem["readmit_events"] < 1 \
            or mem["spill_events"] <= mem["window_evictions"]:
        raise AssertionError(f"{tag} spilled: {mem}: no open window was "
                             "evicted and readmitted")
    return {**wins, "spill_events": mem["spill_events"],
            "readmit_events": mem["readmit_events"],
            "bytes_readmitted": mem["bytes_readmitted"],
            "window_evictions": mem["window_evictions"],
            "windows": "equal", **verdict}


def stream_ckpt_legs(ct, batches, root: str, device, tag: str) -> dict:
    """Checkpoints armed: the view at W = 4 commits one piece per batch,
    and the same ingest resumed at W = 4 fast-forwards every batch
    (``resume``); a second W = 4 commit resumed at W = 2 adopts the
    prefix re-sharded (``reshard``).  Each resumed read's digest equals
    the uninterrupted run's."""
    import os
    from cylon_tpu_torch.ctx.context import VirtualMeshConfig
    from cylon_tpu_torch.stream import IncrementalView, StreamTable

    def run(w):
        env = ct.CylonEnv(VirtualMeshConfig(w), device=device)
        st = StreamTable(env, key="k", name="small_ckpt")
        view = IncrementalView(st, "k", STREAM_AGGS,
                               name="small_ckpt_view", env=env)
        for b in batches:
            st.append(b)
        digest = serve_digest(view.read())
        ffwd = view.fast_forwarded
        view.finalize()
        st.release()
        return digest, ffwd

    out = {}
    n = len(batches)
    for leg, w_to in (("resume", 4), ("reshard", 2)):
        path = os.path.join(root, f"stream_{leg}")
        with ckpt_env(CKPT_DIR=path) as ck:
            base, _ = run(4)
            committed = ck.stats()["checkpoint_events"]
        with ckpt_env(CKPT_DIR=path, RESUME=1) as ck:
            again, ffwd = run(w_to)
            s = ck.stats()
        resharded = n if w_to != 4 else 0
        if committed != n or ffwd != n or again != base \
                or s["resume_resharded_pieces"] != resharded:
            raise AssertionError(f"{tag} {leg}: committed {committed}, "
                                 f"fast-forwarded {ffwd}, equal "
                                 f"{again == base}, {s}")
        out[leg] = {"worlds": [4, w_to], "committed": committed,
                    "fast_forwarded": ffwd, "stats": s, "bit_equal": True}
    return out


def stream_serve(ct, dfs, env, n_batches: int = STREAM_SERVE_BATCHES,
                 rows: int = STREAM_ROWS) -> dict:
    """The stream as a ``kind="stream"`` session beside a TPC-H tenant
    (Q6 then Q1, twice: bench_streaming's ``query_tenant``) under
    ``QueryScheduler(policy="fair")`` on ``env`` and its tables ``dfs``:
    the view bit-equal to the from-scratch groupby, every tenant answer's
    digest equal to its solo run's; each session's slices, the stream's
    rows/s and the scheduler's ``stream_sessions``."""
    import gc
    from cylon_tpu_torch import tpch
    from cylon_tpu_torch.exec.scheduler import QueryScheduler
    batches = stream_batches(n_batches, rows)
    queries = ("q6", "q1")
    solo = {q: serve_digest(getattr(tpch, q)(dfs, env=env))
            for q in queries}
    st, view, wj = stream_objects(ct, env, "stream_serve")
    ingest_rec: dict = {}
    outs: list = []

    def ingest():
        ingest_rec.update(stream_ingest(st, view, wj, batches))
        return ingest_rec["batches"]

    def query_tenant():
        for _ in range(2):
            for q in queries:
                out = getattr(tpch, q)(dfs, env=env)
                wait_result(out)
                outs.append((q, out))
        return len(outs)

    kernel_counts(reset=True)
    sched = QueryScheduler(env, policy="fair")
    sched.submit("ingest", ingest, kind="stream")
    sched.submit("tpch", query_tenant)
    t0 = time.perf_counter()
    sessions = sched.run(raise_errors=True)
    elapsed = time.perf_counter() - t0
    counts = kernel_counts()
    verdict = stream_verdict(ct, st, view, batches, "stream_serve")
    for q, out in outs:
        if serve_digest(out) != solo[q]:
            raise AssertionError(f"stream_serve: {q} differs from its "
                                 "solo run")
    stats = sched.stats()
    for key in ("closed_at", "staleness_s"):
        ingest_rec.pop(key)
    stream_teardown(view, wj, st)
    del view, wj, st, outs
    gc.collect()
    return {"phase": "stream_serve", "world": env.world_size,
            "rows_per_batch": rows, "policy": "fair",
            "tenant_queries": [q for _ in range(2) for q in queries],
            "elapsed_s": elapsed, **ingest_rec,
            "sessions": {s.name: {"kind": s.kind, "slices": s.slices,
                                  "latency_s": s.latency_s,
                                  "service_s": s.service_s,
                                  "outcome": s.outcome()}
                         for s in sessions},
            "stream_sessions": stats["stream_sessions"],
            "scheduler": stats, "kernel_counts": counts, **verdict,
            "tenant_bit_equal_to_solo": True}


# ---------------------------------------------------------------------------
# durability, serving and streams across processes: procs_ckpt,
# procs_serve, procs_stream (children through --procs-child, gloo)
# ---------------------------------------------------------------------------

#: the exchange watchdog of the procs_ckpt children: a peer SIGKILLed
#: mid-run surfaces on the survivor as RankDesyncError within it
PROCS_WATCHDOG_S = 20
#: the exit code of a procs_ckpt child that left through RankDesyncError
DESYNC_RC = 4
#: procs_stream's batches: stream_path's first ones
PROCS_STREAM_BATCHES = 16


def _procs_go(spec: dict) -> None:
    """Wait for a ``--procs-child``'s go file, if it has one: the child
    imports, then waits to touch the card."""
    import os
    if spec.get("go"):
        deadline = time.monotonic() + PROCS_TIMEOUT_S
        while not os.path.exists(spec["go"]):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no go file {spec['go']}")
            time.sleep(0.05)


def _procs_env(spec: dict):
    """A ``--procs-child``'s package and world: its go file awaited, then
    its DistributedConfig env."""
    _procs_go(spec)
    import cylon_tpu_torch as ct
    env = ct.CylonEnv(ct.DistributedConfig(
        spec["addr"], spec["pid"], spec["nproc"],
        local_world=spec["local_world"], backend=spec.get("backend"),
        device=spec.get("device")))
    return ct, env


def _procs_spawn(spec: dict, nproc: int, v: int,
                 switches: dict | None = None) -> list:
    """Start the ``nproc`` ``--procs-child`` processes of one gloo world
    of ``nproc`` × ``v`` ranks running ``spec``, with ``switches`` as
    ``CYLON_TPU_TORCH_<name>`` in their environment (every other
    checkpoint switch unset)."""
    import os
    import socket
    env = {k: x for k, x in os.environ.items() if k not in CKPT_VARS}
    env.update({f"CYLON_TPU_TORCH_{k}": str(x)
                for k, x in (switches or {}).items()})
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sk.getsockname()[1]}"
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--procs-child",
         json.dumps({**spec, "pid": i, "nproc": nproc, "local_world": v,
                     "backend": "gloo", "addr": addr})],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(nproc)]


def _procs_wait(label: str, procs: list, expect: list,
                deadline: float) -> list:
    """Each child's JSON line, with its exit code under ``rc``.  A child
    whose exit code is not ``expect[i]``, that prints no result (a
    SIGKILLed one excepted), or that still runs at ``deadline`` (it and
    its peers are killed) fails the leg."""
    out = []
    try:
        for i, p in enumerate(procs):
            try:
                so, se = p.communicate(
                    timeout=max(deadline - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                so, se = p.communicate()
            if p.returncode != expect[i]:
                raise AssertionError(
                    f"{label}: process {i} exited {p.returncode}, expected "
                    f"{expect[i]}\n{so[-2000:]}\n{se[-4000:]}")
            lines = [ln for ln in so.splitlines() if ln.startswith("{")]
            if not lines and p.returncode != -9:
                raise AssertionError(f"{label}: process {i} printed no "
                                     f"result\n{se[-4000:]}")
            out.append({**(json.loads(lines[-1]) if lines else {}),
                        "rc": p.returncode})
    finally:
        _procs_kill(procs)
    return out


def _procs_kill(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _procs_checks(env, wg, sp, captured: dict, label: str) -> dict:
    """K1 and K2 held bit-equal to their plain versions on the inputs of
    their first launch in this process (on the card; a CPU child has no
    kernels)."""
    checks = {}
    if env.on_cuda:
        torch.cuda.empty_cache()
        if "piece" in captured:
            checks["k1"] = k1_check(wg, label, *captured.pop("piece"))
        if "probe" in captured:
            checks["k2"] = k2_check(sp, label, *captured.pop("probe"))
    return {name: {key: c.get(key) for key in (
        "L", "M", "S", "K", "cap", "window", "bit_equal", "max_abs_err")}
        for name, c in checks.items()}


def _manifest_epochs(root: str, pid: int) -> list:
    """Process ``pid``'s committed manifest epochs, stage by stage."""
    import glob
    import os
    out = []
    for path in sorted(glob.glob(os.path.join(root, f"rank{pid}", "stage*",
                                              "MANIFEST.json"))):
        with open(path, encoding="utf-8") as f:
            out.append(int(json.load(f)["epoch"]))
    return out


def procs_ckpt_child(spec: dict) -> int:
    """One process of ``procs_ckpt``: ckpt_path's tables mapped from the
    parent's ``.npy`` files (this process uploads its own ranks' rows),
    then ``GroupBySink`` + ``pipelined_join(n_chunks=4)`` + ``finalize``
    under the checkpoint switches the parent set: an armed run, a run
    whose process 0 dies at its third ``ckpt.write``, or a resume.
    Prints one JSON line: the run's seconds, the write side's regions,
    the bytes this process wrote, the checkpoint counters, every
    process's manifest epochs (one allgather), the result's shard digest,
    the launches and K1 and K2 against their plain versions.  The
    survivor of a killed peer prints its ``RankDesyncError`` and exits
    ``DESYNC_RC``."""
    import os
    from cylon_tpu_torch.exec import checkpoint
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    from cylon_tpu_torch.parallel import transport
    from cylon_tpu_torch.status import RankDesyncError
    from cylon_tpu_torch.utils import timing
    ct, env = _procs_env(spec)
    t_start = time.perf_counter()
    rec = {"phase": "procs_child", "leg": "procs_ckpt", "mode": spec["mode"],
           "pid": spec["pid"], "world": env.world_size,
           "setup_s": transport.STATS["setup_s"]}
    cols = {name: np.load(os.path.join(spec["data"], f"{name}.npy"),
                          mmap_mode="r") for name in ("lk", "a", "rk", "b")}
    lt = ct.Table.from_pydict({"k": cols["lk"], "a": cols["a"]}, env)
    rt = ct.Table.from_pydict({"k": cols["rk"], "b": cols["b"]}, env)
    del cols
    if env.on_cuda:
        torch.cuda.synchronize()
    rec["upload_s"] = time.perf_counter() - t_start
    env.barrier()
    kernel_counts(reset=True)
    checkpoint.reset_stats()
    transport.reset_stats()
    captured: dict = {}
    t0 = time.perf_counter()
    try:
        with contextlib.ExitStack() as stack:
            sc = stack.enter_context(timing.attribution_scope())
            stack.enter_context(capturing(sp, "count_ge_splitters",
                                          captured, "probe"))
            stack.enter_context(capturing(wg, "windowed_take_t", captured,
                                          "piece", keep_k1))
            g = pipelined_step(ct, lt, rt, spec["n_chunks"])
    except RankDesyncError as e:
        rec.update(run_s=time.perf_counter() - t0, error=type(e).__name__,
                   site=e.site, message=str(e)[:300],
                   stats=checkpoint.stats(),
                   epochs=_manifest_epochs(checkpoint.ckpt_dir(),
                                           spec["pid"]))
        # the process group closes after its peer died (no collective
        # runs on it any more)
        t1 = time.perf_counter()
        env.finalize()
        rec["finalize_s"] = time.perf_counter() - t1
        print(json.dumps(rec), flush=True)
        return DESYNC_RC
    rec["run_s"] = time.perf_counter() - t0
    st = checkpoint.stats()
    rec.update(regions_s={r: v for r, v in sc.snapshot().items()
                          if r in CKPT_REGIONS},
               bytes_written=st["bytes_checkpointed"], stats=st,
               events=recovery_events(), kernel_counts=kernel_counts(),
               transport=dict(transport.STATS), digest=shard_digest(g))
    mine = np.asarray(_manifest_epochs(checkpoint.ckpt_dir(), spec["pid"]),
                      np.int64)
    rec["epochs"] = transport.allgather_array(
        mine, "procs_ckpt.epochs").tolist()
    del g, lt, rt
    rec["checks"] = _procs_checks(
        env, wg, sp, captured, f"procs_ckpt_{spec['mode']}_p{spec['pid']}")
    env.barrier()
    env.finalize()
    rec["wall_s"] = time.perf_counter() - t_start
    print(json.dumps(rec), flush=True)
    return 0


def procs_ckpt_launch(root: str, device=None) -> dict:
    """Start ``procs_ckpt``'s children before ``ckpt_path`` runs, so their
    imports overlap it: the armed and the kill world wait for one go
    file, the resume world for a second one (touched when the kill world
    has ended).  ``root/data`` will hold ckpt_path's tables."""
    import os
    base = {"leg": "procs_ckpt", "data": os.path.join(root, "data"),
            "n_chunks": CKPT_CHUNKS, "device": device}
    go = os.path.join(root, "pc_go")
    go_resume = os.path.join(root, "pc_go_resume")
    go_reshard = os.path.join(root, "pc_go_reshard")
    roots = {m: os.path.join(root, f"pc_{m}") for m in ("armed", "kill")}
    wd = {"WATCHDOG_S": PROCS_WATCHDOG_S}
    # the armed stage's re-shards into one process, at W = 4 and (from a
    # hard-linked copy) W = 2, side by side once the armed world is done
    reshard = {w: spawn_child({"mode": f"reshard_w{w}", "world": w,
                               "data": base["data"],
                               "n_chunks": CKPT_CHUNKS, "device": device,
                               "go": go_reshard},
                              CKPT_DIR=roots["armed"] + ("_w2" if w == 2
                                                         else ""),
                              RESUME=1) for w in (4, 2)}
    return {
        "go": go, "go_resume": go_resume, "go_reshard": go_reshard,
        "roots": roots, "reshard": reshard,
        "armed": _procs_spawn({**base, "mode": "armed", "go": go}, 2, 2,
                              {"CKPT_DIR": roots["armed"], **wd}),
        "kill": _procs_spawn({**base, "mode": "kill", "go": go}, 2, 2,
                             {"CKPT_DIR": roots["kill"],
                              "FAULTS": "ckpt.write:0:3=kill", **wd}),
        "resume": _procs_spawn({**base, "mode": "resume",
                                "go": go_resume}, 2, 2,
                               {"CKPT_DIR": roots["kill"], "RESUME": 1,
                                **wd})}


def procs_ckpt(want: dict, launched: dict, device=None) -> dict:
    """ckpt_path's workload as 2 processes × 2 ranks over gloo (module
    docstring): an armed run; a kill chain (process 0 SIGKILLed at its
    third ``ckpt.write``, process 1 typed and nonzero within the
    watchdog, then a 2 × 2 resume fast-forwarding the 2 committed pieces
    with one manifest epoch on both); and the armed run's complete stage
    resumed in one process at ``VirtualMeshConfig(4)`` (a new process
    layout of the same world) and at ``VirtualMeshConfig(2)`` (W 4 → 2),
    both through the re-shard path, two ``--ckpt-child`` processes side
    by side.  Every result equals ``want`` (ckpt_path's ``digest`` and
    ``shard_digest``; ``pieces``).  ``launched``:
    :func:`procs_ckpt_launch`'s children."""
    import os
    import shutil
    import threading
    pieces = want["pieces"]
    t_leg = time.perf_counter()
    deadline = t_leg + PROCS_TIMEOUT_S
    open(launched["go"], "w").close()
    chain: dict = {}

    def kill_chain():
        try:
            t0 = time.perf_counter()
            chain["kill"] = _procs_wait("procs_ckpt kill", launched["kill"],
                                        [-9, DESYNC_RC], deadline)
            chain["kill_wall_s"] = time.perf_counter() - t0
            open(launched["go_resume"], "w").close()
            t0 = time.perf_counter()
            chain["resume"] = _procs_wait("procs_ckpt resume",
                                          launched["resume"], [0, 0],
                                          deadline)
            chain["resume_wall_s"] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 — raised after the join
            chain["error"] = e

    th = threading.Thread(target=kill_chain)
    th.start()
    relayout = {}
    try:
        t0 = time.perf_counter()
        armed = _procs_wait("procs_ckpt armed", launched["armed"], [0, 0],
                            deadline)
        armed_wall = time.perf_counter() - t0
        for r in armed:
            if r["digest"] != want["shard_digest"] \
                    or r["stats"]["checkpoint_events"] != pieces \
                    or r["epochs"] != armed[0]["epochs"]:
                raise AssertionError(
                    f"procs_ckpt armed process {r['pid']}: digest "
                    f"{r['digest']}, counters {r['stats']}, epochs "
                    f"{r['epochs']}")
        # the complete 2 x 2 stage resumed in one process, two children
        # side by side: a hard-linked copy for the W = 2 resume (a rewrite
        # replaces files, never writes into them), the original for W = 4
        src = launched["roots"]["armed"]
        shutil.copytree(src, src + "_w2", copy_function=os.link)
        open(launched["go_reshard"], "w").close()
        for w in (4, 2):
            r = collect_child(launched["reshard"][w], 0,
                              f"procs_ckpt re-shard at W = {w}")
            st = r["stats"]
            relayout[f"w{w}"] = {
                "world": w, "run_s": r["run_s"], "stats": st,
                "regions_s": r["regions_s"],
                "process_wall_s": r["process_wall_s"],
                "kernel_counts": r["kernel_counts"]}
            if r["digest"] != want["digest"] \
                    or st["resume_world_mismatch"] != 1 \
                    or st["resume_resharded_pieces"] != pieces:
                raise AssertionError(f"procs_ckpt re-shard at W = {w}: "
                                     f"counters {st}, digest {r['digest']}")
        shutil.rmtree(src + "_w2")
    finally:
        th.join()
        for key in ("armed", "kill", "resume"):
            _procs_kill(launched[key])
        _procs_kill([p for p, _t0 in launched["reshard"].values()])
    if "error" in chain:
        raise chain["error"]
    kill, resume = chain["kill"], chain["resume"]
    surv = kill[1]
    if surv.get("error") != "RankDesyncError" \
            or surv["run_s"] > 2 * PROCS_WATCHDOG_S \
            or surv["stats"]["checkpoint_events"] != 2:
        raise AssertionError(f"procs_ckpt kill: the survivor {surv}")
    for r in resume:
        st = r["stats"]
        if r["digest"] != want["shard_digest"] \
                or st["resume_fast_forwarded_pieces"] != 2 \
                or st["checkpoint_events"] != pieces - 2 \
                or len({tuple(e) for e in r["epochs"]}) != 1:
            raise AssertionError(f"procs_ckpt resume process {r['pid']}: "
                                 f"{st}, epochs {r['epochs']}")
    children = armed + resume
    for r in children:
        if device is None and set(r["checks"]) != {"k1", "k2"}:
            raise AssertionError(f"procs_ckpt {r['mode']} process "
                                 f"{r['pid']}: K1/K2 not captured")
        if not all(c["bit_equal"] for c in r["checks"].values()):
            raise AssertionError(f"procs_ckpt: kernel checks {r['checks']}")

    def per_process(runs):
        return [{key: r.get(key) for key in (
            "pid", "rc", "setup_s", "upload_s", "run_s", "wall_s",
            "bytes_written", "regions_s", "stats", "epochs", "checks",
            "kernel_counts", "error", "site", "finalize_s")} for r in runs]

    launches = {name: sum(r["kernel_counts"][name]["launches"]
                          for r in children)
                + sum(x["kernel_counts"][name]["launches"]
                      for x in relayout.values())
                for name in ("windowed_gather", "splitter_probe")}
    return {"phase": "procs_ckpt", "processes": 2, "local_world": 2,
            "world": 4, "backend": "gloo", "n_chunks": CKPT_CHUNKS,
            "pieces": pieces, "watchdog_s": PROCS_WATCHDOG_S,
            "armed": per_process(armed), "armed_wall_s": armed_wall,
            "kill": per_process(kill), "kill_wall_s": chain["kill_wall_s"],
            "resume": per_process(resume),
            "resume_wall_s": chain["resume_wall_s"],
            "relayout": relayout, "wall_s": time.perf_counter() - t_leg,
            "kernel_counts": {k: {"launches": v}
                              for k, v in launches.items()},
            "digest": want["digest"],
            "oracle": "every digest equal to ckpt_path's"}


def _vote_counter():
    """Count the scheduler's and the sessions' votes in this process:
    each consensus entry point wrapped, its calls counted by the thread
    that made them (the scheduler's loop or a session)."""
    import threading
    from cylon_tpu_torch.exec import recovery
    counts: dict = {}
    for name in ("count_consensus", "preempt_consensus", "drain_consensus",
                 "ckpt_commit_consensus", "ckpt_resume_consensus"):
        orig = getattr(recovery, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            who = ("scheduler" if threading.current_thread()
                   is threading.main_thread() else "sessions")
            key = f"{_name}.{who}"
            counts[key] = counts.get(key, 0) + 1
            return _orig(*a, **k)

        setattr(recovery, name, wrapped)
    return counts


def procs_serve_child(spec: dict) -> int:
    """One process of ``procs_serve``: the TPC-H tables the parent
    pickled (this process uploads its own ranks' rows), then
    ``serve_path``'s four tenants, each running its mix once, under
    ``fair`` and then under ``priority`` with checkpoints armed and the
    last tenant submitted late; every answer's digest against the solo
    digests the parent wrote.  Prints one JSON line per leg's report,
    the votes taken and K2 against its plain version on its first launch
    in each pass."""
    import pickle
    from cylon_tpu_torch import tpch
    from cylon_tpu_torch.exec.scheduler import estimate_footprint
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    from cylon_tpu_torch.parallel import transport
    t_start = time.perf_counter()
    with open(spec["tables"], "rb") as f:
        cols = pickle.load(f)
    load_s = time.perf_counter() - t_start
    ct, env = _procs_env(spec)
    t0 = time.perf_counter()
    dfs = {name: ct.DataFrame(ct.Table.from_host_columns(c, env))
           for name, c in cols.items()}
    rows = {name: int(c[next(iter(c))].data.shape[0])
            for name, c in cols.items()}
    del cols
    if env.on_cuda:
        torch.cuda.synchronize()
    rec = {"phase": "procs_child", "leg": "procs_serve", "pid": spec["pid"],
           "world": env.world_size, "tables_load_s": load_s,
           "upload_s": time.perf_counter() - t0,
           "setup_s": transport.STATS["setup_s"]}
    with open(spec["solo"], encoding="utf-8") as f:
        stash = json.load(f)
    solo = stash["solo"]

    def run_query(q):
        return qpipe(ct, dfs) if q == "qpipe" \
            else getattr(tpch, q)(dfs, env=env)

    plans = [{"name": f"t{i}", "mix": mix, "queries": len(mix),
              "footprint": estimate_footprint(*[dfs[t] for t in sorted(
                  {t for q in mix for t in SERVE_TABLES[q]})])}
             for i, mix in enumerate(SERVE_MIXES)]
    foots = sorted(p["footprint"] for p in plans)
    budget = int(1.05 * (foots[0] + foots[1]))
    votes = _vote_counter()
    env.barrier()
    kernel_counts(reset=True)
    for policy, late, ckpt in (("fair", 0, None),
                               ("priority", 1, spec["ckpt"])):
        before = dict(votes)
        run = serve_pass(env, plans, run_query, policy, budget,
                         stash["ledger_budget"], late=late, ckpt=ckpt)
        probe = run.pop("k2_probe")
        rep = serve_report(run, solo, rows, f"procs_serve {policy}")
        del run
        captured = {} if probe is None else {"probe": probe}
        rep["checks"] = _procs_checks(env, wg, sp, captured,
                                      f"procs_serve_{policy}_p{spec['pid']}")
        rep["votes"] = {k: v - before.get(k, 0) for k, v in votes.items()}
        rec[policy] = rep
    env.barrier()
    env.finalize()
    rec["wall_s"] = time.perf_counter() - t_start
    print(json.dumps(rec, default=str), flush=True)
    return 0


def procs_serve_launch(tables: str, root: str, device=None) -> dict:
    """Start ``procs_serve``'s two children (2 processes × 4 ranks, W = 8)
    before ``tpch_path`` runs, behind a go file; they load the pickled
    tables ``tables`` meanwhile and read serve_path's solo digests and
    ledger budget from ``root/procs_serve_solo.json`` after the go."""
    import os
    go = os.path.join(root, "ps_go")
    spec = {"leg": "procs_serve", "tables": tables, "go": go,
            "solo": os.path.join(root, "procs_serve_solo.json"),
            "ckpt": os.path.join(root, "procs_serve_preempt"),
            "device": device}
    return {"go": go, "spec": spec, "procs": _procs_spawn(spec, 2, 4)}


def procs_serve(stash: dict, launched: dict) -> dict:
    """serve_path's four tenants as 2 processes × 4 ranks over gloo
    (module docstring): each tenant runs its mix once under ``fair``,
    then under ``priority`` with checkpoints armed and the last tenant
    submitted late; every answer equal to serve_path's solo answer at
    W = 8 (the first queries of each tenant's solo run).  ``stash``:
    serve_path's solo digests and ledger budget."""
    spec = launched["spec"]
    once = {name: recs[:len(SERVE_MIXES[int(name[1:])])]
            for name, recs in stash["solo"].items()}
    solo = {name: [{"q": r["q"], "digest": r["digest"]} for r in recs]
            for name, recs in once.items()}
    nproc = len(launched["procs"])
    with open(spec["solo"], "w", encoding="utf-8") as f:
        # each process's ledger holds its own ranks' bytes: the budget
        # splits as the tables do
        json.dump({"solo": solo,
                   "ledger_budget": stash["ledger_budget"] // nproc}, f)
    t_leg = time.perf_counter()
    open(launched["go"], "w").close()
    res = _procs_wait("procs_serve", launched["procs"], [0, 0],
                      t_leg + PROCS_TIMEOUT_S)
    wall = time.perf_counter() - t_leg
    for r in res:
        pre = r["priority"]["scheduler"]
        if pre["preemptions"] < 1 or pre["requeues"] < 1 \
                or r["priority"]["checkpoint"][
                    "resume_fast_forwarded_pieces"] < 1:
            raise AssertionError(f"procs_serve process {r['pid']}: "
                                 f"preempt leg {pre}")
        for leg in ("fair", "priority"):
            if not all(c["bit_equal"] for c in r[leg]["checks"].values()):
                raise AssertionError(f"procs_serve {leg}: kernel checks "
                                     f"{r[leg]['checks']}")
    for leg in ("fair", "priority"):
        outs = [{n: (t["outcome"], t["preemptions"], t["mix"])
                 for n, t in r[leg]["tenants"].items()} for r in res]
        if outs[0] != outs[1]:
            raise AssertionError(f"procs_serve {leg}: the processes' "
                                 f"schedules differ: {outs}")
    solo_sum = sum(r["latency_s"] for recs in once.values() for r in recs)
    legs = {}
    for leg in ("fair", "priority"):
        legs[leg] = {
            "elapsed_s": [r[leg]["elapsed_s"] for r in res],
            "over_solo_sum_mix_once": max(r[leg]["elapsed_s"]
                                          for r in res) / solo_sum,
            "tenants": {n: {key: t[key] for key in (
                "mix", "p50_latency_s", "p99_latency_s", "latencies_s",
                "outcome", "preemptions", "requeues", "admission_waits")}
                for n, t in res[0][leg]["tenants"].items()},
            "evictions": [r[leg]["scheduler"]["scheduler_evictions"]
                          + r[leg]["cross_session_evictions"] for r in res],
            "preemptions": res[0][leg]["scheduler"]["preemptions"],
            "votes": [r[leg]["votes"] for r in res],
            "checks": [r[leg]["checks"] for r in res]}
    launches = {name: sum(r[leg]["kernel_counts"][name]["launches"]
                          for r in res for leg in ("fair", "priority"))
                for name in ("windowed_gather", "splitter_probe")}
    return {"phase": "procs_serve", "processes": 2, "local_world": 4,
            "world": 8, "backend": "gloo", "queries": "each mix once",
            "solo_sum_mix_once_s": solo_sum, "wall_s": wall, **legs,
            "children": [{key: r.get(key) for key in (
                "pid", "tables_load_s", "upload_s", "setup_s", "wall_s")}
                for r in res],
            "kernel_counts": {k: {"launches": v}
                              for k, v in launches.items()},
            "oracle": "every answer's digest equal to serve_path's solo"}


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 (wrapping products; the logical
    shifts masked out of torch's arithmetic ones)."""
    x = x ^ ((x >> 30) & ((1 << 34) - 1))
    x = x * -4658895280553007687
    x = x ^ ((x >> 27) & ((1 << 37) - 1))
    x = x * -7723592293110705685
    return x ^ ((x >> 31) & ((1 << 33) - 1))


def window_digest(out) -> list:
    """A closed window's rows as a multiset: ``[rows, Σ mix(row) mod
    2^64]`` over its live rows (k, t, qty, amount, dim), each process
    over its own shards, summed across processes (one allgather)."""
    from cylon_tpu_torch.parallel import transport
    from cylon_tpu_torch.parallel.shards import local_counts
    w = out.env.world_size
    dev = out.column("k").data.device
    vc = torch.as_tensor(local_counts(out.valid_counts), device=dev)
    live = (torch.arange(out.capacity, device=dev)[None, :]
            < vc[:, None]).reshape(-1)
    c = {n: out.column(n).data[live]
         for n in ("k", "t", "qty", "amount", "dim")}
    h = _mix64(stream_pack(c["k"], c["t"], c["qty"],
                           c["amount"].to(torch.int64)) ^ _mix64(c["dim"]))
    mine = np.asarray([[int(vc.sum()), int(h.sum())]], np.int64)
    if transport.current(w) is not None:
        mine = transport.allgather_array(mine[0], "window_digest")
    return [int(mine[:, 0].sum()),
            int(mine[:, 1].view(np.uint64).sum(dtype=np.uint64))]


def read_digest(cols: dict) -> tuple:
    """A view read (host columns, :meth:`Table.host_columns`) sorted by
    key: the sha256 of every column but var and std, and those two as
    arrays (held to ``STREAM_VAR_TOL``, not bit for bit)."""
    import hashlib
    order = stable_order(cols["k"][0])
    h = hashlib.sha256()
    var = {}
    for name, (data, valid) in cols.items():
        if name in STREAM_VAR_COLS:
            var[name] = np.asarray(data)[order]
            continue
        h.update(name.encode())
        for x in (data, valid):
            if x is not None:
                h.update(np.ascontiguousarray(np.asarray(x)[order])
                         .tobytes())
    return h.hexdigest(), var


def stream_tracker(wj, digests: dict, var: list):
    """An ``each(i, read)`` for :func:`stream_ingest`: batch i's read
    digest and var/std, and every window closed by then's digest."""
    def each(i, read):
        d, v = read_digest(read)
        digests["reads"].append(d)
        var.append(v)
        for wid, out in wj.closed:
            if str(wid) not in digests["windows"]:
                digests["windows"][str(wid)] = window_digest(out)
                digests["closed_at_batch"][str(wid)] = i
    return each


def procs_stream_child(spec: dict) -> int:
    """One process of ``procs_stream``: stream_path's first
    ``spec["batches"]`` batches drawn on this process's device (the same
    generator, so the same batches), every process appending each whole
    batch (SPMD ingest) into the stream, its view and its window join.
    Prints one JSON line: rows/s, p50/p99 staleness, every read's and
    closed window's digest; var and std of every read go to
    ``spec["out"]``."""
    import os
    from cylon_tpu_torch.parallel import transport
    ct, env = _procs_env(spec)
    t_start = time.perf_counter()
    batches = stream_batches(spec["batches"], spec["rows"],
                             device=env.device)
    gen_s = time.perf_counter() - t_start
    st, view, wj = stream_objects(ct, env, "procs_stream")
    env.barrier()
    kernel_counts(reset=True)
    transport.reset_stats()
    digests: dict = {"reads": [], "windows": {}, "closed_at_batch": {}}
    var: list = []
    rec = stream_ingest(st, view, wj, batches,
                        each=stream_tracker(wj, digests, var))
    rec.pop("closed_at")
    rec.update(phase="procs_child", leg="procs_stream", pid=spec["pid"],
               world=env.world_size, gen_s=gen_s,
               kernel_counts=kernel_counts(),
               transport=dict(transport.STATS), digests=digests,
               stats={"view": view.stats(), "window": wj.stats()})
    np.savez(os.path.join(spec["out"], f"var_p{spec['pid']}.npz"),
             **{f"{i}|{c}": v[c] for i, v in enumerate(var) for c in v})
    stream_teardown(view, wj, st)
    env.barrier()
    env.finalize()
    rec["wall_s"] = time.perf_counter() - t_start
    print(json.dumps(rec), flush=True)
    return 0


def procs_stream_launch(out: str, device=None) -> dict:
    """Start ``procs_stream``'s two children (2 processes × 2 ranks)
    before ``stream_path`` runs, behind a go file in ``out`` (where they
    write their var/std arrays)."""
    import os
    go = os.path.join(out, "pst_go")
    return {"go": go, "out": out, "procs": _procs_spawn(
        {"leg": "procs_stream", "go": go, "out": out,
         "batches": PROCS_STREAM_BATCHES, "rows": STREAM_ROWS,
         "device": device}, 2, 2)}


def procs_stream(want: dict, launched: dict) -> dict:
    """stream_path's stream as 2 processes × 2 ranks over gloo (module
    docstring): its first batches; every read and every closed window
    equal to the one-process W = 4 run's at the same batch (``want``,
    recorded by stream_path), var and std of every read within
    ``STREAM_VAR_TOL`` of it, every other column bit-equal."""
    import os
    t_leg = time.perf_counter()
    open(launched["go"], "w").close()
    res = _procs_wait("procs_stream", launched["procs"], [0, 0],
                      t_leg + PROCS_TIMEOUT_S)
    wall = time.perf_counter() - t_leg
    n = PROCS_STREAM_BATCHES
    want_w = {wid: d for wid, d in want["digests"]["windows"].items()
              if want["digests"]["closed_at_batch"][wid] < n}
    worst = 0.0
    for r in res:
        got = r["digests"]
        if got["reads"] != want["digests"]["reads"][:n]:
            bad = [i for i, (a, b) in enumerate(zip(
                got["reads"], want["digests"]["reads"])) if a != b]
            raise AssertionError(f"procs_stream process {r['pid']}: reads "
                                 f"{bad} differ from the one-process run's")
        if got["windows"] != want_w or {
                w_: got["closed_at_batch"][w_] for w_ in want_w} != {
                w_: want["digests"]["closed_at_batch"][w_]
                for w_ in want_w}:
            raise AssertionError(f"procs_stream process {r['pid']}: windows "
                                 f"{got['windows']} against {want_w}")
        with np.load(os.path.join(launched["out"],
                                  f"var_p{r['pid']}.npz")) as z:
            for i in range(n):
                for c in STREAM_VAR_COLS:
                    a, b = z[f"{i}|{c}"], want["var"][i][c]
                    if c == "amount_std":
                        a, b = a * a, b * b
                    ok = np.isnan(b)
                    if not np.array_equal(np.isnan(a), ok):
                        raise AssertionError(f"procs_stream batch {i} {c}: "
                                             "NaN where the one-process "
                                             "run has a value")
                    err = np.abs(a[~ok] - b[~ok]) / np.maximum(
                        np.abs(b[~ok]), np.finfo(np.float64).tiny)
                    worst = max(worst, float(err.max(initial=0.0)))
        no_kernels(r, f"procs_stream process {r['pid']}")
    if worst > STREAM_VAR_TOL:
        raise AssertionError(f"procs_stream: var/std {worst:.3g} from the "
                             "one-process run's")
    return {"phase": "procs_stream", "processes": 2, "local_world": 2,
            "world": 4, "backend": "gloo", "batches": n,
            "rows_per_batch": STREAM_ROWS, "wall_s": wall,
            "rows_per_s": [r["rows_per_s"] for r in res],
            "staleness_p50_s": [r["staleness_p50_s"] for r in res],
            "staleness_p99_s": [r["staleness_p99_s"] for r in res],
            "one_process_rows_per_s_first_batches":
                want["rows_per_s_first"],
            "reads_equal": n, "windows_equal": len(want_w),
            "var_std_largest_rel_diff": worst,
            "children": [{key: r.get(key) for key in (
                "pid", "gen_s", "ingest_wall_s", "wall_s", "transport",
                "stats", "windows_closed", "late_dropped")} for r in res],
            "kernel_counts": {k: {"launches": sum(
                r["kernel_counts"][k]["launches"] for r in res)}
                for k in ("windowed_gather", "splitter_probe")},
            "oracle": "every read and window equal to stream_path's"}


#: the compile watchdog's budget of compile_small's stall child, seconds
COMPILE_STALL_S = 2.0
#: the compile tier's switches a compile_small child is given
COMPILE_VARS = ("CYLON_TPU_TORCH_COMPILE_CACHE_DIR",
                "CYLON_TPU_TORCH_COMPILE_TIMEOUT_S",
                "CYLON_TPU_TORCH_FAULTS")


#: the main path's K1 and K2 shapes (the BASELINE W = 4 monolithic step,
#: 125,829,120 rows a side): compile_small's children hold the libraries
#: they loaded or rebuilt at them
K1_MAIN = {"L": 7, "M": 251_658_241, "S": 52_428_800, "window": 2048}
K2_MAIN_CAP = 125_829_120


def compile_kernel_checks(dev) -> dict:
    """K1 and K2 held bit-equal to their plain versions (through whatever
    libraries the compile tier loaded) at the main path's shapes, on
    inputs drawn on the card from a seed: every 256-row tile of the
    sorted K1 indices spans about 1,230 rows, inside the 2,048-row
    window.  A rehearsal on the host uses small shapes."""
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    L, M, S, window = (K1_MAIN[k] for k in ("L", "M", "S", "window"))
    cap = K2_MAIN_CAP
    if dev.type == "cpu":
        M, S, cap = 4097, 1024, 1 << 16
    mat = torch.randint(0, 1 << 30, (L, M), generator=gen, device=dev,
                        dtype=torch.int32)
    idx = torch.sort(torch.randint(0, M, (S,), generator=gen, device=dev,
                                   dtype=torch.int32)).values
    k1 = k1_check(wg, "compile_small", mat, idx, window)
    del mat, idx
    key = torch.randint(-(1 << 30), 1 << 30, (cap,), generator=gen,
                        device=dev, dtype=torch.int32)
    live = torch.zeros(cap, dtype=torch.int32, device=dev)
    pick = torch.randint(0, cap, (5,), generator=gen, device=dev)
    split = torch.sort(key[pick]).values
    k2 = k2_check(sp, "compile_small", (live, key),
                  (torch.zeros(5, dtype=torch.int32, device=dev), split))
    return {"k1": {k: k1[k] for k in ("bit_equal", "ok", "max_abs_err", "M",
                                      "S")},
            "k2": {k: k2[k] for k in ("bit_equal", "max_abs_err", "cap",
                                      "S")}}


def compile_child(spec: dict) -> int:
    """One process of ``compile_small``: the compile tier armed by the
    switches the parent set; builds (or loads) both kernels through the
    facade and, with ``check``, holds K1 and K2 bit-equal to their plain
    versions on the card.  Prints one JSON line: the exception the build
    raised (its class name) or None, the facade's counters, the build
    seconds per kernel and the kernel checks."""
    import os
    t0 = time.perf_counter()
    import cylon_tpu_torch  # noqa: F401
    from cylon_tpu_torch import kernels
    from cylon_tpu_torch.exec import compiler
    rec = {"phase": "compile_child", "mode": spec["mode"],
           "pid": os.getpid(), "error": None}
    try:
        kernels.build()
        for name in kernels.SOURCES:
            kernels.load(name)
    except Exception as e:  # noqa: BLE001 — reported, judged by the parent
        rec.update(error=type(e).__name__, message=str(e)[:400],
                   signature=getattr(e, "signature", None))
    rec["build_s"] = time.perf_counter() - t0
    if rec["error"] is None and spec.get("check"):
        dev = torch.device(spec.get("device") or "cuda:0")
        if dev.type == "cpu":
            # a rehearsal on the host: the checks' device waits are moot
            torch.cuda.synchronize = lambda *a, **k: None
        rec["checks"] = compile_kernel_checks(dev)
    rec["stats"] = compiler.stats()
    rec["build_seconds"] = dict(compiler.build_seconds)
    rec["quarantined"] = list(compiler.quarantined_signatures())
    rec["wall_s"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)
    return 0


def _compile_spawn(mode: str, d: str, check: bool = False, device=None,
                   **switches) -> subprocess.Popen:
    import os
    env = {k: v for k, v in os.environ.items() if k not in COMPILE_VARS}
    env["CYLON_TPU_TORCH_COMPILE_CACHE_DIR"] = d
    env.update({f"CYLON_TPU_TORCH_{k}": str(v) for k, v in switches.items()})
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--compile-child",
         json.dumps({"mode": mode, "check": check, "device": device})],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _compile_wait(p: subprocess.Popen, label: str, rc: int = 0) -> dict:
    out, err = p.communicate(timeout=300)
    if p.returncode != rc:
        raise AssertionError(f"compile_small {label}: the child exited "
                             f"{p.returncode}, expected {rc}\n{out[-2000:]}"
                             f"\n{err[-4000:]}")
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if rc == 0 and not lines:
        raise AssertionError(f"compile_small {label}: no result\n"
                             f"{err[-4000:]}")
    return json.loads(lines[-1]) if lines else {"rc": p.returncode}


def compile_small_start(device=None) -> dict:
    """``compile_small`` (module docstring), its first half: the compile
    tier's persistent layer in fresh directories under a new temporary
    root.  This process builds K1 and K2 cold into the first (two builds,
    two manifest entries); then the children start, side by side: one
    loads them as hits with no build and holds both kernels bit-equal; one
    finds a copy of the directory with K1's manifest entry poisoned and
    one byte of K2's library flipped, drops both, rebuilds both and holds
    both bit-equal; one under ``compile.build=kill`` dies with its intent
    on disk; one under ``compile.build=stall`` with a 2 s budget raises
    ``CompileTimeoutError``.  :func:`compile_small_finish` waits for them
    (the phases between run beside them).  ``device``: the children's
    kernel checks run on the card unless a rehearsal passes the CPU."""
    import shutil
    import tempfile
    t_leg = time.perf_counter()
    root = tempfile.mkdtemp(prefix="cylon_compile_")
    try:
        return _compile_small_start(root, device, t_leg)
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise


def _compile_small_start(root: str, device, t_leg: float) -> dict:
    import os
    import shutil
    from cylon_tpu_torch import config as pconfig
    from cylon_tpu_torch import kernels
    from cylon_tpu_torch.exec import compiler
    warm, crash, stall = (os.path.join(root, d)
                          for d in ("warm", "crash", "stall"))
    for d in (warm, crash, stall):
        os.makedirs(d)
    prev = pconfig.COMPILE_CACHE_DIR
    pconfig.COMPILE_CACHE_DIR = warm
    compiler.rearm()
    compiler.reset_stats()
    try:
        t0 = time.perf_counter()
        kernels.build()
        cold_s = time.perf_counter() - t0
        cold = compiler.stats()
        cold_secs = dict(compiler.build_seconds)
        paths = {n: kernels.library_path(n) for n in kernels.SOURCES}
    finally:
        pconfig.COMPILE_CACHE_DIR = prev
        compiler.rearm()
    with open(os.path.join(warm, "manifest.json"), encoding="utf-8") as f:
        man = json.load(f)
    if cold["cache_misses"] != 2 or cold["compile_events"] != 2 \
            or sorted(e["kernel"] for e in man.values()) \
            != sorted(kernels.SOURCES):
        raise AssertionError(f"compile_small cold build: {cold}, "
                             f"manifest {man}")
    # a copy of the warm directory whose K1 manifest entry is poisoned
    # and one byte of whose K2 library is flipped
    bad_dir = os.path.join(root, "poisoned")
    shutil.copytree(warm, bad_dir)
    k1_name = os.path.basename(paths["windowed_gather"])
    man[k1_name]["sha256"] = "0" * 64
    with open(os.path.join(bad_dir, "manifest.json"), "w",
              encoding="utf-8") as f:
        json.dump(man, f)
    k2_lib = os.path.join(bad_dir, "kernels",
                          os.path.basename(paths["splitter_probe"]))
    with open(k2_lib, "r+b") as f:
        f.seek(4096)
        b = f.read(1)
        f.seek(4096)
        f.write(bytes([b[0] ^ 1]))
    procs = {"hits": _compile_spawn("hits", warm, check=True,
                                    device=device),
             "poisoned": _compile_spawn("poisoned", bad_dir, check=True,
                                        device=device),
             "kill": _compile_spawn("kill", crash,
                                    FAULTS="compile.build=kill"),
             "stall": _compile_spawn("stall", stall,
                                     FAULTS="compile.build=stall",
                                     COMPILE_TIMEOUT_S=COMPILE_STALL_S)}
    return {"root": root, "crash": crash, "procs": procs, "t_leg": t_leg,
            "rec": {"phase": "compile_small", "cold_build_s": cold_s,
                    "nvcc_seconds": cold_secs, "cold": cold}}


def compile_small_finish(state: dict) -> dict:
    """``compile_small``'s second half: wait for the children
    (:func:`compile_small_start`), start the one that finds the killed
    child's intent (it must raise ``CompileQuarantinedError``), hold every
    outcome and remove the temporary root.  Any other outcome fails the
    phase."""
    import os
    import shutil
    procs, crash = state["procs"], state["crash"]
    res = {}
    try:
        res["kill"] = _compile_wait(procs["kill"], "kill", rc=-9)
        intents = [f for f in os.listdir(crash) if f.startswith("intent.")]
        # the dead predecessor's intent: the next build is quarantined
        procs["quarantine"] = _compile_spawn("quarantine", crash)
        for mode in ("quarantine", "hits", "poisoned", "stall"):
            res[mode] = _compile_wait(procs[mode], mode)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(state["root"], ignore_errors=True)
    h, p_, q, st = (res[k] for k in ("hits", "poisoned", "quarantine",
                                     "stall"))
    bad = []
    if h["error"] or h["stats"]["cache_misses"] or \
            h["stats"]["compile_events"] or h["stats"]["cache_hits"] < 2:
        bad.append(("hits", h))
    if p_["error"] or p_["stats"]["manifest_drops"] != 2 or \
            p_["stats"]["cache_misses"] != 2:
        bad.append(("poisoned", p_))
    if len(intents) != 1:
        bad.append(("kill", intents))
    if q["error"] != "CompileQuarantinedError" or \
            q["stats"]["quarantine_adoptions"] != 2:
        bad.append(("quarantine", q))
    if st["error"] != "CompileTimeoutError" or \
            st["stats"]["watchdog_timeouts"] != 1:
        bad.append(("stall", st))
    for r in (h, p_):
        checks = r.get("checks", {})
        if not (checks.get("k1", {}).get("bit_equal")
                and checks.get("k2", {}).get("bit_equal")):
            bad.append(("checks", r))
    if bad:
        raise AssertionError(f"compile_small: {bad}")
    return {**state["rec"], "children": res,
            "wall_s": time.perf_counter() - state["t_leg"],
            "oracle": "hits without a build; poisoned and flipped "
                      "libraries dropped and rebuilt; quarantined after a "
                      "kill; a stall typed; K1 and K2 bit-equal"}


#: the analysis gate child's time limit
GATE_TIMEOUT_S = 300
#: the side child's time limit
SIDE_TIMEOUT_S = 600


def side_child(spec: dict) -> int:
    """``--side-child``: correctness-only phases (``skew_small``,
    ``tpch_small``, ``stream_small``) in a process of their own, on the
    card, one JSON line per phase record."""
    import cylon_tpu_torch as ct
    device = spec.get("device")
    for name in spec["phases"]:
        if name == "skew_small":
            recs = [{"phase": "skew_small", "oracle": "equal", **r}
                    for r in skew_small(ct, SMALL_WORLDS, SMALL_ROWS,
                                        device)]
        elif name == "stream_small":
            with ckpt_root(spec.get("ckpt_dir")) as root:
                recs = stream_small(ct, root, device=device)
        else:
            recs = tpch_small(ct, scale=spec["scale"], device=device)
        for rec in recs:
            no_recovery(f"phase {rec['phase']}")
            print(json.dumps(rec), flush=True)
    return 0


def side_start(spec: dict, device=None) -> dict:
    """Start a ``--side-child`` process (its phases beside this one's)."""
    import os
    if device is not None:
        spec = dict(spec, device=str(device))
    return {"spec": spec, "proc": subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--side-child",
         json.dumps(spec)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)}


def side_finish(state: dict) -> list:
    """Wait for the side child (killed past :data:`SIDE_TIMEOUT_S`) and
    return its records; it must exit 0 with one record per phase run."""
    p = state["proc"]
    try:
        so, se = p.communicate(timeout=SIDE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        p.kill()
        so, se = p.communicate()
    recs = [json.loads(ln) for ln in so.splitlines() if ln.startswith("{")]
    if p.returncode != 0 or {r["phase"] for r in recs} != set(
            state["spec"]["phases"]):
        raise AssertionError(f"side child {state['spec']['phases']} exited "
                             f"{p.returncode}\n{se[-4000:]}")
    return recs


#: the soak's schedules here: the four pinned ones.  The two drawn ones
#: (``--schedules 6``) took the script to 1101 s, past its 1100 s budget,
#: and were cut first
SOAK_SCHEDULES = 4
#: the soak's command line on the card: 67.1M lineitem rows, so a
#: piece's shard holds about 2^20 orders, K1's segment-space gate (at
#: 33.5M rows, 2^19, K1 never launched)
SOAK_ARGS = ("--rows", "67108864", "--chunks", "4", "--world", "4",
             "--seed", "5", "--schedules", str(SOAK_SCHEDULES))
#: the soak child's time limit
SOAK_TIMEOUT_S = 900


def soak_start() -> dict:
    """``chaos_soak`` (module docstring), started: the port's soak as a
    child process from this checkout."""
    import os
    cmd = ["-m", "cylon_tpu_torch.exec.chaos_soak", *SOAK_ARGS]
    # a session of its own: a soak killed at its limit takes the child it
    # is running with it
    return {"t0": time.perf_counter(), "cmd": cmd,
            "proc": subprocess.Popen(
                [sys.executable, *cmd],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                start_new_session=True)}


def soak_finish(state: dict) -> dict:
    """Wait for the soak child (killed past :data:`SOAK_TIMEOUT_S`): it
    must exit 0 with no failure, its baseline equal to the numpy oracle,
    both kernels launched by the baseline and their first launches
    bit-equal, and every schedule converged."""
    import os
    import signal
    p = state["proc"]
    try:
        so, se = p.communicate(timeout=SOAK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        so, se = p.communicate()
    lines = so.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else {}
    except ValueError:
        last = {}
    base = last.get("baseline") or {}
    first = base.get("first_launch") or {}
    launches = last.get("kernel_launches") or {}
    rec = {"phase": "chaos_soak", "cmd": " ".join(state["cmd"]),
           "rc": p.returncode, "wall_s": time.perf_counter() - state["t0"],
           "seconds": last.get("seconds"), "failures": last.get("failures"),
           "children": last.get("children"),
           "children_s": last.get("children_s"),
           "baseline": {k: base.get(k) for k in (
               "rows", "seconds", "kernel_launches", "first_launch",
               "oracle", "oracle_s")},
           "outcomes": [{k: o.get(k) for k in (
               "schedule", "faults", "resume_faults", "outcome", "ok",
               "seconds")} for o in last.get("outcomes") or []],
           "kernel_launches": launches,
           "progress": [ln for ln in lines if ln.startswith("#")]}
    base_launches = base.get("kernel_launches") or {}
    bad = []
    if p.returncode != 0 or last.get("failures") != 0:
        bad.append(f"rc {p.returncode}, failures {last.get('failures')}: "
                   f"{last.get('detail')}")
    if base.get("oracle") != "equal":
        bad.append("the baseline differs from the numpy oracle")
    if not base_launches.get("windowed_gather") \
            or not base_launches.get("splitter_probe"):
        bad.append(f"the baseline's launches {base_launches}")
    for name in ("k1", "k2"):
        if not (first.get(name) or {}).get("bit_equal"):
            bad.append(f"{name}'s first launch: {first.get(name)}")
    if len(rec["outcomes"]) != SOAK_SCHEDULES \
            or not all(o["ok"] for o in rec["outcomes"]):
        bad.append(f"outcomes {rec['outcomes']}")
    if bad:
        raise AssertionError(f"chaos_soak: {bad}\n{so[-3000:]}\n"
                             f"{se[-3000:]}")
    return rec


def local_rank_check(ct) -> dict:
    """``local_rank`` (module docstring): ``LOCAL_RANK`` past the cards
    raises ``DeviceUnavailableError`` at the config, with no rendezvous
    (the address names no listener); the last card's picks that card."""
    import os
    n = torch.cuda.device_count()
    old = os.environ.get("LOCAL_RANK")
    try:
        os.environ["LOCAL_RANK"] = str(n)
        try:
            ct.DistributedConfig("127.0.0.1:1", 0, 1)
        except ct.DeviceUnavailableError as e:
            message = str(e)
        else:
            raise AssertionError(f"local_rank: LOCAL_RANK={n} on {n} "
                                 "card(s) did not raise")
        os.environ["LOCAL_RANK"] = str(n - 1)
        dev = ct.DistributedConfig("127.0.0.1:1", 0, 1).devices[0]
        if dev != torch.device("cuda", n - 1):
            raise AssertionError(f"local_rank: LOCAL_RANK={n - 1} gave "
                                 f"{dev}")
    finally:
        if old is None:
            os.environ.pop("LOCAL_RANK", None)
        else:
            os.environ["LOCAL_RANK"] = old
    return {"phase": "local_rank", "cards": n, "past_the_cards": n,
            "raised": "DeviceUnavailableError", "message": message,
            "last_card": str(dev)}


def gate_start() -> dict:
    """``analysis_gate`` (module docstring), started: the port's gate,
    ``python -m cylon_tpu_torch.analysis --strict``, as a child process
    from this checkout."""
    import os
    args = ["--strict", "--fail-stale-suppressions", "--no-cache"]
    # at nice 10, as the TPC-H generator: the phases beside it keep the
    # host
    code = ("import os, runpy, sys\nos.nice(10)\n"
            f"sys.argv = ['cylon_tpu_torch.analysis'] + {args!r}\n"
            "runpy.run_module('cylon_tpu_torch.analysis', "
            "run_name='__main__', alter_sys=True)")
    return {"t0": time.perf_counter(),
            "cmd": ["-m", "cylon_tpu_torch.analysis"] + args,
            "proc": subprocess.Popen(
                [sys.executable, "-c", code],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}


def gate_finish(state: dict) -> dict:
    """Wait for the gate child (killed past :data:`GATE_TIMEOUT_S`); its
    exit code must be 0."""
    p = state["proc"]
    try:
        so, se = p.communicate(timeout=GATE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        p.kill()
        so, se = p.communicate()
    rec = {"phase": "analysis_gate", "cmd": " ".join(state["cmd"]),
           "rc": p.returncode, "wall_s": time.perf_counter() - state["t0"],
           "python": sys.version.split()[0],
           "stderr": se.strip().splitlines()[-4:],
           "findings": so.strip().splitlines()[:20]}
    if p.returncode != 0:
        raise AssertionError(f"analysis_gate: {rec}")
    return rec


def serve_phases(ct, args, routes: dict, k2_serve: dict,
                 tables: TpchTables) -> None:
    """``tpch_path`` at ``--tpch-scale``, W = 8 (on ``tables``, drawn in
    the background), with ``serve_path`` and its preempt leg on the same
    tables, then ``procs_serve`` (its children start before
    ``tpch_path`` and wait) and ``serve_small``, ``stream_small`` beside
    it in a side process; emits their records, adds their kernel counts
    to ``routes`` and the serve routes' K2 checks to ``k2_serve``;
    returns ``stream_small``'s records."""
    with ckpt_root(args.ckpt_dir) as root:
        t0 = time.perf_counter()
        launched = procs_serve_launch(tables.wait(), root)
        stash = None
        try:
            for trec in tpch_path(ct, args.tpch_scale, serve_root=root,
                                  tables=tables):
                if trec["phase"] == "tpch_path":
                    routes[f"tpch_path_{trec['query']}_w8"] = \
                        trec["kernel_counts"]
                elif trec["phase"] != "tpch_sentinel":
                    routes[f"{trec['phase']}_w8"] = trec["kernel_counts"]
                    k2_serve.update(trec.pop("k2", {}))
                    stash = trec.pop("_solo", stash)
                emit(trec)
            del trec
            torch.cuda.empty_cache()
            prec = procs_serve(stash, launched)
        finally:
            _procs_kill(launched["procs"])
        tables.close()
        routes["procs_serve"] = prec["kernel_counts"]
        emit(prec)
        t1 = time.perf_counter()
        side = side_start({"phases": ["stream_small"],
                           "ckpt_dir": args.ckpt_dir})
        try:
            srec = serve_small(ct, root)
        finally:
            side_recs = side_finish(side)
        srec["seconds"] = time.perf_counter() - t1
        srec["tpch_and_serve_path_s"] = t1 - t0
        emit(srec)
        torch.cuda.empty_cache()
    return side_recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=125_000_000,
                    help="rows per side of the full BASELINE run")
    ap.add_argument("--config3-rows", type=int, default=CONFIG3_ROWS,
                    help="rows in total of BASELINE configuration 3")
    ap.add_argument("--fact-rows", type=int, default=FACT_ROWS,
                    help="fact-table rows of the broadcast phase")
    ap.add_argument("--string-rows", type=int, default=STRING_ROWS,
                    help="rows per table of the hashed-string phase")
    ap.add_argument("--scan-rows", type=int, default=SCAN_ROWS,
                    help="rows per side of the series and scan-join phases")
    ap.add_argument("--skew-rows", type=int, default=SKEW_ROWS,
                    help="rows per side of the skewed join (configuration 5)")
    ap.add_argument("--tpch-scale", type=float, default=TPCH_SCALE,
                    help="TPC-H scale factor of tpch_path (configuration 4)")
    ap.add_argument("--oom-rows", type=int, default=OOM_ROWS,
                    help="rows per side of oom_path (must not fit the card)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="where ckpt_path and ckpt_small make their fresh "
                    "checkpoint root (default: the system's temporary "
                    "directory)")
    ap.add_argument("--ckpt-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--procs-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tpch-gen", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--compile-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--side-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side_child is not None:
        return side_child(json.loads(args.side_child))
    if args.compile_child is not None:
        return compile_child(json.loads(args.compile_child))
    if args.ckpt_child is not None:
        return ckpt_child(json.loads(args.ckpt_child))
    if args.procs_child is not None:
        return procs_child(json.loads(args.procs_child))
    if args.tpch_gen is not None:
        return tpch_gen_child(json.loads(args.tpch_gen))
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this smoke run needs "
              "the card", file=sys.stderr)
        return 1
    import cylon_tpu_torch as ct
    from cylon_tpu_torch import kernels
    from cylon_tpu_torch.ops import splitter_probe as sp
    from cylon_tpu_torch.ops import windowed_gather as wg
    from cylon_tpu_torch.utils import timing
    from torch.utils import cpp_extension

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "ninja": cpp_extension.is_ninja_available()})

    # -- build every kernel from the checkout's sources --------------------
    t0 = time.perf_counter()
    libs = kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs), "ptxas": kernels.build_logs})
    # TPC-H's tables for tpch_path, drawn by a low-priority background
    # process while the card-bound phases run
    import atexit
    tpch_tables = TpchTables(args.tpch_scale)
    atexit.register(tpch_tables.close)

    # -- K1 against its plain version on the card -------------------------
    rng = np.random.default_rng(42)
    for lanes in (1, 7, 8, 13):
        mat, idx = small_cases(rng, 4096, lanes, 2048, "dense", dev)
        for rec in k1_forms(wg, f"dense_L{lanes}", mat, idx, 1024, True):
            emit(rec)
    mat, idx = small_cases(rng, 4096, 5, 1024, "tail", dev)
    for rec in k1_forms(wg, "sentinel_tail", mat, idx, 1024, True):
        emit(rec)
    mat, idx = small_cases(rng, 1 << 15, 6, 4096, "skewed", dev)
    for rec in k1_forms(wg, "skewed", mat, idx, 1024, False):
        emit(rec)
    # M % 128 != 0 and tail tiles on padding columns
    mat, idx = small_cases(rng, 4000, 3, 1024, "dense", dev)
    idx[-256:] = 3999
    for rec in k1_forms(wg, "unaligned_rows", mat, idx, 1024, None):
        emit(rec)
    # separate lanes, each starting 0-3 words past a 16-byte boundary
    mat, idx = small_cases(rng, 1 << 14, 4, 4096, "dense", dev)
    lanes = []
    for off, row in enumerate(mat):
        buf = torch.empty(row.shape[0] + 4, dtype=row.dtype, device=dev)
        lanes.append(buf[off:off + row.shape[0]])
        lanes[-1].copy_(row)
    emit(k1_check(wg, "lanes_at_word_offsets", lanes, idx, 2048, True))
    # BASELINE-shaped: L=7, M=2^28+1, S=2^26, ~0.2 density, sentinel tail
    gen = torch.Generator(device=dev).manual_seed(42)
    M, S = (1 << 28) + 1, 1 << 26
    mat = torch.randint(-(1 << 31), (1 << 31) - 1, (7, M), dtype=torch.int32,
                        device=dev, generator=gen)
    real = torch.nonzero(torch.rand(M - 1, device=dev, generator=gen) < 0.2)
    idx = torch.full((S,), M - 1, dtype=torch.int32, device=dev)
    k = min(real.shape[0], S)
    idx[:k] = real[:k, 0].to(torch.int32)
    del real
    emit(k1_check(wg, "baseline_shaped", mat, idx, wg.pick_window(0.2),
                  True, timed=True))
    emit(k1_check(wg, "baseline_shaped_lanes", list(mat.unbind(0)), idx,
                  wg.pick_window(0.2), True))
    del mat, idx
    torch.cuda.empty_cache()

    # -- K2 against its plain version on the card -------------------------
    for rec in k2_cases(sp, dev):
        emit(rec)
    torch.cuda.empty_cache()


    env = ct.CylonEnv()

    # -- small path: 1M rows per side --------------------------------------
    left, right, mv = baseline_inputs(1_000_000)
    orc = oracle(left, right, mv)
    horc = host_oracle(left, right, mv)
    if any(not np.array_equal(np.asarray(orc[f]), np.asarray(horc[f]))
           for f in horc):
        raise AssertionError("the card's oracle differs from numpy's")
    del horc
    check_how_oracle_card(dev)
    lt, rt = ct.Table.from_pydict(left, env), ct.Table.from_pydict(right, env)
    n_groups = check_groupby(step(ct, lt, rt), orc, "small path")
    # read the deferred join instead of fusing it: Σ L·R rows, same sums
    j = ct.join_tables(lt, rt, "k", "k", how="inner")
    rows = j.to_pydict()
    if len(rows["k"]) != orc["rows"]:
        raise AssertionError("materialized join row count differs")
    sums = np.bincount(rows["k"], rows["a"], minlength=mv).astype(np.int64)
    if not np.array_equal(sums[orc["keep"]], (orc["sa"] * orc["R"])[orc["keep"]]):
        raise AssertionError("materialized join per-key sums differ")
    emit({"phase": "small_path", "rows_per_side": 1_000_000,
          "groups": n_groups, "join_rows": orc["rows"], "oracle": "equal"})
    del lt, rt, j, rows

    # -- full path: the main path, counted ---------------------------------
    n = args.rows
    t0 = time.perf_counter()
    left, right, mv = baseline_inputs(n)
    orc = oracle(left, right, mv)
    lt, rt = ct.Table.from_pydict(left, env), ct.Table.from_pydict(right, env)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # the host arrays stay for the W = 4 phases
    torch.cuda.reset_peak_memory_stats()
    wg.reset_counts()
    times = []
    g = step(ct, lt, rt, times)                 # warm-up (first sight)
    for _ in range(3):
        g = step(ct, lt, rt, times)
    counts = dict(wg.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    n_groups = check_groupby(g, orc, "full path")
    if counts["launches"] < 1 or counts["redispatches"] != 0:
        raise AssertionError(f"windowed gather counts {counts}: expected "
                             "launches > 0 and no redispatch")
    best = min(t["total_s"] for t in times[1:])
    emit({"phase": "full_path", "rows_per_side": n, "groups": n_groups,
          "setup_s": setup_s, "iterations": times, "best_s": best,
          "rows_per_s": 2 * n / best, "peak_mem_bytes": peak,
          "oracle": "equal",
          "kernel_counts": {"windowed_gather": counts}})

    prof = profile_step(ct, lt, rt)
    # the profiler slows the host many-fold: the idle share that counts
    # compares the device time with the unprofiled best
    prof["device_idle_share_of_best"] = 1.0 - prof["device_busy_s"] / best
    emit(prof)

    # -- pipelined path: bench.py's route, the same tables, counted ---------
    n_chunks = max(2, -(-n // PIECE_ROWS))
    del g
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wg.reset_counts()
    sp.reset_counts()
    times = []
    g = pipelined_step(ct, lt, rt, n_chunks, times)      # warm-up
    for _ in range(3):
        g = pipelined_step(ct, lt, rt, n_chunks, times)
    pipe_counts = {"splitter_probe": dict(sp.COUNTS),
                   "windowed_gather": dict(wg.COUNTS)}
    pipe_peak = torch.cuda.max_memory_allocated()
    n_groups = check_groupby(g, orc, "pipelined path")
    # K1 serves a piece only at a segment space of 2^20 groups or more
    # (relational/fused._win_size): from about 16M rows per side on, at
    # bench.py's piece size; the default 125M run must launch it
    need_k1 = n >= 16_000_000
    if pipe_counts["splitter_probe"]["launches"] < 1 \
            or (need_k1 and pipe_counts["windowed_gather"]["launches"] < 1):
        raise AssertionError(f"pipelined path kernel counts {pipe_counts}: "
                             "expected K2 launched, and K1 at >= 16M rows")
    del g
    # phase split: one more iteration with a device wait at the end of
    # every phase (this serializes the phases, so it is not a timed run)
    timing.enable("block")
    timing.reset()
    t0 = time.perf_counter()
    check_groupby(pipelined_step(ct, lt, rt, n_chunks), orc,
                  "attribution run")
    attributed_s = time.perf_counter() - t0
    phases = timing.snapshot()
    timing.enable(None)
    pbest = min(t["total_s"] for t in times[1:])
    emit({"phase": "pipelined_path", "rows_per_side": n, "n_chunks": n_chunks,
          "groups": n_groups, "iterations": times, "best_s": pbest,
          "rows_per_s": 2 * n / pbest, "peak_mem_bytes": pipe_peak,
          "oracle": "equal", "kernel_counts": pipe_counts,
          "phase_split_s": phases, "phase_split_total_s": attributed_s})

    prof = profile_step(
        ct, lt, rt,
        step_fn=lambda c, a, b: pipelined_step(c, a, b, n_chunks))
    prof["phase"] = "profile_pipelined"
    prof["device_idle_share_of_best"] = 1.0 - prof["device_busy_s"] / pbest
    emit(prof)

    # -- K1 and K2 at the main path's own inputs (one more run of each) ---
    captured = {}
    with capturing(wg, "windowed_take_t", captured, "mono", keep_k1):
        check_groupby(step(ct, lt, rt), orc, "capture run")
    # K2, and K1 on the first piece, at the pipelined path's own inputs
    with capturing(sp, "count_ge_splitters", captured, "probe"), \
            capturing(wg, "windowed_take_t", captured, "piece", keep_k1):
        check_groupby(pipelined_step(ct, lt, rt, n_chunks), orc,
                      "K2 capture run")
    del lt, rt
    torch.cuda.empty_cache()

    rec = k1_check(wg, "main_path", *captured.pop("mono"), True, timed=True)
    emit(rec)
    torch.cuda.empty_cache()
    piece = None
    if "piece" in captured:
        piece = k1_check(wg, "pipelined_piece", *captured.pop("piece"),
                         timed=True)
        emit(piece)
    elif need_k1:
        raise AssertionError("K1 capture run: no piece launched K1")
    torch.cuda.empty_cache()
    ops, sops = captured.pop("probe")
    rec2 = k2_check(sp, "main_path", ops, sops, timed=True)
    emit(rec2)
    # the general path on the key structures it serves, at the same rows:
    # (liveness, sign, key) as three int32 operands, and (liveness, hi
    # int32, lo u32 in int64) as a wide int64 key.  Each tuple orders as
    # the narrow key does, so every count equals the main path's.
    general = {}
    for name, form in (
            ("k3_int32", lambda o: (o[0], o[1] >> 31, o[1])),
            ("wide_key", lambda o: (o[0], o[1] >> 31,
                                    o[1].to(torch.int64) & 0xFFFFFFFF))):
        rec3 = k2_check(sp, f"main_path_as_{name}", form(ops), form(sops),
                        timed=True)
        if not torch.equal(sp.count_ge_splitters(form(ops), form(sops)),
                           sp.count_ge_splitters(ops, sops)):
            raise AssertionError(f"K2: the {name} counts differ from the "
                                 "narrow key's")
        emit(rec3)
        general[name] = {key: rec3[key] for key in (
            "K", "widths", "variant", "max_abs_err", "ms", "kernel_ms",
            "plain_ms", "bound_ms", "library_ms")}
    del ops, sops, captured
    torch.cuda.empty_cache()

    # -- world sizes above 1: W ranks on this card, both routes ------------
    routes, w4 = dist_phases(ct, left, right, orc, n, need_k1,
                             {"monolithic_w1": counts,
                              "pipelined_w1": pipe_counts})
    del orc
    torch.cuda.empty_cache()

    # -- the multi-process transport: 2 processes x 2 ranks over gloo,
    # 1 process x 4 ranks over NCCL, 4 processes x 1 rank over gloo on
    # the two-hop route, each result against dist_path's ----------------
    for prec in procs_path(ct, left, right, w4):
        for child in prec["children"]:
            routes[f"{prec['phase']}_p{child['pid']}"] = \
                child["kernel_counts"]
        emit(prec)
    del prec

    # -- the join types at full size, W = 4: a left join through the
    # DataFrame entry, an outer join through the pipeline (K2) ----------
    jrec = left_join_path(ct, left, right, mv)
    routes["left_join_w4"] = jrec["kernel_counts"]
    emit(jrec)
    jrec = outer_pipelined_path(ct, left, right, mv)
    routes["outer_pipelined_w4"] = jrec["kernel_counts"]
    w4["k2_outer_pipelined"] = jrec["k2_shard0"]
    emit(jrec)
    del jrec
    torch.cuda.empty_cache()

    # -- the set operations, the pipelined set op and the repartition at
    # full size, W = 4 ---------------------------------------------------
    for srec in setops_paths(ct, left, right, mv):
        routes[f"{srec['phase']}_{srec.get('query', 'w4')}"] = \
            srec["kernel_counts"]
        emit(srec)
    del left, right, srec
    torch.cuda.empty_cache()

    # -- the sort-based groupby, the sample sort, the DataFrame entry -----
    for w, small in groupby_small(ct, SMALL_WORLDS, SMALL_ROWS).items():
        emit({"phase": "groupby_small", "world": w, "rows": SMALL_ROWS,
              "oracle": "equal", **small})
    k, a, mv = config3_inputs(args.config3_rows)
    c3orc = config3_oracle(k, a, mv)
    for w in (4, 1):
        emit(config3_path(ct, k, a, c3orc, w))
    del k, a, c3orc
    # the compile tier: K1 and K2 built, loaded, poisoned, quarantined and
    # stalled under a persistent directory, its children beside joins_small
    # and the analysis gate, a child beside them
    gate = gate_start()
    try:
        compile_state = compile_small_start()
        try:
            for jrec in joins_small(ct, SMALL_WORLDS, SMALL_ROWS):
                emit({"phase": "joins_small", "rows_per_side": SMALL_ROWS,
                      "oracle": "equal", **jrec})
        finally:
            # waits for (and, failing, kills) every child it started
            crec = compile_small_finish(compile_state)
    finally:
        grec = gate_finish(gate)
    emit(crec)
    emit(grec)
    jrec = broadcast_path(ct, args.fact_rows)
    routes["broadcast_w4"] = jrec["kernel_counts"]
    emit(jrec)
    del jrec
    torch.cuda.empty_cache()
    for srec in setops_small(ct, SMALL_WORLDS, SMALL_ROWS):
        emit({"phase": "setops_small", "oracle": "equal", **srec})
    srec = strings_path(ct, args.string_rows)
    routes["strings_path"] = srec["kernel_counts"]
    emit(srec)
    del srec
    torch.cuda.empty_cache()

    # -- the Series, the index and the streamed scan join on bench.py's
    # tables at SCAN_ROWS rows, W = 4; breadth at SMALL_ROWS ----------------
    left, right, mv = baseline_inputs(args.scan_rows)
    srec = series_path(ct, left, mv)
    routes["series_w4"] = srec["kernel_counts"]
    emit(srec)
    scan_orc = oracle(left, right, mv)
    srec = scan_join_path(ct, left, right, scan_orc)
    srec["beside_monolithic_w4"] = w4["dist_path"]
    routes["scan_join_w4"] = srec["kernel_counts"]
    scan_k1 = srec.pop("k1_first_batch")
    emit(srec)
    emit(scan_k1)
    del srec
    torch.cuda.empty_cache()
    # -- the spilled pipelined route on the same tables, W = 4 ------------
    srec = spill_path(ct, left, right, scan_orc)
    routes["spill_path_w4"] = srec["kernel_counts"]
    w4["k1_spilled_piece"] = srec.pop("k1_spilled_piece")
    w4["k2_spilled"] = srec.pop("k2_spilled")
    emit(srec)
    emit(w4["k1_spilled_piece"])
    emit(w4["k2_spilled"])
    del srec
    torch.cuda.empty_cache()
    # -- durable checkpoints on the same tables: kill, resume, preempt,
    # re-shard (W = 4), then the small scenarios ---------------------------
    with ckpt_root(args.ckpt_dir) as root:
        for crec in ckpt_phases(ct, left, right, scan_orc, root,
                                small_rows=SMALL_ROWS):
            if crec["phase"] == "ckpt_path":
                routes["ckpt_path_w4"] = crec["kernel_counts"]
            elif crec["phase"] == "procs_ckpt":
                routes["procs_ckpt"] = crec["kernel_counts"]
            elif crec["phase"] in ("k1", "k2"):
                w4[f"{crec['phase']}_ckpt_resume"] = crec
            emit(crec)
    del left, right, scan_orc
    torch.cuda.empty_cache()
    # correctness only: skew_small and tpch_small in a child process,
    # and the chaos soak in another, beside breadth_small and
    # recovery_small
    soak = soak_start()
    try:
        side = side_start({"phases": ["skew_small", "tpch_small"],
                           "scale": min(TPCH_SMALL_SCALE, args.tpch_scale)})
        try:
            emit(local_rank_check(ct))
            for brec in breadth_small(ct, SMALL_WORLDS, SMALL_ROWS):
                no_kernels(brec, f"breadth_small W={brec['world']}")
                emit({"phase": "breadth_small", "oracle": "equal", **brec})
            for rrec in recovery_small(ct, SMALL_WORLDS, SMALL_ROWS):
                emit(rrec)
        finally:
            side_recs = side_finish(side)
    finally:
        # waits for (and, failing, kills) the soak and its children
        soak_rec = soak_finish(soak)
    for side_rec in side_recs:
        emit(side_rec)
    emit(soak_rec)
    routes["chaos_soak"] = {
        name: {"launches": soak_rec["kernel_launches"].get(name, 0)}
        for name in ("windowed_gather", "splitter_probe")}

    # -- the adaptive skew split and TPC-H: BASELINE configurations 5
    # (W = 4) and 4 (W = 8) --------------------------------------------------
    srec = skew_path(ct, args.skew_rows)
    routes["skew_path_w4"] = srec["kernel_counts"]
    emit(srec)
    del srec
    torch.cuda.empty_cache()
    # TPC-H at W = 8 with the serving tier on its tables, then serve_small
    # with stream_small beside it
    k2_serve: dict = {}
    for srec in serve_phases(ct, args, routes, k2_serve, tpch_tables):
        routes[f"stream_small_w{srec['world']}"] = srec["kernel_counts"]
        emit(srec)
    for k2rec in k2_serve.values():
        emit(k2rec)
    # -- streaming: the bench's stream at W = 4, then at 1M rows --------
    with ckpt_root(args.ckpt_dir) as root:
        launched = procs_stream_launch(root)
        try:
            srec = stream_path(ct)
            want = srec.pop("_digests")
            routes["stream_path_w4"] = srec["kernel_counts"]
            emit(srec)
            # the same stream as 2 processes x 2 ranks, its children
            # started beside stream_path
            prec = procs_stream(want, launched)
        finally:
            _procs_kill(launched["procs"])
        del want
        routes["procs_stream"] = prec["kernel_counts"]
        emit(prec)
    del srec
    torch.cuda.empty_cache()
    # -- a real device OOM, recovered by the retry ladder ----------------
    orec = oom_path(ct, args.oom_rows)
    routes["oom_path_w1"] = orec["kernel_counts"]
    emit(orec)
    del orec
    emit(exchange_gather_forms(dev))
    emit({"kernels": [{
        "name": "windowed_gather", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": counts["launches"]
        + sum(routes[r]["windowed_gather"]["launches"] for r in (
            "scan_join_w4", "spill_path_w4", "ckpt_path_w4", "obs_path_w4",
            "serve_path_w8", "serve_path_preempt_w8", "stream_serve_w8",
            "stream_path_w4", "procs_gloo_p0", "procs_gloo_p1",
            "procs_nccl_p0", "topo_virtual_w4", "procs_topo_p0",
            "procs_topo_p1", "procs_topo_p2", "procs_topo_p3",
            "procs_ckpt", "integrity_path_w4", "analysis_path_w4",
            "chaos_soak")),
        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        "sector_bytes": rec["sector_bytes"],
        "sector_floor_ms": rec["sector_floor_ms"],
        "redispatches": counts["redispatches"],
        "launches_by_route": {k: v["windowed_gather"] if "windowed_gather"
                              in v else v for k, v in routes.items()},
        "pipelined_launches": pipe_counts["windowed_gather"]["launches"],
        "pipelined_redispatches":
            pipe_counts["windowed_gather"]["redispatches"],
        "pipelined_piece": None if piece is None else {
            key: piece[key] for key in K1_KEYS},
        "w4": {route: {key: w4[check][key] for key in K1_KEYS}
               if check in w4 else None for route, check in (
                   ("monolithic_shard0", "k1_monolithic"),
                   ("pipelined_shard0_piece0", "k1_pipelined_piece"),
                   ("spilled_shard0_piece0", "k1_spilled_piece"),
                   ("ckpt_resume_shard0_first_recomputed_piece",
                    "k1_ckpt_resume"))},
        "scan_join_first_batch_shard0": {key: scan_k1[key]
                                         for key in K1_KEYS}}, {
        "name": "splitter_probe", "route": "cuda", "source": K2_SOURCE,
        "replaces": K2_REPLACES,
        "launches": pipe_counts["splitter_probe"]["launches"]
        + sum(routes[r]["splitter_probe"]["launches"] for r in (
            "spill_path_w4", "ckpt_path_w4", "obs_path_w4",
            "serve_path_w8", "serve_path_preempt_w8", "stream_serve_w8",
            "stream_path_w4", "procs_gloo_p0", "procs_gloo_p1",
            "procs_nccl_p0", "procs_topo_p0", "procs_topo_p1",
            "procs_topo_p2", "procs_topo_p3", "procs_ckpt",
            "procs_serve", "integrity_path_w4", "analysis_path_w4",
            "chaos_soak")),
        "max_abs_err": rec2["max_abs_err"], "ms": rec2["ms"],
        "kernel_ms": rec2["kernel_ms"], "scalar_ms": rec2["scalar_ms"],
        "general_ms": rec2["general_ms"],
        "plain_ms": rec2["plain_ms"], "bound_ms": rec2["bound_ms"],
        "bound_by": rec2["bound_by"], "library_ms": rec2["library_ms"],
        "launches_by_route": {k: v["splitter_probe"] for k, v in
                              routes.items() if "splitter_probe" in v},
        "general_path": general,
        "w4": {"pipelined_shard0": {key: w4["k2_pipelined"][key]
                                    for key in K2_KEYS},
               "outer_pipelined_shard0": {
                   key: w4["k2_outer_pipelined"][key] for key in K2_KEYS},
               "spilled_shard0": {key: w4["k2_spilled"][key]
                                  for key in K2_KEYS},
               "ckpt_resume_shard0": {key: w4["k2_ckpt_resume"][key]
                                      for key in K2_KEYS}},
        "w8": {f"serve_{leg}_shard0": {key: k2rec[key] for key in K2_KEYS
                                       if key in k2rec}
               for leg, k2rec in k2_serve.items()}}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
