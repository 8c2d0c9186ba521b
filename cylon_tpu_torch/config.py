"""Configuration for cylon_tpu_torch: the subset of ``cylon_tpu/config.py``
that the joins, the groupby paths, the sample sort and the
range-partitioned pipeline read, under ``CYLON_TPU_TORCH_*`` environment
names.

PyTorch holds int64/float64 natively, so there is no x64 switch: device
columns always keep their 64-bit types.  The reference's
``DONATE_BUFFERS`` and ``PREWARM_PIECE_PROGRAMS`` have no counterpart: they
steer XLA buffer donation and AOT compilation, while here dropping the last
reference (``del``) returns a block to the caching allocator and nothing
is compiled ahead.  The reference's ``PACKED_PIECES``, ``PACKED_OVERLAP``
and ``PALLAS_PROBE`` switches select second paths of the pipelined join
(materialized pieces, a pull per setup phase, XLA instead of the probe
kernel); the port keeps one path each — packed pieces, one batched pull,
the splitter-probe kernel on the card — and so has no switch for them.
The memory ledger's budget, the spill tiers and the exchange's receive
guard and watchdog (exec/memory.py, exec/recovery.py) take the
reference's knobs under the port's names, at the reference's defaults;
the fault-injection spec is ``CYLON_TPU_TORCH_FAULTS``, read by
exec/recovery.py.
"""

from __future__ import annotations

import os


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v not in ("0", "false", "False", "")


#: Shape-family canonicalization at ingest: a world-1 table's capacity is
#: padded to its ``pow2ceil`` bucket with a masked tail, exactly as the
#: reference does (``cylon_tpu/exec/compiler.family_cap``), so both
#: packages hold the same capacities and padding.  ``=0`` keeps the exact
#: row count.
SHAPE_FAMILIES = _env_flag("CYLON_TPU_TORCH_SHAPE_FAMILIES", True)

#: Defer inner-join output materialization so a same-key groupby can
#: consume the pre-expansion sorted state (relational/fused.py); any other
#: access materializes transparently.
DEFER_JOIN = _env_flag("CYLON_TPU_TORCH_DEFER_JOIN", True)

#: Route large dense grouped-reduce gathers through the windowed-gather
#: CUDA kernel (ops/windowed_gather.py) on the card; span overflows
#: redispatch the plain gather.
WINDOWED_GATHER = _env_flag("CYLON_TPU_TORCH_WINDOWED_GATHER", True)


#: A join side at or below this row count is REPLICATED to every shard
#: (``parallel/collectives.allgather_table``) instead of hash-shuffling
#: both sides: the broadcast-hash-join cutover (relational/join.py).
BROADCAST_JOIN_ROWS = int(os.environ.get(
    "CYLON_TPU_TORCH_BROADCAST_JOIN_ROWS", "65536"))

# Heavy-key detection for the semi/anti spread (relational/join.py), the
# reference's values: detection runs on the row hash of the key tuple, so
# multi-column and float keys take part alike, and the predicate is the
# routing hash.
#: Rows sampled per shard for the heavy-hitter estimate:
SKEW_SAMPLE = 4096
#: Minimum per-shard sampled share for a key to enter the estimate:
SKEW_MIN_SHARE = 0.01
#: A key is heavy when its weighted global share exceeds FACTOR / world
#: (1.0 = one full shard's worth of rows):
SKEW_GLOBAL_FACTOR = 1.0
#: At most this many heavy keys spread per join:
SKEW_MAX_KEYS = 8
#: Replication guard: no spread when the build side's heavy rows,
#: replicated world-ways, would exceed GUARD_RATIO x the build size AND
#: GUARD_ROWS rows.
SKEW_GUARD_RATIO = 2.0
SKEW_GUARD_ROWS = 65536

# The adaptive skew-split join (relational/skew.py): heavy probe keys
# found by the weighted Misra-Gries sketch (obs/sketch.py) split over a
# contiguous rank group, their build rows replicate to that group, and
# the output stitches back bit- and order-equal to the unsplit hash plan.
#: Master switch (default armed; ``0`` is the unsplit hash plan for
#: inner/left/right/outer — semi/anti keep the round-robin spread):
SKEW_SPLIT = _env_flag("CYLON_TPU_TORCH_SKEW_SPLIT", True)
#: A key must also hold at least this share of the probe side before it
#: splits (1/W alone is too eager at large worlds for the stitch's pass):
SKEW_SPLIT_SHARE = float(os.environ.get("CYLON_TPU_TORCH_SKEW_SPLIT_SHARE",
                                        "0.05"))
#: A key of estimated share s splits over ceil(s * W * FACTOR) ranks,
#: clamped to [2, W] and to its exact row count:
SKEW_FANOUT_FACTOR = float(os.environ.get(
    "CYLON_TPU_TORCH_SKEW_FANOUT_FACTOR", "1.25"))


# The topology tier (topo/): on a two-tier fabric (ranks inside a slice
# joined by the device or NVLink, slices joined by the network) the
# exchange goes hierarchical: a slice-local hop that aligns each row on
# its destination's gateway, then one aggregated cross-slice hop, bit-
# and order-equal to the flat route by the slice-major rank numbering.
#: Master switch for the two-hop route (``0``: the flat one-hop exchange
#: on any topology).  A single-slice topology always routes flat.
TOPO_SHUFFLE = _env_flag("CYLON_TPU_TORCH_TOPO_SHUFFLE", True)
#: The slice declaration: ``CYLON_TPU_TORCH_SLICES=<n>`` splits the
#: world's ranks into n contiguous slices (read once and cached by
#: topo/model.declared_slices; a declaration counts only when n divides
#: the world and 2 <= n <= W).  Without one, a multi-process world's
#: processes on one host form a slice.
SLICES_ENV = "CYLON_TPU_TORCH_SLICES"


#: High-cardinality string crossover: a column of at least MIN_ROWS rows
#: whose sampled distinct ratio reaches RATIO takes hashed codes
#: (``core/column.HashedStrings``) instead of a sorted dictionary, whose
#: ``np.unique`` over every value is a host-memory wall at ~1e8 distinct
#: strings.  The reference's defaults; the port is always 64-bit, so the
#: reference's x64 condition has no counterpart.
STRING_HASH_MIN_ROWS = int(os.environ.get("CYLON_TPU_TORCH_STRING_HASH_MIN",
                                          str(4_000_000)))
STRING_HASH_RATIO = float(os.environ.get(
    "CYLON_TPU_TORCH_STRING_HASH_RATIO", "0.5"))


#: Per-shard exchange RECEIVE ceiling in bytes (on the card only): a
#: receive predicted from the count sidecar above it raises
#: ``PredictedResourceExhausted`` before anything is allocated
#: (parallel/shuffle.py), and the ladder streams instead.
EXCHANGE_RECV_BUDGET_BYTES = int(os.environ.get(
    "CYLON_TPU_TORCH_EXCHANGE_RECV_BUDGET", str(12 * 1024**3)))

#: Device budget of the resident-allocation ledger (exec/memory.py), in
#: bytes.  0 (default): one card's total memory — every rank of a
#: VirtualMeshConfig world lives on that card — and no limit on the CPU.
#: Set it below the resident working set to force the host spill tier.
HBM_BUDGET_BYTES = int(os.environ.get("CYLON_TPU_TORCH_HBM_BUDGET", "0"))

#: Host spill tier switch (``0`` disables eviction; the ledger keeps
#: accounting).
SPILL_ENABLED = _env_flag("CYLON_TPU_TORCH_SPILL", True)

#: Host budget of the disk tier: bytes of host-resident spill pages before
#: the coldest demote to spill files (0 = unlimited, disk tier off — no
#: filesystem writes at all).
HOST_BUDGET_BYTES = int(os.environ.get("CYLON_TPU_TORCH_HOST_BUDGET", "0"))

#: Root directory of the disk tier's spill pages (``<dir>/rank0/<owner>
#: .a<j>.s<k>.spill.npy``); empty: a private temporary directory made at
#: the first demotion.  Spill pages live as long as the process.
SPILL_DIR = os.environ.get("CYLON_TPU_TORCH_SPILL_DIR", "")

#: Exchange watchdog deadline in seconds (0 = off): blocking transfers
#: and host pulls that do not finish in time raise ``RankDesyncError``
#: (exec/recovery.exchange_watchdog) instead of blocking forever.
EXCHANGE_WATCHDOG_S = float(os.environ.get("CYLON_TPU_TORCH_WATCHDOG_S",
                                           "0"))


#: Distributed-sort splitter samples per shard (``0``: scale with the
#: world size, :func:`sort_samples`).
SORT_SAMPLES_PER_SHARD = int(os.environ.get("CYLON_TPU_TORCH_SORT_SAMPLES",
                                            "0"))


def sort_samples(world: int) -> int:
    """Splitter samples per shard: the explicit override, else 16 per rank
    and at least 64, as the reference samples."""
    if SORT_SAMPLES_PER_SHARD > 0:
        return SORT_SAMPLES_PER_SHARD
    return max(64, 16 * world)


#: [None = unread, else the cached bool] of ``CYLON_TPU_TORCH_AUDIT``
_AUDIT: list = [None]


def audit_armed() -> bool:
    """``CYLON_TPU_TORCH_AUDIT=1`` arms the audit: the integrity tier's
    fingerprints (exec/integrity.py) and the int64 saturation guard on
    groupby results (ops/groupby.guard_saturation).  The environment is
    read once and cached, so the unarmed path costs one list load;
    :func:`rearm_audit` reads it again (tests, and a process that arms
    the audit between legs)."""
    a = _AUDIT[0]
    if a is None:
        a = _AUDIT[0] = os.environ.get("CYLON_TPU_TORCH_AUDIT",
                                       "") not in ("", "0")
    return a


def rearm_audit() -> None:
    """Read ``CYLON_TPU_TORCH_AUDIT`` again at the next check."""
    _AUDIT[0] = None


#: The compile tier's persistent directory (exec/compiler.py): kernel
#: libraries build into ``<dir>/kernels`` beside a sha256 manifest, a
#: quarantine ledger and a compile intent journal.  Empty: the kernels
#: build into ``cylon_tpu_torch/kernels/_build`` and the facade writes
#: nothing.
COMPILE_CACHE_DIR = os.environ.get("CYLON_TPU_TORCH_COMPILE_CACHE_DIR", "")

#: Seconds an ``nvcc`` build may run before the compile watchdog kills it
#: and raises ``CompileTimeoutError`` (0 = no watchdog).
COMPILE_TIMEOUT_S = float(os.environ.get(
    "CYLON_TPU_TORCH_COMPILE_TIMEOUT_S", "0"))


def pow2ceil(n: int) -> int:
    """Bucket a dynamic capacity to the next 2^(b-5) step for n in
    (2^(b-1), 2^b] (exact powers of two up to 16Ki): 16 steps per octave,
    worst-case overshoot 6.25%.  Same buckets as the reference, so both
    packages pick identical capacities."""
    n = max(int(n), 1)
    if n <= 16384:
        return 1 << (n - 1).bit_length()
    step = 1 << ((n - 1).bit_length() - 5)
    return -(-n // step) * step


def family_cap(n: int) -> int:
    """The canonical row capacity of a world-1 ingest of ``n`` rows: its
    ``pow2ceil`` bucket while shape families are on, else ``n``."""
    n = int(n)
    if n <= 0 or not SHAPE_FAMILIES:
        return max(n, 0)
    return pow2ceil(n)
