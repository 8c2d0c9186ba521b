"""Durable checkpoints and resume: the recovery ladder's persistence rung
(port of ``cylon_tpu/exec/checkpoint.py``).

The retry ladder and the spill tiers (exec/recovery.py, exec/memory.py)
survive faults inside one process.  A fault that ends the process — a
SIGKILL, a spot VM's preemption, a device OOM after which the CUDA
context cannot be trusted — needs a fresh process, and without this
module that meant recomputing every completed piece.  This module adds
the durable rung:

1. **Per-rank stage directories** (``CYLON_TPU_TORCH_CKPT_DIR``): each
   pipelined stage (one ``pipelined_join`` call; stage ids follow call
   order, so a fresh process replaying the workload meets the same ids)
   owns ``<dir>/rank<r>/stage<k>-<label>/``.  Completed-piece state — a
   sinkless loop's piece outputs, or a ``GroupBySink``'s per-piece
   partial aggregates — leaves the device through the spill tier's pull
   (``utils/host.host_shard_blocks``, which waits for the copy before any
   byte is hashed) and comes back through :func:`~cylon_tpu_torch.exec.
   memory.put_blocks`, so a restored piece is byte-identical to the
   tensor it was pulled from.  Every page (one ``.npz`` per array, its W
   shard blocks) carries a sha256; the piece's pickled meta sidecar is
   hashed into the manifest entry.

2. **Two-phase manifest commit**: after a piece's pages land, the updated
   manifest is staged (``MANIFEST.json.staged``, fsynced), the ranks vote
   ``Code.CkptCommit`` with their staged epoch
   (``recovery.ckpt_commit_consensus``) and only then is the staged file
   renamed over ``MANIFEST.json``.  A crash between stage and rename
   leaves only the staged file, which resume ignores.

3. **Resume** (``CYLON_TPU_TORCH_RESUME=1``): a fresh process reaching a
   stage with the same plan token (a hash of its static plan) restores
   the committed pieces and the range loop fast-forwards past them
   (``resume_fast_forwarded_pieces``).  A corrupt page raises
   :class:`~cylon_tpu_torch.status.CheckpointCorruptError` and the stage
   recomputes its remaining pieces: corruption degrades to recompute,
   never to a wrong answer.

4. **The final ladder rung** (exec/recovery.py): an unrecoverable
   ``DeviceOOMError`` with checkpoints armed flushes
   (:func:`flush_for_abort`) and becomes a
   :class:`~cylon_tpu_torch.status.ResumableAbort` carrying the token.

5. **Elastic resume and preemption grace**: a stage carries a
   world-invariant BASE token beside its full layout token.  A resume at
   another world size re-shards a complete stage: every old rank dir's
   pages are verified, the shards' live rows stitched into global row
   order and re-blocked with ``relational/repart.even_partition_counts``
   onto the live world, then re-committed in the new layout
   (:meth:`Stage.load_foreign_pieces`, :meth:`Stage.begin_rewrite`).
   With ``CYLON_TPU_TORCH_PREEMPT_GRACE_S`` set, a SIGTERM drains at the
   next piece boundary (:func:`drain_requested`, :func:`drain_abort`,
   exec/preempt.py) as a ``ResumableAbort``.

Unarmed (``CYLON_TPU_TORCH_CKPT_DIR`` unset) every entry point is an env
read: no stage opens, no file is written, no timing region is entered.

Injector sites ``ckpt.write``, ``ckpt.load`` and ``ckpt.reshard``: kind
``corrupt`` flips a page byte after hashing (write) or fails the check
(load, reshard); ``kill`` SIGKILLs the process at the site and ``term``
sends it SIGTERM (the preemption notice).

Serving sessions (exec/scheduler.py): each session has its own stage
sequence and its stage directories carry its name
(``stage000-t0.pipelined_join``), so tenants' checkpoints never collide
and a relaunch matches each tenant's stages however the interleave
ordered them; a requeued session resumes in process
(``_resume_pending``), and a session the scheduler flagged for a
preemption or a fleet resize drains at its next boundary
(:func:`drain_requested`; injector site ``sched.preempt``).

Single-controller: one process drives every rank of a
``VirtualMeshConfig`` world, so it is rank 0 of one process and writes
every shard's blocks into ``rank0``.  The fingerprint audit of restored
tables (slice 16) is not ported.  The six counters live in the
metrics registry (``ckpt_*``, obs/metrics.py), and the abort flush
writes the flight recorder's post-mortem beside the manifests when the
recorder is armed.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import re
import time

import numpy as np
import torch

from ..status import CheckpointCorruptError, InvalidError, ResumableAbort
from ..utils import timing


# ---------------------------------------------------------------------------
# switches (read on every call: tests flip the env)
# ---------------------------------------------------------------------------

def ckpt_dir() -> str | None:
    """The checkpoint root (``CYLON_TPU_TORCH_CKPT_DIR``), or None:
    disabled."""
    return os.environ.get("CYLON_TPU_TORCH_CKPT_DIR") or None


def enabled() -> bool:
    return ckpt_dir() is not None


def resume_requested() -> bool:
    """``CYLON_TPU_TORCH_RESUME=1``: committed pieces of matching stages
    are restored instead of recomputed.  A serving session the scheduler
    preempted and requeued resumes the same way in process: its
    ``_resume_pending`` flag arms the resume for its own runs only, the
    process-wide switch untouched for its co-tenants."""
    if os.environ.get("CYLON_TPU_TORCH_RESUME") == "1":
        return True
    from .scheduler import current_session
    sess = current_session()
    return bool(sess is not None
                and getattr(sess, "_resume_pending", False))


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

# the counters live in the metrics registry (obs/metrics, names
# ``ckpt_*``): the group view keeps the `_STATS[k] += 1` sites as they are
from ..obs import metrics as _metrics  # noqa: E402

_STATS = _metrics.group("ckpt", (
    "checkpoint_events", "bytes_checkpointed",
    "resume_fast_forwarded_pieces", "corrupt_pages",
    "resume_resharded_pieces", "resume_world_mismatch"))


def stats() -> dict:
    """``checkpoint_events`` (committed piece checkpoints),
    ``bytes_checkpointed`` (page and meta bytes written),
    ``resume_fast_forwarded_pieces`` (pieces restored instead of
    recomputed), ``corrupt_pages`` (failed page checks),
    ``resume_resharded_pieces`` (pieces adopted across a world change,
    also counted as fast-forwarded) and ``resume_world_mismatch`` (stages
    whose checkpoint came from another world)."""
    return dict(_STATS)


def reset_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


def unrestore(k: int) -> None:
    """Back ``k`` discarded restores out of the fast-forward counter (the
    resume vote agreed on a shorter prefix than this rank restored).
    Backing out more than was counted is a consensus bug: the counter
    clamps at zero and :class:`InvalidError` is raised."""
    k = int(k)
    if k < 0:
        raise InvalidError(f"unrestore({k}): negative back-out")
    have = _STATS["resume_fast_forwarded_pieces"]
    if k > have:
        _STATS["resume_fast_forwarded_pieces"] = 0
        raise InvalidError(
            f"unrestore({k}) exceeds the {have} restores counted — the "
            "resume consensus agreed on more discards than this rank "
            "ever restored (counter clamped at zero)")
    _STATS["resume_fast_forwarded_pieces"] = have - k


def note_reshard(k: int) -> None:
    """Count ``k`` pieces adopted across a world change: fast-forwarded
    and re-sharded both."""
    k = int(k)
    _STATS["resume_fast_forwarded_pieces"] += k
    _STATS["resume_resharded_pieces"] += k
    for _ in range(k):
        timing.bump("ckpt.piece_resharded")


# ---------------------------------------------------------------------------
# stage identity
# ---------------------------------------------------------------------------

#: the next stage id per serving session (key None outside a scheduler):
#: each session's stages replay in the same order in a fresh process, so
#: (session, counter) identifies a stage however concurrent sessions
#: interleaved; the plan token guards against the workload having
#: changed
_STAGE_SEQ: dict = {}

#: stage directories opened by this process (for the resume-token file)
_OPEN_DIRS: list[str] = []


def reset_stages() -> None:
    """Restart the stage sequence (a test replaying a workload in one
    process to take the resume path)."""
    _STAGE_SEQ.clear()
    _OPEN_DIRS.clear()


def reset_session_stages(sid: str) -> None:
    """Restart one serving session's stage sequence: a requeued session
    replays its workload from the top, so its stages must start again at
    0 to meet their committed directories."""
    _STAGE_SEQ.pop(sid, None)


def plan_token(*parts) -> str:
    """Deterministic token over a stage's static plan (plain python ints,
    strs and tuples): the reference's, so both packages give one plan the
    same token.  A stage carries a world-invariant BASE token (operator,
    keys, chunk count, consumption mode, global row totals) and the full
    LAYOUT token folding in the world size, piece capacities and
    per-range counts.  A full match fast-forwards; a base-only match at
    another world takes the re-shard path; no match starts over."""
    return hashlib.sha1(repr(parts).encode()).hexdigest()[:16]


def _rank() -> int:
    return 0


def _procs() -> int:
    return 1


_RANK_DIR_RE = re.compile(r"rank(\d+)$")


def _rank_dirs() -> list[str]:
    """``rank<r>`` directory names under the checkpoint root, by rank."""
    try:
        names = os.listdir(ckpt_dir())
    except OSError:
        return []
    ranked = [(int(m.group(1)), n) for n in names
              if (m := _RANK_DIR_RE.fullmatch(n))]
    return [n for _, n in sorted(ranked)]


# ---------------------------------------------------------------------------
# pages
# ---------------------------------------------------------------------------

def _sha(raw) -> str:
    return hashlib.sha256(raw).hexdigest()


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _pull_blocks(arr: torch.Tensor, w: int) -> list:
    """One array's W shard blocks as host numpy arrays.  An unsigned
    tensor moves through its signed view (torch's CUDA copies of uint
    dtypes are not all there) and is viewed back on the host."""
    from ..ops.pack import SIGNED_VIEW
    from ..utils.host import host_shard_blocks
    sv = SIGNED_VIEW.get(arr.dtype)
    blocks = host_shard_blocks(arr if sv is None else arr.view(sv), w)
    want = _np_dtype(arr.dtype)
    return [b.numpy().view(want) for b in blocks]


def _push_blocks(blocks: list, device) -> torch.Tensor:
    """W host blocks -> one device tensor (:func:`memory.put_blocks`),
    unsigned dtypes through their signed view."""
    from ..ops.pack import SIGNED_VIEW
    from . import memory
    dt = torch.from_numpy(np.empty(0, blocks[0].dtype)).dtype
    sv = SIGNED_VIEW.get(dt)
    if sv is None:
        return memory.put_blocks(blocks, device)
    signed = _np_dtype(sv)
    return memory.put_blocks([b.view(signed) for b in blocks],
                             device).view(dt)


def _page_bytes(blocks: list) -> memoryview:
    """One array's per-shard host blocks -> one page (npz)."""
    buf = io.BytesIO()
    arrs = {f"b{k}": b for k, b in enumerate(blocks) if b is not None}
    np.savez(buf, w=np.asarray(len(blocks), np.int64), **arrs)
    return buf.getbuffer()


def _page_blocks(raw: bytes) -> list:
    with np.load(io.BytesIO(raw)) as z:
        blocks: list = [None] * int(z["w"])
        for key in z.files:
            if key != "w":
                blocks[int(key[1:])] = z[key]
    return blocks


class Stage:
    """One pipelined stage's durable state: piece pages and hashed meta
    sidecars under the rank's stage directory, committed under the
    two-phase manifest.  Made by :func:`open_stage`."""

    def __init__(self, env, label: str, token: str, seq: int,
                 base_token: str | None = None):
        self.env = env
        self.label = label
        self.token = token
        self.base = base_token
        self._dirname = f"stage{seq:03d}-{label}"
        self.dir = os.path.join(ckpt_dir(), f"rank{_rank()}", self._dirname)
        os.makedirs(self.dir, exist_ok=True)
        self.epoch = 0
        #: manifest generation: above anything already on disk, bumped
        #: again by a re-shard rewrite (the scan keeps the highest)
        self.gen = 0
        self.complete_flag = False
        self.committed: dict[int, dict] = {}
        self.resuming = False
        #: a checkpoint of this stage from another world: {"world",
        #: "procs", "gen", "complete", "pieces", "manifests"}
        self.foreign: dict | None = None
        if resume_requested():
            self._resolve_resume()
        else:
            # a fresh run supersedes whatever earlier runs left here: a
            # fresh run starting again at generation 0 would be outranked
            # at the next resume by an earlier re-shard rewrite's gen 1
            mans = self._scan_manifests()
            if mans:
                self.gen = max(int(m.get("gen", 0))
                               for m in mans.values()) + 1

    # -- manifest ----------------------------------------------------------
    @property
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "MANIFEST.json")

    def _read_manifest(self, rank_dirname: str | None = None) -> dict | None:
        path = self._manifest_path if rank_dirname is None else os.path.join(
            ckpt_dir(), rank_dirname, self._dirname, "MANIFEST.json")
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _scan_manifests(self) -> dict:
        """Every rank dir's manifest of this stage (rank dirname ->
        manifest)."""
        mans: dict = {}
        for rd in _rank_dirs():
            man = self._read_manifest(rd)
            if man is not None:
                mans[rd] = man
        return mans

    def _resolve_resume(self) -> None:
        """Decide what this stage can restore from the highest generation
        whose manifests agree (same plan, world and process count):

        * its plan is this stage's full token at this world: a plain
          fast-forward (``resuming``);
        * only the BASE token matches, from another world: the re-shard
          path (``foreign``; counted in ``resume_world_mismatch`` with a
          recovery event);
        * anything else: stale, the stage starts over (logged)."""
        from ..utils.logging import log
        mans = self._scan_manifests()
        if not mans:
            return
        top_gen = max(int(m.get("gen", 0)) for m in mans.values())
        cur = {rd: m for rd, m in mans.items()
               if int(m.get("gen", 0)) == top_gen}
        plans = {m.get("plan") for m in cur.values()}
        worlds = {int(m.get("world", 0)) for m in cur.values()}
        procs = {int(m.get("procs", 1)) for m in cur.values()}
        if len(plans) != 1 or len(worlds) != 1 or len(procs) != 1:
            log.warning("checkpoint stage %s: rank manifests disagree at "
                        "generation %d (plans %s, worlds %s, procs %s) — "
                        "torn checkpoint ignored, stage starts over",
                        self._dirname, top_gen, plans, worlds, procs)
            self.gen = top_gen + 1
            return
        plan, world = plans.pop(), worlds.pop()
        same_topo = (world == int(self.env.world_size)
                     and procs == {_procs()})
        if plan == self.token and same_topo:
            # adopt the current generation even without an own manifest:
            # committing below it would hand the next resume stale data
            self.gen = top_gen
            own = cur.get(f"rank{_rank()}")
            if own is None:
                return
            self.committed = {int(k): v
                              for k, v in own.get("pieces", {}).items()}
            self.epoch = int(own.get("epoch", 0))
            self.gen = int(own.get("gen", 0))
            self.complete_flag = bool(own.get("complete", False))
            self.resuming = bool(self.committed)
            return
        base = {m.get("base") for m in cur.values()}
        if (self.base is not None and base == {self.base}
                and not same_topo):
            # every rank dir must hold a piece for it to be adoptable;
            # the contiguous common prefix is the restorable unit
            common = set.intersection(*[
                {int(k) for k in m.get("pieces", {})} for m in cur.values()])
            n = 0
            while n in common:
                n += 1
            # whole-stage adoption needs the prefix to cover the piece
            # count recorded at completion on every rank: the flag alone
            # would let a truncated piece table pass for the whole stage
            want = {int(m.get("n_pieces", -1)) for m in cur.values()}
            complete = (all(bool(m.get("complete", False))
                            for m in cur.values())
                        and len(want) == 1 and n == want.pop())
            self.foreign = {"world": world, "procs": procs.pop(),
                            "gen": top_gen, "complete": complete,
                            "pieces": n, "manifests": cur}
            # whatever this run commits supersedes the foreign generation
            self.gen = top_gen + 1
            _STATS["resume_world_mismatch"] += 1
            from . import recovery
            recovery._record("ckpt.reshard", "world_mismatch", "detected")
            log.warning(
                "checkpoint stage %s: committed at world=%d (%d rank "
                "dirs), resuming at world=%d — %s", self._dirname,
                world, len(cur), int(self.env.world_size),
                "re-shard path engaged (complete stage, %d pieces)" % n
                if complete else
                "stage incomplete at the old world: a pipelined join "
                "recomputes (old-layout pieces cannot splice into a "
                "new-layout loop)")
            return
        log.warning(
            "checkpoint stage %s: plan token mismatch (manifest %s, "
            "workload %s) — stale checkpoint ignored, stage starts "
            "over", self.dir, plan, self.token)
        self.gen = top_gen + 1

    def _commit(self) -> None:
        """Two-phase manifest commit: stage (atomic rank-local write and
        fsync), vote ``Code.CkptCommit`` with the staged epoch, then
        rename the staged file over ``MANIFEST.json``."""
        from . import recovery
        self.epoch += 1
        man = {"plan": self.token, "base": self.base, "label": self.label,
               "epoch": self.epoch, "gen": self.gen,
               "complete": self.complete_flag,
               "n_pieces": len(self.committed),
               "world": int(self.env.world_size), "procs": _procs(),
               "pieces": {str(k): v for k, v in self.committed.items()}}
        staged = self._manifest_path + ".staged"

        def stage_write():
            with open(staged, "w", encoding="utf-8") as f:
                json.dump(man, f)
                f.flush()
                os.fsync(f.fileno())

        with timing.region("ckpt.commit"):
            recovery.retry_io(stage_write, "ckpt.write")
            # stage -> vote -> publish
            recovery.ckpt_commit_consensus(self.env, self.epoch)
            recovery.retry_io(
                lambda: os.replace(staged, self._manifest_path),
                "ckpt.write")

    def has_piece(self, i: int) -> bool:
        return int(i) in self.committed

    @property
    def foreign_complete(self) -> bool:
        """True when the other world's checkpoint covers the WHOLE stage:
        only a whole stage re-shards into a pipelined join (a prefix of
        old-layout pieces has no complement in the new layout)."""
        return (self.foreign is not None and self.foreign["complete"]
                and self.foreign["pieces"] > 0)

    def mark_complete(self) -> None:
        """Record that the stage finished every piece (one more commit),
        so a later resume at another world may adopt it whole."""
        if self.complete_flag:
            return
        self.complete_flag = True
        self._commit()

    def begin_rewrite(self) -> None:
        """Start the post-reshard rewrite: the adopted state re-commits
        under this world's layout token at the next generation, so a
        second resume at this world is a plain fast-forward and the old
        world's rank dirs read as stale."""
        self.gen = int(self.foreign["gen"]) + 1
        self.committed = {}
        self.epoch = 0
        self.resuming = False
        self.complete_flag = False

    # -- save --------------------------------------------------------------
    def save_piece(self, i: int, table) -> None:
        """Checkpoint one completed piece's Table: a page per array and a
        hashed meta sidecar, committed under the two-phase manifest.  The
        piece is durable once :meth:`_commit` returns; a kill before that
        leaves files the manifest does not name."""
        from . import recovery
        corrupt = recovery.maybe_inject(
            "ckpt.write", intercept=("corrupt",)) == "corrupt"
        i = int(i)
        with timing.region("ckpt.write"):
            nbytes, meta_sha, meta_file = self._write_pages(i, table,
                                                            corrupt)
            self.committed[i] = {"meta": meta_file, "sha": meta_sha,
                                 "nbytes": nbytes, "fp": None}
            self._commit()
        _STATS["checkpoint_events"] += 1
        _STATS["bytes_checkpointed"] += nbytes
        timing.add_bytes("ckpt.write", nbytes)
        timing.bump("ckpt.piece_committed")
        # a serving session's durable progress: the scheduler's
        # no-progress guard and the fleet's commit gate read it
        from .scheduler import current_session
        sess = current_session()
        if sess is not None:
            sess.pieces_committed += 1

    def _write_pages(self, i: int, table, corrupt: bool):
        w = int(self.env.world_size)
        cols, flats = [], []
        for name, c in table.columns.items():
            cols.append({"name": name, "type": c.type,
                         "dictionary": c.dictionary, "bounds": c.bounds,
                         "has_validity": c.validity is not None})
            flats.append(c.data)
            if c.validity is not None:
                flats.append(c.validity)
        pages, total = [], 0
        for j, arr in enumerate(flats):
            with timing.region("ckpt.d2h"):
                blocks = _pull_blocks(arr, w)
            with timing.region("ckpt.encode"):
                raw = _page_bytes(blocks)
            del blocks
            fname = f"piece_{i}.p{j}"
            # the hash covers the good bytes; an injected corruption flips
            # one after hashing, so the resume's check catches it
            with timing.region("ckpt.sha"):
                pages.append({"file": fname, "sha": _sha(raw),
                              "nbytes": len(raw)})
            if corrupt and j == 0:
                raw = bytes([raw[0] ^ 0xFF]) + bytes(raw[1:])
            self._atomic_write(fname, raw)
            total += len(raw)
            del raw
        meta = pickle.dumps({
            "cols": cols,
            "valid_counts": np.asarray(table.valid_counts, np.int64),
            "grouped_by": table.grouped_by,
            "pages": pages,
        })
        meta_file = f"piece_{i}.meta"
        self._atomic_write(meta_file, meta)
        return total + len(meta), _sha(meta), meta_file

    def _atomic_write(self, fname: str, raw) -> None:
        path = os.path.join(self.dir, fname)
        tmp = path + ".tmp"

        def write():
            with open(tmp, "wb") as f:
                f.write(raw)
            os.replace(tmp, path)

        from . import recovery
        with timing.region("ckpt.file_write"):
            recovery.retry_io(write, "ckpt.write")

    # -- load (resume fast-forward) ----------------------------------------
    def load_piece(self, i: int):
        """Restore one committed piece bit-identically: the meta sidecar
        checked against the manifest's hash, every page against its meta
        hash, then up through :func:`memory.put_blocks`.  A mismatch (or
        an injected ``corrupt``) raises :class:`CheckpointCorruptError`;
        the caller recomputes the stage's remaining pieces."""
        from . import recovery
        from ..core.column import Column
        from ..core.table import Table
        if recovery.maybe_inject("ckpt.load", intercept=("corrupt",)):
            _STATS["corrupt_pages"] += 1
            raise CheckpointCorruptError(
                "injected checkpoint corruption on load", site="ckpt.load")
        entry = self.committed[int(i)]
        with timing.region("ckpt.load"):
            meta_raw = self._read_verified(entry["meta"], entry["sha"])
            meta = pickle.loads(meta_raw)
            flats = []
            for page in meta["pages"]:
                raw = self._read_verified(page["file"], page["sha"])
                flats.append(_push_blocks(_page_blocks(raw),
                                          self.env.device))
        flats = iter(flats)
        cols = {}
        for cm in meta["cols"]:
            data = next(flats)
            validity = next(flats) if cm["has_validity"] else None
            cols[cm["name"]] = Column(data, cm["type"], validity,
                                      cm["dictionary"], bounds=cm["bounds"])
        out = Table(cols, self.env, meta["valid_counts"])
        out.grouped_by = meta["grouped_by"]
        _STATS["resume_fast_forwarded_pieces"] += 1
        timing.bump("ckpt.piece_restored")
        return out

    # -- elastic re-shard --------------------------------------------------
    def load_foreign_pieces(self) -> list:
        """Adopt another world's committed pieces onto the live world:
        for each piece, every old rank dir's pages are read and verified,
        the per-shard blocks merged across dirs, the shards' live rows
        stitched into global row order and re-blocked with
        ``relational/repart.even_partition_counts`` (a fresh
        ``repartition``'s order-preserving split) before going up
        through :func:`memory.put_blocks`.  Any missing block, unreadable
        file or hash mismatch (or an injected ``corrupt`` at
        ``ckpt.reshard``) raises :class:`CheckpointCorruptError`: the
        caller recomputes.  Returns the Tables in piece order, not yet
        counted (:func:`note_reshard`, after the resume vote) nor
        re-committed (:meth:`begin_rewrite` and :meth:`save_piece`).  The
        reference's ``limit`` and ``prefix_ok`` serve the stream views
        (slice 14)."""
        from . import recovery
        if recovery.maybe_inject("ckpt.reshard",
                                 intercept=("corrupt",)) == "corrupt":
            _STATS["corrupt_pages"] += 1
            raise CheckpointCorruptError(
                "injected checkpoint corruption during re-shard",
                site="ckpt.reshard")
        with timing.region("ckpt.reshard"):
            return [self._load_one_foreign(i)
                    for i in range(self.foreign["pieces"])]

    def _load_one_foreign(self, i: int):
        from .. import config
        from ..core.column import Column
        from ..core.table import Table
        from ..relational.repart import even_partition_counts
        meta = None
        merged: list[list] = []
        for rd, man in self.foreign["manifests"].items():
            entry = man["pieces"][str(i)]
            stage_dir = os.path.join(ckpt_dir(), rd, self._dirname)
            meta_d = pickle.loads(
                self._read_verified(entry["meta"], entry["sha"],
                                    dir=stage_dir))
            if meta is None:
                meta = meta_d
                merged = [[] for _ in meta["pages"]]
            for j, page in enumerate(meta_d["pages"]):
                raw = self._read_verified(page["file"], page["sha"],
                                          dir=stage_dir)
                blocks = _page_blocks(raw)
                if len(merged[j]) < len(blocks):
                    merged[j].extend([None] * (len(blocks) - len(merged[j])))
                for b, blk in enumerate(blocks):
                    if blk is not None:
                        merged[j][b] = blk
        vc_old = np.asarray(meta["valid_counts"], np.int64)
        for j, blocks in enumerate(merged):
            if any(b is None for b in blocks):
                _STATS["corrupt_pages"] += 1
                raise CheckpointCorruptError(
                    f"re-shard of stage {self._dirname} piece {i}: page "
                    f"{j} is missing shard blocks — an old rank "
                    "directory is absent or unreadable (is the "
                    "checkpoint root shared storage?)",
                    site="ckpt.reshard")
        total = int(vc_old.sum())
        w_new = int(self.env.world_size)
        dest = even_partition_counts(total, w_new)
        new_cap = config.pow2ceil(max(int(dest.max(initial=0)), 1))
        dof = np.concatenate([[0], np.cumsum(dest)[:-1]]).astype(np.int64)
        flats = []
        for blocks in merged:
            rows = np.concatenate(
                [blocks[s][:int(vc_old[s])] for s in range(len(blocks))])
            new_blocks = []
            for s in range(w_new):
                part = rows[int(dof[s]):int(dof[s]) + int(dest[s])]
                pad = np.zeros((new_cap - part.shape[0],) + part.shape[1:],
                               part.dtype)
                new_blocks.append(np.concatenate([part, pad]))
            del rows
            flats.append(_push_blocks(new_blocks, self.env.device))
        flats = iter(flats)
        cols = {}
        for cm in meta["cols"]:
            data = next(flats)
            validity = next(flats) if cm["has_validity"] else None
            # the re-block pads with zeros, so bounds must admit 0
            b = cm["bounds"]
            nb = (min(b[0], 0), max(b[1], 0)) if b is not None else None
            cols[cm["name"]] = Column(data, cm["type"], validity,
                                      cm["dictionary"], bounds=nb)
        # per-shard key contiguity does not survive the re-block: the
        # grouped contract is dropped, consumers re-derive it
        return Table(cols, self.env, dest)

    def _read_verified(self, fname: str, want_sha: str,
                       dir: str | None = None) -> bytes:
        path = os.path.join(self.dir if dir is None else dir, fname)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            _STATS["corrupt_pages"] += 1
            raise CheckpointCorruptError(
                f"checkpoint page {path} unreadable: {e}",
                site="ckpt.load") from e
        if _sha(raw) != want_sha:
            _STATS["corrupt_pages"] += 1
            raise CheckpointCorruptError(
                f"checkpoint page {path} failed its content-hash check "
                "(torn write or on-disk corruption)", site="ckpt.load")
        return raw


def open_stage(env, label: str, token: str,
               base_token: str | None = None) -> Stage:
    """The next pipelined stage's checkpoint handle (advances this serving
    session's stage sequence; a session's stage label carries its name).
    ``base_token`` (the world-invariant :func:`plan_token`) makes the
    stage eligible for the re-shard path.  Call only when
    :func:`enabled`."""
    from . import recovery
    sid = recovery.current_session()
    seq = _STAGE_SEQ.get(sid, 0)
    _STAGE_SEQ[sid] = seq + 1
    if sid is not None:
        label = f"{sid}.{label}"
    stage = Stage(env, label, token, seq, base_token=base_token)
    _OPEN_DIRS.append(stage.dir)
    return stage


def corrupt_fallback(stage: Stage, piece: int, err: Exception) -> None:
    """Log and record a recompute after a failed restore (the range loop
    then recomputes the stage's remaining pieces)."""
    from . import recovery
    from ..utils.logging import log
    recovery._record("ckpt.load", "corrupt", "recompute")
    log.warning("checkpoint stage %s piece %d failed verification (%s); "
                "recomputing this stage's remaining pieces instead of "
                "restoring", stage.label, piece, err)


def drain_requested(env) -> bool:
    """The preemption drain poll at a checkpoint boundary: True only when
    a grace budget is declared, checkpoints are armed and the drain vote
    (``recovery.drain_consensus``) agrees a notice arrived.  Unarmed, the
    SIGTERM flag changes nothing.

    A serving session the scheduler flagged for a preemption or a fleet
    resize drains here too (one thread-local read for the others), with
    checkpoints armed; the injector site ``sched.preempt`` fires on that
    session's thread (``stall`` widens the drain window, ``kill`` and
    ``term`` signal the process mid-drain)."""
    from .scheduler import current_session
    sess = current_session()
    if sess is not None and sess._drain_mode is not None and enabled():
        from . import recovery
        kind = recovery.maybe_inject("sched.preempt", intercept=("stall",))
        if kind == "stall":
            time.sleep(0.25)
        return recovery.drain_consensus(env, True)
    from . import preempt
    if not (preempt.armed() and enabled()):
        return False
    from . import recovery
    return recovery.drain_consensus(env, preempt.requested())


def drain_abort(label: str) -> None:
    """Raise the preemption drain: committed state is durable (the caller
    sits at a piece boundary and has settled its sink), so this writes the
    resume token and raises :class:`ResumableAbort`."""
    from . import preempt, recovery
    token = flush_for_abort(label)
    recovery._record(label, "preempt", "drain")
    timing.bump("ckpt.preempt_drain")
    g = preempt.grace_seconds()
    if g is not None:
        left = preempt.remaining_s()
        why = (f"preemption notice received (grace {g:g}s"
               f"{'' if left is None else f', {left:.1f}s left'})")
    else:
        # the scheduler's drain (a preemption or a fleet resize): no
        # grace budget is declared
        why = "scheduler drain requested"
    raise ResumableAbort(
        f"{label}: {why} "
        "— current stage flushed and committed; rerun with "
        f"CYLON_TPU_TORCH_RESUME=1 to fast-forward (resume token: {token}); "
        "a different world size re-shards committed state automatically",
        token=token)


def flush_for_abort(label: str) -> str:
    """The final rung's flush: committed state is already durable (each
    piece commits at its own boundary), so this writes a
    ``RESUME_TOKEN.json`` naming the stages this process opened (and,
    with the flight recorder armed, its ``TRACE_POSTMORTEM.json``) and
    returns the token, the checkpoint root's absolute path.  Both writes
    are best effort: a failure is logged, never raised."""
    root = ckpt_dir()
    token = os.path.abspath(root)
    try:
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, "RESUME_TOKEN.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"label": label, "pid": os.getpid(),
                       "stages": list(_OPEN_DIRS),
                       "resume": "rerun with CYLON_TPU_TORCH_RESUME=1"}, f)
    except OSError:
        pass  # the committed manifests are the durable state
    # the flight recorder's last events beside the manifests (armed runs);
    # best effort, as the token write above: a post-mortem that cannot be
    # written must not replace the resumable abort its caller raises
    from ..obs import trace
    from ..status import ExecutionError
    try:
        trace.postmortem(f"abort flush: {label}", dir_path=root)
    except ExecutionError as e:
        from ..utils.logging import log
        log.warning("abort flush %s: %s", label, e)
    return token
