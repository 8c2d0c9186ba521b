"""IncrementalView: an incrementally maintained groupby-aggregate (port
of ``cylon_tpu/stream/view.py``).

Each appended micro-batch is absorbed into a long-lived
:class:`~cylon_tpu_torch.exec.pipeline.GroupBySink` (one ledger-accounted
partial per batch, folded into one every ``compact_every`` batches), and
``read()`` finalizes a consistent snapshot through the sink's
non-destructive ``snapshot()`` while ingest goes on.  The snapshot is
bit-equal to a from-scratch groupby over every row seen so far whenever
the sums are exact: integer payloads, or integer-valued float64 whose
running totals over a shard stay below 2^53 (the sort-based groupby
takes a group's sum as the difference of two prefix sums over the
shard, in the view's combine as in the from-scratch groupby).

With ``CYLON_TPU_TORCH_CKPT_DIR`` set each absorbed partial is a piece of
a checkpoint stage (exec/checkpoint.py).  A process killed mid-ingest
resumes (``CYLON_TPU_TORCH_RESUME=1``) by restoring the committed
partials and fast-forwarding as many appends: the replayed batches are
counted, not absorbed again.  At another world size the committed prefix
is adopted, re-sharded onto the live world.

Across processes each process absorbs, folds and checkpoints its own
ranks' partials (its pages in its own ``rank<process>`` directory), a
read's combine is the sort-based groupby across the processes, the
resume's fast-forward count is min-agreed, and a resume under another
process layout adopts the committed prefix as another world's would be.

Armed (``CYLON_TPU_TORCH_AUDIT=1``), each absorbed batch's fingerprint is
voted before it folds into the partials (exec/integrity.audit_table, site
``stream.absorb``).
"""

from __future__ import annotations

from ..core.table import Table
from ..exec.pipeline import GroupBySink


class IncrementalView:
    """A groupby-aggregate maintained over a stream.

    Usage::

        st = StreamTable(env, key="k")
        view = IncrementalView(st, "k", [("v", "sum"), ("v", "var")])
        st.append(batch); st.append(batch2)
        snap = view.read()        # a Table; ingest goes on

    ``source``: a :class:`~cylon_tpu_torch.stream.table.StreamTable` to
    subscribe to, or None to drive :meth:`absorb` by hand.  The ops are
    the sink's: sum/count/min/max/mean/var/std."""

    _SEQ = [0]  # the default-name counter (stable across a replay)

    def __init__(self, source, by, aggs, ddof: int = 1,
                 name: str | None = None, env=None,
                 compact_every: int = 32):
        self.env = env if env is not None else source.env
        self.by = [by] if isinstance(by, str) else list(by)
        self.aggs = list(aggs)
        self.ddof = int(ddof)
        #: fold the sink's partials into one every N absorbed batches
        #: (bounded state and reads for an unbounded stream); 0: never
        self.compact_every = int(compact_every)
        if name is None:
            name = f"view{self._SEQ[0]}"
            self._SEQ[0] += 1
        self.name = str(name)
        self.sink = GroupBySink(self.by, self.aggs, ddof=self.ddof)
        self.batches_absorbed = 0
        self.rows_absorbed = 0
        self._skip = 0          # replayed batches the restore covers
        self._ffwd = 0          # the restored prefix's length
        self._attach_checkpoint()
        if source is not None:
            source.subscribe(self.absorb)

    # -- durability --------------------------------------------------------
    def _attach_checkpoint(self) -> None:
        """Arm checkpoints when ``CYLON_TPU_TORCH_CKPT_DIR`` is set: the
        view is one long-lived stage (its plan token over the name, keys,
        aggregations and ddof; the world rides the token's layout half)
        and each absorbed partial a piece.  On resume the committed
        prefix is restored, the fast-forward count min-agreed
        (``recovery.ckpt_resume_consensus``) and that many appends are
        skipped.  A view's piece identity (the batch ordinal) does not
        depend on the world and its partials merge, so a resume at
        another world adopts the committed prefix
        (``Stage.load_foreign_pieces(prefix_ok=True)``: a corrupt piece
        trims the adoption to the verified pieces before it) and
        commits it again in the new layout, so the next resume is a
        plain one."""
        from ..exec import checkpoint as ckpt
        from ..exec import recovery
        from ..status import CheckpointCorruptError
        if not ckpt.enabled():
            return
        base = ckpt.plan_token(
            "stream_view", self.name, tuple(self.by),
            tuple((c, op) for c, op, *_ in self.aggs), self.ddof)
        token = ckpt.plan_token(base, int(self.env.world_size))
        stage = ckpt.open_stage(self.env, f"stream_view.{self.name}", token,
                                base_token=base)
        if ckpt.resume_requested():
            restored: list = []
            foreign = stage.foreign is not None
            if stage.resuming:
                while stage.has_piece(len(restored)):
                    try:
                        restored.append(stage.load_piece(len(restored)))
                    except CheckpointCorruptError as e:
                        ckpt.corrupt_fallback(stage, len(restored), e)
                        break
            elif foreign:
                try:
                    restored = stage.load_foreign_pieces(prefix_ok=True)
                except CheckpointCorruptError as e:
                    ckpt.corrupt_fallback(stage, len(restored), e)
                    restored = []
            n = recovery.ckpt_resume_consensus(self.env, len(restored))
            # armed: the voted prefix audited against the manifests'
            # fingerprints, the pieces before the first miss voted again
            n = ckpt.audit_restored(stage, restored, n)
            if foreign:
                restored = restored[:n]
                if restored:
                    ckpt.note_reshard(n)
                    stage.begin_rewrite()
                    for i, part in enumerate(restored):
                        stage.save_piece(i, part)
            elif len(restored) > n:
                ckpt.unrestore(len(restored) - n)
            for part in restored[:n]:
                self.sink.restore_partial(part)
            self._skip = self._ffwd = len(restored[:n])
        self.sink.attach_checkpoint(stage)

    @property
    def fast_forwarded(self) -> int:
        """Appends covered by restored checkpoint partials (resume)."""
        return self._ffwd

    # -- ingest ------------------------------------------------------------
    def absorb(self, batch: Table) -> None:
        """Absorb one (shuffled) micro-batch into the sink.  During a
        resume the first ``_skip`` replayed batches are counted, not
        absorbed: the restored partials hold them."""
        self.batches_absorbed += 1
        self.rows_absorbed += int(batch.row_count)
        if self._skip > 0:
            self._skip -= 1
            return
        from ..exec import integrity
        if integrity.armed():
            # the armed audit: the batch's fingerprint, voted before it
            # folds into the long-lived partials
            integrity.audit_table(batch, site="stream.absorb",
                                  phase="stream_absorb")
        self.sink.absorb(batch)
        if (self.compact_every
                and len(self.sink._parts) >= self.compact_every):
            self.sink.compact()
        from ..exec import checkpoint as ckpt
        if self.sink._ckpt is not None and ckpt.drain_requested(self.env):
            # a preemption notice: the batch just absorbed is committed,
            # so this append boundary is the planned exit; the resumed
            # ingest fast-forwards the committed batches
            self.sink.flush_pending()
            ckpt.drain_abort(f"stream_view.{self.name}")

    def read(self) -> Table:
        """A finalized snapshot over every batch absorbed so far, leaving
        the partials adopted (append-to-visible staleness is one absorb
        plus one read)."""
        return self.sink.snapshot()

    def finalize(self) -> Table:
        """The last read: drains the sink and its ledger balance."""
        return self.sink.finalize()

    def stats(self) -> dict:
        return {"name": self.name, "batches": self.batches_absorbed,
                "rows": self.rows_absorbed,
                "fast_forwarded": self._ffwd,
                "partials": len(self.sink._parts)}
