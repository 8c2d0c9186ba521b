"""Elastic serving: a resize of the fleet under live traffic (port of
``cylon_tpu/exec/fleet.py``).

The serving scheduler runs its tenants on one world whose size is fixed
at launch, so a resize means draining the whole box and relaunching at
the new world: the preemption drain's protocol (exec/preempt →
exec/checkpoint), driven by load instead of a SIGTERM.
:class:`ResizeController` is that driver.  The scheduler polls
:meth:`~ResizeController.maybe_resize` once per loop turn; when the
pressure signals (the admission queue's depth, the ledger's balance
against its budget) say the world is wrong and enough work is committed
to disk, it engages the scheduler's all-or-nothing fleet drain:

* every running tenant drains at its next checkpoint boundary (it
  commits and raises a typed ``ResumableAbort``);
* pending tenants fail typed-resumable (nothing was committed; a resume
  recomputes them);
* ``scheduler.resize_target`` is set, and the caller exits for a
  relaunch at that world with ``CYLON_TPU_TORCH_RESUME=1``: stages of the
  same world fast-forward, stages of another re-shard.

The decision is voted (max target wins) where several processes drive
one world (``recovery.count_consensus``): each process reads its own
ledger, so their pressure differs, and every process engages the drain
or none does.  A ``FLEET_RESIZE.json`` breadcrumb with the target lands
in the checkpoint root beside ``RESUME_TOKEN.json`` for the relauncher,
written by every process through a temporary file and a rename.
"""

from __future__ import annotations

import os

from ..status import InvalidError


class ResizeController:
    """The resize driver of a serving scheduler
    (``QueryScheduler(env, fleet=...)``).

    ``target_world`` is the world to relaunch at.  The drain engages when
    the pending sessions reach ``queue_depth_high`` or the ledger's
    balance reaches ``ledger_frac_high`` of its budget, and at least
    ``min_committed_pieces`` checkpoint pieces are committed across the
    sessions (a resize with nothing committed would be a restart).  A
    trigger set to None is off."""

    def __init__(self, env, *, target_world: int,
                 queue_depth_high: int | None = 2,
                 ledger_frac_high: float | None = None,
                 min_committed_pieces: int = 1):
        if int(target_world) < 1:
            raise InvalidError(
                f"resize target world {target_world!r} must be >= 1")
        self.env = env
        self.target_world = int(target_world)
        self.queue_depth_high = queue_depth_high
        self.ledger_frac_high = ledger_frac_high
        self.min_committed_pieces = int(min_committed_pieces)
        self.engaged = False

    # -- the pressure signals ----------------------------------------------
    def pressure(self, sched) -> dict:
        """What the decision reads (also written into the breadcrumb)."""
        from . import memory
        from .session import PENDING
        queue_depth = sum(1 for s in sched.sessions
                          if s.state == PENDING)
        committed = sum(s.pieces_committed for s in sched.sessions)
        mem = memory.stats()
        budget = memory.budget_bytes(self.env)
        frac = (mem["ledger_bytes"] / budget) if budget > 0 else 0.0
        return {"queue_depth": queue_depth,
                "pieces_committed": committed,
                "ledger_bytes": mem["ledger_bytes"],
                "ledger_frac": round(frac, 4)}

    def should_resize(self, sched) -> bool:
        p = self.pressure(sched)
        if p["pieces_committed"] < self.min_committed_pieces:
            return False
        if (self.queue_depth_high is not None
                and p["queue_depth"] >= self.queue_depth_high):
            return True
        if (self.ledger_frac_high is not None
                and p["ledger_frac"] >= self.ledger_frac_high):
            return True
        return False

    # -- the scheduler's hook ----------------------------------------------
    def maybe_resize(self, sched) -> bool:
        """Decide, and on a resize engage the scheduler's fleet drain;
        True when it engaged on this call.  Never without checkpoints: a
        drain with nothing durable to resume from would lose work."""
        if self.engaged or sched._fleet_drain:
            return False
        from . import checkpoint
        if not checkpoint.enabled():
            return False
        want = self.target_world if self.should_resize(sched) else 0
        if sched._multi():
            from . import recovery
            want = recovery.count_consensus(self.env, want)
        if not want:
            return False
        self.engaged = True
        info = self.pressure(sched)
        self._write_breadcrumb(want, info)
        sched._begin_fleet_drain(
            want, f"queue_depth={info['queue_depth']} "
                  f"ledger_frac={info['ledger_frac']}")
        return True

    def _write_breadcrumb(self, target_world: int, info: dict) -> None:
        from . import checkpoint
        try:
            # every process writes it, each through its own temporary
            # file: the rename leaves one whole breadcrumb
            checkpoint.atomic_json(
                os.path.join(checkpoint.ckpt_dir(), "FLEET_RESIZE.json"),
                {"target_world": int(target_world),
                 "from_world": int(self.env.world_size),
                 "pid": os.getpid(), **info})
        except OSError:
            pass  # the committed manifests are the durable state; the
            # breadcrumb is best effort, as RESUME_TOKEN.json is
