"""The recovery supervisor: rolling snapshots of the train state on the
device, and the rollback -> checkpoint restore -> abort ladder.

The port of ``gnot_tpu/resilience/supervisor.py``. One bad step (NaN
gradients from an overflow, a corrupt batch) poisons the weights, and
every later step is garbage. The supervisor keeps a last-known-good copy
of the whole train state on the device, refreshed every
``snapshot_every`` steps after a finiteness check of every loss since the
previous refresh (so a snapshot is never taken of a poisoned state); on a
non-finite loss:

1. **rollback**: restore the snapshot, quarantine the offending dispatch
   (skipped on replay; the loader's seeded order makes the replay
   deterministic), re-run the lost steps. At most ``max_rollbacks`` per run.
2. **checkpoint restore**: budget spent (or no clean snapshot): restore
   ``latest`` (else ``best``) through the checkpointer's fallback walk and
   re-enter the epoch loop at the restored epoch. At most once.
3. **abort**: the hard abort, the ``non_finite_loss`` event and a
   ``FloatingPointError``.

The state is the trainer's ``state_dict()``: the weights (the flat buffer
with ``flat_params``, the stacked tree with ``scan_layers``), AdamW's
``exp_avg`` / ``exp_avg_sq`` and its ``step`` counts (CPU tensors), the
micro-step count and, with ``grad_accum > 1``, the accumulation mean and
counts. AdamW updates its tensors in place, so a snapshot that aliased
them would be no snapshot: ``_copy_state`` clones every tensor where it
lies, on the card for the weights and moments (queued on the stream, no
host sync) and on the host for the step counts, whose value sets AdamW's
bias correction.

Detection costs one device-to-host copy of the window's losses per
snapshot window (``check_losses``), no per-step sync. The telemetry NaN
watchdog and ``--debug_checks`` feed the same ladder through
``NonFiniteLossError``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import numpy as np
import torch

logger = logging.getLogger(__name__)


class NonFiniteLossError(FloatingPointError):
    """A detected non-finite training loss, with what recovery needs: the
    step and epoch, the dispatch ordinal within the epoch (when known) and
    the offending host batch (when kept). A FloatingPointError, so callers
    that catch the hard abort keep working."""

    def __init__(
        self, message: str, *, step: int, epoch: int,
        ordinal: int | None = None, batch: Any = None,
    ):
        super().__init__(message)
        self.step = step
        self.epoch = epoch
        self.ordinal = ordinal
        self.batch = batch


class PreemptionRequested(Exception):
    """Raised at a step boundary when a stop was requested (SIGTERM /
    SIGINT or injected); the trainer saves ``latest`` and exits
    resume-ready."""

    def __init__(self, epoch: int, step: int):
        super().__init__(f"preemption requested at epoch {epoch}, step {step}")
        self.epoch = epoch
        self.step = step


class RestoreEscalation(Exception):
    """Internal: the ladder escalates past the device rollback; the outer
    epoch loop restores from a checkpoint (or aborts)."""

    def __init__(self, cause: NonFiniteLossError):
        super().__init__(str(cause))
        self.cause = cause


@dataclasses.dataclass
class _Snapshot:
    state: Any  # an owned copy of the trainer's state_dict()
    ordinal: int  # dispatches completed in this epoch at snapshot time
    host_step: int
    n_losses: int
    points: int


def _copy_state(state):
    """An owned copy of a state_dict tree: every tensor cloned on its own
    device (no host sync), every container rebuilt."""
    if isinstance(state, torch.Tensor):
        return state.detach().clone()
    if isinstance(state, dict):
        return {k: _copy_state(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_copy_state(v) for v in state)
    return state  # ints, floats, strings, None: immutable


class RecoverySupervisor:
    def __init__(self, *, snapshot_every: int = 50, max_rollbacks: int = 3):
        # Bounds validated by TrainConfig.__post_init__.
        self.snapshot_every = max(1, snapshot_every)
        self.max_rollbacks = max_rollbacks
        self.rollbacks_used = 0
        self.restore_used = False
        self.snapshots = 0  # snapshots taken, the epoch-entry ones included
        self._snap: _Snapshot | None = None
        self._dispatch_log: list[tuple[int, int, int]] = []  # (ordinal, start, end)
        self._checked = 0  # losses verified finite so far this epoch
        self._last_snap_step = 0

    def _take(self, state, **where) -> _Snapshot:
        self.snapshots += 1
        return _Snapshot(state=_copy_state(state() if callable(state) else state), **where)

    # -- epoch lifecycle ---------------------------------------------------

    def begin_epoch(self, state, *, host_step: int) -> None:
        """Snapshot the epoch-entry state (always a legal rollback target)
        and reset the per-epoch dispatch log. ``state`` here and in
        ``after_dispatch`` is the trainer's state_dict, or the function
        that returns it, called only when a snapshot is taken."""
        self._snap = self._take(state, ordinal=0, host_step=host_step, n_losses=0, points=0)
        self._dispatch_log = []
        self._checked = 0
        self._last_snap_step = host_step

    def after_dispatch(
        self, state, *, ordinal: int, start_step: int, end_step: int,
        losses: list, points: int, epoch: int,
    ) -> None:
        """Record the dispatch; at each ``snapshot_every`` boundary check
        every loss since the last check (one copy to the host) and refresh
        the snapshot. Raises NonFiniteLossError on the first bad loss,
        BEFORE snapshotting, so the held snapshot is always clean."""
        self._dispatch_log.append((ordinal, start_step, end_step))
        if end_step - self._last_snap_step < self.snapshot_every:
            return
        self.check_losses(losses, epoch=epoch)
        self._snap = self._take(state, ordinal=ordinal + 1, host_step=end_step,
                                n_losses=len(losses), points=points)
        self._last_snap_step = end_step

    def check_losses(self, losses: list, *, epoch: int) -> None:
        """Check the unchecked tail of the epoch's per-dispatch losses
        (``[1]`` or ``[K]`` device tensors) with one ``torch.cat(tail)
        .cpu()``; the trainer also calls this at epoch end, so a NaN in
        the last partial window cannot reach eval."""
        tail = losses[self._checked:]
        if not tail:
            return
        fetched = torch.cat([loss.detach().reshape(-1).float() for loss in tail]).cpu().numpy()
        off = 0
        for i, loss in enumerate(tail):
            arr = fetched[off:off + loss.numel()]
            off += loss.numel()
            bad = ~np.isfinite(arr)
            if bad.any():
                ordinal, start, _ = self._dispatch_log[self._checked + i]
                step = start + int(np.argmax(bad)) + 1
                raise NonFiniteLossError(
                    f"non-finite train loss at epoch {epoch}, step {step}",
                    step=step, epoch=epoch, ordinal=ordinal,
                )
        self._checked = len(losses)

    def ordinal_for_step(self, step: int) -> int | None:
        """The dispatch ordinal of a step number (e.g. from the telemetry
        watchdog) in the current epoch's log."""
        for ordinal, start, end in self._dispatch_log:
            if start < step <= end:
                return ordinal
        return None

    # -- the ladder --------------------------------------------------------

    def plan(self, err: NonFiniteLossError) -> str:
        """The next rung for this failure: ``"rollback"`` while a snapshot
        and budget allow, else ``"restore"`` once, else ``"abort"``."""
        if self._snap is not None and self.rollbacks_used < self.max_rollbacks:
            return "rollback"
        if not self.restore_used:
            self.restore_used = True
            return "restore"
        return "abort"

    def last_good_state(self):
        """A copy of the last-known-good snapshot's state (or None): what a
        preemption save writes when the last telemetry drain finds a NaN in
        the live state."""
        return None if self._snap is None else _copy_state(self._snap.state)

    def rollback(self) -> _Snapshot:
        """Spend one unit of the budget and hand back the snapshot; the
        dispatch log and the checked count go back to its point. The held
        snapshot must survive a second rollback: the trainer's
        ``load_state_dict`` copies every tensor into the live state and
        keeps none of the snapshot's."""
        assert self._snap is not None
        self.rollbacks_used += 1
        snap = self._snap
        self._dispatch_log = [d for d in self._dispatch_log if d[0] < snap.ordinal]
        self._checked = min(self._checked, snap.n_losses)
        self._last_snap_step = snap.host_step
        return snap
