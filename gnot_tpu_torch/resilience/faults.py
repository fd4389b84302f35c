"""Deterministic fault injection, driven by ``TrainConfig.inject_fault``.

The port of ``gnot_tpu/resilience/faults.py``: the same registry of fault
kinds, the same spec grammar (a comma-separated list of ``kind@N``
entries; a spec the JAX package accepts parses the same here), and the
trainer's and checkpointer's hooks, for the port's batches and its
checkpoint files:

* ``nan_grad@STEP``: the batch dispatched as global step STEP gets NaN
  targets, so its loss and gradients are NaN (the "one bad step").
* ``bad_sample@STEP``: the batch's coordinates at step STEP are NaN (a
  corrupt record that slipped through the data pipeline).
* ``sigterm@STEP``: a real SIGTERM to this process before step STEP
  dispatches (a preemption notice mid-epoch).
* ``ckpt_io@N``: N transient ``InjectedIOError``s against checkpoint
  save / restore / sidecar I/O (a flaky filesystem).
* ``corrupt_ckpt@EPOCH``: once the ``latest`` checkpoint recording EPOCH
  is committed and published, its file is truncated (a torn write), so a
  later restore must fall back.
* ``stop_epoch@N``: stop cleanly after N epochs (``--stop_after_epoch N``
  is an alias).

The serve-side kinds (``slow_request``, ``nan_output``,
``reload_corrupt``), the rollout kinds (``replica_kill``,
``stale_session``, ``rollout_nan``) and the federation kinds
(``host_kill``, ``net_partition``, ``msg_drop``, ``msg_delay``) parse
here as they do in the JAX package; their hooks wait for the port's
replicated server, rollout serving and federation (``ROADMAP.md``).

Steps are 1-indexed global micro-step counts (the trainer's
``host_step`` after the dispatch), the step numbers of the metrics
records. Step- and epoch-keyed faults fire once; ``ckpt_io`` spends one
unit of its budget per injected error. Stdlib and torch only.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal

import torch

logger = logging.getLogger(__name__)

#: The registry of injectable fault kinds, the JAX package's whole list.
FAULT_KINDS = (
    "nan_grad",
    "bad_sample",
    "sigterm",
    "ckpt_io",
    "corrupt_ckpt",
    "stop_epoch",
    # serve-side
    "slow_request",
    "nan_output",
    "reload_corrupt",
    # rollout serving
    "replica_kill",
    "stale_session",
    "rollout_nan",
    # federation
    "host_kill",
    "net_partition",
    "msg_drop",
    "msg_delay",
)


class InjectedIOError(OSError):
    """A deliberately injected transient I/O failure (an OSError, so the
    retry machinery treats it exactly like the real thing)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str  # one of FAULT_KINDS
    at: int  # step / epoch / error budget, per kind


def parse_fault_spec(spec: str) -> list[FaultSpec]:
    """Parse ``"kind@N,kind@N"`` into FaultSpecs; raises ValueError
    naming the bad entry and the grammar."""
    out: list[FaultSpec] = []
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        kind, sep, arg = entry.partition("@")
        if not sep or kind not in FAULT_KINDS or not arg.lstrip("-").isdigit():
            raise ValueError(
                f"bad fault spec entry {entry!r}: want kind@N with kind in "
                f"{FAULT_KINDS} and integer N (got spec {spec!r})"
            )
        at = int(arg)
        if at < 1:
            raise ValueError(f"fault spec entry {entry!r}: N must be >= 1")
        out.append(FaultSpec(kind, at))
    return out


def _filled(t: torch.Tensor, value: float) -> torch.Tensor:
    """A new tensor like ``t`` filled with ``value``, page-locked when
    ``t`` is, so its copy to the card stays asynchronous."""
    out = torch.full_like(t, value)
    return out.pin_memory() if t.is_pinned() else out


class FaultInjector:
    """The parsed plan; the trainer and the checkpointer consult it at
    their few hook points (before a dispatch, at each checkpoint I/O
    attempt, after a save is published, at epoch end). Single-fire
    bookkeeping lives here, so the call sites stay branch-free when no
    fault is armed."""

    def __init__(self, specs: list[FaultSpec]):
        self.specs = list(specs)
        self._fired: set[tuple[str, int]] = set()
        self._io_budget = sum(s.at for s in specs if s.kind == "ckpt_io")

    @classmethod
    def from_config(cls, train_cfg) -> "FaultInjector | None":
        """From a TrainConfig: the ``inject_fault`` spec plus the
        ``stop_after_epoch`` alias (``stop_epoch@N``). None when nothing
        is armed (the trainer then skips every hook)."""
        specs = parse_fault_spec(getattr(train_cfg, "inject_fault", "") or "")
        stop = getattr(train_cfg, "stop_after_epoch", 0)
        if stop and not any(s.kind == "stop_epoch" for s in specs):
            specs.append(FaultSpec("stop_epoch", stop))
        return cls(specs) if specs else None

    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector | None":
        """From a ``kind@N,...`` spec string; None when it is empty."""
        specs = parse_fault_spec(spec or "")
        return cls(specs) if specs else None

    def _take(self, kind: str, at: int) -> bool:
        """True exactly once per (kind, at) armed in the plan."""
        key = (kind, at)
        if key in self._fired:
            return False
        if any(s.kind == kind and s.at == at for s in self.specs):
            self._fired.add(key)
            return True
        return False

    # -- trainer hooks -----------------------------------------------------

    def poison_batch(self, batch, step: int):
        """Apply any batch fault armed for global step ``step`` to a host
        ``MeshBatch`` or ``PackedBatch``. Returns the batch, or a poisoned
        copy: a loader-owned tensor is never written in place."""
        if self._take("nan_grad", step):
            logger.warning("fault injection: NaN targets at step %d", step)
            return dataclasses.replace(batch, y=_filled(batch.y, float("nan")))
        if self._take("bad_sample", step):
            logger.warning("fault injection: bad sample (NaN coords) at step %d", step)
            return dataclasses.replace(batch, coords=_filled(batch.coords, float("nan")))
        return batch

    def maybe_sigterm(self, step: int) -> None:
        """Deliver a real SIGTERM to this process before step ``step``
        dispatches: the actual signal path, not a mock."""
        if self._take("sigterm", step):
            logger.warning("fault injection: SIGTERM before step %d", step)
            os.kill(os.getpid(), signal.SIGTERM)

    def stop_after_epoch(self, epoch: int) -> bool:
        """A clean stop once ``epoch + 1`` epochs have completed."""
        return any(
            s.kind == "stop_epoch" and epoch + 1 >= s.at for s in self.specs
        )

    # -- checkpoint hooks --------------------------------------------------

    def maybe_io_error(self, op: str) -> None:
        """Raise one InjectedIOError per armed ``ckpt_io`` budget unit (the
        checkpointer calls this at the top of each I/O attempt, inside the
        retry loop)."""
        if self._io_budget > 0:
            self._io_budget -= 1
            logger.warning(
                "fault injection: transient I/O error on %s (%d left)",
                op, self._io_budget,
            )
            raise InjectedIOError(f"injected transient failure during {op}")

    def post_save(self, name: str, path: str, epoch: int) -> None:
        """``corrupt_ckpt@EPOCH``: truncate the just-published ``latest``
        file of that epoch (the sidecar still names it: the torn-write
        shape the restore fallback must survive)."""
        if name == "latest" and self._take("corrupt_ckpt", epoch):
            logger.warning("fault injection: truncating checkpoint file %s", path)
            corrupt_checkpoint(path, mode="truncate")


def corrupt_checkpoint(path: str, *, mode: str = "truncate") -> None:
    """Corrupt a committed checkpoint file in one of the shapes real
    storage produces (shared by the injector and the tests):

    * ``truncate``: keep the first half of its bytes (a partial upload or
      a torn write); the file exists but ``torch.load`` fails on it.
    * ``remove``: delete it (a sidecar naming it now dangles).
    """
    if mode == "remove":
        if os.path.exists(path):
            os.remove(path)
        return
    if mode != "truncate":
        raise ValueError(f"unknown corruption mode {mode!r}")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file to corrupt at {path}")
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size // 2)


def _published(directory: str, name: str) -> str | None:
    """The file the ``<name>.json`` sidecar names, or None without a
    readable sidecar."""
    try:
        with open(os.path.join(directory, f"{name}.json")) as f:
            return json.load(f).get("dir")
    except (OSError, json.JSONDecodeError):
        return None


def corrupt_published(directory: str, name: str = "latest") -> None:
    """Truncate the checkpoint file the ``<name>.json`` sidecar names (a
    torn write landing between a save and the restore that reads it).
    No-op when there is no sidecar or no such file."""
    target = _published(directory, name)
    if target is not None and os.path.isfile(os.path.join(directory, target)):
        corrupt_checkpoint(os.path.join(directory, target), mode="truncate")


def dangle_sidecar(directory: str, name: str) -> None:
    """Delete the file ``<name>.json`` names, leaving the sidecar pointing
    at nothing (the crash-window shape: sidecar committed, file lost)."""
    target = _published(directory, name)
    if target is None:
        raise FileNotFoundError(f"no readable {name}.json under {directory}")
    corrupt_checkpoint(os.path.join(directory, target), mode="remove")
