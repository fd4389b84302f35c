"""Device-side scalar telemetry of the train step, and its buffer.

Port of ``gnot_tpu/obs/telemetry.py``. The step adds a few reductions
over values it already holds (the gradients, the optimizer's moments,
the weights, the batch's mask, the gate scores) and keeps them as device
tensors; ``TelemetryBuffer`` fetches a whole drain window in one
device-to-host copy, so the step itself adds no host sync.

The keys, as JAX's ``instrument`` gives them:

* ``grad_norm``: global norm of the micro-step's raw gradients, before
  clipping, accumulation or AdamW;
* ``update_norm``: global norm of the whole transform's update (clipping,
  AdamW with its weight decay, gradient accumulation), 0 on a micro-step
  that does not end an accumulation window, as ``optax.MultiSteps``
  emits zero updates there;
* ``param_norm``: global norm of the weights after the update;
* ``padding_waste``: ``1 - mean(node_mask)`` of the batch;
* ``gate_load/block_{i}`` ``[E]`` and ``gate_entropy/block_{i}``: the
  standard forward's gate health (``models/gnot.py``). JAX's overridden
  forwards (the flat, packed and stacked layouts) give the norm and
  padding keys only, and so does the trainer here.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from gnot_tpu_torch.obs import events

#: ``gnot_tpu/obs/telemetry.py``'s refusal of telemetry on a pipe mesh.
PIPE_ERROR = (
    "telemetry does not compose with the pipeline mesh path yet (the "
    "shard_map schedule builds its own step); set mesh pipe=1 or "
    "disable telemetry"
)


@torch.no_grad()
def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of ``tensors``
    (``optax.global_norm``), a device scalar."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@torch.no_grad()
def adamw_update_norm(optimizer: torch.optim.AdamW, norm=global_norm) -> torch.Tensor:
    """Global norm of the update the foreach AdamW just applied to the
    parameters of its one group, computed the way it applied it rather
    than as ``p_new - p_old``, which in f32 subtracts two close numbers.

    Torch's step is ``p <- p * (1 - lr * wd) - a`` with ``a = (lr / bc1) *
    m / (sqrt(v) / sqrt(bc2) + eps)`` on the new moments ``m``, ``v`` and
    bias corrections ``bc1 = 1 - b1^t``, ``bc2 = 1 - b2^t``. So the update
    is ``-(lr * wd * p_old + a)`` with ``p_old = (p + a) / (1 - lr * wd)``,
    that is ``-((1 + c) * a + c * p)`` with ``c = lr * wd / (1 - lr * wd)``;
    the error of ``p_old`` is scaled by ``lr * wd``, far below the bar.
    One list of temporaries, written in place. ``norm`` is the global
    norm (of every rank's shards, on a mesh that splits the weights)."""
    group = optimizer.param_groups[0]
    params = group["params"]
    lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
    b1, b2 = group["betas"]
    states = [optimizer.state[p] for p in params]
    t = float(states[0]["step"])  # a CPU tensor: no sync
    bc1, bc2 = 1 - b1**t, 1 - b2**t
    c = lr * wd / (1 - lr * wd)
    u = torch._foreach_sqrt([s["exp_avg_sq"] for s in states])
    torch._foreach_div_(u, math.sqrt(bc2))
    torch._foreach_add_(u, eps)
    torch._foreach_reciprocal_(u)
    torch._foreach_mul_(u, [s["exp_avg"] for s in states])
    torch._foreach_mul_(u, lr / bc1 * (1 + c))
    torch._foreach_add_(u, params, alpha=c)  # minus the update
    return norm(u)


@torch.no_grad()
def instrument(gates: dict | None, grad_norm: torch.Tensor, update_norm: torch.Tensor,
               params: list[torch.Tensor], batch, *, norm=global_norm,
               mean=lambda t: t) -> dict[str, torch.Tensor]:
    """The step's telemetry dict: the norms, the batch's padding waste and
    the gate stats the forward collected (``None`` for the norm-only
    layouts). ``params`` are the weights after the update. On a mesh
    ``norm`` sums over every rank's shards and ``mean`` turns a rank's
    token mean into the whole batch's."""
    telem = {
        "grad_norm": grad_norm,
        "update_norm": update_norm,
        "param_norm": norm(params),
    }
    mask = getattr(batch, "node_mask", None)
    if mask is not None:
        telem["padding_waste"] = 1.0 - mean(mask.float().mean())
    if gates:
        telem.update(gates)
    return telem


class TelemetryBuffer:
    """Device-resident telemetry with batched drains
    (``gnot_tpu/obs/telemetry.py::TelemetryBuffer``).

    ``append`` keeps one dispatch's loss and telemetry device tensors and
    its host bookkeeping (steps, learning rates, the wall time since the
    last append, the host batches): no copy, no sync. ``drain`` copies the
    whole window to the host at once (one ``torch.cat`` then one
    ``.cpu()``), runs the slow-step gauge over every dispatch interval and
    the NaN watchdog over every loss, and writes one JSONL record per
    ``log_every``-multiple step. The trainer drains on the window edge and
    at epoch end.

    ``on_nonfinite(step, epoch, loss, batch)`` fires on the first
    non-finite loss of a drained window (the watchdog: it raises).
    ``metrics`` (an ``obs.metrics.MetricsRegistry``) is the live metrics
    plane's train-side tap: every drained dispatch interval lands in the
    ``train_step_time_ms`` histogram and every slow-step outlier adds one
    to ``train_slow_steps_total``, at drain cadence (no host sync)."""

    #: drain cadence when log_every is 0 (telemetry on, records off: the
    #: health monitors still need to see the losses).
    DEFAULT_DRAIN = 50

    def __init__(
        self, sink, log_every: int, *, slow_step=None, on_nonfinite=None, metrics=None,
    ):
        self.sink = sink
        self.record_every = max(0, int(log_every))
        self.drain_every = self.record_every or self.DEFAULT_DRAIN
        self._entries: list[dict] = []
        self._pending_steps = 0
        self._slow = slow_step
        self._on_nonfinite = on_nonfinite
        self._last_t: float | None = None
        self.drains = 0
        self._step_hist = metrics.histogram("train_step_time_ms") if metrics is not None else None
        self._slow_counter = (
            metrics.counter("train_slow_steps_total") if metrics is not None else None
        )

    def append(
        self, *, steps, epoch, lrs, loss, telem, batches, span_ids=None
    ) -> None:
        """One dispatch: ``steps`` / ``lrs`` / ``batches`` are length-K
        lists (K = 1 for a single step), ``loss`` and ``telem`` its device
        tensors, stacked on a leading K axis for K > 1. ``span_ids`` (the
        tracer's ``step`` span of the dispatch) let a ``slow_step`` event
        name the span it indicts."""
        now = time.perf_counter()
        dt = (now - self._last_t) / len(steps) if self._last_t is not None else None
        self._last_t = now
        self._entries.append(
            dict(steps=list(steps), epoch=epoch, lrs=list(lrs), loss=loss,
                 telem=telem, batches=list(batches), dt=dt,
                 span_ids=list(span_ids) if span_ids is not None else None)
        )
        self._pending_steps += len(steps)
        if self._pending_steps >= self.drain_every:
            self.drain()

    def _fetch(self, entries: list[dict]) -> list[tuple[np.ndarray, dict[str, np.ndarray]]]:
        """Every entry's loss and telemetry on the host, through one
        device-to-host copy of the whole window."""
        parts, shapes = [], []
        for e in entries:
            for v in (e["loss"], *e["telem"].values()):
                parts.append(v.detach().float().reshape(-1))
                shapes.append(tuple(v.shape))
        host = torch.cat(parts).cpu().numpy()  # the window's one copy
        out, off, i = [], 0, 0
        for e in entries:
            values = []
            for _ in range(1 + len(e["telem"])):
                n = math.prod(shapes[i])
                values.append(host[off:off + n].reshape(shapes[i]))
                off, i = off + n, i + 1
            out.append((values[0], dict(zip(e["telem"], values[1:]))))
        return out

    def discard(self) -> None:
        """Drop the buffered window without draining it (a recovery
        rollback): the rolled-back steps' records would be bogus, and the
        non-finite loss among them must not fire the watchdog again."""
        self._entries.clear()
        self._pending_steps = 0
        self._last_t = None

    def drain(self) -> None:
        if not self._entries:
            return
        entries, self._entries = self._entries, []
        self._pending_steps = 0
        # What happens between a drain and the next append (the epoch-end
        # eval and checkpoints, or this drain's own copy and writes) is
        # not a step interval: timing it would hand the slow-step gauge a
        # false outlier.
        self._last_t = None
        self.drains += 1
        for e, (loss, telem) in zip(entries, self._fetch(entries)):
            k = len(e["steps"])
            if self._step_hist is not None and e["dt"] is not None:
                self._step_hist.record(e["dt"] * 1e3)
            if self._slow is not None and e["dt"] is not None:
                outlier = self._slow.observe(e["dt"])
                if outlier is not None and self._slow_counter is not None:
                    self._slow_counter.inc()
                if outlier is not None and self.sink is not None:
                    span_id = next((s for s in e["span_ids"] or [] if s is not None), None)
                    self.sink.log(
                        event=events.SLOW_STEP, step=e["steps"][-1],
                        epoch=e["epoch"], **outlier,
                        **({"span_id": span_id} if span_id else {}),
                    )
            loss = np.atleast_1d(loss)
            for i, step in enumerate(e["steps"]):
                li = float(loss[i] if k > 1 else loss[0])
                if (
                    self.sink is not None
                    and self.record_every
                    and step % self.record_every == 0
                ):
                    rec = {"step": step, "epoch": e["epoch"], "loss": li,
                           "lr": e["lrs"][i]}
                    for key, v in telem.items():
                        rec[key] = v[i] if k > 1 else v
                    self.sink.log(**rec)
                if not math.isfinite(li) and self._on_nonfinite is not None:
                    # Records up to and including the bad step are
                    # written; the watchdog raises.
                    self._on_nonfinite(step, e["epoch"], li, e["batches"][i])
