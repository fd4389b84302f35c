"""OneCycle learning-rate schedule, torch-formula-exact.

A copy of ``gnot_tpu/train/schedule.py`` (the port imports nothing of
the JAX package), so both packages step the same learning rates.

The reference uses ``torch.optim.lr_scheduler.OneCycleLR(optimizer,
max_lr=1e-3, steps_per_epoch=len(train_loader), epochs=args.epochs)``
(main.py:52) with all other arguments at torch defaults: cosine
annealing, ``pct_start=0.3``, ``div_factor=25``, ``final_div_factor=1e4``,
``three_phase=False``.

Crucially the reference calls ``scheduler.step()`` once per **epoch**
(main.py:106) even though the schedule is sized in per-batch steps, so
only ``epochs / (epochs * steps_per_epoch)`` of the cycle is traversed —
the LR never leaves the early warm-up ramp. ``OptimConfig.
parity_schedule_bug=True`` reproduces this by evaluating the schedule at
the *epoch* counter; ``False`` gives the correct per-update schedule.
"""

from __future__ import annotations

import math
from typing import Callable


def _cos_anneal(start: float, end: float, pct: float) -> float:
    """torch OneCycleLR cosine annealing between two bounds."""
    return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))


def onecycle_lr(
    step: float,
    *,
    max_lr: float,
    total_steps: int,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> float:
    """LR after ``step`` scheduler steps, matching torch OneCycleLR
    (cos anneal, three_phase=False)."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    phase1_end = pct_start * total_steps - 1
    phase2_end = total_steps - 1
    step = min(step, phase2_end)
    if step <= phase1_end:
        pct = step / max(phase1_end, 1e-12)
        return _cos_anneal(initial_lr, max_lr, pct)
    pct = (step - phase1_end) / max(phase2_end - phase1_end, 1e-12)
    return _cos_anneal(max_lr, min_lr, pct)


def make_lr_fn(optim_cfg, *, steps_per_epoch: int, epochs: int) -> Callable[[int, int], float]:
    """Returns ``lr(step, epoch)`` where ``step`` is the micro-step count
    (one per batch).

    With the parity bug on, the schedule is evaluated at the epoch count
    (the reference's per-epoch ``scheduler.step()``), over the cycle the
    reference sizes in per-batch steps (main.py:52). Otherwise it is
    evaluated at the optimizer update count: with ``grad_accum = k`` an
    update takes the learning rate of its k-th micro-step, so the
    counter is ``step // k`` over a horizon of ``max(1, steps_per_epoch
    * epochs // k)`` updates (accumulation windows straddle epochs, so
    the whole micro-step horizon is divided, not each epoch's).
    """
    accum = max(1, optim_cfg.grad_accum)
    if optim_cfg.parity_schedule_bug:
        total_steps = steps_per_epoch * epochs
    else:
        total_steps = max(1, (steps_per_epoch * epochs) // accum)

    def lr(step: int, epoch: int) -> float:
        counter = epoch if optim_cfg.parity_schedule_bug else step // accum
        return onecycle_lr(
            counter,
            max_lr=optim_cfg.lr,
            total_steps=total_steps,
            pct_start=optim_cfg.pct_start,
            div_factor=optim_cfg.div_factor,
            final_div_factor=optim_cfg.final_div_factor,
        )

    return lr
