"""Training health monitors: slow-step outliers and NaN localization.

Port of ``gnot_tpu/obs/health.py``. Both are host-side and run at the
telemetry buffer's drains, on what it already fetched, so neither adds a
device sync to the step.

JAX's third monitor, ``RecompileMonitor``, counts the entries of each
jitted function's trace cache and reports a ``recompile`` event when one
grows mid-run. Eager PyTorch traces and compiles nothing, so it has no
such cache and nothing to count: the port has no recompile monitor and
never emits ``recompile``.
"""

from __future__ import annotations

import math
import statistics

import torch


class SlowStepMonitor:
    """Dispatch-interval outlier gauge (``gnot_tpu/obs/health.py``, the
    same rule and defaults).

    Observes the host wall time between step dispatches. An observation
    is an outlier when it exceeds ``factor`` x the rolling median of the
    last ``window`` observations, once ``warmup`` observations have
    seeded the median (first-use builds land in the warmup)."""

    def __init__(self, factor: float = 3.0, warmup: int = 10, window: int = 256):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {factor}")
        self.factor = factor
        self.warmup = warmup
        self.window = window
        self._times: list[float] = []
        self._seen = 0

    def observe(self, dt: float) -> dict | None:
        """Feed one dispatch interval (seconds); returns the outlier
        record (``step_time_s`` / ``median_s`` / ``slowdown``) or None."""
        self._seen += 1
        out = None
        if self._seen > self.warmup and len(self._times) >= 2:
            med = statistics.median(self._times)
            if med > 0 and dt > self.factor * med:
                out = {
                    "step_time_s": dt,
                    "median_s": med,
                    "slowdown": dt / med,
                }
        self._times.append(dt)
        if len(self._times) > self.window:
            del self._times[: len(self._times) - self.window]
        return out


def _first_non_finite(value) -> str | None:
    """"nan" or "inf" for the first non-finite float tensor in a module
    output (a tensor, or a tuple / list / dict of them), else None."""
    if isinstance(value, torch.Tensor):
        if not value.is_floating_point():
            return None
        if torch.isnan(value).any():
            return "nan"
        if torch.isinf(value).any():
            return "inf"
        return None
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            if (kind := _first_non_finite(v)) is not None:
                return kind
    return None


@torch.no_grad()
def localize_nan(model: torch.nn.Module, loss_fn, batch) -> str | None:
    """Re-run ``loss_fn(batch)`` (which calls ``model``) with a forward
    hook on every module of ``model``, and name the first module whose
    output was non-finite, as ``"<qualified name>: nan"`` (or ``inf``).
    Hooks fire as modules finish, so the first is the innermost module
    that produced the value. None when the re-run comes back clean: a
    NaN that does not reproduce on the current weights. JAX re-runs the
    loss under checkify for the same answer (``health.localize_nan``)."""
    found: list[str] = []

    def hook(name):
        def fn(module, inputs, output):
            if not found and (kind := _first_non_finite(output)) is not None:
                found.append(f"{name or type(module).__name__}: {kind}")
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()]
    try:
        loss = loss_fn(batch)
    finally:
        for h in handles:
            h.remove()
    if found:
        return found[0]
    if not math.isfinite(float(loss)):
        return f"loss: {'nan' if math.isnan(float(loss)) else 'inf'}"
    return None
