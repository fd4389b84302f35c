"""Profiler hooks of the trainer: ``trace_epoch`` and ``annotate``.

Port of ``gnot_tpu/utils/profiling.py``. ``trace_epoch`` records one
epoch with ``torch.profiler`` (host and, on the card, CUDA activity) and
writes its Chrome trace into the profile directory; ``annotate`` names a
range on that timeline (``record_function``).

Not to be confused with ``gnot_tpu_torch/profiling.py``, the reader of
kernel device times that ``chip_smoke.py`` and the probes use.
"""

from __future__ import annotations

import contextlib
import os

import torch


def trace_path(profile_dir: str, epoch: int) -> str:
    """Where ``trace_epoch`` writes epoch ``epoch``'s Chrome trace."""
    return os.path.join(profile_dir, f"epoch_{epoch}.trace.json")


@contextlib.contextmanager
def trace_epoch(profile_dir: str, epoch: int, *, trace_at: int = 1):
    """Profile epoch ``trace_at`` into ``profile_dir``. Callers pick
    ``trace_at`` past the first executed epoch when they can, to keep
    first-use builds and allocations out of the trace (``Trainer.fit``).
    No-op when ``profile_dir`` is empty or ``epoch`` is another one."""
    if not profile_dir or epoch != trace_at:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(trace_path(profile_dir, epoch))


def annotate(name: str):
    """A named range on the profiler timeline (context manager)."""
    return torch.profiler.record_function(name)
