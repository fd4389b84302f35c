"""Device time of the kernels a function runs, read from ``torch.profiler``.

The one reader of kernel times for ``chip_smoke.py`` and the probes.
"""

from __future__ import annotations

from typing import Callable

import torch


def kernel_times(fn, iters: int = 20, warmup: int = 3, attempts: int = 3,
                 names: tuple[str, ...] = (),
                 log: Callable[[str], None] = print) -> dict[str, float] | None:
    """Mean device time in ms of each kernel one ``fn()`` runs: the total
    of its records (CUPTI) over ``iters`` calls, over ``iters``. A kernel
    is keyed by the first of ``names`` its symbol contains, else by its
    symbol's first 40 characters; kernels under one key add up.

    CUPTI now and then hands back a profile without device events, or
    without the first of ``names``; such a profile is taken again, and
    after ``attempts`` of them the answer is None. It also drops records
    at times. Every kernel of a function timed here runs a fixed number
    of times a call, so a kernel whose records are no multiple of
    ``iters`` lost some, and its time reads low: ``log`` says so beside
    the count, and the time is still the total over ``iters``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times: dict[str, float] = {}
        for evt in prof.key_averages():
            if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
                continue
            us = getattr(evt, "self_device_time_total", None)
            us = us if us is not None else getattr(evt, "self_cuda_time_total", 0.0)
            name = next((n for n in names if n in evt.key), evt.key[:40])
            times[name] = times.get(name, 0.0) + us / 1e3 / iters
            if evt.count % iters:
                log(f"[profiler] CUPTI kept {evt.count} records of {name} over {iters} calls, "
                    "no multiple of the calls: records lost, its time reads low")
        if (names[0] in times) if names else sum(times.values()) > 0:
            return times
        log("[profiler] a profile recorded no device time"
            + (f" for {names[0]}" if names else "") + "; profiling again")
    return None
