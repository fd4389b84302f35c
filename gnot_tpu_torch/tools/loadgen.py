"""Shared open-loop load-trace generation for the serving benches.

Port of ``tools/loadgen.py``, the port's own copy (no module of the port
imports the repo's ``tools/``): every function gives bitwise the same
times as its twin from the same arguments and seed (the same numpy
``default_rng`` draws in the same order). It produces the full arrival
schedule up front (seeded, replayable: both arms of an A/B submit at
identical instants) and replays it open-loop (submissions happen on
schedule whether or not the pool keeps up; the backlog is the
measurement, never the throttle).

Rate shapes (``trace_times``):

* ``steady``: homogeneous Poisson at ``base_rps`` (``serve_bench``'s
  arrival process).
* ``diurnal``: one sinusoidal "day" over the window: the rate ramps from
  ``base_rps`` up to ``peak_mult * base_rps`` at mid-window and back (the
  autoscaling workload: a fixed pool either sheds at the peak or idles at
  the edges).
* ``bursty``: ``bursts`` evenly spaced square bursts of ``burst_mult *
  base_rps``, each ``burst_frac`` of the window wide.
* ``diurnal_bursty``: the product of the two, bursts riding the diurnal
  ramp (``autoscale_ab``'s trace).

Inhomogeneous arrivals are drawn by thinning (Lewis & Shedler): a
homogeneous Poisson stream at the peak rate, each point kept with
probability ``rate(t) / rate_max``, exact for any bounded rate function
and deterministic under the seed.

Multi-tenant traces (``multi_stream_times``): N independent seeded
streams, one per tenant, each its own pattern and rate, merged into one
interleaved ``[(offset, tenant)]`` schedule. Each stream derives its seed
from the master seed and its position, so the composite is deterministic
and one tenant's shape change never perturbs a sibling's arrivals
(``tenant_ab``).

Numpy and the standard library only.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import numpy as np

PATTERNS = ("steady", "diurnal", "bursty", "diurnal_bursty")


def rate_fn(
    pattern: str,
    *,
    base_rps: float,
    duration_s: float,
    peak_mult: float = 3.0,
    bursts: int = 2,
    burst_mult: float = 3.0,
    burst_frac: float = 0.08,
) -> tuple[Callable[[float], float], float]:
    """``(rate(t), rate_max)`` for one named pattern over the window.
    ``rate_max`` is the exact least upper bound the thinning loop
    samples at."""
    if pattern not in PATTERNS:
        raise ValueError(f"unknown pattern {pattern!r}; one of {PATTERNS}")
    if base_rps <= 0 or duration_s <= 0:
        raise ValueError("base_rps and duration_s must be > 0")
    if peak_mult < 1.0 or burst_mult < 1.0:
        raise ValueError("peak_mult and burst_mult must be >= 1")
    if not 0 < burst_frac < 1:
        raise ValueError(f"burst_frac must be in (0, 1), got {burst_frac}")

    def diurnal(t: float) -> float:
        # sin^2 ramp: base at the edges, base*peak_mult at mid-window.
        s = math.sin(math.pi * t / duration_s)
        return 1.0 + (peak_mult - 1.0) * s * s

    def burst(t: float) -> float:
        # `bursts` square windows centered at (k + 0.5) / bursts.
        if bursts < 1:
            return 1.0
        width = burst_frac * duration_s
        for k in range(bursts):
            center = (k + 0.5) / bursts * duration_s
            if abs(t - center) <= width / 2:
                return burst_mult
        return 1.0

    if pattern == "steady":
        return (lambda t: base_rps), base_rps
    if pattern == "diurnal":
        return (lambda t: base_rps * diurnal(t)), base_rps * peak_mult
    if pattern == "bursty":
        return (lambda t: base_rps * burst(t)), base_rps * burst_mult
    return (
        lambda t: base_rps * diurnal(t) * burst(t)
    ), base_rps * peak_mult * burst_mult


def trace_times(
    pattern: str,
    *,
    base_rps: float,
    duration_s: float,
    seed: int = 0,
    **shape,
) -> list[float]:
    """The full arrival schedule: sorted offsets (seconds from t0) of
    one seeded open-loop trace. Same pattern + seed => identical trace,
    so A/B arms submit at the same instants."""
    rate, rate_max = rate_fn(
        pattern, base_rps=base_rps, duration_s=duration_s, **shape
    )
    rng = np.random.default_rng(seed)
    times: list[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate_max))
        if t >= duration_s:
            return times
        # Thinning: always consume one uniform per candidate so the
        # kept-point stream is a deterministic function of the seed.
        if float(rng.uniform()) * rate_max <= rate(t):
            times.append(t)


def multi_stream_times(
    streams: dict[str, dict],
    *,
    duration_s: float,
    seed: int = 0,
) -> list[tuple[float, str]]:
    """Compose N independent per-tenant traces into ONE interleaved
    open-loop schedule: ``[(offset_s, tenant), ...]`` sorted by offset.

    ``streams`` maps tenant name -> that tenant's ``trace_times``
    kwargs (``pattern``, ``base_rps``, plus any shape kwargs; an
    optional per-stream ``seed`` overrides the derived one). Each
    stream is seeded independently and deterministically —
    ``seed + stream index in insertion order`` — so one tenant's shape
    change never perturbs a sibling's arrivals, and the same
    (streams, duration, seed) always yields the identical interleaved
    schedule (the tenant A/B's shared-trace requirement: both arms
    replay the same storm). Ties break by (offset, tenant) — stable
    and replayable.
    """
    if not streams:
        raise ValueError("multi_stream_times needs at least one stream")
    merged: list[tuple[float, str]] = []
    for i, (tenant, spec) in enumerate(streams.items()):
        kw = dict(spec)
        stream_seed = kw.pop("seed", seed + i)
        pattern = kw.pop("pattern")
        times = trace_times(
            pattern, duration_s=duration_s, seed=stream_seed, **kw
        )
        merged.extend((t, tenant) for t in times)
    merged.sort(key=lambda e: (e[0], e[1]))
    return merged


def replay(
    submit: Callable[[int], object],
    times: list[float],
    *,
    clock: Callable[[], float] = time.perf_counter,
    sleep: Callable[[float], None] = time.sleep,
) -> list[object]:
    """Open-loop replay: call ``submit(i)`` at each scheduled offset.
    Behind schedule? Submit immediately — the generator never waits for
    the pool (queueing collapse must be observable, not hidden).
    Returns the submit results in arrival order."""
    out: list[object] = []
    t0 = clock()
    for i, at in enumerate(times):
        lag = at - (clock() - t0)
        if lag > 0:
            sleep(lag)
        out.append(submit(i))
    return out


def ramp_split(times: list[float], duration_s: float) -> int:
    """Index of the first arrival past mid-window — everything before
    it rode the diurnal UP-ramp (the autoscale A/B's zero-shed bar is
    scoped to this prefix)."""
    half = duration_s / 2.0
    for i, t in enumerate(times):
        if t > half:
            return i
    return len(times)
