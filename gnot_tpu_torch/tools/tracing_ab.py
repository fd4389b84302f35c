"""Tracing-overhead A/B: train step time with span tracing OFF vs ON.

Port of ``tools/tracing_ab.py``, with its flags, functions, records and
summary (plus ``--device``: ``cuda`` unless ``--device cpu`` is passed;
without a card ``cuda`` raises). The JAX package's bar for the tracing
subsystem (docs/observability.md "Tracing") is <=2% step-time regression
at the default sample rate (1.0, every step traced) on the ns2d
micro-bench; the tool reports it and asserts nothing. The ON arm runs the
trainer's own span sites (``Trainer._run_single``): ``Tracer.timed_iter``
over the batch iterator (one ``data_iter`` span a pull) and a ``step``
span around ``host_to_device`` (``Trainer._device_batch``, the host batch
copied to the device) and ``step_dispatch`` (the trainer's step) children,
one trace for the whole window, against a live ``Tracer`` with a real
output path; the final flush (the Chrome-JSON write) is INSIDE the timed
window. The OFF arm runs the same two calls with no span. Windows are
best-of-N and interleaved off/on, each from the trainer's start state
(``telemetry_ab.restorer``) after one warm-up step, ending in a hard fetch.

Usage::

    python -m gnot_tpu_torch.tools.tracing_ab --steps 60 --repeats 3 \
        --out build/tracing_overhead_ab.jsonl
    python -m gnot_tpu_torch.tools.tracing_ab --device cpu --n_points 64 --steps 2

Emits one JSONL record per arm plus a summary record with
``overhead_frac``, to stdout and to ``--out`` when it is given.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

from gnot_tpu_torch.tools.telemetry_ab import (
    hard_fetch,
    platform_name,
    restorer,
    write_records,
)
from gnot_tpu_torch.tools.telemetry_ab import build as _build


def device_step(state, device_batch, lr):
    """The trainer's step on a batch already on the device
    (``Trainer._step``): ``(state, loss)``. ``_window`` moves the batch
    itself, inside the ``host_to_device`` span, as the trainer does."""
    return state, state._step(device_batch, lr)


def build(n_points: int, batch_size: int, *, device: str = "cuda"):
    """``(device_step, state, batch)``: ``telemetry_ab.build``'s
    micro-bench trainer and host batch."""
    _, state, batch = _build(False, n_points, batch_size, device=device)
    return device_step, state, batch


def _window(step, state0, batch, traced: bool, steps: int, sample_rate: float,
            copy_tree, lr) -> float:
    """One timed window of ``steps`` steps; the ON arm runs the trainer's
    span sites plus the end-of-window flush. ``copy_tree(state0)``
    (``telemetry_ab.restorer``) and the warm-up step run outside the
    window. Returns seconds a step."""
    from gnot_tpu_torch.obs.tracing import Tracer

    state = copy_tree(state0)
    tracer = trace = None
    if traced:
        tracer = Tracer(
            path=os.path.join(tempfile.mkdtemp(), "tracing_ab_trace.json"),
            sample_rate=sample_rate,
        )
        trace = tracer.start_trace()

    def tspan(name, **args):
        if trace is None:
            return contextlib.nullcontext()
        return tracer.span(name, trace=trace, args=args or None)

    def one(state, i, b):
        with tspan("step", step=i):
            with tspan("host_to_device"):
                db = state._device_batch(b)  # Trainer._device_batch
            with tspan("step_dispatch"):
                state, loss = step(state, db, lr)
        return state, loss

    def batch_iter(n):
        # The trainer wraps its loader in Tracer.timed_iter: the same
        # data_iter span site here, over the same repeated batch.
        it = iter([batch] * n)
        if trace is not None:
            return tracer.timed_iter(it, "data_iter", trace=trace)
        return it

    state, loss = one(state, 0, batch)
    hard_fetch(state, loss)
    t0 = time.perf_counter()
    for i, b in enumerate(batch_iter(steps), start=1):
        state, loss = one(state, i, b)
    if tracer is not None:
        tracer.flush()
    hard_fetch(state, loss)  # the window ends when the card does
    return (time.perf_counter() - t0) / steps


def time_ab(n_points: int, batch_size: int, steps: int, sample_rate: float,
            repeats: int, device: str = "cuda") -> tuple[float, float]:
    """Best-of-``repeats`` seconds/step for (off, on), timed windows
    interleaved off/on so ambient load drift cancels (the
    ``telemetry_ab`` methodology). Both arms run one trainer."""
    step, state, batch = build(n_points, batch_size, device=device)
    copy_tree = restorer(state)
    lr = 1e-3
    best_off = best_on = float("inf")
    for _ in range(max(1, repeats)):
        best_off = min(
            best_off,
            _window(step, state, batch, False, steps, sample_rate, copy_tree, lr),
        )
        best_on = min(
            best_on,
            _window(step, state, batch, True, steps, sample_rate, copy_tree, lr),
        )
    return best_off, best_on


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description="Train step ms, span tracing off against on.")
    p.add_argument("--n_points", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--sample_rate", type=float, default=1.0)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where both arms run; cuda raises without a card")
    args = p.parse_args(argv)

    platform = platform_name(args.device)
    sec_off, sec_on = time_ab(
        args.n_points, args.batch_size, args.steps, args.sample_rate,
        args.repeats, args.device,
    )
    records = []
    for arm, sec in (("tracing_off", sec_off), ("tracing_on", sec_on)):
        records.append({
            "arm": arm, "ms_per_step": round(sec * 1e3, 4),
            "platform": platform, "n_points": args.n_points,
            "batch_size": args.batch_size, "steps": args.steps,
            "sample_rate": args.sample_rate, "repeats": args.repeats,
        })
    off, on = records[0]["ms_per_step"], records[1]["ms_per_step"]
    records.append({
        "summary": "tracing_overhead", "config": "ns2d_micro",
        "ms_per_step_off": off, "ms_per_step_on": on,
        "overhead_frac": round(on / off - 1.0, 4),
        "bar": "overhead_frac < 0.02 at the default sample_rate=1.0",
    })
    write_records(records, args.out)
    return records


if __name__ == "__main__":
    main()
