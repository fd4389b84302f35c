"""Metrics-plane overhead A/B: serve-storm throughput with the live
metrics plane OFF vs ON.

Port of ``tools/metrics_ab.py``, with its flags, functions, records and
summary (plus ``--device``: ``cuda`` unless ``--device cpu`` is passed;
without a card ``cuda`` raises). The JAX package's bar for the metrics
plane (docs/observability.md "Live metrics") is <=2% throughput cost with
the publisher running; the tool reports it and asserts nothing. The ON arm
is the WHOLE plane at its real sites: a ``MetricsRegistry`` attached to
the server (per-request histogram records, per-bucket series, shed and
dispatch counters, snapshot-time gauges), a ``MetricsPublisher`` thread
polling it on a sub-second interval (JSONL time series, Prometheus
exposition and ``metrics_snapshot`` events to a live sink), and the
``SLOEvaluator`` burning every snapshot, against an OFF arm running the
identical storm with no registry. Both arms write the ordinary event
stream. The engine is ``serve_smoke.build_engine``'s tiny model on the one
device, warmed on the storm's one bucket before any window. Windows are
best-of-N and interleaved off/on, so ambient load drift hits both arms
alike.

Usage::

    python -m gnot_tpu_torch.tools.metrics_ab --n 400 --repeats 3 \
        --out build/metrics_overhead_ab.jsonl
    python -m gnot_tpu_torch.tools.metrics_ab --device cpu --n 40 --repeats 1

Emits one JSONL record per arm plus a summary record with
``overhead_frac``, to stdout and to ``--out`` when it is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from gnot_tpu_torch.tools.telemetry_ab import platform_name, write_records


def make_publisher(registry, sink, tmp: str, interval_s: float):
    """The plane's publisher over ``registry``: snapshots every
    ``interval_s`` into a series file, a Prometheus exposition and
    ``sink``, with the two SLOs JAX's A/Bs burn (shed fraction, breaker
    open)."""
    from gnot_tpu_torch.obs.metrics import MetricsPublisher, SLOEvaluator, SLOObjective

    return MetricsPublisher(
        registry,
        interval_s=interval_s,
        sink=sink,
        series_path=os.path.join(tmp, "series.jsonl"),
        exposition_path=os.path.join(tmp, "expo.prom"),
        evaluator=SLOEvaluator([
            SLOObjective("shed_fraction", "shed_frac", 0.05,
                         fast_window_s=0.5, slow_window_s=2.0),
            SLOObjective("breaker_open", "breaker_open", 1.0,
                         fast_window_s=0.5, slow_window_s=2.0),
        ]),
    )


def storm(server, traffic) -> float:
    """Submit every request, wait for every result (each must be ok);
    seconds from the first submit to the last result."""
    t0 = time.perf_counter()
    futures = [server.submit(s) for s in traffic]
    for f in futures:
        r = f.result(timeout=120)
        if not r.ok:
            raise RuntimeError(f"storm request failed: {r.reason}")
    return time.perf_counter() - t0


def _window(
    engine, traffic, *, on: bool, interval_s: float, max_batch: int
) -> tuple[float, dict]:
    """One timed storm window: submit -> all resolved, on a fresh
    server over the shared warm engine. Returns (seconds, info)."""
    from gnot_tpu_torch.obs.metrics import MetricsRegistry
    from gnot_tpu_torch.serve import InferenceServer
    from gnot_tpu_torch.utils.metrics import MetricsSink

    tmp = tempfile.mkdtemp(prefix="metrics_ab_")
    registry = publisher = None
    info: dict = {}
    # BOTH arms write the ordinary event stream (queue_depth per
    # dispatch, serve_summary at drain): the sink is the deployment's
    # baseline, not part of the metrics plane; the A/B isolates what the
    # registry, publisher and evaluator ADD on top of it.
    sink = MetricsSink(os.path.join(tmp, "events.jsonl"))
    if on:
        registry = MetricsRegistry()
        publisher = make_publisher(registry, sink, tmp, interval_s)
    server = InferenceServer(
        engine, max_batch=max_batch, max_wait_ms=2.0,
        queue_limit=4 * len(traffic), metrics=registry, sink=sink,
    ).start()
    if publisher is not None:
        publisher.start()
    seconds = storm(server, traffic)
    server.drain()
    if publisher is not None:
        info["snapshots"] = publisher.close()["seq"]
    sink.close()
    return seconds, info


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description="Serve-storm requests/s, metrics plane off against on.")
    p.add_argument("--n", type=int, default=400, help="requests per window")
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--interval_s", type=float, default=0.25,
                   help="publisher cadence in the ON arm")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs; cuda raises without a card")
    args = p.parse_args(argv)

    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.tools.serve_smoke import build_engine

    platform = platform_name(args.device)
    engine = build_engine(max_batch=args.max_batch, device=args.device)
    # Uniform darcy64 traffic: ONE bucket, warmed up front, so the
    # windows time dispatch and the metrics plane.
    traffic = datasets.synth_darcy2d(args.n, seed=0, grid_n=8)
    engine.warmup(traffic[: args.max_batch], rows=args.max_batch)

    best = {"off": float("inf"), "on": float("inf")}
    snapshots = 0
    for _ in range(max(1, args.repeats)):
        # Interleaved off/on: ambient load drift cancels across arms.
        sec_off, _ = _window(
            engine, traffic, on=False, interval_s=args.interval_s,
            max_batch=args.max_batch,
        )
        sec_on, info = _window(
            engine, traffic, on=True, interval_s=args.interval_s,
            max_batch=args.max_batch,
        )
        best["off"] = min(best["off"], sec_off)
        best["on"] = min(best["on"], sec_on)
        snapshots = max(snapshots, info.get("snapshots", 0))

    records = []
    for arm in ("off", "on"):
        records.append({
            "arm": f"metrics_{arm}",
            "requests": args.n,
            "seconds": round(best[arm], 4),
            "requests_per_s": round(args.n / best[arm], 2),
            "platform": platform,
            "max_batch": args.max_batch,
            "interval_s": args.interval_s,
            "repeats": args.repeats,
            **({"snapshots": snapshots} if arm == "on" else {}),
        })
    rps_off = records[0]["requests_per_s"]
    rps_on = records[1]["requests_per_s"]
    records.append({
        "summary": "metrics_overhead",
        "config": "darcy64_storm",
        "requests_per_s_off": rps_off,
        "requests_per_s_on": rps_on,
        "snapshots_on": snapshots,
        "overhead_frac": round(1.0 - rps_on / rps_off, 4),
        "bar": "overhead_frac <= 0.02 with the publisher running",
    })
    write_records(records, args.out)
    return records


if __name__ == "__main__":
    main()
