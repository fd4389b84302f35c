"""Program-catalog overhead A/B: serve-storm throughput with the catalog
and its per-dispatch attribution OFF vs ON.

Port of ``tools/capacity_ab.py``, with its flags, functions, records and
summary (plus ``--device``: ``cuda`` unless ``--device cpu`` is passed;
without a card ``cuda`` raises). The JAX package's bar for the capacity
plane (docs/observability.md "Program costs & capacity") is <=2%
throughput cost; the tool reports it, and asserts only that the ON arm
attributed dispatches. BOTH arms run the full live metrics plane
(registry, publisher, SLO evaluator, event sink: ``metrics_ab``'s), so
the A/B isolates what the catalog ADDS on its hot path: the per-dispatch
program-key stamp in the engine, the ``note_dispatch`` attribution
(traffic ledger, per-program counters, histograms and gauges in the
registry) and the dispatch-provenance check. Cost capture stays outside
the timed windows: the port counts a program's costs at its first
dispatch (``obs/costs.py``), which the warm-up makes here as a
deployment's startup does, and each window's catalog is pre-populated
with those entries.

Windows are interleaved off/on, GC held off inside every timed window
(both arms), and each arm reports the interquartile mean of its windows.

Usage::

    python -m gnot_tpu_torch.tools.capacity_ab --n 400 --repeats 3 \
        --out build/capacity_overhead_ab.jsonl
    python -m gnot_tpu_torch.tools.capacity_ab --device cpu --n 40 --repeats 1

Emits one JSONL record per arm plus a summary record with
``overhead_frac``, to stdout and to ``--out`` when it is given.
"""

from __future__ import annotations

import argparse
import gc
import os
import tempfile

from gnot_tpu_torch.tools.metrics_ab import make_publisher, storm
from gnot_tpu_torch.tools.telemetry_ab import platform_name, write_records


def _window(
    engine, traffic, warm_catalog, *, on: bool, interval_s: float,
    max_batch: int
) -> tuple[float, dict]:
    """One timed storm window: submit -> all resolved, on a fresh
    server over the shared warm engine. Returns (seconds, info)."""
    from gnot_tpu_torch.obs.metrics import MetricsRegistry
    from gnot_tpu_torch.serve import InferenceServer
    from gnot_tpu_torch.serve.catalog import ProgramCatalog
    from gnot_tpu_torch.utils.metrics import MetricsSink

    tmp = tempfile.mkdtemp(prefix="capacity_ab_")
    info: dict = {}
    sink = MetricsSink(os.path.join(tmp, "events.jsonl"))
    registry = MetricsRegistry()
    publisher = make_publisher(registry, sink, tmp, interval_s)
    catalog = None
    if on:
        # A fresh catalog for the window, bound to its registry and sink,
        # PRE-POPULATED with the warm-up's cost entries: a warm
        # deployment's steady state, so the window times attribution.
        catalog = ProgramCatalog(metrics=registry, sink=sink)
        for key, entry in warm_catalog.entries().items():
            catalog.record(key, entry["costs"], source=entry["source"])
    engine.attach_catalog(catalog)
    try:
        server = InferenceServer(
            engine, max_batch=max_batch, max_wait_ms=2.0,
            queue_limit=4 * len(traffic), metrics=registry, sink=sink,
            catalog=catalog,
        ).start()
        publisher.start()
        # GC parity: a collection pause landing inside one arm's window
        # is the dominant noise term at these window lengths; collect up
        # front and hold GC off for the timed region of BOTH arms.
        gc.collect()
        gc.disable()
        try:
            seconds = storm(server, traffic)
        finally:
            gc.enable()
        summary = server.drain()
        info["snapshots"] = publisher.close()["seq"]
        if on:
            model = summary.get("capacity_model") or {}
            pool = model.get("pool") or {}
            if not pool.get("dispatches", 0) > 0:
                raise RuntimeError(
                    "ON arm attributed no dispatches: the A/B measured nothing")
            info["attributed_dispatches"] = pool["dispatches"]
        sink.close()
    finally:
        engine.attach_catalog(None)
    return seconds, info


def iq_mean(xs: list[float]) -> float:
    """Interquartile mean: the top and bottom quarter trimmed, the middle
    averaged (all of ``xs`` when fewer than four)."""
    xs = sorted(xs)
    k = len(xs) // 4
    mid = xs[k : len(xs) - k] or xs
    return sum(mid) / len(mid)


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        description="Serve-storm requests/s, catalog attribution off against on.")
    p.add_argument("--n", type=int, default=400, help="requests per window")
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--interval_s", type=float, default=0.25,
                   help="publisher cadence (both arms)")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs; cuda raises without a card")
    args = p.parse_args(argv)

    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.serve.catalog import ProgramCatalog
    from gnot_tpu_torch.tools.serve_smoke import build_engine

    platform = platform_name(args.device)
    engine = build_engine(max_batch=args.max_batch, device=args.device)
    # Uniform darcy64 traffic: ONE bucket, warmed up front; the cost
    # capture rides the warm-up, like a real deployment's startup.
    traffic = datasets.synth_darcy2d(args.n, seed=0, grid_n=8)
    warm_catalog = ProgramCatalog()
    engine.attach_catalog(warm_catalog)
    engine.warmup(traffic[: args.max_batch], rows=args.max_batch)
    engine.attach_catalog(None)
    if not warm_catalog.entries():
        raise RuntimeError("warmup captured no catalog entries")

    times: dict[str, list[float]] = {"off": [], "on": []}
    snapshots = attributed = 0
    for _ in range(max(1, args.repeats)):
        # Interleaved off/on: ambient load drift cancels across arms.
        sec_off, _ = _window(
            engine, traffic, warm_catalog, on=False,
            interval_s=args.interval_s, max_batch=args.max_batch,
        )
        sec_on, info = _window(
            engine, traffic, warm_catalog, on=True,
            interval_s=args.interval_s, max_batch=args.max_batch,
        )
        times["off"].append(sec_off)
        times["on"].append(sec_on)
        snapshots = max(snapshots, info.get("snapshots", 0))
        attributed = max(attributed, info.get("attributed_dispatches", 0))

    # Interquartile mean per arm, NOT best-of: window times are
    # burst-noisy with equal means but unequal spread across arms, and a
    # min estimator flatters whichever arm has the fatter fast tail.
    records = []
    for arm in ("off", "on"):
        sec = iq_mean(times[arm])
        records.append({
            "arm": f"capacity_{arm}",
            "requests": args.n,
            "seconds": round(sec, 4),
            "seconds_min": round(min(times[arm]), 4),
            "windows": len(times[arm]),
            "requests_per_s": round(args.n / sec, 2),
            "platform": platform,
            "max_batch": args.max_batch,
            "interval_s": args.interval_s,
            "repeats": args.repeats,
            **(
                {
                    "snapshots": snapshots,
                    "attributed_dispatches": attributed,
                    "programs": len(warm_catalog.entries()),
                }
                if arm == "on"
                else {}
            ),
        })
    rps_off = records[0]["requests_per_s"]
    rps_on = records[1]["requests_per_s"]
    records.append({
        "summary": "capacity_overhead",
        "config": "darcy64_storm",
        "requests_per_s_off": rps_off,
        "requests_per_s_on": rps_on,
        "snapshots_on": snapshots,
        "attributed_dispatches": attributed,
        "overhead_frac": round(1.0 - rps_on / rps_off, 4),
        "bar": "overhead_frac <= 0.02 with catalog attribution live",
    })
    write_records(records, args.out)
    return records


if __name__ == "__main__":
    main()
