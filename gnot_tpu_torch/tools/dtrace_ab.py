"""Distributed-tracing overhead A/B: federated request latency with the
cluster tracing plane OFF vs ON.

Port of ``tools/dtrace_ab.py``, with its flags, functions, records and
summary (plus ``--device``: ``cuda`` unless ``--device cpu`` is passed;
without a card ``cuda`` raises). The JAX package's bar for the
distributed-tracing subsystem (docs/observability.md "Distributed
tracing") is <=2% per-request regression at the default sample rate (1.0,
every request traced) WITH the flight recorder armed on every host; the
tool reports it and asserts nothing. The ON arm runs the plane end to
end: a cluster ``Tracer`` deciding head sampling, the ``trace_ctx`` wire
field on every placement, per-host tracers adopting the decision, per-host
``FlightRecorder`` rings shadow-recording every span, and the drain-time
``trace_pull`` stitch and merged-file write (OUTSIDE the timed windows: a
drain cost, not a steady-state one). Both hosts' replicas share the one
device, each replica on its own CUDA stream there (JAX places host ``h``
on ``devs[h % len(devs)]``, which on one device is the same sharing).
Windows are best-of-N and interleaved off/on, so ambient load drift hits
both arms alike.

Usage::

    python -m gnot_tpu_torch.tools.dtrace_ab --n 32 --repeats 3 \
        --out build/dtrace_overhead_ab.jsonl
    python -m gnot_tpu_torch.tools.dtrace_ab --device cpu --n 8 --repeats 1

Emits one JSONL record per arm plus a summary record with
``overhead_frac``, to stdout and to ``--out`` when it is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from gnot_tpu_torch.tools.telemetry_ab import MICRO_ARCH, platform_name, write_records

BATCH = 2


def build_federation(tmp: str, traced: bool, device: str = "cuda"):
    """One 2-host in-proc federation over micro-bench darcy replicas; the
    ``traced`` arm gets the full plane (cluster tracer at rate 1.0,
    per-host adopters, flight recorders on every ring). Returns
    ``(cluster, agents, sink, samples)`` with the routers started and
    every replica warmed."""
    import torch

    from gnot_tpu_torch.config import ModelConfig
    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.device import resolve_device
    from gnot_tpu_torch.models.gnot import GNOT
    from gnot_tpu_torch.serve.federation import build_local_federation
    from gnot_tpu_torch.serve.replica import build_replica
    from gnot_tpu_torch.utils.metrics import MetricsSink

    # The micro-bench architecture (tracing_ab's): the plane's absolute
    # cost is a fixed amount of host work per request, and a toy model
    # would make it look like a share no real deployment resembles.
    dev = resolve_device(device)
    samples = datasets.synth_darcy2d(8, seed=0, grid_n=16)
    mc = ModelConfig(**MICRO_ARCH, **datasets.infer_model_dims(samples))
    model = GNOT(mc, generator=torch.Generator().manual_seed(0)).to(dev)
    groups = [[build_replica(model, 0, dev, batch_size=BATCH)] for _ in range(2)]
    sink = MetricsSink(os.path.join(tmp, "ab.jsonl"))
    kw = {}
    if traced:
        from gnot_tpu_torch.obs import dtrace
        from gnot_tpu_torch.obs.tracing import Tracer

        recorders = {
            h: dtrace.FlightRecorder(tmp, window_s=30.0, host=h)
            for h in ("controller", "host0", "host1")
        }
        kw = dict(
            cluster_tracer=Tracer(sample_rate=1.0, recorder=recorders["controller"]),
            tracer_factory=lambda h: Tracer(recorder=recorders[h]),
            trace_path=os.path.join(tmp, "ab_trace.json"),
            recorders=recorders,
        )
    cluster, agents = build_local_federation(
        groups, sink=sink,
        router_kwargs=dict(max_batch=BATCH, max_wait_ms=2.0),
        **kw,
    )
    for a in agents.values():
        a.router.start()
    for g in groups:
        for r in g:
            r.warm(samples[:BATCH], rows=BATCH)
    return cluster, agents, sink, samples


def _window(cluster, samples, n: int) -> float:
    """One timed storm of ``n`` one-shots, submit to last resolution;
    seconds per request. A warm-up request runs outside the window."""
    cluster.submit(samples[0]).result(timeout=60)
    t0 = time.perf_counter()
    futs = [cluster.submit(samples[i % len(samples)]) for i in range(n)]
    for f in futs:
        r = f.result(timeout=60)
        if not r.ok:
            raise RuntimeError(f"federated request failed: {r.reason}")
    return (time.perf_counter() - t0) / n


def time_ab(n: int, repeats: int, device: str = "cuda") -> tuple[float, float]:
    """Best-of-``repeats`` seconds/request for (off, on), windows
    interleaved off/on so ambient load drift cancels. Both federations
    are built (and warmed) before any window is timed."""
    fed_off = build_federation(tempfile.mkdtemp(), traced=False, device=device)
    fed_on = build_federation(tempfile.mkdtemp(), traced=True, device=device)
    best_off = best_on = float("inf")
    try:
        for _ in range(max(1, repeats)):
            best_off = min(best_off, _window(fed_off[0], fed_off[3], n))
            best_on = min(best_on, _window(fed_on[0], fed_on[3], n))
    finally:
        for cluster, agents, sink, _ in (fed_off, fed_on):
            with sink:
                cluster.drain()
            for a in agents.values():
                a.stop()
            cluster.close()
    return best_off, best_on


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        description="Federated ms per request, cluster tracing off against on.")
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where both hosts' replicas run; cuda raises without a card")
    args = p.parse_args(argv)

    platform = platform_name(args.device)
    sec_off, sec_on = time_ab(args.n, args.repeats, args.device)
    records = []
    for arm, sec in (("dtrace_off", sec_off), ("dtrace_on", sec_on)):
        records.append({
            "arm": arm, "ms_per_request": round(sec * 1e3, 4),
            "platform": platform, "hosts": 2, "n": args.n,
            "sample_rate": 1.0, "flight_recorder_s": 30.0,
            "repeats": args.repeats,
        })
    off, on = records[0]["ms_per_request"], records[1]["ms_per_request"]
    records.append({
        "summary": "dtrace_overhead", "config": "darcy2d_micro_2host",
        "ms_per_request_off": off, "ms_per_request_on": on,
        "overhead_frac": round(on / off - 1.0, 4),
        "bar": "overhead_frac < 0.02 with propagation + flight recorder "
               "on at sample_rate=1.0",
    })
    write_records(records, args.out)
    return records


if __name__ == "__main__":
    main()
