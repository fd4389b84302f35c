"""Open-loop serving load bench: 1 vs N engine replicas.

Port of ``tools/serve_bench.py``, with its flags, defaults, functions
(``make_replicas``, ``fresh_router``, ``run_arm``, ``numerics_check``,
``run``, ``main``), records, summary and exit rule (plus ``--device``:
``cuda`` unless ``--device cpu`` is passed; without a card ``cuda``
raises). Closed-loop benches (submit, wait, repeat) hide queueing
collapse: the bench slows down with the server and never observes
overload. This one is OPEN-LOOP: request arrivals are a Poisson process
at a configured offered load (``loadgen``'s seeded ``steady`` trace),
submitted on schedule whether or not the pool keeps up, so sustained
requests/s and p50 / p99 against offered load mean what they say.

Method (interleaved arms, one offered-load ladder shared by both):

1. Time one warmed dispatch (``dispatch_seconds``) to estimate the
   single-replica capacity ``max_batch / dispatch_s``; the ladder is
   fractions and multiples of it.
2. For each offered load, run the 1-replica arm then the N-replica arm
   (same traffic, same seed, same duration). Each arm is a
   ``ReplicaRouter`` over ``build_replicas`` engines; the arms differ ONLY
   in replica count, and N=1 pays the same router overhead.
3. A run SUSTAINS its load when shed_frac <= ``--max_shed_frac`` and p99
   <= ``--slo_p99_ms``; per arm, sustained rps is the best achieved rps
   over sustaining runs (both arms held to the same p99 SLO).
4. Numerics: every distinct traffic sample is replayed through the
   N-replica pool at idle and through a solo engine; the summary records
   the max per-request |replicated - solo|.

Where the port differs from JAX:

* Devices. JAX gives replica ``i`` device ``i`` and forces host devices
  and one intra-op thread each through ``XLA_FLAGS`` (``_ensure_xla_flags``,
  dropped). The port puts every replica on the one card, each on its own
  CUDA stream (``serve/replica.py``), and keeps the replica counts. The
  summary's ``bar_speedup`` (2.5x) is a bar for N devices: on one card the
  replicas share the device and the host's GIL, so ``main``'s exit rule,
  JAX's, fails there unless the pool scales that far.
* Warm-up. JAX counts persistent-compile-cache hits and misses around the
  warm-up (``compile_cache_probe``) and enables the cache; eager PyTorch
  has neither, so the warm stats keep the probe's keys with None values,
  as JAX writes them when its counters are missing, and the records'
  ``warm_cache_hits`` / ``warm_cache_misses`` are None.

With ``--trace_path`` the heaviest sustained N-replica run is traced and
the per-replica queue-against-device breakdown (``trace_report``) printed.

Usage::

    python -m gnot_tpu_torch.tools.serve_bench --replicas 4 --out build/serve_bench.jsonl
    python -m gnot_tpu_torch.tools.serve_bench --device cpu --quick --out build/serve_bench.jsonl

Writes JSONL (one record per run and one summary) to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from gnot_tpu_torch.tools import loadgen

#: ``compile_cache_probe``'s keys, which eager PyTorch has no values for.
WARM_CACHE_KEYS = ("dir", "entries_before", "entries_after", "requests", "hits", "misses")


def make_replicas(model, n_replicas, *, max_batch, traffic, dtype="float32"):
    """N warmed replicas of ``model``'s weights on its device, each on its
    own stream there (the arms differ ONLY in replica count). Callers build
    replicas once per arm and put a FRESH router over them per run.
    ``dtype`` is the serving compute dtype (the low-precision A/B's arms
    differ only in it). Returns (replicas, warm_stats)."""
    from gnot_tpu_torch.serve import build_replicas

    replicas = build_replicas(model, n_replicas, batch_size=max_batch, dtype=dtype)
    warmed = sum(r.warm(traffic, rows=max_batch) for r in replicas)
    return replicas, {"programs_warmed": warmed, **dict.fromkeys(WARM_CACHE_KEYS)}


def fresh_router(replicas, *, max_batch, queue_limit=256, max_wait_ms=4.0,
                 sink=None, tracer=None):
    """A new router over already-warm replicas (routers drain once;
    engines are reusable)."""
    from gnot_tpu_torch.serve import ReplicaRouter

    return ReplicaRouter(
        replicas,
        max_batch=max_batch,
        max_wait_ms=max_wait_ms,
        queue_limit=queue_limit,
        sink=sink,
        tracer=tracer,
    )


def run_arm(router, traffic, *, offered_rps, duration_s, seed) -> dict:
    """One open-loop run: Poisson arrivals at ``offered_rps`` for
    ``duration_s`` (``loadgen``'s seeded ``steady`` trace, so arms replay
    identical schedules), submitted on schedule (never throttled by
    responses), then wait for every future and drain."""
    times = loadgen.trace_times(
        "steady", base_rps=offered_rps, duration_s=duration_s, seed=seed
    )
    router.start()
    t0 = time.perf_counter()
    futures = loadgen.replay(
        lambda i: router.submit(traffic[i % len(traffic)]), times
    )
    results = [f.result(timeout=300) for f in futures]
    last_done = time.perf_counter()
    summary = router.drain()
    elapsed = last_done - t0
    completed = sum(r.ok for r in results)
    shed = summary["shed"]
    return {
        "offered_rps": offered_rps,
        "duration_s": round(duration_s, 3),
        "submitted": len(futures),
        "completed": completed,
        "shed": shed,
        "shed_frac": (
            round(sum(shed.values()) / len(futures), 4) if futures else 0.0
        ),
        "achieved_rps": round(completed / elapsed, 2) if elapsed > 0 else None,
        "p50_ms": (
            round(summary["latency_p50_ms"], 2)
            if summary["latency_p50_ms"] is not None
            else None
        ),
        "p99_ms": (
            round(summary["latency_p99_ms"], 2)
            if summary["latency_p99_ms"] is not None
            else None
        ),
        "dispatches": summary["dispatches"],
        "compiled_shapes": summary["compiled_shapes"],
        "spills": summary["routing"]["spills"],
    }


def numerics_check(model, replicas, traffic, *, max_batch) -> float:
    """Max per-request |replicated - solo| over the distinct traffic set:
    every request replayed through an idle N-replica pool AND a plain solo
    engine over ``model`` itself. The replicated-vs-solo acceptance
    number."""
    from gnot_tpu_torch.serve import InferenceEngine

    router = fresh_router(replicas, max_batch=max_batch)
    router.start()
    futs = [router.submit(s) for s in traffic]
    results = [f.result(timeout=120) for f in futs]
    router.drain()
    solo = InferenceEngine(model, batch_size=max_batch)
    solo.warmup(traffic, rows=max_batch)
    worst = 0.0
    for s, r in zip(traffic, results):
        assert r.ok, f"numerics replay shed a request: {r.reason}"
        key = solo.bucket_key(s)
        ref = solo.infer(
            [s], pad_nodes=key[0], pad_funcs=key[1], rows=max_batch
        )[0]
        worst = max(worst, float(np.max(np.abs(ref - r.output))))
    return worst


def dispatch_seconds(model, traffic, *, max_batch) -> float:
    """The capacity probe: one warmed solo engine, the median over 3
    rounds of one dispatch's seconds (8 single-request dispatches a round,
    each ending in its output's copy to the host)."""
    from gnot_tpu_torch.serve import InferenceEngine

    probe = InferenceEngine(model, batch_size=max_batch)
    probe.warmup(traffic, rows=max_batch)
    keys = [probe.bucket_key(s) for s in traffic]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for s, k in zip(traffic[:8], keys[:8]):
            probe.infer([s], pad_nodes=k[0], pad_funcs=k[1], rows=max_batch)
        times.append((time.perf_counter() - t0) / 8)
    return float(np.median(times))


def auto_slo_ms(dispatch_s: float, mult: float = 12.0) -> float:
    """The automatic p99 SLO (``--slo_p99_ms 0``): ``mult`` x one measured
    solo dispatch, in ms (12x here; ``lowprec_ab`` takes 15x)."""
    return round(mult * dispatch_s * 1e3, 1)


def sustained(records, *, slo_p99_ms, max_shed_frac):
    """The run of ``records`` (one arm's) with the best achieved rps among
    those that SUSTAIN their load: shed_frac <= ``max_shed_frac`` and p99
    <= ``slo_p99_ms``; None when none does."""
    ok = [
        r for r in records
        if r["shed_frac"] <= max_shed_frac
        and r["p99_ms"] is not None
        and r["p99_ms"] <= slo_p99_ms
    ]
    return max(ok, key=lambda r: r["achieved_rps"], default=None)


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Open-loop serving load: 1 against N replicas.")
    p.add_argument("--replicas", type=int, default=4,
                   help="N for the N-replica arm (vs the 1-replica arm)")
    p.add_argument("--n_traffic", type=int, default=16,
                   help="distinct request samples cycled by the arrival "
                        "process (mixed Darcy64 + ragged buckets)")
    p.add_argument("--mesh_lo", type=int, default=600)
    p.add_argument("--mesh_hi", type=int, default=1000)
    p.add_argument("--hidden", type=int, default=96)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--queue_limit", type=int, default=256)
    p.add_argument("--duration_s", type=float, default=6.0,
                   help="open-loop window per run")
    p.add_argument("--loads", type=str, default="0.5,0.8,1.2,2.0,2.6,3.2",
                   help="offered-load ladder as multiples of the "
                        "measured single-replica dispatch capacity")
    p.add_argument("--slo_p99_ms", type=float, default=0.0,
                   help="p99 SLO a run must meet to count as sustained "
                        "(0 = auto: 12x the measured solo dispatch time)")
    p.add_argument("--max_shed_frac", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="",
                   help="JSONL output path")
    p.add_argument("--trace_path", type=str, default="",
                   help="trace the heaviest N-replica run and print the "
                        "per-replica breakdown (trace_report)")
    p.add_argument("--quick", action="store_true",
                   help="tiny ladder + short windows (CI smoke)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where every replica runs; cuda raises without a card")
    args = p.parse_args(argv)
    if args.quick:
        args.duration_s = min(args.duration_s, 2.0)
        args.loads = "0.6,2.4"

    from gnot_tpu_torch.tools import serve_smoke

    model = _build_model(args)
    traffic = serve_smoke.mixed_traffic(
        args.n_traffic, seed=args.seed, mesh_lo=args.mesh_lo,
        mesh_hi=args.mesh_hi,
    )

    dispatch_s = dispatch_seconds(model, traffic, max_batch=args.max_batch)
    cap1 = args.max_batch / dispatch_s
    slo = args.slo_p99_ms or auto_slo_ms(dispatch_s)
    print(
        f"serve_bench: dispatch {dispatch_s * 1e3:.1f} ms -> est. "
        f"1-replica capacity {cap1:.0f} req/s, p99 SLO {slo} ms"
    )

    loads = [float(x) for x in args.loads.split(",")]
    records: list[dict] = []
    # Build and warm each arm's replicas ONCE; each run gets a fresh
    # router over the same warm engines.
    pools = {}
    for n in (1, args.replicas):
        pools[n] = make_replicas(
            model, n, max_batch=args.max_batch, traffic=traffic
        )
        warm = pools[n][1]
        print(
            f"  warmed n={n}: {warm['programs_warmed']} programs, "
            f"cache hits={warm.get('hits')} misses={warm.get('misses')}"
        )
    for li, mult in enumerate(loads):
        offered = mult * cap1
        for n in (1, args.replicas):  # interleaved arms per load
            replicas_n, warm = pools[n]
            router = fresh_router(
                replicas_n, max_batch=args.max_batch,
                queue_limit=args.queue_limit,
            )
            rec = run_arm(
                router, traffic, offered_rps=offered,
                duration_s=args.duration_s, seed=args.seed + li,
            )
            rec = {
                "arm": f"replicas_{n}", "replicas": n,
                "load_mult": mult, **rec,
                "warm_cache_hits": warm.get("hits"),
                "warm_cache_misses": warm.get("misses"),
            }
            records.append(rec)
            print(
                f"  n={n} offered={offered:7.1f}/s -> "
                f"achieved={rec['achieved_rps']}/s "
                f"p50={rec['p50_ms']}ms p99={rec['p99_ms']}ms "
                f"shed={rec['shed_frac']:.1%}"
            )

    best1, bestn = (
        sustained([r for r in records if r["replicas"] == n], slo_p99_ms=slo,
                  max_shed_frac=args.max_shed_frac)
        for n in (1, args.replicas)
    )
    worst = numerics_check(
        model, pools[args.replicas][0], traffic, max_batch=args.max_batch,
    )
    summary = {
        "summary": "serve_bench",
        "replicas_n": args.replicas,
        "slo_p99_ms": slo,
        "max_shed_frac": args.max_shed_frac,
        "dispatch_ms": round(dispatch_s * 1e3, 3),
        "sustained_rps_1": best1["achieved_rps"] if best1 else None,
        "p99_at_sustained_1": best1["p99_ms"] if best1 else None,
        "sustained_rps_n": bestn["achieved_rps"] if bestn else None,
        "p99_at_sustained_n": bestn["p99_ms"] if bestn else None,
        "speedup": (
            round(bestn["achieved_rps"] / best1["achieved_rps"], 3)
            if best1 and bestn and best1["achieved_rps"]
            else None
        ),
        "max_abs_diff": worst,
        "bar_speedup": 2.5,
        "bar_numeric": 1e-5,
        "quick": bool(args.quick),
    }
    records.append(summary)
    print(
        f"serve_bench: sustained {summary['sustained_rps_1']} req/s (n=1) "
        f"vs {summary['sustained_rps_n']} req/s (n={args.replicas}) at "
        f"p99<={slo}ms -> speedup {summary['speedup']}x; "
        f"max |replicated-solo| {worst:.2e}"
    )

    if args.trace_path and bestn is not None:
        _traced_run(args, pools[args.replicas][0], traffic, bestn, cap1)

    if args.out:
        if d := os.path.dirname(args.out):
            os.makedirs(d, exist_ok=True)
        with open(args.out, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
        print(f"serve_bench: wrote {len(records)} records to {args.out}")
    return summary


def _traced_run(args, replicas, traffic, bestn, cap1) -> None:
    """Re-run the best sustained N-replica load with the span tracer on
    and print the per-replica breakdown: the bottleneck, named per
    replica."""
    from gnot_tpu_torch.obs.tracing import Tracer
    from gnot_tpu_torch.tools import trace_report

    tracer = Tracer(path=args.trace_path)
    router = fresh_router(
        replicas, max_batch=args.max_batch,
        queue_limit=args.queue_limit, tracer=tracer,
    )
    run_arm(
        router, traffic, offered_rps=bestn["load_mult"] * cap1,
        duration_s=min(args.duration_s, 3.0), seed=args.seed,
    )
    tracer.flush()
    rep = trace_report.report(args.trace_path)
    trace_report.print_report(rep)


def _build_model(args):
    """A mid-size GNOT on the Darcy operator schema (``--layers`` blocks of
    width ``--hidden``, 2 experts, 2 heads) on ``args.device``, weights
    drawn from a ``torch.Generator`` seeded with ``args.seed``, untrained
    (serving throughput is about plumbing, not accuracy)."""
    import torch

    from gnot_tpu_torch.config import ModelConfig
    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.device import resolve_device
    from gnot_tpu_torch.models.gnot import GNOT

    dev = resolve_device(args.device)
    samples = datasets.synth_darcy2d(args.max_batch, seed=0, grid_n=8)
    mc = ModelConfig(
        n_attn_layers=args.layers,
        n_attn_hidden_dim=args.hidden,
        n_mlp_num_layers=2,
        n_mlp_hidden_dim=args.hidden,
        n_input_hidden_dim=args.hidden,
        n_expert=2,
        n_head=2,
        **datasets.infer_model_dims(samples),
    )
    return GNOT(mc, generator=torch.Generator().manual_seed(args.seed)).to(dev)


def main(argv=None) -> int:
    s = run(argv)
    ok = (
        s["speedup"] is not None
        and s["speedup"] >= s["bar_speedup"]
        and s["max_abs_diff"] <= s["bar_numeric"]
    )
    if not ok:
        print(f"FAIL: acceptance bar not met: {s}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
