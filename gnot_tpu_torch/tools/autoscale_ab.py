"""Autoscaling A/B: a static pool vs the self-scaling pool, plus a
scale-in chaos arm.

Port of ``tools/autoscale_ab.py``, with its flags, defaults, functions
(``_build_model``, ``_build_pool``, ``_arm``, ``_chaos_scale_in``,
``run``, ``main``), records, summary, bars and exit rule (plus
``--device``: ``cuda`` unless ``--device cpu`` is passed; without a card
``cuda`` raises). One seeded diurnal+bursty open-loop trace
(``loadgen``: the rate ramps from base to a mid-window peak with square
bursts riding it) is driven through two pools of the SAME model:

* ``static``: a fixed ``--max_replicas``-wide pool (provisioned for the
  peak, idle at the edges).
* ``autoscaled``: a pool founded at ``--min_replicas`` with the
  ``AutoscaleController`` closing the loop from the live metrics registry
  and SLO evaluator to capacity: warm-before-join scale-out under
  pressure, drain-then-remove scale-in after calm.

Bars (broken ones land in the returned summary's ``failures``; ``main``
exits 1 on any): strictly fewer replica-seconds autoscaled than static,
at least one scale-out, and the chaos arm's zero lost sessions, zero lost
requests and parity within 1e-5 of the offline trajectories; on the full
window also equal p99 (``BAR_P99_RATIO``) and zero shed on the up-ramp
(``--quick`` compresses the diurnal ramp faster than any reactive
controller can track, so JAX skips these two there, and so does the
port).

The **chaos arm** re-runs the scale-in path under fire: a storm of K-step
rollout sessions over 3 replicas, ``remove_replica`` of a session-holding
replica mid-storm, with the retiring replica KILLED (``replica_kill``)
while it is still handing sessions over.

Where the port differs from JAX:

* Devices. JAX gives each replica a host device of its own through
  ``XLA_FLAGS`` (``_ensure_xla_flags``, dropped); the port's replicas
  share the one card, each on its own CUDA stream (``serve/replica.py``).
* Warm-up instead of AOT. JAX's deploy step compiles every slot's programs
  once (``aot.prewarm_deployment``), each founding replica hydrates them
  (``prewarm_from``, asserted ``"snapshot"``) and scale-out hydrates its
  slot (``prewarm_manifest=``). Eager PyTorch has no executable to
  serialize, so every replica, founding or joining, is warmed by
  ``EngineReplica.warm()``, one dispatch per bucket of the traffic, before
  it takes traffic; ``_build_pool`` asserts the port's record of that
  warm-up (``warm_stats["source"] == "compile"``) where JAX asserts the
  snapshot, and the controller warms a joining replica from
  ``warm_samples``.

Usage::

    python -m gnot_tpu_torch.tools.autoscale_ab --out build/autoscale_ab.jsonl
    python -m gnot_tpu_torch.tools.autoscale_ab --device cpu --quick --out build/autoscale_ab.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from gnot_tpu_torch.tools import loadgen

BAR_P99_RATIO = 1.5  # "equal p99 within noise"


def _build_model(max_batch: int, device: str = "cuda"):
    """A mid-size GNOT (2 blocks, width 96, 2 experts, 2 heads) on the Darcy
    operator schema, on ``device``, weights from a ``torch.Generator``
    seeded with 0 (``serve_bench``'s sizing)."""
    import torch

    from gnot_tpu_torch.config import ModelConfig
    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.device import resolve_device
    from gnot_tpu_torch.models.gnot import GNOT

    dev = resolve_device(device)
    samples = datasets.synth_darcy2d(max_batch, seed=0, grid_n=8)
    mc = ModelConfig(
        n_attn_layers=2, n_attn_hidden_dim=96, n_mlp_num_layers=2,
        n_mlp_hidden_dim=96, n_input_hidden_dim=96, n_expert=2, n_head=2,
        **datasets.infer_model_dims(samples),
    )
    return GNOT(mc, generator=torch.Generator().manual_seed(0)).to(dev)


def _build_pool(model, n, *, max_batch, traffic):
    """n replicas of ``model``'s weights on its device, each warmed (one
    dispatch per bucket of ``traffic``) before it joins: arm setup pays the
    warm-up, never the first request."""
    from gnot_tpu_torch.serve import build_replica

    device = next(model.parameters()).device
    replicas = [
        build_replica(model, i, device, batch_size=max_batch)
        for i in range(n)
    ]
    for r in replicas:
        r.warm(traffic, rows=max_batch)
        stats = r.warm_stats
        assert stats["source"] == "compile", (
            f"replica {r.replica_id} failed to warm: {stats}"
        )
    return replicas


def _arm(
    name,
    model,
    traffic,
    times,
    *,
    n_replicas,
    max_batch,
    autoscale,
    max_replicas,
    duration_s,
    cooldown_s,
    up_load,
    down_load,
):
    """One open-loop run of the shared trace through a fresh pool. Returns
    the arm record (and the controller's ledger when elastic)."""
    from gnot_tpu_torch.obs.metrics import (
        MetricsPublisher,
        MetricsRegistry,
        SLOEvaluator,
        SLOObjective,
    )
    from gnot_tpu_torch.serve import AutoscaleController, ReplicaRouter, build_replica

    device = next(model.parameters()).device
    registry = MetricsRegistry()
    replicas = _build_pool(model, n_replicas, max_batch=max_batch, traffic=traffic)
    router = ReplicaRouter(
        replicas,
        max_batch=max_batch,
        max_wait_ms=4.0,
        queue_limit=512,
        metrics=registry,
    ).start()
    controller = None
    publisher = None
    if autoscale:
        evaluator = SLOEvaluator(
            [
                SLOObjective(
                    "queue_saturation", "queue_depth", 64.0,
                    fast_window_s=0.5, slow_window_s=1.5,
                ),
            ]
        )
        publisher = MetricsPublisher(
            registry, interval_s=0.25, evaluator=evaluator
        ).start()

        def factory(rid, slot):
            # Every slot is the one card (serve/autoscaler.py).
            return build_replica(model, rid, device, batch_size=max_batch)

        controller = AutoscaleController(
            router,
            replica_factory=factory,
            min_replicas=n_replicas,
            max_replicas=max_replicas,
            interval_s=0.1,
            cooldown_s=cooldown_s,
            up_load=up_load,
            down_load=down_load,
            down_ticks=15,
            registry=registry,
            evaluator=evaluator,
            # Warm-before-join: a scale-out replica dispatches every
            # bucket before it takes traffic.
            warm_samples=traffic,
        ).start()
    t0 = time.perf_counter()
    submit_at: list[float] = []

    def submit(i):
        submit_at.append(time.perf_counter() - t0)
        return router.submit(traffic[i % len(traffic)])

    futures = loadgen.replay(submit, times)
    results = [f.result(timeout=300) for f in futures]
    elapsed = time.perf_counter() - t0
    if controller is not None:
        controller.close()
    if publisher is not None:
        publisher.close()
    summary = router.drain()
    ramp_n = loadgen.ramp_split(times, duration_s)
    shed_up_ramp = sum(1 for r in results[:ramp_n] if not r.ok)
    completed = sum(r.ok for r in results)
    rs = (
        controller.replica_seconds()
        if controller is not None
        else n_replicas * elapsed
    )
    rec = {
        "arm": name,
        "replicas_founding": n_replicas,
        "replicas_max": max_replicas,
        "autoscale": autoscale,
        "submitted": len(futures),
        "completed": completed,
        "shed": summary["shed"],
        "shed_total": len(futures) - completed,
        "shed_up_ramp": shed_up_ramp,
        "ramp_requests": ramp_n,
        "p50_ms": summary["latency_p50_ms"],
        "p99_ms": summary["latency_p99_ms"],
        "achieved_rps": round(completed / elapsed, 2),
        "replica_seconds": round(rs, 2),
        "duration_s": round(elapsed, 2),
        "removed": summary["routing"]["removed"],
    }
    if controller is not None:
        rec["autoscale_stats"] = controller.stats()
    return rec


def _chaos_scale_in(engine, *, max_batch, sessions, steps, traffic, quick):
    """Scale-in under fire: rollout sessions resident on the retiring
    replica, which is KILLED while still handing them over. Bars: zero lost
    sessions, zero lost requests, every session completes and matches the
    offline trajectory."""
    from gnot_tpu_torch.resilience.faults import FaultInjector
    from gnot_tpu_torch.serve import ReplicaRouter, offline_rollout, rollout

    traffic = traffic[:sessions]
    reference = [
        offline_rollout(engine, s, steps, rows=max_batch) for s in traffic
    ]
    replicas = _build_pool(engine.model, 3, max_batch=max_batch, traffic=traffic)
    # The kill lands on replica 0 AFTER the removal starts: armed by
    # rollout-step ordinal, sized so eviction is mid-flight.
    kill_at = max(4, sessions // 2)
    router = ReplicaRouter(
        replicas,
        max_batch=max_batch,
        max_wait_ms=2.0,
        session_snapshot_every=2,
        faults={0: FaultInjector.from_spec(f"replica_kill@{kill_at}")},
    ).start()
    futures = [router.submit_rollout(s, steps) for s in traffic]
    # Let the storm take residence everywhere, then retire replica 0 while
    # it still holds sessions; the kill fires during the drain.
    time.sleep(0.05)
    t0 = time.perf_counter()
    router.remove_replica(0, timeout_s=60.0, reason="scale_in")
    remove_s = time.perf_counter() - t0
    results = [f.result(timeout=300) for f in futures]
    summary = router.drain()
    lost_sessions = sum(1 for r in results if not r.ok)
    worst = 0.0
    for r, ref in zip(results, reference):
        if r.ok:
            worst = max(worst, rollout.parity_check(r.outputs, ref))
    sess = summary.get("sessions") or {}
    return {
        "probe": "chaos_scale_in",
        "quick": quick,
        "sessions": sessions,
        "steps": steps,
        "removed_replica": 0,
        "kill_at_step": kill_at,
        "remove_s": round(remove_s, 3),
        "completed": sum(1 for r in results if r.ok),
        "lost_sessions": lost_sessions,
        "lost_requests": sum(
            n
            for reason, n in summary["shed"].items()
            if reason not in ("error_replica_dead",)
        ),
        "dead_request_failures_replayed": summary["shed"].get(
            "error_replica_dead", 0
        ),
        "migrated": sess.get("migrated", 0),
        "max_abs_diff": worst,
        "bar_lost": 0,
        "bar_numeric": 1e-5,
    }


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Autoscaling A/B: a static pool against an elastic one.")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--min_replicas", type=int, default=2)
    p.add_argument("--max_replicas", type=int, default=4)
    p.add_argument("--duration_s", type=float, default=32.0)
    p.add_argument("--base_mult", type=float, default=0.5,
                   help="base offered load as a multiple of one "
                        "replica's measured capacity")
    p.add_argument("--peak_mult", type=float, default=5.0,
                   help="diurnal peak rate as a multiple of base")
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--sessions", type=int, default=10,
                   help="chaos arm: concurrent rollout sessions")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quick", action="store_true",
                   help="short window + small storm (CI smoke)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where every replica runs; cuda raises without a card")
    args = p.parse_args(argv)
    if args.quick:
        args.duration_s = min(args.duration_s, 8.0)
        args.sessions, args.steps = 6, 4

    from gnot_tpu_torch.serve import InferenceEngine
    from gnot_tpu_torch.tools import serve_smoke

    model = _build_model(args.max_batch, args.device)
    traffic = serve_smoke.mixed_traffic(
        16, seed=args.seed, mesh_lo=600, mesh_hi=1000
    )
    engine = InferenceEngine(model, batch_size=args.max_batch)
    engine.warmup(traffic, rows=args.max_batch)

    # Capacity probe: one replica's dispatch rate sets the trace scale
    # (the diurnal peak must genuinely overload a min-size pool).
    keys = [engine.bucket_key(s) for s in traffic]
    t0 = time.perf_counter()
    for s, k in zip(traffic[:8], keys[:8]):
        engine.infer([s], pad_nodes=k[0], pad_funcs=k[1],
                     rows=args.max_batch)
    dispatch_s = (time.perf_counter() - t0) / 8
    cap1 = args.max_batch / dispatch_s
    base_rps = args.base_mult * cap1
    print(
        f"autoscale_ab: dispatch {dispatch_s * 1e3:.1f} ms -> 1-replica "
        f"capacity ~{cap1:.0f}/s; trace base {base_rps:.0f}/s, peak "
        f"~{base_rps * args.peak_mult:.0f}/s over {args.duration_s}s"
    )
    times = loadgen.trace_times(
        "diurnal_bursty",
        base_rps=base_rps,
        duration_s=args.duration_s,
        seed=args.seed,
        peak_mult=args.peak_mult,
        bursts=2,
        burst_mult=2.0,
        burst_frac=0.06,
    )
    print(f"autoscale_ab: {len(times)} arrivals on the shared trace")

    # Controller thresholds in per-replica in-system requests: grow well
    # before the queue saturates, shrink near-idle.
    up_load = 1.0 * args.max_batch
    down_load = 0.5 * args.max_batch
    common = dict(
        max_batch=args.max_batch,
        max_replicas=args.max_replicas,
        duration_s=args.duration_s,
        cooldown_s=0.5,
        up_load=up_load,
        down_load=down_load,
    )
    records: list[dict] = []
    failures: list[str] = []

    def check(ok, msg):
        if not ok:
            failures.append(msg)

    static = _arm(
        "static", model, traffic, times,
        n_replicas=args.max_replicas, autoscale=False, **common,
    )
    records.append(static)
    print(
        f"  static     p99={static['p99_ms']:.1f}ms shed="
        f"{static['shed_total']} replica_s={static['replica_seconds']}"
    )
    auto = _arm(
        "autoscaled", model, traffic, times,
        n_replicas=args.min_replicas, autoscale=True, **common,
    )
    records.append(auto)
    print(
        f"  autoscaled p99={auto['p99_ms']:.1f}ms shed="
        f"{auto['shed_total']} shed_up_ramp={auto['shed_up_ramp']} "
        f"replica_s={auto['replica_seconds']} "
        f"(ups={auto['autoscale_stats']['scale_ups']} "
        f"downs={auto['autoscale_stats']['scale_downs']})"
    )

    chaos = _chaos_scale_in(
        engine, max_batch=args.max_batch,
        sessions=args.sessions, steps=args.steps, traffic=traffic,
        quick=args.quick,
    )
    records.append(chaos)
    print(
        f"  chaos      lost_sessions={chaos['lost_sessions']} "
        f"lost_requests={chaos['lost_requests']} "
        f"migrated={chaos['migrated']} parity={chaos['max_abs_diff']:.2e}"
    )

    p99_ratio = (
        auto["p99_ms"] / static["p99_ms"] if static["p99_ms"] else None
    )
    summary = {
        "summary": "autoscale_ab",
        "quick": bool(args.quick),
        "trace": "diurnal_bursty",
        "duration_s": args.duration_s,
        "base_rps": round(base_rps, 1),
        "peak_mult": args.peak_mult,
        "arrivals": len(times),
        "min_replicas": args.min_replicas,
        "max_replicas": args.max_replicas,
        "up_load": up_load,
        "down_load": down_load,
        "p99_static_ms": static["p99_ms"],
        "p99_autoscaled_ms": auto["p99_ms"],
        "p99_ratio": round(p99_ratio, 3) if p99_ratio else None,
        "bar_p99_ratio": BAR_P99_RATIO,
        "replica_seconds_static": static["replica_seconds"],
        "replica_seconds_autoscaled": auto["replica_seconds"],
        "replica_seconds_saved_frac": round(
            1.0 - auto["replica_seconds"] / static["replica_seconds"], 3
        ),
        "shed_up_ramp": auto["shed_up_ramp"],
        "bar_shed_up_ramp": 0,
        "scale_ups": auto["autoscale_stats"]["scale_ups"],
        "scale_downs": auto["autoscale_stats"]["scale_downs"],
        "chaos_lost_sessions": chaos["lost_sessions"],
        "chaos_lost_requests": chaos["lost_requests"],
        "chaos_migrated": chaos["migrated"],
        "chaos_max_abs_diff": chaos["max_abs_diff"],
    }
    records.append(summary)

    if not args.quick:
        # The timing bars hold on the full window; --quick compresses the
        # diurnal ramp faster than any reactive controller can track.
        check(
            p99_ratio is not None and p99_ratio <= BAR_P99_RATIO,
            f"autoscaled p99 {auto['p99_ms']} vs static "
            f"{static['p99_ms']} (ratio {p99_ratio}) beyond the "
            f"{BAR_P99_RATIO} noise bar",
        )
        check(
            auto["shed_up_ramp"] == 0,
            f"autoscaled arm shed {auto['shed_up_ramp']} requests on "
            "the up-ramp (must grow before it sheds)",
        )
    check(
        auto["replica_seconds"] < static["replica_seconds"],
        "autoscaled pool did not save replica-seconds "
        f"({auto['replica_seconds']} vs {static['replica_seconds']})",
    )
    check(
        auto["autoscale_stats"]["scale_ups"] >= 1,
        "controller never scaled out: the trace was vacuous",
    )
    check(
        chaos["lost_sessions"] == 0,
        f"chaos arm lost {chaos['lost_sessions']} sessions",
    )
    check(
        chaos["lost_requests"] == 0,
        f"chaos arm lost {chaos['lost_requests']} requests",
    )
    check(
        chaos["max_abs_diff"] <= chaos["bar_numeric"],
        f"chaos-arm parity {chaos['max_abs_diff']} over the bar",
    )

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(
        f"autoscale_ab: p99 {auto['p99_ms']:.1f} vs {static['p99_ms']:.1f}"
        f"ms (ratio {p99_ratio:.2f}), replica-seconds "
        f"{auto['replica_seconds']:.0f} vs {static['replica_seconds']:.0f}"
        f" (saved {summary['replica_seconds_saved_frac']:.0%}), "
        f"up-ramp shed {auto['shed_up_ramp']}; wrote {args.out}"
    )
    for msg in failures:
        print(f"FAIL: {msg}")
    summary = dict(summary)
    summary["failures"] = failures
    return summary


def main(argv=None) -> int:
    return 1 if run(argv)["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
