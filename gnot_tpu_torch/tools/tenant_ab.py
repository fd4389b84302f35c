"""Multi-tenant isolation A/B: the tenant plane on vs the open pool, plus
a default-path pin probe.

Port of ``tools/tenant_ab.py``, with its flags, defaults, functions
(``_build_engine``, ``_pct``, ``_arm``, ``_default_pin``, ``run``,
``main``), records, summary, bars and exit rule (plus ``--device``:
``cuda`` unless ``--device cpu`` is passed; without a card ``cuda``
raises). One seeded MULTI-STREAM open-loop trace (``loadgen``'s
``multi_stream_times``: an 'interactive' stream at a modest fraction of
measured capacity interleaved with a 'batch' flood offered at >= 3x its
weighted fair share) is driven through two servers over the SAME warmed
engine:

* ``isolated``: ``TenantPolicy`` on: WFQ weights interactive:3 / batch:1
  with priority classes, and a small admission quota on batch, so the
  flood fast-fails at the door instead of occupying the queue.
* ``open``: the tenant plane OFF (requests submitted untagged, the
  default path): one shared FIFO queue and the global admission limit.

Bars (broken ones land in the returned summary's ``failures``; ``main``
exits 1 on any):

* **isolated keeps interactive clean**: interactive p99 within the SLO
  (default: 20x one measured dispatch) and ZERO interactive sheds, while
  batch floods at >= ``BAR_FLOOD_FACTOR`` x its fair share;
* **open twin breaches**: the same interactive stream behind the same
  flood blows its SLO (full mode only: ``--quick`` may end before the
  open arm's shared queue has grown past the SLO, as in JAX);
* **quota coherence**: every batch quota shed in the isolated arm is a
  tenant-tagged ``tenant_quota_shed`` event, count for count, and the
  server's per-tenant rollup equals the client-side tallies;
* **default path pinned**: the open arm's events and summary carry ZERO
  tenant-plane footprint.

JAX pins its host platform to one intra-op thread through ``XLA_FLAGS``
(``_ensure_xla_flags``, dropped); the port's engine runs on the card.

Usage::

    python -m gnot_tpu_torch.tools.tenant_ab --out build/tenant_ab.jsonl
    python -m gnot_tpu_torch.tools.tenant_ab --device cpu --quick --out build/tenant_ab.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from gnot_tpu_torch.tools import loadgen

BAR_FLOOD_FACTOR = 3.0  # batch offered load vs its weighted fair share
WEIGHTS = "interactive:3,batch:1"


def _build_engine(max_batch: int, device: str = "cuda"):
    """A mid-size GNOT (2 blocks, width 96, 2 experts, 2 heads) on the
    single-bucket Darcy64 schema, weights from a ``torch.Generator``
    seeded with 0: ONE bucket makes the WFQ / priority drain the only
    arbiter of order. Returns (engine, samples)."""
    import torch

    from gnot_tpu_torch.config import ModelConfig
    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.device import resolve_device
    from gnot_tpu_torch.models.gnot import GNOT
    from gnot_tpu_torch.serve import InferenceEngine

    dev = resolve_device(device)
    samples = datasets.synth_darcy2d(max(16, max_batch), seed=0, grid_n=8)
    mc = ModelConfig(
        n_attn_layers=2, n_attn_hidden_dim=96, n_mlp_num_layers=2,
        n_mlp_hidden_dim=96, n_input_hidden_dim=96, n_expert=2, n_head=2,
        **datasets.infer_model_dims(samples),
    )
    model = GNOT(mc, generator=torch.Generator().manual_seed(0)).to(dev)
    return InferenceEngine(model, batch_size=max_batch), samples


def _pct(lat: list[float], q: float) -> float | None:
    """Exact client-side percentile over the resolved latencies (the bar
    values; the summary's histogram estimate is the cross-checked
    secondary view)."""
    return float(np.percentile(lat, q)) if lat else None


def _arm(
    name: str,
    engine,
    samples,
    trace,
    *,
    tagged: bool,
    policy_specs: dict | None,
    max_batch: int,
    max_wait_ms: float,
    queue_limit: int,
):
    """One open-loop replay of the shared interleaved trace through a fresh
    server over the warmed engine. Per-tenant outcomes are tallied
    CLIENT-SIDE from the trace's tenant labels, identically in both arms,
    so the open twin (which submits untagged) is measured on the same
    axis."""
    from gnot_tpu_torch.serve import InferenceServer, TenantPolicy
    from gnot_tpu_torch.utils.metrics import MetricsSink

    policy = (
        TenantPolicy.from_specs(**policy_specs) if policy_specs else None
    )
    metrics_path = os.path.join(
        tempfile.mkdtemp(prefix=f"tenant_ab_{name}_"), "serve.jsonl"
    )
    offsets = [t for t, _ in trace]
    with MetricsSink(metrics_path) as sink:
        server = InferenceServer(
            engine,
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            queue_limit=queue_limit,
            sink=sink,
            tenants=policy,
        ).start()

        def submit(i):
            kw = {"tenant": trace[i][1]} if tagged else {}
            return server.submit(samples[i % len(samples)], **kw)

        t0 = time.perf_counter()
        futures = loadgen.replay(submit, offsets)
        results = [f.result(timeout=600) for f in futures]
        wall = time.perf_counter() - t0
        summary = server.drain()
    with open(metrics_path) as f:
        events = [json.loads(line) for line in f]
    per: dict[str, dict] = {}
    lat: dict[str, list] = {}
    for (_, tenant), r in zip(trace, results):
        st = per.setdefault(
            tenant, {"submitted": 0, "completed": 0, "shed": {}}
        )
        st["submitted"] += 1
        if r.ok:
            st["completed"] += 1
            lat.setdefault(tenant, []).append(r.latency_ms)
        else:
            st["shed"][r.reason] = st["shed"].get(r.reason, 0) + 1
    for t, st in per.items():
        st["shed_total"] = sum(st["shed"].values())
        st["p50_ms"] = _pct(lat.get(t, []), 50)
        st["p99_ms"] = _pct(lat.get(t, []), 99)
    rec = {
        "arm": name,
        "tagged": tagged,
        "policy": policy_specs or None,
        "submitted": len(results),
        "completed": sum(r.ok for r in results),
        "shed": summary["shed"],
        "wall_s": round(wall, 2),
        "achieved_rps": round(sum(r.ok for r in results) / wall, 1),
        "tenants": {t: per[t] for t in sorted(per)},
    }
    return rec, summary, events


def _default_pin(events: list[dict], summary: dict) -> dict:
    """The default-path probe, read off the OPEN arm's own artifacts:
    untagged traffic must leave ZERO tenant-plane footprint: no
    tenant-named events, no tenant / tenants fields on any record, no
    per-tenant summary rollup."""
    tenant_events = sum(
        1 for e in events if "tenant" in (e.get("event") or "")
    )
    tenant_fields = sum(
        1 for e in events if "tenant" in e or "tenants" in e
    )
    return {
        "probe": "default_pin",
        "events_scanned": len(events),
        "tenant_named_events": tenant_events,
        "tenant_fields": tenant_fields,
        "summary_has_tenants": "tenants" in summary,
        "bar": 0,
    }


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Tenant isolation A/B: the tenant plane against the open pool.")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--duration_s", type=float, default=16.0)
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--max_wait_ms", type=float, default=4.0)
    p.add_argument("--queue_limit", type=int, default=256)
    p.add_argument(
        "--interactive_mult", type=float, default=0.3,
        help="interactive offered load as a fraction of measured "
             "capacity (comfortably under its 3/4 weighted share)"
    )
    p.add_argument(
        "--batch_mult", type=float, default=0.9,
        help="batch offered load as a fraction of measured capacity "
             "(0.9 = 3.6x its 1/4 weighted fair share; the flood)"
    )
    p.add_argument(
        "--quota_mult", type=int, default=2,
        help="batch admission quota in multiples of max_batch"
    )
    p.add_argument(
        "--slo_p99_ms", type=float, default=0.0,
        help="interactive p99 SLO; 0 = auto (20x one measured dispatch)"
    )
    p.add_argument(
        "--max_arrivals", type=int, default=4500,
        help="cap on total trace arrivals: on fast hosts the window "
             "shrinks instead of the storm growing unboundedly"
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quick", action="store_true",
                   help="short window + small storm (CI smoke)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs; cuda raises without a card")
    args = p.parse_args(argv)
    if args.quick:
        args.duration_s = min(args.duration_s, 4.0)
        args.max_arrivals = min(args.max_arrivals, 1200)

    engine, samples = _build_engine(args.max_batch, args.device)
    engine.warmup(samples, rows=args.max_batch)

    # Capacity probe: one full-batch dispatch rate sets the trace scale;
    # the flood must genuinely exceed the pool's ability to serve both
    # streams.
    key = engine.bucket_key(samples[0])
    t0 = time.perf_counter()
    for s in samples[:8]:
        engine.infer(
            [s], pad_nodes=key[0], pad_funcs=key[1], rows=args.max_batch
        )
    dispatch_s = (time.perf_counter() - t0) / 8
    cap = args.max_batch / dispatch_s
    slo_ms = args.slo_p99_ms or round(20 * dispatch_s * 1e3, 1)
    interactive_rps = args.interactive_mult * cap
    batch_rps = args.batch_mult * cap
    # batch's weighted fair share under interactive:3,batch:1 is 1/4 of
    # capacity; the flood factor is offered / entitled.
    flood_factor = batch_rps / (cap / 4)
    offered = interactive_rps + batch_rps
    duration_s = min(args.duration_s, args.max_arrivals / offered)
    print(
        f"tenant_ab: dispatch {dispatch_s * 1e3:.1f} ms -> capacity "
        f"~{cap:.0f}/s; interactive {interactive_rps:.0f}/s, batch "
        f"flood {batch_rps:.0f}/s ({flood_factor:.1f}x fair share), "
        f"SLO p99 {slo_ms}ms, window {duration_s:.1f}s"
    )

    # THE shared trace: both arms replay this one interleaved schedule.
    trace = loadgen.multi_stream_times(
        {
            "interactive": {"pattern": "steady", "base_rps": interactive_rps},
            "batch": {"pattern": "steady", "base_rps": batch_rps},
        },
        duration_s=duration_s,
        seed=args.seed,
    )
    n_batch = sum(1 for _, t in trace if t == "batch")
    print(
        f"tenant_ab: {len(trace)} arrivals on the shared trace "
        f"({len(trace) - n_batch} interactive / {n_batch} batch)"
    )

    specs = {
        "weights": WEIGHTS,
        "quotas": f"batch:{args.quota_mult * args.max_batch}",
    }
    common = dict(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        queue_limit=args.queue_limit,
    )
    records: list[dict] = []
    failures: list[str] = []

    def check(ok, msg):
        if not ok:
            failures.append(msg)

    iso, iso_summary, iso_events = _arm(
        "isolated", engine, samples, trace,
        tagged=True, policy_specs=specs, **common,
    )
    records.append(iso)
    it, bt = iso["tenants"]["interactive"], iso["tenants"]["batch"]
    print(
        f"  isolated  interactive p99={it['p99_ms'] and round(it['p99_ms'], 1)}ms "
        f"shed={it['shed_total']}; batch {bt['completed']}/"
        f"{bt['submitted']} ok shed={bt['shed']}"
    )

    open_, open_summary, open_events = _arm(
        "open", engine, samples, trace,
        tagged=False, policy_specs=None, **common,
    )
    records.append(open_)
    oi, ob = open_["tenants"]["interactive"], open_["tenants"]["batch"]
    print(
        f"  open      interactive p99={oi['p99_ms'] and round(oi['p99_ms'], 1)}ms "
        f"shed={oi['shed_total']}; batch {ob['completed']}/"
        f"{ob['submitted']} ok shed={ob['shed']}"
    )

    pin = _default_pin(open_events, open_summary)
    records.append(pin)

    # Isolated-arm cross-checks: the server's per-tenant rollup and the
    # tenant-tagged quota shed stream agree with the client-side tallies.
    roll = iso_summary.get("tenants") or {}
    for t in ("interactive", "batch"):
        got, obs = roll.get(t) or {}, iso["tenants"][t]
        check(
            got.get("requests") == obs["submitted"]
            and got.get("completed") == obs["completed"]
            and (got.get("shed") or {}) == obs["shed"],
            f"isolated arm: summary rollup for {t} {got} != observed "
            f"{obs}",
        )
    n_quota_events = sum(
        1 for e in iso_events if e.get("event") == "tenant_quota_shed"
    )
    check(
        n_quota_events == bt["shed"].get("shed_tenant_quota", 0)
        and all(
            e.get("tenant") == "batch"
            for e in iso_events
            if e.get("event") == "tenant_quota_shed"
        ),
        f"isolated arm: {n_quota_events} tenant_quota_shed events don't "
        f"match batch quota sheds {bt['shed']}",
    )

    open_breached = bool(
        (oi["p99_ms"] or 0) > slo_ms or oi["shed_total"] > 0
    )
    summary = {
        "summary": "tenant_ab",
        "quick": bool(args.quick),
        "trace": "multi_stream:steady+steady",
        "duration_s": round(duration_s, 2),
        "arrivals": len(trace),
        "capacity_rps": round(cap, 1),
        "interactive_rps": round(interactive_rps, 1),
        "batch_rps": round(batch_rps, 1),
        "flood_factor": round(flood_factor, 2),
        "bar_flood_factor": BAR_FLOOD_FACTOR,
        "slo_p99_ms": slo_ms,
        "weights": WEIGHTS,
        "batch_quota": args.quota_mult * args.max_batch,
        "isolated_interactive_p99_ms": it["p99_ms"],
        "isolated_interactive_shed": it["shed_total"],
        "isolated_batch_quota_sheds": bt["shed"].get(
            "shed_tenant_quota", 0
        ),
        "open_interactive_p99_ms": oi["p99_ms"],
        "open_interactive_shed": oi["shed_total"],
        "open_breached": open_breached,
        "pin_tenant_footprint": pin["tenant_named_events"]
        + pin["tenant_fields"]
        + int(pin["summary_has_tenants"]),
    }
    records.append(summary)

    check(
        flood_factor >= BAR_FLOOD_FACTOR,
        f"batch flood {flood_factor:.2f}x under the "
        f"{BAR_FLOOD_FACTOR}x fair-share bar: the storm is vacuous",
    )
    check(
        it["shed_total"] == 0,
        f"isolated arm shed {it['shed_total']} interactive requests "
        f"({it['shed']}): isolation failed",
    )
    check(
        it["p99_ms"] is not None and it["p99_ms"] <= slo_ms,
        f"isolated arm interactive p99 {it['p99_ms']}ms over the "
        f"{slo_ms}ms SLO",
    )
    check(
        bt["shed"].get("shed_tenant_quota", 0) >= 1,
        f"batch flood never hit its quota in the isolated arm: "
        f"{bt['shed']}",
    )
    if not args.quick:
        # The breach bar holds on the full window; --quick may end before
        # the open arm's shared queue has grown past the SLO.
        check(
            open_breached,
            f"open twin did not breach: interactive p99 "
            f"{oi['p99_ms']}ms vs SLO {slo_ms}ms, shed "
            f"{oi['shed_total']}",
        )
    check(
        summary["pin_tenant_footprint"] == 0,
        f"default path carries tenant-plane footprint: {pin}",
    )

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(
        f"tenant_ab: interactive p99 isolated "
        f"{it['p99_ms'] and round(it['p99_ms'], 1)}ms (shed {it['shed_total']}) vs open "
        f"{oi['p99_ms'] and round(oi['p99_ms'], 1)}ms (shed "
        f"{oi['shed_total']}) under a {flood_factor:.1f}x batch flood; "
        f"quota sheds {summary['isolated_batch_quota_sheds']}, default "
        f"pin footprint {summary['pin_tenant_footprint']}; wrote "
        f"{args.out}"
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
