"""Serving smoke test of the port: engine on synthetic Darcy64, mixed-bucket
traffic, one injected fault, asserted counters.

Port of ``tools/serve_smoke.py``, with the same flags, defaults, modes,
assertions and summary keys: the shortest end-to-end proof that the
port's serving tier (``gnot_tpu_torch/serve/``, docs/serving.md) holds
its contract under realistic conditions: ragged mixed-bucket traffic
(64-point Darcy64 queries interleaved with elasticity-sized
~300-700-point clouds in the same operator schema), dynamic per-bucket
batching, a deterministic injected fault (default: ``slow_request@<n>``
against a per-request deadline, so one deadline shed), graceful drain,
and a ``serve_summary`` whose counters are ASSERTED, not just printed:

* every submitted request resolved (completed + shed == submitted);
* the injected fault produced >= 1 deadline shed;
* latency percentiles exist and p50 <= p99;
* no dispatch mixed two buckets, and the engine's distinct dispatch
  shapes (the summary's ``compiled_shapes``, JAX's name) are bounded by
  the distinct-bucket count (O(log L_max), never O(traffic)).

The modes are JAX's: ``--replicas`` / ``--route_policy``, ``--rollout``,
``--metrics_interval_s`` and the SLO flags, ``--tenants``, ``--hosts``,
``--capacity``, ``--packed`` and ``--trace_path``; each adds its own
assertions. The model is JAX's tiny smoke model (one block, width 16,
2 experts, 2 heads, ``grid_n=8`` meshes) with weights drawn from a seeded
``torch.Generator``. ``--device`` is the port's own: ``cuda`` unless
``--device cpu`` is passed, raising without a card. Replicas and hosts
share that one device, each replica on its own CUDA stream there.
``--prewarm`` (JAX's AOT executable snapshots) raises ``NotPortedError``:
eager PyTorch has no compiled executable to serialize.

Usage::

    python -m gnot_tpu_torch.tools.serve_smoke \
        --n 24 --inject_fault slow_request@3 --deadline_ms 200
    python -m gnot_tpu_torch.tools.serve_smoke --device cpu --replicas 2

Exit code 0 iff every assertion holds; ``run(argv)`` returns the summary
with ``failures``, the list of broken assertions.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

import numpy as np

#: Keys of the port's single-server summary that JAX's has not.
PORT_ONLY_SUMMARY_KEYS = ("dispatch_ms_p50", "dispatch_ms_max")


def build_engine(seed: int = 0, max_batch: int = 4, dtype: str = "float32",
                 device: str = "cuda"):
    """Tiny GNOT with fresh weights on the Darcy64 schema (64-point grid,
    one input function), drawn from a ``torch.Generator`` seeded with
    ``seed`` — untrained; serving correctness is about plumbing, not
    accuracy. ``dtype`` is the serving compute dtype
    (models/precision.py); the weights stay f32 at rest. ``device``
    resolves through ``device.resolve_device``: ``cuda`` raises without
    a card."""
    import torch

    from gnot_tpu_torch.config import ModelConfig
    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.device import resolve_device
    from gnot_tpu_torch.models.gnot import GNOT
    from gnot_tpu_torch.serve.engine import InferenceEngine

    dev = resolve_device(device)
    samples = datasets.synth_darcy2d(max_batch, seed=seed, grid_n=8)
    mc = ModelConfig(
        n_attn_layers=1, n_attn_hidden_dim=16, n_mlp_num_layers=1,
        n_mlp_hidden_dim=16, n_input_hidden_dim=16, n_expert=2, n_head=2,
        **datasets.infer_model_dims(samples),
    )
    model = GNOT(mc, generator=torch.Generator().manual_seed(seed)).to(dev)
    return InferenceEngine(model, batch_size=max_batch, dtype=dtype)


def mixed_traffic(n: int, seed: int = 0, mesh_lo: int = 300, mesh_hi: int = 700):
    """Darcy64 queries (64 points) interleaved with ragged clouds
    (``mesh_lo``..``mesh_hi`` points, default elasticity-sized 300-700)
    in the SAME operator schema — the adversarial mix that makes naive
    padding pathological and exercises multiple buckets.
    Small ``mesh_hi`` (e.g. 200) makes the mixed SMALL-mesh workload the
    packing A/B (tools/pack_ab.py) measures."""
    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.data.batch import MeshSample

    rng = np.random.default_rng(seed)
    darcy = datasets.synth_darcy2d(n, seed=seed, grid_n=8)
    out = []
    for i in range(n):
        if i % 2 == 0:
            out.append(darcy[i])
            continue
        m = int(rng.integers(mesh_lo, mesh_hi))
        coords = rng.uniform(0, 1, size=(m, 2)).astype(np.float32)
        f = rng.uniform(0, 1, size=(m // 4, 3)).astype(np.float32)
        out.append(
            MeshSample(
                coords=coords,
                y=np.zeros((m, 1), np.float32),
                theta=darcy[i].theta,
                funcs=(f,),
            )
        )
    return out


def _run_federated(args) -> dict:
    """``--hosts N``: the federated storm (serve/federation.py,
    docs/distributed.md). The pool splits across N loopback hosts —
    one ``ReplicaRouter`` + ``HostAgent`` each, a ``ClusterRouter``
    placing the storm over in-proc links that run the real frame codec
    — and the smoke asserts the federation contract: zero lost futures,
    registry-valid events, per-host compile bounds, a coherent
    ``cluster_summary`` ledger."""
    import threading
    import time as _time

    from gnot_tpu_torch.data.batch import bucket_length
    from gnot_tpu_torch.obs import events as events_registry
    from gnot_tpu_torch.resilience.faults import FaultInjector
    from gnot_tpu_torch.serve.federation import build_local_federation
    from gnot_tpu_torch.serve.replica import build_replica
    from gnot_tpu_torch.serve.rollout import SessionStore
    from gnot_tpu_torch.utils.metrics import MetricsSink

    metrics_path = args.metrics_path or os.path.join(
        tempfile.mkdtemp(prefix="serve_smoke_"), "serve.jsonl"
    )
    engine = build_engine(max_batch=args.max_batch, device=args.device)
    traffic = mixed_traffic(args.n, mesh_lo=args.mesh_lo, mesh_hi=args.mesh_hi)
    per = max(1, args.replicas // args.hosts)
    # Every host's replicas share the one device, each replica on its own
    # stream there (the protocol plane, what this mode tests, is
    # host-level, not device-level), as JAX's slices wrap onto one device.
    groups = [
        [
            build_replica(
                engine.model, r, engine.device, batch_size=args.max_batch,
            )
            for r in range(per)
        ]
        for h in range(args.hosts)
    ]
    store = SessionStore(tempfile.mkdtemp(prefix="serve_smoke_sess_"))
    fi = FaultInjector.from_spec(args.inject_fault)
    chaos = (
        {f"host{h}": fi for h in range(args.hosts)}
        if fi is not None
        else None
    )
    failures = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(msg)

    with MetricsSink(metrics_path) as sink:
        cluster, agents = build_local_federation(
            groups,
            sink=sink,
            session_store=store,
            suspect_after_s=0.5,
            dead_after_s=1.5,
            link_faults=chaos,
            host_faults=chaos,
            router_kwargs=dict(
                max_batch=args.max_batch,
                max_wait_ms=args.max_wait_ms,
                queue_limit=args.queue_limit,
                default_deadline_ms=args.deadline_ms,
                session_snapshot_every=args.session_snapshot_every,
            ),
        )
        for a in agents.values():
            a.router.start()
        # Serving-startup discipline, per host: every bucket is warmed
        # on every replica before traffic.
        for g in groups:
            for r in g:
                r.warm(traffic, rows=args.max_batch)
        stop = threading.Event()

        def _ticker():
            while not stop.is_set():
                cluster.tick()
                stop.wait(0.05)

        ticker = threading.Thread(target=_ticker, daemon=True)
        ticker.start()
        try:
            t_submit = _time.perf_counter()
            futures = [
                cluster.submit_rollout(s, args.rollout)
                if args.rollout
                else cluster.submit(s)
                for s in traffic
            ]
            results = [f.result(timeout=120) for f in futures]
            wall_s = _time.perf_counter() - t_submit
        finally:
            # Stop the control loop BEFORE the sink context closes —
            # a ticker outliving a failed storm would write heartbeat
            # events into a closed file.
            stop.set()
            ticker.join(timeout=5)
        summary = cluster.drain()
        for a in agents.values():
            a.stop()
        cluster.close()
    summary["wall_s"] = wall_s
    summary["requests_per_s"] = args.n / wall_s if wall_s > 0 else None

    # -- assertions (the federation contract) -------------------------------
    # Zero lost futures: every submission resolved — a partition, a
    # dead host, or a drain may shed work honestly, but a future that
    # never resolves (or a session the ledger wrote off) fails.
    check(
        len(results) == args.n,
        f"{len(results)} resolved futures != {args.n} submitted",
    )
    check(
        summary["lost"] == 0,
        f"cluster lost sessions: lost={summary['lost']}",
    )
    n_ok = sum(r.ok for r in results)
    if args.rollout:
        check(
            summary["sessions"] == args.n,
            f"sessions ledger {summary['sessions']} != {args.n} submitted",
        )
    else:
        check(
            summary["requests"] == args.n
            and summary["completed"] + summary["shed"] == args.n,
            f"one-shot ledger incoherent: {summary['completed']}+"
            f"{summary['shed']} != {summary['requests']} != {args.n}",
        )
    if not args.inject_fault:
        check(
            n_ok == args.n,
            f"clean federated storm failed futures: {n_ok}/{args.n} ok",
        )
        check(
            summary["hosts_dead"] == 0 and summary["remigrated"] == 0,
            f"clean storm declared deaths/migrations: {summary}",
        )
        check(
            summary["protocol_errors"] == 0,
            f"clean storm counted protocol errors: "
            f"{summary['protocol_errors']}",
        )
    # Every record in the merged stream validates against the central
    # registry — per-host tagging (host=...) rides the extras contract.
    events = [json.loads(l) for l in open(metrics_path)]
    bad = [
        (e.get("event"), events_registry.validate_record(e))
        for e in events
        if events_registry.validate_record(e)
    ]
    check(
        not bad,
        f"{len(bad)} events fail registry validation; first: {bad[:3]}",
    )
    check(
        sum(e.get("event") == "cluster_summary" for e in events) == 1,
        "expected exactly one cluster_summary event",
    )
    hb_hosts = {
        e["host"] for e in events if e.get("event") == "host_heartbeat"
    }
    check(
        hb_hosts == set(agents),
        f"heartbeats observed from {sorted(hb_hosts)} != hosts "
        f"{sorted(agents)}",
    )
    # One dispatch shape per bucket per host: each host's replicas warmed
    # every traffic bucket exactly once — the distinct dispatch shapes
    # (JAX's compiled programs) are bounded by the distinct-bucket
    # count, never O(traffic).
    expected = {
        (
            bucket_length(s.coords.shape[0]),
            bucket_length(max(f.shape[0] for f in s.funcs)),
        )
        for s in traffic
    }
    for h, g in enumerate(groups):
        for r in g:
            check(
                r.engine.dispatch_shapes <= len(expected),
                f"host{h} replica {r.replica_id} compiled "
                f"{r.engine.dispatch_shapes} shapes > "
                f"{len(expected)} traffic buckets",
            )
    print(
        f"serve_smoke: federated {args.hosts} hosts x {per} replicas, "
        f"{n_ok}/{args.n} ok, lost={summary['lost']}, "
        f"remigrated={summary['remigrated']}, "
        f"hosts_dead={summary['hosts_dead']}, "
        f"protocol_errors={summary['protocol_errors']}, "
        f"{summary['requests_per_s']:.1f} req/s"
    )
    for msg in failures:
        print(f"FAIL: {msg}")
    summary["failures"] = failures
    return summary


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=16, help="requests to fire")
    p.add_argument(
        "--inject_fault", type=str, default="",
        help="serve-side kind@N spec; default: slow_request@<n> (stall "
             "the LAST request's dispatch past its deadline — earlier "
             "batches complete, the victim's batch sheds, so the storm "
             "demonstrates both outcomes)"
    )
    p.add_argument("--deadline_ms", type=float, default=200.0)
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--queue_limit", type=int, default=256)
    p.add_argument(
        "--metrics_path", type=str, default="",
        help="JSONL event sink (default: a temp file, validated then "
             "discarded)"
    )
    p.add_argument(
        "--trace_path", type=str, default="",
        help="also run the span tracer (obs/tracing.py) and write the "
             "Chrome trace-event JSON here; the smoke then ALSO asserts "
             "every completed request has a complete admission->resolve "
             "span chain sharing one trace_id"
    )
    p.add_argument("--trace_sample_rate", type=float, default=1.0)
    p.add_argument(
        "--packed", action="store_true",
        help="packed dispatch mode ('pack, don't pad', docs/performance"
             ".md): derive a PackPlan from the traffic, pack plan-"
             "fitting requests as chunk-aligned segments into ONE "
             "fixed-shape program per dispatch; oversize requests fall "
             "back to the padded per-bucket path. The smoke then ALSO "
             "asserts packed-dispatch bucket discipline and the "
             "serve_summary pad-waste rollup"
    )
    p.add_argument("--pack_chunk", type=int, default=64,
                   help="packed-mode segment alignment (tokens)")
    p.add_argument(
        "--mesh_lo", type=int, default=300,
        help="ragged-cloud size range lower bound (with --mesh_hi; "
             "small values make the mixed small-mesh packing workload)"
    )
    p.add_argument("--mesh_hi", type=int, default=700)
    p.add_argument(
        "--replicas", type=int, default=1,
        help="run the storm through the compile-affinity ReplicaRouter "
             "over N mesh-sliced engine replicas (serve/router.py) "
             "instead of one InferenceServer; the smoke then ALSO "
             "asserts per-replica compiled-program bounds, one route "
             "event per request, and the pool-level serve_summary "
             "per-replica rollup"
    )
    p.add_argument(
        "--route_policy", type=str, default="affinity",
        choices=["affinity", "least_loaded", "round_robin"],
    )
    p.add_argument(
        "--rollout", type=int, default=0, metavar="K",
        help="autoregressive rollout mode (serve/rollout.py, "
             "docs/serving.md 'Rollout serving'): drive each traffic "
             "sample as ONE K-step stateful session instead of a "
             "one-shot request. The smoke then asserts the SESSION "
             "contract: every session future resolves, zero lost "
             "sessions, exactly one rollout_step event per committed "
             "step (1..K in order), session affinity honored (an "
             "unmigrated session's steps all ran on one replica), and "
             "the serve_summary sessions rollup is coherent. Default "
             "fault in this mode: none (arm one explicitly to chaos-"
             "test)"
    )
    p.add_argument(
        "--session_snapshot_every", type=int, default=1,
        help="rollout mode: host-side carry-snapshot cadence (steps)"
    )
    p.add_argument(
        "--metrics_interval_s", type=float, default=0.0, metavar="S",
        help="live metrics plane (obs/metrics.py): attach a "
             "MetricsRegistry to the tier and publish snapshots every "
             "S seconds (plus one guaranteed MID-STORM tick and the "
             "final post-drain tick). The smoke then ALSO asserts the "
             "metrics-plane contract: a mid-storm snapshot reports a "
             "NONZERO live pool p99 before drain, the final snapshot "
             "agrees with serve_summary number-for-number (counters "
             "exact, percentiles within the documented histogram "
             "bound), metrics_snapshot/slo_alert records validate "
             "against the event registry, and the alert stream is "
             "edge-disciplined (fire/clear alternation, no spam)"
    )
    p.add_argument(
        "--slo_shed_frac", type=float, default=0.05,
        help="metrics mode: tolerated windowed shed fraction before "
             "the shed_fraction objective fires"
    )
    p.add_argument(
        "--slo_fast_window_s", type=float, default=0.5,
        help="metrics mode: fast burn-rate window (smoke timescale)"
    )
    p.add_argument(
        "--slo_slow_window_s", type=float, default=2.0,
        help="metrics mode: slow burn-rate window (smoke timescale)"
    )
    p.add_argument(
        "--pace_s", type=float, default=0.0,
        help="sleep between submissions: shapes the storm over wall "
             "time (an open-loop trickle instead of one burst), so "
             "cadence-driven metrics snapshots land genuinely "
             "mid-storm"
    )
    p.add_argument(
        "--prewarm", action="store_true",
        help="JAX's deploy-time AOT prewarm (serve/aot.py): not ported, "
             "raises NotPortedError (eager PyTorch has no compiled "
             "executable to serialize; every replica warms by "
             "dispatching each bucket)"
    )
    p.add_argument(
        "--tenants", action="store_true",
        help="multi-tenant isolation mode (serve/policies.py "
             "TenantPolicy, docs/serving.md 'Multi-tenant isolation'): "
             "run the storm as a TWO-TENANT burst — 'interactive' "
             "(weight 3, no quota) interleaved with a flooding 'batch' "
             "(weight 1, small admission quota) over ONE bucket so the "
             "WFQ + priority drain is the only arbiter. The smoke then "
             "ALSO asserts the isolation contract: batch sheds on its "
             "quota (tenant-tagged tenant_quota_shed events, registry-"
             "validated) while the interactive sibling never does, the "
             "priority drain keeps interactive p50 <= batch p50 under "
             "the shared backlog, and the serve_summary per-tenant "
             "rollup matches the observed per-future outcomes "
             "number-for-number. One-shot only (no --rollout)"
    )
    p.add_argument(
        "--tenant_weights", type=str, default="interactive:3,batch:1",
        help="tenants mode: WFQ weight spec (config.parse_tenant_spec "
             "grammar)"
    )
    p.add_argument(
        "--tenant_quotas", type=str, default="",
        help="tenants mode: admission quota spec; default "
             "batch:max(2, n//4) — small enough that the batch flood "
             "fast-fails on quota while interactive stays unthrottled"
    )
    p.add_argument(
        "--hosts", type=int, default=1,
        help="federated storm mode (serve/federation.py, docs/"
             "distributed.md): split the pool across N loopback hosts "
             "— each behind a HostAgent speaking the versioned wire "
             "protocol, a ClusterRouter placing the storm over lease-"
             "checked links. The smoke then asserts the FEDERATION "
             "contract instead: zero lost futures (every submission "
             "resolves, cluster_summary.lost == 0), every event record "
             "validates against the obs/events.py registry, per-host "
             "single-compile-per-bucket bounds, heartbeats observed "
             "from every host, and a coherent cluster_summary ledger. "
             "Composes with --rollout (K-step sessions through the "
             "cluster) and --inject_fault (federation kinds: host_kill@"
             "N, net_partition@N, msg_drop@N, msg_delay@MS)"
    )
    p.add_argument(
        "--capacity", action="store_true",
        help="program catalog & capacity plane (serve/catalog.py, "
             "docs/observability.md 'Program costs & capacity'): share "
             "ONE ProgramCatalog across the tier — counted costs "
             "(obs/costs.py) recorded per program, every dispatch "
             "attributed to its program key — and assert the capacity "
             "contract: every dispatched program has a catalog entry "
             "(nonzero costs or an explicit unavailable marker), "
             "serve_summary carries the capacity model, and the model's "
             "traffic totals agree with the summary's own counters"
    )
    p.add_argument(
        "--device", type=str, default="cuda", choices=["cuda", "cpu"],
        help="where the engines run: cuda (the default; raises without a "
             "card) or cpu"
    )
    args = p.parse_args(argv)
    if args.prewarm:
        from gnot_tpu_torch.config import NotPortedError

        raise NotPortedError(
            "--prewarm (AOT executable snapshots, JAX's serve/aot.py) has no "
            "counterpart: eager PyTorch has no compiled executable to "
            "serialize; every replica warms by dispatching each bucket")
    if args.tenants and args.rollout:
        p.error("--tenants is a one-shot storm mode (no --rollout)")
    if args.hosts > 1:
        if args.tenants or args.packed or args.capacity:
            p.error(
                "--hosts composes with --rollout/--inject_fault only "
                "(the single-host modes assert single-host invariants)"
            )
        if args.inject_fault == "none":
            args.inject_fault = ""
        return _run_federated(args)
    if args.inject_fault == "none":
        args.inject_fault = ""
    elif not args.inject_fault:
        # Rollout mode defaults to a clean storm (its assertions pin
        # zero lost sessions); tenants mode too (the quota fast-fail IS
        # the demonstrated shed path, and the isolation assertions pin
        # the interactive sibling clean); the one-shot smoke keeps its
        # classic straggler-sheds-the-last-request scenario.
        args.inject_fault = (
            "" if (args.rollout or args.tenants) else f"slow_request@{args.n}"
        )

    from gnot_tpu_torch.data.batch import bucket_length
    from gnot_tpu_torch.resilience.faults import FaultInjector
    from gnot_tpu_torch.serve.server import InferenceServer
    from gnot_tpu_torch.utils.metrics import MetricsSink

    metrics_path = args.metrics_path or os.path.join(
        tempfile.mkdtemp(prefix="serve_smoke_"), "serve.jsonl"
    )
    tracer = None
    if args.trace_path:
        from gnot_tpu_torch.obs.tracing import Tracer

        tracer = Tracer(
            path=args.trace_path, sample_rate=args.trace_sample_rate
        )
    engine = build_engine(max_batch=args.max_batch, device=args.device)
    traffic = mixed_traffic(args.n, mesh_lo=args.mesh_lo, mesh_hi=args.mesh_hi)
    tenant_policy = tenant_of = None
    if args.tenants:
        from gnot_tpu_torch.data import datasets
        from gnot_tpu_torch.serve.policies import TenantPolicy

        # Single-bucket traffic on purpose: with every request in ONE
        # bucket the WFQ + priority drain is the only arbiter of
        # dispatch order, so the fairness assertion (interactive p50 <=
        # batch p50) measures the policy, not bucket readiness.
        traffic = datasets.synth_darcy2d(args.n, seed=0, grid_n=8)
        quotas = args.tenant_quotas or f"batch:{max(2, args.n // 4)}"
        tenant_policy = TenantPolicy.from_specs(
            weights=args.tenant_weights, quotas=quotas
        )
        # (i//2) % 2: pairs alternate — interactive, interactive,
        # batch, batch, ... Equal split, interleaved, so both tenants
        # share the burst's backlog from the first flush on.
        tenant_of = lambda i: ("interactive", "batch")[(i // 2) % 2]  # noqa: E731
    pack_plan = None
    if args.packed:
        from gnot_tpu_torch.data.batch import PackPlan

        # Each replica has the whole device (replicas share it), so the
        # plan's rows split over one device, as main's --serve_packed.
        pack_plan = PackPlan.for_slices(
            traffic,
            chunk=args.pack_chunk,
            batch_size=args.max_batch,
            per_devices=1,
        )
    import time as _time

    # One catalog shared by every engine/server/router of the tier —
    # attached BEFORE warmup so program entries are captured at startup
    # (each program's first dispatch counts its costs) and never on the
    # storm's hot path. Registry and sink late-bind below.
    catalog = None
    if args.capacity:
        from gnot_tpu_torch.serve.catalog import ProgramCatalog

        catalog = ProgramCatalog()
        engine.attach_catalog(catalog)

    # Warm every bucket the storm will hit (serving-startup discipline —
    # docs/serving.md): a bucket's first dispatch (the kernels' build and
    # the allocator's first pass) landing under a 200 ms deadline would
    # shed everything queued behind it. Replicas each warm their own
    # engine on their own stream.
    replicas = None
    if args.replicas > 1:
        from gnot_tpu_torch.serve.replica import build_replicas

        replicas = build_replicas(
            engine.model, args.replicas, batch_size=args.max_batch,
        )
        if catalog is not None:
            for r in replicas:
                r.engine.attach_catalog(catalog)
        for r in replicas:
            r.warm(traffic, rows=args.max_batch, pack_plan=pack_plan)
    else:
        engine.warmup(traffic, rows=args.max_batch)
        if pack_plan is not None:
            engine.warmup_packed(traffic, pack_plan)

    registry = publisher = mid_snap = final_snap = None
    if args.metrics_interval_s > 0:
        from gnot_tpu_torch.obs.metrics import (
            MetricsPublisher,
            MetricsRegistry,
            SLOEvaluator,
            SLOObjective,
        )

        registry = MetricsRegistry()
    with MetricsSink(metrics_path) as sink:
        if catalog is not None:
            # Entries recorded before this point (warmup captures)
            # replay their program_catalog events into the now-open
            # sink.
            catalog.attach_outputs(metrics=registry, sink=sink)
        common = dict(
            max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms,
            queue_limit=args.queue_limit,
            default_deadline_ms=args.deadline_ms,
            sink=sink,
            faults=FaultInjector.from_spec(args.inject_fault),
            tracer=tracer,
            pack_plan=pack_plan,
            session_snapshot_every=args.session_snapshot_every,
            metrics=registry,
            catalog=catalog,
            tenants=tenant_policy,
        )
        if registry is not None:
            w = dict(
                fast_window_s=args.slo_fast_window_s,
                slow_window_s=args.slo_slow_window_s,
            )
            stem = os.path.splitext(metrics_path)[0]
            publisher = MetricsPublisher(
                registry,
                interval_s=args.metrics_interval_s,
                sink=sink,
                series_path=f"{stem}.series.jsonl",
                exposition_path=f"{stem}.prom",
                evaluator=SLOEvaluator([
                    SLOObjective(
                        "shed_fraction", "shed_frac",
                        args.slo_shed_frac, **w,
                    ),
                    SLOObjective("breaker_open", "breaker_open", 1.0, **w),
                    SLOObjective("session_loss", "session_loss", 1.0, **w),
                ]),
            )
        if replicas is not None:
            from gnot_tpu_torch.serve.router import ReplicaRouter

            server = ReplicaRouter(
                replicas, route_policy=args.route_policy, **common
            )
            server.start()
        else:
            server = InferenceServer(engine, **common).start()
        if publisher is not None:
            publisher.start()
        t_submit = _time.perf_counter()
        futures = []
        for i, s in enumerate(traffic):
            tkw = {"tenant": tenant_of(i)} if tenant_of else {}
            if args.rollout:
                futures.append(
                    server.submit_rollout(s, args.rollout, **tkw)
                )
            else:
                futures.append(server.submit(s, **tkw))
            if args.pace_s:
                _time.sleep(args.pace_s)
        results = []
        for i, f in enumerate(futures):
            results.append(f.result(timeout=120))
            if (
                publisher is not None
                and mid_snap is None
                and i + 1 >= max(1, args.n // 2)
            ):
                # The guaranteed MID-STORM snapshot (the cadence
                # thread publishes too; this tick pins one while
                # requests are demonstrably still in flight) —
                # live p99 must be nonzero BEFORE drain.
                mid_snap = publisher.tick()
        wall_s = _time.perf_counter() - t_submit
        summary = server.drain()
        if publisher is not None:
            if args.inject_fault:
                # Observe the fault's breach right at drain (the
                # fire edge, if cadence didn't catch it), then let
                # it leave the FAST window and observe once more so
                # the alert CLEARS before the final snapshot (the
                # fire->clear edge-pair acceptance criterion — a
                # drained tier with a still-open alert would read
                # as a live incident).
                publisher.tick()
                _time.sleep(args.slo_fast_window_s * 1.25)
                publisher.tick()
            final_snap = publisher.close()
        if tracer is not None:
            tracer.flush(sink=sink)
    # Storm throughput (submit -> last resolve; the pack_ab serve
    # metric). Not part of the serve_summary event schema — stamped on
    # the RETURNED dict only, after the sink closed.
    summary["wall_s"] = wall_s
    summary["requests_per_s"] = args.n / wall_s if wall_s > 0 else None

    # -- assertions (the point of a smoke test) ----------------------------
    failures = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(msg)

    n_ok = sum(r.ok for r in results)
    n_shed = sum(not r.ok for r in results)
    check(
        n_ok + n_shed == args.n,
        f"every request must resolve: {n_ok}+{n_shed} != {args.n}",
    )
    if args.rollout:
        # results are RolloutResults: completed counts ok STEP
        # dispatches (>= the committed steps — a migration replays the
        # post-snapshot tail, at-least-once).
        check(
            summary["completed"]
            >= sum(r.steps_completed for r in results),
            "summary.completed < committed rollout steps",
        )
    else:
        check(
            summary["completed"] == n_ok, "summary.completed != observed oks"
        )
    check(n_ok >= 1, "storm completed zero requests")
    if "slow_request" in args.inject_fault and args.deadline_ms:
        check(
            summary["shed"].get("shed_deadline", 0) >= 1,
            f"injected straggler must shed >= 1 deadline: {summary['shed']}",
        )
    check(
        summary["latency_p50_ms"] is not None
        and summary["latency_p50_ms"] <= summary["latency_p99_ms"],
        f"latency percentiles malformed: {summary}",
    )
    # Bucket discipline from the event stream: every PADDED dispatch
    # names ONE bucket, every PACKED dispatch carries the plan's fixed
    # shape, and the engine compiled at most one program per bucket
    # (+1 for the pack plan).
    events = [json.loads(l) for l in open(metrics_path)]
    dispatches = [e for e in events if e.get("event") == "queue_depth"]
    padded_d = [e for e in dispatches if not e.get("packed")]
    packed_d = [e for e in dispatches if e.get("packed")]
    buckets = {(e["bucket_nodes"], e["bucket_funcs"]) for e in padded_d}
    lengths = {s.coords.shape[0] for s in traffic}
    expected = {
        (bucket_length(n), bucket_length(max(f.shape[0] for f in s.funcs)))
        for s in traffic
        for n in [s.coords.shape[0]]
    }
    check(
        buckets <= expected,
        f"dispatch buckets {buckets} outside the traffic's bucket set "
        f"{expected} — a batch mixed buckets",
    )
    l_max = bucket_length(max(lengths))
    bound = 2 * (int(math.log2(l_max / 64)) + 1)  # ~2 per octave, 2 axes
    per_bound = max(len(expected), bound) + (1 if pack_plan is not None else 0)
    if replicas is not None:
        # Bounded PER-REPLICA compile counts under the mixed-bucket
        # storm: each replica compiles at most one program per bucket
        # it warmed/was assigned — never O(traffic) — and the pool
        # total is bounded by replicas x the single-server bound.
        for r in replicas:
            check(
                r.engine.dispatch_shapes <= per_bound,
                f"replica {r.replica_id} compiled "
                f"{r.engine.dispatch_shapes} shapes > per-replica bound "
                f"{per_bound}",
            )
        check(
            summary["compiled_shapes"] <= per_bound * args.replicas,
            f"pool compiled {summary['compiled_shapes']} shapes exceeds "
            f"{per_bound} x {args.replicas} replicas",
        )
        routes = [e for e in events if e.get("event") == "route"]
        check(
            len(routes) == args.n,
            f"{len(routes)} route events != {args.n} submitted requests",
        )
        check(
            set(summary.get("per_replica", {}))
            == {str(r.replica_id) for r in replicas},
            f"serve_summary.per_replica rollup malformed: "
            f"{sorted(summary.get('per_replica', {}))}",
        )
    else:
        check(
            summary["compiled_shapes"] <= per_bound,
            f"{summary['compiled_shapes']} compiled shapes exceeds the "
            f"O(log L) bound ({bound}) / bucket count ({len(expected)})",
        )
    check(
        all(
            0 < e["real_tokens"] <= e["capacity_tokens"] for e in dispatches
        ),
        "a dispatch reported incoherent real/capacity token counts",
    )
    if pack_plan is not None:
        check(
            bool(packed_d),
            "packed mode on but no dispatch rode the pack plan",
        )
        check(
            all(
                (e["bucket_nodes"], e["bucket_funcs"])
                == (pack_plan.row_len, pack_plan.pad_funcs)
                for e in packed_d
            ),
            "a packed dispatch escaped the plan's fixed shape",
        )
        pw = summary.get("pad_waste_by_bucket") or {}
        pk = f"packed:{pack_plan.n_rows}x{pack_plan.row_len}"
        check(
            pk in pw and pw[pk]["fill_frac"] is not None,
            f"serve_summary.pad_waste_by_bucket missing the packed "
            f"bucket {pk}: {sorted(pw)}",
        )
    check(
        any(e.get("event") == "serve_summary" for e in events),
        "no serve_summary event in the sink",
    )
    if args.capacity:
        # The capacity contract (docs/observability.md "Program costs
        # & capacity"): the catalog saw every dispatched program, and
        # the cost x traffic join agrees with the summary's own
        # counters number-for-number.
        model = summary.get("capacity_model")
        check(
            bool(model),
            "capacity mode on but serve_summary carries no capacity_model",
        )
        if model:
            progs = model["programs"]
            check(bool(progs), "capacity model recorded no programs")
            missing = [
                k for k, pr in progs.items() if pr["source"] is None
            ]
            check(
                not missing,
                f"dispatched programs missing catalog entries: {missing}",
            )
            for key, pr in progs.items():
                c = pr["costs"]
                check(
                    any(c.get(f) for f in ("flops", "bytes_accessed"))
                    or bool(c.get("unavailable")),
                    f"program {key}: neither nonzero costs nor an "
                    f"explicit unavailable marker: {c}",
                )
            check(
                model["pool"]["dispatches"] == len(dispatches),
                f"capacity model counted {model['pool']['dispatches']} "
                f"dispatches != {len(dispatches)} dispatch events",
            )
            pw = summary.get("pad_waste_by_bucket") or {}
            check(
                model["pool"]["real_tokens"]
                == sum(st["real_tokens"] for st in pw.values())
                and model["pool"]["capacity_tokens"]
                == sum(st["capacity_tokens"] for st in pw.values()),
                "capacity model token totals disagree with "
                "pad_waste_by_bucket",
            )
            cat_events = {
                e["key"]
                for e in events
                if e.get("event") == "program_catalog"
            }
            check(
                set(progs) <= cat_events,
                f"programs without a program_catalog event: "
                f"{sorted(set(progs) - cat_events)}",
            )
            snap_events = [
                e for e in events if e.get("event") == "capacity_snapshot"
            ]
            check(
                len(snap_events) == 1,
                f"{len(snap_events)} capacity_snapshot events != 1",
            )
            print(
                f"serve_smoke: capacity model {len(progs)} programs, "
                f"pool sustainable "
                f"{model['pool']['sustainable_tokens_per_s'] and round(model['pool']['sustainable_tokens_per_s'])} tok/s, "
                f"useful_token_frac="
                f"{model['pool']['useful_token_frac'] and round(model['pool']['useful_token_frac'], 4)}"
            )
    if args.rollout:
        # The session contract (docs/serving.md "Rollout serving").
        migrated = {
            e["session"]
            for e in events
            if e.get("event") == "session_migrate"
        }
        rsteps = [e for e in events if e.get("event") == "rollout_step"]
        by_session: dict = {}
        for e in rsteps:
            by_session.setdefault(e["session"], []).append(e)
        for r in results:
            if not r.ok:
                continue
            got = sorted(e["step"] for e in by_session.get(r.session, []))
            # Exactly one rollout_step event per committed step, 1..K
            # (a migrated session may log replayed duplicates of the
            # post-snapshot tail — committed coverage must still be
            # exactly 1..K).
            want = list(range(1, args.rollout + 1))
            ok_steps = (
                got == want
                if r.session not in migrated
                else sorted(set(got)) == want
            )
            check(
                ok_steps,
                f"session {r.session}: rollout_step events {got} != "
                f"1..{args.rollout}",
            )
            # Session affinity: an unmigrated session's steps all ran
            # on ONE replica (steps 2..K never re-route).
            if replicas is not None and r.session not in migrated:
                owners = {
                    e.get("replica") for e in by_session.get(r.session, [])
                }
                check(
                    len(owners) == 1,
                    f"session {r.session} steps spread over replicas "
                    f"{owners} without a migration",
                )
        # "Lost" matches the router rollup's definition: a migration
        # give-up, i.e. a terminal BACKEND failure — not a deadline/
        # queue shed (those count under `shed`) and not a drain
        # (drained_at_step is set, possibly 0).
        from gnot_tpu_torch.serve.server import MIGRATABLE_REASONS

        lost = [
            r
            for r in results
            if not r.ok
            and r.drained_at_step is None
            and r.reason in MIGRATABLE_REASONS
        ]
        if not args.inject_fault:
            check(
                not lost,
                f"clean rollout storm lost sessions: "
                f"{[(r.session, r.reason) for r in lost]}",
            )
        sess = summary.get("sessions") or {}
        check(
            sess.get("started", 0) >= args.n,
            f"sessions rollup malformed: {sess}",
        )
        if replicas is not None:
            check(
                sess.get("lost", 0) == len(lost),
                f"sessions rollup lost={sess.get('lost')} != observed "
                f"{len(lost)}",
            )
        snaps = [e for e in events if e.get("event") == "session_snapshot"]
        check(bool(snaps), "rollout storm took no session snapshots")
    if args.tenants:
        # The multi-tenant isolation contract (docs/serving.md
        # "Multi-tenant isolation"): quota fast-fail is tenant-scoped
        # and tenant-tagged, the sibling stays clean, the priority/WFQ
        # drain favors interactive under the shared backlog, and the
        # serve_summary per-tenant rollup agrees with the observed
        # per-future outcomes number-for-number.
        from gnot_tpu_torch.obs import events as ev_registry

        observed: dict = {}
        for i, r in enumerate(results):
            st = observed.setdefault(
                tenant_of(i), {"requests": 0, "completed": 0, "shed": {}}
            )
            st["requests"] += 1
            if r.ok:
                st["completed"] += 1
            else:
                st["shed"][r.reason] = st["shed"].get(r.reason, 0) + 1
        roll = summary.get("tenants") or {}
        check(
            set(roll) == set(observed),
            f"serve_summary tenants {sorted(roll)} != submitted tenants "
            f"{sorted(observed)}",
        )
        for t, obs in sorted(observed.items()):
            got = roll.get(t) or {}
            check(
                got.get("requests") == obs["requests"]
                and got.get("completed") == obs["completed"]
                and (got.get("shed") or {}) == obs["shed"],
                f"tenant {t} rollup {got} != observed {obs}",
            )
        # Quota fast-fail: the flooding batch tenant shed on its quota;
        # the unthrottled interactive sibling NEVER did (isolation) —
        # and in the default clean storm interactive shed NOTHING.
        batch_obs = observed.get("batch") or {"shed": {}, "completed": 0}
        inter_obs = observed.get("interactive") or {"shed": {}}
        n_quota = batch_obs["shed"].get("shed_tenant_quota", 0)
        check(
            n_quota >= 1,
            f"batch flood never hit its admission quota: {batch_obs}",
        )
        check(
            inter_obs["shed"].get("shed_tenant_quota", 0) == 0,
            f"quota sheds leaked onto the interactive sibling: "
            f"{inter_obs}",
        )
        if not args.inject_fault:
            check(
                inter_obs["shed"] == {},
                f"clean tenants storm shed interactive requests: "
                f"{inter_obs['shed']}",
            )
        check(
            batch_obs["completed"] >= 1,
            "batch tenant completed nothing — quota too tight to "
            "measure the drain",
        )
        # Tenant-tagged quota shed events, one per observed quota shed,
        # all naming the offender, all registry-valid.
        qevents = [
            e for e in events if e.get("event") == "tenant_quota_shed"
        ]
        check(
            len(qevents)
            == sum(
                st["shed"].get("shed_tenant_quota", 0)
                for st in observed.values()
            ),
            f"{len(qevents)} tenant_quota_shed events != observed quota "
            f"sheds",
        )
        check(
            all(e.get("tenant") == "batch" for e in qevents),
            f"a quota shed event named the wrong tenant: "
            f"{sorted({e.get('tenant') for e in qevents})}",
        )
        for rec in qevents:
            check(
                ev_registry.validate_record(rec) == [],
                f"tenant_quota_shed fails registry validation: {rec}",
            )
        # WFQ/priority drain fairness: both tenants queued into ONE
        # bucket in one interleaved burst; the interactive class (3x
        # weight, higher priority tier) must clear no slower than the
        # deprioritized batch flood.
        ip50 = (roll.get("interactive") or {}).get("latency_p50_ms")
        bp50 = (roll.get("batch") or {}).get("latency_p50_ms")
        check(
            ip50 is not None and bp50 is not None and ip50 <= bp50,
            f"priority drain inverted: interactive p50 {ip50}ms > "
            f"batch p50 {bp50}ms",
        )
        print(
            "serve_smoke: tenants "
            + ", ".join(
                f"{t}: {st['completed']}/{st['requests']} ok "
                f"shed={st['shed']} "
                f"p50={roll[t]['latency_p50_ms'] and round(roll[t]['latency_p50_ms'], 1)}ms"
                for t, st in sorted(observed.items())
            )
        )
    if publisher is not None:
        # Live-metrics-plane assertions.
        from gnot_tpu_torch.obs import events as events_registry
        from gnot_tpu_torch.obs.metrics import summary_agrees
        from gnot_tpu_torch.tools import metrics_report

        snaps = [e for e in events if e.get("event") == "metrics_snapshot"]
        alerts = [e for e in events if e.get("event") == "slo_alert"]
        check(
            len(snaps) >= 2,
            f"metrics plane published {len(snaps)} snapshots; need the "
            "mid-storm tick plus the final post-drain one at minimum",
        )
        for rec in snaps + alerts:
            check(
                events_registry.validate_record(rec) == [],
                f"metrics record fails registry validation: {rec}",
            )
        check(
            mid_snap is not None
            and mid_snap["pool"]["completed"] > 0
            and (mid_snap["pool"]["p99_ms"] or 0) > 0,
            f"mid-storm snapshot must report a nonzero live pool p99 "
            f"BEFORE drain: {mid_snap and mid_snap['pool']}",
        )
        agree_problems = summary_agrees(summary, final_snap)
        check(
            not agree_problems,
            f"final snapshot disagrees with serve_summary: "
            f"{agree_problems}",
        )
        _, alert_problems = metrics_report.breach_intervals(events)
        check(
            not alert_problems,
            f"slo_alert stream is not edge-disciplined: {alert_problems}",
        )
        if "slow_request" in args.inject_fault and args.deadline_ms:
            # The injected straggler's deadline sheds breach the shed
            # SLO exactly once — one fire edge mid-storm, one clear
            # edge after the quiet post-drain window, never spam — IF
            # the breach was real at slow-window scale (the storm's
            # overall shed fraction exceeded the objective). A blip
            # the slow window correctly suppressed must stay silent:
            # that suppression is the design, not a miss.
            frac = sum(summary["shed"].values()) / max(
                1, summary["requests"]
            )
            states = [
                a["state"] for a in alerts
                if a["objective"] == "shed_fraction"
            ]
            want = (
                ["fire", "clear"] if frac > args.slo_shed_frac else []
            )
            check(
                states == want,
                f"shed SLO edges {states} != {want} (storm shed "
                f"fraction {frac:.4f} vs objective "
                f"{args.slo_shed_frac})",
            )
        stem = os.path.splitext(metrics_path)[0]
        rows = metrics_report.load_rows(f"{stem}.series.jsonl")
        check(
            len(rows) == publisher.seq and rows[-1]["seq"] == publisher.seq,
            f"series file rows ({len(rows)}) != published snapshots "
            f"({publisher.seq})",
        )
        check(
            os.path.exists(f"{stem}.prom")
            and "serve_request_latency_ms_count" in open(f"{stem}.prom").read(),
            "Prometheus exposition file missing or incomplete",
        )
        print(
            f"serve_smoke: metrics plane {publisher.seq} snapshots, "
            f"{len(alerts)} alert edges, mid-storm p99="
            f"{round(mid_snap['pool']['p99_ms'], 1)}ms"
        )

    if tracer is not None:
        # Trace-file assertions: every completed
        # request's trace carries the full lifecycle chain under ONE
        # trace_id, and trace_report derives a per-bucket queue/device
        # breakdown from the file.
        from gnot_tpu_torch.obs import tracing
        from gnot_tpu_torch.tools import trace_report

        spans = trace_report.load_spans(args.trace_path)
        by_trace: dict = {}
        for s in spans:
            by_trace.setdefault(s["trace_id"], set()).add(s["name"])
        chain = set(tracing.SERVE_SPANS)
        complete = [t for t, names in by_trace.items() if chain <= names]
        # Head sampling is deterministic (floor-counter rule) and every
        # submit calls start_trace exactly once, so the sampled-trace
        # count is exact; at rate 1.0 every completed request must also
        # have a whole chain (a sampled shed chain legitimately stops
        # early, so below 1.0 only the bound holds).
        sampled = math.floor(args.n * args.trace_sample_rate)
        check(
            len(by_trace) == sampled,
            f"{len(by_trace)} sampled traces != floor(n*rate) = {sampled}",
        )
        if args.trace_sample_rate >= 1.0:
            # Trace ids assign in submit order at rate 1.0, so result i
            # is trace t(i+1): every COMPLETED request must have a
            # whole chain. Requests failed by an injected nan_output
            # also carry whole chains (they reached resolve), so the
            # ok set is a subset, not an equality.
            ok_traces = {
                f"t{i + 1:06d}" for i, r in enumerate(results) if r.ok
            }
            check(
                ok_traces <= set(complete),
                f"completed requests missing whole chains: "
                f"{sorted(ok_traces - set(complete))}",
            )
        else:
            check(
                len(complete) <= sampled,
                f"{len(complete)} complete chains exceed {sampled} "
                "sampled traces",
            )
        # Every bucket has queue-wait numbers; buckets that only ever
        # shed (no dispatch reached the device) legitimately carry no
        # device time, so require device numbers on at least one — and
        # only when some sampled request actually completed (at low
        # rates the lone sampled trace can be the injected straggler's
        # shed request, which never reaches the device). At rates low
        # enough that floor(n*rate) == 0 an empty breakdown is the
        # configured behavior — nothing to check.
        bb = trace_report.bucket_breakdown(spans)
        if sampled:
            check(
                bool(bb)
                and all(v["queue_p50_ms"] is not None for v in bb.values())
                and (
                    not complete
                    or any(
                        v["device_p50_ms"] is not None for v in bb.values()
                    )
                ),
                f"trace_report bucket breakdown empty/malformed: {bb}",
            )
        check(
            summary.get("queue_device_by_bucket") is not None,
            "serve_summary missing queue_device_by_bucket with tracing on",
        )
        print(
            f"serve_smoke: trace {args.trace_path}: {len(spans)} spans, "
            f"{len(complete)} complete chains, buckets={sorted(bb)}"
        )

    p50, p99 = summary["latency_p50_ms"], summary["latency_p99_ms"]
    if args.rollout and summary.get("sessions"):
        print(f"serve_smoke: sessions rollup {summary['sessions']}")
    print(
        f"serve_smoke: {n_ok}/{args.n} ok, shed={summary['shed']}, "
        f"p50={p50 if p50 is None else round(p50, 1)}ms "
        f"p99={p99 if p99 is None else round(p99, 1)}ms, "
        f"buckets={sorted(buckets)}, compiled={summary['compiled_shapes']}, "
        f"{len(packed_d)} packed / {len(padded_d)} padded dispatches, "
        f"{summary['requests_per_s']:.1f} req/s"
    )
    for msg in failures:
        print(f"FAIL: {msg}")
    # The port's server summary carries two keys of its own, a dispatch's
    # host-clock p50 and max (serve/server.py; the serve_summary event in
    # the sink keeps them): the smoke returns JAX's key set.
    for key in PORT_ONLY_SUMMARY_KEYS:
        summary.pop(key, None)
    summary["failures"] = failures
    return summary


def main(argv=None) -> int:
    return 1 if run(argv)["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
