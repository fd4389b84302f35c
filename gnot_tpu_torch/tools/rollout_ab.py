"""Chaos A/B: fault-tolerant rollout serving vs a no-migration twin.

Port of ``tools/rollout_ab.py``, with its flags, ``run`` / ``main``,
records, summary and bars (plus ``--device``: ``cuda`` unless ``--device
cpu`` is passed; without a card ``cuda`` raises). A storm of concurrent
K-step autoregressive rollout sessions (``serve/rollout.py``) over a
2-replica pool, with replica 0 KILLED mid-storm (``replica_kill@N``: its
worker dies, every in-system request fails ``error_replica_dead``). Two
arms, identical traffic, identical fault:

* ``migration``: ``session_migration=True`` (the default): the router
  re-places every orphaned session on the surviving replica from its last
  host-side snapshot and replays forward. Bars: **0 lost sessions**, at
  least one migrated, and every served rollout within 1e-5 a step of the
  offline engine-only K-step loop (``offline_rollout``).
* ``no_migration``: the twin with migration disabled: sessions resident
  on the killed replica resolve with the failure. Bar: **losses >= 1**
  (the kill genuinely orphaned sessions).

The two replicas share the one device, each on its own CUDA stream there
(``build_replicas``), where JAX asks the host platform for 8 devices and
puts them on two. A broken bar lands in the returned summary's
``failures`` (``main`` exits 1), as in JAX.

Usage::

    python -m gnot_tpu_torch.tools.rollout_ab --out build/rollout_ab.jsonl
    python -m gnot_tpu_torch.tools.rollout_ab --device cpu --quick --out build/rollout_ab.jsonl

Writes JSONL to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BAR_NUMERIC = 1e-5


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Rollout chaos A/B: migration against a twin.")
    p.add_argument("--out", type=str, required=True, help="JSONL output")
    p.add_argument("--sessions", type=int, default=12)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument(
        "--kill_at_step", type=int, default=8,
        help="replica 0 dies before dispatching its Nth rollout step "
             "(1-indexed per-server step admission ordinal): mid-storm"
    )
    p.add_argument(
        "--snapshot_every", type=int, default=2,
        help="session snapshot cadence > 1, so migration exercises a "
             "REAL replay (steps past the snapshot re-execute)"
    )
    p.add_argument("--max_batch", type=int, default=2)
    p.add_argument(
        "--quick", action="store_true",
        help="smaller storm for the in-process test-suite smoke"
    )
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where both replicas run; cuda raises without a card")
    args = p.parse_args(argv)
    if args.quick:
        args.sessions, args.steps, args.kill_at_step = 6, 4, 4

    from gnot_tpu_torch.resilience.faults import FaultInjector
    from gnot_tpu_torch.serve import ReplicaRouter, build_replicas, offline_rollout, rollout
    from gnot_tpu_torch.tools import serve_smoke
    from gnot_tpu_torch.utils.metrics import MetricsSink

    engine = serve_smoke.build_engine(max_batch=args.max_batch, device=args.device)
    traffic = serve_smoke.mixed_traffic(args.sessions, seed=7, mesh_lo=100, mesh_hi=300)
    engine.warmup(traffic, rows=args.max_batch)
    records: list[dict] = []
    failures: list[str] = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(msg)

    # The offline engine-only reference trajectories (no serve stack).
    reference = [
        offline_rollout(engine, s, args.steps, rows=args.max_batch)
        for s in traffic
    ]

    arm_stats: dict[str, dict] = {}
    arm_results: dict[str, list] = {}
    for arm, migrate in (("migration", True), ("no_migration", False)):
        replicas = build_replicas(engine.model, 2, batch_size=args.max_batch)
        for r in replicas:
            r.warm(traffic, rows=args.max_batch)
        sink_path = f"{args.out}.{arm}.events.jsonl"
        with MetricsSink(sink_path) as sink:
            router = ReplicaRouter(
                replicas,
                sink=sink,
                max_batch=args.max_batch,
                max_wait_ms=2.0,
                session_snapshot_every=args.snapshot_every,
                session_migration=migrate,
                faults={0: FaultInjector.from_spec(f"replica_kill@{args.kill_at_step}")},
            ).start()
            futures = [router.submit_rollout(s, args.steps) for s in traffic]
            results = [f.result(timeout=120) for f in futures]
            summary = router.drain()
        sess = summary.get("sessions") or {}
        lost = [r for r in results if not r.ok]
        check(
            len(results) == args.sessions,
            f"{arm}: {len(results)} futures resolved != {args.sessions}",
        )
        check(
            sess.get("lost", 0) == len(lost),
            f"{arm}: rollup lost={sess.get('lost')} != observed {len(lost)}",
        )
        with open(sink_path) as f:
            events = [json.loads(line) for line in f if line.strip()]
        kills = [
            e for e in events
            if e.get("event") == "replica_health" and e.get("reason") == "dead"
        ]
        check(bool(kills), f"{arm}: replica 0 never read dead: the kill didn't land")
        arm_stats[arm] = {
            "arm": arm,
            "sessions": args.sessions,
            "steps": args.steps,
            "snapshot_every": args.snapshot_every,
            "killed_replica": 0,
            "kill_at_step": args.kill_at_step,
            "completed": sess.get("completed", 0),
            "lost": len(lost),
            "lost_reasons": sorted({r.reason for r in lost}),
            "migrated": sess.get("migrated", 0),
            "drained": sess.get("drained", 0),
            "shed": sess.get("shed", 0),
            "steps_committed": sum(r.steps_completed for r in results),
            "step_latency_p50_ms": sess.get("step_latency_p50_ms"),
            "step_latency_p99_ms": sess.get("step_latency_p99_ms"),
        }
        records.append(arm_stats[arm])
        arm_results[arm] = results
        os.remove(sink_path)

    # The bars: zero lost with migration, measured losses without.
    mig, nomig = arm_stats["migration"], arm_stats["no_migration"]
    check(mig["lost"] == 0, f"migration arm lost {mig['lost']} sessions (must be 0)")
    check(
        mig["completed"] == args.sessions,
        f"migration arm completed {mig['completed']}/{args.sessions}",
    )
    check(mig["migrated"] >= 1, "migration arm never migrated a session")
    check(nomig["lost"] >= 1, "no-migration twin lost nothing: the kill was vacuous")

    # Parity: every served rollout (migrated sessions included) matches
    # the offline engine-only loop per step, at the original tolerance.
    worst = 0.0
    for r, ref in zip(arm_results["migration"], reference):
        if not r.ok:
            continue
        worst = max(worst, rollout.parity_check(r.outputs, ref, atol=BAR_NUMERIC))
    check(
        worst <= BAR_NUMERIC,
        f"served rollouts drifted {worst} from the offline loop (bar {BAR_NUMERIC})",
    )
    records.append(
        {
            "probe": "parity",
            "sessions_checked": sum(r.ok for r in arm_results["migration"]),
            "steps": args.steps,
            "max_abs_diff": worst,
            "bar": BAR_NUMERIC,
        }
    )

    summary_rec = {
        "summary": "rollout_ab",
        "quick": args.quick,
        "sessions": args.sessions,
        "steps": args.steps,
        "snapshot_every": args.snapshot_every,
        "kill_at_step": args.kill_at_step,
        "lost_migration": mig["lost"],
        "lost_no_migration": nomig["lost"],
        "migrated": mig["migrated"],
        "max_abs_diff": worst,
        "bar_numeric": BAR_NUMERIC,
        "bar_lost_migration": 0,
    }
    records.append(summary_rec)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(
        f"rollout_ab: migration lost={mig['lost']} "
        f"(migrated={mig['migrated']}) vs no_migration "
        f"lost={nomig['lost']}; parity max |diff| = {worst:.2e} "
        f"(bar {BAR_NUMERIC}); wrote {args.out}"
    )
    for msg in failures:
        print(f"FAIL: {msg}")
    summary_rec = dict(summary_rec)
    summary_rec["failures"] = failures
    return summary_rec


def main(argv=None) -> int:
    return 1 if run(argv)["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
