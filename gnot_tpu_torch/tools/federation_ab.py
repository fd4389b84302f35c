"""Chaos A/B: topology-honest federation vs a no-failover twin, plus the
federation-off single-host byte-pin.

Port of ``tools/federation_ab.py``, with its flags, ``run`` / ``main``,
records, summary and bars (plus ``--device``: ``cuda`` unless ``--device
cpu`` is passed; without a card ``cuda`` raises). Three probes over
identical traffic:

* ``chaos``: a 2-host loopback federation (``serve/federation.py``)
  running a storm of concurrent K-step rollout sessions; once a session
  is mid-trajectory its OWNER HOST IS KILLED (silent death: no goodbye
  frame, the lease just stops renewing). Bars: **0 lost sessions** (every
  orphan re-migrates to the survivor from its persisted ``SessionStore``
  snapshot), ``remigrated >= 1``, and every served rollout within 1e-5 a
  step of the offline engine-only K-step loop (``offline_rollout``).
* ``no_failover``: the twin with ``failover=False``: the dead host's
  sessions resolve ``host_dead``. Bar: **losses >= 1**.
* ``single_host_pin``: the federation-off path (``--hosts 1`` never
  touches federation.py): the SAME serial one-shot storm through a plain
  single-replica ``ReplicaRouter``, twice. Bars: per-request outputs
  **byte-identical** across the two runs, and the deterministic
  ``serve_summary`` ledger fields equal.

Every host's replica shares the one device, each on its own CUDA stream
there (as ``serve_smoke --hosts`` places them); the pin's two runs build a
fresh replica (weights copy and stream) each. A broken bar lands in the
returned summary's ``failures`` (``main`` exits 1), as in JAX.

Usage::

    python -m gnot_tpu_torch.tools.federation_ab --out build/federation_ab.jsonl
    python -m gnot_tpu_torch.tools.federation_ab --device cpu --quick --out build/federation_ab.jsonl

Writes JSONL to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

BAR_NUMERIC = 1e-5

#: serve_summary fields that are deterministic under a SERIAL storm
#: (no batching races, no wall-clock): the summary-level pin set.
PIN_FIELDS = (
    "requests", "admitted", "completed", "shed", "dispatches",
    "reloads", "breaker_trips", "compiled_shapes",
)


def _federated_storm(args, engine, traffic, *, failover: bool) -> dict:
    """One federated rollout storm with the owner of a mid-flight
    session killed. Returns results, the cluster ledger and the victim."""
    from gnot_tpu_torch.serve.federation import build_local_federation
    from gnot_tpu_torch.serve.replica import build_replica
    from gnot_tpu_torch.serve.rollout import SessionStore
    from gnot_tpu_torch.utils.metrics import MetricsSink

    groups = [
        [build_replica(engine.model, 0, engine.device, batch_size=args.max_batch)]
        for _ in range(args.hosts)
    ]
    tmp = tempfile.mkdtemp(prefix="federation_ab_")
    sink = MetricsSink(os.path.join(tmp, "events.jsonl"))
    cluster, agents = build_local_federation(
        groups,
        sink=sink,
        failover=failover,
        suspect_after_s=0.25,
        dead_after_s=0.6,
        session_store=SessionStore(os.path.join(tmp, "sessions")),
        router_kwargs=dict(
            max_batch=args.max_batch,
            max_wait_ms=2.0,
            session_snapshot_every=args.snapshot_every,
        ),
    )
    for a in agents.values():
        a.router.start()
    for g in groups:
        for r in g:
            r.warm(traffic, rows=args.max_batch)
    with sink:
        futs = [
            cluster.submit_rollout(s, args.steps, name=f"s{i:03d}")
            for i, s in enumerate(traffic)
        ]
        # Kill the owner of the first session caught mid-trajectory:
        # after real progress (snapshots exist), before the tail (the
        # kill cannot be a no-op).
        victim = None
        deadline = time.time() + 60
        while victim is None and time.time() < deadline:
            cluster.tick()
            for s in list(cluster._sessions.values()):
                if 2 <= s.streamed < args.steps - 2:
                    victim = s.owner
                    break
            time.sleep(0.01)
        if victim is None:
            raise RuntimeError("no session reached the kill window")
        agents[victim].kill()
        stop = threading.Event()
        died: list[BaseException] = []

        def _ticker():
            try:
                while not stop.is_set():
                    cluster.tick()
                    stop.wait(0.02)
            except Exception as e:  # the control loop's death, re-raised below
                died.append(e)

        t = threading.Thread(target=_ticker, daemon=True)
        t.start()
        try:
            results = [f.result(timeout=180) for f in futs]
        except TimeoutError:
            if died:
                raise RuntimeError("the control loop died mid-storm") from died[0]
            raise
        finally:
            stop.set()
            t.join(timeout=5)
        summary = cluster.drain()
    for a in agents.values():
        a.stop()
    cluster.close()
    return {"results": results, "summary": summary, "victim": victim}


def _single_host_storm(args, engine, traffic) -> dict:
    """The federation-off path: a serial one-shot storm through a plain
    single-replica ReplicaRouter (what ``--hosts 1`` runs). Returns
    per-request output bytes and the drain summary."""
    from gnot_tpu_torch.serve import ReplicaRouter, build_replicas

    replicas = build_replicas(engine.model, 1, batch_size=args.max_batch)
    for r in replicas:
        r.warm(traffic, rows=args.max_batch)
    router = ReplicaRouter(replicas, max_batch=args.max_batch, max_wait_ms=2.0).start()
    outs = []
    for s in traffic:
        res = router.submit(s).result(timeout=60)
        if not res.ok:
            router.drain()
            raise RuntimeError(f"single-host pin request failed: {res.reason}")
        outs.append(res.output.tobytes())
    summary = router.drain()
    return {"outputs": outs, "summary": summary}


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Federation chaos A/B and the single-host pin.")
    p.add_argument("--out", type=str, required=True, help="JSONL output")
    p.add_argument("--hosts", type=int, default=2)
    p.add_argument("--sessions", type=int, default=8)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument(
        "--snapshot_every", type=int, default=2,
        help="session snapshot cadence > 1, so a re-migration exercises "
             "a REAL cross-host replay from the persisted cursor"
    )
    p.add_argument("--max_batch", type=int, default=2)
    p.add_argument(
        "--quick", action="store_true",
        help="smaller storm for the in-process test-suite smoke"
    )
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where every replica runs; cuda raises without a card")
    args = p.parse_args(argv)
    if args.quick:
        args.sessions, args.steps = 4, 8

    from gnot_tpu_torch.serve import offline_rollout
    from gnot_tpu_torch.serve.rollout import parity_check
    from gnot_tpu_torch.tools import serve_smoke

    engine = serve_smoke.build_engine(max_batch=args.max_batch, device=args.device)
    traffic = serve_smoke.mixed_traffic(args.sessions, seed=7, mesh_lo=100, mesh_hi=300)
    engine.warmup(traffic, rows=args.max_batch)
    records: list[dict] = []
    failures: list[str] = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(msg)

    # The offline engine-only reference trajectories (no serve stack, no
    # federation) every served session must match.
    reference = [
        offline_rollout(engine, s, args.steps, rows=args.max_batch)
        for s in traffic
    ]

    arm_stats: dict[str, dict] = {}
    arm_out: dict[str, dict] = {}
    for arm, failover in (("chaos", True), ("no_failover", False)):
        out = _federated_storm(args, engine, traffic, failover=failover)
        results, summary = out["results"], out["summary"]
        lost = [r for r in results if not r.ok]
        check(
            len(results) == args.sessions,
            f"{arm}: {len(results)} futures resolved != {args.sessions}",
        )
        check(
            summary["lost"] == len(lost),
            f"{arm}: ledger lost={summary['lost']} != observed {len(lost)}",
        )
        check(
            summary["hosts_dead"] == 1,
            f"{arm}: hosts_dead={summary['hosts_dead']}: the kill "
            "didn't land as ONE dead host",
        )
        arm_stats[arm] = {
            "arm": arm,
            "hosts": args.hosts,
            "failover": failover,
            "sessions": args.sessions,
            "steps": args.steps,
            "snapshot_every": args.snapshot_every,
            "killed_host": out["victim"],
            "completed": summary["completed"],
            "lost": len(lost),
            "lost_reasons": sorted({r.reason for r in lost}),
            "remigrated": summary["remigrated"],
            "hosts_dead": summary["hosts_dead"],
            "protocol_errors": summary["protocol_errors"],
            "steps_committed": sum(r.steps_completed for r in results),
        }
        records.append(arm_stats[arm])
        arm_out[arm] = out

    chaos, nofail = arm_stats["chaos"], arm_stats["no_failover"]
    check(chaos["lost"] == 0, f"chaos arm lost {chaos['lost']} sessions (must be 0)")
    check(chaos["remigrated"] >= 1,
          "chaos arm never re-migrated a session: the kill was vacuous")
    check(
        chaos["completed"] == args.sessions,
        f"chaos arm completed {chaos['completed']}/{args.sessions}",
    )
    check(
        chaos["protocol_errors"] == 0,
        f"chaos arm counted {chaos['protocol_errors']} protocol errors",
    )
    check(nofail["lost"] >= 1, "no-failover twin lost nothing: the host kill was vacuous")
    check(
        nofail["lost_reasons"] == ["host_dead"],
        f"no-failover losses must read host_dead, got {nofail['lost_reasons']}",
    )

    # Parity: every chaos-arm rollout (re-migrated sessions included)
    # matches the offline loop per step, at the original tolerance.
    worst = 0.0
    for r, ref in zip(arm_out["chaos"]["results"], reference):
        worst = max(worst, parity_check(r.outputs, ref, atol=BAR_NUMERIC))
    check(
        worst <= BAR_NUMERIC,
        f"federated rollouts drifted {worst} from the offline loop (bar {BAR_NUMERIC})",
    )
    records.append(
        {
            "probe": "parity",
            "sessions_checked": sum(r.ok for r in arm_out["chaos"]["results"]),
            "steps": args.steps,
            "max_abs_diff": worst,
            "bar": BAR_NUMERIC,
        }
    )

    # The federation-off byte-pin: two identical single-host runs.
    pin_a = _single_host_storm(args, engine, traffic)
    pin_b = _single_host_storm(args, engine, traffic)
    byte_identical = pin_a["outputs"] == pin_b["outputs"]
    check(
        byte_identical,
        "single-host outputs differ between identical runs: the "
        "federation-off batcher path is no longer deterministic",
    )
    pin_view_a = {k: pin_a["summary"].get(k) for k in PIN_FIELDS}
    pin_view_b = {k: pin_b["summary"].get(k) for k in PIN_FIELDS}
    check(
        pin_view_a == pin_view_b,
        f"single-host serve_summary ledgers diverged: {pin_view_a} vs {pin_view_b}",
    )
    records.append(
        {
            "probe": "single_host_pin",
            "requests": len(traffic),
            "byte_identical": byte_identical,
            "summary_match": pin_view_a == pin_view_b,
            "summary_fields": list(PIN_FIELDS),
            "ledger": pin_view_a,
        }
    )

    summary_rec = {
        "summary": "federation_ab",
        "quick": args.quick,
        "hosts": args.hosts,
        "sessions": args.sessions,
        "steps": args.steps,
        "snapshot_every": args.snapshot_every,
        "lost_chaos": chaos["lost"],
        "lost_no_failover": nofail["lost"],
        "remigrated": chaos["remigrated"],
        "max_abs_diff": worst,
        "single_host_byte_identical": byte_identical,
        "bar_numeric": BAR_NUMERIC,
        "bar_lost_chaos": 0,
    }
    records.append(summary_rec)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(
        f"federation_ab: chaos lost={chaos['lost']} "
        f"(remigrated={chaos['remigrated']}) vs no_failover "
        f"lost={nofail['lost']}; parity max |diff| = {worst:.2e} "
        f"(bar {BAR_NUMERIC}); single-host pin "
        f"byte_identical={byte_identical}; wrote {args.out}"
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
