"""Render the port's live-metrics time series (``gnot_tpu_torch/obs/
metrics.py``) and cross-check the final snapshot against the drain-time
``serve_summary``.

Port of ``tools/metrics_report.py``: the same views, flags, functions,
returned values and exit code. The metrics plane writes one JSONL row per
publish cycle (``<metrics-stem>.series.jsonl`` under
``--metrics_interval_s``); this is its reader:

* **per-series history** — for every histogram series: windowed p50 /
  p99 / rate (observations per second) over time, from the cumulative
  bucket deltas between consecutive rows; for counters: the
  per-interval rate; for gauges: the level.
* **pool size over time** — the ``pool_replicas`` gauge's trajectory
  and its step-integral in replica-seconds.
* **SLO breach intervals** — the fire->clear windows rebuilt from the
  ``slo_alert`` edges of the event stream (``--metrics``, the JSONL of
  the same run), held to edge discipline (a second ``fire`` without a
  ``clear`` between is a fault, not load).
* **per-tenant and per-host rollups**, and the federation's
  ``cluster_summary`` against its own event stream.
* **final-snapshot cross-check** — the last series row against the
  ``serve_summary`` event, number for number: counters exactly,
  percentiles within the histogram's estimate bound (``summary_agrees``,
  the check ``main --serve`` runs at drain).

Usage::

    python -m gnot_tpu_torch.tools.metrics_report run/serve.series.jsonl \
        --metrics run/serve.jsonl

Exit code 0 iff the series parses, the alert stream is edge-disciplined,
and (when ``--metrics`` has a serve_summary) the final snapshot agrees
with it. Host code: the standard library and the port's
``obs/metrics.py`` (``LogHistogram``, ``summary_agrees``).
"""

from __future__ import annotations

import argparse
import json
import sys

from gnot_tpu_torch.obs.metrics import LogHistogram, summary_agrees


def load_rows(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def series_history(rows: list[dict]) -> dict[str, list[dict]]:
    """Per-series derived history: one entry per row transition with
    windowed stats (histograms: delta p50/p99 + rate; counters: rate;
    gauges: level)."""
    out: dict[str, list[dict]] = {}
    prev: dict | None = None
    for row in rows:
        t = row["t"]
        dt = (t - prev["t"]) if prev is not None else None
        for key, st in row["series"].items():
            hist = out.setdefault(key, [])
            kind = st["type"]
            entry: dict = {"seq": row["seq"], "t": t, "type": kind}
            if kind == "histogram":
                base = (prev or {}).get("series", {}).get(key)
                delta = LogHistogram.delta(st, base)
                entry.update(
                    count=st["count"],
                    window_n=delta.count,
                    p50_ms=delta.percentile(0.50),
                    p99_ms=delta.percentile(0.99),
                    rate=(delta.count / dt) if dt else None,
                )
            elif kind == "counter":
                base = (prev or {}).get("series", {}).get(key)
                d = st["value"] - (base["value"] if base else 0)
                entry.update(
                    value=st["value"], rate=(d / dt) if dt else None
                )
            else:
                entry.update(value=st["value"])
            hist.append(entry)
        prev = row
    return out


def pool_size_series(rows: list[dict]) -> list[dict]:
    """Pool-size-over-time from the ``pool_replicas`` gauge the router
    registers: one ``{"seq", "t", "replicas"}`` entry per snapshot that
    carries the gauge (empty when the run never registered it — a
    single-server tier has no pool gauge)."""
    out: list[dict] = []
    for row in rows:
        for st in row["series"].values():
            if st["type"] == "gauge" and st["name"] == "pool_replicas":
                out.append(
                    {
                        "seq": row["seq"],
                        "t": row["t"],
                        "replicas": int(st["value"]),
                    }
                )
                break
    return out


def replica_seconds(series: list[dict]) -> float:
    """Step-integral of the pool size over the snapshot timeline — the
    capacity actually paid for (the autoscale A/B's efficiency axis,
    as reconstructable from the time series alone)."""
    total = 0.0
    for a, b in zip(series, series[1:]):
        total += (b["t"] - a["t"]) * a["replicas"]
    return total


def breach_intervals(events: list[dict]) -> tuple[list[dict], list[str]]:
    """(fire->clear intervals per objective, edge-discipline problems)
    from the ``slo_alert`` records of a metrics-event JSONL."""
    alerts = [e for e in events if e.get("event") == "slo_alert"]
    open_at: dict[str, dict] = {}
    intervals: list[dict] = []
    problems: list[str] = []
    for a in alerts:
        name = a["objective"]
        if a["state"] == "fire":
            if name in open_at:
                problems.append(
                    f"objective {name!r}: second fire without a clear"
                )
            open_at[name] = a
        elif a["state"] == "clear":
            start = open_at.pop(name, None)
            if start is None:
                problems.append(
                    f"objective {name!r}: clear without a prior fire"
                )
                continue
            intervals.append(
                {
                    "objective": name,
                    "kind": a["kind"],
                    "fired_ts": start.get("ts"),
                    "cleared_ts": a.get("ts"),
                    "peak_burn_fast": start["burn_fast"],
                }
            )
        else:
            problems.append(f"unknown slo_alert state {a['state']!r}")
    for name, a in open_at.items():
        intervals.append(
            {
                "objective": name,
                "kind": a["kind"],
                "fired_ts": a.get("ts"),
                "cleared_ts": None,  # still burning at end of stream
                "peak_burn_fast": a["burn_fast"],
            }
        )
    return intervals, problems


def tenant_breakdown(events: list[dict]) -> dict[str, dict]:
    """Per-tenant isolation rollup from a metrics-event JSONL
    (docs/serving.md "Multi-tenant isolation"): the final
    ``serve_summary``'s ``tenants`` block (requests / completed / shed
    / latency percentiles) joined with the ``tenant_quota_shed``
    admission events (``quota_shed_events``) and any tenant-scoped
    ``slo_alert`` edges (``slo_edges``). Empty when the run never
    carried a tenant tag — the single-tenant path emits none of
    these."""
    summaries = [
        e
        for e in events
        if e.get("event") == "serve_summary" and e.get("tenants")
    ]
    # Prefer the pool-level rollup when a router emitted both tiers.
    pool = [e for e in summaries if "per_replica" in e or "routing" in e]
    roll = ((pool or summaries)[-1]["tenants"] if summaries else {}) or {}
    out = {t: dict(st) for t, st in roll.items()}
    for e in events:
        if e.get("event") == "tenant_quota_shed":
            st = out.setdefault(e["tenant"], {})
            st["quota_shed_events"] = st.get("quota_shed_events", 0) + 1
        elif e.get("event") == "slo_alert" and e.get("tenant"):
            st = out.setdefault(e["tenant"], {})
            st.setdefault("slo_edges", []).append(
                (e["objective"], e["state"])
            )
    return out


def host_breakdown(rows: list[dict]) -> dict[str, dict]:
    """Per-host slice of a federated series (docs/distributed.md): the
    ``ClusterRouter`` publishes every host's registry snapshot under
    ``host<i>/<series_key>`` merged keys; this splits the LAST row back
    into per-host rollups — series count, counter totals by name, gauge
    levels, histogram observation totals. Empty for a single-host
    series (no prefixed keys)."""
    out: dict[str, dict] = {}
    if not rows:
        return out
    for key, st in rows[-1]["series"].items():
        host, sep, _rest = key.partition("/")
        if not sep or not host.startswith("host"):
            continue
        h = out.setdefault(
            host,
            {"series": 0, "counters": {}, "gauges": {}, "observations": 0},
        )
        h["series"] += 1
        name = st.get("name", key)
        if st["type"] == "counter":
            h["counters"][name] = h["counters"].get(name, 0) + st["value"]
        elif st["type"] == "gauge":
            h["gauges"][name] = st["value"]
        elif st["type"] == "histogram":
            h["observations"] += st.get("count", 0)
    return out


def cluster_crosscheck(events: list[dict]) -> tuple[dict | None, list[str]]:
    """(final ``cluster_summary`` or None, problems): the controller's
    drain-time ledger checked against the raw federation event stream
    it claims to roll up — one ``host_dead`` event per counted death,
    one ``session_remigrate`` per counted re-migration, heartbeats
    observed from every member host, and internal coherence (every
    one-shot resolved, lost bounded by sessions)."""
    summaries = [e for e in events if e.get("event") == "cluster_summary"]
    if not summaries:
        return None, []
    s = summaries[-1]
    problems: list[str] = []
    deaths = [e for e in events if e.get("event") == "host_dead"]
    remigs = [e for e in events if e.get("event") == "session_remigrate"]
    hb_hosts = {
        e["host"] for e in events if e.get("event") == "host_heartbeat"
    }
    if s["hosts_dead"] != len(deaths):
        problems.append(
            f"cluster_summary hosts_dead={s['hosts_dead']} != "
            f"{len(deaths)} host_dead events"
        )
    if s["remigrated"] != len(remigs):
        problems.append(
            f"cluster_summary remigrated={s['remigrated']} != "
            f"{len(remigs)} session_remigrate events"
        )
    if hb_hosts and s["hosts"] != len(hb_hosts):
        problems.append(
            f"cluster_summary hosts={s['hosts']} != heartbeats observed "
            f"from {sorted(hb_hosts)}"
        )
    if s["completed"] + s["shed"] != s["requests"]:
        problems.append(
            f"one-shot ledger incoherent: completed {s['completed']} + "
            f"shed {s['shed']} != requests {s['requests']}"
        )
    if s["lost"] > s["sessions"]:
        problems.append(
            f"lost {s['lost']} exceeds sessions {s['sessions']}"
        )
    return s, problems


def run(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("series", help="the <stem>.series.jsonl time series")
    p.add_argument(
        "--metrics", default="",
        help="the run's metrics-event JSONL (for slo_alert intervals "
             "and the serve_summary cross-check)",
    )
    p.add_argument(
        "--tail", type=int, default=5,
        help="history rows to print per series",
    )
    args = p.parse_args(argv)

    rows = load_rows(args.series)
    if not rows:
        print(f"FAIL: {args.series} is empty")
        return 1
    failures: list[str] = []
    seqs = [r["seq"] for r in rows]
    if seqs != sorted(set(seqs)):
        failures.append(f"snapshot seq not strictly increasing: {seqs}")

    hist = series_history(rows)
    print(f"{args.series}: {len(rows)} snapshots, {len(hist)} series\n")
    for key in sorted(hist):
        entries = hist[key][-args.tail:]
        kind = entries[-1]["type"]
        print(f"  {key} [{kind}]")
        for e in entries:
            if kind == "histogram":
                p50 = e["p50_ms"]
                p99 = e["p99_ms"]
                rate = e["rate"]
                print(
                    f"    seq {e['seq']:>4}  n={e['window_n']:>6}  "
                    f"p50={p50 if p50 is None else round(p50, 2)}ms  "
                    f"p99={p99 if p99 is None else round(p99, 2)}ms  "
                    f"rate={rate if rate is None else round(rate, 2)}/s"
                )
            elif kind == "counter":
                rate = e["rate"]
                print(
                    f"    seq {e['seq']:>4}  total={e['value']:>8}  "
                    f"rate={rate if rate is None else round(rate, 2)}/s"
                )
            else:
                print(f"    seq {e['seq']:>4}  value={e['value']}")

    per_host = host_breakdown(rows)
    if per_host:
        print(f"\nPer-host breakdown ({len(per_host)} hosts):")
        for host, st in sorted(per_host.items()):
            counters = ", ".join(
                f"{k}={v}" for k, v in sorted(st["counters"].items())
            )
            print(
                f"  {host}: {st['series']} series, "
                f"{st['observations']} observations"
                + (f", {counters}" if counters else "")
            )

    pool = pool_size_series(rows)
    if pool:
        sizes = [p["replicas"] for p in pool]
        print(
            f"\nPool size over time ({len(pool)} snapshots, "
            f"min={min(sizes)} max={max(sizes)}, "
            f"{replica_seconds(pool):.1f} replica-seconds):"
        )
        # Print the transitions (and the endpoints), not every row —
        # a long steady stretch is one line, not a page.
        last = None
        for i, p in enumerate(pool):
            if p["replicas"] != last or i in (0, len(pool) - 1):
                print(
                    f"  seq {p['seq']:>4}  t={p['t']:.3f}  "
                    f"replicas={p['replicas']}"
                )
                last = p["replicas"]

    if args.metrics:
        events = load_rows(args.metrics)
        intervals, problems = breach_intervals(events)
        failures.extend(problems)
        print(f"\nSLO breach intervals ({len(intervals)}):")
        for iv in intervals:
            end = (
                "open"
                if iv["cleared_ts"] is None
                else f"cleared @{iv['cleared_ts']:.3f}"
            )
            print(
                f"  {iv['objective']} [{iv['kind']}] fired "
                f"@{iv['fired_ts']:.3f} -> {end} "
                f"(burn_fast {iv['peak_burn_fast']})"
            )
        tb = tenant_breakdown(events)
        if tb:
            print(f"\nPer-tenant breakdown ({len(tb)} tenants):")
            for t, st in sorted(tb.items()):
                shed = st.get("shed") or {}
                p50, p99 = st.get("latency_p50_ms"), st.get("latency_p99_ms")
                print(
                    f"  {t}: requests={st.get('requests', 0)} "
                    f"completed={st.get('completed', 0)} "
                    f"shed={dict(sorted(shed.items()))} "
                    f"p50={p50 if p50 is None else round(p50, 2)}ms "
                    f"p99={p99 if p99 is None else round(p99, 2)}ms "
                    f"quota_shed_events={st.get('quota_shed_events', 0)}"
                )
                for obj, state in st.get("slo_edges", []):
                    print(f"    slo_alert {obj}: {state}")
                # Admission coherence: the fast-fail event stream and
                # the summary's shed counter are two views of the same
                # decisions — they must agree per tenant.
                n_ev = st.get("quota_shed_events", 0)
                n_sum = shed.get("shed_tenant_quota", 0)
                if "requests" in st and n_ev != n_sum:
                    failures.append(
                        f"tenant {t}: {n_ev} tenant_quota_shed events "
                        f"!= summary shed_tenant_quota {n_sum}"
                    )
        cluster, cluster_problems = cluster_crosscheck(events)
        if cluster is not None:
            failures.extend(cluster_problems)
            if not cluster_problems:
                print(
                    "\ncluster_summary agrees with the federation event "
                    f"stream (hosts={cluster['hosts']}, "
                    f"requests={cluster['requests']}, "
                    f"sessions={cluster['sessions']}, "
                    f"remigrated={cluster['remigrated']}, "
                    f"hosts_dead={cluster['hosts_dead']}, "
                    f"lost={cluster['lost']})"
                )
        summaries = [
            e
            for e in events
            if e.get("event") == "serve_summary" and "routing" not in e
        ] or [e for e in events if e.get("event") == "serve_summary"]
        # A federated run's serve_summary events are PER-HOST (each
        # covers one pool's slice of the storm); the merged series can
        # only be checked against the cluster ledger above.
        if summaries and cluster is None:
            # Prefer the pool-level summary when a router emitted both
            # tiers (per-replica summaries cover a subset each).
            pool = [e for e in events if e.get("event") == "serve_summary"
                    and ("per_replica" in e or "routing" in e)]
            summary = (pool or summaries)[-1]
            problems = summary_agrees(summary, rows[-1])
            if problems:
                failures.extend(
                    f"final snapshot vs serve_summary: {p}" for p in problems
                )
            else:
                print(
                    "\nfinal snapshot agrees with serve_summary "
                    f"(requests={summary['requests']}, "
                    f"completed={summary['completed']}, "
                    f"p99={summary['latency_p99_ms']})"
                )

    for msg in failures:
        print(f"FAIL: {msg}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(run())
