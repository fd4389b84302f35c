"""Trace analysis of the port: load a Chrome trace-event JSON written by
``--trace_path`` (``gnot_tpu_torch/obs/tracing.py``, or the merged cluster
trace of ``obs/dtrace.py``) and print where the time went.

Port of ``tools/trace_report.py``: the same three views, the same flags,
functions and returned dicts, so a trace reads the same through either.

1. **Per-span-kind latency table** — count, p50, p99, total wall-time
   per span name (``queue_wait``, ``device``, ``step_dispatch``, ...).
2. **Per-bucket queue-wait vs device-time breakdown** (serve traces) —
   a request's time divides into waiting for batchmates vs the forward,
   and both vary per bucket; the same split per replica, tenant and host.
3. **Critical path of the slowest request / step** — the single worst
   trace (serve: a request's admission→resolve chain; train: the
   slowest ``step`` span and its phase children), each phase with its
   duration and share, plus unattributed gap time.

Usage::

    python -m gnot_tpu_torch.tools.trace_report run/trace.json
    python -m gnot_tpu_torch.tools.trace_report run/trace.json --json

Host code: it reads JSON and prints text, and imports nothing but the
standard library and the port's ``obs/tracing.py::percentiles``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from gnot_tpu_torch.obs.tracing import percentiles


def load_spans(path: str) -> list[dict]:
    """Chrome ``traceEvents`` -> span dicts with ms floats. Only
    ``ph: "X"`` complete events are spans; metadata events pass."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", [])
    if not isinstance(events, list):
        raise ValueError(f"{path}: traceEvents is not a list")
    spans = []
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args", {})
        spans.append(
            {
                "name": e["name"],
                "start_ms": e["ts"] / 1e3,
                "dur_ms": e["dur"] / 1e3,
                "end_ms": (e["ts"] + e["dur"]) / 1e3,
                "trace_id": args.get("trace_id"),
                "span_id": args.get("span_id"),
                "parent_id": args.get("parent_id"),
                "args": args,
            }
        )
    return spans


def kind_stats(spans: list[dict]) -> dict[str, dict]:
    """name -> {count, p50_ms, p99_ms, total_ms}, ordered by total."""
    by_name: dict[str, list[float]] = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s["dur_ms"])
    out = {}
    for name, durs in sorted(
        by_name.items(), key=lambda kv: -sum(kv[1])
    ):
        out[name] = {
            "count": len(durs),
            **percentiles(durs),
            "total_ms": round(sum(durs), 4),
        }
    return out


def _queue_device_stats(spans: list[dict], arg_key: str) -> dict[str, dict]:
    """Group ``queue_wait``/``device`` spans by an args key and roll
    each group into queue-vs-device percentiles — the shared population
    definition behind both the per-bucket and per-replica views (change
    it here and both stay in agreement)."""
    groups: dict[str, dict[str, list[float]]] = {}
    for s in spans:
        key = s["args"].get(arg_key)
        if key is None or s["name"] not in ("queue_wait", "device"):
            continue
        st = groups.setdefault(str(key), {"queue_wait": [], "device": []})
        st[s["name"]].append(s["dur_ms"])
    out = {}
    for key, st in sorted(groups.items()):
        q, d = percentiles(st["queue_wait"]), percentiles(st["device"])
        out[key] = {
            "requests": len(st["queue_wait"]),
            "queue_p50_ms": q["p50_ms"],
            "queue_p99_ms": q["p99_ms"],
            "device_p50_ms": d["p50_ms"],
            "device_p99_ms": d["p99_ms"],
        }
    return out


def bucket_breakdown(spans: list[dict]) -> dict[str, dict]:
    """bucket -> queue-wait vs device-time percentiles (serve traces:
    ``queue_wait`` and ``device`` spans carry a ``bucket`` arg)."""
    return _queue_device_stats(spans, "bucket")


def replica_breakdown(spans: list[dict]) -> dict[str, dict]:
    """replica -> queue-wait vs device-time percentiles plus dispatch
    count (replicated serve traces: every span a replica server records
    carries a ``replica`` arg). This is how the load bench names the
    bottleneck PER REPLICA: a replica whose queue p99 dwarfs its device
    p99 is starved by placement or wedged, one whose device p99 grew is
    the sick engine. Empty for single-server traces (no replica args)."""
    out = {}
    dispatches: dict[str, set] = {}
    for s in spans:
        rep = s["args"].get("replica")
        if rep is not None and s["name"] == "dispatch":
            # dispatch spans repeat once per traced member; the
            # ``dispatch`` ordinal arg identifies the real dispatch.
            dispatches.setdefault(str(rep), set()).add(
                s["args"].get("dispatch", s["span_id"])
            )
    for rep, st in _queue_device_stats(spans, "replica").items():
        out[rep] = {
            "requests": st["requests"],
            "dispatches": len(dispatches.get(rep, ())),
            **{k: v for k, v in st.items() if k != "requests"},
        }
    return out


def tenant_breakdown(spans: list[dict]) -> dict[str, dict]:
    """tenant -> queue-wait vs device-time percentiles (multi-tenant
    serve traces: phase spans carry a ``tenant`` arg). The populations
    match ``serve_summary.tenants`` request-for-request over the traced
    subset, so a noisy-neighbor story told by the trace file can be
    cross-checked against the drain rollup. Empty when no request
    carried a tenant tag."""
    return _queue_device_stats(spans, "tenant")


def host_breakdown(spans: list[dict]) -> dict[str, dict]:
    """host -> queue-wait vs device-time percentiles plus placement
    count (merged FEDERATED traces: ``obs/dtrace.merge_traces`` stamps
    every remote span with a ``host`` arg, and controller ``placement``
    spans name their target host). Agrees with ``metrics_report``'s
    per-host view on which host is queue-bound vs device-bound. Empty
    for single-host traces."""
    placements: dict[str, int] = {}
    for s in spans:
        if s["name"] == "placement":
            h = s["args"].get("host")
            if h is not None:
                placements[str(h)] = placements.get(str(h), 0) + 1
    out = {}
    for host, st in _queue_device_stats(spans, "host").items():
        out[host] = {**st, "placements": placements.get(host, 0)}
    for host, n in placements.items():
        # A host that only ever RECEIVED placements (all its frames
        # lost / it died before exporting) still shows up honestly.
        out.setdefault(
            host,
            {
                "requests": 0, "queue_p50_ms": None, "queue_p99_ms": None,
                "device_p50_ms": None, "device_p99_ms": None,
                "placements": n,
            },
        )
    return dict(sorted(out.items()))


def critical_path(spans: list[dict]) -> dict | None:
    """The slowest request (serve) or step (train), phase by phase.

    Serve traces: the trace_id whose ``admission``..``resolve`` extent
    is longest; its spans in start order are the critical path (the
    chain is sequential by construction). Train traces: the slowest
    ``step`` span; its children plus itself. Returns ``{kind, trace_id,
    total_ms, phases: [{name, start_ms, dur_ms, share}], gap_ms}``."""
    steps = [s for s in spans if s["name"] == "step"]
    if steps and not any(s["name"] == "queue_wait" for s in spans):
        worst = max(steps, key=lambda s: s["dur_ms"])
        members = [worst] + [
            s for s in spans if s["parent_id"] == worst["span_id"]
        ]
        kind = "step"
    else:
        by_trace: dict[str, list[dict]] = {}
        for s in spans:
            if s["trace_id"] and s["name"] != "epoch":
                by_trace.setdefault(s["trace_id"], []).append(s)
        # Only complete request chains compete (a lone admission span
        # from a shed request isn't a latency story).
        candidates = {
            t: ss
            for t, ss in by_trace.items()
            if any(s["name"] == "resolve" for s in ss)
        } or by_trace
        if not candidates:
            return None
        members = max(
            candidates.values(),
            key=lambda ss: max(s["end_ms"] for s in ss)
            - min(s["start_ms"] for s in ss),
        )
        kind = "request"
    start = min(s["start_ms"] for s in members)
    end = max(s["end_ms"] for s in members)
    total = end - start
    phases = []
    attributed = 0.0
    for s in sorted(members, key=lambda s: (s["start_ms"], -s["dur_ms"])):
        if kind == "step" and s is not worst:
            attributed += s["dur_ms"]
        if kind == "request" and s["name"] not in (
            "admission", "batch_assembly", "device", "unpad"
        ):
            # The dispatch span CONTAINS assembly/device/unpad, and
            # admission is a sub-interval of queue_wait (both start at
            # submit); count only the non-overlapping top-level chain
            # (queue_wait, dispatch, resolve) toward attributed time so
            # gap_ms reports REAL unattributed gaps.
            attributed += s["dur_ms"]
        phases.append(
            {
                "name": s["name"],
                "start_ms": round(s["start_ms"] - start, 4),
                "dur_ms": round(s["dur_ms"], 4),
                "share": round(s["dur_ms"] / total, 4) if total else None,
            }
        )
    if kind == "step":
        attributed = min(attributed, worst["dur_ms"])
        total = worst["dur_ms"]
    return {
        "kind": kind,
        "trace_id": members[0]["trace_id"],
        "total_ms": round(total, 4),
        "phases": phases,
        "gap_ms": round(max(0.0, total - attributed), 4),
    }


def report(path: str) -> dict:
    spans = load_spans(path)
    return {
        "path": path,
        "spans": len(spans),
        "kinds": kind_stats(spans),
        "buckets": bucket_breakdown(spans),
        "replicas": replica_breakdown(spans),
        "tenants": tenant_breakdown(spans),
        "hosts": host_breakdown(spans),
        "critical_path": critical_path(spans),
    }


def _fmt(v) -> str:
    return "-" if v is None else f"{v:10.3f}"


def print_report(rep: dict) -> None:
    print(f"{rep['path']}: {rep['spans']} spans")
    print("\nper-span-kind latency (ms):")
    print(f"  {'kind':<16} {'count':>6} {'p50':>10} {'p99':>10} {'total':>10}")
    for name, st in rep["kinds"].items():
        print(
            f"  {name:<16} {st['count']:>6} {_fmt(st['p50_ms'])} "
            f"{_fmt(st['p99_ms'])} {_fmt(st['total_ms'])}"
        )
    if rep["buckets"]:
        print("\nqueue-wait vs device-time per bucket (ms):")
        print(
            f"  {'bucket':<12} {'reqs':>5} {'queue p50':>10} "
            f"{'queue p99':>10} {'device p50':>11} {'device p99':>11}"
        )
        for bucket, st in rep["buckets"].items():
            print(
                f"  {bucket:<12} {st['requests']:>5} "
                f"{_fmt(st['queue_p50_ms'])} {_fmt(st['queue_p99_ms'])} "
                f" {_fmt(st['device_p50_ms'])}  {_fmt(st['device_p99_ms'])}"
            )
    if rep.get("replicas"):
        print("\nqueue-wait vs device-time per replica (ms):")
        print(
            f"  {'replica':<8} {'reqs':>5} {'disp':>5} {'queue p50':>10} "
            f"{'queue p99':>10} {'device p50':>11} {'device p99':>11}"
        )
        for rid, st in rep["replicas"].items():
            print(
                f"  {rid:<8} {st['requests']:>5} {st['dispatches']:>5} "
                f"{_fmt(st['queue_p50_ms'])} {_fmt(st['queue_p99_ms'])} "
                f" {_fmt(st['device_p50_ms'])}  {_fmt(st['device_p99_ms'])}"
            )
    if rep.get("tenants"):
        print("\nqueue-wait vs device-time per tenant (ms):")
        print(
            f"  {'tenant':<12} {'reqs':>5} {'queue p50':>10} "
            f"{'queue p99':>10} {'device p50':>11} {'device p99':>11}"
        )
        for t, st in rep["tenants"].items():
            print(
                f"  {t:<12} {st['requests']:>5} "
                f"{_fmt(st['queue_p50_ms'])} {_fmt(st['queue_p99_ms'])} "
                f" {_fmt(st['device_p50_ms'])}  {_fmt(st['device_p99_ms'])}"
            )
    if rep.get("hosts"):
        print("\nqueue-wait vs device-time per host (ms, merged trace):")
        print(
            f"  {'host':<12} {'reqs':>5} {'place':>5} {'queue p50':>10} "
            f"{'queue p99':>10} {'device p50':>11} {'device p99':>11}"
        )
        for h, st in rep["hosts"].items():
            print(
                f"  {h:<12} {st['requests']:>5} {st['placements']:>5} "
                f"{_fmt(st['queue_p50_ms'])} {_fmt(st['queue_p99_ms'])} "
                f" {_fmt(st['device_p50_ms'])}  {_fmt(st['device_p99_ms'])}"
            )
    cp = rep["critical_path"]
    if cp is not None:
        print(
            f"\ncritical path — slowest {cp['kind']} "
            f"({cp['trace_id']}, {cp['total_ms']:.3f} ms total, "
            f"{cp['gap_ms']:.3f} ms unattributed):"
        )
        for ph in cp["phases"]:
            share = f"{ph['share'] * 100:5.1f}%" if ph["share"] is not None else ""
            print(
                f"  +{ph['start_ms']:9.3f} ms  {ph['name']:<16} "
                f"{ph['dur_ms']:9.3f} ms  {share}"
            )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("trace", help="Chrome trace-event JSON (--trace_path)")
    p.add_argument(
        "--json", action="store_true",
        help="emit the report as JSON instead of text",
    )
    args = p.parse_args(argv)
    if not os.path.exists(args.trace):
        print(f"no such trace file: {args.trace}", file=sys.stderr)
        return 2
    rep = report(args.trace)
    if args.json:
        json.dump(rep, sys.stdout, indent=1)
        print()
    else:
        print_report(rep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
