"""Capacity report of the port: program costs x live traffic, headroom,
and the pack-plan recommendation the observed traffic supports.

Port of ``tools/capacity_report.py``, with the same flags (plus the
port's ``--device``), functions, records and exit code. It runs a
``serve_smoke`` storm with the program catalog attached (``--capacity``;
``gnot_tpu_torch.tools.serve_smoke``) and folds the resulting
``serve_summary.capacity_model`` into the operator's tables:

* **program rows** — one per dispatched program: its cost entry (the
  counted flops and bytes of ``obs/costs.py``, or the explicit
  ``unavailable`` marker), attributed traffic (dispatches, requests,
  real vs capacity tokens, device seconds) and the derived rates.
* **capacity row** — the pool model against the observed offered load:
  sustainable requests/s and tokens/s (the 100%-device-duty bound)
  against what the storm offered, as headroom ratios, with an
  ``agreement`` block holding the model's traffic totals to the
  summary's own counters number for number (``problems`` must be empty).
* **pack_recommendation row** — a ``PackPlan`` searched over the traffic
  the catalog observed (per-bucket request counts and mean sizes rebuilt
  from the padded programs' token tallies), each candidate simulated with
  the server's own first-fit FIFO prefix packing, its projected pad waste
  beside the measured padded waste and the committed packed-arm baseline
  (docs/artifacts/pack_ab.jsonl, a ratio of tokens on the same traffic).

Usage::

    python -m gnot_tpu_torch.tools.capacity_report --out build/capacity.jsonl
    python -m gnot_tpu_torch.tools.capacity_report --device cpu

Defaults reproduce the pack_ab serve arm's storm (same traffic
generator, same knobs). The pure parts (``program_rows``, ``agreement``,
``capacity_row``, ``reconstruct_sizes``, ``pack_recommendation``,
``load_baseline``) read a capacity model from any run, e.g. the
``serve_summary`` event of ``main --serve`` with a catalog.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _round(x, nd=4):
    return None if x is None else round(x, nd)


def program_rows(model: dict) -> list[dict]:
    """One record per program: the cost x traffic join, verbatim."""
    rows = []
    for key, prog in model["programs"].items():
        rows.append({
            "record": "program",
            "program": key,
            "source": prog["source"],
            "costs": prog["costs"],
            "dispatches": prog["dispatches"],
            "requests": prog["requests"],
            "real_tokens": prog["real_tokens"],
            "capacity_tokens": prog["capacity_tokens"],
            "device_s": _round(prog["device_s"], 6),
            "useful_token_frac": _round(prog["useful_token_frac"]),
            "device_us_per_token": _round(prog["device_us_per_token"], 3),
            "tokens_per_device_s": _round(prog["tokens_per_device_s"], 1),
            "flops_per_s": _round(prog["flops_per_s"], 1),
        })
    return rows


def agreement(summary: dict, model: dict) -> dict:
    """The model's traffic totals vs serve_summary's own counters —
    the two views are one accounting; any drift is a bug."""
    pool = model["pool"]
    pw = summary.get("pad_waste_by_bucket") or {}
    checks = {
        "dispatches": (pool["dispatches"], summary.get("dispatches")),
        "real_tokens": (
            pool["real_tokens"],
            sum(st["real_tokens"] for st in pw.values()),
        ),
        "capacity_tokens": (
            pool["capacity_tokens"],
            sum(st["capacity_tokens"] for st in pw.values()),
        ),
    }
    problems = [
        f"{name}: model {a} != summary {b}"
        for name, (a, b) in checks.items()
        if a != b
    ]
    return {
        **{name: a for name, (a, _) in checks.items()},
        "problems": problems,
    }


def capacity_row(summary: dict, model: dict) -> dict:
    """Pool capacity vs observed offered load, as headroom ratios
    (``summary``'s ``wall_s`` and ``requests_per_s`` are the smoke's; a
    summary without them leaves the offered rates None)."""
    pool = model["pool"]
    wall = summary.get("wall_s") or 0.0
    offered_rps = summary.get("requests_per_s")
    offered_tps = pool["real_tokens"] / wall if wall else None
    sus_rps = pool["sustainable_requests_per_s"]
    sus_tps = pool["sustainable_tokens_per_s"]
    return {
        "record": "capacity",
        "replicas": pool["replicas"],
        "programs": pool["programs"],
        "dispatches": pool["dispatches"],
        "requests": pool["requests"],
        "real_tokens": pool["real_tokens"],
        "capacity_tokens": pool["capacity_tokens"],
        "useful_token_frac": _round(pool["useful_token_frac"]),
        "device_s": _round(pool["device_s"], 6),
        "sustainable_requests_per_s": _round(sus_rps, 1),
        "sustainable_tokens_per_s": _round(sus_tps, 1),
        "offered_requests_per_s": _round(offered_rps, 1),
        "offered_tokens_per_s": _round(offered_tps, 1),
        # Headroom > 1: the pool could absorb that factor more load at
        # 100% device duty. The autoscaler's capacity-side signal.
        "headroom_requests": _round(
            sus_rps / offered_rps if sus_rps and offered_rps else None, 2
        ),
        "headroom_tokens": _round(
            sus_tps / offered_tps if sus_tps and offered_tps else None, 2
        ),
        "agreement": agreement(summary, model),
    }


def reconstruct_sizes(model: dict, chunk: int) -> tuple[list[int], list[dict]]:
    """Per-request mesh sizes reconstructed from the padded programs'
    observed traffic (requests + real tokens per bucket). Arrival
    order is modeled as a STRIDE interleave — each bucket's requests
    spread evenly over the sequence, so a numerous bucket (the Darcy64
    queries of the mixed workload) appears proportionally often
    between the rarer large meshes, like the storm that produced the
    histogram. The reconstruction is exact for the pack simulation
    when each bucket's sizes share one chunk-aligned segment length
    (true whenever the bucket spans at most one chunk band)."""
    slots: list[tuple[float, int, int]] = []
    buckets = []
    for bi, (key, prog) in enumerate(sorted(model["programs"].items())):
        if not key.startswith("bucket:") or not prog["requests"]:
            continue
        pn = int(key.split(":")[1].split("x")[0])
        reqs, real = prog["requests"], prog["real_tokens"]
        mean = real // reqs
        rem = real - mean * reqs
        sizes = [min(pn, mean + 1)] * rem + [max(1, mean)] * (reqs - rem)
        for i, n in enumerate(sizes):
            slots.append(((i + 0.5) / reqs, bi, n))
        buckets.append({
            "bucket": pn,
            "requests": reqs,
            "mean_size": _round(real / reqs, 1),
        })
    slots.sort(key=lambda t: (t[0], t[1]))
    return [n for _, _, n in slots], buckets


def _simulate(sizes: list[int], plan, max_batch: int) -> tuple[int, int, int]:
    """(packed_dispatches, fallback_dispatches, capacity_tokens) of
    running ``sizes`` through the server's own first-fit FIFO prefix
    packing under ``plan``; oversize requests take the padded
    per-bucket fallback path at their bucket's capacity."""
    from gnot_tpu_torch.data.batch import bucket_length, pack_prefix

    packable = [n for n in sizes if plan.aligned(n) <= plan.row_len]
    oversize = [n for n in sizes if plan.aligned(n) > plan.row_len]
    rest, packed_dispatches = packable, 0
    while rest:
        placements = pack_prefix(rest, plan)
        k = max(1, len(placements))
        packed_dispatches += 1
        rest = rest[k:]
    capacity = packed_dispatches * plan.capacity_tokens
    fallback_dispatches = 0
    by_bucket: dict[int, int] = {}
    for n in oversize:
        by_bucket[bucket_length(n)] = by_bucket.get(bucket_length(n), 0) + 1
    for pn, cnt in by_bucket.items():
        d = -(-cnt // max_batch)
        fallback_dispatches += d
        capacity += d * max_batch * pn
    return packed_dispatches, fallback_dispatches, capacity


def pack_recommendation(
    model: dict, chunk: int, max_batch: int, baseline: float | None
) -> dict:
    """The adaptive-packing recommendation: search the plan grid
    (chunk-aligned row lengths x row counts) over the reconstructed
    observed traffic, simulating each candidate with the server's own
    packing, and report the lowest-projected-waste plan. A search, not
    a single heuristic derivation: the observed histogram says which
    grid its mix actually fills."""
    from gnot_tpu_torch.data.batch import PackPlan

    sizes, buckets = reconstruct_sizes(model, chunk)
    if not sizes:
        return {"record": "pack_recommendation", "plan": None,
                "reason": "no padded traffic observed"}
    pad_funcs = max(
        (
            int(k.split(":")[1].split("x")[1].split("@")[0])
            for k in model["programs"]
            if k.startswith("bucket:")
        ),
        default=0,
    )
    real = sum(sizes)
    max_aligned = max(-(-n // chunk) * chunk for n in sizes)
    best = None
    candidates = 0
    for row_len in range(max_aligned, 4 * max_aligned + 1, chunk):
        for n_rows in range(1, 2 * max_batch + 1):
            plan = PackPlan(
                row_len=row_len, chunk=chunk, n_rows=n_rows,
                n_slots=n_rows * (row_len // chunk), pad_funcs=pad_funcs,
            )
            candidates += 1
            packed_d, fallback_d, capacity = _simulate(
                sizes, plan, max_batch
            )
            waste = 1.0 - real / capacity if capacity else None
            # Lowest projected waste wins; ties break toward the
            # smaller dispatch capacity (cheapest program).
            if best is None or (waste, plan.capacity_tokens) < (
                best[0], best[1].capacity_tokens,
            ):
                best = (waste, plan, packed_d, fallback_d, capacity)
    projected, plan, packed_dispatches, fallback_dispatches, capacity = best
    observed = (
        1.0 - model["pool"]["real_tokens"] / model["pool"]["capacity_tokens"]
        if model["pool"]["capacity_tokens"]
        else None
    )
    return {
        "record": "pack_recommendation",
        "plan": dataclasses.asdict(plan),
        "candidates_searched": candidates,
        "observed_buckets": buckets,
        "requests": len(sizes),
        "packed_dispatches": packed_dispatches,
        "fallback_dispatches": fallback_dispatches,
        "real_tokens": real,
        "capacity_tokens": capacity,
        "observed_pad_waste": _round(observed),
        "projected_pad_waste": _round(projected),
        "baseline_packed_pad_waste": baseline,
        "beats_baseline": (
            None
            if baseline is None or projected is None
            else bool(projected <= baseline)
        ),
    }


def load_baseline(path: str) -> float | None:
    """The committed pack_ab packed-arm pad waste (the bar the
    recommendation must reproduce or beat on the same traffic)."""
    try:
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("summary") == "pack_ab":
                    return rec.get("serve_pad_waste_packed")
    except OSError:
        pass
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=32, help="storm size "
                   "(default: the pack_ab serve arm's)")
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--mesh_lo", type=int, default=40)
    p.add_argument("--mesh_hi", type=int, default=200)
    p.add_argument("--chunk", type=int, default=64,
                   help="recommendation plan's segment alignment")
    p.add_argument("--pack_ab", type=str,
                   default=os.path.join(
                       _REPO_ROOT, "docs", "artifacts", "pack_ab.jsonl"),
                   help="committed pack_ab artifact to read the "
                        "packed-arm baseline from")
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the storm runs: cuda (the default; raises "
                        "without a card) or cpu")
    args = p.parse_args(argv)

    from gnot_tpu_torch.tools import serve_smoke

    t0 = time.perf_counter()
    summary = serve_smoke.run([
        "--n", str(args.n), "--max_batch", str(args.max_batch),
        "--inject_fault", "none", "--deadline_ms", "10000",
        "--mesh_lo", str(args.mesh_lo), "--mesh_hi", str(args.mesh_hi),
        "--capacity", "--device", args.device,
    ])
    if summary["failures"]:
        print(f"FAIL: storm failed its own assertions: "
              f"{summary['failures']}")
        return 1
    model = summary["capacity_model"]
    records = program_rows(model)
    cap = capacity_row(summary, model)
    records.append(cap)
    rec = pack_recommendation(
        model, args.chunk, args.max_batch, load_baseline(args.pack_ab)
    )
    records.append(rec)
    records.append({
        "summary": "capacity_report",
        # The torch device type, where JAX names its backend's platform.
        "platform": args.device,
        "n_requests": args.n,
        "max_batch": args.max_batch,
        "mesh_lo": args.mesh_lo,
        "mesh_hi": args.mesh_hi,
        "chunk": args.chunk,
        "programs": model["pool"]["programs"],
        "agreement_problems": cap["agreement"]["problems"],
        "projected_pad_waste": rec.get("projected_pad_waste"),
        "baseline_packed_pad_waste": rec.get("baseline_packed_pad_waste"),
        "beats_baseline": rec.get("beats_baseline"),
        "elapsed_s": round(time.perf_counter() - t0, 1),
        "bar": "agreement_problems empty; projected_pad_waste <= the "
               "committed pack_ab packed-arm pad waste on the same "
               "traffic",
    })
    out = "\n".join(json.dumps(r) for r in records) + "\n"
    sys.stdout.write(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(out)
    ok = not cap["agreement"]["problems"] and rec.get("beats_baseline") in (
        True, None,
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
