"""Packing A/B: pad waste and throughput, padded against packed, on both
hot paths of the port.

Port of ``tools/pack_ab.py``, with its flags (plus ``--device``: ``cuda``
unless ``--device cpu`` is passed; without a card ``cuda`` raises), its
records and its summary record. On a mixed small-mesh ragged workload:

* **train**: tokens/s (REAL node tokens a second) of the padded and the
  packed train step of ``gnot_tpu_torch.bench.build`` on the same
  samples and model, timed by ``bench.time_steps`` in interleaved
  best-of-N windows (ambient drift hits both arms alike);
* **serve**: requests/s through the port's ``serve_smoke`` storm
  (``gnot_tpu_torch.tools.serve_smoke.run``, submit to last resolve) with
  per-bucket padded dispatch against ``--packed`` pack-plan dispatch, the
  same traffic and weights; every storm must pass the smoke's own
  assertions;
* **numerics**: every request's packed output against its own solo padded
  dispatch through ``serve_smoke.build_engine``, ``PackPlan`` and
  ``pack_prefix``: max |diff| <= 1e-5.

Pad waste is measured from the batch masks (train) and the
``serve_summary.pad_waste_by_bucket`` rollup (serve). Records go to
stdout, and to ``--out`` only when it is given.

Usage::

    python -m gnot_tpu_torch.tools.pack_ab --out build/pack_ab.jsonl
    python -m gnot_tpu_torch.tools.pack_ab --device cpu --steps 2 --repeats 1 --serve_n 8
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _token_counts(batch) -> tuple[int, int]:
    """(real, capacity) node tokens of one dispatch's static shape."""
    real = int(batch.node_mask.sum())
    capacity = int(batch.coords.shape[0] * batch.coords.shape[1])
    return real, capacity


def train_ab(config: str, n_points: int, batch_size: int, pack_chunk: int,
             steps: int, repeats: int, device: str = "cuda") -> tuple[dict, dict]:
    """Interleaved best-of-``repeats`` timed windows of the padded and the
    packed f32 train steps over the SAME samples (``bench.build`` draws
    both from one generator and one ``ModelConfig``)."""
    from gnot_tpu_torch import bench

    arms = {}
    for packed in (False, True):
        step, state, batch, _mc = bench.build(
            "float32", n_points=n_points, batch_size=batch_size,
            config=config, packed=packed, pack_chunk=pack_chunk, device=device,
        )
        real, capacity = _token_counts(batch)
        arms[packed] = {
            "step": step, "state": state, "batch": batch,
            "real": real, "capacity": capacity, "best": float("inf"),
        }
    for _ in range(max(1, repeats)):
        for packed in (False, True):  # interleaved: drift hits both arms
            a = arms[packed]
            a["best"] = min(
                a["best"],
                bench.time_steps(
                    a["step"], a["state"], a["batch"], 1e-3, 2, steps, a["state"].device,
                ),
            )
    out = []
    for packed in (False, True):
        a = arms[packed]
        out.append({
            "arm": "train_packed" if packed else "train_padded",
            "config": config, "n_points": n_points,
            "batch_size": batch_size,
            "pack_chunk": pack_chunk if packed else None,
            "ms_per_step": round(a["best"] * 1e3, 4),
            "real_tokens": a["real"], "capacity_tokens": a["capacity"],
            "pad_waste_frac": round(1.0 - a["real"] / a["capacity"], 4),
            "tokens_per_s": round(a["real"] / a["best"], 1),
        })
    return out[0], out[1]


def _serve_waste(summary: dict) -> float:
    """Measured pad waste over every executed dispatch."""
    pw = summary.get("pad_waste_by_bucket") or {}
    real = sum(v["real_tokens"] for v in pw.values())
    cap = sum(v["capacity_tokens"] for v in pw.values())
    return 1.0 - real / cap if cap else 0.0


def serve_ab(n: int, max_batch: int, pack_chunk: int, mesh_lo: int,
             mesh_hi: int, repeats: int, device: str = "cuda") -> tuple[dict, dict]:
    """Best-of-``repeats`` ``serve_smoke`` storms per arm, interleaved.
    Every storm must pass ALL the smoke's own assertions (bucket
    discipline, everything resolves): a fast but wrong arm is a failure,
    not a win."""
    from gnot_tpu_torch.tools import serve_smoke

    base = [
        "--n", str(n), "--max_batch", str(max_batch),
        "--inject_fault", "none", "--deadline_ms", "10000",
        "--mesh_lo", str(mesh_lo), "--mesh_hi", str(mesh_hi),
        "--device", device,
    ]
    arms = {False: None, True: None}
    for _ in range(max(1, repeats)):
        for packed in (False, True):
            argv = base + (
                ["--packed", "--pack_chunk", str(pack_chunk)] if packed else []
            )
            s = serve_smoke.run(argv)
            if s["failures"]:
                raise RuntimeError(
                    f"serve_smoke arm packed={packed} failed its own "
                    f"assertions: {s['failures']}"
                )
            best = arms[packed]
            if best is None or s["requests_per_s"] > best["requests_per_s"]:
                arms[packed] = s
    out = []
    for packed in (False, True):
        s = arms[packed]
        out.append({
            "arm": "serve_packed" if packed else "serve_unpacked",
            "n_requests": n, "max_batch": max_batch,
            "pack_chunk": pack_chunk if packed else None,
            "mesh_lo": mesh_lo, "mesh_hi": mesh_hi,
            "requests_per_s": round(s["requests_per_s"], 2),
            "dispatches": s["dispatches"],
            "latency_p50_ms": s["latency_p50_ms"],
            "latency_p99_ms": s["latency_p99_ms"],
            "pad_waste_frac": round(_serve_waste(s), 4),
        })
    return out[0], out[1]


def numerics_check(n: int, max_batch: int, pack_chunk: int, mesh_lo: int,
                   mesh_hi: int, device: str = "cuda") -> float:
    """max over requests of max |packed output - solo padded output|: the
    <= 1e-5 per-request bar, through the real engine on the traffic the
    serve A/B uses."""
    from gnot_tpu_torch.data.batch import PackPlan, pack_prefix
    from gnot_tpu_torch.tools import serve_smoke

    engine = serve_smoke.build_engine(max_batch=max_batch, device=device)
    traffic = serve_smoke.mixed_traffic(n, mesh_lo=mesh_lo, mesh_hi=mesh_hi)
    plan = PackPlan.from_samples(traffic, chunk=pack_chunk, batch_size=max_batch)
    solo = []
    for s in traffic:
        pn, pf = engine.bucket_key(s)
        solo.append(engine.infer([s], pad_nodes=pn, pad_funcs=pf, rows=max_batch)[0])
    packed_outs: list[np.ndarray] = []
    rest = list(traffic)
    while rest:
        placements = pack_prefix([s.coords.shape[0] for s in rest], plan)
        k = max(1, len(placements))
        packed_outs.extend(engine.infer_packed(rest[:k], plan, placements=placements[:k]))
        rest = rest[k:]
    return float(max(np.abs(p - s).max() for p, s in zip(packed_outs, solo)))


def main(argv=None) -> list[dict]:
    """Run the three parts; print (and return) the records."""
    p = argparse.ArgumentParser(description="Padded against packed, train and serve.")
    p.add_argument("--config", type=str, default="elasticity",
                   help="train-arm workload (a ragged bench config)")
    p.add_argument("--n_points", type=int, default=256,
                   help="train-arm base mesh size (elasticity spreads "
                        "sizes around it: the ragged mix)")
    p.add_argument("--batch_size", type=int, default=16,
                   help="train-arm samples per dispatch")
    p.add_argument("--pack_chunk", type=int, default=64)
    p.add_argument("--steps", type=int, default=8,
                   help="train-arm steps per timed window")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--serve_n", type=int, default=32,
                   help="serve-arm storm size")
    p.add_argument("--serve_max_batch", type=int, default=4)
    p.add_argument("--mesh_lo", type=int, default=40)
    p.add_argument("--mesh_hi", type=int, default=200,
                   help="serve-arm ragged sizes: the mixed SMALL-mesh "
                        "workload packing exists for")
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where both arms run; cuda raises without a card")
    args = p.parse_args(argv)

    # JAX's platform names: "gpu" for a CUDA card.
    platform = "gpu" if args.device == "cuda" else "cpu"
    t0 = time.perf_counter()
    tr_pad, tr_pack = train_ab(
        args.config, args.n_points, args.batch_size, args.pack_chunk,
        args.steps, args.repeats, args.device,
    )
    sv_pad, sv_pack = serve_ab(
        args.serve_n, args.serve_max_batch, args.pack_chunk,
        args.mesh_lo, args.mesh_hi, args.repeats, args.device,
    )
    max_diff = numerics_check(
        args.serve_n, args.serve_max_batch, args.pack_chunk,
        args.mesh_lo, args.mesh_hi, args.device,
    )
    records = [tr_pad, tr_pack, sv_pad, sv_pack]
    for r in records:
        r["platform"] = platform
    records.append({
        "summary": "pack_ab",
        "platform": platform,
        "train_tokens_per_s_padded": tr_pad["tokens_per_s"],
        "train_tokens_per_s_packed": tr_pack["tokens_per_s"],
        "train_speedup": round(tr_pack["tokens_per_s"] / tr_pad["tokens_per_s"], 3),
        "train_pad_waste_padded": tr_pad["pad_waste_frac"],
        "train_pad_waste_packed": tr_pack["pad_waste_frac"],
        "serve_requests_per_s_unpacked": sv_pad["requests_per_s"],
        "serve_requests_per_s_packed": sv_pack["requests_per_s"],
        "serve_speedup": round(sv_pack["requests_per_s"] / sv_pad["requests_per_s"], 3),
        "serve_pad_waste_unpacked": sv_pad["pad_waste_frac"],
        "serve_pad_waste_packed": sv_pack["pad_waste_frac"],
        "max_abs_diff": max_diff,
        "elapsed_s": round(time.perf_counter() - t0, 1),
        "bar": "pad waste down and throughput up on BOTH paths; "
               "max_abs_diff <= 1e-5",
    })
    out = "\n".join(json.dumps(r) for r in records) + "\n"
    sys.stdout.write(out)
    sys.stdout.flush()
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    return records


if __name__ == "__main__":
    main()
