"""Low-precision serving A/B: f32 vs bf16 through the replica tier,
per-dataset quality parity, and the native dispatch path before/after.

Port of ``tools/lowprec_ab.py``, with its flags, defaults, functions
(``rel_l2``, ``parity_pass``, ``run_arm``, ``throughput_ab``,
``host_phase_ab``, ``device_microbench``, ``run``, ``main``), records,
summary and exit rule (plus ``--device``: ``cuda`` unless ``--device
cpu`` is passed; without a card ``cuda`` raises). Three measured claims:

1. **Quality parity**: for each dataset a small GNOT is trained in f32,
   then the SAME weights are served through the f32 engine and the bf16
   engine (``models/precision.py``: bf16 blocks, f32 accumulation,
   normalizer and head) and the test RelL2 is compared against
   ``PARITY_BAR``.
2. **Throughput** through the replica tier: open-loop Poisson arrivals
   over a shared offered-load ladder (``serve_bench``'s method and
   functions; the arms differ ONLY in the serving dtype), sustained req/s,
   tokens/s and p99 per arm.
3. **Dispatch hot path**: the same bf16 storm traced under the adaptive
   native packer against the forced numpy fallback, the ``trace_report``
   host phases (batch_assembly + unpad) before/after.

Where the port differs from JAX:

* Replicas share the one card, each on its own CUDA stream (JAX gives each
  a host device through ``XLA_FLAGS``, dropped here); the compile cache is
  not enabled (eager PyTorch has none).
* ``device_microbench`` times one warm dispatch per dtype and a 1024^2
  ``torch.matmul`` pair (a plain product, timed to the device's end) on
  the run's device. JAX's record carries a note that its CPU backend
  upcasts bf16 products; the port's ``note`` and the summary's
  ``cpu_proxy_note`` say what this run's numbers show: that bf16 is slower
  where it is, faster where it is. The key names (``*_cpu``) are JAX's.

Usage::

    python -m gnot_tpu_torch.tools.lowprec_ab --out build/lowprec_ab.jsonl
    python -m gnot_tpu_torch.tools.lowprec_ab --device cpu --quick --out build/lowprec_ab.jsonl

Writes JSONL (every record also printed) to ``--out`` when it is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from gnot_tpu_torch.tools import serve_bench

#: Per-dataset |RelL2(bf16) - RelL2(f32)| bar, JAX's. The policy keeps
#: every RelL2-critical site f32, so the delta is bf16 input and block
#: quantization only.
PARITY_BAR = 0.01

#: Datasets the parity pass trains and serves (name -> (synthetic config,
#: synth_size)), JAX's: every schema (uniform grid, ragged 2D clouds, 3D
#: clouds).
PARITY_DATASETS = {
    "darcy64": ("darcy2d", 8),  # 64-point uniform grid (serve_smoke's mix)
    "elasticity": ("elasticity", 256),
    "ns2d": ("ns2d", 256),
    "heatsink3d": ("heatsink3d", 512),
}


def log_line(out, **kw):
    rec = dict(kw)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)
    return rec


def _sync(device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# -- 1. quality parity ------------------------------------------------------


def rel_l2(preds, samples) -> float:
    """Mean per-sample relative L2 against the targets, the repo's eval
    metric, computed host-side on unpadded outputs."""
    vals = [
        float(np.linalg.norm(p - s.y) / max(np.linalg.norm(s.y), 1e-12))
        for p, s in zip(preds, samples)
    ]
    return float(np.mean(vals))


def parity_pass(args, out):
    """Train f32, serve the same weights at f32 and bf16, compare."""
    import dataclasses

    from gnot_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.serve import InferenceEngine
    from gnot_tpu_torch.train.trainer import Trainer

    names = [n.strip() for n in args.datasets.split(",") if n.strip()]
    records = []
    for name in names:
        synth, size = PARITY_DATASETS[name]
        cfg = Config(
            data=DataConfig(synthetic=synth, synth_size=size, n_train=args.parity_n_train,
                            n_test=args.parity_n_test, batch_size=4),
            train=TrainConfig(epochs=args.parity_epochs),
        )
        train_samples, test_samples = datasets.load(cfg.data)
        mc = dataclasses.replace(
            ModelConfig(),
            n_attn_layers=2, n_attn_hidden_dim=64, n_mlp_num_layers=2,
            n_mlp_hidden_dim=64, n_input_hidden_dim=64, n_expert=2,
            n_head=4, **datasets.infer_model_dims(train_samples),
        )
        trainer = Trainer(cfg, mc, train_samples, test_samples, device=args.device)
        best = trainer.fit()
        model = trainer.standard_model()
        preds32 = InferenceEngine(model, batch_size=4).predict(test_samples)
        preds16 = InferenceEngine(model, batch_size=4, dtype="bfloat16").predict(test_samples)
        r32 = rel_l2(preds32, test_samples)
        r16 = rel_l2(preds16, test_samples)
        records.append(log_line(
            out,
            probe="parity",
            dataset=name,
            synthetic=synth,
            synth_size=size,
            epochs=args.parity_epochs,
            n_test=len(test_samples),
            best_train_metric=best,
            rel_l2_f32=round(r32, 6),
            rel_l2_bf16=round(r16, 6),
            delta=round(r16 - r32, 6),
            bar=PARITY_BAR,
        ))
    return records


# -- 2. replica-tier throughput A/B ----------------------------------------


def run_arm(router, traffic, *, offered_rps, duration_s, seed) -> dict:
    """One open-loop run (serve_bench's method) that ALSO counts the node
    tokens of completed requests, for tokens/s."""
    rng = np.random.default_rng(seed)
    router.start()
    futures = []
    tokens = []
    t0 = time.perf_counter()
    deadline = t0 + duration_s
    next_at = t0 + float(rng.exponential(1.0 / offered_rps))
    i = 0
    while next_at < deadline:
        now = time.perf_counter()
        if now < next_at:
            time.sleep(next_at - now)
        s = traffic[i % len(traffic)]
        futures.append(router.submit(s))
        tokens.append(s.coords.shape[0])
        i += 1
        next_at += float(rng.exponential(1.0 / offered_rps))
    results = [f.result(timeout=300) for f in futures]
    last_done = time.perf_counter()
    summary = router.drain()
    elapsed = last_done - t0
    completed = sum(r.ok for r in results)
    tokens_ok = sum(t for t, r in zip(tokens, results) if r.ok)
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
        "tokens_per_s": round(tokens_ok / elapsed, 1) if elapsed > 0 else None,
        "p50_ms": (
            round(summary["latency_p50_ms"], 2)
            if summary["latency_p50_ms"] is not None else None
        ),
        "p99_ms": (
            round(summary["latency_p99_ms"], 2)
            if summary["latency_p99_ms"] is not None else None
        ),
        "dispatches": summary["dispatches"],
        "dtype": summary["dtype"],
    }


def throughput_ab(args, model, traffic, out):
    # Capacity probe and shared SLO from the f32 solo engine (one SLO,
    # both arms: "equal p99" means held to the same number).
    dispatch_s = serve_bench.dispatch_seconds(model, traffic, max_batch=args.max_batch)
    cap1 = args.max_batch / dispatch_s
    # 15x one dispatch: roomier than serve_bench's 12x (the ladder probes
    # each arm's queueing knee).
    slo = args.slo_p99_ms or serve_bench.auto_slo_ms(dispatch_s, 15.0)
    print(
        f"lowprec_ab: f32 dispatch {dispatch_s * 1e3:.1f} ms -> offered "
        f"ladder off {cap1:.0f} req/s/replica, shared p99 SLO {slo} ms"
    )

    pools = {}
    for dtype in ("float32", "bfloat16"):
        pools[dtype] = serve_bench.make_replicas(
            model, args.replicas, max_batch=args.max_batch,
            traffic=traffic, dtype=dtype,
        )
        warm = pools[dtype][1]
        print(f"  warmed {dtype}: {warm['programs_warmed']} programs")

    loads = [float(x) for x in args.loads.split(",")]
    records = []
    for li, mult in enumerate(loads):
        offered = mult * cap1 * args.replicas
        for dtype in ("float32", "bfloat16"):  # interleaved arms
            router = serve_bench.fresh_router(
                pools[dtype][0], max_batch=args.max_batch,
                queue_limit=args.queue_limit,
            )
            rec = run_arm(
                router, traffic, offered_rps=offered,
                duration_s=args.duration_s, seed=args.seed + li,
            )
            rec = log_line(
                out,
                arm=f"serve_{'f32' if dtype == 'float32' else 'bf16'}",
                replicas=args.replicas, load_mult=mult, **rec,
            )
            records.append(rec)

    best32, best16 = (
        serve_bench.sustained([r for r in records if r["arm"] == arm], slo_p99_ms=slo,
                              max_shed_frac=args.max_shed_frac)
        for arm in ("serve_f32", "serve_bf16")
    )
    return records, best32, best16, slo


# -- 3. native dispatch hot path: trace host phases before/after -----------


def _ragged_only(n, *, seed, mesh_lo, mesh_hi):
    """Pure large-cloud traffic for the host-phase arms (no 64-point darcy
    interleave: tiny dispatches would dilute the host phases the
    before/after measures)."""
    from gnot_tpu_torch.data.batch import MeshSample

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(mesh_lo, mesh_hi))
        out.append(MeshSample(
            coords=rng.uniform(0, 1, size=(m, 2)).astype(np.float32),
            y=np.zeros((m, 1), np.float32),
            theta=np.ones((1,), np.float32),
            funcs=(rng.uniform(0, 1, size=(m // 4, 3)).astype(np.float32),),
        ))
    return out


def host_phase_ab(model, *, n, mesh_lo, mesh_hi, max_batch, trace_dir, repeats=3):
    """Traced bf16 serve storms, packer impls INTERLEAVED per round
    (python, native, python, native, ...), so the two arms sample the same
    thermal, cache and allocator state; each ``trace_report`` host phase
    keeps its MIN across rounds. Returns ``{"python": stats, "native":
    stats}``."""
    from gnot_tpu_torch import native
    from gnot_tpu_torch.obs.tracing import Tracer
    from gnot_tpu_torch.serve import InferenceEngine, InferenceServer
    from gnot_tpu_torch.tools import trace_report

    traffic = _ragged_only(n, seed=9, mesh_lo=mesh_lo, mesh_hi=mesh_hi)
    engine = InferenceEngine(model, batch_size=max_batch, dtype="bfloat16")
    engine.warmup(traffic, rows=max_batch)
    best: dict = {
        impl: {"requests": n} for impl in ("python", "native")
    }

    def one_storm(impl, path):
        saved = (native._lib, native._load_failed)
        if impl == "python":
            native._lib, native._load_failed = None, True
        try:
            tracer = Tracer(path=path)
            server = InferenceServer(
                engine, max_batch=max_batch, max_wait_ms=2.0,
                queue_limit=4 * n, tracer=tracer,
            )
            server.start()
            futures = [server.submit(s) for s in traffic]
            results = [f.result(timeout=120) for f in futures]
            server.drain(timeout_s=120)
            assert all(r.ok for r in results), "host-phase storm shed"
            tracer.flush()
        finally:
            native._lib, native._load_failed = saved
        spans = trace_report.load_spans(path)
        b = best[impl]
        for phase in ("batch_assembly", "unpad", "device"):
            durs = sorted(
                s["dur_ms"] for s in spans if s["name"] == phase
            )
            if not durs:
                continue
            # Each stat keeps its minimum ACROSS ROUNDS independently. The
            # estimator is the TRIMMED total (top 10% of calls dropped): one
            # scheduler preemption inside one call poisons a plain total in
            # either arm, while the p50 alone misses the heavier mid-tail.
            keep = durs[: max(1, len(durs) - max(1, len(durs) // 10))]
            stats = {
                "total_ms": round(sum(durs), 4),
                "trimmed_ms": round(sum(keep), 4),
                "p50_ms": round(durs[len(durs) // 2], 4),
            }
            for stat, v in stats.items():
                key = f"{phase}_{stat}"
                if b.get(key) is None or v < b[key]:
                    b[key] = v

    for rep_i in range(repeats):
        for impl in ("python", "native"):
            one_storm(
                impl, os.path.join(trace_dir, f"host_{impl}_{rep_i}.json")
            )
    return best


# -- the run ----------------------------------------------------------------


def device_microbench(model, traffic, *, max_batch, out):
    """The device-side dtype reality on this run's device, recorded next to
    the throughput numbers: one warm dispatch f32 vs bf16, plus a bare
    1024^2 ``torch.matmul`` pair, each timed to the device's end."""
    import torch

    from gnot_tpu_torch.serve import InferenceEngine

    device = next(model.parameters()).device
    ms = {}
    for dtype in ("float32", "bfloat16"):
        eng = InferenceEngine(model, batch_size=max_batch, dtype=dtype)
        eng.warmup(traffic[:2], rows=max_batch)
        k = eng.bucket_key(traffic[1])
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(4):
                eng.infer([traffic[1]], pad_nodes=k[0], pad_funcs=k[1],
                          rows=max_batch)
            ts.append((time.perf_counter() - t0) / 4)
        ms[dtype] = round(min(ts) * 1e3, 3)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((1024, 1024)), dtype=torch.float32, device=device)
    b = torch.as_tensor(rng.standard_normal((1024, 1024)), dtype=torch.float32, device=device)
    mat = {}
    for name, (x, y) in (
        ("f32", (a, b)),
        ("bf16", (a.to(torch.bfloat16), b.to(torch.bfloat16))),
    ):
        torch.matmul(x, y)
        _sync(device)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(4):
                torch.matmul(x, y)
            _sync(device)
            ts.append((time.perf_counter() - t0) / 4)
        mat[name] = round(min(ts) * 1e3, 3)
    slowdown = round(ms["bfloat16"] / ms["float32"], 3)
    return log_line(
        out,
        probe="device_microbench",
        dispatch_ms_f32=ms["float32"],
        dispatch_ms_bf16=ms["bfloat16"],
        matmul1024_ms_f32=mat["f32"],
        matmul1024_ms_bf16=mat["bf16"],
        bf16_dispatch_slowdown=slowdown,
        note=_dtype_note(device.type, slowdown, mat),
    )


def _dtype_note(platform: str, slowdown: float, mat: dict) -> str:
    """What this run's microbench shows about bf16 on its device."""
    product = "faster" if mat["bf16"] < mat["f32"] else "not faster"
    dispatch = "slower" if slowdown > 1.0 else "not slower"
    return (f"measured on {platform}: the bf16 1024^2 product is {product} than f32 "
            f"({mat['bf16']} vs {mat['f32']} ms) and a bf16 dispatch {dispatch} "
            f"({slowdown}x f32)")


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Low-precision serving A/B: f32 against bf16.")
    p.add_argument("--replicas", type=int, default=4)
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--n_traffic", type=int, default=16)
    p.add_argument("--mesh_lo", type=int, default=600)
    p.add_argument("--mesh_hi", type=int, default=1000)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--queue_limit", type=int, default=256)
    p.add_argument("--duration_s", type=float, default=5.0)
    p.add_argument("--loads", type=str, default="0.25,0.4,0.5,0.6,0.7",
                   help="offered-load rungs as fractions of replicas x "
                        "the measured solo f32 dispatch capacity")
    p.add_argument("--slo_p99_ms", type=float, default=0.0)
    p.add_argument("--max_shed_frac", type=float, default=0.02)
    p.add_argument("--datasets", type=str,
                   default="darcy64,elasticity,ns2d,heatsink3d")
    p.add_argument("--parity_epochs", type=int, default=10)
    p.add_argument("--parity_n_train", type=int, default=48)
    p.add_argument("--parity_n_test", type=int, default=16)
    p.add_argument("--host_n", type=int, default=32,
                   help="requests in each host-phase traced storm")
    p.add_argument("--host_mesh_lo", type=int, default=8000)
    p.add_argument("--host_mesh_hi", type=int, default=15000)
    p.add_argument("--host_max_batch", type=int, default=8,
                   help="rows per host-phase dispatch (bigger than the "
                        "serve arms: the before/after isolates the "
                        "collate/unpad sweep, which scales with payload)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--quick", action="store_true",
                   help="tiny ladder/datasets (CI smoke)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where training and every replica run; cuda raises without a card")
    args = p.parse_args(argv)
    if args.quick:
        args.duration_s = min(args.duration_s, 1.5)
        args.loads = "0.3,0.5"
        args.datasets = "darcy64"
        args.parity_epochs = 2
        args.parity_n_train = 12
        args.parity_n_test = 6
        # Host meshes stay at full size: below ~100 KB a dispatch the
        # adaptive packer (correctly) routes both arms to numpy and the
        # before/after would measure nothing.
        args.host_n = 16
        args.replicas = min(args.replicas, 2)

    from gnot_tpu_torch import native
    from gnot_tpu_torch.tools import serve_smoke

    out = args.out
    if out:
        if d := os.path.dirname(out):
            os.makedirs(d, exist_ok=True)
        open(out, "w").close()
    log_line(out, probe="native_packer", **native.status())

    # 1. quality parity per dataset.
    parity = parity_pass(args, out)

    # 2+3. one bench model for throughput and the microbench; the
    # host-phase A/B gets a deliberately SMALL device model (the claim
    # under test is host-side collate/unpad cost).
    bench_args = argparse.Namespace(
        max_batch=args.max_batch, layers=args.layers, hidden=args.hidden,
        seed=args.seed, device=args.device,
    )
    model = serve_bench._build_model(bench_args)
    host_args = argparse.Namespace(
        max_batch=args.host_max_batch, layers=1, hidden=16, seed=args.seed,
        device=args.device,
    )
    host_model = serve_bench._build_model(host_args)
    traffic = serve_smoke.mixed_traffic(
        args.n_traffic, seed=args.seed, mesh_lo=args.mesh_lo,
        mesh_hi=args.mesh_hi,
    )
    micro = device_microbench(model, traffic, max_batch=args.max_batch, out=out)
    records, best32, best16, slo = throughput_ab(args, model, traffic, out)

    host = host_phase_ab(
        host_model, n=args.host_n,
        mesh_lo=args.host_mesh_lo, mesh_hi=args.host_mesh_hi,
        max_batch=args.host_max_batch,
        trace_dir=tempfile.mkdtemp(prefix="lowprec_ab_host_"),
    )
    for impl in ("python", "native"):
        log_line(out, arm=f"host_{impl}", **host[impl])

    def host_sum(st):
        # Trimmed bulk cost (batch_assembly + unpad), the outlier-robust
        # estimator (see host_phase_ab).
        return (st.get("batch_assembly_trimmed_ms") or 0.0) + (
            st.get("unpad_trimmed_ms") or 0.0
        )

    host_before, host_after = host_sum(host["python"]), host_sum(host["native"])
    summary = log_line(
        out,
        summary="lowprec_ab",
        quick=bool(args.quick),
        parity_bar=PARITY_BAR,
        parity_max_delta=round(
            max(abs(r["delta"]) for r in parity), 6
        ),
        parity_datasets=[r["dataset"] for r in parity],
        replicas=args.replicas,
        slo_p99_ms=slo,
        sustained_rps_f32=best32["achieved_rps"] if best32 else None,
        sustained_rps_bf16=best16["achieved_rps"] if best16 else None,
        tokens_per_s_f32=best32["tokens_per_s"] if best32 else None,
        tokens_per_s_bf16=best16["tokens_per_s"] if best16 else None,
        p99_at_sustained_f32=best32["p99_ms"] if best32 else None,
        p99_at_sustained_bf16=best16["p99_ms"] if best16 else None,
        req_s_ratio=(
            round(best16["achieved_rps"] / best32["achieved_rps"], 3)
            if best32 and best16 and best32["achieved_rps"] else None
        ),
        # JAX's design target (its TPU path), reported beside the
        # microbench record.
        bar_req_s_ratio_target=1.3,
        bf16_dispatch_slowdown_cpu=micro["bf16_dispatch_slowdown"],
        cpu_proxy_note=micro["note"],
        host_phase_trimmed_ms_python=round(host_before, 4),
        host_phase_trimmed_ms_native=round(host_after, 4),
        host_reduction_frac=(
            round(1.0 - host_after / host_before, 4) if host_before else None
        ),
        native_packer=native.status()["impl"],
    )
    print(
        f"lowprec_ab: parity max delta {summary['parity_max_delta']} "
        f"(bar {PARITY_BAR}); sustained f32 {summary['sustained_rps_f32']} "
        f"vs bf16 {summary['sustained_rps_bf16']} req/s "
        f"(ratio {summary['req_s_ratio']}); host phases (trimmed) "
        f"{summary['host_phase_trimmed_ms_python']} -> "
        f"{summary['host_phase_trimmed_ms_native']} ms "
        f"({summary['host_reduction_frac']} reduction)"
    )
    return summary


def main(argv=None) -> int:
    s = run(argv)
    ok = (
        s["parity_max_delta"] <= s["parity_bar"]
        and s["host_reduction_frac"] is not None
        and s["host_reduction_frac"] > 0
        and s["sustained_rps_bf16"] is not None
    )
    if not ok:
        print(f"FAIL: lowprec_ab bars not met: {s}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
