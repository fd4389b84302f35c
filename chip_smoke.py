#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``gnot_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (``nvidia-smi``);
2. every kernel under ``gnot_tpu_torch/csrc`` built for sm_90a, one
   ``nvcc`` per source started together, with the ``-Xptxas -v``
   register / shared-memory report;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it and at a ragged row count, for both
   GELUs, with the kernel's time (CUDA events) beside its bound and the
   plain version's time;
4. the serving path at full width through ``gnot_tpu_torch.main``'s
   serve function with ``--ffn_impl pallas``: 16 NS2d-1k requests,
   ``max_batch=4``, every result ``ok``, the FFN kernel launched
   ``2 x n_attn_layers`` times per dispatch, each output held against a
   forward of the same weights with every FFN through the kernel's plain
   version;
5. where one full-width dispatch spends its time: host-clock dispatch
   time with the kernel and with the plain torch FFN path, in turns, and
   a ``torch.profiler`` trace of device time by kernel.

The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``. The script imports
nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain version: both compute in f32, but the kernel sums each
# 256-long dot product in another order than PyTorch's matmul, through
# five chained Linears; a few ulp of the O(1) outputs.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# Served outputs vs a forward through the plain version: the JAX
# package's own model-level bar for its fused FFN against its XLA path.
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ffn_inputs(torch, np, b: int, l: int, width: int, n_expert: int, n_linears: int, seed: int):
    """x, scores, kernels, biases on the card, from a numpy seed; the
    weights follow the model's init (U(+-1/sqrt(fan_in)))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, width), dtype=np.float32)
    logits = rng.standard_normal((b, l, n_expert), dtype=np.float32)
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    bound = 1.0 / np.sqrt(width)
    kernels = [
        rng.uniform(-bound, bound, (n_expert, width, width)).astype(np.float32)
        for _ in range(n_linears)
    ]
    biases = [
        rng.uniform(-bound, bound, (n_expert, width)).astype(np.float32)
        for _ in range(n_linears)
    ]
    dev = torch.device("cuda")
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return to(x), to(scores), [to(k) for k in kernels], [to(bb) for bb in biases]


def ffn_bound_ms(x, scores, kernels, biases) -> tuple[float, str]:
    """Least time for the FFN's work on the card: the larger of its
    compulsory bytes (inputs read once, output written once) over the
    memory rate and its f32 operations (matmul, bias, gate) over the f32
    peak."""
    rows = x.shape[0] * x.shape[1]
    n_expert = scores.shape[-1]
    d_out = kernels[-1].shape[-1]
    flops = 0
    for k in kernels:
        flops += rows * n_expert * (2 * k.shape[1] * k.shape[2] + k.shape[2])
    flops += rows * n_expert * 2 * d_out
    nbytes = 4 * (
        x.numel() + scores.numel() + rows * d_out
        + sum(k.numel() for k in kernels) + sum(b.numel() for b in biases)
    )
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def where_the_time_goes(torch, kernel_model, plain_model, group, engine_cls) -> None:
    """One 4-row serving dispatch at full width: host-clock time with the
    fused FFN kernel and with the plain torch FFN path, in turns
    (plain, kernel, kernel, plain; median of 10 each), then a
    ``torch.profiler`` trace of one kernel dispatch: device time by
    kernel and the device's busy share of the dispatch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    engines = {"xla": engine_cls(plain_model, batch_size=4),
               "pallas": engine_cls(kernel_model, batch_size=4)}
    key = engines["pallas"].bucket_key(group[0])

    def dispatch(label):
        return engines[label].infer(group, pad_nodes=key[0], pad_funcs=key[1], rows=4)

    medians: dict[str, list[float]] = {"xla": [], "pallas": []}
    for label in ("xla", "pallas", "pallas", "xla"):
        dispatch(label)
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            dispatch(label)  # ends in a device-to-host copy: synchronised
            times.append((time.perf_counter() - t0) * 1e3)
        medians[label].append(sorted(times)[len(times) // 2])
    log(f"[time] dispatch [4 rows x {key[0]} points] host clock, median of 10, "
        f"turns xla/pallas/pallas/xla: ffn_impl=xla {medians['xla']} ms, "
        f"ffn_impl=pallas {medians['pallas']} ms")

    dispatch("pallas")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dispatch("pallas")
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if str(getattr(evt, "device_type", "")).endswith("CUDA") and dev_us > 0:
            rows.append((dev_us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"[time] one pallas dispatch: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"({busy_ms / wall_ms:.1%} busy, {1 - busy_ms / wall_ms:.1%} idle)")
    for ms, count, name in rows[:10]:
        log(f"[time]   {ms:8.3f} ms  x{count:<4d} {name[:90]}")


def main() -> int:
    if not (ROOT / "gnot_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no gnot_tpu_torch package beside {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.device import resolve_device
    from gnot_tpu_torch.models import layers
    from gnot_tpu_torch.ops import build
    from gnot_tpu_torch.ops.fused_ffn import (
        fused_gated_ffn,
        fused_gated_ffn_kernel,
        fused_gated_ffn_reference,
    )
    from gnot_tpu_torch.serve.engine import InferenceEngine

    resolve_device("cuda")  # also turns TF32 off
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    card = card_line()
    log(card)

    # -- phase 2: build every kernel, all nvcc processes at once --------
    t0 = time.monotonic()
    procs = {name: build.start_build(name) for name in build.sources()}
    for name, proc in procs.items():
        report = build.finish_build(name, proc)
        log(f"[build] {name}: {build.library_path(name).relative_to(ROOT)}")
        for line in report.splitlines():
            if "ptxas" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] {len(procs)} kernel(s) built in {time.monotonic() - t0:.1f} s")

    # -- phase 3: each kernel against its plain version on the card -----
    width, n_expert, n_linears = 256, 3, 5
    max_abs = 0.0
    for (b, l), gelu in [((4, 1024), "tanh"), ((4, 1024), "erf"),
                         ((4, 1000), "tanh"), ((3, 1000), "erf")]:
        args = ffn_inputs(torch, np, b, l, width, n_expert, n_linears, seed=b * l)
        got = fused_gated_ffn_kernel(*args, gelu_kind=gelu)
        want = fused_gated_ffn_reference(*args, gelu_kind=gelu)
        torch.cuda.synchronize()
        err = (got - want).abs()
        rel = (err / want.abs().clamp_min(1e-3)).max().item()
        log(f"[ffn] x [{b},{l},{width}] E={n_expert} {n_linears} Linears gelu={gelu}: "
            f"max_abs_err {err.max().item():.3e} max_rel_err {rel:.3e} "
            f"(tolerance rtol {KERNEL_RTOL} atol {KERNEL_ATOL}: f32 both ways, "
            "another summation order over K=256 through 5 chained Linears)")
        torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        max_abs = max(max_abs, err.max().item())

    args = ffn_inputs(torch, np, 4, 1024, width, n_expert, n_linears, seed=7)
    kernel_ms = cuda_ms(torch, lambda: fused_gated_ffn_kernel(*args, gelu_kind="tanh"))
    plain_ms = cuda_ms(torch, lambda: fused_gated_ffn_reference(*args, gelu_kind="tanh"))
    bound_ms, bound_by = ffn_bound_ms(*args)
    log(f"[ffn] time at [4,1024,256] tanh, weights warm in L2: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{bound_ms / kernel_ms:.1%} of bound on {card}")

    # -- phase 4: the serving path at full width ------------------------
    argv = ["--serve", "--ffn_impl", "pallas", "--synthetic", "ns2d",
            "--n_test", "16", "--serve_max_batch", "4", "--device", "cuda"]
    serve_args = port_main.build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    fused_gated_ffn_kernel.launches = 0
    run = port_main.run_serve(serve_args)
    launches = fused_gated_ffn_kernel.launches
    summary = run.summary
    log(f"[serve] python -m gnot_tpu_torch.main {' '.join(argv)}")
    log(f"[serve] summary {json.dumps(summary)}")
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    n_ok = sum(r.ok for r in run.results)
    if n_ok != len(run.results) or len(run.results) != 16:
        raise RuntimeError(
            f"{n_ok}/{len(run.results)} requests ok: "
            f"{[(r.reason, r.detail) for r in run.results if not r.ok]}"
        )
    cfg = run.model.config
    warmed = summary["warmed_buckets"]
    dispatches = summary["dispatches"] + warmed
    expected = 2 * cfg.n_attn_layers * dispatches
    log(f"[serve] {n_ok}/16 ok; fused_gated_ffn launches {launches} = "
        f"2 x {cfg.n_attn_layers} blocks x {dispatches} dispatches "
        f"({summary['dispatches']} served + {warmed} warm-up)")
    if launches != expected or launches == 0:
        raise RuntimeError(f"expected {expected} FFN kernel launches, counted {launches}")

    # The same weights forward again on the card, every FFN through the
    # kernel's plain version instead of the kernel.
    layers.fused_gated_ffn = fused_gated_ffn_reference
    try:
        plain = InferenceEngine(run.model, batch_size=4).predict(run.samples)
    finally:
        layers.fused_gated_ffn = fused_gated_ffn
    worst = 0.0
    for r, want in zip(run.results, plain):
        if r.output.shape != want.shape or not np.all(np.isfinite(r.output)):
            raise RuntimeError(f"bad served output shape {r.output.shape} vs {want.shape}")
        np.testing.assert_allclose(r.output, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)
        worst = max(worst, float(np.max(np.abs(r.output - want))))
    log(f"[serve] outputs vs a forward through the kernel's plain version on the card: "
        f"max_abs_err {worst:.3e} (tolerance rtol {MODEL_RTOL} atol {MODEL_ATOL})")
    log(f"[serve] request latency p50 {summary['latency_ms_p50']:.3f} ms "
        f"p99 {summary['latency_ms_p99']:.3f} ms; dispatch p50 "
        f"{summary['dispatch_ms_p50']:.3f} ms max {summary['dispatch_ms_max']:.3f} ms "
        f"(host clock); peak device memory {peak_mib:.1f} MiB")

    # -- phase 5: where one full-width dispatch spends its time ----------
    plain_model = copy.deepcopy(run.model)
    for m in plain_model.modules():
        if isinstance(m, layers.GatedExpertFfn):
            m.ffn_impl = "xla"
    where_the_time_goes(torch, run.model, plain_model, run.samples[:4], InferenceEngine)

    kernels = [{
        "name": "fused_gated_ffn",
        "route": "cuda",
        "source": "gnot_tpu_torch/csrc/fused_gated_ffn.cu",
        "replaces": "gnot_tpu/ops/pallas_ffn.py:206",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
