"""Per-kernel time breakdown of the headline training step.

Port of ``tools/profile_step.py``. It traces the card while the NS2d-1k
bf16 train step of ``gnot_tpu_torch.bench.build`` (the bench's headline
workload: reference-default architecture, B=4, L=1024) runs one K-step
window (the window ``bench.time_scan_marginal`` times), after an untimed
warm-up window from the same state, with ``torch.profiler`` (CPU and CUDA
activity) in place of ``jax.profiler``. The device records of the trace
(kernels, copies, fills) are aggregated by ``family``, the kernel's name
with its template arguments, its parameter list and a numeric suffix
stripped, into JAX's record:

* ``module_total_ms_per_step``: the device-busy union over the window
  (overlapping records counted once), over K;
* ``ops_total_ms_per_step``: the sum of the device records' times, over K;
* ``while_wrapper_ms_per_step``: ``None``. Eager PyTorch runs no scan, so
  no ``while`` op wraps the steps (``unavailable`` names it);
* ``op_families``: the top ``--top`` families by time, ``example_hlo``
  holding one kernel symbol of the family.

CUPTI drops records now and then (ROADMAP §2). The record also holds
``kernel_records``, the kernel records the trace kept, ``launch_calls``,
the host's kernel-launch calls it saw, and ``records_lost``, the launch
calls with no kernel record (by correlation id), and the FFN kernel's
launches (its wrapper's count) beside its records. A loss is flagged on
stderr, as ``profiling.kernel_times`` flags it: those times read low.

Writes ``--out`` (default ``build/profile_breakdown.json`` in the
checkout; ``_flat.json`` with ``--flat_params``) and the raw Chrome trace
under ``--trace_dir`` (default ``build/profile_step/``); never JAX's
committed ``docs/artifacts/``. With ``--device cpu`` it exits with a
message: there is no CUDA device plane to read.

Usage::

    python -m gnot_tpu_torch.tools.profile_step [--k 20] [--dtype bfloat16]
        [--config ns2d] [--n_points 1024] [--top 25] [--flat_params]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from pathlib import Path

BUILD = Path(__file__).resolve().parents[2] / "build"

#: Chrome-trace categories of the records that run on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Host calls that launch one kernel each (cudaLaunchKernel*, cuLaunchKernel*).
LAUNCH_CALL = re.compile(r"^cu(da)?Launch(Cooperative)?Kernel")
FFN_SYMBOL = "fused_gated_ffn"


def family(event_name: str) -> str:
    """Kernel family key: the symbol with its template arguments
    (``<...>``, nested), its trailing parameter list, a leading ``void``
    and the uniquifying numeric suffix stripped, e.g. ``void
    at::native::elementwise_kernel<128, 2, ...>(int, ...)`` ->
    ``at::native::elementwise_kernel``, ``Memcpy DtoH (Device ->
    Pinned)`` -> ``Memcpy DtoH``."""
    out, depth = [], 0
    for ch in event_name:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    base = "".join(out).strip()
    if base.endswith(")"):
        depth = 0
        for i in range(len(base) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(base[i], 0)
            if depth == 0:
                base = base[:i].strip()
                break
    base = base.removeprefix("void ").strip()
    return re.sub(r"[.\d]+$", "", base)


def _union_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def breakdown(events: list[dict], k: int, top: int = 25) -> dict:
    """The per-family table of a ``torch.profiler`` Chrome trace's events
    over a window of ``k`` steps, and the record counts."""
    device, launches = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver") and LAUNCH_CALL.match(str(e.get("name", ""))):
            launches.append(e)
    kernels = [e for e in device if str(e.get("cat", "")).lower() == "kernel"]
    kept = {e.get("args", {}).get("correlation") for e in kernels}
    lost = sum(1 for e in launches if e.get("args", {}).get("correlation") not in kept)
    fams: dict[str, dict] = {}
    for e in device:
        d = fams.setdefault(family(str(e["name"])),
                            {"us": 0.0, "count": 0, "name": str(e["name"])[:200]})
        d["us"] += float(e["dur"])
        d["count"] += 1
    total_us = sum(v["us"] for v in fams.values())
    busy_us = _union_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device])
    ranked = sorted(fams.items(), key=lambda kv: -kv[1]["us"])[:top]
    return {
        "module_total_ms_per_step": busy_us / 1e3 / k,
        "while_wrapper_ms_per_step": None,
        "ops_total_ms_per_step": total_us / 1e3 / k,
        "op_families": [
            {
                "family": name,
                "ms_per_step": round(v["us"] / 1e3 / k, 4),
                "pct_of_ops": round(100 * v["us"] / total_us, 2) if total_us else 0.0,
                "count_per_step": v["count"] / k,
                "example_hlo": v["name"],
            }
            for name, v in ranked
        ],
        "kernel_records": len(kernels),
        "launch_calls": len(launches),
        "records_lost": lost,
        "ffn_kernel_records": sum(1 for e in kernels if FFN_SYMBOL in str(e["name"])),
        "unavailable": {
            "while_wrapper_ms_per_step": "eager PyTorch runs no lax.scan: no while op "
                                         "wraps the steps",
        },
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Per-kernel breakdown of the port's train step.")
    p.add_argument("--k", type=int, default=20, help="steps in the traced window")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--config", default="ns2d")
    p.add_argument("--n_points", type=int, default=1024)
    p.add_argument("--trace_dir", default=str(BUILD / "profile_step"))
    p.add_argument("--out", default=str(BUILD / "profile_breakdown.json"))
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--flat_params", action="store_true",
                   help="profile the flat parameter layout")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (cuda raises without one); cpu has no device plane")
    args = p.parse_args(argv)
    if args.flat_params and args.out == p.get_default("out"):
        # Layout-suffixed default: never write over the tree layout's file.
        args.out = args.out.replace(".json", "_flat.json")
    if args.device != "cuda":
        sys.exit(f"profile_step: device {args.device!r} has no CUDA device plane — this "
                 "tool reads the card's kernel records (run it on the card, without "
                 "--device cpu)")

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gnot_tpu_torch import bench
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel

    step, state, batch, _ = bench.build(args.dtype, config=args.config, n_points=args.n_points,
                                        flat_params=args.flat_params, device=args.device)
    lr = 1e-3
    dbatch = batch.to(state.device)
    start = bench._snapshot(state)
    # The warm-up window, untraced: first launches, the allocator.
    bench._hard_sync(state, bench._window(step, state, dbatch, lr, args.k))
    bench._restore(state, start)

    ffn_before = fused_gated_ffn_kernel.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bench._hard_sync(state, bench._window(step, state, dbatch, lr, args.k))
    ffn_launches = fused_gated_ffn_kernel.launches - ffn_before
    os.makedirs(args.trace_dir, exist_ok=True)
    trace = os.path.join(args.trace_dir, f"profile_step_{int(time.time())}.trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    table = breakdown(events, args.k, args.top)
    if not table["kernel_records"]:
        sys.exit(f"profile_step: the trace {trace} holds no kernel record — CUPTI "
                 "returned an empty profile; rerun")

    result = {
        "workload": {
            "config": args.config, "dtype": args.dtype, "k_steps": args.k,
            "n_points": args.n_points, "batch": 4,
            "flat_params": args.flat_params,
        },
        "device": torch.cuda.get_device_name(state.device),
        **table,
        "ffn_kernel_launches": ffn_launches,
    }
    if table["records_lost"] or table["ffn_kernel_records"] != ffn_launches:
        print(f"profile_step: CUPTI kept {table['kernel_records']} kernel records of "
              f"{table['launch_calls']} launch calls ({table['records_lost']} launches without "
              f"a record; {FFN_SYMBOL} {table['ffn_kernel_records']} records of "
              f"{ffn_launches} launches): records lost, the times read low", file=sys.stderr)
    print("profile_step: while_wrapper_ms_per_step is null — "
          + table["unavailable"]["while_wrapper_ms_per_step"], file=sys.stderr)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in
                      ("module_total_ms_per_step", "while_wrapper_ms_per_step",
                       "ops_total_ms_per_step", "kernel_records", "launch_calls",
                       "records_lost")}, indent=1))
    for f_ in result["op_families"]:
        print(f'{f_["ms_per_step"]:8.4f}ms {f_["pct_of_ops"]:5.1f}% '
              f'x{f_["count_per_step"]:6.1f}  {f_["family"]}')
    print(f"full breakdown -> {args.out}; raw trace {trace}", flush=True)
    return result


if __name__ == "__main__":
    main()
