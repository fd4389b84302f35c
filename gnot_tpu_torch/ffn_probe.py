"""Where the fused gated-FFN kernel's time goes on the card.

    python -m gnot_tpu_torch.ffn_probe

Builds variants of ``csrc/fused_gated_ffn.cu`` made by replacing lines
of the source (all ``nvcc`` processes at once, into
``build/gnot_tpu_torch/ffn_probe/``) and times each at the serving shape
(x ``[4, 1024, 256]``, E=3, five 256-wide Linears, tanh GELU) by CUDA
events over back-to-back launches:

* ``kernel``: the source as it is;
* ``stages_4``: a 4-chunk weight ring (2 chunks of lookahead, not 3);
* ``one_product``: only a_hi * b_hi (one TF32 product instead of three);
* ``no_copies``: the first ring of weight chunks is reused, no bulk copy
  after it (wrong numbers, the weight stream's cost);
* ``no_products``: no wgmma at all (wrong numbers, the tensor cores'
  cost);
* ``identity_gelu``: GELU(x) = x (the epilogue's transcendental cost);
* ``no_a_loads``: the A fragments of chunk 0 and 1 reused for every
  chunk (wrong numbers, the cost of reading and splitting A);
* ``mma_only``: no copies, no A reads, identity GELU: the products and
  the epilogue's bias and stores alone (wrong numbers);
* ``phases``: the kernel with clock64 counters, which gives one
  consumer thread's cycles by phase (chunk wait, wgmma issue and wait,
  A load, epilogue, cluster barrier, x tile) for one launch.

Then the host time of one wrapper call (enqueue only), and the kernel
alone at 1, 16 and 64 row tiles, which tells one
cluster's latency from the whole card's contention. Only ``kernel``,
``stages_4`` and ``phases`` compute the FFN; the others print their
error only to show it. Runs on ``cuda`` and raises without a card.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from gnot_tpu_torch.device import resolve_device
from gnot_tpu_torch.ops import build
from gnot_tpu_torch.ops import fused_ffn

SOURCE = build.CSRC / "fused_gated_ffn.cu"
OUT_DIR = build.BUILD_DIR / "ffn_probe"

VARIANTS: dict[str, list[tuple[str, str]]] = {
    "kernel": [],
    "stages_4": [("constexpr int kStages = 5;", "constexpr int kStages = 4;")],
    "one_product": [
        ("wgmma_m64n128k8(acc, al[kk], b_hi);  // small terms first", ""),
        ("wgmma_m64n128k8(acc, ah[kk], b_lo);", ""),
    ],
    "no_copies": [
        ("mbar_wait(&full[s], (t / kStages) & 1);", "if (t < kStages) mbar_wait(&full[s], 0);"),
        ("if (m >= kStages) mbar_wait(&empty[slot], ((m / kStages) + 1) & 1);",
         "if (m >= kStages) continue;"),
    ],
    "no_products": [
        ("wgmma_m64n128k8(acc, al[kk], b_hi);  // small terms first", ""),
        ("wgmma_m64n128k8(acc, ah[kk], b_lo);", ""),
        ("wgmma_m64n128k8(acc, ah[kk], b_hi);", ""),
    ],
    "identity_gelu": [("  if (kGelu == 0) {\n", "  if (kGelu == 0) {\n    return x;\n")],
    "no_a_loads": [("        if (c + 1 < nck) load_a(hin, c + 1, r0, r1, t4, nh, nl);\n", "")],
}
VARIANTS["mma_only"] = VARIANTS["no_copies"] + VARIANTS["no_a_loads"] + [
    ("  if (kGelu == 0) {\n", "  if (kGelu == 0) {\n    return x;\n")]

# The ``phases`` variant: consumer thread 0 of block 0 adds up the SM clock cycles
# it spends in each phase of the kernel (clock64), read back through an
# extra C entry point.
PHASES = ["chunk wait (mbarrier)", "wgmma issue", "wgmma wait (chunk t-1)",
          "next A load + split", "layer drain + consumer barrier", "epilogue",
          "cluster barrier", "x tile load", "total"]
_B0 = "if (blockIdx.x == 0 && tid == 0) g_phase"
_N = len(PHASES)
PHASE_EDITS = [
    ("namespace cg = cooperative_groups;\n",
     f"namespace cg = cooperative_groups;\n__device__ unsigned long long g_phase[{_N}];\n"),
    ("  float gacc[64];\n", "  const long long t_start = clock64();\n  float gacc[64];\n"),
    ("        mbar_wait(&full[s], (t / kStages) & 1);\n",
     "        long long tc = clock64();\n        mbar_wait(&full[s], (t / kStages) & 1);\n"
     f"        {_B0}[0] += clock64() - tc; tc = clock64();\n"),
    ("        wgmma_commit();\n",
     f"        wgmma_commit();\n        {_B0}[1] += clock64() - tc;\n"),
    ("        wgmma_wait<1>();  // chunk t - 1 is done: its slot and A registers are free\n",
     "        tc = clock64();\n        wgmma_wait<1>();\n"
     f"        {_B0}[2] += clock64() - tc; tc = clock64();\n"),
    ("        if (c + 1 < nck) load_a(hin, c + 1, r0, r1, t4, nh, nl);\n",
     "        if (c + 1 < nck) load_a(hin, c + 1, r0, r1, t4, nh, nl);\n"
     f"        {_B0}[3] += clock64() - tc;\n"),
    ("      wgmma_wait<0>();\n      fence_acc(acc);\n      consumer_sync();  // bias_s is in place\n",
     "      long long te = clock64();\n      wgmma_wait<0>();\n      fence_acc(acc);\n"
     f"      consumer_sync();\n      {_B0}[4] += clock64() - te; te = clock64();\n"),
    ("      cluster_arrive();\n      cluster_wait();\n    }\n  }\n",
     f"      {_B0}[5] += clock64() - te; te = clock64();\n      cluster_arrive();\n"
     f"      cluster_wait();\n      {_B0}[6] += clock64() - te;\n    }}\n  }}\n"
     f"  {_B0}[{_N - 1}] += clock64() - t_start;\n"),
    ("    for (int j = tid; j < kRows * din / 4; j += kConsumers) {\n",
     "    long long tx = clock64();\n    for (int j = tid; j < kRows * din / 4; j += kConsumers) {\n"),
    ("    consumer_sync();\n\n    for (int i = 0; i < a.n_linears; ++i) {\n",
     f"    consumer_sync();\n    {_B0}[7] += clock64() - tx;\n\n"
     "    for (int i = 0; i < a.n_linears; ++i) {\n"),
    ("extern \"C\" int gnot_fused_gated_ffn(",
     "extern \"C\" int gnot_ffn_phases(void* host, int reset) {\n"
     "  cudaError_t err = cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));\n"
     "  if (err == cudaSuccess && reset) {\n"
     f"    static const unsigned long long zeros[{_N}] = {{}};\n"
     "    err = cudaMemcpyToSymbol(g_phase, zeros, sizeof(zeros));\n  }\n"
     "  return static_cast<int>(err);\n}\n\n"
     "extern \"C\" int gnot_fused_gated_ffn("),
]
VARIANTS["phases"] = PHASE_EDITS


def build_variants() -> dict[str, ctypes.CDLL]:
    libs = {}
    for name, (lib, out) in build.build_variants("fused_gated_ffn", VARIANTS, OUT_DIR).items():
        regs, spills = build.ptxas_summary(out)
        warnings = sorted({line.split("(C")[1].split(")")[0] for line in out.splitlines()
                           if "(C7" in line})
        print(f"[probe] built {name}: registers {regs}, spill stores + loads {spills} B, "
              f"ptxas notes {warnings}", flush=True)
        libs[name] = lib
    return libs


def inputs(rows_b: int, rows_l: int, device, seed: int = 7):
    rng = np.random.default_rng(seed)
    width, e, n_linears = 256, 3, 5
    bound = 1.0 / np.sqrt(width)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)  # noqa: E731
    x = to(rng.standard_normal((rows_b, rows_l, width)))
    logits = rng.standard_normal((rows_b, rows_l, e))
    scores = to(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
    kernels = [to(rng.uniform(-bound, bound, (e, width, width))) for _ in range(n_linears)]
    biases = [to(rng.uniform(-bound, bound, (e, width))) for _ in range(n_linears)]
    return x, scores, kernels, biases


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    device = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    libs = build_variants()
    args = inputs(4, 1024, device)
    want = fused_ffn.fused_gated_ffn_reference(*args, gelu_kind="tanh")
    for name, lib in libs.items():
        launcher = fused_ffn._Launcher(lib)
        call = lambda: fused_ffn.launch(*args, "tanh", launcher)  # noqa: E731
        err = (call()[0] - want).abs().max().item()
        print(f"[probe] {name:14s} [4,1024,256] E=3 5 Linears: {event_ms(call):.4f} ms, "
              f"max_abs_err vs plain {err:.3e}", flush=True)
    phases = libs["phases"]
    phases.gnot_ffn_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counts = (ctypes.c_ulonglong * len(PHASES))()
    fused_ffn.launch(*args, "tanh", fused_ffn._Launcher(phases))
    torch.cuda.synchronize()
    phases.gnot_ffn_phases(ctypes.addressof(counts), 1)
    fused_ffn.launch(*args, "tanh", fused_ffn._Launcher(phases))
    torch.cuda.synchronize()
    phases.gnot_ffn_phases(ctypes.addressof(counts), 1)
    total = counts[len(PHASES) - 1]
    for name, c in zip(PHASES, counts):
        print(f"[probe] block 0 {name:38s} {c:9d} cycles ({c / total:.1%})", flush=True)
    import time

    fused_ffn.fused_gated_ffn_kernel(*args, gelu_kind="tanh")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fused_ffn.fused_gated_ffn_kernel(*args, gelu_kind="tanh")
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    print(f"[probe] host time per fused_gated_ffn_kernel call (enqueue only): {host_us:.1f} us",
          flush=True)
    launcher = fused_ffn._Launcher(libs["kernel"])
    for tiles in (1, 16, 64):
        small = inputs(1, 64 * tiles, device)
        ms = event_ms(lambda: fused_ffn.launch(*small, "tanh", launcher))
        print(f"[probe] kernel at {tiles} row tile(s) ({2 * tiles} CTAs): {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
