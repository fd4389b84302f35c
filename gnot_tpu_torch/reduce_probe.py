"""Where the reduce kernel's time goes on the card, pass by pass.

    python -m gnot_tpu_torch.reduce_probe

Prints the device time (``torch.profiler``) of ``csrc/nla_reduce.cu``'s two
passes, ``reduce_partial`` (the per-piece Grams) and ``reduce_combine``
(their in-order sum per slot), at the full-width shapes of
``validate_kernels`` (self, cross, self_packed, cross_packed) for several
floors on a piece's row count (``fused_attention.REDUCE_MIN_SPLIT``); then
the rate of pass 1 (f32 multiply-adds of the Gram a second) with one block
alone on an SM (8 blocks over 4,096 rows) and with 1,056 blocks, 8 per SM,
each against an SM's share of two peaks: the f32 CUDA cores', and the
TF32 tensor cores' over the three products a multiply-add takes in
3xTF32 (the kernel's form). Last, pass 1's time at the self shape and
with one block alone on an SM for variants of ``csrc/nla_reduce.cu`` made
by replacing lines of the source (built together into
``build/gnot_tpu_torch/reduce_probe/``), each leaving one part of a step
out, so the differences say what a step's time is made of:

* ``kernel``: the source as it is;
* ``one_product``: only hi*hi, one TF32 product, and no lo split (what
  the three products and the split cost over one);
* ``no_products``: no mma at all, so no fragment loads or splits either
  (the whole product loop's cost);
* ``no_softmax``: the staged k stripe multiplied as it arrived (the
  softmax's shuffles and barrier-bound pass);
* ``no_loads``: only the first 32 rows are copied, every later step
  reuses them (the cost of staging rows from device memory);
* ``fast_division``: the softmax divides with ``__fdividef`` (no branch
  to the IEEE division's slow path between the unrolled rows' shuffle
  chains; results within a few ulp).

All but ``kernel`` and ``fast_division`` give wrong Grams on purpose. Runs on ``cuda`` and
raises without a card.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from gnot_tpu_torch import validate_kernels as vk
from gnot_tpu_torch.device import resolve_device
from gnot_tpu_torch.ops import build
from gnot_tpu_torch.ops import fused_attention as fa
from gnot_tpu_torch.profiling import kernel_times

PEAK_F32_FLOPS = 67e12  # one H100 SXM, f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # and TF32 on its tensor cores, dense
TF32_PRODUCTS = 3  # 3xTF32: lo*hi + hi*lo + hi*hi per f32 multiply-add
N_SM = 132

OUT_DIR = build.BUILD_DIR / "reduce_probe"
_MMA_LO_HI = ("          mma_tf32(acc[mt][nt], al[mt], bh);\n", "")
_MMA_HI_LO = ("          if (kSplitV) mma_tf32(acc[mt][nt], ah[mt], bl);\n", "")
_MMA_HI_HI = ("          mma_tf32(acc[mt][nt], ah[mt], bh);\n", "")
VARIANTS: dict[str, list[tuple[str, str]]] = {
    "kernel": [],
    "one_product": [_MMA_LO_HI, _MMA_HI_LO],
    "no_products": [_MMA_LO_HI, _MMA_HI_LO, _MMA_HI_HI],
    "no_softmax": [("    for (int j = 0; j < kRows / (kThreads / 32); ++j) {\n",
                    "    for (int j = 0; j < 0; ++j) {\n")],
    "no_loads": [("    if (r0 + kRows < r_end) {\n      stage_rows(",
                  "    if (false) {\n      stage_rows(")],
    "fast_division": [("col < wi ? ex / sum * m : 0.f;", "col < wi ? __fdividef(ex, sum) * m : 0.f;")],
}


def pass_times(fn) -> dict[str, float]:
    """Mean device time in ms of each pass one ``fn()`` runs, by name."""
    times = kernel_times(fn, names=("reduce_partial", "reduce_combine"))
    if times is None:
        raise RuntimeError("3 profiles recorded no reduce_partial device time")
    return times


def build_variants() -> dict[str, ctypes.CDLL]:
    libs = {}
    for name, (lib, out) in build.build_variants("nla_reduce", VARIANTS, OUT_DIR).items():
        regs, spills = build.ptxas_summary(out)
        print(f"[probe] built {name}: registers {regs}, spill stores + loads {spills} B", flush=True)
        libs[name] = lib
    return libs


def variant_times(device, case: dict) -> None:
    """Pass 1's device time of every variant at the self shape and with
    one block alone on each of 8 SMs (one piece of 4,096 rows), through
    the dense wrapper with its launcher swapped for the variant's."""
    libs = build_variants()
    alone = torch.randn(1, 1, 4096, vk.WIDTH, device=device)
    alone_mask = torch.ones(1, 1, 4096, device=device)
    steps = 4096 // fa.REDUCE_ROWS
    default_floor, saved = fa.REDUCE_MIN_SPLIT, fa._launchers.get("gnot_nla_reduce")
    try:
        for name, lib in libs.items():
            fn = lib.gnot_nla_reduce
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fa._launchers["gnot_nla_reduce"] = fn
            fa.REDUCE_MIN_SPLIT = default_floor
            args = (case["k"], case["v"], case["mask"], vk.N_HEAD)
            err = max((a - b).abs().max().item() for a, b in zip(
                fa.nla_reduce_kernel(*args), fa.reduce_reference(*args)))
            self_ms = pass_times(lambda: fa.nla_reduce_kernel(*args))["reduce_partial"]
            fa.REDUCE_MIN_SPLIT = 1 << 30  # one piece per row
            alone_ms = pass_times(lambda: fa.nla_reduce_kernel(alone, alone, alone_mask,
                                                               vk.N_HEAD))["reduce_partial"]
            print(f"[probe] variant {name:12s}: reduce_partial self {self_ms:.4f} ms, one "
                  f"block of 4096 rows alone {alone_ms:.4f} ms ({alone_ms / steps * 1e3:.2f} us "
                  f"per {fa.REDUCE_ROWS}-row step); max_abs_err vs plain at self {err:.3e}", flush=True)
    finally:
        fa.REDUCE_MIN_SPLIT = default_floor
        if saved is None:
            fa._launchers.pop("gnot_nla_reduce", None)
        else:
            fa._launchers["gnot_nla_reduce"] = saved


def main() -> int:
    device = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    cases = vk.full_width_cases(device)
    default_floor = fa.REDUCE_MIN_SPLIT
    try:
        for floor in (32, 64, 128, 256):
            fa.REDUCE_MIN_SPLIT = floor
            for name, c in cases.items():
                if name not in ("self", "cross", "self_packed", "cross_packed"):
                    continue
                if "q_seg" in c:
                    fn = lambda c=c: fa.nla_reduce_seg_kernel(  # noqa: E731
                        c["k"], c["v"], c["mask"], c["kv_seg"], c["n_seg"], vk.N_HEAD)
                else:
                    fn = lambda c=c: fa.nla_reduce_kernel(c["k"], c["v"], c["mask"], vk.N_HEAD)  # noqa: E731
                t = pass_times(fn)
                print(f"[probe] piece floor {floor:3d} rows, {name:12s}: reduce_partial "
                      f"{t['reduce_partial']:.4f} ms, reduce_combine {t['reduce_combine']:.4f} ms",
                      flush=True)
        fa.REDUCE_MIN_SPLIT = 1 << 30  # one piece per chunk
        for b, lk in ((1, 4096), (132, 512)):
            k = torch.randn(1, b, lk, vk.WIDTH, device=device)
            mask = torch.ones(1, b, lk, device=device)
            t = pass_times(lambda: fa.nla_reduce_kernel(k, k, mask, vk.N_HEAD))
            blocks = b * 8  # 8 tiles of 64 x 128 per 256 x 256 Gram
            rate = 2 * b * lk * vk.WIDTH**2 / (t["reduce_partial"] * 1e-3)
            per_sm = rate / min(blocks, N_SM)
            print(f"[probe] {blocks} pass-1 blocks of {lk} rows ({blocks / N_SM:.2f} per SM): "
                  f"reduce_partial {t['reduce_partial']:.4f} ms, {rate / 1e12:.2f} TFLOP/s f32, "
                  f"{per_sm / 1e9:.1f} GFLOP/s per busy SM = "
                  f"{per_sm / (PEAK_F32_FLOPS / N_SM):.1%} of an SM's share of 67 TFLOP/s "
                  f"f32, {per_sm * TF32_PRODUCTS / (PEAK_TF32_FLOPS / N_SM):.1%} of its share "
                  f"of 495 TFLOP/s TF32 at {TF32_PRODUCTS} products a multiply-add",
                  flush=True)
    finally:
        fa.REDUCE_MIN_SPLIT = default_floor
    variant_times(device, cases["self"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
