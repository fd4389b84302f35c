"""Where the reduce kernel's time goes on the card, pass by pass.

    python -m gnot_tpu_torch.reduce_probe

Prints the device time (``torch.profiler``) of ``csrc/nla_reduce.cu``'s two
passes, ``reduce_partial`` (the per-piece Grams) and ``reduce_combine``
(their in-order sum per slot), at the full-width shapes of
``validate_kernels`` (self, cross, self_packed, cross_packed) for several
floors on a piece's row count (``fused_attention.REDUCE_MIN_SPLIT``); then
the f32 rate of one pass-1 block alone on an SM (8 blocks over 4,096 rows)
and of 1,056 blocks, 8 per SM, each against an SM's share of the card's
f32 peak. Runs on ``cuda`` and raises without a card.
"""

from __future__ import annotations

import sys

import torch

from gnot_tpu_torch import validate_kernels as vk
from gnot_tpu_torch.device import resolve_device
from gnot_tpu_torch.ops import fused_attention as fa

PEAK_F32_FLOPS = 67e12  # one H100 SXM, f32 outside the tensor cores
N_SM = 132


def pass_times(fn, iters: int = 20, warmup: int = 3) -> dict[str, float]:
    """Mean device time in ms of each kernel one ``fn()`` runs, by name."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            name = "reduce_partial" if "reduce_partial" in evt.key else (
                "reduce_combine" if "reduce_combine" in evt.key else evt.key[:40])
            times[name] = evt.self_device_time_total / 1e3 / iters
    return times


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
                  f"{per_sm / (PEAK_F32_FLOPS / N_SM):.1%} of an SM's share of 67 TFLOP/s",
                  flush=True)
    finally:
        fa.REDUCE_MIN_SPLIT = default_floor
    return 0


if __name__ == "__main__":
    sys.exit(main())
