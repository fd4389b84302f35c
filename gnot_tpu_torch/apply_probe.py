"""Where the apply kernel's time goes on the card.

    python -m gnot_tpu_torch.apply_probe

Prints the device time (``torch.profiler``, read by
``profiling.kernel_times``) of ``csrc/nla_apply.cu``'s kernel, each time
beside its blocks, how many of them one SM holds at once and the shared
memory a block takes:

* at the full-width shapes of ``validate_kernels.full_width_cases``
  (self, cross, self_packed, cross_packed);
* a blocks sweep: q ``[B, 1024, 256]`` for B = 1, 4, 8, 16 and 32 (64 to
  2,048 blocks of 16 rows), which tells one wave's latency from the rate
  at ~2, 4 and 8 blocks an SM;
* an F sweep: F = 1, 2 and 4 input functions at the self shape, which
  tells the per-row cost (q, the softmax, qs) from the per-function cost
  (the Grams, the products, the stores);
* one block alone: B = 1, L = 16.

Last, the kernel at the self shape and one block alone for variants of
``csrc/nla_apply.cu`` made by replacing lines of the source (built
together into ``build/gnot_tpu_torch/apply_probe/``), each leaving one
part out or making it cheap, so the differences say what the time is made
of:

* ``kernel``: the source as it is;
* ``chained_softmax``: the softmax as the kernel had it before, one
  chain of shuffles, ``expf`` and division after another, each ended by
  a branch past E, so no two chains interleave (what the stage-by-stage
  softmax saves);
* ``fast_division``: the softmax divides with ``__fdividef`` (no branch to
  the IEEE division's slow path inside the rows' shuffle chains);
* ``reciprocal_output``: one reciprocal of the denominator per (row,
  head), then a multiply per output, in place of 16 IEEE divisions a
  thread;
* ``both_divisions``: the two above together;
* ``no_softmax``: qs is q itself (no shuffles, ``expf`` or division);
* ``no_gram_loads``: the Gram's head-diagonal blocks are not staged (the
  product reads whatever shared memory holds);
* ``no_products``: no multiply-adds over the Gram;
* ``no_q_loads``: q is made from the column index, not read;
* ``empty``: the kernel returns at entry (the floor of one launch).

All but ``kernel``, ``chained_softmax``, ``fast_division``,
``reciprocal_output`` and ``both_divisions`` give wrong outputs on purpose; each prints its max abs
error against the plain version. Runs on ``cuda`` and raises without a
card.
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
from gnot_tpu_torch.reduce_probe import N_SM

OUT_DIR = build.BUILD_DIR / "apply_probe"
ROWS = 16  # query rows per block of csrc/nla_apply.cu
_FAST_DIVISION = ("      const float y = x[j][i] / m[j][i];\n",
                  "      const float y = __fdividef(x[j][i], m[j][i]);\n")
_RECIPROCAL_OUTPUT = [
    ("      den[rr * (kMaxE / D) + h] = s == 0.f ? 1.f : s;\n",
     "      den[rr * (kMaxE / D) + h] = 1.f / (s == 0.f ? 1.f : s);\n"),
    ("make_float4(acc[i][0] / dn, acc[i][1] / dn, acc[i][2] / dn, acc[i][3] / dn)",
     "make_float4(acc[i][0] * dn, acc[i][1] * dn, acc[i][2] * dn, acc[i][3] * dn)"),
]
# The softmax's shuffle stages over all of a warp's chains, then the head
# of the loop that divides and stores.
_STAGES = (
    "  float m[kWarpRows][kMaxE / 32];  // each chain's head max, then its sum\n"
    "#pragma unroll\n"
    "  for (int j = 0; j < kWarpRows; ++j)\n"
    "#pragma unroll\n"
    "    for (int i = 0; i < kMaxE / 32; ++i) m[j][i] = x[j][i];\n"
    "  head_reduce<D, true>(m);\n"
    "#pragma unroll\n"
    "  for (int j = 0; j < kWarpRows; ++j)\n"
    "#pragma unroll\n"
    "    for (int i = 0; i < kMaxE / 32; ++i) {\n"
    "      x[j][i] = expf(x[j][i] - m[j][i]);\n"
    "      m[j][i] = x[j][i];\n"
    "    }\n"
    "  head_reduce<D, false>(m);\n"
)
_STORE_HEAD = (
    "#pragma unroll\n"
    "  for (int j = 0; j < kWarpRows; ++j) {\n"
    "    const int rr = warp + j * (kThreads / 32);\n"
    "    const size_t base = (static_cast<size_t>(b) * a.l + r0 + rr) * e;\n"
    "#pragma unroll\n"
    "    for (int i = 0; i < kMaxE / 32; ++i) {\n"
)
# The earlier softmax: one chain after another, each ended by a branch past E.
_CHAINED = (
    "      if (32 * i >= e) break;\n"
    "      const int col = lane + 32 * i;\n"
    "      float mx = x[j][i];\n"
    "#pragma unroll\n"
    "      for (int o = D / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));\n"
    "      const float ex = expf(x[j][i] - mx);\n"
    "      float sum = ex;\n"
    "#pragma unroll\n"
    "      for (int o = D / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);\n"
    "      const float y = ex / sum;\n"
)
VARIANTS: dict[str, list[tuple[str, str]]] = {
    "kernel": [],
    "chained_softmax": [(_STAGES + _STORE_HEAD + "      const int col = lane + 32 * i;\n"
                         "      const float y = x[j][i] / m[j][i];\n", _STORE_HEAD + _CHAINED)],
    "fast_division": [_FAST_DIVISION],
    "reciprocal_output": _RECIPROCAL_OUTPUT,
    "both_divisions": [_FAST_DIVISION, *_RECIPROCAL_OUTPUT],
    "no_softmax": [(_STAGES, ""), ("const float y = x[j][i] / m[j][i];", "const float y = x[j][i];")],
    "no_gram_loads": [("    for (int idx = t; idx < D * e / 4; idx += kThreads) {\n",
                       "    for (int idx = t; idx < 0; idx += kThreads) {\n")],
    "no_products": [("      for (int d = 0; d < D; ++d) {\n        const float4 w",
                     "      for (int d = 0; d < 0; ++d) {\n        const float4 w")],
    "no_q_loads": [("x[j][i] = (rr < rows && col < e) ? load_f(qp + base + col) : 0.f;",
                    "x[j][i] = (rr < rows && col < e) ? 1e-3f * col : 0.f;")],
    "empty": [("  extern __shared__ __align__(16) float smem[];\n",
               "  if (a.f >= 0) return;\n  extern __shared__ __align__(16) float smem[];\n")],
}


def apply_ms(fn) -> float:
    """Mean device time in ms of the apply kernel in one ``fn()``. CUPTI
    has handed back three empty profiles in a row here, so it gets more
    attempts than the reduce's probe gives it."""
    times = kernel_times(fn, attempts=8, names=("apply_kernel",))
    if times is None:
        raise RuntimeError("8 profiles recorded no apply_kernel device time")
    return times["apply_kernel"]


def occupancy(lib: ctypes.CDLL, d: int) -> tuple[int, int]:
    """(resident blocks per SM, shared memory bytes per block) of the
    kernel in ``lib`` for head width ``d``."""
    fn = lib.gnot_nla_apply_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    smem = ctypes.c_int(0)
    blocks = fn(d, ctypes.byref(smem))
    if blocks < 0:
        raise RuntimeError("cudaOccupancyMaxActiveBlocksPerMultiprocessor failed")
    return blocks, smem.value


def grams(device, f: int, b: int, lk: int = 64, seed: int = 0):
    """``(kv [F,B,E,E], ksum [F,B,1,E])`` of random keys and values by the
    plain reduce."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    k = torch.randn(f, b, lk, vk.WIDTH, generator=g).to(device)
    v = torch.randn(f, b, lk, vk.WIDTH, generator=g).to(device)
    return fa.reduce_reference(k, v, torch.ones(f, b, lk, device=device), vk.N_HEAD)


def blocks_of(q: torch.Tensor) -> int:
    b, l, _ = q.shape
    return b * -(-l // ROWS)


def line(label: str, ms: float, blocks: int, resident: int, smem: int) -> str:
    return (f"[probe] {label}: apply_kernel {ms:.4f} ms; {blocks} blocks "
            f"({blocks / N_SM:.2f} per SM), {resident} resident per SM, {smem:,} B shared per block")


def dense_call(q, kv, ksum):
    return lambda: fa.nla_apply_kernel(q, kv, ksum, vk.N_HEAD)


def variant_times(device, case: dict) -> None:
    """The kernel's time at the self shape and one block alone for every
    variant, through the dense wrapper with its launcher swapped for the
    variant's."""
    libs = {}
    for name, (lib, out) in build.build_variants("nla_apply", VARIANTS, OUT_DIR).items():
        regs, spills = build.ptxas_summary(out)
        print(f"[probe] built {name}: registers {regs}, spill stores + loads {spills} B", flush=True)
        libs[name] = lib
    kv, ksum = fa.reduce_reference(case["k"], case["v"], case["mask"], vk.N_HEAD)
    q = case["q"]
    alone_q = torch.randn(1, ROWS, vk.WIDTH, device=device)
    alone_kv, alone_ksum = grams(device, 1, 1)
    want = fa.apply_reference(q, kv, ksum, vk.N_HEAD)
    saved = fa._launchers.get("gnot_nla_apply")
    try:
        for name, lib in libs.items():
            fn = lib.gnot_nla_apply
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fa._launchers["gnot_nla_apply"] = fn
            got = fa.nla_apply_kernel(q, kv, ksum, vk.N_HEAD)
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            self_ms = apply_ms(dense_call(q, kv, ksum))
            alone_ms = apply_ms(dense_call(alone_q, alone_kv, alone_ksum))
            resident, smem = occupancy(lib, vk.WIDTH // vk.N_HEAD)
            print(f"[probe] variant {name:17s}: self {self_ms:.4f} ms, one block alone "
                  f"{alone_ms * 1e3:.2f} us; {resident} resident per SM, {smem:,} B shared per "
                  f"block; max_abs_err vs plain at self {err:.3e}", flush=True)
    finally:
        if saved is None:
            fa._launchers.pop("gnot_nla_apply", None)
        else:
            fa._launchers["gnot_nla_apply"] = saved


def main() -> int:
    device = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    d = vk.WIDTH // vk.N_HEAD
    resident, smem = occupancy(build.load("nla_apply"), d)
    cases = vk.full_width_cases(device)
    for name in ("self", "cross", "self_packed", "cross_packed"):
        c = cases[name]
        if "q_seg" in c:
            kv, ksum = fa.reduce_seg_reference(c["k"], c["v"], c["mask"], c["kv_seg"], c["n_seg"],
                                               vk.N_HEAD)
            fn = lambda c=c, kv=kv, ksum=ksum: fa.nla_apply_seg_kernel(  # noqa: E731
                c["q"], kv, ksum, c["q_seg"], vk.N_HEAD)
        else:
            kv, ksum = fa.reduce_reference(c["k"], c["v"], c["mask"], vk.N_HEAD)
            fn = dense_call(c["q"], kv, ksum)
        print(line(f"case {name:12s} q {list(c['q'].shape)} kv {list(kv.shape)}", apply_ms(fn),
                   blocks_of(c["q"]), resident, smem), flush=True)
    for b in (1, 4, 8, 16, 32):
        q = torch.randn(b, 1024, vk.WIDTH, device=device)
        kv, ksum = grams(device, 1, b)
        print(line(f"blocks sweep B={b:2d} q {list(q.shape)}", apply_ms(dense_call(q, kv, ksum)),
                   blocks_of(q), resident, smem), flush=True)
    q = cases["self"]["q"]
    for f in (1, 2, 4):
        kv, ksum = grams(device, f, q.shape[0])
        print(line(f"F sweep F={f} q {list(q.shape)} kv {list(kv.shape)}",
                   apply_ms(dense_call(q, kv, ksum)), blocks_of(q), resident, smem), flush=True)
    q = torch.randn(1, ROWS, vk.WIDTH, device=device)
    kv, ksum = grams(device, 1, 1)
    print(line(f"one block alone q {list(q.shape)}", apply_ms(dense_call(q, kv, ksum)),
               blocks_of(q), resident, smem), flush=True)
    variant_times(device, cases["self"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
