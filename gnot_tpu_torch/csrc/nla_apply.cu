// Normalized-linear-attention apply stage for NVIDIA Hopper (sm_90a), float32.
//
// Replaces two TPU kernels of gnot_tpu/ops/pallas_attention.py:
//   * nla_apply     (:304; pallas_call :268, body _apply_kernel :237)
//   * nla_apply_seg (:710; pallas_call :676, body _apply_seg_kernel :628)
// For every query row both compute qs = group_softmax(q) (a softmax within
// each head's D features, with a per-head max), written once, and for every
// input function f, per head h:
//   denom_h = <qs_h, k_sum_h>, with 0 replaced by 1,
//   out_h   = qs_h @ kv[hD:(h+1)D, hD:(h+1)D] / denom_h,
// where (kv, k_sum) belong to the row's slot: b for nla_apply; for
// nla_apply_seg the row's chunk (L / N rows each) has slot seg[b, n], and a
// chunk whose id lies outside [0, S) (a pad chunk carries S) gives out = 0.
//
// What bounds it on this card: bytes. At full width (q [4, 1024, 256], F = 1,
// H = 8, D = 32) the outputs need 2 * E * D FLOP per row and function,
// 0.07 GFLOP in all (1.1 us at 67 TFLOP/s f32), against reading q and the
// head-diagonal blocks of kv and writing out and qs, ~12.7 MB (3.8 us at
// 3.35 TB/s). But every full-width grid is one partial wave (256 or 192
// blocks of 16 rows, 3 resident per SM on 132 SMs), so one block's critical
// path sets the time: 6.9 us for one block alone, 0.0099 ms at self, 38% of
// the byte bound (apply_probe.py, H100 80GB HBM3, 700 W). On that path a
// warp's softmax is 16 chains of 10 dependent shuffles. Run one chain after
// another, with a branch between chains (no shuffle moves across a branch),
// they take ~3.5 us of a block's time: the probe's chained_softmax variant
// reads 9.3 us alone. Next on the path: the Gram's loads after the
// softmax's barrier (~1.5 us at self, the probe's no_gram_loads).
//
// What the design does about it:
//   * The softmax runs stage by stage over all 16 chains of a warp (a max
//     butterfly, expf, a sum butterfly, the division), with no branch
//     between chains: each shuffle stage issues 16 independent shuffles
//     back to back. Column groups past E run on zeros and are not stored.
//     Each chain keeps its own butterfly order, so qs does not depend on
//     how the chains interleave.
//   * q is read once and qs written once, whatever F is: a block takes 16
//     query rows (of one chunk, in the seg form), softmaxes them per head in
//     registers, writes qs and keeps it in shared memory for every f. The
//     TPU kernel recomputed the softmax for every f.
//   * Each warp loads every q value it needs before using any, so a block
//     waits on device memory once for q and once for each f's Grams.
//   * Only the head-diagonal blocks of each Gram are read (E * D floats, 32 KB
//     at full width, 1/8 of the [E, E] Gram); the TPU kernel multiplied the
//     full Gram by a block-diagonal mask on the MXU.
//   * Shared memory holds qs as [row][d * H + h] and the diagonal blocks as
//     [d][h * D + j], so the product's reads are broadcasts or consecutive
//     words. Each of 256 threads computes 4 columns of 4 rows.
//   * Rows past L read as zero and are never stored, so q is not padded.
//   * A pad chunk's rows are written as zeros without reading any Gram.
// Plain FFMA in f32; the divisions (the softmax's and the one by denom) are
// exact IEEE division, as in the plain version.
//
// Supported: D in {16, 32}, E a multiple of D up to 256, any F, B, L. The
// launchers refuse anything else.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // query rows per block
constexpr int kMaxE = 256;
constexpr int kWarpRows = kRows / (kThreads / 32);  // softmax rows per warp

struct ApplyArgs {
  const float* __restrict__ q;     // [B, L, E]
  const float* __restrict__ kv;    // [F, S, E, E]
  const float* __restrict__ ksum;  // [F, S, E]
  const int* __restrict__ seg;     // [B, N] chunk -> slot ids, or nullptr: the slot of row b is b
  float* __restrict__ out;         // [F, B, L, E]
  float* __restrict__ qs;          // [B, L, E]
  int f, b, l, e;
  int n_chunks;   // N: chunks per row
  int chunk_len;  // L / N
  int n_slots;    // S
};

template <int D>
constexpr int smem_floats() {
  return kRows * kMaxE      // qs, [row][d * H + h]
         + D * kMaxE        // head-diagonal kv blocks, [d][h * D + j]
         + kMaxE            // k_sum, [d * H + h]
         + kRows * kMaxE / D;  // denominators, [row][h]
}

// v = max (kMax) or sum of v over each head's D lanes, for all of a warp's
// chains at once: each xor-shuffle stage issues one independent shuffle per
// chain back to back. The butterfly's order is a chain's own, so every
// lane of a head ends with the same value.
template <int D, bool kMax>
__device__ __forceinline__ void head_reduce(float (&v)[kWarpRows][kMaxE / 32]) {
#pragma unroll
  for (int o = D / 2; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < kWarpRows; ++j)
#pragma unroll
      for (int i = 0; i < kMaxE / 32; ++i) {
        const float other = __shfl_xor_sync(0xffffffffu, v[j][i], o);
        v[j][i] = kMax ? fmaxf(v[j][i], other) : v[j][i] + other;
      }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const __grid_constant__ ApplyArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* qst = smem;
  float* kvd = qst + kRows * kMaxE;
  float* kst = kvd + D * kMaxE;
  float* den = kst + kMaxE;

  const int e = a.e;
  const int H = e / D;
  const int tiles = (a.chunk_len + kRows - 1) / kRows;
  const int n = blockIdx.x / tiles;
  const int b = blockIdx.y;
  const int r0 = n * a.chunk_len + (blockIdx.x % tiles) * kRows;
  const int rows = min(kRows, min((n + 1) * a.chunk_len, a.l) - r0);
  int slot = b;
  if (a.seg != nullptr) {
    const int s = __ldg(a.seg + static_cast<size_t>(b) * a.n_chunks + n);
    slot = (s >= 0 && s < a.n_slots) ? s : -1;
  }

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // qs: warp w takes rows w, w+8; lane l holds columns l + 32i, so a head
  // is D consecutive lanes and xor-shuffles below D stay inside it. Every
  // q value the warp needs is loaded before any is used: one round trip.
  float x[kWarpRows][kMaxE / 32];
#pragma unroll
  for (int j = 0; j < kWarpRows; ++j) {
    const int rr = warp + j * (kThreads / 32);
    const size_t base = (static_cast<size_t>(b) * a.l + r0 + rr) * e;
#pragma unroll
    for (int i = 0; i < kMaxE / 32; ++i) {
      const int col = lane + 32 * i;
      x[j][i] = (rr < rows && col < e) ? __ldg(a.q + base + col) : 0.f;
    }
  }
  // The softmax of the warp's 16 chains (2 rows x 8 column groups) stage
  // by stage over all of them, with no branch between chains: column
  // groups past E run on zeros and are not stored.
  float m[kWarpRows][kMaxE / 32];  // each chain's head max, then its sum
#pragma unroll
  for (int j = 0; j < kWarpRows; ++j)
#pragma unroll
    for (int i = 0; i < kMaxE / 32; ++i) m[j][i] = x[j][i];
  head_reduce<D, true>(m);
#pragma unroll
  for (int j = 0; j < kWarpRows; ++j)
#pragma unroll
    for (int i = 0; i < kMaxE / 32; ++i) {
      x[j][i] = expf(x[j][i] - m[j][i]);
      m[j][i] = x[j][i];
    }
  head_reduce<D, false>(m);
#pragma unroll
  for (int j = 0; j < kWarpRows; ++j) {
    const int rr = warp + j * (kThreads / 32);
    const size_t base = (static_cast<size_t>(b) * a.l + r0 + rr) * e;
#pragma unroll
    for (int i = 0; i < kMaxE / 32; ++i) {
      const int col = lane + 32 * i;
      const float y = x[j][i] / m[j][i];
      if (col < e) {
        qst[rr * kMaxE + (col % D) * H + col / D] = y;
        if (rr < rows) a.qs[base + col] = y;
      }
    }
  }

  const int cq = t & 63;  // output columns 4cq..4cq+3
  const int rg = t >> 6;  // output rows rg, rg+4, rg+8, rg+12
  const bool has_cols = 4 * cq < e;

  if (slot < 0) {  // a pad chunk: its rows attend to nothing
    for (int f = 0; f < a.f; ++f) {
      for (int i = 0; i < kRows / 4; ++i) {
        const int rr = rg + 4 * i;
        if (has_cols && rr < rows) {
          *reinterpret_cast<float4*>(
              a.out + ((static_cast<size_t>(f) * a.b + b) * a.l + r0 + rr) * e + 4 * cq) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    return;
  }

  for (int f = 0; f < a.f; ++f) {
    __syncthreads();  // qs is complete; the previous f is done with kvd/kst/den
    const size_t fs = static_cast<size_t>(f) * a.n_slots + slot;
    const float* kvp = a.kv + fs * e * e;
    for (int idx = t; idx < D * e / 4; idx += kThreads) {
      const int d = idx / (e / 4);
      const int c4 = (idx % (e / 4)) * 4;
      const int h = c4 / D;
      *reinterpret_cast<float4*>(kvd + d * kMaxE + c4) =
          __ldg(reinterpret_cast<const float4*>(kvp + static_cast<size_t>(h * D + d) * e + c4));
    }
    for (int idx = t; idx < e; idx += kThreads) {
      kst[(idx % D) * H + idx / D] = __ldg(a.ksum + fs * e + idx);
    }
    __syncthreads();

    for (int idx = t; idx < kRows * H; idx += kThreads) {
      const int rr = idx / H;
      const int h = idx % H;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s += qst[rr * kMaxE + d * H + h] * kst[d * H + h];
      // An all-masked slab or an empty slot has k_sum == 0 and a zero
      // numerator: dividing by 1 gives exactly 0, not 0/0.
      den[rr * (kMaxE / D) + h] = s == 0.f ? 1.f : s;
    }
    __syncthreads();

    if (has_cols) {
      const int h = 4 * cq / D;
      float acc[kRows / 4][4];
#pragma unroll
      for (int i = 0; i < kRows / 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float4 w = *reinterpret_cast<const float4*>(kvd + d * kMaxE + 4 * cq);
#pragma unroll
        for (int i = 0; i < kRows / 4; ++i) {
          const float x = qst[(rg + 4 * i) * kMaxE + d * H + h];
          acc[i][0] += x * w.x;
          acc[i][1] += x * w.y;
          acc[i][2] += x * w.z;
          acc[i][3] += x * w.w;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows / 4; ++i) {
        const int rr = rg + 4 * i;
        if (rr < rows) {
          const float dn = den[rr * (kMaxE / D) + h];
          *reinterpret_cast<float4*>(
              a.out + ((static_cast<size_t>(f) * a.b + b) * a.l + r0 + rr) * e + 4 * cq) =
              make_float4(acc[i][0] / dn, acc[i][1] / dn, acc[i][2] / dn, acc[i][3] / dn);
        }
      }
    }
  }
}

template <int D>
cudaError_t configure() {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        apply_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_floats<D>() * 4);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const ApplyArgs& a, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * 4;
  const cudaError_t err = configure<D>();
  if (err != cudaSuccess) return err;
  if (a.b == 0 || a.l == 0) return cudaSuccess;
  const int tiles = (a.chunk_len + kRows - 1) / kRows;
  const dim3 grid(a.n_chunks * tiles, a.b);
  apply_kernel<D><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

bool dims_ok(int f, int b, int l, int e, int d) {
  return (d == 16 || d == 32) && e > 0 && e <= kMaxE && e % d == 0 && f >= 0 && b >= 0 && l >= 0 &&
         b <= 65535;
}

cudaError_t run(const ApplyArgs& a, int d, cudaStream_t stream) {
  return d == 16 ? launch<16>(a, stream) : launch<32>(a, stream);
}

template <int D>
int occupancy(int* smem_bytes) {
  *smem_bytes = smem_floats<D>() * 4;
  int blocks = 0;
  if (configure<D>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, apply_kernel<D>, kThreads,
                                                    *smem_bytes) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

}  // namespace

// nla_apply. q: [B, L, E] f32; kv: [F, B, E, E]; ksum: [F, B, 1, E];
// out: [F, B, L, E]; qs: [B, L, E]. Returns a cudaError_t (0 = launched).
extern "C" int gnot_nla_apply(const void* q, const void* kv, const void* ksum, void* out, void* qs,
                              int f, int b, int l, int e, int d, void* stream) {
  if (!dims_ok(f, b, l, e, d)) return static_cast<int>(cudaErrorInvalidValue);
  ApplyArgs a;
  a.q = static_cast<const float*>(q);
  a.kv = static_cast<const float*>(kv);
  a.ksum = static_cast<const float*>(ksum);
  a.seg = nullptr;
  a.out = static_cast<float*>(out);
  a.qs = static_cast<float*>(qs);
  a.f = f;
  a.b = b;
  a.l = l;
  a.e = e;
  a.n_chunks = 1;
  a.chunk_len = l;
  a.n_slots = b;
  return static_cast<int>(run(a, d, static_cast<cudaStream_t>(stream)));
}

// nla_apply_seg. q: [B, L, E] f32; kv: [F, S, E, E]; ksum: [F, S, 1, E];
// seg: [B, N] int32 chunk -> slot ids, L = N * chunk; out: [F, B, L, E];
// qs: [B, L, E]. Returns a cudaError_t (0 = launched).
extern "C" int gnot_nla_apply_seg(const void* q, const void* kv, const void* ksum, const void* seg,
                                  void* out, void* qs, int f, int b, int l, int e, int d,
                                  int n_chunks, int n_slots, void* stream) {
  if (!dims_ok(f, b, l, e, d) || n_chunks < 1 || l % n_chunks != 0 || n_slots < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ApplyArgs a;
  a.q = static_cast<const float*>(q);
  a.kv = static_cast<const float*>(kv);
  a.ksum = static_cast<const float*>(ksum);
  a.seg = static_cast<const int*>(seg);
  a.out = static_cast<float*>(out);
  a.qs = static_cast<float*>(qs);
  a.f = f;
  a.b = b;
  a.l = l;
  a.e = e;
  a.n_chunks = n_chunks;
  a.chunk_len = l / n_chunks;
  a.n_slots = n_slots;
  return static_cast<int>(run(a, d, static_cast<cudaStream_t>(stream)));
}

// Resident blocks per SM of the kernel for head width d (16 or 32), and its
// shared memory per block in *smem_bytes; -1 on an error. For the probes.
extern "C" int gnot_nla_apply_occupancy(int d, int* smem_bytes) {
  if (d != 16 && d != 32) return -1;
  return d == 16 ? occupancy<16>(smem_bytes) : occupancy<32>(smem_bytes);
}
