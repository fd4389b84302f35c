// Normalized-linear-attention reduce stage for NVIDIA Hopper (sm_90a), float32.
//
// Replaces two TPU kernels of gnot_tpu/ops/pallas_attention.py:
//   * nla_reduce     (:206; pallas_call :171, body _reduce_kernel :145)
//   * nla_reduce_seg (:581; pallas_call :546, body _reduce_seg_kernel :505)
// Both compute ks = group_softmax(k) * mask (a softmax within each head's D
// features, with a per-head max) and, per output slot, the full Gram
// kv = ks^T v [E, E] and k_sum = sum over rows of ks [E], in f32. For
// nla_reduce the slot of (f, b) is b and its rows are all Lk rows. For
// nla_reduce_seg the rows come in chunks of Lk / N; chunk n of row b belongs
// to slot seg[b, n], and a chunk whose id lies outside [0, S) belongs to none
// (the pad chunks carry id S). A slot that no chunk belongs to comes out
// exactly zero.
//
// What bounds it on this card: arithmetic. At full width (F*B = 4 Grams of
// 256x256 over Lk = 1024 rows) one call is 2 * 1024 * 256^2 * 4 = 0.54 GFLOP
// against ~9.4 MB of compulsory traffic: 8.0 us at 67 TFLOP/s (f32 outside
// the tensor cores) against 2.8 us at 3.35 TB/s.
//
// What the design does about it:
//   * The TPU kernel walks the Lk tiles in order and adds each into an output
//     block it revisits. Blocks on Hopper run at once and in no order, so the
//     rows are cut into chunks instead (one per row for nla_reduce, the
//     packing chunks for nla_reduce_seg), each chunk into pieces of at least
//     64 rows where that makes about two blocks per SM (chosen by the
//     caller), and pass 1 gives every (64x128 output tile, piece, f) a block
//     of its own. At full width that is 8 tiles x 8 pieces x 4 Grams = 256
//     blocks on 132 SMs, where one block per Gram would fill 4. Each block
//     writes its partial Gram and partial k_sum to a scratch buffer (a whole
//     E^2 Gram per piece, hence the 64-row floor).
//   * Pass 2 adds up the partials of each slot in piece order: deterministic
//     sums, no atomics, and a slot no chunk belongs to is written as zero.
//     nla_reduce's slots own contiguous pieces, read with unrolled loads;
//     nla_reduce_seg branches around the chunks of other slots. The scratch
//     (F * B*N*P * (E^2 + E) floats, ~8 MB at full width) stays in L2.
//   * A pass-1 block of 128 threads stages 32 rows of its k stripe (64
//     columns), its v stripe (128 columns) and their mask in shared memory
//     with cp.async, double-buffered, so the next rows load while this step
//     computes and no step waits on device memory row by row. It
//     softmaxes the k stripe per head with warp shuffles (64 columns hold
//     whole heads for D = 16 and 32), and each thread keeps an 8x8 piece of
//     the tile in registers: four 16-byte shared-memory reads per 64 FMAs, so
//     the FMA units and not shared memory set the pace.
//   * Rows past a chunk's end and columns past E are zero-filled by the copy
//     and carry mask 0, so no input is padded.
// Plain FFMA in f32 on the CUDA cores; TF32 would change the numbers, and
// wgmma/TMA pipelining is later work.
//
// Supported: D in {16, 32}, E a multiple of D up to 256, any F, B, Lk. The
// launchers refuse anything else.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTi = 64;    // output tile rows: Gram rows i (k features)
constexpr int kTj = 128;   // output tile columns: Gram columns j (v features)
constexpr int kRows = 32;  // key rows staged per step
constexpr int kMaxE = 256;
constexpr int kCombineThreads = 256;

struct ReduceArgs {
  const float* __restrict__ k;     // [F, B, Lk, E]
  const float* __restrict__ v;     // [F, B, Lk, E]
  const float* __restrict__ mask;  // [F, B, Lk]
  const int* __restrict__ seg;     // [B, N] chunk -> slot ids, or nullptr: the slot of row b is b
  float* __restrict__ partial;     // [F, B*N, E*E + E] scratch: per-chunk Gram, then k_sum
  float* __restrict__ kv;          // [F, S, E, E]
  float* __restrict__ ksum;        // [F, S, E]
  int f, b, lk, e;
  int n_chunks;   // N: chunks per row (1 for nla_reduce)
  int chunk_len;  // rows per chunk: Lk / N
  int n_split;    // P: each chunk is cut into P pieces of split_len rows
  int split_len;  // (the last piece of a chunk may be short)
  int n_slots;    // S
};

// The slot piece u (of chunk u / P = b * N + n) belongs to, or -1 for none.
__device__ __forceinline__ int slot_of(const ReduceArgs& a, int u) {
  const int c = u / a.n_split;
  if (a.seg == nullptr) return c;
  const int s = __ldg(a.seg + c);
  return (s >= 0 && s < a.n_slots) ? s : -1;
}

// 16-byte global -> shared copy; bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

// 4-byte global -> shared copy; bytes = 0 writes a zero.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Stage {
  float k[kRows][kTi];
  float v[kRows][kTj];
  float m[kRows];
};

// Start copying rows r0..r0+31 of the k stripe [i0, i0+wi), the v stripe
// [j0, j0+wj) and the mask into `st`; rows at or past r_end and columns
// past the stripe are zero-filled.
__device__ __forceinline__ void stage_rows(Stage& st, const float* kp, const float* vp,
                                           const float* mp, int e, int r0, int r_end, int i0,
                                           int wi, int j0, int wj) {
  const int t = threadIdx.x;
  if (t < kRows) {
    const bool ok = r0 + t < r_end;
    cp_async4(&st.m[t], ok ? mp + r0 + t : mp, ok ? 4 : 0);
  }
  for (int idx = t; idx < kRows * kTi / 4; idx += kThreads) {
    const int rr = idx / (kTi / 4);
    const int c4 = (idx % (kTi / 4)) * 4;
    const bool ok = r0 + rr < r_end && c4 < wi;
    cp_async16(&st.k[rr][c4], ok ? kp + static_cast<size_t>(r0 + rr) * e + i0 + c4 : kp, ok ? 16 : 0);
  }
  for (int idx = t; idx < kRows * kTj / 4; idx += kThreads) {
    const int rr = idx / (kTj / 4);
    const int c4 = (idx % (kTj / 4)) * 4;
    const bool ok = r0 + rr < r_end && c4 < wj;
    cp_async16(&st.v[rr][c4], ok ? vp + static_cast<size_t>(r0 + rr) * e + j0 + c4 : vp, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
reduce_partial(const __grid_constant__ ReduceArgs a) {
  extern __shared__ __align__(16) float smem[];
  Stage* st = reinterpret_cast<Stage*>(smem);  // double-buffered k, v and mask rows

  const int u = blockIdx.y;  // piece u % P of chunk u / P
  if (slot_of(a, u) < 0) return;  // a pad chunk: pass 2 never reads it
  const int n_tj = (a.e + kTj - 1) / kTj;
  const int i0 = (blockIdx.x / n_tj) * kTi;
  const int j0 = (blockIdx.x % n_tj) * kTj;
  const int wi = min(kTi, a.e - i0);  // a multiple of D: whole heads
  const int wj = min(kTj, a.e - j0);
  const int c = u / a.n_split;
  const int row = c / a.n_chunks;
  const int chunk_begin = (c % a.n_chunks) * a.chunk_len;
  const int r_begin = chunk_begin + (u % a.n_split) * a.split_len;
  const int r_end = min(min(r_begin + a.split_len, chunk_begin + a.chunk_len), a.lk);
  const size_t slab = (static_cast<size_t>(blockIdx.z) * a.b + row) * a.lk;
  const float* kp = a.k + slab * a.e;
  const float* vp = a.v + slab * a.e;
  const float* mp = a.mask + slab;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tx = t & 15;  // tile columns 4tx..4tx+3 and 64+4tx..64+4tx+3
  const int ty = t >> 4;  // tile rows 4ty..4ty+3 and 32+4ty..32+4ty+3
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ksum_acc = 0.f;

  if (r_begin < r_end) stage_rows(st[0], kp, vp, mp, a.e, r_begin, r_end, i0, wi, j0, wj);
  cp_async_commit();
  int cur = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += kRows, cur ^= 1) {
    // The next rows load into the other buffer (last read in the previous
    // step, before its closing barrier) while this step computes.
    if (r0 + kRows < r_end) {
      stage_rows(st[cur ^ 1], kp, vp, mp, a.e, r0 + kRows, r_end, i0, wi, j0, wj);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    // Per-head softmax of the k stripe, times the mask. Warp w takes rows
    // w, w+4, ...; lane l holds columns l and l+32, so a head is D
    // consecutive lanes and xor-shuffles below D stay inside it. Unrolled,
    // so the warp's 16 chains of dependent shuffles overlap.
#pragma unroll
    for (int j = 0; j < kRows / (kThreads / 32); ++j) {
      const int rr = warp + j * (kThreads / 32);
      const float m = st[cur].m[rr];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = lane + 32 * half;
        const float x = st[cur].k[rr][col];
        float mx = x;
#pragma unroll
        for (int o = D / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float ex = expf(x - mx);
        float sum = ex;
#pragma unroll
        for (int o = D / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        st[cur].k[rr][col] = col < wi ? ex / sum * m : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int rr = 0; rr < kRows; ++rr) {
      const float4 k0 = *reinterpret_cast<const float4*>(&st[cur].k[rr][4 * ty]);
      const float4 k1 = *reinterpret_cast<const float4*>(&st[cur].k[rr][32 + 4 * ty]);
      const float4 v0 = *reinterpret_cast<const float4*>(&st[cur].v[rr][4 * tx]);
      const float4 v1 = *reinterpret_cast<const float4*>(&st[cur].v[rr][64 + 4 * tx]);
      const float kr[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
      const float vr[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += kr[i] * vr[j];
    }
    if (j0 == 0 && t < kTi) {
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) ksum_acc += st[cur].k[rr][t];
    }
    __syncthreads();
  }

  const size_t per = static_cast<size_t>(a.e) * a.e + a.e;
  float* p = a.partial + (static_cast<size_t>(blockIdx.z) * a.b * a.n_chunks * a.n_split + u) * per;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = (i < 4 ? 4 * ty + i : 32 + 4 * ty + i - 4);
    if (gi >= wi) continue;
    float* prow = p + static_cast<size_t>(i0 + gi) * a.e + j0;
    if (4 * tx < wj) {
      *reinterpret_cast<float4*>(prow + 4 * tx) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    if (64 + 4 * tx < wj) {
      *reinterpret_cast<float4*>(prow + 64 + 4 * tx) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  if (j0 == 0 && t < wi) p[static_cast<size_t>(a.e) * a.e + i0 + t] = ksum_acc;
}

// Pass 2: slot s of f is the sum, in order, of the partials of the pieces
// that belong to it; zero when none does. One thread per 4 floats of the
// slot's E*E Gram followed by its E k_sum values.
__global__ void __launch_bounds__(kCombineThreads)
reduce_combine(const __grid_constant__ ReduceArgs a) {
  const int s = blockIdx.y;
  const int per = a.e * a.e + a.e;
  const int x4 = 4 * (blockIdx.x * kCombineThreads + threadIdx.x);
  if (x4 >= per) return;
  const int n_u = a.b * a.n_chunks * a.n_split;
  const float* p = a.partial + static_cast<size_t>(blockIdx.z) * n_u * per + x4;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  if (a.seg == nullptr) {
    // nla_reduce: the pieces of slot s are s*P .. s*P + P - 1, all read, so
    // the unrolled loads are issued together.
#pragma unroll 4
    for (int u = s * a.n_split; u < (s + 1) * a.n_split; ++u) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p + static_cast<size_t>(u) * per));
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
  } else {
    // nla_reduce_seg: most chunks belong to other slots (or none); branch
    // around them so their partials are never read.
    for (int c = 0; c < a.b * a.n_chunks; ++c) {
      if (__ldg(a.seg + c) != s) continue;
      for (int u = c * a.n_split; u < (c + 1) * a.n_split; ++u) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p + static_cast<size_t>(u) * per));
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
    }
  }
  const size_t fs = static_cast<size_t>(blockIdx.z) * a.n_slots + s;
  if (x4 < a.e * a.e) {
    *reinterpret_cast<float4*>(a.kv + fs * a.e * a.e + x4) = sum;
  } else {
    *reinterpret_cast<float4*>(a.ksum + fs * a.e + (x4 - a.e * a.e)) = sum;
  }
}

template <int D>
cudaError_t launch(const ReduceArgs& a, cudaStream_t stream) {
  constexpr int bytes = 2 * sizeof(Stage);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        reduce_partial<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (a.f == 0 || a.n_slots == 0) return cudaSuccess;
  const int n_tiles = ((a.e + kTi - 1) / kTi) * ((a.e + kTj - 1) / kTj);
  if (a.b * a.n_chunks > 0) {
    const dim3 grid(n_tiles, a.b * a.n_chunks * a.n_split, a.f);
    reduce_partial<D><<<grid, kThreads, bytes, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int per4 = (a.e * a.e + a.e) / 4;
  const dim3 grid2((per4 + kCombineThreads - 1) / kCombineThreads, a.n_slots, a.f);
  reduce_combine<<<grid2, kCombineThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool dims_ok(int f, int b, int lk, int e, int d) {
  return (d == 16 || d == 32) && e > 0 && e <= kMaxE && e % d == 0 && f >= 0 && b >= 0 && lk >= 0 &&
         f <= 65535;
}

cudaError_t run(const ReduceArgs& a, int d, cudaStream_t stream) {
  return d == 16 ? launch<16>(a, stream) : launch<32>(a, stream);
}

bool split_ok(int b, int n_chunks, int chunk_len, int n_split, int split_len) {
  return n_chunks >= 1 && n_split >= 1 && split_len >= 1 &&
         static_cast<int64_t>(n_split) * split_len >= chunk_len &&
         static_cast<int64_t>(b) * n_chunks * n_split <= 65535;
}

}  // namespace

// nla_reduce. k, v: [F, B, Lk, E] f32; mask: [F, B, Lk] f32; partial: scratch
// of F * B * n_split * (E*E + E) floats; kv: [F, B, E, E]; ksum: [F, B, 1, E].
// Row b is cut into n_split pieces of split_len rows (the last may be short).
// Returns a cudaError_t (0 = launched).
extern "C" int gnot_nla_reduce(const void* k, const void* v, const void* mask, void* partial,
                               void* kv, void* ksum, int f, int b, int lk, int e, int d,
                               int n_split, int split_len, void* stream) {
  if (!dims_ok(f, b, lk, e, d) || !split_ok(b, 1, lk, n_split, split_len) || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ReduceArgs a;
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.mask = static_cast<const float*>(mask);
  a.seg = nullptr;
  a.partial = static_cast<float*>(partial);
  a.kv = static_cast<float*>(kv);
  a.ksum = static_cast<float*>(ksum);
  a.f = f;
  a.b = b;
  a.lk = lk;
  a.e = e;
  a.n_chunks = 1;
  a.chunk_len = lk;
  a.n_split = n_split;
  a.split_len = split_len;
  a.n_slots = b;
  return static_cast<int>(run(a, d, static_cast<cudaStream_t>(stream)));
}

// nla_reduce_seg. k, v: [F, B, Lk, E] f32; mask: [F, B, Lk] f32; seg: [B, N]
// int32 chunk -> slot ids, Lk = N * chunk; each chunk is cut into n_split
// pieces of split_len rows; partial: scratch of F * B * N * n_split *
// (E*E + E) floats; kv: [F, S, E, E]; ksum: [F, S, 1, E]. Returns a
// cudaError_t (0 = launched).
extern "C" int gnot_nla_reduce_seg(const void* k, const void* v, const void* mask, const void* seg,
                                   void* partial, void* kv, void* ksum, int f, int b, int lk, int e,
                                   int d, int n_chunks, int n_slots, int n_split, int split_len,
                                   void* stream) {
  if (!dims_ok(f, b, lk, e, d) || n_chunks < 1 || lk % n_chunks != 0 || n_slots < 0 ||
      n_slots > 65535 || !split_ok(b, n_chunks, lk / n_chunks, n_split, split_len)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ReduceArgs a;
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.mask = static_cast<const float*>(mask);
  a.seg = static_cast<const int*>(seg);
  a.partial = static_cast<float*>(partial);
  a.kv = static_cast<float*>(kv);
  a.ksum = static_cast<float*>(ksum);
  a.f = f;
  a.b = b;
  a.lk = lk;
  a.e = e;
  a.n_chunks = n_chunks;
  a.chunk_len = lk / n_chunks;
  a.n_split = n_split;
  a.split_len = split_len;
  a.n_slots = n_slots;
  return static_cast<int>(run(a, d, static_cast<cudaStream_t>(stream)));
}
