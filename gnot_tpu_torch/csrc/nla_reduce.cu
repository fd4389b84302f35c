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
// What bounds it on this card. At full width (F*B = 4 Grams of 256x256
// over Lk = 1024 rows) the compulsory traffic (k, v and the mask read once,
// kv and k_sum written once) is ~9.4 MB: 2.8 us at 3.35 TB/s. The Gram is
// 2 E^2 flops per unmasked key row, 0.26 GFLOP at the self shape (~1,980
// of 4,096 rows unmasked; 0.54 GFLOP if every row counted). On the f32
// CUDA cores (67 TFLOP/s) that is 3.9 us, so arithmetic bounds it there.
// On the tensor cores in 3xTF32 (three TF32 products per multiply-add at
// 495 TFLOP/s, f32's accuracy) it is 1.6 us, so bytes bound it: 2.8 us.
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
//     whole heads for D = 16 and 32) and sums k_sum on the CUDA cores.
//   * The Gram tile is multiplied on the tensor cores with mma.sync
//     m16n8k8 TF32: each of the 4 warps owns a 32x64 quarter of the tile,
//     2 x 8 m16n8 tiles, 64 f32 accumulators a thread. Per 8 key rows a
//     warp loads its A (ks^T, read down the columns of the k stripe) and B
//     (the v stripe) fragments from shared memory by hand, splits each
//     value into a TF32 hi and the TF32 rounding of the rest (lo), and adds
//     lo*hi + hi*lo + hi*hi into f32 (3xTF32; lo*lo lies below f32's
//     precision). That is 48 HMMA, 24 shared loads and 72 split
//     instructions a thread per 8 rows, where an FFMA loop issues 512
//     FFMA and 32 16-byte loads. The shared row strides are padded to 72
//     and 136 floats (8 mod 32 words), so a fragment load (8 tile columns
//     x 4 key rows) hits 32 distinct banks.
//   * What a step costs (reduce_probe's source variants, one block alone
//     on an SM of an H100 SXM at 700 W): ~6.1 us a 32-row step, of which
//     the softmax ~4.2 (each row's IEEE division branches to its slow
//     path, which keeps the unrolled rows' shuffle chains from
//     overlapping), the product loop ~1.6 and the staging ~0.9. So the
//     products are not the bound now: the softmax is.
//   * mma.sync and not wgmma: TF32 wgmma reads its shared-memory operands
//     K-major only, and here K is the key-row axis while k and v arrive
//     with their features contiguous, so wgmma would need a transposing
//     copy of every stage. mma.sync fragments are loaded from any layout.
//   * Rows past a chunk's end and columns past E are zero-filled by the copy
//     and carry mask 0, so no input is padded.
// f32 in and out. wgmma with TMA, skipping masked rows and warp
// specialisation are later work.
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
// Shared row strides of the staged stripes, padded to 8 mod 32 words so a
// fragment load (lane g*4+q reads row q, column g) hits 32 distinct banks.
constexpr int kStrideK = kTi + 8;
constexpr int kStrideV = kTj + 8;
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
  float k[kRows][kStrideK];
  float v[kRows][kStrideV];
  float m[kRows];
};

// Round to TF32 (nearest, ties away from zero): the low 13 bits are 0.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-21 |x|), hi and lo both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d[16x8] += a[16x8] * b[8x8] on the tensor cores, TF32 in, f32 sums. With
// g = lane / 4 and q = lane % 4: a holds (row, col) (g, q), (g+8, q),
// (g, q+4), (g+8, q+4); b holds (q, g), (q+4, g); d holds (g, 2q),
// (g, 2q+1), (g+8, 2q), (g+8, 2q+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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
  const int g = lane >> 2;            // mma fragment row group
  const int q = lane & 3;             // and thread within it
  const int wm = (warp >> 1) * 32;    // the warp's tile rows wm..wm+31
  const int wn = (warp & 1) * 64;     // and columns wn..wn+63
  float acc[2][8][4];                 // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mt][nt][x] = 0.f;
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

    // The Gram tile on the tensor cores, 8 key rows per mma: A = ks^T
    // (tile row i, key row r) = k[r][i], B = v; 3xTF32, small terms first.
    const Stage& s = st[cur];
#pragma unroll
    for (int r = 0; r < kRows; r += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int i = wm + 16 * mt + g;
        split_tf32(s.k[r + q][i], ah[mt][0], al[mt][0]);
        split_tf32(s.k[r + q][i + 8], ah[mt][1], al[mt][1]);
        split_tf32(s.k[r + q + 4][i], ah[mt][2], al[mt][2]);
        split_tf32(s.k[r + q + 4][i + 8], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int j = wn + 8 * nt + g;
        uint32_t bh[2], bl[2];
        split_tf32(s.v[r + q][j], bh[0], bl[0]);
        split_tf32(s.v[r + q + 4][j], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][nt], al[mt], bh);
          mma_tf32(acc[mt][nt], ah[mt], bl);
          mma_tf32(acc[mt][nt], ah[mt], bh);
        }
      }
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
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = wm + 16 * mt + 8 * h + g;
      if (gi >= wi) continue;
      float* prow = p + static_cast<size_t>(i0 + gi) * a.e + j0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int gj = wn + 8 * nt + 2 * q;  // even, and wj is a multiple of D
        if (gj < wj) {
          *reinterpret_cast<float2*>(prow + gj) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
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
