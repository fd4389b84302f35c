// Fused gated soft-MoE expert FFN for NVIDIA Hopper (sm_90a), float32 or
// bfloat16 in and out, float32 or bfloat16 weights, computed in float32,
// products on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel gnot_tpu/ops/pallas_ffn.py:206 fused_gated_ffn
// (pallas_call in _ffn_call, body _ffn_kernel :123). For every token row,
// each of E expert MLPs runs (Linear -> GELU) x (n_linears - 1), then a
// last Linear, and the expert outputs are summed with weights
// scores[row, e]. As on the TPU, the expert stack stays fused: no
// [E, rows, hidden] activation reaches device memory.
//
// Why 3xTF32. One TF32 product keeps 10 mantissa bits and misses the f32
// bar this port is held to (rtol 1e-4 / atol 1e-5 against the f32 plain
// version): emulated at the serving shapes its max error against an f64
// forward is 1.6e-5, against 2.8e-8 for f32. Splitting each operand into
// a TF32 high part hi = rna(x) and a low part lo = rna(x - hi), and
// summing a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with f32 accumulation, gives
// 3.3e-8 in that emulation (tests/test_torch_ffn.py checks both). On the
// card the tensor cores' f32 accumulation rounds less carefully: the
// kernel lands ~3e-7 from the f32 plain version at the serving shapes,
// 30x inside the bar (chip_smoke.py phase 3).
//
// What bounds it on this card: operations. At the serving shapes (4,096
// rows, E=3, five 256x256 Linears) one launch is 8.05 GFLOP of products,
// 3 x 8.05 on the tensor cores: 24.2 GFLOP / 495 TFLOP/s (TF32, dense) =
// 0.0488 ms. Compulsory traffic is ~12.4 MB (3.7 us at 3.35 TB/s).
//
// Design.
//   * Blocks: a cluster of 2 CTAs owns one 64-row tile (the wgmma M), so
//     4,096 rows make 128 CTAs, one wave on 132 SMs. CTA h of the
//     cluster computes output columns [128h, 128h + 128) of every Linear
//     with one consumer warpgroup (m64n128k8), and writes its half of
//     each hidden layer into both CTAs' shared memory (distributed shared
//     memory); one cluster barrier per Linear. Each consumer thread keeps
//     a 64-float accumulator and the 64-float gate-weighted sum in
//     registers.
//   * Weights: the wrapper packs each [E, in, out] kernel once (cached
//     per tensor and version) into this kernel's image: zero-padded to
//     256 output columns, K-major, split into hi and lo, cut into chunks
//     of 16 K-rows x 128 columns (hi then lo, 16 KB) laid out as wgmma's
//     canonical no-swizzle core matrices. A producer warp streams them,
//     one cp.async.bulk per chunk completing on a "full" mbarrier, into a
//     ring of kStages slots that the consumers hand back through "empty"
//     mbarriers; no tensor map is needed. The stream runs across Linear
//     and expert boundaries, and the 7.9 MB image stays in the 50 MB L2.
//   * Activations: the A operand is read from shared memory (the x tile,
//     re-read from L2 for each expert, or the previous Linear's output)
//     into registers and split into hi and lo there, one chunk ahead, in
//     two register sets, while the tensor cores run the current chunk.
//     Within a 16-wide K chunk each thread reads one float4 per row; the
//     image's K order is permuted to match, so A needs no shuffles. The
//     hidden buffers are ping-ponged, with a row stride of 272 floats
//     (conflict-free float4 reads).
//   * Epilogue on the CUDA cores in f32: bias (staged in shared memory),
//     GELU (the same tanh or polynomial-erf GELU as pallas_ffn.py:81-116,
//     without branches) into the next hidden buffer, or for the last
//     Linear the gate-weighted sum.
//   * Shared memory: 2 x 64 x 272 x 4 B hidden + 5 x 16 KB weight ring
//     = 216 KB of the 227 KB a block may use.
//   * Zero padding: widths below 256 compute on zero weights and zero
//     bias, and GELU(0) = 0, so padded columns stay 0. Rows past the end
//     read zero and are never stored.
// What holds it back (gnot_tpu_torch/ffn_probe.py): the products run at
// about full rate but do not overlap the rest of each chunk's work, and
// each CTA streams 3.9 MB of hi+lo weights from L2 per launch; a 64-row
// tile reads each weight byte once for 64 rows.
//
//   * bfloat16 I/O (bf16 serving): x, weights, biases and the output in
//     bf16, gate scores in f32, the mix the JAX model passes its kernel
//     (pallas_ffn.py:128-145, :178). For bf16 activations x is widened
//     to f32 into the first hidden buffer
//     (exact), biases are read as f32, and the whole expert stack and the
//     gate-weighted sum stay f32, with one rounding to bf16 (nearest
//     even) at the store; nothing is rounded between Linears. The bf16
//     weights reach the kernel as the same f32 hi/lo image; a bf16 value
//     is exact in TF32, so the lo image is all zeros and the a_hi * b_lo
//     product adds exact zeros: the bf16 kernel skips it (two products
//     per k8 step, the same sums): 2 x 8.05 GFLOP / 495 TFLOP/s = 0.0325
//     ms at the serving shapes. On Linear 0 the bf16 x is exact in TF32
//     too, and its a_lo * b_hi product (all zeros) still runs. The least
//     time for the function is lower (chip_smoke.py ffn_bound_ms): on the
//     bf16 tensor cores (989 TFLOP/s), one product on Linear 0's bf16 x
//     and weights, three on each later Linear's f32 activations split
//     into three bf16 pieces (exact to f32), 13 x 1.61 GFLOP = 0.0212 ms.
//
//   * bf16 activations with f32 weights and biases (bf16 training): the
//     JAX model computes its blocks in bf16 on the f32 master weights and
//     hands its kernel the weights uncast (gnot_tpu/models/layers.py,
//     GatedExpertFfn). The kernel is templated on the activation type TX
//     (x, out) and the parameter type TP (biases; the weight image is f32
//     either way) apart. The lo image of an f32 weight is not zero, so
//     whether the a_hi * b_lo product runs follows TP, not TX: skipping it
//     here would compute another function. x widens exactly, its a_lo is
//     zero on Linear 0, and the output rounds once at the store, so this
//     instance is bitwise the f32 instance run on the widened x with its
//     output rounded to bf16 (chip_smoke.py phase 3 checks it). Its least
//     time (chip_smoke.py ffn_bound_ms): Linear 0's f32 weights in three
//     bf16 pieces against its bf16 x, three products at 989 TFLOP/s, and
//     3xTF32 on the later Linears, 0.0049 + 0.0390 = 0.044 ms at the
//     serving shapes; the kernel runs 3xTF32 on every Linear (0.0488 ms).
//
// Supported: 1..8 Linears, every width a multiple of 16 in [16, 256],
// any n_expert >= 1, any row count, and three type mixes: f32 x, weights
// and biases; bf16 ones; bf16 x with f32 weights and biases. The scores
// are f32 in all three. The launcher refuses anything else.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;            // rows of a tile (the wgmma M)
constexpr int kCols = 128;           // output columns of one CTA (the wgmma N)
constexpr int kConsumers = 128;      // one warpgroup multiplies
constexpr int kThreads = kConsumers + 32;  // and one warp streams weights
constexpr int kMaxWidth = 256;
constexpr int kMaxLinears = 8;
constexpr int kChunkK = 16;          // K rows of a weight chunk: two k8 steps
constexpr int kStages = 5;           // weight chunks in flight
constexpr int kLd = 272;             // hidden row stride in floats
constexpr int kChunkFloats = 2 * kChunkK * kCols;   // hi + lo
constexpr int kChunkBytes = kChunkFloats * 4;        // 16 KB
constexpr int kHiddenFloats = kRows * kLd;
constexpr int kSmemBytes =
    kStages * kChunkBytes + 2 * kHiddenFloats * 4 + kCols * 4 + 2 * kStages * 8;

// TX is the activation type of x and out, TP the parameter type of the
// weights and biases: float or __nv_bfloat16 each.
template <typename TX, typename TP>
struct FfnArgs {
  const TX* x;          // [rows, dims[0]]
  const float* scores;  // [rows, n_expert], f32 for every mix
  TX* out;              // [rows, dims[n_linears]]
  const float* w[kMaxLinears];  // w[i]: packed f32 image of Linear i
  const TP* b[kMaxLinears];     // b[i]: [n_expert, dims[i+1]]
  int dims[kMaxLinears + 1];
  int n_linears;
  int n_expert;
  int rows;
};

// float32 erf as the rational polynomial of gnot_tpu/ops/pallas_ffn.py
// _erf_f32 (Eigen's generic_fast_erf_float), so both kernels compute the
// same exact-GELU.
__device__ __forceinline__ float erf_poly(float x) {
  x = fminf(fmaxf(x, -3.832506856900711f), 3.832506856900711f);
  const float z = x * x;
  float alpha = -2.72614225801306e-10f;
  alpha = alpha * z + 2.77068142495902e-08f;
  alpha = alpha * z + -2.10102402082508e-06f;
  alpha = alpha * z + -5.69250639462346e-05f;
  alpha = alpha * z + -7.34990630326855e-04f;
  alpha = alpha * z + -2.95459980854025e-03f;
  alpha = alpha * z + -1.60960333262415e-02f;
  float beta = -1.45660718464996e-05f;
  beta = beta * z + -2.13374055278905e-04f;
  beta = beta * z + -1.68282697438203e-03f;
  beta = beta * z + -7.37332916720468e-03f;
  beta = beta * z + -1.42647390514189e-02f;
  return __fdividef(x * alpha, beta);  // beta is in [-0.0143, -0.0142]
}

// kGelu: 0 = tanh approximation, 1 = exact (erf) GELU. The tanh form is
// computed as x * sigmoid(2u) = x / (1 + exp(-2u)), the same function as
// 0.5 x (1 + tanh(u)) without tanhf's branches: one ex2 and one
// reciprocal on the special-function unit, a few ulp from the plain
// version. A large negative x gives 0 (the true value is below 1e-30).
template <int kGelu>
__device__ __forceinline__ float gelu(float x) {
  if (kGelu == 0) {
    const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return __fdividef(x, 1.0f + exp2f(-2.8853900817779268f * u));  // 2 log2(e)
  }
  return 0.5f * x * (1.0f + erf_poly(x * 0.7071067811865476f));
}

// Four consecutive activations widened to f32 (bf16 -> f32 is exact), and
// two f32 values stored as TX (one rounding, nearest even, for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Waits for the barrier's phase `parity` to complete. A copy that never
// lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    if (spins == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// One bulk copy of a weight chunk into shared memory, completing on `bar`.
__device__ __forceinline__ void load_chunk(float* dst, const float* src, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(kChunkBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(kChunkBytes), "r"(smem_u32(bar))
      : "memory");
}

// Round to TF32 (nearest, ties away from zero), as the wrapper's pack does.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Shared-memory descriptor of one k8 step of a weight chunk: K-major, no
// swizzle; core matrices of 8 columns x 4 K (128 B), the two K halves
// 2048 B apart (LBO), neighbouring 8-column groups 128 B apart (SBO).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(2048 >> 4) << 16) | (static_cast<uint64_t>(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders register uses of the accumulator against the asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 8] (registers, tf32) * B[8 x 128] (shared, tf32).
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// A fragments of chunk c's two k8 steps, split into TF32 hi and lo.
// Thread (g, t4) reads columns 4*t4 .. 4*t4+3 of its rows r0 and r1 as
// one float4 each; the image orders K so that step kk's k = t4 and
// k = t4 + 4 are columns 4*t4 + 2*kk and 4*t4 + 2*kk + 1.
__device__ __forceinline__ void load_a(const float* hin, int c, int r0, int r1, int t4,
                                       uint32_t (&ah)[2][4], uint32_t (&al)[2][4]) {
  const float4 x0 = *reinterpret_cast<const float4*>(hin + r0 * kLd + c * kChunkK + 4 * t4);
  const float4 x1 = *reinterpret_cast<const float4*>(hin + r1 * kLd + c * kChunkK + 4 * t4);
  split_tf32(x0.x, ah[0][0], al[0][0]);
  split_tf32(x1.x, ah[0][1], al[0][1]);
  split_tf32(x0.y, ah[0][2], al[0][2]);
  split_tf32(x1.y, ah[0][3], al[0][3]);
  split_tf32(x0.z, ah[1][0], al[1][0]);
  split_tf32(x1.z, ah[1][1], al[1][1]);
  split_tf32(x0.w, ah[1][2], al[1][2]);
  split_tf32(x1.w, ah[1][3], al[1][3]);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// The consumer warpgroup's own barrier (the producer warp stays out).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// A cluster barrier split in two, so that the producer warp can arrive
// early and wait late.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int kGelu, typename TX, typename TP>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    fused_gated_ffn_kernel(const __grid_constant__ FfnArgs<TX, TP> a) {
  // bf16 weights have an all-zero lo image, f32 weights do not: the
  // parameter type decides (see the header).
  constexpr bool kLoWeights = sizeof(TP) == sizeof(float);
  extern __shared__ __align__(1024) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // kStages weight chunks
  float* hid = ring + kStages * kChunkFloats;     // two [64, kLd] buffers
  float* bias_s = hid + 2 * kHiddenFloats;        // [128] this CTA's bias
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + kCols);  // chunk landed
  uint64_t* empty = full + kStages;                              // slot free again

  cg::cluster_group cluster = cg::this_cluster();
  const int half = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The peer's shared memory is live, and the barriers initialised,
  // before anyone uses them.
  cluster.sync();

  if (tid >= kConsumers) {
    // The producer warp: lane 0 streams every weight chunk of this CTA's
    // column half, in the order the consumers multiply them, into the
    // ring, each once its slot is free. The warp also keeps the cluster
    // barriers of the consumers' Linears: it arrives at Linear k's when
    // it has issued that Linear's chunks and waits for it only after
    // issuing the next Linear's, so it never holds back a copy.
    int m = 0;  // chunks issued
    bool first = true;
    for (int e = 0; e < a.n_expert; ++e) {
      for (int i = 0; i < a.n_linears; ++i) {
        if ((tid & 31) == 0) {
          const int nck = a.dims[i] / kChunkK;
          const float* src = a.w[i] + static_cast<size_t>((e * 2 + half) * nck) * kChunkFloats;
          for (int c = 0; c < nck; ++c, ++m, src += kChunkFloats) {
            const int slot = m % kStages;
            if (m >= kStages) mbar_wait(&empty[slot], ((m / kStages) + 1) & 1);
            load_chunk(ring + slot * kChunkFloats, src, &full[slot]);
          }
        }
        __syncwarp();
        if (!first) cluster_wait();
        cluster_arrive();
        first = false;
      }
    }
    cluster_wait();
    return;
  }

  // The consumer warpgroup.
  float* peer_hid = cluster.map_shared_rank(hid, half ^ 1);
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;
  const bool lane0 = (tid & 31) == 0;
  const int r0 = 16 * (tid >> 5) + g;  // this thread's accumulator rows r0, r0 + 8
  const int r1 = r0 + 8;
  const int row0 = (blockIdx.x >> 1) * kRows;
  const int din = a.dims[0];

  float gacc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) gacc[j] = 0.f;

  int t = 0;  // chunks consumed so far
  for (int e = 0; e < a.n_expert; ++e) {
    const float s0 = row0 + r0 < a.rows ? a.scores[static_cast<size_t>(row0 + r0) * a.n_expert + e] : 0.f;
    const float s1 = row0 + r1 < a.rows ? a.scores[static_cast<size_t>(row0 + r1) * a.n_expert + e] : 0.f;
    // The x tile into the first hidden buffer. Nobody reads it now (the
    // last Linear ended in a cluster barrier) and the peer writes it no
    // earlier than Linear 1's epilogue.
    for (int j = tid; j < kRows * din / 4; j += kConsumers) {
      const int r = (4 * j) / din;
      const int c = (4 * j) % din;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < a.rows) v = load4(a.x + static_cast<size_t>(row0 + r) * din + c);
      *reinterpret_cast<float4*>(hid + r * kLd + c) = v;
    }
    consumer_sync();

    for (int i = 0; i < a.n_linears; ++i) {
      const float* hin = hid + (i & 1) * kHiddenFloats;
      const int nck = a.dims[i] / kChunkK;
      const int n = a.dims[i + 1];
      // This CTA's 128 bias values, staged in shared memory during the
      // first chunk (a global load per value in the epilogue would
      // stall it once per column group).
      const int bcol = half * kCols + tid;
      const float bias_v = bcol < n ? load1(a.b[i] + static_cast<size_t>(e) * n + bcol) : 0.f;
      float acc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = 0.f;
      fence_acc(acc);

      // One chunk: wait for its weights, issue its six products, wait for
      // chunk t - 1 and hand its slot back to the producer, then load the
      // next chunk's A fragments into chunk t - 1's register set while
      // the tensor cores run chunk t.
      auto step = [&](int c, const uint32_t(&ah)[2][4], const uint32_t(&al)[2][4],
                      uint32_t(&nh)[2][4], uint32_t(&nl)[2][4]) {
        const int s = t % kStages;
        mbar_wait(&full[s], (t / kStages) & 1);
        const uint32_t sb = smem_u32(ring + s * kChunkFloats);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t b_hi = b_desc(sb + kk * 4096);
          const uint64_t b_lo = b_desc(sb + 8192 + kk * 4096);
          wgmma_m64n128k8(acc, al[kk], b_hi);  // small terms first
          if constexpr (kLoWeights) {
            wgmma_m64n128k8(acc, ah[kk], b_lo);
          }
          wgmma_m64n128k8(acc, ah[kk], b_hi);
        }
        wgmma_commit();
        if (c == 0) bias_s[tid] = bias_v;
        wgmma_wait<1>();  // chunk t - 1 is done: its slot and A registers are free
        if (t > 0 && lane0) mbar_arrive(&empty[(t - 1) % kStages]);
        if (c + 1 < nck) load_a(hin, c + 1, r0, r1, t4, nh, nl);
        ++t;
      };
      uint32_t a0h[2][4], a0l[2][4], a1h[2][4], a1l[2][4];
      load_a(hin, 0, r0, r1, t4, a0h, a0l);
      for (int c = 0; c < nck; c += 2) {
        step(c, a0h, a0l, a1h, a1l);
        if (c + 1 < nck) step(c + 1, a1h, a1l, a0h, a0l);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      consumer_sync();  // bias_s is in place

      // Epilogue: bias, then GELU into the next hidden buffer of both
      // CTAs, or (last Linear) the gate-weighted sum. Accumulator j of
      // the thread is row r0 (j % 4 < 2) or r1, column
      // 128 * half + 8 * (j / 4) + 2 * t4 + (j % 2).
      const bool last = i == a.n_linears - 1;
      float* own = hid + ((i + 1) & 1) * kHiddenFloats;
      float* far = peer_hid + ((i + 1) & 1) * kHiddenFloats;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = half * kCols + 8 * j + 2 * t4;
        const float2 bv = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * t4);
        const float v00 = acc[4 * j] + bv.x, v01 = acc[4 * j + 1] + bv.y;
        const float v10 = acc[4 * j + 2] + bv.x, v11 = acc[4 * j + 3] + bv.y;
        if (last) {
          gacc[4 * j] += s0 * v00;
          gacc[4 * j + 1] += s0 * v01;
          gacc[4 * j + 2] += s1 * v10;
          gacc[4 * j + 3] += s1 * v11;
        } else {
          const float2 h0 = make_float2(gelu<kGelu>(v00), gelu<kGelu>(v01));
          const float2 h1 = make_float2(gelu<kGelu>(v10), gelu<kGelu>(v11));
          *reinterpret_cast<float2*>(own + r0 * kLd + col) = h0;
          *reinterpret_cast<float2*>(own + r1 * kLd + col) = h1;
          *reinterpret_cast<float2*>(far + r0 * kLd + col) = h0;
          *reinterpret_cast<float2*>(far + r1 * kLd + col) = h1;
        }
      }
      // Both halves of the next hidden layer are in place in both CTAs,
      // and both are done reading this Linear's input.
      cluster_arrive();
      cluster_wait();
    }
  }

  const int dout = a.dims[a.n_linears];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = half * kCols + 8 * j + 2 * t4;
    if (col >= dout) continue;
    if (row0 + r0 < a.rows) {
      store2(a.out + static_cast<size_t>(row0 + r0) * dout + col, gacc[4 * j], gacc[4 * j + 1]);
    }
    if (row0 + r1 < a.rows) {
      store2(a.out + static_cast<size_t>(row0 + r1) * dout + col, gacc[4 * j + 2],
             gacc[4 * j + 3]);
    }
  }
}

template <int kGelu, typename TX, typename TP>
cudaError_t launch(const FfnArgs<TX, TP>& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(fused_gated_ffn_kernel<kGelu, TX, TP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int tiles = (a.rows + kRows - 1) / kRows;
  fused_gated_ffn_kernel<kGelu, TX, TP><<<2 * tiles, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename TX, typename TP>
cudaError_t run(const void* x, const void* scores, void* out, const int* dims,
                const uint64_t* w, const uint64_t* b, int n_linears, int n_expert, int rows,
                int gelu, cudaStream_t stream) {
  FfnArgs<TX, TP> a;
  a.x = static_cast<const TX*>(x);
  a.scores = static_cast<const float*>(scores);
  a.out = static_cast<TX*>(out);
  for (int i = 0; i <= kMaxLinears; ++i) a.dims[i] = i <= n_linears ? dims[i] : 0;
  for (int i = 0; i < kMaxLinears; ++i) {
    a.w[i] = i < n_linears ? reinterpret_cast<const float*>(w[i]) : nullptr;
    a.b[i] = i < n_linears ? reinterpret_cast<const TP*>(b[i]) : nullptr;
  }
  a.n_linears = n_linears;
  a.n_expert = n_expert;
  a.rows = rows;
  return gelu == 0 ? launch<0, TX, TP>(a, stream) : launch<1, TX, TP>(a, stream);
}

}  // namespace

// x, scores, out: device pointers. weights: host array of n_linears
// device pointers to packed f32 images (ops/fused_ffn.py::pack_weights).
// biases: host array of n_linears device pointers, [n_expert, out] each.
// dims: host array of n_linears + 1 widths. gelu: 0 = tanh, 1 = erf.
// dtype: the type mix, 0 = float32 x, out, weights and biases; 1 = all
// bfloat16; 2 = bfloat16 x and out with float32 weights and biases (the
// packed image is float32 in all three, scores are float32 in all three).
// Returns a cudaError_t (0 = launched).
extern "C" int gnot_fused_gated_ffn(const void* x, const void* scores, void* out,
                                    const void* weights, const void* biases,
                                    const void* dims, int n_linears, int n_expert,
                                    int rows, int gelu, int dtype, void* stream) {
  if (n_linears < 1 || n_linears > kMaxLinears || n_expert < 1 || rows < 0 ||
      (gelu != 0 && gelu != 1) || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* d = static_cast<const int*>(dims);
  for (int i = 0; i <= n_linears; ++i) {
    if (d[i] < 16 || d[i] > kMaxWidth || d[i] % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (rows == 0) return 0;
  const uint64_t* w = static_cast<const uint64_t*>(weights);
  const uint64_t* b = static_cast<const uint64_t*>(biases);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (dtype == 0) {
    err = run<float, float>(x, scores, out, d, w, b, n_linears, n_expert, rows, gelu, s);
  } else if (dtype == 1) {
    err = run<bf16, bf16>(x, scores, out, d, w, b, n_linears, n_expert, rows, gelu, s);
  } else {
    err = run<bf16, float>(x, scores, out, d, w, b, n_linears, n_expert, rows, gelu, s);
  }
  return static_cast<int>(err);
}
