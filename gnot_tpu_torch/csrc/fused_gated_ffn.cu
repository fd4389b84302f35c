// Fused gated soft-MoE expert FFN for NVIDIA Hopper (sm_90a), float32.
//
// Replaces the TPU kernel gnot_tpu/ops/pallas_ffn.py::fused_gated_ffn
// (pallas_call in _ffn_call, body _ffn_kernel). It computes exactly what
// _ffn_kernel computes: for every token row, each of E expert MLPs runs
// (Linear -> GELU) x (n_linears - 1), then a last Linear, and the expert
// outputs are summed with weights scores[row, e]. f32 in, f32 out, f32
// accumulation, no TF32.
//
// What bounds it on this card: arithmetic. At the serving shapes (4,096
// rows, E=3, five 256x256 Linears) one launch is 8.05 GFLOP against
// ~12.4 MB of compulsory traffic, far above the card's f32 ridge point,
// so the floor is 8.05 GFLOP / 67 TFLOP/s (f32 outside the tensor cores).
//
// What the design does about it. The TPU kernel keeps the whole 3.9 MB
// weight set resident in VMEM; a Hopper block has at most 227 KB of
// shared memory, so here the weights stream and the activations stay:
//   * one block owns kRows = 32 rows (4,096 rows -> 128 blocks on 132
//     SMs). Its x tile and two ping-pong hidden buffers, [32, <=256] f32
//     each, live in dynamic shared memory for the whole expert stack, so
//     no [E, rows, hidden] activation ever reaches device memory;
//   * every weight matrix streams through shared memory in chunks of
//     kChunk = 16 rows, double-buffered with cp.async so the next chunk
//     (across layer and expert boundaries) loads while this one is
//     multiplied. The 3.9 MB weight set stays in the 50 MB L2 across
//     blocks;
//   * 256 threads; warp w owns rows 4w..4w+3 (its hidden-row reads are
//     shared-memory broadcasts), lane t owns columns 4t..4t+3 and
//     128+4t..128+4t+3 (float4 weight reads, conflict-free). Each thread
//     keeps a 4x8 product tile and a 4x8 gated sum in registers;
//   * rows past the end of the input read as zero and are never stored,
//     so any row count works without padding.
// Plain CUDA cores in f32: wgmma/TMA and TF32 are later work (TF32 would
// change the numbers).
//
// Supported: 1..8 Linears, every width a multiple of 16 in [16, 256],
// any n_expert >= 1, any row count. The launcher refuses anything else.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;
constexpr int kThreads = 256;
constexpr int kMaxWidth = 256;
constexpr int kChunk = 16;
constexpr int kMaxLinears = 8;
constexpr int kTile = kRows * kMaxWidth;       // floats in one activation buffer
constexpr int kWTile = kChunk * kMaxWidth;     // floats in one weight chunk buffer
constexpr int kSmemBytes = (3 * kTile + 2 * kWTile) * 4;

struct FfnArgs {
  const float* x;       // [rows, dims[0]]
  const float* scores;  // [rows, n_expert]
  float* out;           // [rows, dims[n_linears]]
  const float* w[kMaxLinears];  // w[i]: [n_expert, dims[i], dims[i+1]]
  const float* b[kMaxLinears];  // b[i]: [n_expert, dims[i+1]]
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
  return x * alpha / beta;
}

// kGelu: 0 = tanh approximation, 1 = exact (erf) GELU.
template <int kGelu>
__device__ __forceinline__ float gelu(float x) {
  if (kGelu == 0) {
    return 0.5f * x * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  }
  return 0.5f * x * (1.0f + erf_poly(x * 0.7071067811865476f));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Position of the next weight chunk to load: expert e, Linear i, row k0.
struct Cursor {
  int e, i, k0;
};

__device__ __forceinline__ void load_chunk(const FfnArgs& a, const Cursor& c, float* dst) {
  const int k = a.dims[c.i];
  const int n = a.dims[c.i + 1];
  const float* src = a.w[c.i] + (static_cast<size_t>(c.e) * k + c.k0) * n;
  const int n4 = kChunk * n / 4;
  for (int j = threadIdx.x; j < n4; j += kThreads) {
    cp_async16(dst + 4 * j, src + 4 * j);
  }
}

__device__ __forceinline__ void advance(const FfnArgs& a, Cursor& c) {
  c.k0 += kChunk;
  if (c.k0 >= a.dims[c.i]) {
    c.k0 = 0;
    if (++c.i == a.n_linears) {
      c.i = 0;
      ++c.e;
    }
  }
}

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

template <int kGelu>
__global__ void __launch_bounds__(kThreads)
fused_gated_ffn_kernel(const __grid_constant__ FfnArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [kRows, dims[0]]
  float* hbase = smem + kTile;       // two [kRows, <=256] hidden buffers
  float* wbase = smem + 3 * kTile;   // two [kChunk, <=256] weight chunks

  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const int din = a.dims[0];

  // Start streaming the first weight chunk, then stage the x tile.
  Cursor cur{0, 0, 0};
  load_chunk(a, cur, wbase);
  cp_async_commit();
  advance(a, cur);
  for (int j = threadIdx.x; j < kRows * din / 4; j += kThreads) {
    const int r = (4 * j) / din;
    const int c = (4 * j) % din;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < a.rows) {
      v = *reinterpret_cast<const float4*>(a.x + static_cast<size_t>(row0 + r) * din + c);
    }
    *reinterpret_cast<float4*>(xs + 4 * j) = v;
  }

  float gacc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) gacc[r][j] = 0.f;

  int chunk = 0;
  for (int e = 0; e < a.n_expert; ++e) {
    float sc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + ty * 4 + r;
      sc[r] = row < a.rows ? a.scores[static_cast<size_t>(row) * a.n_expert + e] : 0.f;
    }
    const float* hin = xs;
    for (int i = 0; i < a.n_linears; ++i) {
      const int k = a.dims[i];
      const int n = a.dims[i + 1];
      float acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

      for (int k0 = 0; k0 < k; k0 += kChunk, ++chunk) {
        // Chunk `chunk` has landed and every thread is done with the
        // other buffer: refill it with the next chunk while this one is
        // multiplied.
        cp_async_wait_all();
        __syncthreads();
        if (cur.e < a.n_expert) {
          load_chunk(a, cur, wbase + ((chunk + 1) & 1) * kWTile);
          advance(a, cur);
        }
        cp_async_commit();
        const float* wb = wbase + (chunk & 1) * kWTile;
#pragma unroll
        for (int kk = 0; kk < kChunk; kk += 4) {
          float4 hv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            hv[r] = *reinterpret_cast<const float4*>(hin + (ty * 4 + r) * k + k0 + kk);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // Columns past n read stale chunk data; those sums are never stored.
            const float4 w0 = *reinterpret_cast<const float4*>(wb + (kk + q) * n + tx * 4);
            const float4 w1 = *reinterpret_cast<const float4*>(wb + (kk + q) * n + 128 + tx * 4);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float h = lane(hv[r], q);
              acc[r][0] += h * w0.x;
              acc[r][1] += h * w0.y;
              acc[r][2] += h * w0.z;
              acc[r][3] += h * w0.w;
              acc[r][4] += h * w1.x;
              acc[r][5] += h * w1.y;
              acc[r][6] += h * w1.z;
              acc[r][7] += h * w1.w;
            }
          }
        }
      }

      // Epilogue: bias, then GELU into the next hidden buffer, or (last
      // Linear) the gate-weighted sum. The buffer written here was last
      // read by Linear i-1, which every thread finished before the
      // __syncthreads of this Linear's first chunk.
      const bool last = i == a.n_linears - 1;
      float* hout = hbase + (i & 1) * kTile;
      const float* bias = a.b[i] + static_cast<size_t>(e) * n;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int c = g * 128 + tx * 4;
        if (c >= n) continue;
        const float4 bv = *reinterpret_cast<const float4*>(bias + c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v[4] = {acc[r][4 * g] + bv.x, acc[r][4 * g + 1] + bv.y,
                        acc[r][4 * g + 2] + bv.z, acc[r][4 * g + 3] + bv.w};
          if (last) {
#pragma unroll
            for (int j = 0; j < 4; ++j) gacc[r][4 * g + j] += sc[r] * v[j];
          } else {
            *reinterpret_cast<float4*>(hout + (ty * 4 + r) * n + c) =
                make_float4(gelu<kGelu>(v[0]), gelu<kGelu>(v[1]),
                            gelu<kGelu>(v[2]), gelu<kGelu>(v[3]));
          }
        }
      }
      hin = hout;
    }
  }

  const int dout = a.dims[a.n_linears];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty * 4 + r;
    if (row >= a.rows) continue;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int c = g * 128 + tx * 4;
      if (c >= dout) continue;
      *reinterpret_cast<float4*>(a.out + static_cast<size_t>(row) * dout + c) =
          make_float4(gacc[r][4 * g], gacc[r][4 * g + 1], gacc[r][4 * g + 2], gacc[r][4 * g + 3]);
    }
  }
}

template <int kGelu>
cudaError_t launch(const FfnArgs& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_gated_ffn_kernel<kGelu>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int blocks = (a.rows + kRows - 1) / kRows;
  fused_gated_ffn_kernel<kGelu><<<blocks, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x, scores, out: device pointers. weights, biases: host arrays of
// n_linears device pointers. dims: host array of n_linears + 1 widths.
// gelu: 0 = tanh, 1 = erf. Returns a cudaError_t (0 = launched).
extern "C" int gnot_fused_gated_ffn(const void* x, const void* scores, void* out,
                                    const void* weights, const void* biases,
                                    const void* dims, int n_linears, int n_expert,
                                    int rows, int gelu, void* stream) {
  if (n_linears < 1 || n_linears > kMaxLinears || n_expert < 1 || rows < 0 ||
      (gelu != 0 && gelu != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FfnArgs a;
  a.x = static_cast<const float*>(x);
  a.scores = static_cast<const float*>(scores);
  a.out = static_cast<float*>(out);
  const int* d = static_cast<const int*>(dims);
  for (int i = 0; i <= n_linears; ++i) {
    if (d[i] < 16 || d[i] > kMaxWidth || d[i] % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.dims[i] = d[i];
  }
  for (int i = n_linears + 1; i <= kMaxLinears; ++i) a.dims[i] = 0;
  const uint64_t* w = static_cast<const uint64_t*>(weights);
  const uint64_t* b = static_cast<const uint64_t*>(biases);
  for (int i = 0; i < kMaxLinears; ++i) {
    a.w[i] = i < n_linears ? reinterpret_cast<const float*>(w[i]) : nullptr;
    a.b[i] = i < n_linears ? reinterpret_cast<const float*>(b[i]) : nullptr;
  }
  a.n_linears = n_linears;
  a.n_expert = n_expert;
  a.rows = rows;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = gelu == 0 ? launch<0>(a, s) : launch<1>(a, s);
  return static_cast<int>(err);
}
