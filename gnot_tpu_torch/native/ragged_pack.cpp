// Native ragged->dense batch packer of the port: the host-side hot loop
// of the serving dispatch path and of collate. A copy of the JAX
// package's gnot_tpu/native/ragged_pack.cpp with the same three
// extern "C" symbols and ABI, built with g++ into build/gnot_tpu_torch/
// at first use (gnot_tpu_torch/native/__init__.py); it needs no nvcc and
// no card.
//
// * gnot_pack_rows: pad n ragged [len_i, dim] float32 blocks into a dense
//   [n, max_len, dim] batch and its 0/1 mask in one call: one memcpy per
//   sample row-block, the mask written in the same sweep.
// * gnot_pack_rows_bf16: the FUSED pad-and-cast: the same sweep, emitting
//   bfloat16 bits (round-to-nearest-even, NaN kept as 0x7FC0 / 0xFFC0 by
//   sign), so a bf16 serving dispatch assembles its half-width batch in
//   one pass instead of pack-then-cast.
// * gnot_unpad_rows: batched unpad/scatter: every response's [n_i, out]
//   rows copied out of the dispatch output in ONE call (padded rows or
//   packed (row, offset) segments alike).
//
// ABI: plain C symbols loaded via ctypes (no pybind11, no PyTorch
// headers). The port's lint rule GL007 (gnot_tpu_torch/analysis/
// native_abi.py) cross-checks these signatures against the ctypes
// bindings in __init__.py (arity + dtype tags) on every run.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// The bf16 conversion inside gnot_pack_rows_bf16 is EXACTLY the
// Eigen::bfloat16 round-to-nearest-even ml_dtypes uses, and the numpy
// fallback (native/__init__.py::bf16_bits) is the same formula on the
// uint32 bits, so the two are bitwise-identical, NaNs included
// (tests/test_torch_native.py asserts it against the JAX package).

// Run pack_one(i) for i in [0, n), threaded only when the payload is
// so large that thread spawn (hundreds of us on a busy host) is noise:
// per-dispatch serve payloads (KBs to a few MB) finish their memcpy
// before a second thread starts, so the bar is 32 MB, the JAX package's.
template <typename F>
void for_samples(int64_t n, int64_t total_bytes, F&& pack_one) {
  const unsigned hw = std::thread::hardware_concurrency();
  if (total_bytes < (int64_t{32} << 20) || hw <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) pack_one(i);
    return;
  }
  const int64_t n_threads = std::min<int64_t>(n, hw);
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads));
  for (int64_t t = 0; t < n_threads; ++t) {
    threads.emplace_back([&, t] {
      for (int64_t i = t; i < n; i += n_threads) pack_one(i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Pack n ragged [len_i, dim] float32 row-blocks into a dense
// [n, max_len, dim] tensor and a [n, max_len] 0/1 mask. `srcs[i]`
// points at sample i's contiguous data.
//
// CALLER CONTRACT: `out` and `mask` arrive ZERO-INITIALIZED (the
// Python side allocates them with np.zeros — calloc-backed lazy zero
// pages). Only the payload and the mask's 1-prefix are written here;
// the pad tail is never touched, so untouched pad PAGES are never
// faulted in: no redundant memset sweep over the whole batch.
void gnot_pack_rows(const float** srcs, const int64_t* lens, int64_t n,
                    int64_t dim, int64_t max_len, float* out, float* mask) {
  const int64_t row_bytes = dim * static_cast<int64_t>(sizeof(float));
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) total += lens[i] * row_bytes;
  for_samples(n, total, [&](int64_t i) {
    const int64_t len = lens[i];
    std::memcpy(out + i * max_len * dim, srcs[i],
                static_cast<size_t>(len * row_bytes));
    float* m = mask + i * max_len;
    for (int64_t r = 0; r < len; ++r) m[r] = 1.0f;
  });
}

// Fused pad-and-cast: gnot_pack_rows semantics (same zero-initialized
// caller contract), but the output tensor and mask are bfloat16
// (uint16 bits, RNE) — ONE sweep builds the half-width dispatch batch
// a bf16 serving program consumes, no full-width intermediate, no
// second pass. The cast loop reads the float bits through a uint32
// pointer (built with -fno-strict-aliasing) and keeps the NaN fixup
// as a branchless select so -O3 -march=native vectorizes it.
void gnot_pack_rows_bf16(const float** srcs, const int64_t* lens, int64_t n,
                         int64_t dim, int64_t max_len, uint16_t* out,
                         uint16_t* mask) {
  const int64_t row_bytes = dim * static_cast<int64_t>(sizeof(float));
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) total += lens[i] * row_bytes;
  for_samples(n, total, [&](int64_t i) {
    const int64_t len = lens[i];
    const uint32_t* src = reinterpret_cast<const uint32_t*>(srcs[i]);
    uint16_t* dst = out + i * max_len * dim;
    const int64_t elems = len * dim;
    // Mask-select form with no ternary at all: the JAX package's copy
    // picks the NaN pattern with `(x >> 31) ? 0xFFC0 : 0x7FC0`, which
    // g++ 12 leaves scalar; the sign moved into bit 15 and a 0/~0 mask
    // from the comparison give the same bits and vectorize.
    for (int64_t e = 0; e < elems; ++e) {
      const uint32_t x = src[e];
      const uint32_t lsb = (x >> 16) & 1u;
      const uint32_t rne = (x + 0x7FFFu + lsb) >> 16;
      const uint32_t nan_bits = 0x7FC0u | ((x >> 16) & 0x8000u);
      const uint32_t is_nan =
          0u - static_cast<uint32_t>((x & 0x7FFFFFFFu) > 0x7F800000u);
      dst[e] = static_cast<uint16_t>((is_nan & nan_bits) | (~is_nan & rne));
    }
    uint16_t* m = mask + i * max_len;
    for (int64_t r = 0; r < len; ++r) m[r] = 0x3F80u;  // 1.0 in bfloat16
  });
}

// Batched unpad/scatter: copy each sample's [len_i, dim] block out of a
// dense [R, row_len, dim] dispatch output into its own destination
// buffer, in one call. Byte-oriented so any element dtype works:
// sample i's block starts at src + rows[i]*row_bytes + offs[i]*tok_bytes
// and spans lens[i]*tok_bytes (tok_bytes = dim * itemsize). Covers the
// padded path (rows=i, offs=0) and the packed path ((row, offset)
// segment placements) with the same symbol.
void gnot_unpad_rows(const char* src, const int64_t* rows,
                     const int64_t* offs, const int64_t* lens, int64_t n,
                     int64_t row_bytes, int64_t tok_bytes, char** dsts) {
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) total += lens[i] * tok_bytes;
  for_samples(n, total, [&](int64_t i) {
    std::memcpy(dsts[i], src + rows[i] * row_bytes + offs[i] * tok_bytes,
                static_cast<size_t>(lens[i] * tok_bytes));
  });
}

}  // extern "C"
