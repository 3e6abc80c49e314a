// What the two divide-and-conquer kernels share (csrc/dc_kernel.cu, the
// single-shot warm start, and csrc/dc_level.cu, one level a launch): the
// block shape, the Newton-Schulz coefficients, one output tile of the
// register-tiled float32 product and the epilogues fused into it.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BM = 128, BN = 128, BK = 8;
constexpr int kPad = 4;  // As row padding: conflict-free transposed stores

// quintic Newton-Schulz coefficients (ops/spectral_dc.py::_QUINTIC)
constexpr float kQa = 3.4445f, kQb = -4.7750f, kQc = 2.0315f;

// the k tiles of one product, staged through shared memory
struct Tiles {
  alignas(16) float As[BK][BM + kPad];  // read back as float4
  alignas(16) float Bs[BK][BN];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- epilogues: value stored at (i, j) for the accumulated product ----
struct EpiStore {
  __device__ float operator()(int, int, float acc) const { return acc; }
};
// qa I + qb X2 + qc (X2 X2)
struct EpiQuinticW {
  const float* X2;
  int n;
  __device__ float operator()(int i, int j, float acc) const {
    return (i == j ? kQa : 0.0f) + kQb * X2[(size_t)i * n + j] + kQc * acc;
  }
};
// 1.5 X - 0.5 (X X2)
struct EpiCubic {
  const float* X;
  int n;
  __device__ float operator()(int i, int j, float acc) const {
    return 1.5f * X[(size_t)i * n + j] - 0.5f * acc;
  }
};

// The (bm, bn) output tile, BM x BN, of C = op(A) B on row-major (n, n)
// planes in device memory, op = transpose when TA; C is neither A nor B;
// the sum runs over k in [k_lo, k_hi) (0 <= k_lo < k_hi <= n), so a caller
// whose operands are zero outside that range skips the rest exactly.
// 256 threads, 8 x 8 outputs a thread, 8-deep k tiles staged through
// registers, every accumulation an IEEE float32 multiply-add (no TF32).
// Every thread of the block calls it; the shared tiles are free again on
// return (the last k step ends on a barrier), but C is not yet visible to
// the other threads of the block.
template <bool TA, class Epi>
__device__ __forceinline__ void gemm_tile(const float* A, const float* B, float* C,
                                          int n, int bm, int bn, Epi epi, Tiles& s,
                                          int k_lo, int k_hi) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // global -> register staging: this thread's four A and four B values
  const int la_k = TA ? (tid >> 5) : ((tid & 1) << 2);
  const int la_i = TA ? ((tid & 31) << 2) : (tid >> 1);
  const int lb_k = tid >> 5, lb_j = (tid & 31) << 2;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float ra[4], rb[4];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (TA) {
        const int k = k0 + la_k, i = bm + la_i + q;
        ra[q] = (k < k_hi && i < n) ? A[(size_t)k * n + i] : 0.0f;
      } else {
        const int i = bm + la_i, k = k0 + la_k + q;
        ra[q] = (i < n && k < k_hi) ? A[(size_t)i * n + k] : 0.0f;
      }
      const int k = k0 + lb_k, j = bn + lb_j + q;
      rb[q] = (k < k_hi && j < n) ? B[(size_t)k * n + j] : 0.0f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (TA)
        s.As[la_k][la_i + q] = ra[q];
      else
        s.As[la_k + q][la_i] = ra[q];
      s.Bs[lb_k][lb_j + q] = rb[q];
    }
  };

  fetch(k_lo);
  stage();
  __syncthreads();
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    const bool more = k0 + BK < k_hi;
    if (more) fetch(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s.As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // every thread is done with this k tile
    if (more) {
      stage();
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = bm + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = bn + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < n) C[(size_t)row * n + col] = epi(row, col, acc[i][j]);
    }
  }
}

// the dense product: k over all of n
template <bool TA, class Epi>
__device__ __forceinline__ void gemm_tile(const float* A, const float* B, float* C,
                                          int n, int bm, int bn, Epi epi, Tiles& s) {
  gemm_tile<TA>(A, B, C, n, bm, bn, epi, s, 0, n);
}

}  // namespace
