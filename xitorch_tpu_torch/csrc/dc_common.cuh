// What the two divide-and-conquer kernels share (csrc/dc_kernel.cu, the
// single-shot warm start, and csrc/dc_level.cu, one level a launch): the
// Newton-Schulz coefficients, one output tile of the register-tiled float32
// product, whose width is a parameter (128 for the per-level kernel, 32 for
// the single-shot one), and the epilogues fused into it.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BM = 128, BN = 128, BK = 8;  // the per-level kernel's tile
constexpr int kPad = 4;  // As row padding: conflict-free transposed stores

// quintic Newton-Schulz coefficients (ops/spectral_dc.py::_QUINTIC)
constexpr float kQa = 3.4445f, kQb = -4.7750f, kQc = 2.0315f;

// the k tiles of one product with TM x TM output tiles, staged through
// shared memory; kR x kR outputs a thread (8 at TM = 128, 4 at TM = 32),
// so (TM / kR)^2 threads: 256 and 64
template <int TM>
struct TileSmem {
  static_assert(TM == 32 || TM == 128, "the tile is 32 or 128 wide");
  static constexpr int kR = TM == 32 ? 4 : 8;
  static constexpr int kThreads = (TM / kR) * (TM / kR);
  alignas(16) float As[BK][TM + kPad];  // read back as float4
  alignas(16) float Bs[BK][TM];
};
using Tiles = TileSmem<BM>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- epilogues: value stored at (i, j) for the accumulated product ----
// The multiply-adds are written out (fmaf, __fmul_rn), so that no
// instantiation of a product kernel leaves the choice of contraction to the
// compiler (it chose these where the expressions were written plainly).
__device__ __forceinline__ float quintic_w(int i, int j, float x2, float acc) {
  return fmaf(kQc, acc, fmaf(kQb, x2, i == j ? kQa : 0.0f));
}
__device__ __forceinline__ float cubic(float x, float acc) {
  return fmaf(1.5f, x, __fmul_rn(-0.5f, acc));  // 0.5 acc is exact
}

struct EpiStore {
  __device__ float operator()(int, int, float acc) const { return acc; }
};
// qa I + qb X2 + qc (X2 X2)
struct EpiQuinticW {
  const float* X2;
  int n;
  __device__ float operator()(int i, int j, float acc) const {
    return quintic_w(i, j, X2[(size_t)i * n + j], acc);
  }
};
// 1.5 X - 0.5 (X X2)
struct EpiCubic {
  const float* X;
  int n;
  __device__ float operator()(int i, int j, float acc) const {
    return cubic(X[(size_t)i * n + j], acc);
  }
};

// The (bm, bn) output tile, TM x TM, of C = op(A) B on row-major (n, n)
// planes in device memory, op = transpose when TA; C is neither A nor B;
// the sum runs over k in [k_lo, k_hi) (0 <= k_lo < k_hi <= n), so a caller
// whose operands are zero outside that range skips the rest exactly.
// TileSmem<TM>::kThreads threads, kR x kR outputs a thread (two 4 x 4
// quadrants at TM = 128), 8-deep k tiles staged through registers, every
// accumulation an IEEE float32 multiply-add (no TF32) in the order of k,
// whatever TM is.
// kVec (n a multiple of 4 only): the k tiles start at k_lo rounded down to
// a multiple of 8 and are staged as 16-byte loads, entries outside
// [k_lo, k_hi) set to zero, which adds exact zeros only; otherwise each
// thread stages single floats.
// Every thread of the block calls it; the shared tiles are free again on
// return (the last k step ends on a barrier), but C is not yet visible to
// the other threads of the block.
template <bool TA, bool kVec = false, int TM, class Epi>
__device__ __forceinline__ void gemm_tile(const float* A, const float* B, float* C,
                                          int n, int bm, int bn, Epi epi,
                                          TileSmem<TM>& s, int k_lo, int k_hi) {
  constexpr int kR = TileSmem<TM>::kR;  // outputs a thread along a side
  constexpr int kT = TM / kR;           // threads along a side of the tile
  constexpr int kN = kT * kT;           // threads
  constexpr int kL = BK * TM / kN;      // A (and B) values a thread stages
  static_assert(kL == 4, "a thread stages one 16-byte chunk of A and of B");
  constexpr int kH = TM / 2;            // a thread's second half of rows / columns
  // (unsigned: the divisions by powers of two are shifts and masks)
  const unsigned u = threadIdx.x;
  const int tx = (int)(u % kT), ty = (int)(u / kT);
  // global -> register staging: this thread's kL A and kL B values
  const int la_k = (int)(TA ? u / (TM / kL) : (u % (BK / kL)) * kL);
  const int la_i = (int)(TA ? (u % (TM / kL)) * kL : u / (BK / kL));
  const int lb_k = (int)(u / (TM / kL)), lb_j = (int)((u % (TM / kL)) * kL);

  float acc[kR][kR];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[i][j] = 0.0f;
  float ra[kL], rb[kL];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kL; ++q) {
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
    for (int q = 0; q < kL; ++q) {
      if (TA)
        s.As[la_k][la_i + q] = ra[q];
      else
        s.As[la_k + q][la_i] = ra[q];
      s.Bs[lb_k][lb_j + q] = rb[q];
    }
  };

  // 16-byte staging, one chunk of A and one of B a thread (c the thread).
  // B and A^T: k tile row c / (TM / 4), columns 4 (c % (TM / 4)) + 0..3;
  // A: row c / 2 of the tile, k 4 (c % 2) + 0..3 (32 contiguous bytes a row)
  const int c = (int)u;
  float4 va, vb;
  auto load4 = [&](const float* X, int k, int col) {
    return (k >= k_lo && k < k_hi && col < n)
               ? *reinterpret_cast<const float4*>(X + (size_t)k * n + col)
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  auto fetch4 = [&](int k0) {
    const int k = k0 + c / (TM / 4), col = 4 * (c % (TM / 4));
    vb = load4(B, k, bn + col);
    if (TA) {
      va = load4(A, k, bm + col);
    } else {
      const int i = bm + c / 2, kk = k0 + 4 * (c % 2);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < n && kk < n) v = *reinterpret_cast<const float4*>(A + (size_t)i * n + kk);
      v.x = (kk >= k_lo && kk < k_hi) ? v.x : 0.0f;
      v.y = (kk + 1 >= k_lo && kk + 1 < k_hi) ? v.y : 0.0f;
      v.z = (kk + 2 >= k_lo && kk + 2 < k_hi) ? v.z : 0.0f;
      v.w = (kk + 3 >= k_lo && kk + 3 < k_hi) ? v.w : 0.0f;
      va = v;
    }
  };
  auto stage4 = [&]() {
    const int k = c / (TM / 4), col = 4 * (c % (TM / 4));
    *reinterpret_cast<float4*>(&s.Bs[k][col]) = vb;
    if (TA) {
      *reinterpret_cast<float4*>(&s.As[k][col]) = va;
    } else {
      const int i = c / 2, kh = 4 * (c % 2);
      s.As[kh][i] = va.x;
      s.As[kh + 1][i] = va.y;
      s.As[kh + 2][i] = va.z;
      s.As[kh + 3][i] = va.w;
    }
  };

  const int k_start = kVec ? (k_lo & ~(BK - 1)) : k_lo;
  if constexpr (kVec) {
    fetch4(k_start);
    stage4();
  } else {
    fetch(k_start);
    stage();
  }
  __syncthreads();
  for (int k0 = k_start; k0 < k_hi; k0 += BK) {
    const bool more = k0 + BK < k_hi;
    if (more) {
      if constexpr (kVec)
        fetch4(k0 + BK);
      else
        fetch(k0 + BK);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      if constexpr (kR == 8) {
        const float4 a0 = *reinterpret_cast<const float4*>(&s.As[k][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&s.As[k][kH + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&s.Bs[k][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&s.Bs[k][kH + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      } else {
        const float4 a0 = *reinterpret_cast<const float4*>(&s.As[k][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&s.Bs[k][tx * 4]);
        const float a[4] = {a0.x, a0.y, a0.z, a0.w};
        const float b[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // every thread is done with this k tile
    if (more) {
      if constexpr (kVec)
        stage4();
      else
        stage();
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = bm + (i < 4 ? ty * 4 + i : kH + ty * 4 + i - 4);
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int col = bn + (j < 4 ? tx * 4 + j : kH + tx * 4 + j - 4);
      if (col < n) C[(size_t)row * n + col] = epi(row, col, acc[i][j]);
    }
  }
}

}  // namespace
