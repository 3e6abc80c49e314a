// The TF32 tensor-core tile of the per-level divide-and-conquer kernel
// (csrc/dc_level.cu): one BM x BN output tile of C = op(A) B, for the
// products the reference runs at default precision.
//
// 256 threads, 8 warps of 64 x 32 outputs each (4 x 4 tiles of
// mma.sync.m16n8k8 with TF32 operands and float32 accumulation).  The k loop
// runs in 32-deep stages through a ring of three shared-memory buffers
// filled by cp.async (16-byte chunks where n is a multiple of 4, single
// floats otherwise), so the copies of stages k + 1 and k + 2 overlap the
// products of stage k.  Each operand is rounded to TF32 by cvt.rna (to
// nearest, ties away from zero) as it leaves shared memory; zeros stay
// exact zeros.  Rows and columns past n are filled with zeros.
//
// Shared layout, strides padded so that each fragment load of a warp hits 32
// banks: A as stored [m][k] (kSA = 36 floats a row), or [k][m] for the
// transposed operand (kSAT = 136); B [k][n] (kSB = 136).  Three stages take
// 107,520 bytes of dynamic shared memory, two blocks an SM.
#pragma once
#include <stdint.h>

#include "dc_common.cuh"

namespace {

constexpr int TBK = 32;           // k depth of a stage
constexpr int kStages = 3;        // cp.async ring
constexpr int kSA = TBK + 4;      // row stride of A stored [m][k]
constexpr int kSAT = BM + 8;      // row stride of A stored [k][m] (transposed)
constexpr int kSB = BN + 8;       // row stride of B stored [k][n]
constexpr int kStageA = BM * kSA;  // floats; the larger of the two A layouts
constexpr int kStageFloats = kStageA + TBK * kSB;
constexpr int kTf32Smem = kStages * kStageFloats * (int)sizeof(float);
static_assert(BM * kSA >= TBK * kSAT, "the stage must hold either A layout");
static_assert(BM == 128 && BN == 128 && kThreads == 256, "the warp layout below");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage the k-rows [k0, k0 + TBK) of op(A)'s band bm and of B's band bn.
// Invalid sources are replaced by the plane's base (never read: 0 bytes).
template <bool TA, bool V16>
__device__ __forceinline__ void tf32_stage(const float* A, const float* B, float* sA,
                                           float* sB, int n, int bm, int bn, int k0) {
  const int tid = threadIdx.x;
  if (V16) {
    // 1,024 chunks of 4 floats an operand, 4 a thread
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = tid + q * kThreads;
      if (TA) {
        const int kr = c >> 5, mc = (c & 31) << 2, k = k0 + kr, m = bm + mc;
        const bool ok = k < n && m < n;
        cp_async16(sA + kr * kSAT + mc, ok ? A + (size_t)k * n + m : A, ok);
      } else {
        const int mr = c >> 3, kc = (c & 7) << 2, m = bm + mr, k = k0 + kc;
        const bool ok = m < n && k < n;
        cp_async16(sA + mr * kSA + kc, ok ? A + (size_t)m * n + k : A, ok);
      }
      const int kr = c >> 5, nc = (c & 31) << 2, k = k0 + kr, j = bn + nc;
      const bool ok = k < n && j < n;
      cp_async16(sB + kr * kSB + nc, ok ? B + (size_t)k * n + j : B, ok);
    }
  } else {
    // rows not 16-byte aligned: 4,096 single floats an operand, 16 a thread
#pragma unroll 4
    for (int q = 0; q < 16; ++q) {
      const int c = tid + q * kThreads;
      if (TA) {
        const int kr = c >> 7, mc = c & 127, k = k0 + kr, m = bm + mc;
        const bool ok = k < n && m < n;
        cp_async4(sA + kr * kSAT + mc, ok ? A + (size_t)k * n + m : A, ok);
      } else {
        const int mr = c >> 5, kc = c & 31, m = bm + mr, k = k0 + kc;
        const bool ok = m < n && k < n;
        cp_async4(sA + mr * kSA + kc, ok ? A + (size_t)m * n + k : A, ok);
      }
      const int kr = c >> 7, nc = c & 127, k = k0 + kr, j = bn + nc;
      const bool ok = k < n && j < n;
      cp_async4(sB + kr * kSB + nc, ok ? B + (size_t)k * n + j : B, ok);
    }
  }
}

// The (bm, bn) output tile of C = op(A) B (op = transpose when TA) on
// row-major (n, n) planes, C neither A nor B, summed over the 32-deep k
// stages that cover [k_lo, k_hi) (0 <= k_lo < k_hi <= n; the stages start
// at a multiple of 32, so a caller whose operands are zero outside the
// range gets the product over the range exactly), each stored as
// epi(i, j, acc).  V16: n is a multiple of 4.  smem: kTf32Smem bytes of
// dynamic shared memory, 16-byte aligned.
template <bool TA, bool V16, class Epi>
__device__ __forceinline__ void tf32_tile(const float* A, const float* B, float* C, int n,
                                          int bm, int bn, Epi epi, float* smem, int k_lo,
                                          int k_hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int k_beg = k_lo & ~(TBK - 1);
  const int nk = (k_hi - k_beg + TBK - 1) / TBK;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk)
      tf32_stage<TA, V16>(A, B, smem + st * kStageFloats, smem + st * kStageFloats + kStageA,
                          n, bm, bn, k_beg + st * TBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();               // and every warp is done with stage kt - 1
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      float* s = smem + (nxt % kStages) * kStageFloats;
      tf32_stage<TA, V16>(A, B, s, s + kStageA, n, bm, bn, k_beg + nxt * TBK);
    }
    cp_async_commit();
    const float* a_s = smem + (kt % kStages) * kStageFloats;
    const float* b_s = a_s + kStageA;
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 8) {
      uint32_t bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn + nt * 8 + g;
        bf[nt][0] = to_tf32(b_s[(kk + t) * kSB + col]);
        bf[nt][1] = to_tf32(b_s[(kk + t + 4) * kSB + col]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = wm + mt * 16 + g;
        uint32_t af[4];
        if (TA) {
          af[0] = to_tf32(a_s[(kk + t) * kSAT + row]);
          af[1] = to_tf32(a_s[(kk + t) * kSAT + row + 8]);
          af[2] = to_tf32(a_s[(kk + t + 4) * kSAT + row]);
          af[3] = to_tf32(a_s[(kk + t + 4) * kSAT + row + 8]);
        } else {
          af[0] = to_tf32(a_s[row * kSA + kk + t]);
          af[1] = to_tf32(a_s[(row + 8) * kSA + kk + t]);
          af[2] = to_tf32(a_s[row * kSA + kk + t + 4]);
          af[3] = to_tf32(a_s[(row + 8) * kSA + kk + t + 4]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], af, bf[nt]);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups can remain

  // accumulator (mt, nt, e): row g (+8 for e >= 2), column 2t (+1 for odd e)
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = bm + wm + mt * 16 + g + (e >> 1) * 8;
        const int j = bn + wn + nt * 8 + 2 * t + (e & 1);
        if (i < n && j < n) C[(size_t)i * n + j] = epi(i, j, acc[mt][nt][e]);
      }
}

}  // namespace
