// What the real and the complex one-sided Jacobi sweep kernels share
// (csrc/jacobi_sweep.cu, csrc/jacobi_sweep_complex.cu): the block shape, the
// warp reduction, the rotation and the ring tournament.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 1024;             // rows of a panel (static norm array)
constexpr int kUnroll = 6;              // a sweep is ceil((n-1)/6)*6 rounds
constexpr float kEpsFloor = 16.0f * 1.17549435e-38f;  // 16 * FLT_MIN

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(const float4& x, const float4& y) {
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}

// The rotation p <- c p - s q, q <- s p + c q in the form
// p - s (q + tau p), q + s (p - tau q) with tau = s / (1 + c) = (1 - c) / s:
// the same rotation, but 1 - c is never formed by rounding c.  For the
// many small rotations of the late sweeps c rounds to exactly 1 in float32,
// and applying c and s as they are then stretches every such pair by
// 1 + t^2/2, always upwards: G^T G drifted by 5e-5 relative at n = 256
// (measured), against 1e-6 in this form.
__device__ __forceinline__ void rot4(const float4& x, const float4& y, float s,
                                     float tau, float4& np, float4& nq) {
  np = make_float4(x.x - s * (y.x + tau * x.x), x.y - s * (y.y + tau * x.y),
                   x.z - s * (y.z + tau * x.z), x.w - s * (y.w + tau * x.w));
  nq = make_float4(y.x + s * (x.x - tau * y.x), y.y + s * (x.y - tau * y.y),
                   y.z + s * (x.z - tau * y.z), y.w + s * (x.w - tau * y.w));
}

// The tournament as a ring.  Seats: top_0 is fixed; the other n-1 seats
// form the cycle top_1 .. top_{h-1}, bot_{h-1} .. bot_0, and every round
// each player moves one seat along it.  ring_player(k) is the row that
// starts in ring seat k (top_i starts with row i, bot_i with row h + i).
__device__ __forceinline__ int ring_player(int k, int h, int n) {
  return k <= h - 2 ? k + 1 : h + n - 2 - k;
}

// seat x of the ring after `shift` rounds holds the starter of seat x - shift
__device__ __forceinline__ int ring_at(int x, int shift, int m) {
  const int k = x - shift;
  return k < 0 ? k + m : k;
}

}  // namespace
