// What the real and the complex one-sided Jacobi sweep kernels share
// (csrc/jacobi_sweep.cu, csrc/jacobi_sweep_complex.cu): the block shape, the
// warp reduction, the rotation and the ring tournament; and of their cluster
// paths the rank-ordered sums through distributed shared memory, the column
// slice and the threads a pair.  The cluster machinery they share with the
// fused CG kernel (rank, cluster barrier, mbarriers, words pushed into other
// CTAs with st.async, the launch configuration, the kernel attributes and
// the occupancy query) is in cluster_common.cuh.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "cluster_common.cuh"

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

// the rows of pair i (top_i, bot_i) after `shift` rounds
__device__ __forceinline__ int pair_top(int i, int shift, int h, int n, int m) {
  return i == 0 ? 0 : ring_player(ring_at(i - 1, shift, m), h, n);
}
__device__ __forceinline__ int pair_bot(int i, int shift, int h, int n, int m) {
  return ring_player(ring_at(n - 2 - i, shift, m), h, n);
}

// ---- thread-block clusters (sm_90): one matrix split over C CTAs ----
//
// Every CTA of a cluster holds all rows of a slice of the columns in its
// own shared memory; a sum over the whole row is the CTAs' partial sums
// read through distributed shared memory and added in rank order
// 0 .. C-1, so that every CTA forms the same value bit for bit.

// the word at `p` (this CTA's shared memory) in CTA `rank` of the cluster
__device__ __forceinline__ float cluster_load(const float* p, unsigned rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned ra;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(ra));
  return v;
}

// sum over the cluster's C CTAs of the word at `p`, in rank order (all
// loads issued before the first add)
template <int C>
__device__ __forceinline__ float cluster_sum(const float* p) {
  float v[C];
#pragma unroll
  for (int r = 0; r < C; ++r) v[r] = cluster_load(p, r);
  float s = v[0];
#pragma unroll
  for (int r = 1; r < C; ++r) s += v[r];
  return s;
}

template <int C>
__device__ __forceinline__ float cluster_max(const float* p) {
  float m = cluster_load(p, 0);
#pragma unroll
  for (int r = 1; r < C; ++r) m = fmaxf(m, cluster_load(p, r));
  return m;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A slice: the ceil(w4 / C) float4 columns a CTA holds of each row, stored
// at an odd row stride (in float4) so that the same column of 8 consecutive
// rows falls in 8 different 16-byte bank groups
__host__ __device__ __forceinline__ int slice_w4(int w4, int C) {
  return (w4 + C - 1) / C;
}
__host__ __device__ __forceinline__ int slice_stride(int s4) { return s4 | 1; }

// Threads a pair in the vector work of a round: 8, so that 8 threads read
// 128 contiguous bytes of a row (one conflict-free access), or fewer where
// the slice row is shorter
__host__ __device__ __forceinline__ int pair_threads(int s4) {
  int tpp = 8;
  while (tpp > 1 && tpp >= 2 * s4) tpp >>= 1;
  return tpp;
}

}  // namespace
