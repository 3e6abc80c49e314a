// Batched conjugate-gradient solve for structured operators
//     A = diag(d) + sum_k band(o_k) + V V^T
// with the whole CG state and the operator data resident in shared memory.
//
// Replaces: xitorch_tpu/ops/structured_cg.py::_cg_kernel (the Pallas TPU
// kernel behind structured_cg_pallas).
//
// What bounds it on the H100: per CG step a system touches its
// (5 + 2*nb + r) * n floats several times (stencil, rank-r contraction,
// three axpys) and needs r + 2 block-wide reductions.  Kept in device
// memory this would stream ~45 KB per system per step at n=1024, nb=1,
// r=4, so the loop would be bound by HBM bandwidth; kept in shared memory
// it is bound by shared-memory bandwidth and by the latency of the
// block-wide synchronisations, which grows with the step count.
//
// Design: one thread block per system (a batch row times one right-hand
// side).  d, the band planes, V, x, r, p and A p live in dynamic shared
// memory for the whole solve, so device memory is read once at the start
// and x written once at the end.  Each step does the r products V^T p as
// one vector reduction, then A p and p.A p with one reduction, then the
// x/r update and r.r with one reduction: warp shuffles first, then one
// __syncthreads and a fixed-order sum of the per-warp partials, so every
// thread holds bit-identical scalars and the stop test is uniform across
// the block.  The stop rule is the reference's, decided per system: run
// while it < max_niter and r.r / stop^2 >= 0.25 (iterate to half the
// tolerance).  Neighbour indices are bounded instead of the reference's
// circular roll; the zero ends of the band planes are still honoured.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxRank = 16;
constexpr int kMaxBands = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum; every thread returns the same value.  `red` must not be
// reused before all threads have passed the next __syncthreads.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nwarps; ++w) s += red[w];
  return s;
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
structured_cg_kernel(const float* __restrict__ d_g,
                     const float* __restrict__ bl_g,
                     const float* __restrict__ bu_g,
                     const float* __restrict__ V_g,
                     const float* __restrict__ b_g,
                     const int* __restrict__ offs_g,
                     float* __restrict__ x_g,
                     float* __restrict__ it_g,
                     float* __restrict__ res_g,
                     int n, int nb, int r, int max_niter,
                     float rtol2, float atol2, float eps) {
  extern __shared__ float smem[];
  __shared__ float red_v[kMaxRank * 32];
  __shared__ float red_0[32];
  __shared__ float red_p[32];
  __shared__ float red_r[32];
  __shared__ int offs[kMaxBands];

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const size_t sys = blockIdx.x;

  float* d = smem;
  float* x = d + n;
  float* rv = x + n;
  float* p = rv + n;
  float* q = p + n;
  float* bl = q + n;
  float* bu = bl + (size_t)nb * n;
  float* V = bu + (size_t)nb * n;

  const float* dk = d_g + sys * n;
  const float* bk = b_g + sys * n;
  const float* blk = bl_g + sys * nb * n;
  const float* buk = bu_g + sys * nb * n;
  const float* Vk = V_g + sys * r * n;

  if (tid < nb) offs[tid] = offs_g[tid];
  float bb = 0.f;
  for (int i = tid; i < n; i += nthr) {
    const float bi = bk[i];
    d[i] = dk[i];
    x[i] = 0.f;
    rv[i] = bi;
    p[i] = bi;
    bb += bi * bi;
  }
  for (int i = tid; i < nb * n; i += nthr) {
    bl[i] = blk[i];
    bu[i] = buk[i];
  }
  for (int i = tid; i < r * n; i += nthr) V[i] = Vk[i];
  // the reduction's barrier also publishes every shared-memory load above
  float rr = block_sum(bb, red_0);
  const float stop2 = fmaxf(rtol2 * rr, atol2);

  int it = 0;
  while (it < max_niter && rr / stop2 >= 0.25f) {
    // V^T p: r sums in one reduction round
    float acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = 0.f;
    for (int i = tid; i < n; i += nthr) {
      const float pi = p[i];
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (j < r) acc[j] += V[j * n + i] * pi;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j < r) {
        const float v = warp_sum(acc[j]);
        if (lane == 0) red_v[j * 32 + warp] = v;
      }
    }
    __syncthreads();
    float vt[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float s = 0.f;
      if (j < r)
        for (int w = 0; w < nwarps; ++w) s += red_v[j * 32 + w];
      vt[j] = s;
    }

    // q = A p and p.q
    float pap = 0.f;
    for (int i = tid; i < n; i += nthr) {
      const float pi = p[i];
      float y = d[i] * pi;
      for (int k = 0; k < nb; ++k) {
        const int o = offs[k];
        if (i - o >= 0) y += bl[k * n + i] * p[i - o];
        if (i + o < n) y += bu[k * n + i] * p[i + o];
      }
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (j < r) y += V[j * n + i] * vt[j];
      q[i] = y;
      pap += pi * y;
    }
    const float pAp = block_sum(pap, red_p);
    const float alpha = rr / (pAp == 0.f ? eps : pAp);

    // x += alpha p, r -= alpha q, r.r  (each thread touches only its own
    // indices, so no barrier is needed before the reduction)
    float rrn = 0.f;
    for (int i = tid; i < n; i += nthr) {
      x[i] += alpha * p[i];
      const float ri = rv[i] - alpha * q[i];
      rv[i] = ri;
      rrn += ri * ri;
    }
    const float rr_new = block_sum(rrn, red_r);
    const float beta = rr_new / (rr == 0.f ? eps : rr);
    for (int i = tid; i < n; i += nthr) p[i] = rv[i] + beta * p[i];
    __syncthreads();  // the next stencil reads neighbours' p
    rr = rr_new;
    ++it;
  }

  float* xk = x_g + sys * n;
  for (int i = tid; i < n; i += nthr) xk[i] = x[i];
  if (tid == 0) {
    it_g[sys] = (float)it;
    res_g[sys] = sqrtf(rr);
  }
}

template <int R>
cudaError_t launch(const float* d, const float* bl, const float* bu,
                   const float* V, const float* b, const int* offs, float* x,
                   float* it, float* res, int K, int n, int nb, int r,
                   int max_niter, float rtol2, float atol2, float eps,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(5 + 2 * nb + r) * n * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      structured_cg_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  int threads = ((n + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  structured_cg_kernel<R><<<K, threads, smem, stream>>>(
      d, bl, bu, V, b, offs, x, it, res, n, nb, r, max_niter, rtol2, atol2,
      eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes.  All arrays are contiguous f32 on the device:
// d, b, x (K, n); bl, bu (K, nb, n); V (K, r, n); offs (nb,) int32;
// it, res (K,).  Returns a cudaError_t (0 on success).
extern "C" int structured_cg_f32(const float* d, const float* bl,
                                 const float* bu, const float* V,
                                 const float* b, const int* offs, float* x,
                                 float* it, float* res, int K, int n, int nb,
                                 int r, int max_niter, float rtol2,
                                 float atol2, float eps, void* stream) {
  if (K <= 0 || n <= 0 || nb < 1 || nb > kMaxBands || r < 1 || r > kMaxRank)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (r <= 1)
    e = launch<1>(d, bl, bu, V, b, offs, x, it, res, K, n, nb, r, max_niter,
                  rtol2, atol2, eps, s);
  else if (r <= 2)
    e = launch<2>(d, bl, bu, V, b, offs, x, it, res, K, n, nb, r, max_niter,
                  rtol2, atol2, eps, s);
  else if (r <= 4)
    e = launch<4>(d, bl, bu, V, b, offs, x, it, res, K, n, nb, r, max_niter,
                  rtol2, atol2, eps, s);
  else if (r <= 8)
    e = launch<8>(d, bl, bu, V, b, offs, x, it, res, K, n, nb, r, max_niter,
                  rtol2, atol2, eps, s);
  else
    e = launch<16>(d, bl, bu, V, b, offs, x, it, res, K, n, nb, r, max_niter,
                   rtol2, atol2, eps, s);
  return (int)e;
}
