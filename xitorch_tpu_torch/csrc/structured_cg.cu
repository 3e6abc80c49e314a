// Batched conjugate-gradient solve for structured operators
//     A = diag(d) + sum_k band(o_k) + V V^T
// with the whole CG state and the operator data of a system on chip.
//
// Replaces: xitorch_tpu/ops/structured_cg.py::_cg_kernel (the Pallas TPU
// kernel behind structured_cg_pallas).
//
// What bounds it on the H100: device memory is read once (d, the band
// planes, V and b: 23 MB at config 3, 7 us at 3.35 TB/s) and x written
// once; a CG step touches each system's (5 + 2*nb + r) * n values a few
// times and needs r + 2 sums over the system.  On chip, a step is bound by
// the latency of its block-wide reductions and barriers, not by bytes.
//
// Two designs, one thread block a system (a batch row times one
// right-hand side), the same loop and stop rule:
//   * the register design (structured_cg_reg_kernel, below): each thread
//     holds 8 consecutive elements of every plane in registers, two block
//     barriers a step; it takes nb <= 2 bands of offset <= 8, rank <= 8,
//     and n up to 8 x the threads a block of it may have (the register
//     window; ops/structured_cg.py::register_window);
//   * the shared-memory design (structured_cg_kernel): every plane in
//     dynamic shared memory, strided over the threads, four barriers a
//     step; the path for the shapes outside the register window (more
//     bands, larger offsets, rank up to 16, larger n while the planes fit).
// Each step does the r products V^T p and p.(A p) as block reductions and
// then r.r: warp shuffles first, then a barrier and a fixed-order sum of
// the per-warp partials, so every thread holds bit-identical scalars and
// the stop test is uniform across the block.  The stop rule is the
// reference's, decided per system: run while it < max_niter and
// r.r / stop^2 >= 0.25 (iterate to half the tolerance).  Neighbour indices
// are bounded instead of the reference's circular roll; the zero ends of
// the band planes are still honoured.  The band offsets travel by value.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxRank = 16;
constexpr int kMaxBands = 8;
constexpr int kMaxDevices = 64;

// the band offsets, passed by value as a kernel parameter (no copy to the
// device before a launch)
struct Offsets {
  int o[kMaxBands];
};

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
                     const Offsets offs,
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
        const int o = offs.o[k];
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

// Once per instantiation and device: let the kernel take as much dynamic
// shared memory as the card allows a block beside its static scratch.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)fa.sharedSizeBytes);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

template <int R>
cudaError_t launch(const float* d, const float* bl, const float* bu,
                   const float* V, const float* b, const Offsets& offs, float* x,
                   float* it, float* res, int K, int n, int nb, int r,
                   int max_niter, float rtol2, float atol2, float eps,
                   cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const size_t smem = (size_t)(5 + 2 * nb + r) * n * sizeof(float);
  cudaError_t e = allow_smem(structured_cg_kernel<R>, done);
  if (e != cudaSuccess) return e;
  int threads = ((n + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  structured_cg_kernel<R><<<K, threads, smem, stream>>>(
      d, bl, bu, V, b, offs, x, it, res, n, nb, r, max_niter, rtol2, atol2,
      eps);
  return cudaGetLastError();
}

// ---- the register design ----
//
// A block of ceil(n / 8) threads (rounded up to warps) a system; thread t
// holds the 8 consecutive elements [8 t, 8 t + 8) of d, the band planes,
// V's planes (zero past rank r), x, r and p in registers for the whole
// solve.  A band's neighbour p[i -/+ o] (o <= 8) comes from the thread
// itself, from its lane neighbour by shuffle, or, at a warp's edge, from a
// halo in shared memory that only the edge lane keeps: p's halo is formed
// locally as r_halo + beta * p_halo, the same FMA the owner applies to its
// own p, so the copy stays bit-identical to the owner's value.  Two block
// barriers a step: one reduction round of the r + 1 sums V^T p and
// p.(D p + B p), from which p.A p = p.(D p + B p) + sum_j (v_j . p)^2; then
// r.r, with r's edge elements published at the same barrier.  Partials are
// combined in one fixed order, so every thread holds bit-identical scalars
// and the stop is uniform.
constexpr int kE = 8;            // consecutive elements a thread
constexpr int kRegMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load_row(const float* __restrict__ g, int e0, int n, bool vec,
                                         float (&v)[kE]) {
  if (vec && e0 + kE <= n) {
    const float4 a = *reinterpret_cast<const float4*>(g + e0);
    const float4 b = *reinterpret_cast<const float4*>(g + e0 + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kE; ++j) v[j] = e0 + j < n ? g[e0 + j] : 0.f;
  }
}

// q += bl * p[i - O] + bu * p[i + O] for the thread's elements; lo_halo and
// hi_halo are the edge lanes' halos (the kE elements before the warp's
// first element, and after its last)
template <int O>
__device__ __forceinline__ void band_term(const float (&p)[kE], const float (&bl)[kE],
                                          const float (&bu)[kE], float (&q)[kE], int lane,
                                          const float* lo_halo, const float* hi_halo) {
  float lo[O], hi[O];
#pragma unroll
  for (int t = 0; t < O; ++t) {
    lo[t] = __shfl_up_sync(kFull, p[kE - O + t], 1);
    hi[t] = __shfl_down_sync(kFull, p[t], 1);
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < O; ++t) lo[t] = lo_halo[kE - O + t];
  }
  if (lane == 31) {
#pragma unroll
    for (int t = 0; t < O; ++t) hi[t] = hi_halo[t];
  }
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const float pl = j >= O ? p[j >= O ? j - O : 0] : lo[j < O ? j : 0];
    const float pu = j + O < kE ? p[j + O < kE ? j + O : 0] : hi[j + O >= kE ? j + O - kE : 0];
    q[j] = fmaf(bl[j], pl, q[j]);
    q[j] = fmaf(bu[j], pu, q[j]);
  }
}

// the band term for a runtime offset o in [1, kE] (uniform over the block)
__device__ __forceinline__ void band_any(int o, const float (&p)[kE], const float (&bl)[kE],
                                         const float (&bu)[kE], float (&q)[kE], int lane,
                                         const float* lo_halo, const float* hi_halo) {
  switch (o) {
    case 1: band_term<1>(p, bl, bu, q, lane, lo_halo, hi_halo); break;
    case 2: band_term<2>(p, bl, bu, q, lane, lo_halo, hi_halo); break;
    case 3: band_term<3>(p, bl, bu, q, lane, lo_halo, hi_halo); break;
    case 4: band_term<4>(p, bl, bu, q, lane, lo_halo, hi_halo); break;
    case 5: band_term<5>(p, bl, bu, q, lane, lo_halo, hi_halo); break;
    case 6: band_term<6>(p, bl, bu, q, lane, lo_halo, hi_halo); break;
    case 7: band_term<7>(p, bl, bu, q, lane, lo_halo, hi_halo); break;
    default: band_term<8>(p, bl, bu, q, lane, lo_halo, hi_halo); break;
  }
}

template <int R, int NB>
__global__ void structured_cg_reg_kernel(const float* __restrict__ d_g,
                                         const float* __restrict__ bl_g,
                                         const float* __restrict__ bu_g,
                                         const float* __restrict__ V_g,
                                         const float* __restrict__ b_g, const Offsets offs,
                                         float* __restrict__ x_g, float* __restrict__ it_g,
                                         float* __restrict__ res_g, int n, int r,
                                         int max_niter, float rtol2, float atol2, float eps) {
  __shared__ float red1[kRegMaxWarps * (R + 1)];
  __shared__ float red2[kRegMaxWarps];
  __shared__ float r_first[kRegMaxWarps * kE];  // r of each warp's first kE elements
  __shared__ float r_last[kRegMaxWarps * kE];   // and of its last kE
  __shared__ float p_lo[kRegMaxWarps * kE];     // lane 0's halo: p before the warp
  __shared__ float p_hi[kRegMaxWarps * kE];     // lane 31's halo: p after the warp

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t sys = blockIdx.x;
  const int e0 = tid * kE;
  const bool vec = (n & 3) == 0;

  float d[kE], bl[NB][kE], bu[NB][kE], V[R][kE], x[kE], rv[kE], p[kE];
  load_row(d_g + sys * n, e0, n, vec, d);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    load_row(bl_g + (sys * NB + k) * n, e0, n, vec, bl[k]);
    load_row(bu_g + (sys * NB + k) * n, e0, n, vec, bu[k]);
  }
#pragma unroll
  for (int m = 0; m < R; ++m) {
    if (m < r) {
      load_row(V_g + (sys * r + m) * n, e0, n, vec, V[m]);
    } else {
#pragma unroll
      for (int j = 0; j < kE; ++j) V[m][j] = 0.f;
    }
  }
  const float* bk = b_g + sys * n;
  load_row(bk, e0, n, vec, rv);
  float bb = 0.f;
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    x[j] = 0.f;
    p[j] = rv[j];
    bb = fmaf(rv[j], rv[j], bb);
  }
  // p = b at start: the edge lanes' halos from b
  float* lo_halo = p_lo + warp * kE;
  float* hi_halo = p_hi + warp * kE;
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < kE; ++t) {
      const int e = e0 - kE + t;
      lo_halo[t] = e >= 0 ? bk[e] : 0.f;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int t = 0; t < kE; ++t) {
      const int e = e0 + kE + t;
      hi_halo[t] = e < n ? bk[e] : 0.f;
    }
  }
  bb = warp_sum(bb);
  if (lane == 0) red2[warp] = bb;
  __syncthreads();
  float rr = 0.f;
  for (int w = 0; w < nwarps; ++w) rr += red2[w];
  const float stop2 = fmaxf(rtol2 * rr, atol2);

  int it = 0;
  while (it < max_niter && rr / stop2 >= 0.25f) {
    // q = D p + B p; the r + 1 sums V^T p and p.q in one round
    float q[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j) q[j] = d[j] * p[j];
#pragma unroll
    for (int k = 0; k < NB; ++k) band_any(offs.o[k], p, bl[k], bu[k], q, lane, lo_halo, hi_halo);
    float part[R + 1];
    part[R] = 0.f;
#pragma unroll
    for (int m = 0; m < R; ++m) part[m] = 0.f;
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      part[R] = fmaf(p[j], q[j], part[R]);
#pragma unroll
      for (int m = 0; m < R; ++m) part[m] = fmaf(V[m][j], p[j], part[m]);
    }
#pragma unroll
    for (int m = 0; m <= R; ++m) part[m] = warp_sum(part[m]);
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m <= R; ++m) red1[warp * (R + 1) + m] = part[m];
    }
    __syncthreads();
    float vt[R], pq = 0.f;
#pragma unroll
    for (int m = 0; m < R; ++m) vt[m] = 0.f;
    for (int w = 0; w < nwarps; ++w) {
#pragma unroll
      for (int m = 0; m < R; ++m) vt[m] += red1[w * (R + 1) + m];
      pq += red1[w * (R + 1) + R];
    }
    float pAp = pq;
#pragma unroll
    for (int m = 0; m < R; ++m) pAp = fmaf(vt[m], vt[m], pAp);
    const float alpha = rr / (pAp == 0.f ? eps : pAp);

    // A p = q + V vt; x += alpha p, r -= alpha A p, r.r
    float rrn = 0.f;
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      float ap = q[j];
#pragma unroll
      for (int m = 0; m < R; ++m) ap = fmaf(V[m][j], vt[m], ap);
      x[j] = fmaf(alpha, p[j], x[j]);
      rv[j] = fmaf(-alpha, ap, rv[j]);
      rrn = fmaf(rv[j], rv[j], rrn);
    }
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < kE; ++t) r_first[warp * kE + t] = rv[t];
    }
    if (lane == 31) {
#pragma unroll
      for (int t = 0; t < kE; ++t) r_last[warp * kE + t] = rv[t];
    }
    rrn = warp_sum(rrn);
    if (lane == 0) red2[warp] = rrn;
    __syncthreads();
    float rr_new = 0.f;
    for (int w = 0; w < nwarps; ++w) rr_new += red2[w];
    const float beta = rr_new / (rr == 0.f ? eps : rr);
#pragma unroll
    for (int j = 0; j < kE; ++j) p[j] = fmaf(beta, p[j], rv[j]);
    if (lane == 0 && warp > 0) {
#pragma unroll
      for (int t = 0; t < kE; ++t)
        lo_halo[t] = fmaf(beta, lo_halo[t], r_last[(warp - 1) * kE + t]);
    }
    if (lane == 31 && warp < nwarps - 1) {
#pragma unroll
      for (int t = 0; t < kE; ++t)
        hi_halo[t] = fmaf(beta, hi_halo[t], r_first[(warp + 1) * kE + t]);
    }
    rr = rr_new;
    ++it;
  }

  float* xk = x_g + sys * n;
  if (vec && e0 + kE <= n) {
    *reinterpret_cast<float4*>(xk + e0) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(xk + e0 + 4) = make_float4(x[4], x[5], x[6], x[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kE; ++j)
      if (e0 + j < n) xk[e0 + j] = x[j];
  }
  if (tid == 0) {
    it_g[sys] = (float)it;
    res_g[sys] = sqrtf(rr);
  }
}

template <int R, int NB>
cudaError_t launch_reg(const float* d, const float* bl, const float* bu, const float* V,
                       const float* b, const Offsets& offs, float* x, float* it, float* res,
                       int K, int n, int r, int max_niter, float rtol2, float atol2, float eps,
                       cudaStream_t stream) {
  const int threads = ((n + kE - 1) / kE + 31) / 32 * 32;
  if (threads > kRegMaxWarps * 32) return cudaErrorInvalidValue;
  structured_cg_reg_kernel<R, NB><<<K, threads, 0, stream>>>(
      d, bl, bu, V, b, offs, x, it, res, n, r, max_niter, rtol2, atol2, eps);
  return cudaGetLastError();
}

// the register design's instantiation for rank r and nb bands (nullptr:
// none)
template <int NB>
const void* reg_kernel_nb(int r) {
  if (r <= 1) return (const void*)structured_cg_reg_kernel<1, NB>;
  if (r <= 2) return (const void*)structured_cg_reg_kernel<2, NB>;
  if (r <= 4) return (const void*)structured_cg_reg_kernel<4, NB>;
  if (r <= 8) return (const void*)structured_cg_reg_kernel<8, NB>;
  return nullptr;
}

const void* reg_kernel(int r, int nb) {
  if (r < 1) return nullptr;
  if (nb == 1) return reg_kernel_nb<1>(r);
  if (nb == 2) return reg_kernel_nb<2>(r);
  return nullptr;
}

template <int NB>
cudaError_t launch_reg_nb(const float* d, const float* bl, const float* bu, const float* V,
                          const float* b, const Offsets& offs, float* x, float* it,
                          float* res, int K, int n, int r, int max_niter, float rtol2,
                          float atol2, float eps, cudaStream_t s) {
  if (r <= 1)
    return launch_reg<1, NB>(d, bl, bu, V, b, offs, x, it, res, K, n, r, max_niter, rtol2,
                             atol2, eps, s);
  if (r <= 2)
    return launch_reg<2, NB>(d, bl, bu, V, b, offs, x, it, res, K, n, r, max_niter, rtol2,
                             atol2, eps, s);
  if (r <= 4)
    return launch_reg<4, NB>(d, bl, bu, V, b, offs, x, it, res, K, n, r, max_niter, rtol2,
                             atol2, eps, s);
  return launch_reg<8, NB>(d, bl, bu, V, b, offs, x, it, res, K, n, r, max_niter, rtol2,
                           atol2, eps, s);
}

}  // namespace

// Plain C entry for ctypes.  All arrays but offs are contiguous f32 on the
// device: d, b, x (K, n); bl, bu (K, nb, n); V (K, r, n); it, res (K,).
// offs (nb,) int32 is HOST memory: the offsets travel to the kernel by
// value.  Returns a cudaError_t (0 on success).
extern "C" int structured_cg_f32(const float* d, const float* bl,
                                 const float* bu, const float* V,
                                 const float* b, const int* offs_host, float* x,
                                 float* it, float* res, int K, int n, int nb,
                                 int r, int max_niter, float rtol2,
                                 float atol2, float eps, void* stream) {
  if (K <= 0 || n <= 0 || nb < 1 || nb > kMaxBands || r < 1 || r > kMaxRank)
    return (int)cudaErrorInvalidValue;
  Offsets offs = {};
  for (int k = 0; k < nb; ++k) offs.o[k] = offs_host[k];
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

// The register design, the same arguments as structured_cg_f32 (offs_host
// in host memory): nb <= 2 bands of offset <= 8, rank <= 8, and
// ceil(n / 8) threads (rounded up to warps) no more than the launch takes
// (structured_cg_reg_attrs).  Returns a cudaError_t (0 on success).
extern "C" int structured_cg_reg_f32(const float* d, const float* bl, const float* bu,
                                     const float* V, const float* b, const int* offs_host,
                                     float* x, float* it, float* res, int K, int n, int nb,
                                     int r, int max_niter, float rtol2, float atol2,
                                     float eps, void* stream) {
  if (K <= 0 || n <= 0 || reg_kernel(r, nb) == nullptr) return (int)cudaErrorInvalidValue;
  Offsets offs = {};
  for (int k = 0; k < nb; ++k) {
    if (offs_host[k] < 1 || offs_host[k] > kE) return (int)cudaErrorInvalidValue;
    offs.o[k] = offs_host[k];
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = nb == 1
      ? launch_reg_nb<1>(d, bl, bu, V, b, offs, x, it, res, K, n, r, max_niter, rtol2, atol2,
                         eps, s)
      : launch_reg_nb<2>(d, bl, bu, V, b, offs, x, it, res, K, n, r, max_niter, rtol2, atol2,
                         eps, s);
  return (int)e;
}

// The compiled register design for rank r and nb bands: its registers a
// thread and the most threads a block of it can launch with, on the
// current device (the register window is 8 x that many elements).
extern "C" int structured_cg_reg_attrs(int r, int nb, int* regs, int* max_threads) {
  const void* k = reg_kernel(r, nb);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  *max_threads = fa.maxThreadsPerBlock;
  return 0;
}
