// Fused conjugate-gradient solve A X = B for explicit dense hermitian A:
// the whole iteration in one launch, with no host round trip per step.
//
// Replaces: xitorch_tpu/ops/fused_cg.py::_cg_kernel (the Pallas TPU kernel
// behind fused_cg_dense).
//
// What bounds it on the H100: a CG step is one product A p (2 n^2 operations
// a column) and a few vector updates.  The reference pins A in on-chip
// memory for the whole solve; here A (n^2 * 4 bytes, 1.96 MB at n = 700) is
// larger than a block's shared memory, so A is read from L2 / device memory
// on every step and only the CG state lives on chip.  Per step a block moves
// n^2 elements of A through its SM and does n^2 * G multiply-adds on them;
// at G = 8 the two are balanced on an SM, so the loop is bound by the L2
// bandwidth an SM can draw and by its FMA rate, not by device memory.
//
// Design: the columns of one system are independent CG recurrences coupled
// only by the stop rule, so a block owns one (system, group of G columns)
// and keeps the group's x, r, p and A p in dynamic shared memory, one
// contiguous plane a column.  Nothing crosses blocks.  The product: each
// warp carries kRows rows of A at a time, lanes stride along the row
// (coalesced reads of A as given: symmetry is never assumed), every lane
// keeps kRows * G partial sums in registers, and a warp-shuffle tree
// finishes each row.  The dot products p.Ap and r.r reduce by warp shuffles
// and then across the warps in a fixed order, so every thread holds
// bit-identical scalars and the stop test is uniform across the block.
// Arithmetic is IEEE (fused multiply-adds in the working type; no tensor
// cores, no TF32).  Each group stops on its own columns:
//     while it < max_niter and any_c sqrt(r_c.r_c) / max(rtol |b_c|, atol) >= 1
// (the reference stops a system on the maximum over all its columns; a
// group of already-converged columns is simply polished less).  Zero
// denominators follow the reference: p.Ap == 0 and r.r == 0 become eps.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows of A a warp carries at once

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of G values; every thread returns the same values.  `red`
// (G * kWarps) must not be written again before all threads have passed
// another __syncthreads.
template <typename T, int G>
__device__ __forceinline__ void block_sums(T (&v)[G], T* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T s = warp_sum(v[g]);
    if (lane == 0) red[g * kWarps + warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[g * kWarps + w];
    v[g] = s;
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
fused_cg_kernel(const T* __restrict__ A_g, const long long* __restrict__ a_idx,
                const T* __restrict__ B_g, T* __restrict__ X_g,
                int* __restrict__ it_g, int n, int nc, int ngroups,
                int max_niter, T rtol, T atol, T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red_p[G * kWarps];
  __shared__ T red_r[G * kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t sys = blockIdx.x / ngroups;
  const int c0 = (int)(blockIdx.x % ngroups) * G;
  const int gcount = nc - c0 < G ? nc - c0 : G;  // columns of this group

  // one contiguous plane of n a column: lanes read neighbouring addresses
  T* x = reinterpret_cast<T*>(smem_raw);
  T* r = x + (size_t)G * n;
  T* p = r + (size_t)G * n;
  T* q = p + (size_t)G * n;

  const T* Ak = A_g + (size_t)a_idx[sys] * n * n;
  const T* Bk = B_g + sys * n * nc + c0;
  T* Xk = X_g + sys * n * nc + c0;

  // columns past nc stay zero: alpha and beta come out 0 and they never
  // hold the group back
  for (int idx = tid; idx < G * n; idx += kThreads) {
    const int i = idx / G, g = idx % G;
    const T v = g < gcount ? Bk[(size_t)i * nc + g] : T(0);
    x[g * n + i] = T(0);
    r[g * n + i] = v;
    p[g * n + i] = v;
  }
  __syncthreads();
  T rr[G], stop[G];
#pragma unroll
  for (int g = 0; g < G; ++g) rr[g] = T(0);
  for (int i = tid; i < n; i += kThreads) {
#pragma unroll
    for (int g = 0; g < G; ++g) rr[g] += r[g * n + i] * r[g * n + i];
  }
  block_sums<T, G>(rr, red_r);
#pragma unroll
  for (int g = 0; g < G; ++g) stop[g] = fmax(rtol * sqrt(rr[g]), atol);

  int it = 0;
  while (it < max_niter) {
    bool go = false;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g < gcount && sqrt(rr[g]) / stop[g] >= T(1)) go = true;
    if (!go) break;

    // q = A p
    for (int i0 = warp * kRows; i0 < n; i0 += kWarps * kRows) {
      T acc[kRows][G];
      const T* arow[kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        // a row past the end repeats the last one; its sums are dropped
        const int row = i0 + a < n ? i0 + a : n - 1;
        arow[a] = Ak + (size_t)row * n;
#pragma unroll
        for (int g = 0; g < G; ++g) acc[a][g] = T(0);
      }
#pragma unroll 2
      for (int j = lane; j < n; j += 32) {
        T pv[G];
#pragma unroll
        for (int g = 0; g < G; ++g) pv[g] = p[g * n + j];
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          const T av = arow[a][j];
#pragma unroll
          for (int g = 0; g < G; ++g) acc[a][g] = fma(av, pv[g], acc[a][g]);
        }
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const T s = warp_sum(acc[a][g]);
          if (lane == 0 && i0 + a < n) q[g * n + i0 + a] = s;
        }
      }
    }
    __syncthreads();

    T pap[G];
#pragma unroll
    for (int g = 0; g < G; ++g) pap[g] = T(0);
    for (int i = tid; i < n; i += kThreads) {
#pragma unroll
      for (int g = 0; g < G; ++g) pap[g] += p[g * n + i] * q[g * n + i];
    }
    block_sums<T, G>(pap, red_p);

    // x += alpha p, r -= alpha q, r.r  (each thread touches only its own
    // indices, so no barrier is needed before the reduction)
    T alpha[G], rrn[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      alpha[g] = rr[g] / (pap[g] == T(0) ? eps : pap[g]);
      rrn[g] = T(0);
    }
    for (int i = tid; i < n; i += kThreads) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        x[g * n + i] += alpha[g] * p[g * n + i];
        const T ri = r[g * n + i] - alpha[g] * q[g * n + i];
        r[g * n + i] = ri;
        rrn[g] += ri * ri;
      }
    }
    block_sums<T, G>(rrn, red_r);
    for (int i = tid; i < n; i += kThreads) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const T beta = rrn[g] / (rr[g] == T(0) ? eps : rr[g]);
        p[g * n + i] = r[g * n + i] + beta * p[g * n + i];
      }
    }
    __syncthreads();  // the next product reads every thread's p
#pragma unroll
    for (int g = 0; g < G; ++g) rr[g] = rrn[g];
    ++it;
  }

  for (int idx = tid; idx < G * n; idx += kThreads) {
    const int i = idx / G, g = idx % G;
    if (g < gcount) Xk[(size_t)i * nc + g] = x[g * n + i];
  }
  if (tid == 0) it_g[blockIdx.x] = it;
}

template <typename T, int G>
cudaError_t launch(const T* A, const long long* a_idx, const T* B, T* X, int* it,
                   int nb, int n, int nc, int max_niter, double rtol, double atol,
                   double eps, cudaStream_t stream) {
  const size_t smem = (size_t)4 * G * n * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      fused_cg_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int ngroups = (nc + G - 1) / G;
  fused_cg_kernel<T, G><<<(unsigned)(nb * ngroups), kThreads, smem, stream>>>(
      A, a_idx, B, X, it, n, nc, ngroups, max_niter, (T)rtol, (T)atol, (T)eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const T* A, const long long* a_idx, const T* B, T* X, int* it,
                     int nb, int n, int nc, int group, int max_niter, double rtol,
                     double atol, double eps, cudaStream_t s) {
  if (nb <= 0 || n <= 0 || nc <= 0 || max_niter < 0) return cudaErrorInvalidValue;
  const long long blocks = (long long)nb * ((nc + group - 1) / group);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  switch (group) {
    case 1: return launch<T, 1>(A, a_idx, B, X, it, nb, n, nc, max_niter, rtol, atol, eps, s);
    case 2: return launch<T, 2>(A, a_idx, B, X, it, nb, n, nc, max_niter, rtol, atol, eps, s);
    case 4: return launch<T, 4>(A, a_idx, B, X, it, nb, n, nc, max_niter, rtol, atol, eps, s);
    case 8: return launch<T, 8>(A, a_idx, B, X, it, nb, n, nc, max_niter, rtol, atol, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entries for ctypes.  All arrays are contiguous on the device:
// A (nA, n, n); a_idx (nb,) int64, the matrix of each system (a batch of B
// that A broadcasts against indexes A, nothing is copied); B, X (nb, n, nc);
// it (nb * ceil(nc / group),) int32, the steps each block took.  `group` is
// the number of columns a block owns (1, 2, 4 or 8); the caller makes sure
// that 4 * group * n elements fit a block's shared memory.  Returns a
// cudaError_t (0 on success).
extern "C" int fused_cg_f32(const float* A, const long long* a_idx, const float* B,
                            float* X, int* it, int nb, int n, int nc, int group,
                            int max_niter, double rtol, double atol, double eps,
                            void* stream) {
  return (int)dispatch<float>(A, a_idx, B, X, it, nb, n, nc, group, max_niter, rtol,
                              atol, eps, (cudaStream_t)stream);
}

extern "C" int fused_cg_f64(const double* A, const long long* a_idx, const double* B,
                            double* X, int* it, int nb, int n, int nc, int group,
                            int max_niter, double rtol, double atol, double eps,
                            void* stream) {
  return (int)dispatch<double>(A, a_idx, B, X, it, nb, n, nc, group, max_niter, rtol,
                               atol, eps, (cudaStream_t)stream);
}
