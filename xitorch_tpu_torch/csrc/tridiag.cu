// Batched tridiagonal solve by the non-pivoting Thomas algorithm.
//
// Replaces: xitorch_tpu/ops/tridiag.py::_thomas_kernel (the Pallas TPU
// kernel behind tridiag_solve_pallas).
//
// What bounds it on the H100: each system is a serial recurrence of n
// steps forward and n - 1 back, and it moves about 9 * n values per
// system through device memory (dl, d, du, b read and cp, x written in the
// forward sweep; cp, x read and x written in the back substitution): at
// K = 512, n = 1024 in f32 that is ~19 MB, a few microseconds at full
// bandwidth.  With one thread per system the card holds only K threads,
// so the sweep is bound by the latency of the dependent steps and of
// device memory, not by bandwidth.
//
// Design: one thread per system on the (n, K) layout of the reference
// (systems along the fast axis), so the threads of a warp read and write
// neighbouring addresses at every step.  The loads of a row do not depend
// on the recurrence and can be issued ahead of it; the previous row's cp
// and x are carried in registers.  Zero pivots are replaced by eps (the
// dtype's smallest normal number by default), as in the reference.
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void thomas_kernel(const T* __restrict__ dl,
                              const T* __restrict__ d,
                              const T* __restrict__ du,
                              const T* __restrict__ b, T* __restrict__ x,
                              T* __restrict__ cp, int n, int K, T eps) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  T m = d[k];
  if (m == T(0)) m = eps;
  T cprev = du[k] / m;
  T xprev = b[k] / m;
  cp[k] = cprev;
  x[k] = xprev;
  for (int i = 1; i < n; ++i) {
    const size_t o = (size_t)i * K + k;
    const T l = dl[o];
    m = d[o] - l * cprev;
    if (m == T(0)) m = eps;
    cprev = du[o] / m;
    xprev = (b[o] - l * xprev) / m;
    cp[o] = cprev;
    x[o] = xprev;
  }
  for (int i = n - 2; i >= 0; --i) {
    const size_t o = (size_t)i * K + k;
    xprev = x[o] - cp[o] * xprev;
    x[o] = xprev;
  }
}

template <typename T>
int launch(const T* dl, const T* d, const T* du, const T* b, T* x, T* cp,
           int n, int K, T eps, void* stream) {
  if (n <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (K + threads - 1) / threads;
  thomas_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      dl, d, du, b, x, cp, n, K, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes.  dl, d, du, b, x and the scratch cp are
// contiguous (n, K) device arrays; dl[0, :] and du[n-1, :] are ignored.
// Returns a cudaError_t (0 on success).
extern "C" int thomas_f32(const float* dl, const float* d, const float* du,
                          const float* b, float* x, float* cp, int n, int K,
                          float eps, void* stream) {
  return launch<float>(dl, d, du, b, x, cp, n, K, eps, stream);
}

extern "C" int thomas_f64(const double* dl, const double* d,
                          const double* du, const double* b, double* x,
                          double* cp, int n, int K, double eps,
                          void* stream) {
  return launch<double>(dl, d, du, b, x, cp, n, K, eps, stream);
}
