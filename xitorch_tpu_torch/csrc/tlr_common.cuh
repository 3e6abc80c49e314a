// What the residual and the gradient kernels of tridiagonal-plus-low-rank
// solves share (csrc/tlr_residual.cu, csrc/tlr_grad.cu): the row of P
// threads holding kE elements each, the warp sum, the device's limits and
// the persistent grid.  Each source keeps its own arguments, loads, kernel
// and rank switch.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int kE = 4;                     // elements a thread
constexpr int kMaxThreads = 1024;         // threads a row at most: n <= 4,096
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kBlockMin = 256;            // threads a block at least
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the device's SM count and the resident blocks an SM can hold
int device_limit(cudaDeviceAttr what) {
  static int cache[2][kMaxDevices] = {};
  const int which = what == cudaDevAttrMultiProcessorCount ? 0 : 1;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  int& v = cache[which][dev];
  if (v == 0 && cudaDeviceGetAttribute(&v, what, dev) != cudaSuccess) v = 0;
  return v;
}

// the most blocks a launch holds on the current device: the slots of the
// scratch's partials
int max_blocks() {
  return device_limit(cudaDevAttrMultiProcessorCount) *
         device_limit(cudaDevAttrMaxBlocksPerMultiprocessor);
}

// threads a row of n elements: a power of two from 32 to kMaxThreads
int row_threads(int n) {
  int P = 32;
  while (P * kE < n) P <<= 1;
  return P;
}

// Launch kernel(a, P) on a persistent grid over `rows` rows of P threads:
// blocks of max(P, kBlockMin) threads, each holding block / P rows, as many
// blocks as stay resident and never more than max_blocks().
template <typename Args>
int launch_persistent(void (*kernel)(Args, int), const Args& a, long long rows, int P,
                      cudaStream_t stream) {
  const int block = P < kBlockMin ? kBlockMin : P;
  const int G = block / P;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, 0);
  if (e != cudaSuccess) return (int)e;
  const int sms = device_limit(cudaDevAttrMultiProcessorCount);
  if (per_sm < 1 || sms < 1 || max_blocks() < 1) return (int)cudaErrorInvalidConfiguration;
  // as many blocks as stay resident, and never more than the partials hold
  long long grid = (rows + G - 1) / G;
  if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
  if (grid > max_blocks()) grid = max_blocks();
  kernel<<<(unsigned)grid, block, 0, stream>>>(a, P);
  return (int)cudaGetLastError();
}

bool aligned(const void* p) { return ((unsigned long long)p & 15ull) == 0; }

}  // namespace

// The slots of 3 floats that the kernels' scratch of partials needs on the
// current device (the most blocks a launch holds there), 0 if the device
// cannot be read.
extern "C" int tlr_slots() { return max_blocks(); }
