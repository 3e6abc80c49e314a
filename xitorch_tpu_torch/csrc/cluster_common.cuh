// Thread-block cluster machinery (sm_90) shared by the kernels that split a
// system over the CTAs of a cluster (csrc/jacobi_sweep.cu,
// csrc/jacobi_sweep_complex.cu through jacobi_common.cuh, and
// csrc/fused_cg.cu): the CTA's rank, the cluster barrier, mbarriers, words
// pushed into other CTAs with st.async and counted on their mbarriers, the
// launch configuration, the kernel attributes and the occupancy query.
#pragma once
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster: writes to shared memory before
// it are visible to every CTA of the cluster after it (arrive has release,
// wait acquire semantics); it is also a barrier of the CTA's own threads
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;"
               ::: "memory");
}

// Pushing a word into another CTA: st.async carries the value and
// completes its bytes on the receiver's mbarrier, so the receiver learns
// that the data arrived by waiting on its own barrier, with no fence at
// cluster scope (on an NVIDIA H100 80GB HBM3 at 700 W a cluster barrier,
// whose arrive has release semantics, took ~0.7 us; with a relaxed arrive
// ~0.07 us).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned cluster_map(unsigned a, unsigned rank) {
  unsigned ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(a), "r"(rank));
  return ra;
}

// the word v to cluster address `ra`, its 4 bytes completed on the mbarrier
// at cluster address `rbar` (both in the same CTA)
__device__ __forceinline__ void push_word(unsigned ra, float v, unsigned rbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(ra), "r"(__float_as_uint(v)), "r"(rbar) : "memory");
}

// the words (v0, v1) to cluster address `ra` (8-byte aligned), their 8
// bytes completed on the mbarrier at cluster address `rbar`
__device__ __forceinline__ void push_pair(unsigned ra, float v0, float v1, unsigned rbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
               :: "r"(ra), "r"(__float_as_uint(v0)), "r"(__float_as_uint(v1)), "r"(rbar)
               : "memory");
}

// the double v to cluster address `ra` (8-byte aligned), its 8 bytes
// completed on the mbarrier at cluster address `rbar`
__device__ __forceinline__ void push_dword(unsigned ra, double v, unsigned rbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
               :: "r"(ra), "l"(__double_as_longlong(v)), "r"(rbar) : "memory");
}

__device__ __forceinline__ void mbar_init(void* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// the barrier inits visible to the cluster (before any CTA pushes to them)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects `bytes` more bytes in the current phase
__device__ __forceinline__ void mbar_expect(void* bar, unsigned bytes) {
  [[maybe_unused]] unsigned long long state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state) : "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// one arrival on the mbarrier at cluster address `rbar` (another CTA's),
// with the default release semantics at CTA scope: releasing at cluster
// scope costs a fence (~0.7 us a call, as the cluster barrier above)
__device__ __forceinline__ void mbar_arrive_remote(unsigned rbar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" :: "r"(rbar) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(void* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// ---- launching a cluster kernel (host) ----

// `clusters` clusters of C CTAs of `threads` threads, `smem` bytes of
// dynamic shared memory each; attr: one cudaLaunchAttribute the config
// points to
inline cudaLaunchConfig_t cluster_config(int C, int clusters, int threads, size_t smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the kernel's dynamic shared memory, and above 8 CTAs the non-portable
// cluster size
template <class Kernel>
cudaError_t cluster_attributes(Kernel kernel, int C, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// how many clusters of the kernel the card holds at once, into *out (0: it
// cannot schedule one)
template <class Kernel>
cudaError_t active_clusters_of(Kernel kernel, int C, int threads, size_t smem, int* out) {
  cudaError_t e = cluster_attributes(kernel, C, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(C, 1, threads, smem, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace
