// Fused conjugate-gradient solve A X = B for explicit dense hermitian A:
// the whole iteration in one launch, with no host round trip per step.
//
// Replaces: xitorch_tpu/ops/fused_cg.py::_cg_kernel (the Pallas TPU kernel
// behind fused_cg_dense).
//
// What bounds it on the H100: a CG step is one product A P (2 n^2
// operations a column) and a few vector updates.  The reference pins A in
// on-chip memory for the whole solve; here a batch of A (64 x 700^2 float32
// is 125 MB) exceeds the card's shared memory (132 x 227 KB) and its 50 MB
// L2, so A comes from device memory on every step.  What the design can
// choose is how many columns each byte of A serves once it is in an SM: a
// CTA that owns G columns does G multiply-adds per element of A it takes
// in, and below a few columns the SM waits on A's bytes, not on its FMA
// units; inside the SM, the product is bound by shared-memory reads unless
// each value read serves several multiply-adds from registers.
//
// Design (the cluster path).  One thread-block cluster of C CTAs a system
// (or a super-group of its columns where there are more than the cluster
// holds): CTA rank c owns its columns' CG recurrences (about W / C of the W
// columns of the cluster, split as evenly as they go; no column past nc is
// multiplied).  A is streamed in bands of whole rows (contiguous in a
// row-major A) into an S-stage ring in shared memory with cp.async.bulk,
// multicast to every CTA of the cluster, so that a band leaves L2 once a
// cluster; each CTA waits for a band on its own full mbarrier (the bytes,
// counted by the copy).  Every computing warp of every CTA arrives on the
// stage's empty mbarrier in rank 0 once it has read the band; a loading
// warp of rank 0 waits there, loads the band a round later into the
// stage, and prefetches the one after it into L2.  A band's 8 computing
// warps: column groups (a warp carries up to 8 of the CTA's columns) x
// halves of k (1 or 2) x row groups of 8 rows.  A warp keeps its 8 rows x
// its columns of sums in registers, each lane one 16-byte chunk of k at a
// time (A and P read as 16-byte vectors, A as 8-byte ones where the rows
// are not 16-byte aligned), so that each value read from shared memory
// serves 8 or GL multiply-adds; its 32 lanes' sums are folded once a band
// by a transposing shuffle (a lane ends with one or two entries), and
// where k is split in halves, the second half's
// warp hands its sums to the first through shared memory (a barrier of the
// two warps).  P and Q = A P live in shared memory ([column][row]); r and x
// in shared memory where they fit, else in a device-memory scratch.  p.q
// is summed per column from the warps' entries in a fixed order, r.r by
// one warp a column, so every thread of the CTA holds the same scalars.
// Only the stop decision crosses CTAs: each CTA pushes the maximum over its
// columns of sqrt(r.r) / max(rtol |b|, atol) into every CTA of the cluster
// with st.async on an mbarrier, every CTA combines the C values in rank
// order and takes the same decision, so all keep consuming bands together
// and leave together.  Where the cluster holds all of a system's columns
// this is the reference's joint rule:
//     while it < max_niter and max_c sqrt(r_c.r_c) / max(rtol |b_c|, atol) >= 1
// Zero denominators follow the reference: p.Ap == 0 and r.r == 0 become
// eps.  Arithmetic is IEEE (fused multiply-adds in the working type; no
// tensor cores, no TF32).  The bands of the next step are loaded before
// the decision is taken (A is the same every step); at the end each CTA
// waits for the S bands in flight before it leaves.  Alignment: a band's
// bytes and its start are multiples of 16 where n is even (bands are
// multiples of 8 rows); the caller pads the rows of an odd n (lda).
//
// The device-memory path (namespace dm, the one-block design) takes the shapes
// whose ring of two bands and one column's state do not fit a CTA's shared
// memory (n > 3,124 float32, n > 1,518 float64): one block a (system, group of G columns), the CG state in shared
// memory, A read by every block from L2 / device memory on every step.
#include <cuda_runtime.h>
#include <math.h>

#include "cluster_common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ============ the device-memory path: a block a group of columns ============
namespace dm {


constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows of A a warp carries at once

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

}  // namespace dm

// ============ the cluster path ============

constexpr int kConsumers = 256;  // 8 warps compute
constexpr int kCWarps = kConsumers / 32;
constexpr int kCThreads = kConsumers + 32;  // and one warp loads A (rank 0)
constexpr int kMaxStages = 4;
constexpr int kMaxCluster = 16;
constexpr int kMaxColsF32 = 32;  // columns a CTA: float32 (float64: 16)
constexpr int kMaxColsF64 = 16;
constexpr int kMaxLaneCols = 8;  // columns a warp carries (8 rows x 8 in registers)
constexpr int kChunkBytes = 16384;  // one bulk copy
constexpr int kVecBatch = 8;        // elements a thread updates at once
// mbarriers (empty and full per stage, two for the decision), the decision
// values (two steps x the cluster), the per-column scalars (rr, stop,
// alpha, 1 spare) of up to 32 columns, and the bands the solve consumed
// (for the loading warp, once it is known)
constexpr int kBarBytes = 8 * (2 * kMaxStages + 2);
constexpr int kDecBytes = 8 * 2 * kMaxCluster;
constexpr int kColBytes = 8 * 4 * kMaxColsF32;
constexpr int kHeaderBytes = kBarBytes + kDecBytes + kColBytes + 16;

// A band's 8 warps: cg column groups (cg a power of 2, at least enough
// that a group holds at most 8 of the CTA's G columns) x kh halves of k
// (1 or 2) x 8 / (cg kh) row groups of 8 rows; a band is 64 / (cg kh) rows
__host__ __device__ __forceinline__ int min_col_groups(int G) {
  int c = 1;
  while (c * kMaxLaneCols < G) c *= 2;
  return c;
}

// Shared memory of a CTA: the header, the warps' p.q parts (8 x 64), the
// partial sums the k halves exchange (2 x 8 x 64), P and Q (G x np, np = n
// rounded up to 16 bytes), with rx also r and x, and S ring stages of
// 64 / (cg kh) rows of lda.
__host__ __device__ inline size_t cluster_smem_bytes(int n, int lda, int G, int cg, int kh, int S,
                                                     int rx, int esize) {
  const int vk = 16 / esize;
  const size_t np = (size_t)(n + vk - 1) / vk * vk;
  return (size_t)kHeaderBytes +
         (size_t)esize * (3 * 512 + (size_t)(2 + 2 * rx) * G * np +
                          (size_t)S * (64 / (cg * kh)) * lda);
}

template <typename T>
struct Args {
  const T* A;
  const long long* a_idx;
  const T* B;
  T* X;
  T* ws;  // x, r scratch (2, nb, nc, n) where they do not live in shared memory
  int* it;
  int nb, n, nc, lda, W, nsg, G, cg, kh, S, rx, max_niter;
  T rtol, atol, eps;
};

__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar, int C) {
  if (C > 1) {
    const unsigned short mask = (unsigned short)((1u << C) - 1u);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1], %2, [%3], %4;"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
  }
}

// the 8 computing warps only (the loading warp does not take part)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
}

// whether the phase of parity `parity` of the barrier has completed (one try)
__device__ __forceinline__ bool mbar_test(void* bar, unsigned parity) {
  unsigned done;
  asm volatile("{\n\t.reg .pred p;\n\t"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
               "selp.u32 %0, 1, 0, p;\n\t}"
               : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void push_value(unsigned ra, float v, unsigned rbar) {
  push_word(ra, v, rbar);
}
__device__ __forceinline__ void push_value(unsigned ra, double v, unsigned rbar) {
  push_dword(ra, v, rbar);
}

// one level of the transposing reduction over the lanes: a lane keeps one
// half of its 2 H values (the upper one where `up`) and adds the partner's
// copy of that half
template <typename T, int H, int VP>
__device__ __forceinline__ void fold(T (&v)[VP], bool up, int mask) {
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const T send = up ? v[j] : v[j + H];
    const T keep = up ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// One 16-byte chunk of P for a lane: columns cb .. cb + GL - 1, chunk c.
template <typename T, int GL>
__device__ __forceinline__ void load_p(typename Vec16<T>::type (&pv)[GL], const T* p, int np,
                                       int cb, int c) {
  constexpr int VK = 16 / (int)sizeof(T);
#pragma unroll
  for (int gj = 0; gj < GL; ++gj)
    pv[gj] = *reinterpret_cast<const typename Vec16<T>::type*>(p + (size_t)(cb + gj) * np +
                                                                VK * c);
}

// acc[mi][gj] += the chunk's k-products of row mi of A and column gj of P
template <typename T, int GL>
__device__ __forceinline__ void chunk_fma(T (&acc)[8][GL], const T* arow, int lda, int nr, int n,
                                          bool a16, int c,
                                          const typename Vec16<T>::type (&pv)[GL]) {
  if constexpr (sizeof(T) == 4) {
    const int k = 4 * c;
    // the second pair of a chunk past n (n = 2 mod 4) belongs to the next
    // row and is not read; rows four at a time, to keep registers for P
    const bool hi = k + 2 < n;
#pragma unroll
    for (int h = 0; h < 8; h += 4) {
      float av[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (h + m < nr) {
          const float* src = arow + (size_t)(h + m) * lda + k;
          if (a16) {
            x = *reinterpret_cast<const float4*>(src);
          } else {
            const float2 lo2 = *reinterpret_cast<const float2*>(src);
            x.x = lo2.x;
            x.y = lo2.y;
            if (hi) {
              const float2 hi2 = *reinterpret_cast<const float2*>(src + 2);
              x.z = hi2.x;
              x.w = hi2.y;
            }
          }
        }
        av[m][0] = x.x;
        av[m][1] = x.y;
        av[m][2] = x.z;
        av[m][3] = x.w;
      }
#pragma unroll
      for (int gj = 0; gj < GL; ++gj)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[h + m][gj] = fmaf(av[m][0], pv[gj].x, acc[h + m][gj]);
          acc[h + m][gj] = fmaf(av[m][1], pv[gj].y, acc[h + m][gj]);
          acc[h + m][gj] = fmaf(av[m][2], pv[gj].z, acc[h + m][gj]);
          acc[h + m][gj] = fmaf(av[m][3], pv[gj].w, acc[h + m][gj]);
        }
    }
  } else {
    // float64: rows are 16-byte aligned (lda even)
    const int k = 2 * c;
    double av[8][2];
#pragma unroll
    for (int mi = 0; mi < 8; ++mi) {
      double2 x = make_double2(0.0, 0.0);
      if (mi < nr) x = *reinterpret_cast<const double2*>(arow + (size_t)mi * lda + k);
      av[mi][0] = x.x;
      av[mi][1] = x.y;
    }
#pragma unroll
    for (int gj = 0; gj < GL; ++gj)
#pragma unroll
      for (int mi = 0; mi < 8; ++mi) {
        acc[mi][gj] = fma(av[mi][0], pv[gj].x, acc[mi][gj]);
        acc[mi][gj] = fma(av[mi][1], pv[gj].y, acc[mi][gj]);
      }
  }
}

// A warp's part of a band: its 8 rows (from row r0 of the stage; rows past
// `rows` read as zero) times its GL columns of P (from column cb), over the
// k chunks (16 bytes each) c0 + lane, c0 + lane + cs, ...: each lane keeps
// the 8 x GL sums in registers; A and P are read as 16-byte vectors (A as
// 8-byte ones where the rows are not 16-byte aligned).  The lanes' sums
// are then folded:
// lane L ends with entries EPL L .. EPL L + EPL - 1 (EPL = 1 or 2; entry
// mi * GL + gj is row r0 + mi, column cb + gj), in out[].
template <typename T, int GL>
__device__ __forceinline__ void warp_band(T (&out)[2], const T* __restrict__ slot,
                                          const T* __restrict__ p, int lda, int n, int np,
                                          int rows, int r0, int cb, int c0, int cs) {
  constexpr int VK = 16 / (int)sizeof(T);
  constexpr int VP = (8 * GL + 31) / 32 * 32;
  const int lane = threadIdx.x & 31;
  const int nch = (n + VK - 1) / VK;
  const int nr = rows - r0;
  const bool a16 = (lda % VK) == 0;
  const T* arow = slot + (size_t)r0 * lda;
  T acc[8][GL];
#pragma unroll
  for (int mi = 0; mi < 8; ++mi)
#pragma unroll
    for (int gj = 0; gj < GL; ++gj) acc[mi][gj] = T(0);
  for (int c = c0 + lane; c < nch; c += cs) {
    typename Vec16<T>::type pv[GL];
    load_p<T, GL>(pv, p, np, cb, c);
    chunk_fma<T, GL>(acc, arow, lda, nr, n, a16, c, pv);
  }
  T v[VP];
#pragma unroll
  for (int mi = 0; mi < 8; ++mi)
#pragma unroll
    for (int gj = 0; gj < GL; ++gj) v[mi * GL + gj] = acc[mi][gj];
#pragma unroll
  for (int j = 8 * GL; j < VP; ++j) v[j] = T(0);
  fold<T, VP / 2>(v, lane & 16, 16);
  fold<T, VP / 4>(v, lane & 8, 8);
  fold<T, VP / 8>(v, lane & 4, 4);
  fold<T, VP / 16>(v, lane & 2, 2);
  fold<T, VP / 32>(v, lane & 1, 1);
  out[0] = v[0];
  out[1] = VP > 32 ? v[VP / 32 - 1] : T(0);
}

// What a warp needs for a step's bands.
template <typename T>
struct Bands {
  unsigned long long* full;
  const T* ring;
  const T* p;
  T* q;
  const T* A;   // the system's matrix
  size_t slot;  // elements a stage
  T* pair;       // this warp pair's exchange buffer [2][32][2] (kh = 2)
  int lda, n, np, BR, nbands, S, r0, cb, gl, t0, C, kh, khi, pair_id;
  unsigned empty0;  // rank 0's empty[0] as a cluster address
};

template <typename T>
__device__ __forceinline__ unsigned band_bytes_of(const Bands<T> w, int t) {
  const int b = t % w.nbands;
  const int rows = w.n - b * w.BR < w.BR ? w.n - b * w.BR : w.BR;
  return (unsigned)((size_t)rows * w.lda * sizeof(T));
}

// band t into its stage in every CTA of the cluster (one thread)
template <typename T>
__device__ __forceinline__ void issue_band(const Bands<T> w, int t) {
  const unsigned bytes = band_bytes_of(w, t);
  const char* src = reinterpret_cast<const char*>(w.A + (size_t)(t % w.nbands) * w.BR * w.lda);
  const unsigned dst = smem_u32(w.ring + (size_t)(t % w.S) * w.slot);
  const unsigned bar = smem_u32(&w.full[t % w.S]);
  for (unsigned off = 0; off < bytes; off += kChunkBytes)
    bulk_load(dst + off, src + off, bytes - off < kChunkBytes ? bytes - off : kChunkBytes, bar,
              w.C);
  // and the band a round later into L2, so that its copy waits on L2, not
  // on device memory
  const int t2 = t + w.S;
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(w.A + (size_t)(t2 % w.nbands) * w.BR * w.lda), "r"(band_bytes_of(w, t2))
               : "memory");
}

// a warp has read band t: one arrival on the stage's empty barrier in
// rank 0, where the loading warp waits for all 8 C of them
template <typename T>
__device__ __forceinline__ void release_band(const Bands<T> w, int t) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive_remote(w.empty0 + 8 * (t % w.S));
}

// The step's product Q = A P for a warp's 8 rows of every band and its GL
// columns (its half of k where kh = 2): wait for the band, multiply, fold,
// release the band; with kh = 2 the second half's warp hands its sums to
// the first through shared memory; the first writes the warp's entries of
// Q.  Thread 0 also arms its CTA's full barrier for the band S ahead.
// Leaves in pq[] the lane's parts of p.q: its entries' products, summed
// over the bands in order.
template <typename T, int GL>
__device__ __forceinline__ void warp_bands(const Bands<T> w, T (&pq)[2]) {
  constexpr int EPL = GL > 4 ? 2 : 1;  // entries a lane
  const int lane = threadIdx.x & 31;
  const int c0 = 32 * w.khi, cs = 32 * w.kh;
  pq[0] = pq[1] = T(0);
  for (int b = 0; b < w.nbands; ++b) {
    const int t = w.t0 + b, s = t % w.S;
    mbar_wait(&w.full[s], (t / w.S) & 1);
    if (threadIdx.x == 0) mbar_expect(&w.full[s], band_bytes_of(w, t + w.S));
    const int rows = w.n - b * w.BR < w.BR ? w.n - b * w.BR : w.BR;
    T e[2];
    warp_band<T, GL>(e, w.ring + (size_t)s * w.slot, w.p, w.lda, w.n, w.np, rows, w.r0, w.cb,
                     c0, cs);
    release_band(w, t);
    if (w.kh == 2) {
      T* buf = w.pair + (b & 1) * 64 + lane * 2;
      if (w.khi == 1) {
        buf[0] = e[0];
        buf[1] = e[1];
      }
      asm volatile("bar.sync %0, 64;" :: "r"(w.pair_id) : "memory");
      if (w.khi == 1) continue;
      e[0] += buf[0];
      e[1] += buf[1];
    }
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int ent = EPL * lane + j, mi = ent / GL, gj = ent - mi * GL;
      const int i = b * w.BR + w.r0 + mi;
      if (ent < 8 * GL && i < w.n) {
        const size_t at = (size_t)(w.cb + gj) * w.np + i;
        w.q[at] = e[j];
        pq[j] = fma(w.p[at], e[j], pq[j]);
      }
    }
  }
}

template <typename T, int GL>
__device__ __forceinline__ void bands_cols(const Bands<T> w, T (&pq)[2]) {
  if constexpr (GL > 0) {
    if (w.gl == GL) {
      warp_bands<T, GL>(w, pq);
      return;
    }
    bands_cols<T, GL - 1>(w, pq);
  } else {
    // a warp with no columns still takes part in every band
    pq[0] = pq[1] = T(0);
    for (int b = 0; b < w.nbands; ++b) {
      const int t = w.t0 + b, s = t % w.S;
      mbar_wait(&w.full[s], (t / w.S) & 1);
      if (threadIdx.x == 0) mbar_expect(&w.full[s], band_bytes_of(w, t + w.S));
      release_band(w, t);
      if (w.kh == 2) asm volatile("bar.sync %0, 64;" :: "r"(w.pair_id) : "memory");
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCThreads, 1) fused_cg_cluster_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int E = (int)sizeof(T);
  constexpr int VK = 16 / E;
  unsigned long long* empty = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* full = empty + kMaxStages;
  unsigned long long* decbar = full + kMaxStages;
  T* dec = reinterpret_cast<T*>(smem + kBarBytes);  // [2][kMaxCluster]
  T* col = reinterpret_cast<T*>(smem + kBarBytes + kDecBytes);
  T* rr = col;
  T* stop = col + kMaxColsF32;
  T* alpha = col + 2 * kMaxColsF32;
  volatile int* consumed = reinterpret_cast<volatile int*>(smem + kBarBytes + kDecBytes +
                                                           kColBytes);

  const int n = a.n, nc = a.nc, lda = a.lda, S = a.S, cg = a.cg, kh = a.kh;
  const int np = (n + VK - 1) / VK * VK;
  T* pqw = reinterpret_cast<T*>(smem + kHeaderBytes);  // [warp][entry] parts of p.q
  T* pairs = pqw + 512;                                // [4 pairs][2][32][2]
  T* p = pairs + 1024;
  T* q = p + (size_t)a.G * np;
  T* ring = q + (size_t)a.G * np * (a.rx ? 3 : 1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned C;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(C));
  const unsigned rank = cluster_rank();
  const int cid = blockIdx.x / C;
  const int sys = cid / a.nsg, sg = cid % a.nsg;
  const int lo = sg * a.W;
  const int w = nc - lo < a.W ? nc - lo : a.W;
  const int c0 = lo + (int)(rank * w / C);
  const int gc = lo + (int)((rank + 1) * w / C) - c0;  // this CTA's columns
  const T* Ak = a.A + (size_t)a.a_idx[sys] * n * lda;
  const T* Bk = a.B + (size_t)sys * n * nc;
  T* Xk = a.X + (size_t)sys * n * nc;
  // r and x: [column][row] in shared memory (stride np) or in the scratch
  // (stride n)
  T* r = a.rx ? q + (size_t)a.G * np : a.ws + ((size_t)(a.nb + sys) * nc + c0) * n;
  T* x = a.rx ? q + (size_t)2 * a.G * np : a.ws + ((size_t)sys * nc + c0) * n;
  const int rs = a.rx ? np : n;
  const int wrn = 8 / (cg * kh), BR = 8 * wrn;
  const int nbands = (n + BR - 1) / BR;
  const size_t slot = (size_t)BR * lda;
  // this warp: column group cw (the CTA's columns cb .. cb + gl - 1, at
  // most 8), half khi of k, rows 8 wr .. 8 wr + 7 of each band
  const int cw = warp / (kh * wrn), khi = (warp / wrn) % kh, wr = warp % wrn;
  const int cb = cw * gc / cg, gl = (cw + 1) * gc / cg - cb;
  // the warps of the two halves (kh = 2) meet on named barrier 2 + pair
  // (0 is __syncthreads, 1 the computing warps')
  const int pair = cw * wrn + wr;

  Bands<T> bw{full, ring, p, q, Ak, slot, pairs + pair * 128, lda, n, np, BR, nbands, S, 8 * wr,
              cb, gl, 0, (int)C, kh, khi, 2 + pair, cluster_map(smem_u32(empty), 0)};

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&empty[s], kCWarps * C);
      mbar_init(&full[s], 1);
    }
    mbar_init(&decbar[0], 1);
    mbar_init(&decbar[1], 1);
    mbar_init_fence();
    for (int s = 0; s < S; ++s) mbar_expect(&full[s], band_bytes_of<T>(bw, s));
    mbar_expect(&decbar[0], C * E);
    mbar_expect(&decbar[1], C * E);
    *consumed = -1;
  }
  cluster_sync();
  if (tid >= kConsumers) {
    // the loading warp of rank 0: band u goes into its stage once every
    // warp of every CTA has released band u - S; it stops after band
    // T + S - 1, T the bands the solve consumed, so that exactly the S
    // bands each CTA waits for at the end are in flight
    if (rank == 0 && tid == kConsumers) {
      for (int u = 0; u < S; ++u) issue_band(bw, u);
      for (int u = S;; ++u) {
        const int tt = u - S;
        bool done = false;
        while (!mbar_test(&empty[tt % S], (tt / S) & 1)) {
          const int total = *consumed;
          if (total >= 0 && u >= total + S) {
            done = true;
            break;
          }
        }
        if (done) break;
        issue_band(bw, u);
      }
    }
    __syncwarp();
    cluster_sync();
    return;
  }
  // x = 0, r = p = b; p's rows n .. np - 1 stay zero
  for (int idx = tid; idx < gc * np; idx += kConsumers) {
    const int g = idx / np, i = idx - g * np;
    const T b = i < n ? Bk[(size_t)i * nc + c0 + g] : T(0);
    p[idx] = b;
    if (i < n) {
      r[(size_t)g * rs + i] = b;
      x[(size_t)g * rs + i] = T(0);
    }
  }
  consumer_sync();
  for (int g = warp; g < gc; g += kCWarps) {
    T s = T(0);
    for (int i = lane; i < n; i += 32) s += p[(size_t)g * np + i] * p[(size_t)g * np + i];
    s = warp_sum(s);
    if (lane == 0) {
      rr[g] = s;
      stop[g] = fmax(a.rtol * sqrt(s), a.atol);
    }
  }
  consumer_sync();

  int step = 0, t = 0;
  while (true) {
    // the stop decision, the same in every CTA of the cluster
    T m = T(0);
    for (int g = 0; g < gc; ++g) {
      const T v = sqrt(rr[g]) / stop[g];
      if (v > m) m = v;
    }
    const int db = step & 1;
    if (tid < (int)C)
      push_value(cluster_map(smem_u32(&dec[db * kMaxCluster + rank]), tid), m,
                 cluster_map(smem_u32(&decbar[db]), tid));
    mbar_wait(&decbar[db], (step >> 1) & 1);
    T mx = dec[db * kMaxCluster];
    for (unsigned k = 1; k < C; ++k) {
      const T v = dec[db * kMaxCluster + k];
      if (v > mx) mx = v;
    }
    if (tid == 0) mbar_expect(&decbar[db], C * E);
    if (!(step < a.max_niter && mx >= T(1))) break;

    // q = A p, band by band, each warp its rows and columns
    bw.t0 = t;
    {
      T pq[2];
      bands_cols<T, kMaxLaneCols>(bw, pq);
      const int epl = gl > 4 ? 2 : 1;
      pqw[warp * 64 + epl * lane] = pq[0];
      if (epl == 2) pqw[warp * 64 + 2 * lane + 1] = pq[1];
    }
    t += nbands;
    consumer_sync();

    if (a.rx) {
      // r and x on chip: a warp a column, from p.q to the new p
      for (int g = warp; g < gc; g += kCWarps) {
        int ow = cg - 1;
        while (ow * gc / cg > g) --ow;
        const int ob = ow * gc / cg, ol = (ow + 1) * gc / cg - ob;
        // the first k half's warps of the group hold the parts
        T s = T(0);
        for (int j = lane; j < 8 * wrn; j += 32)
          s += pqw[(ow * kh * wrn + j / 8) * 64 + g - ob + ol * (j % 8)];
        s = warp_sum(s);
        const T al = rr[g] / (s == T(0) ? a.eps : s);
        T s2 = T(0);
        for (int i = lane; i < n; i += 32) {
          const size_t at = (size_t)g * np + i;
          x[at] += al * p[at];
          const T rn = r[at] - al * q[at];
          r[at] = rn;
          q[at] = rn;
          s2 += rn * rn;
        }
        s2 = warp_sum(s2);
        const T beta = s2 / (rr[g] == T(0) ? a.eps : rr[g]);
        for (int i = lane; i < n; i += 32) {
          const size_t at = (size_t)g * np + i;
          p[at] = q[at] + beta * p[at];
        }
        __syncwarp();
        if (lane == 0) rr[g] = s2;
      }
      consumer_sync();
    } else {
      // alpha = r.r / p.q per column: the parts of the warps of its group,
      // in order
      if (tid < gc) {
        const int g = tid;
        int ow = cg - 1;
        while (ow * gc / cg > g) --ow;
        const int ob = ow * gc / cg, ol = (ow + 1) * gc / cg - ob;
        T s = T(0);
        for (int k = 0; k < wrn; ++k)
          for (int e = g - ob; e < 8 * ol; e += ol) s += pqw[(ow * kh * wrn + k) * 64 + e];
        alpha[g] = rr[g] / (s == T(0) ? a.eps : s);
      }
      consumer_sync();
      // x += alpha p, r -= alpha q (the new r also into q); kVecBatch
      // elements a thread at a time, their loads issued together (r and x may
      // be in device memory)
      for (int base = tid; base < gc * n; base += kConsumers * kVecBatch) {
        size_t ir[kVecBatch];
        int ip[kVecBatch];
        T xv[kVecBatch], rv[kVecBatch], al[kVecBatch];
#pragma unroll
        for (int u = 0; u < kVecBatch; ++u) {
          const int idx = base + u * kConsumers;
          const int g = idx < gc * n ? idx / n : 0, i = idx < gc * n ? idx - g * n : 0;
          ir[u] = (size_t)g * rs + i;
          ip[u] = idx < gc * n ? g * np + i : -1;
          al[u] = alpha[g];
          if (ip[u] >= 0) {
            xv[u] = x[ir[u]];
            rv[u] = r[ir[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < kVecBatch; ++u) {
          if (ip[u] < 0) continue;
          x[ir[u]] = xv[u] + al[u] * p[ip[u]];
          const T rn = rv[u] - al[u] * q[ip[u]];
          r[ir[u]] = rn;
          q[ip[u]] = rn;
        }
      }
      consumer_sync();
      // r.r, beta, p = r + beta p
      for (int g = warp; g < gc; g += kCWarps) {
        T s = T(0);
        for (int i = lane; i < n; i += 32) s += q[(size_t)g * np + i] * q[(size_t)g * np + i];
        s = warp_sum(s);
        const T beta = s / (rr[g] == T(0) ? a.eps : rr[g]);
        for (int i = lane; i < n; i += 32)
          p[(size_t)g * np + i] = q[(size_t)g * np + i] + beta * p[(size_t)g * np + i];
        __syncwarp();
        if (lane == 0) rr[g] = s;
      }
      consumer_sync();
    }
    ++step;
  }

  // the S bands loaded ahead land before the CTA leaves; no CTA leaves
  // while another may still arrive on or push into it
  if (tid == 0) {
    *consumed = t;
    for (int j = 0; j < S; ++j) mbar_wait(&full[(t + j) % S], ((t + j) / S) & 1);
  }
  __syncwarp();
  cluster_sync();
  for (int idx = tid; idx < gc * n; idx += kConsumers) {
    const int g = idx / n, i = idx - g * n;
    Xk[(size_t)i * nc + c0 + g] = x[(size_t)g * rs + i];
  }
  if (rank == 0 && tid == 0) a.it[(size_t)sys * a.nsg + sg] = step;
}

template <typename T>
bool cluster_valid(int nb, int n, int nc, int lda, int C, int W, int nsg, int G, int cg, int kh,
                   int S, int rx) {
  const int gmax = sizeof(T) == 4 ? kMaxColsF32 : kMaxColsF64;
  const int vk = 16 / (int)sizeof(T);
  if (nb <= 0 || n <= 0 || nc <= 0 || C < 1 || C > kMaxCluster || G < 1 || G > gmax) return false;
  if (!(cg == 1 || cg == 2 || cg == 4 || cg == 8) || cg < min_col_groups(G)) return false;
  if (!(kh == 1 || kh == 2) || cg * kh > 8) return false;
  if (S < 1 || S > kMaxStages) return false;
  if (lda < n || (lda & 1) || (((long long)n * lda) % vk) || rx < 0 || rx > 1) return false;
  if (W < 1 || nsg < 1 || (long long)W * (nsg - 1) >= nc || (long long)W * nsg < nc) return false;
  if ((W + C - 1) / C > G) return false;
  return (long long)nb * nsg * C <= 2147483647LL;
}

template <typename T>
cudaError_t cluster_launch(const T* A, const long long* a_idx, const T* B, T* X, T* ws, int* it,
                           int nb, int n, int nc, int lda, int C, int W, int nsg, int G, int cg,
                           int kh, int S, int rx, int max_niter, double rtol, double atol,
                           double eps, cudaStream_t stream) {
  if (!cluster_valid<T>(nb, n, nc, lda, C, W, nsg, G, cg, kh, S, rx) || max_niter < 0)
    return cudaErrorInvalidValue;
  const size_t smem = cluster_smem_bytes(n, lda, G, cg, kh, S, rx, (int)sizeof(T));
  cudaError_t e = cluster_attributes(fused_cg_cluster_kernel<T>, C, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(C, nb * nsg, kCThreads, smem, stream, attr);
  Args<T> args{A, a_idx, B, X, ws, it, nb, n, nc, lda, W, nsg, G, cg, kh, S, rx, max_niter,
               (T)rtol, (T)atol, (T)eps};
  e = cudaLaunchKernelEx(&cfg, fused_cg_cluster_kernel<T>, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t cluster_occupancy(int n, int lda, int C, int G, int cg, int kh, int S, int rx,
                              int* out) {
  if (!cluster_valid<T>(1, n, C, lda, C, C, 1, G, cg, kh, S, rx)) return cudaErrorInvalidValue;
  const size_t smem = cluster_smem_bytes(n, lda, G, cg, kh, S, rx, (int)sizeof(T));
  return active_clusters_of(fused_cg_cluster_kernel<T>, C, kCThreads, smem, out);
}

}  // namespace

// Plain C entries for ctypes.  All arrays are contiguous on the device:
// A (nA, n, lda) (lda >= n, even, and n * lda a multiple of 16 bytes; the
// columns past n zero); a_idx (nb,) int64, the matrix of each system (a
// batch of B that A broadcasts against indexes A, nothing is copied); B, X
// (nb, n, nc); ws (2, nb, nc, n), the x and r scratch where rx == 0 (else
// unused); it (nb * nsg,) int32, the steps each cluster took.  The design:
// clusters of C CTAs (1..16), super-groups of W columns (nsg of them, the
// last one W or fewer), at most G columns a CTA, CG column groups of its
// warps (1, 2, 4, 8, at least ceil(G / 8)), KH halves of k (1, 2; CG KH <=
// 8; bands of 64 / (CG KH) rows), S ring stages (1..4), rx: r and x in
// shared memory.  Returns a cudaError_t (0 on
// success).
extern "C" int fused_cg_cluster_f32(const float* A, const long long* a_idx, const float* B,
                                    float* X, float* ws, int* it, int nb, int n, int nc, int lda,
                                    int C, int W, int nsg, int G, int cg, int kh, int S, int rx,
                                    int max_niter, double rtol, double atol, double eps,
                                    void* stream) {
  return (int)cluster_launch<float>(A, a_idx, B, X, ws, it, nb, n, nc, lda, C, W, nsg, G, cg, kh,
                                    S, rx, max_niter, rtol, atol, eps, (cudaStream_t)stream);
}

extern "C" int fused_cg_cluster_f64(const double* A, const long long* a_idx, const double* B,
                                    double* X, double* ws, int* it, int nb, int n, int nc,
                                    int lda, int C, int W, int nsg, int G, int cg, int kh, int S,
                                    int rx, int max_niter, double rtol, double atol, double eps,
                                    void* stream) {
  return (int)cluster_launch<double>(A, a_idx, B, X, ws, it, nb, n, nc, lda, C, W, nsg, G, cg,
                                     kh, S, rx, max_niter, rtol, atol, eps, (cudaStream_t)stream);
}

// How many clusters of the design (C, G, CG, KH, S, rx) at (n, lda) the
// card holds at once, into *out (0: it cannot schedule one); dtype 4 or 8.
extern "C" int fused_cg_cluster_occupancy(int esize, int n, int lda, int C, int G, int cg, int kh,
                                          int S, int rx, int* out) {
  if (esize == 4) return (int)cluster_occupancy<float>(n, lda, C, G, cg, kh, S, rx, out);
  if (esize == 8) return (int)cluster_occupancy<double>(n, lda, C, G, cg, kh, S, rx, out);
  return (int)cudaErrorInvalidValue;
}

// The device-memory path: A (nA, n, n); it (nb * ceil(nc /
// group),) int32, the steps each block took.  `group` is the number of
// columns a block owns (1, 2, 4 or 8); the caller makes sure that
// 4 * group * n elements fit a block's shared memory.
extern "C" int fused_cg_f32(const float* A, const long long* a_idx, const float* B,
                            float* X, int* it, int nb, int n, int nc, int group,
                            int max_niter, double rtol, double atol, double eps,
                            void* stream) {
  return (int)dm::dispatch<float>(A, a_idx, B, X, it, nb, n, nc, group, max_niter, rtol,
                                  atol, eps, (cudaStream_t)stream);
}

extern "C" int fused_cg_f64(const double* A, const long long* a_idx, const double* B,
                            double* X, int* it, int nb, int n, int nc, int group,
                            int max_niter, double rtol, double atol, double eps,
                            void* stream) {
  return (int)dm::dispatch<double>(A, a_idx, B, X, it, nb, n, nc, group, max_niter, rtol,
                                   atol, eps, (cudaStream_t)stream);
}
