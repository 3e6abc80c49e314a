// First-order gradients of a solve's operator parameters for a
// tridiagonal-plus-low-rank operator A = diag(d) + T(c) + V V^T, in the
// backward of linalg.solve.
//
// Replaces: no TPU kernel.  The JAX package leaves these gradients to
// jax.vjp of the operator's matvec under XLA (xitorch_tpu/linalg/solve.py);
// built from ATen ops, autograd through A.mm(x) re-runs the matvec's V
// contractions as batched GEMVs and GEMMs and writes each intermediate
// (V^T x, V^T lam, their outer products, the coupling's shifted products)
// as a full plane.  This kernel reads lam, x and V once and writes each
// gradient once.
//
// With lam the adjoint solution and x the solution, the backward needs the
// gradient of -lam^T (A - E) x to the parameters, x held fixed.  Over the
// columns j of each system k, for every element i:
//   gd[k, i]    = -sum_j lam_i x_i
//   gV[k, i, m] = -sum_j (lam_i (V^T x)_m + x_i (V^T lam)_m)
//   gc          = -sum (lam_i x_{i+1} + lam_{i+1} x_i), the bond (i, i+1):
//                 per bond and system for a (K, n - 1) coupling, over every
//                 bond, column and system for a scalar coupling
//   gE[k, j]    =  sum_i lam_i x_i
// each only where it is asked for.  Every operation is IEEE float32, no
// TF32; every sum is taken in a fixed order, so a launch on a device gives
// the same bits every time.
//
// What bounds it on the H100: bytes.  At rank r a column reads lam, x and
// V, (2 + r) n floats, and writes gd and gV, (1 + r) n, doing about 6 r + 4
// operations an element: 4 bytes an operation, far below the card's 20
// operations a byte.
//
// Design, after csrc/tlr_residual.cu, which reads the same planes: a
// persistent grid, as many blocks as the occupancy query lets stay
// resident, each walking over systems.  A system is P threads (a power of
// two from 32 to 1,024), each holding 4 elements of lam and x, P apart
// (thread t has i = t, t + P, t + 2P, t + 3P), and their rows of V in
// registers; below 256 threads a system, a block holds several.  So every
// load and store of a warp covers consecutive addresses: 128 bytes of lam,
// x, gd or a coupling plane, and at rank 4 (8) one (two) float4 a row of V
// and of gV, 512 bytes a warp (a thread holding 4 consecutive elements
// instead wrote gV at 64-byte strides and reached 71 % of the bound on an
// H100 80GB HBM3 at 700 W, against 82 % for this layout).
// V^T x, V^T lam and lam . x (2 r + 1 sums) are reduced together by warp
// shuffles and one shared-memory step, and gV is formed from the V still in
// registers, so V is read once.  The neighbours lam_{i+1} and x_{i+1} come
// from the next lane by shuffles, and across a warp's edge through shared
// memory (the system's last lane takes its first lane's next element).  One
// block barrier a column (the shared words are double-buffered).  With
// several columns, a thread adds each column's part to the outputs it wrote
// for the column before (its own elements only); with one column every
// output is written once.  A scalar coupling's sum is kept by each thread,
// reduced once a block into its slot of `partial`; the last block to finish
// (a ticket on `counter`) sums the slots in block order, writes gc and
// resets the counter to 0 for the next launch on the stream.
#include <cuda_runtime.h>
#include <math.h>

#include "tlr_common.cuh"

namespace {

struct Args {
  const float* lam;
  const float* x;
  const float* V;          // null unless gV is asked for (R > 0)
  float* gd;               // (K, n) or null
  float* gV;               // (K, n, R) or null
  float* gc;               // one value (c_mode 1), (K, n - 1) (c_mode 2) or null
  float* gE;               // (K, J) or null
  float* partial;          // 1 float a block (c_mode 1)
  unsigned int* counter;   // 0 between launches
  long long K, J;
  long long lk, lj, xk, xj, vk;  // strides of k and j
  int n;
  int c_mode;              // 0: no coupling gradient, 1: a scalar's, 2: a plane's
};

// this thread's kE elements t, t + P, ... of a row (zeros past n)
__device__ __forceinline__ void load4(const float* row, int t, int P, int n, bool live,
                                      float* v) {
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int i = t + e * P;
    v[e] = (live && i < n) ? row[i] : 0.f;
  }
}

// store (first column) or add to what this thread stored before
__device__ __forceinline__ void put4(float* row, int t, int P, int n, bool first,
                                     const float* v) {
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int i = t + e * P;
    if (i < n) row[i] = first ? v[e] : row[i] + v[e];
  }
}

// R floats of a row of V (or gV) by float4 (kVec: R % 4 == 0, rows aligned)
template <int R, bool kVec>
__device__ __forceinline__ void load_row(const float* row, bool ok, float* v) {
  if (kVec) {
#pragma unroll
    for (int m4 = 0; m4 < R / 4; ++m4) {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) q = reinterpret_cast<const float4*>(row)[m4];
      v[4 * m4] = q.x; v[4 * m4 + 1] = q.y; v[4 * m4 + 2] = q.z; v[4 * m4 + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < R; ++m) v[m] = ok ? row[m] : 0.f;
  }
}

template <int R, bool kVec>
__device__ __forceinline__ void put_row(float* row, bool first, const float* v) {
  if (kVec) {
#pragma unroll
    for (int m4 = 0; m4 < R / 4; ++m4) {
      float4* p = reinterpret_cast<float4*>(row) + m4;
      float4 q = make_float4(v[4 * m4], v[4 * m4 + 1], v[4 * m4 + 2], v[4 * m4 + 3]);
      if (!first) {
        const float4 o = *p;
        q.x = o.x + q.x; q.y = o.y + q.y; q.z = o.z + q.z; q.w = o.w + q.w;
      }
      *p = q;
    }
  } else {
#pragma unroll
    for (int m = 0; m < R; ++m) row[m] = first ? v[m] : row[m] + v[m];
  }
}

template <int R, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) tlr_grad_kernel(const Args a, const int P) {
  constexpr int kR = R > 0 ? R : 1;
  constexpr int kS = 2 * kR + 1;          // a warp's sums: V^T x, V^T lam, lam . x
  __shared__ float s_sum[2][kMaxWarps][kS];
  __shared__ float s_x[2][kMaxWarps][kE], s_l[2][kMaxWarps][kE];   // each warp's lane 0
  __shared__ float s_c[kMaxWarps];
  __shared__ bool s_last;

  const int G = blockDim.x / P;         // systems a block
  const int g = threadIdx.x / P;        // this thread's system in the block
  const int t = threadIdx.x % P;        // its place in the system
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = P >> 5;                 // warps a system
  const int w = t >> 5;                 // this warp's place in the system
  const int first = warp - w;           // the system's first warp
  const int n = a.n;
  const bool want_d = a.gd != nullptr;
  const bool want_e = a.gE != nullptr;
  // the shared step: the column's sums, or the neighbours across a warp's edge
  const bool sync = R > 0 || want_e || a.c_mode != 0;

  float csum = 0.f;                     // this thread's part of a scalar coupling's gradient
  int buf = 0;

  for (long long base = (long long)blockIdx.x * G; base < a.K;
       base += (long long)gridDim.x * G) {
    const long long k = base + g;
    const bool live = k < a.K;
    const long long ks = live ? k : 0;

    float vv[kE * kR];
    if (R > 0) {
      const float* vrow = a.V + ks * a.vk;   // (n, R), rows contiguous
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int i = t + e * P;
        load_row<R, kVec>(vrow + (long long)i * R, live && i < n, vv + e * R);
      }
    }

    for (long long j = 0; j < a.J; ++j) {
      float xv[kE], lv[kE];
      load4(a.x + ks * a.xk + j * a.xj, t, P, n, live, xv);
      load4(a.lam + ks * a.lk + j * a.lj, t, P, n, live, lv);

      // element i + 1 of x and lam: the next lane's, across the warp's
      // edge through shared memory (zeros past n: the last bond's product
      // vanishes by itself)
      float xn[kE], ln[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        xn[e] = __shfl_down_sync(0xffffffffu, xv[e], 1);
        ln[e] = __shfl_down_sync(0xffffffffu, lv[e], 1);
      }
      if (lane == 0) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          s_x[buf][warp][e] = xv[e];
          s_l[buf][warp][e] = lv[e];
        }
      }

      float p[kR], q[kR];
      float lx = 0.f;
#pragma unroll
      for (int m = 0; m < kR; ++m) p[m] = q[m] = 0.f;
      if (R > 0) {
#pragma unroll
        for (int m = 0; m < R; ++m) {
          float ax = 0.f, al = 0.f;
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            ax += vv[e * R + m] * xv[e];
            al += vv[e * R + m] * lv[e];
          }
          p[m] = warp_sum(ax);
          q[m] = warp_sum(al);
        }
      }
      if (want_e) {
#pragma unroll
        for (int e = 0; e < kE; ++e) lx += lv[e] * xv[e];
        lx = warp_sum(lx);
      }
      if (lane == 0) {
        if (R > 0) {
#pragma unroll
          for (int m = 0; m < R; ++m) {
            s_sum[buf][warp][m] = p[m];
            s_sum[buf][warp][kR + m] = q[m];
          }
        }
        s_sum[buf][warp][2 * kR] = lx;
      }
      if (sync) __syncthreads();
      if (a.c_mode != 0 && lane == 31) {
        // the next warp's lane 0; past the system's last warp, its first
        // warp's lane 0 holds element i + 1 = P (e + 1)
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const bool last = w == W - 1;
          xn[e] = !last ? s_x[buf][warp + 1][e] : (e + 1 < kE ? s_x[buf][first][e + 1] : 0.f);
          ln[e] = !last ? s_l[buf][warp + 1][e] : (e + 1 < kE ? s_l[buf][first][e + 1] : 0.f);
        }
      }
      if (R > 0) {
#pragma unroll
        for (int m = 0; m < R; ++m) {
          float sp = 0.f, sq = 0.f;
          for (int u = 0; u < W; ++u) {
            sp += s_sum[buf][first + u][m];
            sq += s_sum[buf][first + u][kR + m];
          }
          p[m] = sp;                       // (V^T x)_m of the column
          q[m] = sq;                       // (V^T lam)_m
        }
      }
      const bool first_col = j == 0;
      if (want_e && t == 0 && live) {
        float s = 0.f;
        for (int u = 0; u < W; ++u) s += s_sum[buf][first + u][2 * kR];
        a.gE[k * a.J + j] = s;
      }
      buf ^= 1;
      if (!live) continue;

      if (want_d) {
        float gdv[kE];
#pragma unroll
        for (int e = 0; e < kE; ++e) gdv[e] = -(lv[e] * xv[e]);
        put4(a.gd + k * n, t, P, n, first_col, gdv);
      }
      if (a.c_mode != 0) {
        float bond[kE];
#pragma unroll
        for (int e = 0; e < kE; ++e) bond[e] = lv[e] * xn[e] + ln[e] * xv[e];
        if (a.c_mode == 1) {
#pragma unroll
          for (int e = 0; e < kE; ++e) csum -= bond[e];
        } else {
#pragma unroll
          for (int e = 0; e < kE; ++e) bond[e] = -bond[e];
          // bonds 0 .. n - 2
          put4(a.gc + k * (n - 1), t, P, n - 1, first_col, bond);
        }
      }
      if (R > 0) {
        float* grow = a.gV + k * (long long)n * R;   // (n, R), rows contiguous
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int i = t + e * P;
          if (i < n) {
            float gv[kR];
#pragma unroll
            for (int m = 0; m < R; ++m) gv[m] = -(lv[e] * p[m] + xv[e] * q[m]);
            put_row<R, kVec>(grow + (long long)i * R, first_col, gv);
          }
        }
      }
    }
  }

  if (a.c_mode != 1) return;

  // a scalar coupling: the block's sum into its slot, the last block sums the slots
  csum = warp_sum(csum);
  if (lane == 0) s_c[warp] = csum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int u = 0; u < (int)(blockDim.x >> 5); ++u) s += s_c[u];
    a.partial[blockIdx.x] = s;
    __threadfence();
    s_last = atomicAdd(a.counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: every other block's slot is written
  __threadfence();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (unsigned u = 0; u < gridDim.x; ++u) s += __ldcg(a.partial + u);
    *a.gc = s;
    *a.counter = 0u;
  }
}

template <int R, bool kVec>
int launch(const Args& a, int P, cudaStream_t stream) {
  return launch_persistent<Args>(tlr_grad_kernel<R, kVec>, a, a.K, P, stream);
}

// kVec: V and gV by float4, only where R % 4 == 0
template <bool kVec>
int launch_rank(const Args& a, int r, int P, cudaStream_t stream) {
  switch (r) {
    case 0: return launch<0, false>(a, P, stream);
    case 1: return launch<1, false>(a, P, stream);
    case 2: return launch<2, false>(a, P, stream);
    case 3: return launch<3, false>(a, P, stream);
    case 4: return kVec ? launch<4, true>(a, P, stream) : launch<4, false>(a, P, stream);
    case 5: return launch<5, false>(a, P, stream);
    case 6: return launch<6, false>(a, P, stream);
    case 7: return launch<7, false>(a, P, stream);
    case 8: return kVec ? launch<8, true>(a, P, stream) : launch<8, false>(a, P, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes.  lam and x: rows (k, j) of n floats at
// lam + k lk + j lj (x likewise), each contiguous; V: an (n, r) block at
// V + k vk, row-major, or null with r = 0 (then no gV).  Outputs, each
// contiguous or null where not asked for: gd (K, n), gV (K, n, r), gE (K,
// J); gc one float (c_mode 1), (K, n - 1) (c_mode 2) or null (c_mode 0).
// partial holds tlr_slots() floats; counter is one word, 0 before the
// launch and after it.  n in [1, 4096], r in [0, 8].  Returns a cudaError_t
// (0 on success).
extern "C" int tlr_grad_f32(const float* lam, const float* x, const float* V, float* gd,
                            float* gV, float* gc, float* gE, float* partial,
                            unsigned int* counter, long long K, long long J, int n, int r,
                            int c_mode, long long lk, long long lj, long long xk, long long xj,
                            long long vk, void* stream) {
  if (K <= 0 || J <= 0 || n < 1 || n > kE * kMaxThreads || r < 0 || r > 8 || c_mode < 0 ||
      c_mode > 2 || (r > 0) != (V != nullptr && gV != nullptr) ||
      (c_mode != 0 && gc == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{lam, x, V, gd, gV, gc, gE, partial, counter, K, J, lk, lj, xk, xj, vk, n, c_mode};
  const int P = row_threads(n);
  // V and gV by float4 where every row of each starts 16-byte aligned
  const bool vec = r % 4 == 0 && r > 0 && aligned(V) && aligned(gV) && vk % 4 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch_rank<true>(a, r, P, s) : launch_rank<false>(a, r, P, s);
}
