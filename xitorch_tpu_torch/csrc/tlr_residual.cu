// Residual verdict of a solve with a tridiagonal-plus-low-rank operator
// A = diag(d) + T(c) + V V^T, for the eager convergence check of
// linalg.solve.
//
// Replaces: no TPU kernel.  The JAX package's check is A.mm(x) and two
// norms under XLA (xitorch_tpu/linalg/solve.py); built from ATen ops the
// same check writes every intermediate (d x, each coupling product, V^T x,
// V (V^T x), the sums, r) as a full plane, and the low-rank product reads
// V twice.  This kernel reads each input once and writes three numbers.
//
// A row of the kernel is one column j of one system k:
//   r = (d - e_j) x + c (x_{i-1} + x_{i+1}) + V (V^T x) - b,
//   resid = ||r||, stop = max(rtol ||b||, atol),
// and over all rows the check's verdict:
//   out = [any(resid > 10 stop), max resid, max stop]
// (a NaN wins the maxima and fails no comparison, as torch.max and the
// comparison do).  Every operation is IEEE float32, no TF32; sums of
// squares accumulate in float32 by a tree.
//
// What bounds it on the H100: bytes.  A row reads x, d, b and V once,
// (3 + r) n floats, and does about 2 r + 10 operations an element: 28
// bytes to 18 operations at rank 4, far below the card's 20 operations a
// byte.
//
// Design: a persistent grid, as many blocks as the occupancy query lets
// stay resident, each walking over rows.  A row is P threads (a power of
// two from 32 to 1,024), each holding 4 consecutive elements of x, d, b
// and their 4 rows of V in registers, by 16-byte loads where every row is
// 16-byte aligned; below 256 threads a row, a block holds several rows.
// V^T x is reduced by warp shuffles and one shared-memory step, and V
// (V^T x) is formed from the V still in registers, so V is read once.
// The neighbours x_{i-1} and x_{i+1} come by warp shuffles, and across a
// warp's edge through a word of shared memory.  Two block barriers a row.
// Each block keeps its rows' running verdict in registers and writes it
// once, at exit, to its slot of `partial`; the last block to finish (a
// ticket on `counter`) reduces the slots, writes `out` and resets the
// counter to 0 for the next launch on the stream.
#include <cuda_runtime.h>
#include <math.h>

#include "tlr_common.cuh"

namespace {

struct Args {
  const float* x;
  const float* b;
  const float* d;
  const float* c;
  const float* V;
  const float* e;
  float* partial;          // 3 floats a block
  unsigned int* counter;   // 0 between launches
  float* out;              // [failed, max resid, max stop]
  long long rows, J;       // rows = K * J, row s = (s / J, s % J)
  long long xk, xj, bk, bj, dk, ck, vk, ek, ej;  // strides of k and j
  int n;
  int c_mode;              // 0: no coupling, 1: c[k ck] for every pair, 2: a plane of n - 1
  float rtol, atol;
};

// torch.max's rule: a NaN wins
__device__ __forceinline__ float nanmax(float a, float b) { return (b > a || b != b) ? b : a; }

__device__ __forceinline__ float warp_nanmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// this thread's kE elements of a row from i0 (zeros past n)
template <bool kVec>
__device__ __forceinline__ void load4(const float* row, int i0, int n, bool live, float* v) {
  if (kVec) {
    if (live && i0 < n) {
      const float4 q = *reinterpret_cast<const float4*>(row + i0);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) v[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) v[e] = (live && i0 + e < n) ? row[i0 + e] : 0.f;
  }
}

template <int R, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) tlr_residual_kernel(const Args a, const int P) {
  constexpr int kR = R > 0 ? R : 1;
  __shared__ float s_vtx[kMaxWarps][kR];
  __shared__ float s_lo[kMaxWarps], s_hi[kMaxWarps];
  __shared__ float s_rr[kMaxWarps], s_bb[kMaxWarps];
  __shared__ float s_out[kMaxWarps][3];
  __shared__ bool s_last;

  const int G = blockDim.x / P;         // rows a block
  const int g = threadIdx.x / P;        // this thread's row in the block
  const int t = threadIdx.x % P;        // its place in the row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = P >> 5;                 // warps a row
  const int w = t >> 5;                 // this warp's place in the row
  const int first = warp - w;           // the row's first warp
  const int n = a.n;
  const int i0 = kE * t;

  // the running verdict of this thread's row slot (kept by its t == 0)
  float failed = 0.f, mres = -INFINITY, mstop = -INFINITY;

  for (long long base = (long long)blockIdx.x * G; base < a.rows;
       base += (long long)gridDim.x * G) {
    const long long s = base + g;
    const bool live = s < a.rows;
    const long long k = live ? s / a.J : 0;
    const long long j = live ? s - k * a.J : 0;

    float xv[kE], dv[kE], bv[kE], vv[kE * kR];
    load4<kVec>(a.x + k * a.xk + j * a.xj, i0, n, live, xv);
    load4<kVec>(a.d + k * a.dk, i0, n, live, dv);
    load4<kVec>(a.b + k * a.bk + j * a.bj, i0, n, live, bv);
    if (R > 0) {
      const float* vrow = a.V + k * a.vk;   // (n, R), rows contiguous
      if (kVec) {
#pragma unroll
        for (int m = 0; m < R; ++m) {
          float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
          if (live && i0 < n) q = reinterpret_cast<const float4*>(vrow)[t * R + m];
          vv[4 * m] = q.x; vv[4 * m + 1] = q.y; vv[4 * m + 2] = q.z; vv[4 * m + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e)
#pragma unroll
          for (int q = 0; q < R; ++q)
            vv[e * R + q] = (live && i0 + e < n) ? vrow[(long long)(i0 + e) * R + q] : 0.f;
      }
    }
    const float ej = (a.e != nullptr && live) ? a.e[k * a.ek + j * a.ej] : 0.f;
    // coupling to i - 1 and to i + 1 of each element (0 past either end)
    float cl[kE], cr[kE];
    if (a.c_mode == 1) {
      const float cs = live ? a.c[k * a.ck] : 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        cl[e] = (i0 + e >= 1) ? cs : 0.f;
        cr[e] = (i0 + e < n - 1) ? cs : 0.f;
      }
    } else if (a.c_mode == 2) {
      const float* crow = a.c + k * a.ck;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int i = i0 + e;
        cl[e] = (live && i >= 1 && i - 1 < n - 1) ? crow[i - 1] : 0.f;
        cr[e] = (live && i < n - 1) ? crow[i] : 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) cl[e] = cr[e] = 0.f;
    }

    // neighbours: inside a warp by shuffles, across its edges through shared memory
    float xl = __shfl_up_sync(0xffffffffu, xv[kE - 1], 1);
    float xr = __shfl_down_sync(0xffffffffu, xv[0], 1);
    if (lane == 31) s_hi[warp] = xv[kE - 1];
    if (lane == 0) s_lo[warp] = xv[0];

    float p[kR];
#pragma unroll
    for (int q = 0; q < kR; ++q) p[q] = 0.f;
    if (R > 0) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc += vv[e * R + q] * xv[e];
        p[q] = warp_sum(acc);
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < R; ++q) s_vtx[warp][q] = p[q];
      }
    }
    __syncthreads();
    if (lane == 0) xl = w > 0 ? s_hi[warp - 1] : 0.f;
    if (lane == 31) xr = w < W - 1 ? s_lo[warp + 1] : 0.f;
    if (R > 0) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        float acc = 0.f;
        for (int u = 0; u < W; ++u) acc += s_vtx[first + u][q];
        p[q] = acc;                        // (V^T x)_q of the row
      }
    }

    float rr = 0.f, bb = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (live && i0 + e < n) {
        const float xm = e == 0 ? xl : xv[e - 1];
        const float xp = e == kE - 1 ? xr : xv[e + 1];
        float y = dv[e] * xv[e];
        y = y + cr[e] * xp;
        y = y + cl[e] * xm;
        if (R > 0) {
          float lr = 0.f;
#pragma unroll
          for (int q = 0; q < R; ++q) lr += vv[e * R + q] * p[q];
          y = y + lr;
        }
        y = y - xv[e] * ej;
        const float r = y - bv[e];
        rr += r * r;
        bb += bv[e] * bv[e];
      }
    }
    rr = warp_sum(rr);
    bb = warp_sum(bb);
    if (lane == 0) {
      s_rr[warp] = rr;
      s_bb[warp] = bb;
    }
    __syncthreads();
    if (t == 0 && live) {
      float RR = 0.f, BB = 0.f;
      for (int u = 0; u < W; ++u) {
        RR += s_rr[first + u];
        BB += s_bb[first + u];
      }
      const float resid = sqrtf(RR);
      float stop = a.rtol * sqrtf(BB);
      stop = stop < a.atol ? a.atol : stop;   // clamp(min=atol); a NaN stays
      if (resid > 10.f * stop) failed = 1.f;
      mres = nanmax(mres, resid);
      mstop = nanmax(mstop, stop);
    }
  }

  if (t == 0) {
    s_out[g][0] = failed;
    s_out[g][1] = mres;
    s_out[g][2] = mstop;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float f = 0.f, m1 = -INFINITY, m2 = -INFINITY;
    for (int u = 0; u < G; ++u) {
      f = fmaxf(f, s_out[u][0]);
      m1 = nanmax(m1, s_out[u][1]);
      m2 = nanmax(m2, s_out[u][2]);
    }
    float* slot = a.partial + 3 * (long long)blockIdx.x;
    slot[0] = f;
    slot[1] = m1;
    slot[2] = m2;
    __threadfence();
    s_last = atomicAdd(a.counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: every other block's slot is written
  __threadfence();
  float f = 0.f, m1 = -INFINITY, m2 = -INFINITY;
  for (unsigned u = threadIdx.x; u < gridDim.x; u += blockDim.x) {
    const float* slot = a.partial + 3 * (long long)u;
    f = fmaxf(f, __ldcg(slot));
    m1 = nanmax(m1, __ldcg(slot + 1));
    m2 = nanmax(m2, __ldcg(slot + 2));
  }
  f = warp_nanmax(f);
  m1 = warp_nanmax(m1);
  m2 = warp_nanmax(m2);
  if (lane == 0) {
    s_out[warp][0] = f;
    s_out[warp][1] = m1;
    s_out[warp][2] = m2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int u = 1; u < (int)(blockDim.x >> 5); ++u) {
      f = fmaxf(f, s_out[u][0]);
      m1 = nanmax(m1, s_out[u][1]);
      m2 = nanmax(m2, s_out[u][2]);
    }
    a.out[0] = f;
    a.out[1] = m1;
    a.out[2] = m2;
    *a.counter = 0u;
  }
}

template <int R, bool kVec>
int launch(const Args& a, int P, cudaStream_t stream) {
  return launch_persistent<Args>(tlr_residual_kernel<R, kVec>, a, a.rows, P, stream);
}

template <bool kVec>
int launch_rank(const Args& a, int r, int P, cudaStream_t stream) {
  switch (r) {
    case 0: return launch<0, kVec>(a, P, stream);
    case 1: return launch<1, kVec>(a, P, stream);
    case 2: return launch<2, kVec>(a, P, stream);
    case 3: return launch<3, kVec>(a, P, stream);
    case 4: return launch<4, kVec>(a, P, stream);
    case 5: return launch<5, kVec>(a, P, stream);
    case 6: return launch<6, kVec>(a, P, stream);
    case 7: return launch<7, kVec>(a, P, stream);
    case 8: return launch<8, kVec>(a, P, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes.  x and b: rows (k, j) of n floats at
// x + k xk + j xj (b likewise), each contiguous; d: n floats at d + k dk;
// c: none (c_mode 0), one value at c + k ck (1) or n - 1 at c + k ck (2);
// V: an (n, r) block at V + k vk, row-major, or null with r = 0; e: one
// value at e + k ek + j ej, or null.  A stride may be 0 (a broadcast).
// partial holds 3 * tlr_slots() floats; counter is one word, 0
// before the launch and after it.  n in [1, 4096], r in [0, 8].  Returns a
// cudaError_t (0 on success).
extern "C" int tlr_residual_f32(const float* x, const float* b, const float* d, const float* c,
                                const float* V, const float* e, float* partial,
                                unsigned int* counter, float* out, long long K, long long J,
                                int n, int r, int c_mode, long long xk, long long xj,
                                long long bk, long long bj, long long dk, long long ck,
                                long long vk, long long ek, long long ej, float rtol,
                                float atol, void* stream) {
  if (K <= 0 || J <= 0 || n < 1 || n > kE * kMaxThreads || r < 0 || r > 8 || c_mode < 0 ||
      c_mode > 2)
    return (int)cudaErrorInvalidValue;
  Args a{x, b, d, c, V, e, partial, counter, out, K * J, J,
         xk, xj, bk, bj, dk, ck, vk, ek, ej, n, c_mode, rtol, atol};
  const int P = row_threads(n);
  // 16-byte loads where every row of x, d, b and V starts 16-byte aligned
  const bool vec = n % kE == 0 && aligned(x) && aligned(b) && aligned(d) &&
                   (r == 0 || aligned(V)) && xk % kE == 0 && xj % kE == 0 && bk % kE == 0 &&
                   bj % kE == 0 && dk % kE == 0 && vk % kE == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch_rank<true>(a, r, P, s) : launch_rank<false>(a, r, P, s);
}
