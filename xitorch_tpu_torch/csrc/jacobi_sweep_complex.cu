// Batched one-sided (Hestenes) Jacobi sweeps on a complex row panel, held
// as packed real planes [Re G^T | Im G^T].
//
// Replaces: xitorch_tpu/ops/jacobi_eigh.py::_jacobi_kernel_complex (the
// Pallas TPU kernel behind _pallas_g_panel, complexpair=True).
//
// What it computes, per matrix of the batch: G := the (n, width) input
// panel, whose row i is the complex vector g_i packed as its real half then
// its imaginary half (width = 2 * half-width); then sweeps of Brent-Luk
// round-robin row-pair rotations that orthogonalise the rows of G under
// the hermitian inner product.  One pair (p, q): gamma = <g_p, g_q> by two
// reductions (re = rp.rq + ip.iq, im = rp.iq - ip.rq); the bottom row is
// phase-aligned, g_q <- exp(-i arg gamma) g_q (the identity where |gamma| is
// at the floor), so that the pair's inner product becomes the real |gamma|
// and the rotation itself is real and applies to both planes in the tau
// form (rot4), c = 1/sqrtf(1 + t^2) in IEEE rounding; the norms updated
// analytically with 2 c s |gamma|.  A pair that is already orthogonal (or
// zero, the live_thresh test) is left untouched, phase included.  A sweep
// is ceil((n-1)/6)*6 rounds; the norms are refreshed by a full reduction
// once per sweep; before the first sweep and after each one the hermitian
// gauge
//     max_{i<j} (re^2 + im^2) / max(|g_i|^2 |g_j|^2, 16 tiny)
// is measured in IEEE float32, and the loop runs while
// sweep < max_sweeps and gauge > tol^2.  Every matrix has its own exit and
// its own sweep count; rows never move (the tournament is a ring of
// players), so the output keeps the input's row order.
//
// What bounds it on the H100: as the real kernel (csrc/jacobi_sweep.cu),
// the latency of a round, not device memory (the panel is read once and
// written once): a sweep does ~5 n^2 width multiply-adds (two reductions,
// the phase and the rotation, on twice the real width) in ~n serial rounds,
// each of which reads and writes the whole panel in the memory that holds
// it and runs one pair's chain of divisions and square roots.
//
// Design, the cluster path (the real kernel's, csrc/jacobi_sweep.cu, on the
// machinery of csrc/jacobi_common.cuh; every panel whose slices fit shared
// memory; the host picks C, see ops/jacobi_eigh.py::sweep_cluster): one
// matrix is one thread-block cluster of C CTAs.  CTA
// `rank` holds all n rows of the same float4 columns [rank s4, (rank + 1) s4)
// of both planes, s4 = ceil(hw4 / C), in its own shared memory (a row's Re
// slice then its Im slice, at an odd row stride), so the pair's partial
// (re, im), its phase and its rotation all stay in the CTA.  A round:
//   1. groups of 8 threads (fewer where s4 < 8) each take a pair and its
//      partial (re, im) over the CTA's columns, reduce it with shuffles and
//      push both words with one st.async into part[r % 2][rank][pair] of
//      every CTA of the cluster, the 8 bytes counted on that CTA's mbarrier
//      for the round's parity;
//   2. every thread waits on its own CTA's mbarrier;
//   3. one thread a pair adds the C partials in rank order 0..C-1, so every
//      CTA forms the same |gamma|, phase, (c, s, tau), skip decision and
//      carried norms, bit for bit, and writes (s, tau, phase) for the round;
//      one CTA barrier;
//   4. the groups of step 1 phase-align and rotate their pairs' columns
//      (held in registers since step 1 where a round is one pass and a
//      thread holds at most 2 float4 of each plane of a row); one CTA
//      barrier, since the next round pairs rows that other threads rotated.
// Double-buffered partials need no other synchronisation (see the real
// kernel).  The gauge is tiled: over the CTA's columns, each output tile
// holds two partial planes, the Re of the Gram matrix (Rr Rr^T + Ri Ri^T)
// and its Im (Rr Ri^T - Ri Rr^T), of IEEE float32 FMAs, the diagonal tiles
// first (their Re diagonals, summed in rank order by every CTA, are the
// refreshed norms), then the strict upper tiles; after a cluster barrier
// each CTA takes a C-th of every tile's entries, sums both planes' C
// partials in rank order and keeps the max of (re^2 + im^2) / max(n_i n_j,
// 16 tiny); the tiles share one area of shared memory with the partials,
// double-buffered where two fit (one cluster barrier a tile), else one
// (two).  No CTA leaves while another may read its shared memory or push
// into it: the kernel ends with a cluster barrier after the last remote
// access, and every CTA takes the exit decision from the same rank-ordered
// sums.
//
// The cluster sizes are 1, 2, 3, 4, 8 and 16.  Config 2's 64 panels of
// 512 KB are 32 MB, more than the card's 132 x 227 KB of shared memory, so
// no design holds the batch in one wave: on clusters of 4 (135 KB slices)
// the card holds 30 matrices at once, three waves; on clusters of 3 (184
// KB slices, the gauge's tile single-buffered to fit) 39, two waves, and
// the batch is faster though each matrix is slower.  CTAs of 512 threads,
// two an SM, were slower at every batch measured (PERF.md, section 6, row 5).
//
// The device-memory path (a panel whose slices no cluster holds, such as
// n = 768 at half-width 768, or asked for with cluster = 0): one block of
// 16 warps a matrix working in the output buffer; a warp owns a pair for a
// round and keeps both rows in registers for half-widths up to 512; one
// __syncthreads a round; the gauge on the upper triangle, a warp keeping row
// i in registers and taking the two reductions against every row j > i.
#include "jacobi_common.cuh"

namespace {

// A packed row as one lane sees it: NV float4 values of each half in
// registers (NV = 0: nothing cached, the row is read again where needed).
template <int NV>
struct CRow {
  float4 re[NV > 0 ? NV : 1];
  float4 im[NV > 0 ? NV : 1];
};

template <int NV>
__device__ __forceinline__ void load_row(const float4* p, int hw4, int lane,
                                         CRow<NV>& r) {
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = lane + 32 * k;
      const bool in = idx < hw4;
      r.re[k] = in ? p[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
      r.im[k] = in ? p[hw4 + idx] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// one lane's share of <x, y> = sum conj-paired products: re += xr.yr + xi.yi,
// im += xr.yi - xi.yr
__device__ __forceinline__ void herm4(const float4& xr, const float4& xi,
                                      const float4& yr, const float4& yi,
                                      float& re, float& im) {
  re += dot4(xr, yr) + dot4(xi, yi);
  im += dot4(xr, yi) - dot4(xi, yr);
}

// <row, q> over the whole warp; `row` is p's cached copy (NV > 0) or p is
// read again (NV = 0).  Every lane returns the same sums.
template <int NV>
__device__ __forceinline__ void herm_row(const CRow<NV>& row, const float4* p,
                                         const float4* q, int hw4, int lane,
                                         float& re, float& im) {
  float ar = 0.f, ai = 0.f;
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = lane + 32 * k;
      if (idx < hw4) herm4(row.re[k], row.im[k], q[idx], q[hw4 + idx], ar, ai);
    }
  } else {
    for (int idx = lane; idx < hw4; idx += 32)
      herm4(p[idx], p[hw4 + idx], q[idx], q[hw4 + idx], ar, ai);
  }
  re = warp_sum(ar);
  im = warp_sum(ai);
}

// gamma = <p, q>, keeping both rows in registers when NV > 0
template <int NV>
__device__ __forceinline__ void pair_dot(const float4* p, const float4* q, int hw4,
                                         int lane, CRow<NV>& rp, CRow<NV>& rq,
                                         float& re, float& im) {
  float ar = 0.f, ai = 0.f;
  if constexpr (NV > 0) {
    load_row<NV>(p, hw4, lane, rp);
    load_row<NV>(q, hw4, lane, rq);
#pragma unroll
    for (int k = 0; k < NV; ++k) herm4(rp.re[k], rp.im[k], rq.re[k], rq.im[k], ar, ai);
  } else {
    for (int idx = lane; idx < hw4; idx += 32)
      herm4(p[idx], p[hw4 + idx], q[idx], q[hw4 + idx], ar, ai);
  }
  re = warp_sum(ar);
  im = warp_sum(ai);
}

// a x + b y, componentwise
__device__ __forceinline__ float4 axpby(float a, const float4& x, float b,
                                        const float4& y) {
  return make_float4(a * x.x + b * y.x, a * x.y + b * y.y, a * x.z + b * y.z,
                     a * x.w + b * y.w);
}

// phase-align q by (ph_c, ph_s) = exp(-i arg gamma) and rotate the pair:
// one float4 of each half of each row (the real rotation is rot4 of
// jacobi_common.cuh, in the tau form that never rounds 1 - c away)
__device__ __forceinline__ void rot_pair4(float4* p, float4* q, int hw4, int idx,
                                          const float4& xr, const float4& xi,
                                          const float4& yr, const float4& yi,
                                          float ph_c, float ph_s, float s,
                                          float tau) {
  const float4 qr = axpby(ph_c, yr, ph_s, yi);
  const float4 qi = axpby(ph_c, yi, -ph_s, yr);
  float4 np, nq;
  rot4(xr, qr, s, tau, np, nq);
  p[idx] = np;
  q[idx] = nq;
  rot4(xi, qi, s, tau, np, nq);
  p[hw4 + idx] = np;
  q[hw4 + idx] = nq;
}

template <int NV>
__device__ __forceinline__ void rotate(float4* p, float4* q, int hw4, int lane,
                                       const CRow<NV>& rp, const CRow<NV>& rq,
                                       float ph_c, float ph_s, float s, float tau) {
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = lane + 32 * k;
      if (idx < hw4)
        rot_pair4(p, q, hw4, idx, rp.re[k], rp.im[k], rq.re[k], rq.im[k], ph_c,
                  ph_s, s, tau);
    }
  } else {
    for (int idx = lane; idx < hw4; idx += 32)
      rot_pair4(p, q, hw4, idx, p[idx], p[hw4 + idx], q[idx], q[hw4 + idx], ph_c,
                ph_s, s, tau);
  }
}

// One pair's coefficients from its gamma = (re, im) and carried norms
// (a, b), in the order of the reference: false where the pair is already
// orthogonal (or zero); else the rotation's s and tau = s / (1 + c), the
// phase (ph_c, ph_s) = exp(-i arg gamma) (the identity where |gamma| is at
// the floor: dividing by a floored |gamma| would zero the bottom row), and
// the pair's new norms (na, nb)
__device__ __forceinline__ bool pair_coefficients(float re, float im, float a, float b,
                                                  float live_thresh, float& s, float& tau,
                                                  float& ph_c, float& ph_s, float& na,
                                                  float& nb) {
  const float gam2 = re * re + im * im;
  const float ratio = gam2 / fmaxf(a * b, kEpsFloor);
  if (!(ratio > live_thresh)) return false;
  const float gam = sqrtf(gam2);
  const bool safe = gam > kEpsFloor;
  const float inv = 1.0f / fmaxf(gam, kEpsFloor);
  ph_c = safe ? re * inv : 1.0f;
  ph_s = safe ? im * inv : 0.0f;
  const float zeta = (b - a) / (2.0f * gam);
  const float t = (zeta >= 0.f ? 1.0f : -1.0f) / (fabsf(zeta) + sqrtf(1.0f + zeta * zeta));
  // 1/sqrt in IEEE rounding, not the approximate rsqrtf
  const float c = 1.0f / sqrtf(1.0f + t * t);
  s = c * t;
  tau = s / (1.0f + c);
  const float cs2 = 2.0f * c * s * gam;
  na = c * c * a + s * s * b - cs2;
  nb = s * s * a + c * c * b + cs2;
  return true;
}

// |g_i|^2 = sum of squares over the whole packed row
__device__ __forceinline__ void refresh_norms(const float4* G, float* nrm, int n,
                                              int w4, int warp, int lane) {
  for (int i = warp; i < n; i += kWarps) {
    const float4* row = G + (size_t)i * w4;
    float acc = 0.f;
    for (int idx = lane; idx < w4; idx += 32) acc += dot4(row[idx], row[idx]);
    acc = warp_sum(acc);
    if (lane == 0) nrm[i] = acc;
  }
}

// max over i < j of |<g_i, g_j>|^2 / max(n_i n_j, floor); every thread of
// the block returns the same value
template <int NV>
__device__ __forceinline__ float gauge(const float4* G, const float* nrm,
                                       float* red, int n, int hw4, int warp,
                                       int lane) {
  const int w4 = 2 * hw4;
  float worst = 0.f;
  for (int i = warp; i < n - 1; i += kWarps) {
    const float ni = nrm[i];
    if (ni == 0.f) continue;  // a zero row: every product with it is exactly 0
    const float4* row = G + (size_t)i * w4;
    CRow<NV> r;
    load_row<NV>(row, hw4, lane, r);
    for (int j = i + 1; j < n; ++j) {
      const float nj = nrm[j];
      if (nj == 0.f) continue;
      float re, im;
      herm_row<NV>(r, row, G + (size_t)j * w4, hw4, lane, re, im);
      worst = fmaxf(worst, (re * re + im * im) / fmaxf(ni * nj, kEpsFloor));
    }
  }
  if (lane == 0) red[warp] = worst;
  __syncthreads();
  float m = 0.f;
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();  // red is written again by the next gauge
  return m;
}

template <int NV>
__global__ void __launch_bounds__(kThreads)
jacobi_sweep_complex_kernel(const float* __restrict__ a_g, float* g_g,
                            int* sweeps_g, float* gauge_g, int* rot_g, int n,
                            int width, int max_sweeps, float tol2,
                            float live_thresh) {
  __shared__ float nrm[kMaxN];
  __shared__ float red[kWarps];
  __shared__ int rotations;  // pairs rotated so far (skipped pairs not counted)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = n / 2;
  const int m = n - 1;  // length of the ring
  const int w4 = width / 4;
  const int hw4 = w4 / 2;
  const size_t count = (size_t)n * w4;
  const float4* src = reinterpret_cast<const float4*>(a_g) + blockIdx.x * count;
  float4* G = reinterpret_cast<float4*>(g_g) + blockIdx.x * count;

  for (size_t i = tid; i < count; i += kThreads) G[i] = src[i];
  if (tid == 0) rotations = 0;
  __syncthreads();

  refresh_norms(G, nrm, n, w4, warp, lane);
  __syncthreads();
  float worst = gauge<NV>(G, nrm, red, n, hw4, warp, lane);

  const int rounds = (m + kUnroll - 1) / kUnroll * kUnroll;
  int shift = 0;  // rounds played so far, modulo the ring length
  int sweep = 0;
  while (sweep < max_sweeps && worst > tol2) {
    for (int r = 0; r < rounds; ++r) {
      for (int i = warp; i < h; i += kWarps) {
        const int pi = pair_top(i, shift, h, n, m);
        const int qi = pair_bot(i, shift, h, n, m);
        float4* p = G + (size_t)pi * w4;
        float4* q = G + (size_t)qi * w4;
        CRow<NV> rp, rq;
        float g_re, g_im;
        pair_dot<NV>(p, q, hw4, lane, rp, rq, g_re, g_im);
        const float a = nrm[pi];
        const float b = nrm[qi];
        __syncwarp();  // every lane has read the norms before lane 0 rewrites them
        float s, tau, ph_c, ph_s, na, nb;
        if (!pair_coefficients(g_re, g_im, a, b, live_thresh, s, tau, ph_c, ph_s, na, nb))
          continue;  // already orthogonal, or zero
        rotate<NV>(p, q, hw4, lane, rp, rq, ph_c, ph_s, s, tau);
        if (lane == 0) {
          nrm[pi] = na;
          nrm[qi] = nb;
          atomicAdd(&rotations, 1);
        }
      }
      __syncthreads();  // the next round pairs rows other warps just wrote
      shift = shift + 1 == m ? 0 : shift + 1;
    }
    ++sweep;
    refresh_norms(G, nrm, n, w4, warp, lane);
    __syncthreads();
    worst = gauge<NV>(G, nrm, red, n, hw4, warp, lane);
  }

  if (tid == 0) {
    sweeps_g[blockIdx.x] = sweep;
    gauge_g[blockIdx.x] = worst;
    rot_g[blockIdx.x] = rotations;
  }
}

template <int NV>
cudaError_t launch_device_memory(const float* a, float* g, int* sweeps, float* gauge_out,
                                 int* rot, int B, int n, int width, int max_sweeps,
                                 float tol2, float live_thresh, cudaStream_t stream) {
  jacobi_sweep_complex_kernel<NV><<<B, kThreads, 0, stream>>>(
      a, g, sweeps, gauge_out, rot, n, width, max_sweeps, tol2, live_thresh);
  return cudaGetLastError();
}

// =============================== cluster path ===============================

constexpr int kCThreads = 1024;
constexpr int kTile = 64;  // gauge tiles of kTile x kTile outputs
// words after the slice, the shared area, the norms and the coefficients:
// two mbarriers, the per-warp maxima, this CTA's max and the rotation count
constexpr int kMisc = 64;
// float4 of each plane of a row a thread keeps in registers from the pair
// dots to the rotation (both planes of both rows: 4 kKeep float4)
constexpr int kKeep = 2;

// The shared area of a CTA: `bufs` buffers of the gauge's tile of two
// planes, or (in the rounds) the pair partials (re, im) received from every
// rank, part[2][C][n/2][2]
__host__ __device__ __forceinline__ int complex_area(int n, int C, int bufs) {
  return 2 * bufs * kTile * kTile > 2 * C * n ? 2 * bufs * kTile * kTile : 2 * C * n;
}

// dynamic shared memory of one CTA: the slice (n x slice_stride(2 s4)
// float4, both planes), the shared area, the carried norms (n), the round's
// coefficients (4 x n/2: s, tau and the phase) and kMisc words.
// ops/jacobi_eigh.py::cluster_smem_bytes(complexpair=True) is the same
// formula with one tile buffer, the least the kernel takes.
__host__ __device__ __forceinline__ size_t complex_smem_bytes(int n, int hw4, int C,
                                                              int bufs) {
  return (size_t)n * slice_stride(2 * slice_w4(hw4, C)) * sizeof(float4) +
         (size_t)(complex_area(n, C, bufs) + 3 * n + kMisc) * sizeof(float);
}

// The gauge's tile buffers: two (one cluster barrier a tile) where they fit
// the shared memory a block may opt in to, else one (two barriers a tile;
// the same bits): config 2's clusters of 3 fit only with one
int tile_buffers(int n, int hw4, int C) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 1;
  return complex_smem_bytes(n, hw4, C, 2) <= (size_t)limit ? 2 : 1;
}

__host__ __device__ __forceinline__ bool complex_keeps_rows(int n, int hw4, int C) {
  const int s4 = slice_w4(hw4, C), tpp = pair_threads(s4);
  return n / 2 <= kCThreads / tpp && s4 <= kKeep * tpp;
}

// re += xr.yr + xi.yi, im += xr.yi - xi.yr over one float4 of each plane
__device__ __forceinline__ void herm_fma(const float4& xr, const float4& xi,
                                         const float4& yr, const float4& yi, float& re,
                                         float& im) {
  re = fmaf(xr.x, yr.x, re); re = fmaf(xr.y, yr.y, re);
  re = fmaf(xr.z, yr.z, re); re = fmaf(xr.w, yr.w, re);
  re = fmaf(xi.x, yi.x, re); re = fmaf(xi.y, yi.y, re);
  re = fmaf(xi.z, yi.z, re); re = fmaf(xi.w, yi.w, re);
  im = fmaf(xr.x, yi.x, im); im = fmaf(xr.y, yi.y, im);
  im = fmaf(xr.z, yi.z, im); im = fmaf(xr.w, yi.w, im);
  im = fmaf(-xi.x, yr.x, im); im = fmaf(-xi.y, yr.y, im);
  im = fmaf(-xi.z, yr.z, im); im = fmaf(-xi.w, yr.w, im);
}

// phase-align y by (ph_c, ph_s) and rotate the pair (x, y), one float4 of
// each plane: x's planes to (pr, pi), y's to (qr, qi) (the inputs are
// copies, so the outputs may be where they were read from)
__device__ __forceinline__ void phase_rot4(float4 xr, float4 xi, float4 yr, float4 yi,
                                           float ph_c, float ph_s, float s, float tau,
                                           float4& pr, float4& pi, float4& qr, float4& qi) {
  const float4 ar = axpby(ph_c, yr, ph_s, yi);
  const float4 ai = axpby(ph_c, yi, -ph_s, yr);
  rot4(xr, ar, s, tau, pr, qr);
  rot4(xi, ai, s, tau, pi, qi);
}

// The hermitian gauge and the refreshed norms of the panel held by the
// cluster; every thread of every CTA returns the same value.  S: this
// CTA's slice (a row: s4 float4 of Re, then s4 of Im, at stride sp).
template <int C>
__device__ float complex_cluster_gauge(const float4* S, int n, int s4, int sp, float* tiles,
                                       int bufs, float* nrm, float* red, float* gmax,
                                       unsigned rank, int tid) {
  constexpr int kT = kTile;
  constexpr int TY = kCThreads / 32;  // rows of threads
  constexpr int RM = kT / TY;         // output rows a thread
  constexpr int CN = kT / 32;         // output columns a thread
  constexpr int share = (kT * kT + C - 1) / C;  // entries of a tile a CTA sums
  const int ty = tid >> 5, tx = tid & 31;
  const int T = (n + kT - 1) / kT;
  const int steps = T * (T + 1) / 2;
  float worst = 0.f;
  for (int t = 0; t < steps; ++t) {
    // tile t: the T diagonal tiles first, then the strict upper ones by rows
    int I = t, J = t;
    if (t >= T) {
      int u = t - T;
      I = 0;
      while (u >= T - 1 - I) {
        u -= T - 1 - I;
        ++I;
      }
      J = I + 1 + u;
    }
    const int i0 = I * kT, j0 = J * kT;
    float* b_re = tiles + (bufs == 2 ? t & 1 : 0) * 2 * kT * kT;
    float* b_im = b_re + kT * kT;
    // one buffer: every CTA has read the last tile's partials before any
    // writes this one's (two: the cluster barrier of the tile between)
    if (bufs == 1 && t > 0) cluster_sync();
    {
      // this CTA's partial tile: rows i0 + ty + r TY, columns j0 + tx + c 32;
      // rows past n read row n - 1 and are never used
      const float4* a[RM];
      const float4* b[CN];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = S + (size_t)min(i0 + ty + r * TY, n - 1) * sp;
#pragma unroll
      for (int c = 0; c < CN; ++c) b[c] = S + (size_t)min(j0 + tx + c * 32, n - 1) * sp;
      float re[RM][CN], im[RM][CN];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < CN; ++c) re[r][c] = im[r][c] = 0.f;
      for (int k = 0; k < s4; ++k) {
        float4 yr[CN], yi[CN];
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          yr[c] = b[c][k];
          yi[c] = b[c][s4 + k];
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float4 xr = a[r][k], xi = a[r][s4 + k];
#pragma unroll
          for (int c = 0; c < CN; ++c) herm_fma(xr, xi, yr[c], yi[c], re[r][c], im[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          const int e = (ty + r * TY) * kT + tx + c * 32;
          b_re[e] = re[r][c];
          b_im[e] = im[r][c];
        }
    }
    cluster_sync();
    if (I == J) {
      // every CTA sums the Re diagonal itself: the refreshed norms
      if (tid < kT && i0 + tid < n) nrm[i0 + tid] = cluster_sum<C>(b_re + tid * (kT + 1));
      __syncthreads();
    }
    const int e_end = min((int)(rank + 1) * share, kT * kT);
    for (int e = rank * share + tid; e < e_end; e += kCThreads) {
      const int a = e / kT, b = e % kT;
      const int i = i0 + a, j = j0 + b;
      if (i < n && j < n && (I != J || a < b)) {
        const float re = cluster_sum<C>(b_re + e), im = cluster_sum<C>(b_im + e);
        worst = fmaxf(worst, (re * re + im * im) / fmaxf(nrm[i] * nrm[j], kEpsFloor));
      }
    }
  }
  worst = warp_max(worst);
  if ((tid & 31) == 0) red[tid >> 5] = worst;
  __syncthreads();
  if (tid == 0) {
    float m = 0.f;
    for (int w = 0; w < kCThreads / 32; ++w) m = fmaxf(m, red[w]);
    *gmax = m;
  }
  cluster_sync();
  return cluster_max<C>(gmax);
}

// KEEP (complex_keeps_rows): the thread's columns of its pair stay in
// registers from step 1 to step 4, so a round reads the slice once and
// writes it once
template <int C, bool KEEP>
__global__ void __launch_bounds__(kCThreads, 1)
jacobi_sweep_complex_cluster_kernel(const float* __restrict__ a_g, float* g_g,
                                    int* sweeps_g, float* gauge_g, int* rot_g, int n,
                                    int hw4, int max_sweeps, float tol2,
                                    float live_thresh, int bufs) {
  extern __shared__ float4 smem4[];
  const int s4 = slice_w4(hw4, C);
  const int sp = slice_stride(2 * s4);
  const int h = n / 2;
  const int m = n - 1;  // length of the ring
  float4* S = smem4;
  float* area = reinterpret_cast<float*>(S + (size_t)n * sp);
  float* nrm = area + complex_area(n, C, bufs);
  float* coef_s = nrm + n;       // the round's s of each pair
  float* coef_tau = coef_s + h;  // tau = s / (1 + c)
  float* coef_pc = coef_tau + h;  // the phase exp(-i arg gamma)
  float* coef_ps = coef_pc + h;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(coef_ps + h);
  float* red = coef_ps + h + 4;
  float* gmax = red + kCThreads / 32;
  int* rotations = reinterpret_cast<int*>(gmax + 1);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const unsigned rank = cluster_rank();
  const size_t mat = blockIdx.x / C;
  const int w4 = 2 * hw4;
  const int c0 = (int)rank * s4;                 // first column held, in each plane
  const int cw = max(0, min(s4, hw4 - c0));      // columns held (the rest zero)
  const float4* src = reinterpret_cast<const float4*>(a_g) + mat * n * w4;
  float4* out = reinterpret_cast<float4*>(g_g) + mat * n * w4;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < n * s4; e += kCThreads) {
    const int i = e / s4, k = e - i * s4;
    S[(size_t)i * sp + k] = k < cw ? src[(size_t)i * w4 + c0 + k] : zero;
    S[(size_t)i * sp + s4 + k] = k < cw ? src[(size_t)i * w4 + hw4 + c0 + k] : zero;
  }
  if (tid == 0) {
    *rotations = 0;
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // its cluster barriers also make the mbarriers' inits visible to every
  // CTA before the first push
  float worst = complex_cluster_gauge<C>(S, n, s4, sp, area, bufs, nrm, red, gmax, rank, tid);

  // the vector work of a round: a group of tpp threads a pair, thread
  // `sub` taking columns sub, sub + tpp, ... of each plane; group `grp`
  // takes pairs grp, grp + groups, ...
  const int tpp = pair_threads(s4);
  const int groups = kCThreads / tpp;
  const int grp = tid / tpp;
  const int sub = tid & (tpp - 1);
  const int passes = (h + groups - 1) / groups;  // the same in every warp
  const int rounds = (m + kUnroll - 1) / kUnroll * kUnroll;
  const unsigned bytes = (unsigned)(C * h * 2 * sizeof(float));
  int nrot = 0;        // pairs this thread found live (step 3)
  int shift = 0;       // rounds played so far, modulo the ring length
  unsigned phase = 0;  // rounds played in all sweeps: part and bar[phase & 1]
  int sweep = 0;
  constexpr int kK = KEEP ? kKeep : 1;
  float4 kpr[kK], kpi[kK], kqr[kK], kqi[kK];  // the kept columns
  while (sweep < max_sweeps && worst > tol2) {
    for (int r = 0; r < rounds; ++r, ++phase) {
      const int par = phase & 1;
      float* part = area + par * 2 * C * h;
      if (tid == 0) mbar_expect(bar + par, bytes);
      // ---- 1. the partial gamma of each pair pv over this CTA's columns,
      // pushed into part[par][rank][pv] of every rank ----
      for (int k = 0; k < passes; ++k) {
        const int pv = grp + k * groups;
        float re = 0.f, im = 0.f;
        if (pv < h) {
          const float4* p = S + (size_t)pair_top(pv, shift, h, n, m) * sp;
          const float4* q = S + (size_t)pair_bot(pv, shift, h, n, m) * sp;
          if constexpr (KEEP) {
#pragma unroll
            for (int j = 0; j < kKeep; ++j) {
              const int x = sub + j * tpp;
              if (x < s4) {
                kpr[j] = p[x];
                kpi[j] = p[s4 + x];
                kqr[j] = q[x];
                kqi[j] = q[s4 + x];
                herm_fma(kpr[j], kpi[j], kqr[j], kqi[j], re, im);
              }
            }
          } else {
            for (int x = sub; x < s4; x += tpp) herm_fma(p[x], p[s4 + x], q[x], q[s4 + x], re, im);
          }
        }
        for (int o = tpp >> 1; o > 0; o >>= 1) {
          re += __shfl_xor_sync(0xffffffffu, re, o);
          im += __shfl_xor_sync(0xffffffffu, im, o);
        }
        if (pv < h) {
          const unsigned a = smem_u32(part + 2 * (rank * h + pv));
          const unsigned b = smem_u32(bar + par);
          for (int d = sub; d < C; d += tpp) push_pair(cluster_map(a, d), re, im, cluster_map(b, d));
        }
      }
      // ---- 2. every rank's partials have arrived ----
      mbar_wait(bar + par, (phase >> 1) & 1);
      // ---- 3. one thread a pair: gamma in rank order, the phase, the
      // rotation's coefficients and the carried norms ----
      for (int pv = tid; pv < h; pv += kCThreads) {
        float re = part[2 * pv], im = part[2 * pv + 1];
#pragma unroll
        for (int rr = 1; rr < C; ++rr) {
          re += part[2 * (rr * h + pv)];
          im += part[2 * (rr * h + pv) + 1];
        }
        const int pi = pair_top(pv, shift, h, n, m);
        const int qi = pair_bot(pv, shift, h, n, m);
        float s = 0.f, tau = 0.f, ph_c = 1.f, ph_s = 0.f, na, nb;
        if (pair_coefficients(re, im, nrm[pi], nrm[qi], live_thresh, s, tau, ph_c, ph_s, na,
                              nb)) {
          nrm[pi] = na;
          nrm[qi] = nb;
          ++nrot;
        }
        coef_s[pv] = s;
        coef_tau[pv] = tau;
        coef_pc[pv] = ph_c;
        coef_ps[pv] = ph_s;
      }
      __syncthreads();
      // ---- 4. the phase and the rotation of this CTA's columns, skipped
      // where both are the identity (s = 0 and the phase 1) ----
      for (int pv = grp; pv < h; pv += groups) {
        const float s = coef_s[pv], ph_c = coef_pc[pv], ph_s = coef_ps[pv];
        if (s != 0.f || ph_s != 0.f || ph_c != 1.f) {
          const float tau = coef_tau[pv];
          float4* p = S + (size_t)pair_top(pv, shift, h, n, m) * sp;
          float4* q = S + (size_t)pair_bot(pv, shift, h, n, m) * sp;
          if constexpr (KEEP) {
#pragma unroll
            for (int j = 0; j < kKeep; ++j) {
              const int x = sub + j * tpp;
              if (x < s4)
                phase_rot4(kpr[j], kpi[j], kqr[j], kqi[j], ph_c, ph_s, s, tau, p[x],
                           p[s4 + x], q[x], q[s4 + x]);
            }
          } else {
            for (int x = sub; x < s4; x += tpp)
              phase_rot4(p[x], p[s4 + x], q[x], q[s4 + x], ph_c, ph_s, s, tau, p[x],
                         p[s4 + x], q[x], q[s4 + x]);
          }
        }
      }
      // ---- 5. the next round pairs rows that other threads just rotated ----
      __syncthreads();
      shift = shift + 1 == m ? 0 : shift + 1;
    }
    ++sweep;
    worst = complex_cluster_gauge<C>(S, n, s4, sp, area, bufs, nrm, red, gmax, rank, tid);
  }

  // every CTA's last remote read (the gauge's maximum) is behind this
  // barrier: no CTA leaves while another may still read its shared memory
  cluster_sync();
  for (int e = tid; e < n * cw; e += kCThreads) {
    const int i = e / cw, k = e - i * cw;
    out[(size_t)i * w4 + c0 + k] = S[(size_t)i * sp + k];
    out[(size_t)i * w4 + hw4 + c0 + k] = S[(size_t)i * sp + s4 + k];
  }
  nrot = __reduce_add_sync(0xffffffffu, nrot);
  if (lane == 0 && nrot) atomicAdd(rotations, nrot);
  __syncthreads();
  if (rank == 0 && tid == 0) {
    sweeps_g[mat] = sweep;
    gauge_g[mat] = worst;
    rot_g[mat] = *rotations;
  }
}

template <int C, bool KEEP>
cudaError_t launch_cluster_as(const float* a, float* g, int* sweeps, float* gauge_out,
                              int* rot, int B, int n, int hw4, int max_sweeps, float tol2,
                              float live_thresh, cudaStream_t stream) {
  const int bufs = tile_buffers(n, hw4, C);
  const size_t smem = complex_smem_bytes(n, hw4, C, bufs);
  cudaError_t e = cluster_attributes(jacobi_sweep_complex_cluster_kernel<C, KEEP>, C, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(C, B, kCThreads, smem, stream, attr);
  e = cudaLaunchKernelEx(&cfg, jacobi_sweep_complex_cluster_kernel<C, KEEP>, a, g, sweeps,
                         gauge_out, rot, n, hw4, max_sweeps, tol2, live_thresh, bufs);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_cluster(const float* a, float* g, int* sweeps, float* gauge_out, int* rot,
                           int B, int n, int hw4, int max_sweeps, float tol2,
                           float live_thresh, cudaStream_t stream) {
  if (complex_keeps_rows(n, hw4, C))
    return launch_cluster_as<C, true>(a, g, sweeps, gauge_out, rot, B, n, hw4, max_sweeps,
                                      tol2, live_thresh, stream);
  return launch_cluster_as<C, false>(a, g, sweeps, gauge_out, rot, B, n, hw4, max_sweeps,
                                     tol2, live_thresh, stream);
}

template <int C>
cudaError_t active_clusters(int n, int hw4, int* out) {
  const size_t smem = complex_smem_bytes(n, hw4, C, tile_buffers(n, hw4, C));
  if (complex_keeps_rows(n, hw4, C))
    return active_clusters_of(jacobi_sweep_complex_cluster_kernel<C, true>, C, kCThreads,
                              smem, out);
  return active_clusters_of(jacobi_sweep_complex_cluster_kernel<C, false>, C, kCThreads, smem,
                            out);
}

bool valid(int n, int width, int cluster) {
  return n >= 2 && !(n & 1) && n <= kMaxN && width >= 8 && !(width & 7) &&
         (cluster == 0 || cluster == 1 || cluster == 2 || cluster == 3 || cluster == 4 ||
          cluster == 8 || cluster == 16);
}

}  // namespace

// Plain C entries for ctypes.  a, g: (B, n, width) contiguous f32 on the
// device, distinct buffers; a row is [Re | Im], each half width / 2 floats
// and a multiple of 4, so width is a multiple of 8; n even and <= 1024.
// sweeps (B,) int32, gauge (B,) f32 and rot (B,) int32 receive each matrix's
// executed sweep count, last measured gauge and number of pairs rotated.
// cluster: C (1, 2, 3, 4, 8 or 16) CTAs a matrix on the cluster path,
// whose slices must fit the shared memory a block may opt in to
// (complex_smem_bytes with one tile buffer), or 0 for the device-memory
// path.  Returns a cudaError_t (0 on success); a cluster launch the card
// refuses returns its error.
extern "C" int jacobi_sweep_c32(const float* a, float* g, int* sweeps, float* gauge_out,
                                int* rot, int B, int n, int width, int max_sweeps,
                                float tol2, float live_thresh, int cluster, void* stream) {
  if (B <= 0 || !valid(n, width, cluster) || max_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int hw4 = width / 8;  // float4 of a half
  switch (cluster) {
    case 1: return (int)launch_cluster<1>(a, g, sweeps, gauge_out, rot, B, n, hw4, max_sweeps, tol2, live_thresh, s);
    case 2: return (int)launch_cluster<2>(a, g, sweeps, gauge_out, rot, B, n, hw4, max_sweeps, tol2, live_thresh, s);
    case 3: return (int)launch_cluster<3>(a, g, sweeps, gauge_out, rot, B, n, hw4, max_sweeps, tol2, live_thresh, s);
    case 4: return (int)launch_cluster<4>(a, g, sweeps, gauge_out, rot, B, n, hw4, max_sweeps, tol2, live_thresh, s);
    case 8: return (int)launch_cluster<8>(a, g, sweeps, gauge_out, rot, B, n, hw4, max_sweeps, tol2, live_thresh, s);
    case 16: return (int)launch_cluster<16>(a, g, sweeps, gauge_out, rot, B, n, hw4, max_sweeps, tol2, live_thresh, s);
    default: break;
  }
  const int nv = (hw4 + 31) / 32;  // float4 values of a half a lane
  cudaError_t e;
  if (nv <= 1)
    e = launch_device_memory<1>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2,
                                live_thresh, s);
  else if (nv <= 2)
    e = launch_device_memory<2>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2,
                                live_thresh, s);
  else if (nv <= 4)
    e = launch_device_memory<4>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2,
                                live_thresh, s);
  else
    e = launch_device_memory<0>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2,
                                live_thresh, s);
  return (int)e;
}

// How many clusters of `cluster` CTAs of the cluster path the card holds at
// once for an (n, width) panel (cudaOccupancyMaxActiveClusters), into *out;
// 0 means it cannot schedule one.  Returns a cudaError_t.
extern "C" int jacobi_sweep_c32_clusters(int n, int width, int cluster, int* out) {
  if (!valid(n, width, cluster) || cluster == 0) return (int)cudaErrorInvalidValue;
  const int hw4 = width / 8;
  switch (cluster) {
    case 1: return (int)active_clusters<1>(n, hw4, out);
    case 2: return (int)active_clusters<2>(n, hw4, out);
    case 3: return (int)active_clusters<3>(n, hw4, out);
    case 4: return (int)active_clusters<4>(n, hw4, out);
    case 8: return (int)active_clusters<8>(n, hw4, out);
    default: return (int)active_clusters<16>(n, hw4, out);
  }
}
