// Batched one-sided (Hestenes) Jacobi sweeps on a row panel G^T.
//
// Replaces: xitorch_tpu/ops/jacobi_eigh.py::_jacobi_kernel (the Pallas TPU
// kernel behind _pallas_g_panel, complexpair=False).
//
// What it computes, per matrix of the batch: G := the (n, width) input
// panel; then sweeps of Brent-Luk round-robin row-pair rotations that
// orthogonalise the rows of G, with the squared row norms carried through
// every rotation analytically and refreshed by a full reduction once per
// sweep; before the first sweep and after each one the gauge
//     max_{i<j} <g_i, g_j>^2 / max(|g_i|^2 |g_j|^2, 16 tiny)
// is measured in IEEE float32, and the loop runs while
// sweep < max_sweeps and gauge > tol^2.  A panel that is already
// orthogonal leaves with zero sweeps.  Every matrix has its own exit and
// its own sweep count.  Rows never move: the tournament is a ring of
// players, and which row sits in which seat in round r is computed from r,
// so the output keeps the input's row order.  A pair (p, q): gamma =
// <g_p, g_q>, (c, s) from the carried norms as the reference forms them
// (c = 1/sqrt(1 + t^2) in IEEE rounding, s = c t), the pair skipped when
// it is already orthogonal, else both rows rotated in the form that never
// rounds 1 - c away (rot4) and the two norms updated.
//
// What bounds it on the H100: a sweep rotates each of the n/2 pairs in
// each of its ~n rounds, touching the whole panel once per round (~2 n^2
// width floats through the memory that holds the panel, ~3 n^2 width
// multiply-adds), and the rounds are serial.  The input is read once and
// the output written once, so device memory is not the limit: the latency
// of a round is (~2,300 rounds a matrix at n = 256), and within it the
// shared-memory traffic of the slice, the exchange between the CTAs and
// the divisions and square roots of one pair's rotation.
//
// Design, the cluster path (every panel whose column slices fit shared
// memory; the host picks C, see ops/jacobi_eigh.py::sweep_cluster): one
// matrix is one thread-block cluster of C = 1, 2, 4, 8 or 16 CTAs of 32
// warps.  CTA `rank` holds all n rows of float4 columns
// [rank s4, (rank + 1) s4), s4 = ceil(w4 / C), in its own shared memory,
// so no round touches L2.  A round:
//   1. groups of 8 threads (fewer where s4 < 8) each take a pair and its
//      partial gamma over the CTA's columns (8 threads read 128 contiguous
//      bytes of a row), reduce it with shuffles and push it with st.async
//      into part[r % 2][rank][pair] of every CTA of the cluster, the bytes
//      counted on that CTA's mbarrier for the round's parity;
//   2. every thread waits on its own CTA's mbarrier: the C partials of
//      every pair have arrived (no fence at cluster scope: a cluster
//      barrier, whose arrive has release semantics, took ~0.7 us a round on
//      an NVIDIA H100 80GB HBM3 at 700 W);
//   3. one thread a pair adds the C partials in rank order 0..C-1, so
//      every CTA of the cluster forms the same gamma, the same (c, s, tau),
//      the same skip decision and the same carried norms, bit for bit, and
//      writes (s, tau) for the round (s = 0: not rotated); one CTA barrier;
//   4. the groups of step 1 rotate their pairs' columns (held in registers
//      since step 1 where a round is one pass and a thread holds 2 to 4
//      float4 of a row); one CTA barrier, since the next round pairs rows
//      that other threads rotated.
// Why double-buffered partials need no other synchronisation: CTA X pushes
// into part[r % 2] of CTA Y again in round r + 2, after it has waited in
// round r + 1 for Y's partials, which Y pushes only after its step 3 of
// round r, its last read of part[r % 2].  The gauge (below) and the
// partials share one area of shared memory: the gauge's cluster barriers
// separate the two uses in every CTA.  No CTA leaves while another may
// read its shared memory or push into it: the kernel ends with a cluster
// barrier after the last remote access, and the exit decision (sweep <
// max_sweeps and gauge > tol^2) is made from the same rank-ordered sums in
// every CTA, so all CTAs of a cluster take the same path.
// The gauge is tiled: G G^T over the CTA's columns in 64 x 64 output tiles
// of IEEE float32 FMAs (each of the 1,024 threads 2 x 2 outputs), the
// diagonal tiles first (their diagonals, summed in rank order by every CTA,
// are the refreshed norms), then the strict upper tiles; after a cluster
// barrier each CTA takes a C-th of every tile's entries, sums their C
// partials, read through distributed shared memory, in rank order and
// keeps the max of g^2 / max(n_i n_j, 16 tiny); the tiles are
// double-buffered (one cluster barrier a tile) and the C maxima are
// exchanged at the end.  The rotation count stays in registers, one
// atomic a warp.
//
// The device-memory path (a panel whose slices no cluster holds, such as
// n = 1024 at width 1024, or asked for with cluster = 0): one block of 16
// warps a matrix working in the output buffer (a batch of 64 panels of
// 256 KB is 16 MB, inside the 50 MB L2); a warp owns a pair for a round,
// loads both rows (held in registers for widths up to 1024), reduces gamma
// with shuffles, rotates and writes both rows back; one __syncthreads a
// round.  Its gauge takes the upper triangle row by row: a warp keeps row i
// in registers and dots it with every row j > i.
#include "jacobi_common.cuh"

namespace {

// ============================ device-memory path ============================


// A row of the panel as one lane sees it: NV float4 values in registers
// (NV = 0: nothing cached, the row is read again where it is needed).
template <int NV>
struct Row {
  float4 v[NV > 0 ? NV : 1];
};

template <int NV>
__device__ __forceinline__ void load_row(const float4* p, int w4, int lane,
                                         Row<NV>& r) {
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = lane + 32 * k;
      r.v[k] = idx < w4 ? p[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// <row, q> over the whole warp; `row` is p's cached copy (NV > 0) or p is
// read again (NV = 0).  Every lane returns the same sum.
template <int NV>
__device__ __forceinline__ float dot_row(const Row<NV>& row, const float4* p,
                                         const float4* q, int w4, int lane) {
  float acc = 0.f;
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = lane + 32 * k;
      if (idx < w4) acc += dot4(row.v[k], q[idx]);
    }
  } else {
    for (int idx = lane; idx < w4; idx += 32) acc += dot4(p[idx], q[idx]);
  }
  return warp_sum(acc);
}

// gamma = <p, q>, keeping both rows in registers when NV > 0
template <int NV>
__device__ __forceinline__ float pair_dot(const float4* p, const float4* q,
                                          int w4, int lane, Row<NV>& rp,
                                          Row<NV>& rq) {
  float acc = 0.f;
  if constexpr (NV > 0) {
    load_row<NV>(p, w4, lane, rp);
    load_row<NV>(q, w4, lane, rq);
#pragma unroll
    for (int k = 0; k < NV; ++k) acc += dot4(rp.v[k], rq.v[k]);
  } else {
    for (int idx = lane; idx < w4; idx += 32) acc += dot4(p[idx], q[idx]);
  }
  return warp_sum(acc);
}

// rotate the pair (p, q) in place
template <int NV>
__device__ __forceinline__ void rotate(float4* p, float4* q, int w4, int lane,
                                       const Row<NV>& rp, const Row<NV>& rq,
                                       float s, float tau) {
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int idx = lane + 32 * k;
      if (idx < w4) {
        float4 np, nq;
        rot4(rp.v[k], rq.v[k], s, tau, np, nq);
        p[idx] = np;
        q[idx] = nq;
      }
    }
  } else {
    for (int idx = lane; idx < w4; idx += 32) {
      float4 np, nq;
      rot4(p[idx], q[idx], s, tau, np, nq);
      p[idx] = np;
      q[idx] = nq;
    }
  }
}

template <int NV>
__device__ __forceinline__ void refresh_norms(const float4* G, float* nrm,
                                              int n, int w4, int warp,
                                              int lane) {
  for (int i = warp; i < n; i += kWarps) {
    const float4* row = G + (size_t)i * w4;
    Row<NV> r;
    load_row<NV>(row, w4, lane, r);
    const float s = dot_row<NV>(r, row, row, w4, lane);
    if (lane == 0) nrm[i] = s;
  }
}

// max over i < j of <g_i, g_j>^2 / max(n_i n_j, floor); every thread of
// the block returns the same value
template <int NV>
__device__ __forceinline__ float gauge(const float4* G, const float* nrm,
                                       float* red, int n, int w4, int warp,
                                       int lane) {
  float worst = 0.f;
  for (int i = warp; i < n - 1; i += kWarps) {
    const float ni = nrm[i];
    if (ni == 0.f) continue;  // a zero row: every dot with it is exactly 0
    const float4* row = G + (size_t)i * w4;
    Row<NV> r;
    load_row<NV>(row, w4, lane, r);
    for (int j = i + 1; j < n; ++j) {
      const float nj = nrm[j];
      if (nj == 0.f) continue;
      const float g = dot_row<NV>(r, row, G + (size_t)j * w4, w4, lane);
      worst = fmaxf(worst, g * g / fmaxf(ni * nj, kEpsFloor));
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
jacobi_sweep_kernel(const float* __restrict__ a_g, float* g_g, int* sweeps_g,
                    float* gauge_g, int* rot_g, int n, int width, int max_sweeps,
                    float tol2, float live_thresh) {
  __shared__ float nrm[kMaxN];
  __shared__ float red[kWarps];
  __shared__ int rotations;  // pairs rotated so far (skipped pairs not counted)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = n / 2;
  const int m = n - 1;  // length of the ring
  const int w4 = width / 4;
  const size_t count = (size_t)n * w4;
  const float4* src = reinterpret_cast<const float4*>(a_g) + blockIdx.x * count;
  float4* G = reinterpret_cast<float4*>(g_g) + blockIdx.x * count;

  for (size_t i = tid; i < count; i += kThreads) G[i] = src[i];
  if (tid == 0) rotations = 0;
  __syncthreads();

  refresh_norms<NV>(G, nrm, n, w4, warp, lane);
  __syncthreads();
  float worst = gauge<NV>(G, nrm, red, n, w4, warp, lane);

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
        Row<NV> rp, rq;
        const float gam = pair_dot<NV>(p, q, w4, lane, rp, rq);
        const float a = nrm[pi];
        const float b = nrm[qi];
        __syncwarp();  // every lane has read the norms before lane 0 rewrites them
        const float ratio = gam * gam / fmaxf(a * b, kEpsFloor);
        if (!(ratio > live_thresh)) continue;  // already orthogonal, or zero
        const float zeta = (b - a) / (2.0f * gam);
        const float t = (zeta >= 0.f ? 1.0f : -1.0f) /
                        (fabsf(zeta) + sqrtf(1.0f + zeta * zeta));
        // 1/sqrt in IEEE rounding, not the approximate rsqrtf: a bias in
        // c^2 + s^2 adds up over the ~n rotations a row sees per sweep
        // (measured: it doubled the drift of G^T G)
        const float c = 1.0f / sqrtf(1.0f + t * t);
        const float s = c * t;
        rotate<NV>(p, q, w4, lane, rp, rq, s, s / (1.0f + c));
        if (lane == 0) {
          const float cs2 = 2.0f * c * s * gam;
          nrm[pi] = c * c * a + s * s * b - cs2;
          nrm[qi] = s * s * a + c * c * b + cs2;
          atomicAdd(&rotations, 1);
        }
      }
      __syncthreads();  // the next round pairs rows other warps just wrote
      shift = shift + 1 == m ? 0 : shift + 1;
    }
    ++sweep;
    refresh_norms<NV>(G, nrm, n, w4, warp, lane);
    __syncthreads();
    worst = gauge<NV>(G, nrm, red, n, w4, warp, lane);
  }

  if (tid == 0) {
    sweeps_g[blockIdx.x] = sweep;
    gauge_g[blockIdx.x] = worst;
    rot_g[blockIdx.x] = rotations;
  }
}

template <int NV>
cudaError_t launch_device_memory(const float* a, float* g, int* sweeps,
                                 float* gauge_out, int* rot, int B, int n,
                                 int width, int max_sweeps, float tol2,
                                 float live_thresh, cudaStream_t stream) {
  jacobi_sweep_kernel<NV><<<B, kThreads, 0, stream>>>(
      a, g, sweeps, gauge_out, rot, n, width, max_sweeps, tol2, live_thresh);
  return cudaGetLastError();
}

// =============================== cluster path ===============================

constexpr int kCThreads = 1024;
constexpr int kCWarps = kCThreads / 32;
constexpr int kTile = 64;   // gauge tiles of kTile x kTile outputs
// words after the slice, the shared area, the norms and the coefficients:
// two mbarriers, the per-warp maxima, this CTA's max and the rotation count
constexpr int kMisc = 64;

// The shared area of a CTA: the gauge's two tiles, or (in the rounds) the
// pair partials received from every rank, part[2][C][n/2]
__host__ __device__ __forceinline__ int shared_area(int n, int C) {
  return 2 * kTile * kTile > C * n ? 2 * kTile * kTile : C * n;
}

// dynamic shared memory of one CTA: the slice (n x slice_stride float4),
// the shared area, the carried norms (n), the round's coefficients (2 x
// n/2) and kMisc words.  ops/jacobi_eigh.py::cluster_smem_bytes is the
// same formula.
__host__ __device__ __forceinline__ size_t cluster_smem_bytes(int n, int w4, int C) {
  return (size_t)n * slice_stride(slice_w4(w4, C)) * sizeof(float4) +
         (size_t)(shared_area(n, C) + 2 * n + kMisc) * sizeof(float);
}

// float4 of each row a thread keeps in registers from the pair dots to the
// rotation, where a round is one pass of the pairs over the threads and a
// thread holds 2 to kKeep float4 of a row (at one, the registers cost more
// than the shared-memory reads they save, measured on an NVIDIA H100 80GB
// HBM3 at 700 W)
constexpr int kKeep = 4;

__host__ __device__ __forceinline__ bool keeps_rows(int n, int w4, int C) {
  const int s4 = slice_w4(w4, C), tpp = pair_threads(s4);
  return n / 2 <= kCThreads / tpp && s4 > tpp && s4 <= kKeep * tpp;
}

// The gauge and the refreshed norms of the panel held by the cluster; every
// thread of every CTA returns the same value.  S: this CTA's slice.
template <int C>
__device__ float cluster_gauge(const float4* S, int n, int s4, int sp,
                               float* tiles, float* nrm, float* red,
                               float* gmax, unsigned rank, int tid) {
  const int ty = tid >> 5, tx = tid & 31;
  const int T = (n + kTile - 1) / kTile;
  const int steps = T * (T + 1) / 2;
  const int share = kTile * kTile / C;  // entries of a tile this CTA sums
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
    const int i0 = I * kTile, j0 = J * kTile;
    float* buf = tiles + (t & 1) * kTile * kTile;
    {
      // this CTA's partial tile: rows i0 + ty (+32), columns j0 + tx (+32);
      // rows past n read row n - 1 and are never used
      const float4* a0 = S + (size_t)min(i0 + ty, n - 1) * sp;
      const float4* a1 = S + (size_t)min(i0 + ty + 32, n - 1) * sp;
      const float4* b0 = S + (size_t)min(j0 + tx, n - 1) * sp;
      const float4* b1 = S + (size_t)min(j0 + tx + 32, n - 1) * sp;
      float c00 = 0.f, c01 = 0.f, c10 = 0.f, c11 = 0.f;
      for (int k = 0; k < s4; ++k) {
        const float4 x0 = a0[k], x1 = a1[k], y0 = b0[k], y1 = b1[k];
        c00 = fmaf(x0.x, y0.x, c00); c00 = fmaf(x0.y, y0.y, c00);
        c00 = fmaf(x0.z, y0.z, c00); c00 = fmaf(x0.w, y0.w, c00);
        c01 = fmaf(x0.x, y1.x, c01); c01 = fmaf(x0.y, y1.y, c01);
        c01 = fmaf(x0.z, y1.z, c01); c01 = fmaf(x0.w, y1.w, c01);
        c10 = fmaf(x1.x, y0.x, c10); c10 = fmaf(x1.y, y0.y, c10);
        c10 = fmaf(x1.z, y0.z, c10); c10 = fmaf(x1.w, y0.w, c10);
        c11 = fmaf(x1.x, y1.x, c11); c11 = fmaf(x1.y, y1.y, c11);
        c11 = fmaf(x1.z, y1.z, c11); c11 = fmaf(x1.w, y1.w, c11);
      }
      buf[ty * kTile + tx] = c00;
      buf[ty * kTile + tx + 32] = c01;
      buf[(ty + 32) * kTile + tx] = c10;
      buf[(ty + 32) * kTile + tx + 32] = c11;
    }
    cluster_sync();
    if (I == J) {
      // every CTA sums the diagonal itself: the refreshed norms
      if (tid < kTile && i0 + tid < n) nrm[i0 + tid] = cluster_sum<C>(buf + tid * (kTile + 1));
      __syncthreads();
    }
    for (int e = rank * share + tid; e < (rank + 1) * share; e += kCThreads) {
      const int a = e / kTile, b = e % kTile;
      const int i = i0 + a, j = j0 + b;
      if (i < n && j < n && (I != J || a < b)) {
        const float g = cluster_sum<C>(buf + e);
        worst = fmaxf(worst, g * g / fmaxf(nrm[i] * nrm[j], kEpsFloor));
      }
    }
  }
  worst = warp_max(worst);
  if ((tid & 31) == 0) red[tid >> 5] = worst;
  __syncthreads();
  if (tid == 0) {
    float m = 0.f;
    for (int w = 0; w < kCWarps; ++w) m = fmaxf(m, red[w]);
    *gmax = m;
  }
  cluster_sync();
  return cluster_max<C>(gmax);
}

// KEEP (keeps_rows): the thread's columns of its pair stay in registers
// from step 1 to step 4, so a round reads the slice once and writes it once
template <int C, bool KEEP>
__global__ void __launch_bounds__(kCThreads, 1)
jacobi_sweep_cluster_kernel(const float* __restrict__ a_g, float* g_g,
                            int* sweeps_g, float* gauge_g, int* rot_g, int n,
                            int w4, int max_sweeps, float tol2,
                            float live_thresh) {
  extern __shared__ float4 smem4[];
  const int s4 = slice_w4(w4, C);
  const int sp = slice_stride(s4);
  const int h = n / 2;
  const int m = n - 1;  // length of the ring
  float4* S = smem4;
  float* area = reinterpret_cast<float*>(S + (size_t)n * sp);
  float* nrm = area + shared_area(n, C);
  float* coef_s = nrm + n;      // the round's s of each pair (0: not rotated)
  float* coef_tau = coef_s + h;  // and tau = s / (1 + c)
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(coef_tau + h);
  float* red = coef_tau + h + 4;
  float* gmax = red + kCWarps;
  int* rotations = reinterpret_cast<int*>(gmax + 1);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const unsigned rank = cluster_rank();
  const size_t mat = blockIdx.x / C;
  const int c0 = (int)rank * s4;                     // first column held
  const int cw = max(0, min(s4, w4 - c0));           // columns held (the rest zero)
  const float4* src = reinterpret_cast<const float4*>(a_g) + mat * n * w4;
  float4* out = reinterpret_cast<float4*>(g_g) + mat * n * w4;

  for (int e = tid; e < n * s4; e += kCThreads) {
    const int i = e / s4, k = e - i * s4;
    S[(size_t)i * sp + k] = k < cw ? src[(size_t)i * w4 + c0 + k]
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
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
  float worst = cluster_gauge<C>(S, n, s4, sp, area, nrm, red, gmax, rank, tid);

  // the vector work of a round: a group of tpp threads a pair, thread
  // `sub` taking columns sub, sub + tpp, ...; group `grp` takes pairs grp,
  // grp + groups, ...
  const int tpp = pair_threads(s4);
  const int groups = kCThreads / tpp;
  const int grp = tid / tpp;
  const int sub = tid & (tpp - 1);
  const int passes = (h + groups - 1) / groups;  // the same in every warp
  const int rounds = (m + kUnroll - 1) / kUnroll * kUnroll;
  const unsigned bytes = (unsigned)(C * h * sizeof(float));
  int nrot = 0;        // pairs this thread found live (phase 3)
  int shift = 0;       // rounds played so far, modulo the ring length
  unsigned phase = 0;  // rounds played in all sweeps: part and bar[phase & 1]
  int sweep = 0;
  float4 kp[KEEP ? kKeep : 1], kq[KEEP ? kKeep : 1];  // the kept columns
  while (sweep < max_sweeps && worst > tol2) {
    for (int r = 0; r < rounds; ++r, ++phase) {
      const int par = phase & 1;
      float* part = area + par * C * h;
      if (tid == 0) mbar_expect(bar + par, bytes);
      // ---- 1. the partial gamma of each pair pv over this CTA's columns,
      // pushed into part[par][rank][pv] of every rank ----
      for (int k = 0; k < passes; ++k) {
        const int pv = grp + k * groups;
        float acc = 0.f;
        if (pv < h) {
          const float4* p = S + (size_t)pair_top(pv, shift, h, n, m) * sp;
          const float4* q = S + (size_t)pair_bot(pv, shift, h, n, m) * sp;
          if constexpr (KEEP) {
#pragma unroll
            for (int j = 0; j < kKeep; ++j) {
              const int x = sub + j * tpp;
              if (x < s4) {
                kp[j] = p[x];
                kq[j] = q[x];
                acc += dot4(kp[j], kq[j]);
              }
            }
          } else {
            for (int x = sub; x < s4; x += tpp) acc += dot4(p[x], q[x]);
          }
        }
        for (int o = tpp >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (pv < h) {
          const unsigned a = smem_u32(part + rank * h + pv);
          const unsigned b = smem_u32(bar + par);
          for (int d = sub; d < C; d += tpp) push_word(cluster_map(a, d), acc, cluster_map(b, d));
        }
      }
      // ---- 2. every rank's partials have arrived ----
      mbar_wait(bar + par, (phase >> 1) & 1);
      // ---- 3. one thread a pair: gamma in rank order, the rotation's
      // coefficients and the carried norms ----
      if (tid < h) {
        float g = part[tid];
#pragma unroll
        for (int rr = 1; rr < C; ++rr) g += part[rr * h + tid];
        const int pi = pair_top(tid, shift, h, n, m);
        const int qi = pair_bot(tid, shift, h, n, m);
        const float a = nrm[pi], b = nrm[qi];
        float s = 0.f, tau = 0.f;
        const float ratio = g * g / fmaxf(a * b, kEpsFloor);
        if (ratio > live_thresh) {  // else already orthogonal, or zero
          const float zeta = (b - a) / (2.0f * g);
          const float t = (zeta >= 0.f ? 1.0f : -1.0f) /
                          (fabsf(zeta) + sqrtf(1.0f + zeta * zeta));
          // 1/sqrt in IEEE rounding (see the device-memory kernel)
          const float c = 1.0f / sqrtf(1.0f + t * t);
          s = c * t;
          tau = s / (1.0f + c);
          const float cs2 = 2.0f * c * s * g;
          nrm[pi] = c * c * a + s * s * b - cs2;
          nrm[qi] = s * s * a + c * c * b + cs2;
          ++nrot;
        }
        coef_s[tid] = s;
        coef_tau[tid] = tau;
      }
      __syncthreads();
      // ---- 4. the rotation of this CTA's columns (s = 0: the identity) ----
      for (int pv = grp; pv < h; pv += groups) {
        const float s = coef_s[pv];
        if (s != 0.f) {
          const float tau = coef_tau[pv];
          float4* p = S + (size_t)pair_top(pv, shift, h, n, m) * sp;
          float4* q = S + (size_t)pair_bot(pv, shift, h, n, m) * sp;
          if constexpr (KEEP) {
#pragma unroll
            for (int j = 0; j < kKeep; ++j) {
              const int x = sub + j * tpp;
              if (x < s4) {
                float4 np, nq;
                rot4(kp[j], kq[j], s, tau, np, nq);
                p[x] = np;
                q[x] = nq;
              }
            }
          } else {
            for (int x = sub; x < s4; x += tpp) {
              float4 np, nq;
              rot4(p[x], q[x], s, tau, np, nq);
              p[x] = np;
              q[x] = nq;
            }
          }
        }
      }
      // ---- 5. the next round pairs rows that other threads just rotated ----
      __syncthreads();
      shift = shift + 1 == m ? 0 : shift + 1;
    }
    ++sweep;
    worst = cluster_gauge<C>(S, n, s4, sp, area, nrm, red, gmax, rank, tid);
  }

  // every CTA's last remote read (the gauge's maximum) is behind this
  // barrier: no CTA leaves while another may still read its shared memory
  cluster_sync();
  for (int e = tid; e < n * cw; e += kCThreads) {
    const int i = e / cw, k = e - i * cw;
    out[(size_t)i * w4 + c0 + k] = S[(size_t)i * sp + k];
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
                              int* rot, int B, int n, int w4, int max_sweeps,
                              float tol2, float live_thresh, cudaStream_t stream) {
  const size_t smem = cluster_smem_bytes(n, w4, C);
  cudaError_t e = cluster_attributes(jacobi_sweep_cluster_kernel<C, KEEP>, C, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(C, B, kCThreads, smem, stream, attr);
  e = cudaLaunchKernelEx(&cfg, jacobi_sweep_cluster_kernel<C, KEEP>, a, g, sweeps,
                         gauge_out, rot, n, w4, max_sweeps, tol2, live_thresh);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_cluster(const float* a, float* g, int* sweeps, float* gauge_out,
                           int* rot, int B, int n, int w4, int max_sweeps,
                           float tol2, float live_thresh, cudaStream_t stream) {
  if (keeps_rows(n, w4, C))
    return launch_cluster_as<C, true>(a, g, sweeps, gauge_out, rot, B, n, w4,
                                      max_sweeps, tol2, live_thresh, stream);
  return launch_cluster_as<C, false>(a, g, sweeps, gauge_out, rot, B, n, w4,
                                     max_sweeps, tol2, live_thresh, stream);
}

template <int C, bool KEEP>
cudaError_t active_clusters_as(int n, int w4, int* out) {
  return active_clusters_of(jacobi_sweep_cluster_kernel<C, KEEP>, C, kCThreads,
                            cluster_smem_bytes(n, w4, C), out);
}

template <int C>
cudaError_t active_clusters(int n, int w4, int* out) {
  return keeps_rows(n, w4, C) ? active_clusters_as<C, true>(n, w4, out)
                              : active_clusters_as<C, false>(n, w4, out);
}

bool valid(int n, int width, int cluster) {
  return n >= 2 && !(n & 1) && n <= kMaxN && width >= 4 && !(width & 3) &&
         (cluster == 0 || cluster == 1 || cluster == 2 || cluster == 4 ||
          cluster == 8 || cluster == 16);
}

}  // namespace

// Plain C entries for ctypes.  a, g: (B, n, width) contiguous f32 on the
// device, distinct buffers, n even and <= 1024, width a multiple of 4;
// sweeps (B,) int32, gauge (B,) f32 and rot (B,) int32 receive each
// matrix's executed sweep count, last measured gauge and number of pairs
// rotated.  cluster: C (1, 2, 4, 8 or 16) CTAs a matrix on the cluster
// path, whose slices must fit the shared memory a block may opt in to
// (cluster_smem_bytes), or 0 for the device-memory path.  Returns a
// cudaError_t (0 on success); a cluster launch the card refuses returns
// its error.
extern "C" int jacobi_sweep_f32(const float* a, float* g, int* sweeps,
                                float* gauge_out, int* rot, int B, int n,
                                int width, int max_sweeps, float tol2, float live_thresh,
                                int cluster, void* stream) {
  if (B <= 0 || !valid(n, width, cluster) || max_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int w4 = width / 4;
  cudaError_t e;
  switch (cluster) {
    case 1: e = launch_cluster<1>(a, g, sweeps, gauge_out, rot, B, n, w4, max_sweeps, tol2, live_thresh, s); break;
    case 2: e = launch_cluster<2>(a, g, sweeps, gauge_out, rot, B, n, w4, max_sweeps, tol2, live_thresh, s); break;
    case 4: e = launch_cluster<4>(a, g, sweeps, gauge_out, rot, B, n, w4, max_sweeps, tol2, live_thresh, s); break;
    case 8: e = launch_cluster<8>(a, g, sweeps, gauge_out, rot, B, n, w4, max_sweeps, tol2, live_thresh, s); break;
    case 16: e = launch_cluster<16>(a, g, sweeps, gauge_out, rot, B, n, w4, max_sweeps, tol2, live_thresh, s); break;
    default: {
      const int nv = (w4 + 31) / 32;
      if (nv <= 1)
        e = launch_device_memory<1>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2, live_thresh, s);
      else if (nv <= 2)
        e = launch_device_memory<2>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2, live_thresh, s);
      else if (nv <= 4)
        e = launch_device_memory<4>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2, live_thresh, s);
      else if (nv <= 8)
        e = launch_device_memory<8>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2, live_thresh, s);
      else
        e = launch_device_memory<0>(a, g, sweeps, gauge_out, rot, B, n, width, max_sweeps, tol2, live_thresh, s);
    }
  }
  return (int)e;
}

// How many clusters of `cluster` CTAs of the cluster path the card holds at
// once for an (n, width) panel (cudaOccupancyMaxActiveClusters), into *out;
// 0 means it cannot schedule one.  Returns a cudaError_t.
extern "C" int jacobi_sweep_f32_clusters(int n, int width, int cluster, int* out) {
  if (!valid(n, width, cluster) || cluster == 0) return (int)cudaErrorInvalidValue;
  const int w4 = width / 4;
  switch (cluster) {
    case 1: return (int)active_clusters<1>(n, w4, out);
    case 2: return (int)active_clusters<2>(n, w4, out);
    case 4: return (int)active_clusters<4>(n, w4, out);
    case 8: return (int)active_clusters<8>(n, w4, out);
    default: return (int)active_clusters<16>(n, w4, out);
  }
}
