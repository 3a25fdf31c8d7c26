// Fused batched transform: query kernel rows + component projection.
//
// Replaces the TPU kernel
//   src/repro/kernels/nystrom_recon/transform_batch.py::transform_project
//   (pallas_call at :123).
//
// For queries xq (nq, dim), stored points X (n, dim) and a projection
// S (n, ncomp), any ncomp >= 1, it computes, with Kq[i, j] = k(xq_i, X_j)
// masked to columns j < m (m read by pointer),
//   Y      = Kq @ S          (nq, ncomp)
//   rowsum = Kq @ 1          (nq,)
// in one launch: the query gram is never stored in memory.  One launch
// serves nb tenants (the reference's pallas_call under jax.vmap), each
// with operands of the single call's shape laid one after another (xq by
// nq x dim, X by n x dim, S by n x ncomp, Y by nq x ncomp, rowsum by nq,
// m by one int); the tenant is the grid's z axis, beside the cluster's x.
// It picks the rows a block reads, never the order of a sum, so tenant b
// of a launch equals a launch on its operands alone bit for bit.  The epilogue
// and the norm expansion d2 = max(|xq_i|^2 + |X_j|^2 - 2 xq_i.X_j, 0)
// follow kernels_fn.gram_block term for term.
//
// What bounds it on an H100: neither bytes nor operations.  The main
// path's calls (the service: nq 64, m 1000, dim 16, ncomp 8; Nystrom
// features: 64 x 512 against 512 components; the roofline: 512 x 1024,
// 64 components) move under 2 MB and do under 0.1 GFLOP, about a
// microsecond at the card's f32/f64 rate, so latency and filling the card
// bound it: the design spreads a call over at least 64 blocks, keeps the
// queries in shared memory and makes one launch, on the CUDA cores (a
// tensor-core pipeline cannot pay for itself at these sizes).
//   * A block owns kTQ = 8 queries x a tile of TC (8, 16, 32 or 64)
//     components; the stored points j < m are split over the kRanks = 8
//     blocks of a thread-block cluster, rank r taking the 64-point chunks
//     r, r + 8, ...  The grid (ranks x query tiles, component tiles) and
//     the tile are nystrom_recon/ops.transform_geometry's, passed in and
//     checked here: 64 blocks at the service's shape.
//   * Each rank works through its chunks in steps of (chunk, 128-byte slab
//     of dim): the step's X rows, query rows and (at a chunk's first
//     slab) S rows are copied into shared memory with cp.async,
//     double-buffered, the next step's copies in flight while this one
//     computes.
//   * Thread (q, j) holds the dot products of queries q and q + 4 with
//     point j over the slabs; after the last one the (8 x 64) Kq tile is
//     formed in shared memory, each entry once per component tile,
//     |xq_i|^2 once per block and |X_j|^2 once per chunk (the first 64
//     threads).  Then each thread adds the tile times S's chunk into its
//     Y entries (one or two queries of one column, over all 64 points or
//     a half or quarter of them) and the row sums alike.
//   * No atomics: a block's partial sums its point splits in order, then
//     each rank finishes every eighth entry of the tile, adding the 8
//     ranks' partials in rank order through distributed shared memory.
//     The result does not depend on scheduling.  Only the first
//     component tile writes rowsum.
// The chunk, the stages and the launch bounds were measured (PERF.md,
// Findings; launch/kernel_times.py): at the service's shape a step's
// fixed cost (its barriers, the wait for its copies) outweighs its work,
// so 64-point chunks beat 32; 128 beat 64 there but their stages cost the
// 512-block roofline call its occupancy in f64; 4 stages gained nothing
// over 2.  The launch bounds ask for three blocks an SM: left to itself
// ptxas aimed at 64 registers and spilled (f64, 32 columns); at two blocks
// (up to 128 registers) the roofline call ran slower in f32.
#include <cooperative_groups.h>

#include "common.cuh"
#include "rotate_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using repro::tile::cp_async_commit;
using repro::tile::cp_async_zfill;

constexpr int kThreads = 256;
constexpr int kTQ = 8;        // queries per block (ops.TRANSFORM_QUERIES)
constexpr int kRanks = 8;     // cluster over the points (ops.TRANSFORM_RANKS)
constexpr int kChunk = 64;    // points per chunk (ops.TRANSFORM_CHUNK)
constexpr int kStages = 2;    // steps in shared memory at once
constexpr int kE = kTQ * kChunk / kThreads;   // Kq entries a thread forms
constexpr int kQRows = kThreads / kChunk;     // ... kQRows queries apart
static_assert(kE * kThreads == kTQ * kChunk, "whole Kq entries a thread");

template <typename T, int TC>
struct Geo {
  static constexpr int kDS = 128 / sizeof(T);   // slab of dim: 128 bytes
  static constexpr int kLdX = kDS + 1;          // X slab row, padded
  // Y entries: a thread holds kQPer queries of one column, over 1/kKS of
  // a chunk's points.
  static constexpr int kQPer = kTQ * TC > kThreads ? kTQ * TC / kThreads : 1;
  static constexpr int kKS = kThreads * kQPer / (kTQ * TC);
  static constexpr int kQStride = kTQ / kQPer;
  static constexpr int kPts = kChunk / kKS;
  static constexpr int kStageX = kChunk * kLdX;
  static constexpr int kStageQ = kTQ * kDS;
  static constexpr int kStageS = kChunk * TC;
  static constexpr int kStage = kStageX + kStageQ + kStageS;
  static constexpr int kOut = kTQ * (TC + 1);   // Y tile + row sums
  static constexpr size_t kSmem = kStages * kStage * sizeof(T);
  static_assert(kKS * kOut <= kStages * kStage,
                "the point splits' partials fit in the stages");
};

// Wait until at most kStages - 2 groups of copies are in flight: the
// oldest step has landed.
__device__ __forceinline__ void cp_async_wait_step() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int TC>
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreads, 3)
transform_project_kernel(const T* __restrict__ xq, const T* __restrict__ x,
                         const T* __restrict__ s,
                         const int* __restrict__ m_ptr, T* __restrict__ y,
                         T* __restrict__ rowsum, int nq, int n, int dim,
                         int ncomp, int kind, T sigma, T scale) {
  using G = Geo<T, TC>;
  constexpr int kBytes = static_cast<int>(sizeof(T));
  // kStages stages, each [X slab | query slab | S chunk].
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const stages = reinterpret_cast<T*>(smem_raw);
  __shared__ T kt[kTQ][kChunk + 1];                   // the Kq tile
  __shared__ T xn[kChunk];                            // |X_j|^2
  __shared__ T qn[kTQ];                               // |xq_i|^2
  __shared__ T part[G::kOut];                         // the block's partial

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int q0 = blockIdx.x / kRanks * kTQ;
  const int c0 = blockIdx.y * TC;
  const int b = blockIdx.z;                          // the tenant
  xq += (size_t)b * nq * dim;
  x += (size_t)b * n * dim;
  s += (size_t)b * n * ncomp;
  y += (size_t)b * nq * ncomp;
  rowsum += (size_t)b * nq;
  const int m = repro::active_count(m_ptr + b, n);
  const int tid = threadIdx.x;
  const int nds = max(1, (dim + G::kDS - 1) / G::kDS);
  const int chunks = (m + kChunk - 1) / kChunk;
  const int mine = chunks > rank ? (chunks - rank + kRanks - 1) / kRanks : 0;
  const int steps = mine * nds;

  // Step t: slab t % nds of chunk rank + (t / nds) * kRanks, into stage
  // t % kStages; S's rows ride with a chunk's first slab, into stage
  // (t / nds) % kStages.
  auto issue = [&](int t) {
    if (t < steps) {
      const int sl = t % nds, ci = t / nds;
      const int j0 = (rank + ci * kRanks) * kChunk, k0 = sl * G::kDS;
      T* xs = stages + (t % kStages) * G::kStage;
      T* qs = xs + G::kStageX;
      for (int e = tid; e < kChunk * G::kDS; e += kThreads) {
        const int r = e / G::kDS, k = k0 + e % G::kDS, j = j0 + r;
        const bool ok = j < m && k < dim;
        cp_async_zfill<kBytes>(xs + r * G::kLdX + e % G::kDS,
                               ok ? x + (size_t)j * dim + k : x,
                               ok ? kBytes : 0);
      }
      for (int e = tid; e < kTQ * G::kDS; e += kThreads) {
        const int q = q0 + e / G::kDS, k = k0 + e % G::kDS;
        const bool ok = q < nq && k < dim;
        cp_async_zfill<kBytes>(qs + e, ok ? xq + (size_t)q * dim + k : xq,
                               ok ? kBytes : 0);
      }
      if (sl == 0) {
        T* ss = stages + (ci % kStages) * G::kStage + G::kStageX +
                G::kStageQ;
        for (int e = tid; e < kChunk * TC; e += kThreads) {
          const int j = j0 + e / TC, c = c0 + e % TC;
          const bool ok = j < m && c < ncomp;
          cp_async_zfill<kBytes>(ss + e, ok ? s + (size_t)j * ncomp + c : s,
                                 ok ? kBytes : 0);
        }
      }
    }
    cp_async_commit();                 // possibly empty: keeps the count
  };

  for (int t = 0; t < kStages - 1; ++t) issue(t);
  if (tid < kTQ) {
    T acc = T(0);
    if (q0 + tid < nq)
      for (int k = 0; k < dim; ++k) {
        const T v = xq[(size_t)(q0 + tid) * dim + k];
        acc = fma(v, v, acc);
      }
    qn[tid] = acc;
  }

  // This thread's Kq entries (qt + e kQRows, jt) and its Y entries: column
  // cc, queries qa + i kQStride, points ks kPts .. of each chunk.
  const int qt = tid / kChunk, jt = tid % kChunk;
  const int cc = tid % TC, qa = tid / TC % G::kQStride;
  const int ks = tid / TC / G::kQStride;
  T dot[kE], norm = T(0);
  T acc[G::kQPer], rs[G::kQPer];
#pragma unroll
  for (int e = 0; e < kE; ++e) dot[e] = T(0);
#pragma unroll
  for (int i = 0; i < G::kQPer; ++i) acc[i] = rs[i] = T(0);

  for (int t = 0; t < steps; ++t) {
    cp_async_wait_step();              // step t has landed
    __syncthreads();                   // ... for every thread; step t - 1
    issue(t + kStages - 1);            // is done with its stage
    const int sl = t % nds, ci = t / nds;
    const T* xs = stages + (t % kStages) * G::kStage;
    const T* qs = xs + G::kStageX + qt * G::kDS;
    xs += jt * G::kLdX;
    const int kd = min(G::kDS, dim - sl * G::kDS);
    for (int k = 0; k < kd; ++k) {
      const T xv = xs[k];
#pragma unroll
      for (int e = 0; e < kE; ++e)
        dot[e] = fma(qs[e * kQRows * G::kDS + k], xv, dot[e]);
      if (qt == 0) norm = fma(xv, xv, norm);   // |X_j|^2: the first warps
    }
    if (sl != nds - 1) continue;
    if (qt == 0) xn[jt] = norm;
    __syncthreads();
    const int j = (rank + ci * kRanks) * kChunk + jt;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int q = qt + e * kQRows;
      T kv = T(0);
      if (j < m && q0 + q < nq)
        kv = repro::kernel_epilogue(
            max(qn[q] + xn[jt] - T(2) * dot[e], T(0)), kind, sigma, scale);
      kt[q][jt] = kv;
      dot[e] = T(0);
    }
    norm = T(0);
    __syncthreads();
    const T* ss = stages + (ci % kStages) * G::kStage + G::kStageX +
                  G::kStageQ + cc;
#pragma unroll 8
    for (int p = ks * G::kPts; p < (ks + 1) * G::kPts; ++p) {
      const T sv = ss[p * TC];
#pragma unroll
      for (int i = 0; i < G::kQPer; ++i) {
        const T k = kt[qa + i * G::kQStride][p];
        acc[i] = fma(k, sv, acc[i]);
        rs[i] += k;
      }
    }
  }

  // The block's partial: its point splits in order (through the stages'
  // memory, free once the last copies have landed).
  cp_async_wait_all();
  __syncthreads();
  T* const red = stages;                              // [kKS][kOut]
#pragma unroll
  for (int i = 0; i < G::kQPer; ++i) {
    T* row = red + ks * G::kOut + (qa + i * G::kQStride) * (TC + 1);
    row[cc] = acc[i];
    if (cc == 0) row[TC] = rs[i];
  }
  __syncthreads();
  for (int e = tid; e < G::kOut; e += kThreads) {
    T v = T(0);
#pragma unroll
    for (int k = 0; k < G::kKS; ++k) v += red[k * G::kOut + e];
    part[e] = v;
  }
  // The cluster's: rank r adds the ranks' partials of entries r, r + 8,
  // ... in rank order and writes them.
  cluster.sync();
  for (int e = tid * kRanks + rank; e < G::kOut; e += kThreads * kRanks) {
    const int q = q0 + e / (TC + 1), c = e % (TC + 1);
    if (q >= nq || (c == TC ? blockIdx.y != 0 : c0 + c >= ncomp)) continue;
    T v = T(0);
#pragma unroll
    for (int p = 0; p < kRanks; ++p) v += cluster.map_shared_rank(part, p)[e];
    if (c == TC)
      rowsum[q] = v;
    else
      y[(size_t)q * ncomp + c0 + c] = v;
  }
  cluster.sync();                      // peers keep their partials until read
}

template <typename T, int TC>
int launch_tile(const void* xq, const void* x, const void* s, const void* m,
                void* y, void* rowsum, int nq, int n, int dim, int ncomp,
                int kind, double sigma, double scale, dim3 grid,
                cudaStream_t stream) {
  using G = Geo<T, TC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      transform_project_kernel<T, TC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  transform_project_kernel<T, TC><<<grid, kThreads, G::kSmem, stream>>>(
      static_cast<const T*>(xq), static_cast<const T*>(x),
      static_cast<const T*>(s), static_cast<const int*>(m),
      static_cast<T*>(y), static_cast<T*>(rowsum), nq, n, dim, ncomp, kind,
      static_cast<T>(sigma), static_cast<T>(scale));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xq, const void* x, const void* s, const void* m,
           void* y, void* rowsum, int nq, int n, int dim, int ncomp, int kind,
           double sigma, double scale, int grid_x, int grid_y, int grid_z,
           int q_tile, int c_tile, int ranks, int chunk, void* stream) {
  if (q_tile != kTQ || ranks != kRanks || chunk != kChunk || c_tile <= 0 ||
      grid_x != kRanks * ((nq + kTQ - 1) / kTQ) ||
      grid_y != (ncomp + c_tile - 1) / c_tile || grid_z < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || ncomp == 0 || grid_z == 0)
    return static_cast<int>(cudaGetLastError());
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c_tile) {
    case 8:
      return launch_tile<T, 8>(xq, x, s, m, y, rowsum, nq, n, dim, ncomp,
                               kind, sigma, scale, grid, st);
    case 16:
      return launch_tile<T, 16>(xq, x, s, m, y, rowsum, nq, n, dim, ncomp,
                                kind, sigma, scale, grid, st);
    case 32:
      return launch_tile<T, 32>(xq, x, s, m, y, rowsum, nq, n, dim, ncomp,
                                kind, sigma, scale, grid, st);
    case 64:
      return launch_tile<T, 64>(xq, x, s, m, y, rowsum, nq, n, dim, ncomp,
                                kind, sigma, scale, grid, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int transform_project_f32(const void* xq, const void* x,
                                     const void* s, const void* m, void* y,
                                     void* rowsum, int nq, int n, int dim,
                                     int ncomp, int kind, double sigma,
                                     double scale, int grid_x, int grid_y,
                                     int grid_z, int q_tile, int c_tile,
                                     int ranks, int chunk, void* stream) {
  return launch<float>(xq, x, s, m, y, rowsum, nq, n, dim, ncomp, kind, sigma,
                       scale, grid_x, grid_y, grid_z, q_tile, c_tile, ranks,
                       chunk, stream);
}

extern "C" int transform_project_f64(const void* xq, const void* x,
                                     const void* s, const void* m, void* y,
                                     void* rowsum, int nq, int n, int dim,
                                     int ncomp, int kind, double sigma,
                                     double scale, int grid_x, int grid_y,
                                     int grid_z, int q_tile, int c_tile,
                                     int ranks, int chunk, void* stream) {
  return launch<double>(xq, x, s, m, y, rowsum, nq, n, dim, ncomp, kind,
                        sigma, scale, grid_x, grid_y, grid_z, q_tile, c_tile,
                        ranks, chunk, stream);
}
