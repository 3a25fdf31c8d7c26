// The cluster projection of eigvec_project.cu and krow_project.cu:
// P = U^T V for a row block of U, with V's rows staged by the caller.
//
// U is a row block (R rows of n, row-major) whose first row is the state's
// row r0; the sum runs over its `rows` live rows (r0 + i < m).  V has ncol
// <= 8 columns; the caller's `stage` hook writes V's rows of each chunk
// into shared memory.  P is the (n, ncol) partial of the block.  Output
// rows of P (columns of U) in 32-column slabs at or beyond ceil(m / 32)
// are exact zeros: their true value, since inactive U columns are
// identity columns supported on masked rows.
//
// What bounds it on an H100: bytes.  It reads the active block of U once
// (4 MB at m = 1000 in f32) and does 2 ncol flops per entry, far below the
// ridge; at 4 MB the card must keep most of the matrix in flight at once
// to come near its memory rate.  Design:
//   * The grid is 64-column slabs of U x 8 row ranks (16 x 8 = 128 blocks
//     at n = 1024), each slab's 8 ranks one thread-block cluster (the
//     kernel declares __cluster_dims__(1, kCluster, 1)).  Rank q takes the
//     row chunks q, q + 8, ... of the block's live rows.
//   * A thread reads 16 bytes along a U row (4 floats or 2 doubles; a
//     half warp covers a 64-float row segment, a warp a 64-double one).
//     The block's threads load a chunk of 128 rows at once (8 loads a
//     thread in f32, 16 in f64), all issued before V's rows of the chunk
//     are staged in shared memory and before the first FMA: at m = 1000
//     each rank's rows are one chunk, a single trip to memory.  Whatever
//     the hook computes to stage V overlaps U's memory latency.
//   * No atomics: each rank sums its rows in order, its row groups in
//     order in shared memory; then each rank finishes 8 of the slab's 64
//     columns, adding the 8 ranks' partials in rank order through
//     distributed shared memory, and writes them.  The result does not
//     depend on scheduling.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace project {

constexpr int kCols = 64;      // columns of U per block
constexpr int kThreads = 256;
constexpr int kCluster = 8;    // row ranks per column slab: one cluster
constexpr int kChunk = 128;    // rows the block's threads load at once
constexpr int kMaxCols = 8;    // columns of V
constexpr int kSlab = 32;      // pruning granule (ops.PROJECT_SLAB)
constexpr int kShare = kCols / kCluster;   // columns each rank finishes

// Vec: 16-byte loads (n a multiple of 16 bytes, u 16-byte aligned); else
// one value per load.
template <typename T, bool Vec>
struct Geo {
  static constexpr int kUnit = Vec ? 16 / sizeof(T) : 1;  // values a load
  static constexpr int kLanes = kCols / kUnit;            // threads a row
  static constexpr int kGroups = kThreads / kLanes;       // rows at once
  static constexpr int kUnroll = kChunk / kGroups;        // loads a thread
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// Rows r0 + i < m of an R-row block starting at the state's row r0.
__device__ __forceinline__ int live_rows(int m, int r0, int R) {
  return min(max(m - r0, 0), R);
}

// The block's share of P = U^T V over `rows` live rows of u, m the active
// count.  stage(vs, base) is called by every thread once per chunk, after
// the chunk's U loads are issued and between two barriers: it fills
// vs[i][0 .. ncol) with V's row base + i for i < kChunk, zeros at
// base + i >= rows.
template <typename T, bool Vec, typename Stage>
__device__ __forceinline__ void project(const T* __restrict__ u, int n,
                                        int ncol, int m, int rows,
                                        T* __restrict__ out, Stage&& stage) {
  using G = Geo<T, Vec>;
  using P = Pack<T, G::kUnit>;
  __shared__ T vs[kChunk][kMaxCols];
  __shared__ T red[G::kGroups][kCols][kMaxCols];
  __shared__ T part[kCols][kMaxCols];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int live = min(n, (m + kSlab - 1) / kSlab * kSlab);
  const int col0 = blockIdx.x * kCols;
  if (col0 >= live) {                // the whole cluster: exact zeros
    if (rank == 0)
      for (int e = threadIdx.x; e < kCols * ncol; e += kThreads) {
        const int col = col0 + e / ncol;
        if (col < n) out[(size_t)col * ncol + e % ncol] = T(0);
      }
    return;
  }
  const int lane = threadIdx.x % G::kLanes, grp = threadIdx.x / G::kLanes;
  const int c0 = col0 + lane * G::kUnit;       // this thread's first column
  const bool loads = c0 < live;

  T acc[G::kUnit][kMaxCols];
#pragma unroll
  for (int e = 0; e < G::kUnit; ++e)
#pragma unroll
    for (int q = 0; q < kMaxCols; ++q) acc[e][q] = T(0);
  for (int base = rank * kChunk; base < rows; base += kCluster * kChunk) {
    P x[G::kUnroll];                 // the chunk's loads, all in flight
#pragma unroll
    for (int uu = 0; uu < G::kUnroll; ++uu) {
      const int r = base + grp + uu * G::kGroups;
      if (loads && r < rows) {
        x[uu] = *reinterpret_cast<const P*>(u + (size_t)r * n + c0);
      } else {
#pragma unroll
        for (int e = 0; e < G::kUnit; ++e) x[uu].v[e] = T(0);
      }
    }
    __syncthreads();                 // the previous chunk's V is read
    stage(vs, base);
    __syncthreads();
#pragma unroll
    for (int uu = 0; uu < G::kUnroll; ++uu) {
      const T* vr = vs[grp + uu * G::kGroups];
#pragma unroll
      for (int q = 0; q < kMaxCols; ++q) {
        if (q < ncol) {
#pragma unroll
          for (int e = 0; e < G::kUnit; ++e)
            acc[e][q] = fma(x[uu].v[e], vr[q], acc[e][q]);
        }
      }
    }
  }

  // The block's partial: its row groups in order.
#pragma unroll
  for (int e = 0; e < G::kUnit; ++e)
#pragma unroll
    for (int q = 0; q < kMaxCols; ++q)
      red[grp][lane * G::kUnit + e][q] = acc[e][q];
  __syncthreads();
  for (int e = threadIdx.x; e < kCols * ncol; e += kThreads) {
    const int c = e / ncol, q = e % ncol;
    T s = T(0);
#pragma unroll
    for (int gi = 0; gi < G::kGroups; ++gi) s += red[gi][c][q];
    part[c][q] = s;
  }
  // The cluster's: rank q adds the ranks' partials of its share of the
  // columns in rank order and writes them.
  cluster.sync();
  for (int e = threadIdx.x; e < kShare * ncol; e += kThreads) {
    const int c = rank * kShare + e / ncol, q = e % ncol;
    const int col = col0 + c;
    if (col >= n) continue;
    T s = T(0);
    if (col < live)
#pragma unroll
      for (int p = 0; p < kCluster; ++p)
        s += cluster.map_shared_rank(&part[0][0], p)[c * kMaxCols + q];
    out[(size_t)col * ncol + q] = s;
  }
  cluster.sync();                    // peers keep their partials until read
}

// Whether U's rows can be read 16 bytes at a time.
template <typename T>
bool vector_rows(const void* u, int n) {
  return n % (16 / sizeof(T)) == 0 &&
         reinterpret_cast<uintptr_t>(u) % 16 == 0;
}

}  // namespace project
}  // namespace repro
