// Pruned eigenbasis projection P = U^T V (Algorithm 2's second pair).
//
// Replaces the TPU kernel
//   src/repro/kernels/eigvec_update/eigvec_update.py::eigvec_project
//   (pallas_call at :272).
//
// U is a row block (R rows of n, row-major) whose first row is the
// state's row r0 (R = n and r0 = 0 for the whole state); V is (R, ncol)
// with ncol <= 8; P is the (n, ncol) partial of the block.  Rows of the
// block at or beyond the active count m (global index, read by pointer)
// are masked: the sum runs over rows r0 + i < m.  Output rows of P
// (columns of U) in slabs at or beyond ceil(m / 32) are exact zeros (32 is
// ops.PROJECT_SLAB): their true value, since inactive U columns are
// identity columns supported on masked rows.
//
// What bounds it on an H100: bytes.  It reads the active block of U once
// (4 MB at m = 1000 in f32) and does 2 ncol flops per entry, far below the
// ridge; at 4 MB the card must keep most of the matrix in flight at once
// to come near its memory rate.  Design:
//   * The grid is 64-column slabs of U x 8 row ranks (16 x 8 = 128 blocks
//     at n = 1024), each column's 8 ranks one thread-block cluster.  Rank q
//     takes the row chunks q, q + 8, ... of the block's live rows.
//   * A thread reads 16 bytes along a U row (4 floats or 2 doubles; a
//     half warp covers a 64-float row segment, a warp a 64-double one).
//     The block's threads load a chunk of 128 rows at once (8 loads a
//     thread in f32, 16 in f64), all issued before V's rows of the chunk
//     are staged in shared memory and before the first FMA: at m = 1000
//     each rank's rows are one chunk, a single trip to memory.
//   * No atomics: each rank sums its rows in order, its row groups in
//     order in shared memory; then each rank finishes 8 of the slab's 64
//     columns, adding the 8 ranks' partials in rank order through
//     distributed shared memory, and writes them.  The result does not
//     depend on scheduling.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCols = 64;      // columns of U per block
constexpr int kThreads = 256;
constexpr int kCluster = 8;    // row ranks per column slab: one cluster
constexpr int kChunk = 128;    // rows the block's threads load at once
constexpr int kMaxCols = 8;    // ops.NPROJ
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

template <typename T, bool Vec>
__global__ void __cluster_dims__(1, kCluster, 1) __launch_bounds__(kThreads)
eigvec_project_kernel(const T* __restrict__ u,
                      const T* __restrict__ v, const int* __restrict__ m_ptr,
                      T* __restrict__ out, int R, int n, int ncol, int r0) {
  using G = Geo<T, Vec>;
  using P = Pack<T, G::kUnit>;
  __shared__ T vs[kChunk][kMaxCols];
  __shared__ T red[G::kGroups][kCols][kMaxCols];
  __shared__ T part[kCols][kMaxCols];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int m = repro::active_count(m_ptr, n);
  const int live = min(n, (m + kSlab - 1) / kSlab * kSlab);
  const int rows = min(max(m - r0, 0), R);      // rows r0 + i < m
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
    // V's live columns only (one load a thread at ncol = 2), so its loads
    // are one trip to memory, alongside U's.
#pragma unroll 4
    for (int e = threadIdx.x; e < kChunk * ncol; e += kThreads) {
      const int i = e / ncol, q = e % ncol;
      vs[i][q] = base + i < rows ? v[(size_t)(base + i) * ncol + q] : T(0);
    }
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

template <typename T>
int launch(const void* u, const void* v, const void* m, void* out, int R,
           int n, int r0, int ncol, void* stream) {
  if (n > 0 && ncol > 0) {
    const bool vec = n % (16 / sizeof(T)) == 0 &&
                     reinterpret_cast<uintptr_t>(u) % 16 == 0;
    const dim3 grid((n + kCols - 1) / kCols, kCluster);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* up = static_cast<const T*>(u);
    const T* vp = static_cast<const T*>(v);
    const int* mp = static_cast<const int*>(m);
    T* o = static_cast<T*>(out);
    if (vec)
      eigvec_project_kernel<T, true><<<grid, kThreads, 0, s>>>(
          up, vp, mp, o, R, n, ncol, r0);
    else
      eigvec_project_kernel<T, false><<<grid, kThreads, 0, s>>>(
          up, vp, mp, o, R, n, ncol, r0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int eigvec_project_f32(const void* u, const void* v,
                                  const void* m, void* out, int R, int n,
                                  int r0, int ncol, void* stream) {
  return launch<float>(u, v, m, out, R, n, r0, ncol, stream);
}

extern "C" int eigvec_project_f64(const void* u, const void* v,
                                  const void* m, void* out, int R, int n,
                                  int r0, int ncol, void* stream) {
  return launch<double>(u, v, m, out, R, n, r0, ncol, stream);
}
