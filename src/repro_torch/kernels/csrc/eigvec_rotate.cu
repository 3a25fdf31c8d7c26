// Cauchy-factor eigenvector rotation: the paper's O(m^3) hot spot.
//
// Replaces the TPU kernel
//   src/repro/kernels/eigvec_update/eigvec_update.py::eigvec_rotate
//   (pallas_call at :179).
//
// Computes C = (U @ W) * inv with W[k, j] = z[k] / ((d[k] - org[j]) - tau[j]);
// W is generated tile by tile in shared memory from the vectors and never
// stored.  U is (n, n) row-major; z, inv are (n,) in T; d, org, tau are
// (n,) in double, the secular solve's type: root j is org[j] + tau[j], kept
// as its origin pole and the offset from it (repro_torch/core/rankone.py,
// _Roots), so that d[k] - org[j] is exact for close poles and the root's
// distance to them keeps its digits.  The denominator is formed in double
// and then rounded to T, because a root within half an f32 ulp of its pole
// would otherwise round onto it and divide by zero.  A denominator smaller
// than `guard` becomes +-guard, the guard under which inv was computed
// (rankone._cauchy_inv; eigvec_update/ref.py::offset_guard gives its
// value): the reference's kernel has none, and a root that rounds onto
// its pole then divides by zero.
//
// Pruning contract (the reference's _tile_counts, without a host read):
// the active count m is read by pointer; output tiles whose row or column
// tile lies at or beyond ceil(m / 64) are written as exact zeros, and the
// reduction stops at k = m.  On the padding contract (z = inv = 0 beyond
// m, U identity on inactive columns) these zeros are the true values, and
// the caller overwrites inactive columns anyway.
//
// What bounds it on an H100: operations.  At m ~ 1000 the product is
// 2 m^3 ~ 2 GFLOP against ~8 MB of operands, far above the card's
// FP32-CUDA-core ridge; TF32 tensor cores are not allowed (they would miss
// the f32 tolerances), so the ceiling is the FP32 (or FP64) CUDA-core rate.
// Design: 64x64 output tiles, 256 threads each holding a 4x4 register
// block (16 FMAs per 8 shared-memory loads), a K loop over 32-wide slabs
// with the U slab and the generated W slab staged in shared memory.  The
// W slab costs 2048 divisions (and double subtractions) per slab,
// amortized over 64 output rows.
// Accumulates in T: float for f32, double for f64, as the reference's
// promote(dtype, f32).  Tensor cores (wgmma) and TMA are later work.
#include "common.cuh"

namespace {

constexpr int kTile = 64;     // output tile edge (rows and columns)
constexpr int kSlab = 32;     // reduction slab
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(kThreads)
eigvec_rotate_kernel(const T* __restrict__ u, const T* __restrict__ z,
                     const double* __restrict__ d,
                     const double* __restrict__ org,
                     const double* __restrict__ tau,
                     const T* __restrict__ inv, const int* __restrict__ m_ptr,
                     T* __restrict__ out, int n, double guard) {
  const int m = repro::active_count(m_ptr, n);
  const int g = (m + kTile - 1) / kTile;     // active tiles per axis
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  if (blockIdx.x >= g || blockIdx.y >= g) {  // pruned tile: exact zeros
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = row0 + e / kTile, c = col0 + e % kTile;
      if (r < n && c < n) out[(size_t)r * n + c] = T(0);
    }
    return;
  }

  __shared__ T us[kSlab][kTile + 1];   // us[k][r] = U[row0 + r, k0 + k]
  __shared__ T ws[kSlab][kTile];       // ws[k][c] = W[k0 + k, col0 + c]
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < m; k0 += kSlab) {
    // U slab: a warp reads 32 consecutive entries of one row (coalesced).
#pragma unroll
    for (int i = 0; i < kTile * kSlab / kThreads; ++i) {
      const int kk = threadIdx.x % kSlab;
      const int r = threadIdx.x / kSlab + i * (kThreads / kSlab);
      const int gr = row0 + r, gk = k0 + kk;
      us[kk][r] = (gr < n && gk < m) ? u[(size_t)gr * n + gk] : T(0);
    }
    // W slab, generated from z, d, org, tau (rows >= m contribute nothing).
#pragma unroll
    for (int i = 0; i < kTile * kSlab / kThreads; ++i) {
      const int c = threadIdx.x % kTile;
      const int kk = threadIdx.x / kTile + i * (kThreads / kTile);
      const int gc = col0 + c, gk = k0 + kk;
      T w = T(0);
      if (gc < n && gk < m) {
        double den = (d[gk] - org[gc]) - tau[gc];
        if (fabs(den) < guard) den = den < 0 ? -guard : guard;
        w = z[gk] / static_cast<T>(den);
      }
      ws[kk][c] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kSlab; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = us[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < n && c < n) out[(size_t)r * n + c] = acc[i][j] * inv[c];
    }
  }
}

template <typename T>
int launch(const void* u, const void* z, const void* d, const void* org,
           const void* tau, const void* inv, const void* m, void* out, int n,
           double guard, void* stream) {
  const int tiles = (n + kTile - 1) / kTile;
  if (n > 0) {
    eigvec_rotate_kernel<T><<<dim3(tiles, tiles), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(z),
        static_cast<const double*>(d), static_cast<const double*>(org),
        static_cast<const double*>(tau), static_cast<const T*>(inv),
        static_cast<const int*>(m),
        static_cast<T*>(out), n, guard);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int eigvec_rotate_f32(const void* u, const void* z, const void* d,
                                 const void* org, const void* tau,
                                 const void* inv, const void* m, void* out,
                                 int n, double guard, void* stream) {
  return launch<float>(u, z, d, org, tau, inv, m, out, n, guard, stream);
}

extern "C" int eigvec_rotate_f64(const void* u, const void* z, const void* d,
                                 const void* org, const void* tau,
                                 const void* inv, const void* m, void* out,
                                 int n, double guard, void* stream) {
  return launch<double>(u, z, d, org, tau, inv, m, out, n, guard, stream);
}
