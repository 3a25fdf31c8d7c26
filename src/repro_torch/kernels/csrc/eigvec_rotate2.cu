// Fused double Cauchy rotation: the ±sigma pair of Algorithms 1 and 2 with
// one pass over U.
//
// Replaces the TPU kernel
//   src/repro/kernels/eigvec_update/eigvec_update.py::eigvec_rotate2
//   (pallas_call at :428, body _kernel2 :305, tile generator _w_tile :280).
//
// Computes C = U @ W1 @ W2 with two normalized Cauchy factors
//   W[k, j] = z[k] * inv[j] / ((d[k] - org[j]) - tau[j])    (ecol[j] < 0)
//   W[k, j] = (k == ecol[j])                                 (ecol[j] >= 0)
// ecol[j] >= 0 marks a deflated column, the identity column e_{cid[j]}
// (cid carries the sort between the two updates).  U is (n, n) row-major;
// z, inv in T; d, org, tau in double, the secular solve's type, with root
// j kept as its origin pole org[j] plus the offset tau[j]
// (repro_torch/core/rankone.py, _Roots), so each denominator keeps a close
// root's distance to its pole.  A denominator below `guard` becomes
// +-guard (eigvec_update/ref.py::_denominators), then it is rounded to T.
// Accumulates in T (float for f32, double for f64: the reference's
// promote(dtype, f32)).
//
// Design.  The TPU kernel keeps the intermediate row block U_rows @ W1,
// (block, Mp), in VMEM: 512 KB at Mp = 1024, block 128, f32, beyond the
// 227 KB of shared memory a Hopper block can have, and holding it in
// shared memory instead (one block per 32 rows) leaves 100 of the 132 SMs
// idle at m = 1000 (it ran 3.0 ms against a 0.06 ms bound).  Here the two
// factors are multiplied first, by association C = U @ (W1 @ W2):
//   1. factor_product: W12 = W1[:m, :m] @ W2[:m, :], both operands
//      generated slab by slab in shared memory from their vectors, into a
//      scratch matrix the wrapper allocates (n x n, which the 50 MB L2
//      holds at the service's sizes);
//   2. rotate: C = U[:, :m] @ W12[:m, :].
// Each is a 64 x 64-tiled product over the whole grid, 256 threads with a
// 4 x 4 register block each and 32-wide reduction slabs staged in shared
// memory, as eigvec_rotate.cu.  U is read once and C written once; the
// intermediate that touches U, U @ W1, never exists.  Nothing crosses
// blocks, so the result does not depend on scheduling.
//
// Pruning (the reference's _tile_counts, without a host read): the active
// count m is read by pointer; both reductions stop at k = m, W12 tiles at
// or beyond ceil(m / 64) in either axis are not computed (nothing reads
// them), and output tiles of C at or beyond ceil(m / 64) in either axis
// are written as exact zeros.  On the padding contract these are the
// true values of active columns; the caller puts U's own columns in place
// of inactive ones (within the active tiles they come out 0).
//
// What bounds it on an H100: operations, 4 m^3 (two m x m x m products) at
// the FP32 (or FP64) CUDA-core rate; TF32 tensor cores would miss the f32
// tolerances.
#include "common.cuh"

namespace {

constexpr int kTile = 64;     // output tile edge (rows and columns)
constexpr int kSlab = 32;     // reduction slab
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
struct Factor {
  const T* z;
  const double* d;
  const double* org;
  const double* tau;
  const T* inv;
  const int* ecol;

  __device__ __forceinline__ T at(int k, int j, double guard) const {
    const int e = ecol[j];
    if (e >= 0) return k == e ? T(1) : T(0);
    double den = (d[k] - org[j]) - tau[j];
    if (fabs(den) < guard) den = den < 0 ? -guard : guard;
    return (z[k] * inv[j]) / static_cast<T>(den);
  }
};

// acc += A_slab @ B_slab for one 32-wide slab staged as
// as[kk][r] = A[row0 + r, k0 + kk] and bs[kk][c] = B[k0 + kk, col0 + c].
template <typename T>
__device__ __forceinline__ void slab_fma(const T (*as)[kTile + 1],
                                         const T (*bs)[kTile], T acc[4][4],
                                         int tx, int ty) {
#pragma unroll 8
  for (int kk = 0; kk < kSlab; ++kk) {
    T a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
  }
}

// W12 = W1[:m, :m] @ W2[:m, :] on the active tiles, both factors
// generated in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
factor_product_kernel(Factor<T> f1, Factor<T> f2,
                      const int* __restrict__ m_ptr, T* __restrict__ w12,
                      int n, double guard) {
  const int m = repro::active_count(m_ptr, n);
  const int g = (m + kTile - 1) / kTile;
  if (blockIdx.x >= g || blockIdx.y >= g) return;   // never read
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  __shared__ T as[kSlab][kTile + 1];   // as[l][r] = W1[row0 + r, l0 + l]
  __shared__ T bs[kSlab][kTile];       // bs[l][c] = W2[l0 + l, col0 + c]
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int l0 = 0; l0 < m; l0 += kSlab) {
#pragma unroll
    for (int i = 0; i < kTile * kSlab / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int ll = e % kSlab, r = e / kSlab;
      const int gk = row0 + r, gl = l0 + ll;
      as[ll][r] = (gk < m && gl < m) ? f1.at(gk, gl, guard) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kTile * kSlab / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int c = e % kTile, ll = e / kTile;
      const int gl = l0 + ll, gj = col0 + c;
      bs[ll][c] = (gl < m && gj < n) ? f2.at(gl, gj, guard) : T(0);
    }
    __syncthreads();
    slab_fma(as, bs, acc, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < n && c < n) w12[(size_t)r * n + c] = acc[i][j];
    }
  }
}

// C = U[:, :m] @ W12[:m, :], pruned tiles written as exact zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rotate_kernel(const T* __restrict__ u, const T* __restrict__ w12,
              const int* __restrict__ m_ptr, T* __restrict__ out, int n) {
  const int m = repro::active_count(m_ptr, n);
  const int g = (m + kTile - 1) / kTile;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  if (blockIdx.x >= g || blockIdx.y >= g) {  // pruned tile: exact zeros
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = row0 + e / kTile, c = col0 + e % kTile;
      if (r < n && c < n) out[(size_t)r * n + c] = T(0);
    }
    return;
  }

  __shared__ T us[kSlab][kTile + 1];   // us[k][r] = U[row0 + r, k0 + k]
  __shared__ T ws[kSlab][kTile];       // ws[k][c] = W12[k0 + k, col0 + c]
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < m; k0 += kSlab) {
    // A warp reads 32 consecutive entries of one row of U, and 64 of one
    // row of W12 (coalesced).
#pragma unroll
    for (int i = 0; i < kTile * kSlab / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int kk = e % kSlab, r = e / kSlab;
      const int gr = row0 + r, gk = k0 + kk;
      us[kk][r] = (gr < n && gk < m) ? u[(size_t)gr * n + gk] : T(0);
    }
#pragma unroll
    for (int i = 0; i < kTile * kSlab / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int c = e % kTile, kk = e / kTile;
      const int gk = k0 + kk, gc = col0 + c;
      ws[kk][c] = (gk < m && gc < n) ? w12[(size_t)gk * n + gc] : T(0);
    }
    __syncthreads();
    slab_fma(us, ws, acc, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < n && c < n) out[(size_t)r * n + c] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* u, const void* z1, const void* d1, const void* org1,
           const void* tau1, const void* inv1, const void* ecol1,
           const void* z2, const void* d2, const void* org2, const void* tau2,
           const void* inv2, const void* ecol2, const void* m, void* w12,
           void* out, int n, double guard, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Factor<T> f1{static_cast<const T*>(z1), static_cast<const double*>(d1),
                     static_cast<const double*>(org1),
                     static_cast<const double*>(tau1),
                     static_cast<const T*>(inv1), static_cast<const int*>(ecol1)};
  const Factor<T> f2{static_cast<const T*>(z2), static_cast<const double*>(d2),
                     static_cast<const double*>(org2),
                     static_cast<const double*>(tau2),
                     static_cast<const T*>(inv2), static_cast<const int*>(ecol2)};
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  factor_product_kernel<T><<<grid, kThreads, 0, s>>>(
      f1, f2, static_cast<const int*>(m), static_cast<T*>(w12), n, guard);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rotate_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(w12),
      static_cast<const int*>(m), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_ROTATE2_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* u, const void* z1, const void* d1,         \
                      const void* org1, const void* tau1, const void* inv1,  \
                      const void* ecol1, const void* z2, const void* d2,     \
                      const void* org2, const void* tau2, const void* inv2,  \
                      const void* ecol2, const void* m, void* w12, void* out, \
                      int n, double guard, void* stream) {                   \
    return launch<T>(u, z1, d1, org1, tau1, inv1, ecol1, z2, d2, org2, tau2, \
                     inv2, ecol2, m, w12, out, n, guard, stream);            \
  }

REPRO_ROTATE2_ENTRY(eigvec_rotate2_f32, float)
REPRO_ROTATE2_ENTRY(eigvec_rotate2_f64, double)
