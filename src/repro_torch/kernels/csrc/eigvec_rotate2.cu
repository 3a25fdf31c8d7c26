// Fused double Cauchy rotation: the ±sigma pair of Algorithms 1 and 2 with
// one pass over U.
//
// Replaces the TPU kernel
//   src/repro/kernels/eigvec_update/eigvec_update.py::eigvec_rotate2
//   (pallas_call at :428, body _kernel2 :305, tile generator _w_tile :280).
//
// Computes C = U @ W1 @ W2 with two normalized Cauchy factors
//   W[k, j] = z[k] * inv[j] / ((d[k] - org[j]) - tau[j])    (defl[j] == 0)
//   W[k, j] = (k == cid[j])                                  (defl[j] > 0)
// defl[j] > 0 marks a deflated column, the identity column e_{cid[j]}
// (cid carries the sort between the two updates).  U is (R, n) row-major:
// the state (R = n) or a row block (below).  z, inv in T; d, org, tau in
// double, the secular solve's type, with root j kept as its origin pole
// org[j] plus the offset tau[j] (repro_torch/core/rankone.py, _Roots), so
// each denominator keeps a close root's distance to its pole.  A
// denominator below `guard` becomes +-guard
// (eigvec_update/ref.py::_denominators), then it is rounded to T.
// Accumulates in T (float for f32, double for f64: the reference's
// promote(dtype, f32)).
//
// Tenants (the reference's pallas_call under jax.vmap): one call serves nb
// tenants, each with operands of the single call's shape laid one after
// another (U and C by R x n, the factor vectors by n, the active count by
// one int, the scratch by three n x n matrices).  The tenant folds into
// the factor pass's z axis (z = 2 tenant + factor) and is the products' z
// axis: it picks the tile a block reads, never the order of a sum, so
// tenant b of a launch equals a launch on its operands alone bit for bit.
//
// Design.  The TPU kernel keeps the intermediate row block U_rows @ W1,
// (block, Mp), in VMEM: 512 KB at Mp = 1024, block 128, f32, beyond the
// 227 KB of shared memory a Hopper block can have.  Here the two factors
// are multiplied first, by association C = U @ (W1 @ W2), in three
// launches:
//   1. factor_kernel forms each entry of W1[:m, :m] and W2[:m, :g64] once
//      (g64 = 64 ceil(m / 64), at most n), in the order above (the
//      denominator in double with its guard, rounded to T, then
//      (z * inv) / den), into scratch the wrapper allocates;
//   2. W12 = W1[:m, :m] @ W2[:m, :g64];
//   3. C = U[:, :m] @ W12[:m, :].
// Both products run the register-blocked tile of rotate_tile.cuh: 128 x 64
// output tiles of 256 threads with 8 x 4 blocks in registers, 128-byte
// reduction slabs in a three-stage cp.async ring (at m = 1000, 128 blocks:
// one wave on the 132 SMs).  U is read once and C written once; the
// intermediate that touches U, U @ W1, never exists.  The scratch (three
// n x n matrices) stays in the 50 MB L2 at the service's sizes.  Nothing
// crosses blocks, so the result does not depend on scheduling.
//
// Row blocks (the reference's (R, M) block with row_offset): U may be
// rows r0 .. r0 + R of the state, R x n row-major, and C is then the same
// R rows of U @ W1 @ W2.  Launches 1 and 2 do not depend on U's rows and
// are the same for a block as for the state; launch 3 runs over the
// block's R / 128 row tiles.
//
// Pruning (the reference's _tile_counts, without a host read): the active
// count m is read by pointer; both reductions stop at k = m (the tile's
// copies fill past m with zeros), W12 tiles at or beyond g64 in either
// axis are not computed (nothing reads them), and entries of C at or
// beyond g64 columns, or at or beyond the block's live rows
// 64 ceil(clamp(m - r0, 0, R) / 64), are written as exact zeros: a tile
// wholly past either reads nothing of U.  On the padding contract these
// are the true values of active columns; the caller puts U's own columns
// in place of inactive ones (within the active tiles they come out 0).
// The pruning granule stays 64 (ops.ROTATE2_TILE).
//
// What bounds it on an H100: operations, 4 m^3 (two m x m x m products)
// at the FP32 (or FP64) CUDA-core rate.  For a block of r live rows the
// function needs 4 r m^2; this order does 2 m^3 + 2 r m^2, since every
// call forms W12 again (ROADMAP §1b: the shards of one sharded update
// should share one W12).
//
// ptxas reports 4 bytes of spill stores, all in factor_kernel<double>: it
// saves one register around its calls to the float64 division's slow-path
// subroutine (in SASS an STL before the CALLs and an LDL after them).  The
// product kernels, which the row blocks changed, do not spill.
#include "common.cuh"
#include "rotate_tile.cuh"

namespace {

namespace tl = repro::tile;

constexpr int kGranule = 64;          // pruning granule (ops.ROTATE2_TILE)
constexpr int kGenCols = 128;         // factor_kernel: columns per block
constexpr int kGenRows = 32;          //   and rows per block

template <typename T>
struct Factor {
  const T* z;
  const double* d;
  const double* org;
  const double* tau;
  const T* inv;
  const T* defl;
  const int* cid;
};

__host__ __device__ __forceinline__ int live_extent(int m, int n) {
  return min(n, (m + kGranule - 1) / kGranule * kGranule);
}

// W1[k, j] (k < m, j < m) and W2[k, j] (k < m, j < g64) into w1 and w2
// (leading dim n); blockIdx.z is 2 tenant + factor.  A thread takes one
// column and walks the block's rows, so its column's values load once.
template <typename T>
__global__ void __launch_bounds__(kGenCols)
factor_kernel(Factor<T> f1, Factor<T> f2, const int* __restrict__ m_ptr,
              T* __restrict__ scratch, int n, double guard) {
  const int b = blockIdx.z / 2;              // the tenant
  const size_t vb = (size_t)b * n;           // its vectors' offset
  const int m = repro::active_count(m_ptr + b, n);
  const bool second = blockIdx.z % 2 == 1;
  const int cols = second ? live_extent(m, n) : m;
  const int j = blockIdx.x * kGenCols + threadIdx.x;
  const int k0 = blockIdx.y * kGenRows;
  if (j >= cols || k0 >= m) return;
  // The factor's vectors by value (selecting a reference between the two
  // parameter structs would copy both to the stack).
  const T* z = (second ? f2.z : f1.z) + vb;
  const double* d = (second ? f2.d : f1.d) + vb;
  T* w = scratch + (size_t)n * n * (3 * b + (second ? 1 : 0));
  const size_t jb = vb + j;
  // A deflated column (defl > 0) is the identity column e_{cid[j]}.
  const int e = (second ? f2.defl[jb] : f1.defl[jb]) > T(0)
                    ? (second ? f2.cid[jb] : f1.cid[jb]) : -1;
  const double org = second ? f2.org[jb] : f1.org[jb];
  const double tau = second ? f2.tau[jb] : f1.tau[jb];
  const T inv = second ? f2.inv[jb] : f1.inv[jb];
  const int k1 = min(k0 + kGenRows, m);
  for (int k = k0; k < k1; ++k) {
    T v;
    if (e >= 0) {
      v = k == e ? T(1) : T(0);
    } else {
      double den = (d[k] - org) - tau;
      if (fabs(den) < guard) den = den < 0 ? -guard : guard;
      v = (z[k] * inv) / static_cast<T>(den);
    }
    w[(size_t)k * n + j] = v;
  }
}

// Live extent of rows r0 .. r0 + rows of an operand whose rows past the
// active count m are pruned: 64 ceil(clamp(m - r0, 0, rows) / 64), at most
// rows.
__device__ __forceinline__ int live_rows(int m, int r0, int rows) {
  return live_extent(min(max(m - r0, 0), rows), rows);
}

// second == false: W12 = W1[:m, :m] @ W2[:m, :g64], tiles past g64 skipped
// (rows = n, r0 = 0).  second == true: C = U[:, :m] @ W12[:m, :] for the
// `rows` rows of U from the state's row r0, entries past g64 columns or
// the live rows zero.  blockIdx.z is the tenant; sa, sb and sc are the
// tenants' strides of a, b and c in elements.
template <typename T, bool Vec>
__global__ void __launch_bounds__(tl::kThreads)
rotate_product_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const int* __restrict__ m_ptr, T* __restrict__ c, int n,
                      int rows, int r0, bool second, size_t sa, size_t sb,
                      size_t sc) {
  extern __shared__ float4 smem4[];
  const int t = blockIdx.z;                  // the tenant
  a += t * sa;
  b += t * sb;
  c += t * sc;
  const int m = repro::active_count(m_ptr + t, n);
  const int live_c = live_extent(m, n);
  const int live_r = live_rows(m, r0, rows);
  const int row0 = blockIdx.y * tl::kRows, col0 = blockIdx.x * tl::kCols;
  if (row0 >= live_r || col0 >= live_c) {
    if (second) tl::store_zeros(c, n, rows, n, row0, col0);
    return;
  }
  T acc[8][4];
  tl::product<T, Vec>(acc, reinterpret_cast<T*>(smem4), a, n,
                      second ? live_r : m, b, n, live_c, m, row0, col0);
  tl::store<T, Vec>(acc, c, n, rows, n, live_r, live_c, row0, col0, nullptr);
}

template <typename T, bool Vec>
cudaError_t products(const T* u, const T* w1, const T* w2, T* w12, T* out,
                     const int* m, int n, int rows, int r0, int nb,
                     cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        rotate_product_kernel<T, Vec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tl::Shape<T>::kSmem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const int col_tiles = (n + tl::kCols - 1) / tl::kCols;
  const size_t nn = (size_t)n * n, scr = 3 * nn, blk = (size_t)rows * n;
  rotate_product_kernel<T, Vec>
      <<<dim3(col_tiles, (n + tl::kRows - 1) / tl::kRows, nb), tl::kThreads,
         tl::Shape<T>::kSmem, s>>>(w1, w2, m, w12, n, n, 0, false, scr, scr,
                                   scr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || rows <= 0) return err;
  rotate_product_kernel<T, Vec>
      <<<dim3(col_tiles, (rows + tl::kRows - 1) / tl::kRows, nb),
         tl::kThreads, tl::Shape<T>::kSmem, s>>>(u, w12, m, out, n, rows, r0,
                                                 true, blk, scr, blk);
  return cudaGetLastError();
}

template <typename T>
Factor<T> factor(const void* z, const void* d, const void* org,
                 const void* tau, const void* inv, const void* defl,
                 const void* cid) {
  return {static_cast<const T*>(z), static_cast<const double*>(d),
          static_cast<const double*>(org), static_cast<const double*>(tau),
          static_cast<const T*>(inv), static_cast<const T*>(defl),
          static_cast<const int*>(cid)};
}

// Per tenant (nb of them, one after another): scratch, three n x n
// matrices, W1, W2 and W12; u and out, rows x n; the factor vectors, n;
// m, one int.
template <typename T>
int launch(const void* u, const void* z1, const void* d1, const void* org1,
           const void* tau1, const void* inv1, const void* defl1,
           const void* cid1,
           const void* z2, const void* d2, const void* org2, const void* tau2,
           const void* inv2, const void* defl2, const void* cid2,
           const void* m, void* scratch, void* out, int n, int rows, int r0,
           int nb, double guard, void* stream) {
  if (n <= 0 || nb <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* w1 = static_cast<T*>(scratch);
  T* w2 = w1 + (size_t)n * n;
  T* w12 = w2 + (size_t)n * n;
  const int* mp = static_cast<const int*>(m);
  const dim3 gen((n + kGenCols - 1) / kGenCols,
                 (n + kGenRows - 1) / kGenRows, 2 * nb);
  factor_kernel<T><<<gen, kGenCols, 0, s>>>(
      factor<T>(z1, d1, org1, tau1, inv1, defl1, cid1),
      factor<T>(z2, d2, org2, tau2, inv2, defl2, cid2), mp, w1, n, guard);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies where every row starts on a 16-byte boundary (every
  // tenant's too: its blocks start a multiple of n values on).
  const bool vec = (n % tl::Shape<T>::kVec) == 0 &&
                   reinterpret_cast<uintptr_t>(u) % 16 == 0;
  const T* up = static_cast<const T*>(u);
  T* o = static_cast<T*>(out);
  err = vec ? products<T, true>(up, w1, w2, w12, o, mp, n, rows, r0, nb, s)
            : products<T, false>(up, w1, w2, w12, o, mp, n, rows, r0, nb,
                                 s);
  return static_cast<int>(err);
}

}  // namespace

#define REPRO_ROTATE2_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* u, const void* z1, const void* d1,         \
                      const void* org1, const void* tau1, const void* inv1,  \
                      const void* defl1, const void* cid1, const void* z2,   \
                      const void* d2, const void* org2, const void* tau2,    \
                      const void* inv2, const void* defl2, const void* cid2, \
                      const void* m, void* scratch, void* out, int n,        \
                      int rows, int r0, int nb, double guard,                \
                      void* stream) {                                        \
    return launch<T>(u, z1, d1, org1, tau1, inv1, defl1, cid1, z2, d2, org2, \
                     tau2, inv2, defl2, cid2, m, scratch, out, n, rows, r0,  \
                     nb, guard, stream);                                     \
  }

REPRO_ROTATE2_ENTRY(eigvec_rotate2_f32, float)
REPRO_ROTATE2_ENTRY(eigvec_rotate2_f64, double)
