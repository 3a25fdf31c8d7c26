// Cauchy-factor eigenvector rotation: the paper's O(m^3) hot spot.
//
// Replaces the TPU kernel
//   src/repro/kernels/eigvec_update/eigvec_update.py::eigvec_rotate
//   (pallas_call at :179).
//
// Computes C = (U @ W) * inv with W[k, j] = z[k] / ((d[k] - org[j]) - tau[j])
// for a row block U (R rows, leading dim ldu, its first row the state's row
// r0; R = n and r0 = 0 for the whole state), for each of nb tenants at
// once (the reference's pallas_call under jax.vmap).  Tenant b's operands
// follow tenant b - 1's, each of the single call's shape: U, C and the
// scratch by their whole extents, the vectors by n, the active count by
// one int.  The tenant is the grid's z axis: it picks which tile a block
// reads, never the order of a sum, so tenant b of a launch equals a launch
// on tenant b's operands alone bit for bit.  z, inv are (n,) in T; d,
// org, tau are (n,) in double, the secular solve's type: root j is org[j] +
// tau[j], kept as its origin pole and the offset from it
// (repro_torch/core/rankone.py, _Roots), so that d[k] - org[j] is exact for
// close poles and the root's distance to them keeps its digits.  Each
// denominator is formed in double, a denominator smaller than `guard`
// becomes +-guard (the guard under which inv was computed:
// eigvec_update/ref.py::offset_guard), then it is rounded to T and z[k] is
// divided by it; inv is applied after the sum, as the reference's _done.
//
// Pruning contract (the reference's _tile_counts, without a host read):
// the tenant's active count m is read by pointer; the reduction stops at k = m;
// output entries in columns at or beyond ceil(m / 64) * 64, or in rows at
// or beyond ceil(clamp(m - r0, 0, R) / 64) * 64, are exact zeros (64 is
// ops.ROTATE_TILE).  On the padding contract (z = inv = 0 beyond m, U
// identity on inactive columns) these zeros are the true values, and the
// caller overwrites inactive columns anyway.
//
// Two launches per call, both on the caller's stream:
//
// 1. The factor pass forms each entry of W[:m, :g64] once (g64 = 64 ceil(m
//    / 64), at most n) in the order above, into scratch the wrapper
//    allocates.  In float64 it writes W row-major (leading dim n).  In
//    float32 it writes W transposed (Wt[j, k], k contiguous: TF32 wgmma
//    takes both operands K-major) as two planes, head = tf32(w) and tail =
//    tf32(w - head), each n x ldw with ldw = 32 ceil(n / 32); within each
//    32-wide slab of k the entries are permuted (slab_perm below) so that
//    a thread's U fragments are two 16-byte vectors of its row.  The
//    planes of the nb tenants lie one after another.
//
// 2. The product.
//    float32: on the tensor cores as three TF32 products.  One TF32 pass
//    keeps 11 bits of each operand, far short of float32's 24.  Split each
//    operand into a TF32 head and a TF32 tail (u = uh + ul + O(2^-22 u)):
//    uh wh + uh wl + ul wh misses u w by O(2^-21 |u w|) per product (ul wl
//    and the tails' own rounding), the rounding of a float32 sum a few
//    times over, and each TF32 product is exact in float32.  Each 32-wide
//    slab of k takes the three products per 8-deep step, the two small
//    ones first: ul wh, uh wl, uh wh, accumulated in float32 fragments.
//    A block computes a 128 x 64 tile of C with two consumer warpgroups
//    (64 rows each, wgmma m64n64k8) and one producer warp.  The producer
//    brings U's slab (128 rows x 32 floats, row-major, so K-major already)
//    and the two Wt planes' slabs (64 x 32 each) into a ring of 4 stages
//    of 32 KB by TMA (128-byte swizzle; mbarriers: `full` counts a stage's
//    bytes in, `empty` one arrival per consumer warp out).  U's map has
//    the tenant as a third dimension (rows past R read as zeros within
//    the tenant: a box never reaches into the next tenant's rows) and the
//    planes' map it as a fourth.  A consumer
//    reads its U fragments from the stage (two 16-byte loads per row, free
//    of bank conflicts under the swizzle), splits them in registers and
//    issues wgmma with A from registers and B from shared memory.  The
//    fragments are double-buffered (the loop is unrolled by two), so slab
//    s + 1 is read and split while slab s's products run.
//    Hopper's tensor cores add a product's terms into the accumulator
//    with less than float32's rounding: summed over all of k at m = 1000,
//    the result was 4.1x the plain float32 product's error against float64
//    (7.6x on a row block; PERF.md, Findings).  So each slab's products
//    start from a zeroed fragment, and the slab's sum is added into
//    float32 registers with FADD: within 1.05x of the plain product's
//    error.
//    At n = 1024, m = 1000 the grid is 16 x 8 = 128 blocks: one wave on
//    the 132 SMs.  The planes (8 MB at n = 1024) stay in the 50 MB L2.
//    float64: on the CUDA cores, the register-blocked tile of
//    rotate_tile.cuh (128 x 64 tiles, 8 x 4 per thread, a three-stage
//    cp.async ring), its epilogue scaling by inv.
//
// What bounds it on an H100: operations.  At m = 1000 the float32 product
// is three TF32 passes, 3 * 2 m^3 = 6.0 GFLOP, 0.0121 ms at 495 TFLOP/s,
// against ~12 MB of operands (0.0036 ms); the float64 product is 2 m^3 at
// 67 TFLOP/s.  Nothing crosses blocks, so the result does not depend on
// scheduling.
#include "common.cuh"
#include "hopper.cuh"
#include "rotate_tile.cuh"

namespace {

namespace hw = repro::hopper;
namespace tl = repro::tile;

constexpr int kGranule = 64;        // pruning granule (ops.ROTATE_TILE)
constexpr int kDepth = 32;          // float32 slab of k: one 128-byte row

__host__ __device__ __forceinline__ int round_up(int x, int q) {
  return (x + q - 1) / q * q;
}

// Live columns g64 and live rows of the block.
__device__ __forceinline__ int live_cols(int m, int n) {
  return min(n, round_up(m, kGranule));
}
__device__ __forceinline__ int live_rows(int m, int r0, int R) {
  return min(R, round_up(min(max(m - r0, 0), R), kGranule));
}

__device__ __forceinline__ double guarded(double den, double guard) {
  return fabs(den) < guard ? (den < 0 ? -guard : guard) : den;
}

// Within a slab, Wt's k position L holds W's row 8 (L % 4) + 2 (L / 8) +
// (L / 4) % 2.  A thread of lane t (= l % 4) then finds the values of its
// four TF32 k-steps in U's columns 8 t .. 8 t + 7: for step kk, columns
// 8 t + 2 kk (fragment column t) and 8 t + 2 kk + 1 (column t + 4).
__device__ __forceinline__ int slab_perm(int L) {
  return 8 * (L % 4) + 2 * (L / 8) + (L / 4) % 2;
}

// ------------------------------------------------------------ factor pass
// float32: head and tail planes of Wt[j, k] (j < g64, k < 32 ceil(m / 32),
// zeros past m); a warp writes 32 consecutive k of one j.
__global__ void __launch_bounds__(256)
factor_planes_kernel(const float* __restrict__ z,
                     const double* __restrict__ d,
                     const double* __restrict__ org,
                     const double* __restrict__ tau,
                     const int* __restrict__ m_ptr, float* __restrict__ planes,
                     int n, int ldw, double guard) {
  const int b = blockIdx.z;                  // the tenant
  z += (size_t)b * n;
  d += (size_t)b * n;
  org += (size_t)b * n;
  tau += (size_t)b * n;
  planes += (size_t)b * 2 * n * ldw;
  const int m = repro::active_count(m_ptr + b, n);
  const int j = blockIdx.y * 8 + threadIdx.y;
  const int s = blockIdx.x;
  if (j >= live_cols(m, n) || s * kDepth >= m) return;
  const int L = threadIdx.x;
  const int k = s * kDepth + slab_perm(L);
  float w = 0.f;
  if (k < m)
    w = z[k] / static_cast<float>(guarded((d[k] - org[j]) - tau[j], guard));
  const uint32_t head = hw::to_tf32(w);
  const size_t at = (size_t)j * ldw + s * kDepth + L;
  planes[at] = __uint_as_float(head);
  planes[(size_t)n * ldw + at] = __uint_as_float(hw::to_tf32(
      w - __uint_as_float(head)));
}

// float64: W[k, j] row-major (k < m, j < g64); a thread takes one column
// and 8 rows, its column's values loaded once and its rows' loads issued
// together, so that a small bucket (capacity 256: 50 blocks) is not one
// long chain of loads per thread.
constexpr int kGenCols = 128;
constexpr int kGenRows = 8;

__global__ void __launch_bounds__(kGenCols)
factor_rows_kernel(const double* __restrict__ z,
                   const double* __restrict__ d,
                   const double* __restrict__ org,
                   const double* __restrict__ tau,
                   const int* __restrict__ m_ptr, double* __restrict__ w,
                   int n, double guard) {
  const int b = blockIdx.z;                  // the tenant
  z += (size_t)b * n;
  d += (size_t)b * n;
  org += (size_t)b * n;
  tau += (size_t)b * n;
  w += (size_t)b * n * n;
  const int m = repro::active_count(m_ptr + b, n);
  const int j = blockIdx.x * kGenCols + threadIdx.x;
  const int k0 = blockIdx.y * kGenRows;
  if (j >= live_cols(m, n) || k0 >= m) return;
  const double oj = org[j], tj = tau[j];
#pragma unroll
  for (int i = 0; i < kGenRows; ++i) {
    const int k = k0 + i;
    if (k < m) w[(size_t)k * n + j] = z[k] / guarded((d[k] - oj) - tj, guard);
  }
}

// ------------------------------------------------- float32: TF32 x 3 product
namespace tc {

constexpr int kRows = 128;          // tile rows: two warpgroups of 64
constexpr int kCols = 64;           // tile columns
constexpr int kStages = 4;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr uint32_t kUBytes = kRows * kDepth * 4;    // 16 KB
constexpr uint32_t kWBytes = kCols * kDepth * 4;    // 8 KB a plane

struct Smem {
  float u[kStages][kRows * kDepth];
  float wh[kStages][kCols * kDepth];
  float wl[kStages][kCols * kDepth];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kSmem = sizeof(Smem) + 1024;   // room to align to 1024

__device__ __forceinline__ void split(float x, uint32_t& head,
                                      uint32_t& tail) {
  head = hw::to_tf32(x);
  tail = hw::to_tf32(x - __uint_as_float(head));
}

// Accumulator fragments (wgmma m64n64, float32): in warpgroup thread
// (warp w, lane l) entry 4 c + 2 i + e is row 16 w + l / 4 + 8 i, column
// 8 c + 2 (l % 4) + e of the warpgroup's 64 x 64 tile.
__global__ void __launch_bounds__(kThreads, 1)
rotate_tf32_kernel(const __grid_constant__ CUtensorMap umap,
                   const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ inv,
                   const int* __restrict__ m_ptr, float* __restrict__ out,
                   int R, int n, int r0) {
  const int b = blockIdx.z;                  // the tenant
  inv += (size_t)b * n;
  out += (size_t)b * R * n;
  const int m = repro::active_count(m_ptr + b, n);
  const int lr = live_rows(m, r0, R);
  const int row0 = blockIdx.y * kRows, col0 = blockIdx.x * kCols;
  if (row0 >= lr || col0 >= live_cols(m, n)) {     // pruned: exact zeros
    for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
      const int r = row0 + e / kCols, c = col0 + e % kCols;
      if (r < R && c < n) out[(size_t)r * n + c] = 0.f;
    }
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int slabs = (m + kDepth - 1) / kDepth;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hw::mbar_init(&sm.full[st], 1);
      hw::mbar_init(&sm.empty[st], kConsumers / 32);   // one per warp
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {           // the producer warp
    if (threadIdx.x == kConsumers) {
      for (int s = 0; s < slabs; ++s) {
        const int st = s % kStages;
        if (s >= kStages)
          hw::mbar_wait(&sm.empty[st], ((s / kStages) - 1) & 1);
        hw::mbar_expect_tx(&sm.full[st], kUBytes + 2 * kWBytes);
        hw::tma_load_3d(sm.u[st], &umap, &sm.full[st], s * kDepth, row0, b);
        hw::tma_load_4d(sm.wh[st], &wmap, &sm.full[st], s * kDepth, col0, 0,
                        b);
        hw::tma_load_4d(sm.wl[st], &wmap, &sm.full[st], s * kDepth, col0, 1,
                        b);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = 64 * wg + 16 * warp + g;    // tile rows ra and ra + 8
  float acc[32], part[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = part[e] = 0.f;

  // Slab s's U fragments of both rows, split: head[kk] / tail[kk] are the
  // A fragments of k-step kk.  The 128-byte swizzle puts 16-byte chunk q
  // of row r at chunk q ^ (r % 8); both rows are g modulo 8.
  auto fragments = [&](int s, uint32_t (&head)[4][4],
                       uint32_t (&tail)[4][4]) {
    const int st = s % kStages;
    hw::mbar_wait(&sm.full[st], (s / kStages) & 1);
    const float* ub = sm.u[st];
    float x[2][8];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* row = ub + (ra + 8 * r) * kDepth;
      const float4 c0 = *reinterpret_cast<const float4*>(
          row + ((2 * t) ^ g) * 4);                   // columns 8 t ..
      const float4 c1 = *reinterpret_cast<const float4*>(
          row + ((2 * t + 1) ^ g) * 4);               // 8 t + 4 ..
      x[r][0] = c0.x; x[r][1] = c0.y; x[r][2] = c0.z; x[r][3] = c0.w;
      x[r][4] = c1.x; x[r][5] = c1.y; x[r][6] = c1.z; x[r][7] = c1.w;
    }
    const int left = m - s * kDepth - 8 * t;   // columns 8 t + e < m
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e >= left) x[r][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split(x[0][2 * kk], head[kk][0], tail[kk][0]);
      split(x[1][2 * kk], head[kk][1], tail[kk][1]);
      split(x[0][2 * kk + 1], head[kk][2], tail[kk][2]);
      split(x[1][2 * kk + 1], head[kk][3], tail[kk][3]);
    }
  };
  // Slab s's 12 products into `part`, the first of them overwriting it.
  auto issue = [&](int s, const uint32_t (&head)[4][4],
                   const uint32_t (&tail)[4][4]) {
    const int st = s % kStages;
    const uint32_t bh = hw::smem_u32(sm.wh[st]);
    const uint32_t bl = hw::smem_u32(sm.wl[st]);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hw::wgmma_m64n64k8_tf32_rs(part, tail[kk],
                                 hw::sw128_desc(bh + 32 * kk, 16, 1024),
                                 kk != 0);
      hw::wgmma_m64n64k8_tf32_rs(part, head[kk],
                                 hw::sw128_desc(bl + 32 * kk, 16, 1024), 1);
      hw::wgmma_m64n64k8_tf32_rs(part, head[kk],
                                 hw::sw128_desc(bh + 32 * kk, 16, 1024), 1);
    }
    hw::wgmma_commit();
  };
  // Slab s: its products from (head, tail), slab s - 1's stage released
  // (its products, which read (nhead, ntail), ended in its fold), slab
  // s + 1's fragments into (nhead, ntail) while slab s's products run,
  // then acc += part once they are done.
  auto step = [&](int s, const uint32_t (&head)[4][4],
                  const uint32_t (&tail)[4][4], uint32_t (&nhead)[4][4],
                  uint32_t (&ntail)[4][4]) {
    hw::fence_operands(part);
    issue(s, head, tail);
    if (s > 0) {
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(&sm.empty[(s - 1) % kStages]);
    }
    if (s + 1 < slabs) fragments(s + 1, nhead, ntail);
    hw::wgmma_wait_all();
    hw::fence_operands(part);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += part[e];
  };
  uint32_t h0[4][4], t0[4][4], h1[4][4], t1[4][4];
  fragments(0, h0, t0);
  int s = 0;
  for (; s + 1 < slabs; s += 2) {    // fragments alternate (h0, t0), (h1, t1)
    step(s, h0, t0, h1, t1);
    step(s + 1, h1, t1, h0, t0);
  }
  if (s < slabs) step(s, h0, t0, h1, t1);

  // C = acc * inv; rows at or beyond the live rows are exact zeros.
  const bool pair = (n % 2) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + ra + 8 * i;
    if (r >= R) continue;
    float* crow = out + (size_t)r * n;
    const bool live = r < lr;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = col0 + 8 * c + 2 * t;
      if (col >= n) continue;
      const float v0 = live ? acc[4 * c + 2 * i] * inv[col] : 0.f;
      if (pair) {
        const float v1 = live ? acc[4 * c + 2 * i + 1] * inv[col + 1] : 0.f;
        *reinterpret_cast<float2*>(crow + col) = make_float2(v0, v1);
      } else {
        crow[col] = v0;
        if (col + 1 < n)
          crow[col + 1] = live ? acc[4 * c + 2 * i + 1] * inv[col + 1] : 0.f;
      }
    }
  }
}

// A float32 map over `outer` stacked (rows, ncols) matrices with leading
// dim ld, each matrix following the last: rank 2 + the count of outer
// dimensions (the planes, the tenants).  Boxes of 32 columns (128 bytes)
// x box_rows x 1 ..., 128-byte swizzle, reads past each dimension's edge
// as zeros.
bool encode(CUtensorMap* map, const void* base, int ncols, int rows, int ld,
            const int* outer, int n_outer, int box_rows) {
  const hw::EncodeTiled fn = hw::encode_tiled();
  if (fn == nullptr || n_outer > 2) return false;
  cuuint64_t dims[4] = {(cuuint64_t)ncols, (cuuint64_t)rows, 1, 1};
  cuuint64_t strides[3] = {(cuuint64_t)ld * 4, (cuuint64_t)ld * 4 * rows, 0};
  for (int i = 0; i < n_outer; ++i) {
    dims[2 + i] = (cuuint64_t)outer[i];
    if (i > 0) strides[1 + i] = strides[i] * (cuuint64_t)outer[i - 1];
  }
  const cuuint32_t box[4] = {kDepth, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2 + n_outer,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

// float64: C tile = U[rows, :m] @ W[:m, tile] * inv on the CUDA cores.
template <bool Vec>
__global__ void __launch_bounds__(tl::kThreads)
rotate_f64_kernel(const double* __restrict__ u, int ldu,
                  const double* __restrict__ w,
                  const double* __restrict__ inv,
                  const int* __restrict__ m_ptr, double* __restrict__ out,
                  int R, int n, int r0) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.z;                  // the tenant
  u += (size_t)b * R * ldu;
  w += (size_t)b * n * n;
  inv += (size_t)b * n;
  out += (size_t)b * R * n;
  const int m = repro::active_count(m_ptr + b, n);
  const int lr = live_rows(m, r0, R), lc = live_cols(m, n);
  const int row0 = blockIdx.y * tl::kRows, col0 = blockIdx.x * tl::kCols;
  if (row0 >= lr || col0 >= lc) {
    tl::store_zeros(out, n, R, n, row0, col0);
    return;
  }
  double acc[8][4];
  tl::product<double, Vec>(acc, reinterpret_cast<double*>(smem4), u, ldu, R,
                           w, n, lc, m, row0, col0);
  tl::store<double, Vec>(acc, out, n, R, n, lr, lc, row0, col0, inv);
}

template <bool Vec>
cudaError_t product_f64(const double* u, int ldu, const double* w,
                        const double* inv, const int* m, double* out, int R,
                        int n, int r0, int nb, cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        rotate_f64_kernel<Vec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tl::Shape<double>::kSmem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const dim3 grid((n + tl::kCols - 1) / tl::kCols,
                  (R + tl::kRows - 1) / tl::kRows, nb);
  rotate_f64_kernel<Vec><<<grid, tl::kThreads, tl::Shape<double>::kSmem,
                           s>>>(u, ldu, w, inv, m, out, R, n, r0);
  return cudaGetLastError();
}

}  // namespace

// Per tenant (nb of them, one after another): scratch, float32, two
// n x 32 ceil(n / 32) planes, float64, one n x n matrix; U (R x n, leading
// dim ldu): for float32 ldu is a multiple of 4 and u 16-byte aligned
// (TMA's strides), as ops.rotate_vectors makes it; C (R x n); z, d, org,
// tau, inv (n); m (1).
extern "C" int eigvec_rotate_f32(const void* u, const void* z, const void* d,
                                 const void* org, const void* tau,
                                 const void* inv, const void* m,
                                 void* scratch, void* out, int R, int n,
                                 int ldu, int r0, int nb, double guard,
                                 void* stream) {
  if (R <= 0 || n <= 0 || nb <= 0)
    return static_cast<int>(cudaGetLastError());
  if (ldu % 4 != 0 || reinterpret_cast<uintptr_t>(u) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc::rotate_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tc::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  if (hw::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  const int ldw = round_up(n, kDepth);
  const int u_outer[1] = {nb}, w_outer[2] = {2, nb};
  CUtensorMap umap, wmap;
  if (!tc::encode(&umap, u, n, R, ldu, u_outer, 1, tc::kRows) ||
      !tc::encode(&wmap, scratch, ldw, n, ldw, w_outer, 2, tc::kCols))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* mp = static_cast<const int*>(m);
  float* planes = static_cast<float*>(scratch);
  factor_planes_kernel<<<dim3(ldw / kDepth, (n + 7) / 8, nb),
                         dim3(kDepth, 8), 0, s>>>(static_cast<const float*>(z),
                              static_cast<const double*>(d),
                              static_cast<const double*>(org),
                              static_cast<const double*>(tau), mp, planes, n,
                              ldw, guard);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + tc::kCols - 1) / tc::kCols,
                  (R + tc::kRows - 1) / tc::kRows, nb);
  tc::rotate_tf32_kernel<<<grid, tc::kThreads, tc::kSmem, s>>>(
      umap, wmap, static_cast<const float*>(inv), mp,
      static_cast<float*>(out), R, n, r0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int eigvec_rotate_f64(const void* u, const void* z, const void* d,
                                 const void* org, const void* tau,
                                 const void* inv, const void* m,
                                 void* scratch, void* out, int R, int n,
                                 int ldu, int r0, int nb, double guard,
                                 void* stream) {
  if (R <= 0 || n <= 0 || nb <= 0)
    return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mp = static_cast<const int*>(m);
  double* w = static_cast<double*>(scratch);
  factor_rows_kernel<<<dim3((n + kGenCols - 1) / kGenCols,
                            (n + kGenRows - 1) / kGenRows, nb),
                       kGenCols, 0, s>>>(
      static_cast<const double*>(z), static_cast<const double*>(d),
      static_cast<const double*>(org), static_cast<const double*>(tau), mp, w,
      n, guard);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies where every row of U, W and C starts on a 16-byte
  // boundary (every tenant's too: its U starts R ldu doubles on).
  const double* up = static_cast<const double*>(u);
  const bool vec = n % 2 == 0 && ldu % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(u) % 16 == 0;
  const double* iv = static_cast<const double*>(inv);
  double* o = static_cast<double*>(out);
  err = vec ? product_f64<true>(up, ldu, w, iv, mp, o, R, n, r0, nb, s)
            : product_f64<false>(up, ldu, w, iv, mp, o, R, n, r0, nb, s);
  return static_cast<int>(err);
}
