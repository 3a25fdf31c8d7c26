// Nystrom reconstruction K~ = B diag(s) B^T: the O(n^2 m) hot spot of the
// paper's section 4 evaluation (Fig. 2).
//
// Replaces the TPU kernel
//   src/repro/kernels/nystrom_recon/nystrom_recon.py::scaled_gram
//   (pallas_call at :49, body _kernel :21).
//
// B is (n, k) row-major (B = K_nm U, k the factor's width), s is (k,), the
// output (n, n) row-major.  The diagonal scale is applied to the left
// operand as it is read (as the TPU kernel scales its left tile in VMEM):
// a = b * s rounded to T, as the plain version's (B * s) rounds it, so the
// scaled copy of B never exists in device memory.  (The TPU kernel
// accumulates in float32 even for f64 B, preferred_element_type at :31;
// ROADMAP.md, "Faults found".)
//
// What bounds it on an H100: operations.  K~ is symmetric, so the function
// needs the n (n + 1) / 2 dot products of one triangle: n (n + 1) k flops
// (8.6 GFLOP at n = 4096, k = 512), against 4 n k + 4 n^2 bytes.
//
// One triangle.  The output is cut into 64 x 64 cells; a block computes a
// 128 x 64 tile, two row cells (2I, 2I + 1) by one column cell J, and the
// grid holds only the tiles with J >= 2I (a linear block index walks them
// row block by row block: 1056 blocks at n = 4096, where the full square
// takes 2048).  A cell above the diagonal (row cell < J) writes each entry
// and its mirror; a diagonal cell writes the entries on and above its
// diagonal and their mirrors; a cell below (only row cell 2I + 1 of the
// tiles J = 2I) writes nothing.  Each pair (i, j), (j, i) is so written
// from one value, and K~ equals its transpose bit for bit.  The stores go
// straight from the accumulators: a warp's store of the direct entries
// writes 8 rows x 32 bytes, of the mirrored ones 4 rows x 32 bytes, so
// every 32-byte sector is written whole and no staging is needed.
//
// float32: on the tensor cores as three TF32 products per k-step, the
// design of eigvec_rotate.cu's rotate_tf32_kernel (see its notes).  One
// TF32 pass keeps 11 bits of each operand, short of float32's 24; split
// each operand into a TF32 head and tail and uh wh + uh wl + ul wh misses
// u w by O(2^-21 |u w|) per product.  The right operand (rows j of B) is
// split once by split_planes_kernel into two planes of n x ldk floats,
// ldk = 32 ceil(k / 32), scratch the wrapper allocates (16 MB at
// n = 4096, k = 512: they stay in the 50 MB L2), k permuted within each
// 32-wide slab so that a thread's A values are two 16-byte vectors of its
// row.  The left operand comes by TMA in B's own rows (K-major already),
// is scaled by s and split in registers.  Each 32-wide slab's products
// start from a zeroed fragment and its sum is added into float32
// registers with FADD: Hopper's tensor cores add a product's terms with
// less than float32's rounding (summed over all of k, the rotation read
// 4.1-7.6x the float32 product's error; PERF.md, Findings PR 17).  Two
// consumer warpgroups (one row cell each, wgmma m64n64k8) and one
// producer warp that keeps a ring of 4 stages of 32 KB (B's rows 128 x 32
// and both planes' 64 x 32) in flight by TMA on mbarriers.  B's row
// stride must be a multiple of 16 bytes for TMA: the wrapper pads k to a
// multiple of 4 with zero columns (and s with zeros) where it is not.
// Bound: 3 n (n + 1) k at 495 TFLOP/s (0.0521 ms at 4096 x 512).
//
// float64: on the FP64 tensor cores (DMMA), mma.sync m16n8k8 with f64
// operands and accumulators, each product an IEEE float64 FMA.  256
// threads, 8 warps of 32 x 32 (4 along the rows, 2 along the columns;
// each warp inside one row cell), 2 x 4 m16n8 fragments each.  Slabs of
// 16 values of k of B's rows (128 x 16 and 64 x 16) and of s pass through
// a ring of 3 stages in shared memory by cp.async (rows padded to 20
// doubles: the fragment loads are free of bank conflicts); a scaled A
// value is b * s formed as it is loaded.  92 KB of shared memory: two
// blocks on each SM.  Bound: n (n + 1) k at 67 TFLOP/s (0.1282 ms).
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = repro::hopper;

constexpr int kCell = 64;           // output cells of 64 x 64
constexpr int kRows = 2 * kCell;    // a tile: two row cells ...
constexpr int kCols = kCell;        // ... by one column cell

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Tiles (I, J) with J >= 2I: row block I holds nc - 2I of them.
__host__ __device__ __forceinline__ int tile_count(int n) {
  const int nr = cdiv(n, kRows), nc = cdiv(n, kCols);
  return nr * nc - nr * (nr - 1);
}
__device__ __forceinline__ void tile_of(int b, int nc, int& I, int& J) {
  I = 0;
  for (int cnt = nc; b >= cnt; cnt -= 2) {
    b -= cnt;
    ++I;
  }
  J = 2 * I + b;
}

// Entry (rr, cc) of cell (ci, cj) with value v: written with its mirror
// where the cell lies on or above the diagonal (on it, where rr <= cc).
template <typename T>
__device__ __forceinline__ void put_sym(T* __restrict__ out, int n, int ci,
                                        int cj, int rr, int cc, T v) {
  if (ci > cj || (ci == cj && rr > cc)) return;
  const int r = ci * kCell + rr, c = cj * kCell + cc;
  if (r >= n || c >= n) return;
  out[(size_t)r * n + c] = v;
  if (r != c) out[(size_t)c * n + r] = v;
}

// --------------------------------------------- float32: TF32 x 3 product
namespace tc {

constexpr int kDepth = 32;          // slab of k: one 128-byte row
constexpr int kStages = 4;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr uint32_t kABytes = kRows * kDepth * 4;    // 16 KB
constexpr uint32_t kPBytes = kCols * kDepth * 4;    // 8 KB a plane

struct Smem {
  float a[kStages][kRows * kDepth];
  float bh[kStages][kCols * kDepth];
  float bl[kStages][kCols * kDepth];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kSmem = sizeof(Smem) + 1024;   // room to align to 1024

// Within a slab, plane position L holds k = 8 (L % 4) + 2 (L / 8) +
// (L / 4) % 2: a thread of lane t (= l % 4) then finds the values of its
// four TF32 k-steps in B's columns 8 t .. 8 t + 7 (as eigvec_rotate.cu).
__device__ __forceinline__ int slab_perm(int L) {
  return 8 * (L % 4) + 2 * (L / 8) + (L / 4) % 2;
}

// Head and tail planes of B (rows j < n, k < ldk, zeros past k); a warp
// writes 32 consecutive positions of one row.
__global__ void __launch_bounds__(256)
split_planes_kernel(const float* __restrict__ b, float* __restrict__ planes,
                    int n, int k, int ldk) {
  const int j = blockIdx.y * 8 + threadIdx.y;
  if (j >= n) return;
  const int L = threadIdx.x;
  const int kk = blockIdx.x * kDepth + slab_perm(L);
  const float v = kk < k ? b[(size_t)j * k + kk] : 0.f;
  const uint32_t head = hw::to_tf32(v);
  const size_t at = (size_t)j * ldk + blockIdx.x * kDepth + L;
  planes[at] = __uint_as_float(head);
  planes[(size_t)n * ldk + at] =
      __uint_as_float(hw::to_tf32(v - __uint_as_float(head)));
}

__device__ __forceinline__ void split(float x, uint32_t& head,
                                      uint32_t& tail) {
  head = hw::to_tf32(x);
  tail = hw::to_tf32(x - __uint_as_float(head));
}

// Accumulator fragments (wgmma m64n64, float32): in warpgroup thread
// (warp w, lane l) entry 4 c + 2 i + e is row 16 w + l / 4 + 8 i, column
// 8 c + 2 (l % 4) + e of the warpgroup's 64 x 64 cell.
__global__ void __launch_bounds__(kThreads, 1)
gram_tf32_kernel(const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap pmap,
                 const float* __restrict__ s, float* __restrict__ out, int n,
                 int k) {
  int I, J;
  tile_of(blockIdx.x, cdiv(n, kCols), I, J);
  const int row0 = I * kRows, col0 = J * kCols;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int slabs = cdiv(k, kDepth);
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
      for (int q = 0; q < slabs; ++q) {
        const int st = q % kStages;
        if (q >= kStages)
          hw::mbar_wait(&sm.empty[st], ((q / kStages) - 1) & 1);
        hw::mbar_expect_tx(&sm.full[st], kABytes + 2 * kPBytes);
        hw::tma_load_2d(sm.a[st], &bmap, &sm.full[st], q * kDepth, row0);
        hw::tma_load_3d(sm.bh[st], &pmap, &sm.full[st], q * kDepth, col0, 0);
        hw::tma_load_3d(sm.bl[st], &pmap, &sm.full[st], q * kDepth, col0, 1);
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

  // Slab q's A fragments of both rows, scaled and split: head[kk] /
  // tail[kk] are those of k-step kk.  The 128-byte swizzle puts 16-byte
  // chunk c of row r at chunk c ^ (r % 8); both rows are g modulo 8.
  // Columns past k arrive as zeros (TMA's fill), and so do their scales.
  auto fragments = [&](int q, uint32_t (&head)[4][4],
                       uint32_t (&tail)[4][4]) {
    const int st = q % kStages;
    const int k0 = q * kDepth + 8 * t;       // k % 4 == 0: whole float4s
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 s0 = k0 < k ? *reinterpret_cast<const float4*>(s + k0) : z;
    const float4 s1 =
        k0 + 4 < k ? *reinterpret_cast<const float4*>(s + k0 + 4) : z;
    hw::mbar_wait(&sm.full[st], (q / kStages) & 1);
    const float* ab = sm.a[st];
    float x[2][8];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* row = ab + (ra + 8 * r) * kDepth;
      const float4 c0 = *reinterpret_cast<const float4*>(
          row + ((2 * t) ^ g) * 4);                   // columns 8 t ..
      const float4 c1 = *reinterpret_cast<const float4*>(
          row + ((2 * t + 1) ^ g) * 4);               // 8 t + 4 ..
      x[r][0] = c0.x * s0.x; x[r][1] = c0.y * s0.y;
      x[r][2] = c0.z * s0.z; x[r][3] = c0.w * s0.w;
      x[r][4] = c1.x * s1.x; x[r][5] = c1.y * s1.y;
      x[r][6] = c1.z * s1.z; x[r][7] = c1.w * s1.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split(x[0][2 * kk], head[kk][0], tail[kk][0]);
      split(x[1][2 * kk], head[kk][1], tail[kk][1]);
      split(x[0][2 * kk + 1], head[kk][2], tail[kk][2]);
      split(x[1][2 * kk + 1], head[kk][3], tail[kk][3]);
    }
  };
  // Slab q's 12 products into `part`, the first of them overwriting it.
  auto issue = [&](int q, const uint32_t (&head)[4][4],
                   const uint32_t (&tail)[4][4]) {
    const int st = q % kStages;
    const uint32_t bh = hw::smem_u32(sm.bh[st]);
    const uint32_t bl = hw::smem_u32(sm.bl[st]);
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
  // Slab q: its products from (head, tail), slab q - 1's stage released,
  // slab q + 1's fragments into (nhead, ntail) while slab q's products
  // run, then acc += part once they are done.
  auto step = [&](int q, const uint32_t (&head)[4][4],
                  const uint32_t (&tail)[4][4], uint32_t (&nhead)[4][4],
                  uint32_t (&ntail)[4][4]) {
    hw::fence_operands(part);
    issue(q, head, tail);
    if (q > 0) {
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(&sm.empty[(q - 1) % kStages]);
    }
    if (q + 1 < slabs) fragments(q + 1, nhead, ntail);
    hw::wgmma_wait_all();
    hw::fence_operands(part);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += part[e];
  };
  uint32_t h0[4][4], t0[4][4], h1[4][4], t1[4][4];
  if (slabs > 0) fragments(0, h0, t0);
  int q = 0;
  for (; q + 1 < slabs; q += 2) {    // fragments alternate (h0, t0), (h1, t1)
    step(q, h0, t0, h1, t1);
    step(q + 1, h1, t1, h0, t0);
  }
  if (q < slabs) step(q, h0, t0, h1, t1);

  const int ci = 2 * I + wg;
  const int rr = 16 * warp + g;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        put_sym(out, n, ci, J, rr + 8 * i, 8 * c + 2 * t + e,
                acc[4 * c + 2 * i + e]);
}

// A 2-d (rows, ncols) float32 map with leading dim ld, or a 3-d one over
// `planes` such matrices; boxes of 32 columns (128 bytes) x box_rows,
// 128-byte swizzle, reads past the edges as zeros.
bool encode(CUtensorMap* map, const void* base, int ncols, int rows, int ld,
            int planes, int box_rows) {
  const hw::EncodeTiled fn = hw::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)ncols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4,
                                 (cuuint64_t)ld * 4 * rows};
  const cuuint32_t box[3] = {kDepth, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, planes > 1 ? 3 : 2,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

// ------------------------------------------------- float64: DMMA product
namespace dm {

constexpr int kDepth = 16;          // slab of k: 128 bytes of a row
constexpr int kLd = kDepth + 4;     // padded row (20 doubles)
constexpr int kStages = 3;
constexpr int kThreads = 256;

struct Stage {
  double a[kRows * kLd];
  double b[kCols * kLd];
  double s[kDepth];
};
constexpr size_t kSmem = kStages * sizeof(Stage);

// dst[0 .. bytes) = src, the rest of the `Size` bytes zero.
template <int Size>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               int bytes) {
  const uint32_t d = hw::smem_u32(dst);
  if constexpr (Size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(Size), "r"(bytes) : "memory");
}

// Slab q of B's rows row0 .. row0 + 127 (a) and col0 .. col0 + 63 (b) and
// of s into one stage; rows past n and columns past k arrive as zeros.
// Vec: 16-byte copies (k even and b 16-byte aligned); else 8 bytes.
template <bool Vec>
__device__ __forceinline__ void load_slab(Stage& st,
                                          const double* __restrict__ b,
                                          const double* __restrict__ s,
                                          int n, int k, int row0, int col0,
                                          int q) {
  constexpr int kUnit = Vec ? 2 : 1;
  constexpr int kPerRow = kDepth / kUnit;
  const int k0 = q * kDepth;
  for (int e = threadIdx.x; e < (kRows + kCols) * kPerRow; e += kThreads) {
    const int r = e / kPerRow, kk = (e % kPerRow) * kUnit;
    const int gr = r < kRows ? row0 + r : col0 + r - kRows;
    double* dst = r < kRows ? st.a + r * kLd + kk
                            : st.b + (r - kRows) * kLd + kk;
    const int live = gr < n ? min(kUnit, max(k - k0 - kk, 0)) : 0;
    cp_async_zfill<8 * kUnit>(dst, live ? b + (size_t)gr * k + k0 + kk : b,
                              8 * live);
  }
  if (threadIdx.x < kDepth) {
    const int gk = k0 + threadIdx.x;
    cp_async_zfill<8>(st.s + threadIdx.x, gk < k ? s + gk : s,
                      gk < k ? 8 : 0);
  }
}

template <bool Vec>
__global__ void __launch_bounds__(kThreads, 2)
gram_dmma_kernel(const double* __restrict__ b, const double* __restrict__ s,
                 double* __restrict__ out, int n, int k) {
  extern __shared__ float4 smem4[];
  Stage* stages = reinterpret_cast<Stage*>(smem4);
  int I, J;
  tile_of(blockIdx.x, cdiv(n, kCols), I, J);
  const int row0 = I * kRows, col0 = J * kCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = 32 * (warp % 4), wc = 32 * (warp / 4);   // warp's origin
  const int slabs = cdiv(k, kDepth);

  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < slabs) load_slab<Vec>(stages[q], b, s, n, k, row0, col0, q);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int q = 0; q < slabs; ++q) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
    __syncthreads();      // slab q landed; slab q - 1's stage is free
    if (q + kStages - 1 < slabs)
      load_slab<Vec>(stages[(q + kStages - 1) % kStages], b, s, n, k, row0,
                     col0, q + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const Stage& st = stages[q % kStages];
#pragma unroll
    for (int kb = 0; kb < kDepth; kb += 8) {
      const double s0 = st.s[kb + t], s1 = st.s[kb + t + 4];
      double bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const double* br = st.b + (wc + 8 * j + g) * kLd + kb + t;
        bf[j][0] = br[0];
        bf[j][1] = br[4];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const double* ar = st.a + (wr + 16 * i + g) * kLd + kb + t;
        const double af[4] = {ar[0] * s0, ar[8 * kLd] * s0, ar[4] * s1,
                              ar[8 * kLd + 4] * s1};
#pragma unroll
        for (int j = 0; j < 4; ++j) hw::dmma_m16n8k8(acc[i][j], af, bf[j]);
      }
    }
  }

  // Warp rows wr .. wr + 31 lie in row cell 2I (wr < 64) or 2I + 1.
  const int ci = 2 * I + wr / kCell;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        put_sym(out, n, ci, J, wr % kCell + 16 * i + g + 8 * (e / 2),
                wc + 8 * j + 2 * t + e % 2, acc[i][j][e]);
}

template <bool Vec>
cudaError_t launch(const double* b, const double* s, double* out, int n,
                   int k, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_dmma_kernel<Vec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  gram_dmma_kernel<Vec><<<tile_count(n), kThreads, kSmem, stream>>>(
      b, s, out, n, k);
  return cudaGetLastError();
}

}  // namespace dm

}  // namespace

// scratch: float32, two n x 32 ceil(k / 32) planes; float64, unused.  For
// float32, k is a multiple of 4 and b 16-byte aligned (TMA's strides), as
// nystrom_recon/ops.py makes them.
extern "C" int scaled_gram_f32(const void* b, const void* s, void* scratch,
                               void* out, int n, int k, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (k % 4 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(s) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc::gram_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tc::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  if (hw::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  const int ldk = cdiv(k, tc::kDepth) * tc::kDepth;
  CUtensorMap bmap, pmap;
  if (!tc::encode(&bmap, b, k, n, k, 1, kRows) ||
      !tc::encode(&pmap, scratch, ldk, n, ldk, 2, kCols))
    return static_cast<int>(cudaErrorInvalidValue);
  float* planes = static_cast<float*>(scratch);
  tc::split_planes_kernel<<<dim3(ldk / tc::kDepth, cdiv(n, 8)),
                            dim3(tc::kDepth, 8), 0, st>>>(
      static_cast<const float*>(b), planes, n, k, ldk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tc::gram_tf32_kernel<<<tile_count(n), tc::kThreads, tc::kSmem, st>>>(
      bmap, pmap, static_cast<const float*>(s), static_cast<float*>(out), n,
      k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scaled_gram_f64(const void* b, const void* s, void* scratch,
                               void* out, int n, int k, void* stream) {
  (void)scratch;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* bp = static_cast<const double*>(b);
  const double* sp = static_cast<const double*>(s);
  double* o = static_cast<double*>(out);
  const bool vec = k % 2 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const cudaError_t err = vec ? dm::launch<true>(bp, sp, o, n, k, st)
                              : dm::launch<false>(bp, sp, o, n, k, st);
  return static_cast<int>(err);
}
