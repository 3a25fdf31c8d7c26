// Dense RBF gram G[i, j] = exp(-max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) / sigma)
// by the norm expansion, with the exp epilogue fused: G is written once and
// the distance matrix never exists in device memory.
//
// Replaces the TPU kernel
//   src/repro/kernels/rbf_gram/rbf_gram.py::rbf_gram
//   (pallas_call at :61, body _kernel :23).
//
// x is (n, d) and y (m, d), row-major; the output (n, m) row-major.  The
// TPU wrapper forms the row norms outside its pallas_call (:56-57) and pads
// n, m to 128 and d to a multiple of 8 with zeros; here each block sums the
// norms of its rows from the operands as it stages them (one launch per
// call) and masks the ragged edges: rows past n, m and features past d are
// staged as zeros, which add nothing to a norm or a dot product, and
// nothing is written outside (n, m).  Everything sums in T, and 1/sigma is
// formed in T: float for f32, double for f64.  (The TPU kernel sums in
// float32 even for f64 operands and casts 1/sigma to float32, :35, :58,
// :73; ROADMAP.md, "Faults found".)  The library exp/expf, no fast math.
//
// What bounds it on an H100: the bytes of G.  At the roofline's k(X, X)
// (n = m = 1024, d = 64, f32) 4.2 MB of G and 0.26 MB of x, 1.33 us at
// 3.35 TB/s, against one triangle's n (n + 1) (d + 2) flops (1.0 us at
// 67 TFLOP/s on the CUDA cores); at Fig. 2's full gram (n = m = 4096,
// d = 10, f64) 134 MB, 40 us, while its 8.4 M f64 exps must hide behind
// those stores.  Measured at 1024^2 (PERF.md, Findings PR 20): a fixed
// ~3.8 us at d = 1 (launch, staging, exp and the stores of G), then
// ~0.05 us per unit of d, the FMAs fed from shared memory at 1.5 float4
// reads per 8 FMAs a thread, which the shared memory's bandwidth holds
// to ~1/4 of the FP32 peak.
//
// One triangle.  The output is cut into square cells, one a block.  Where
// y is x (`sym`: the wrapper passes the same storage) the grid holds only
// the cells (I, J) with J >= I, a linear block index walking them row by
// row: n (n + 1) / 2 dot products and exps instead of n^2, x read once.  A
// cell above the diagonal writes each entry and its mirror, a diagonal
// cell the entries on and above its diagonal and their mirrors, so G
// equals its transpose bit for bit (scaled_gram.cu's schedule).  Otherwise
// the grid is every cell, with no mirror.
//
// Staging.  Slabs of 128 bytes of d (32 floats, 16 doubles) of the cell's
// x rows and y rows arrive in shared memory by cp.async (16-byte copies
// where d fills 16-byte rows, else one value a copy over the live columns
// only; rows past n, m and chunks past d are stored as zeros directly: no
// padded copy of the operands).  Where d takes more than one slab, two
// (f32) or four (f64) are in flight.  Threads 0 .. C-1 square the staged x
// rows and C .. 2C-1 the y rows (C the cell's side) as the slabs pass, in
// k order: each norm from the staged values, the same sum for a row as x
// and as y.
//
// float32: on the CUDA cores, each dot product a chain of float32 FMAs in
// k order.  Not TF32: three products of a two-way split miss the 2x error
// bar at d = 3, and six of a three-way split on wgmma ran slower than
// this at every shape measured (PERF.md, Findings PR 20).  32 x 32
// cells, 128 threads of 2 x 4 entries (rows ty, ty + 16, columns tx + 8 j):
// 528 blocks at n = 1024, four for each of the 132 SMs, where 64 x 64
// cells give 136 (four SMs take two) and ran 1.4x slower.  Per 4-wide step
// of k a thread reads its 2 x rows and 4 y rows as float4s (rows padded to
// 36 floats: a quarter-warp's 8 y rows fall in 8 distinct 16-byte bank
// groups) for 32 FMAs; the k-loop is unrolled over the slab, k-steps past
// d skipped.  The direct stores go from the registers, a warp 4 rows x 32
// bytes; the mirror goes through a transposed tile in shared memory (rows
// of 36: its writes free of bank conflicts) and leaves as float4 rows of
// G, a warp 4 rows x 128 bytes.
//
// float64: on the FP64 tensor cores (DMMA), mma.sync m16n8k8 with f64
// operands and accumulators, each product an IEEE float64 FMA
// (scaled_gram.cu's gram_dmma_kernel): 64 x 64 cells, sixteen warps of
// 16 x 16, two m16n8 fragments each, rows padded to 20 doubles (fragment
// loads free of bank conflicts); every slab of d <= 64 in flight at once,
// one wait.  d = 10 is one slab.  Two blocks an SM, so their exps and
// stores overlap.  The stores go straight from the fragments, two adjacent
// columns a thread: a warp's direct store writes 8 rows x 64 bytes, a
// mirrored one 4 rows x 64 bytes, so every 32-byte sector is written whole.
#include "common.cuh"
#include "hopper.cuh"
#include "rotate_tile.cuh"

namespace {

namespace hw = repro::hopper;
using repro::tile::cp_async_commit;
using repro::tile::cp_async_zfill;

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Cells of a launch on Cell x Cell cells: where sym, the cells (I, J),
// J >= I, of the n x n gram (row I holds nc - I of them); else every cell
// of the n x m gram.
__host__ __device__ __forceinline__ int cell_count(int n, int m, bool sym,
                                                   int cell) {
  const int nc = cdiv(m, cell);
  return sym ? nc * (nc + 1) / 2 : cdiv(n, cell) * nc;
}
__device__ __forceinline__ void cell_of(int b, int m, bool sym, int cell,
                                        int& I, int& J) {
  const int nc = cdiv(m, cell);
  if (!sym) {
    I = b / nc;
    J = b % nc;
    return;
  }
  I = 0;
  for (int cnt = nc; b >= cnt; --cnt) {
    b -= cnt;
    ++I;
  }
  J = I + b;
}

template <typename T>
struct Pair;
template <>
struct Pair<float> { using type = float2; };
template <>
struct Pair<double> { using type = double2; };

// G's entry from the dot product a and the two squared norms.
template <typename T>
__device__ __forceinline__ T gram_entry(T a, T xr, T yc, T inv_sigma) {
  return exp(-max(xr + yc - T(2) * a, T(0)) * inv_sigma);
}

// Entries (r, c) and (r, c + 1) of G (global indices, c even) from the dot
// products a0, a1, the norms xr of row r and yc0, yc1 of the columns.
// Where sym, a diagonal cell (diag) keeps the entries with r <= column and
// writes each with its mirror; any other cell writes both directly and,
// where sym, mirrored.  vec: m even (two adjacent entries one store).
template <typename T>
__device__ __forceinline__ void put_pair(T* __restrict__ out, int n, int m,
                                         bool sym, bool diag, bool vec,
                                         int r, int c, T a0, T a1, T xr,
                                         T yc0, T yc1, T inv_sigma) {
  const T g0 = gram_entry(a0, xr, yc0, inv_sigma);
  const T g1 = gram_entry(a1, xr, yc1, inv_sigma);
  if (r >= n) return;
  if (diag) {
    const T g[2] = {g0, g1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = c + e;
      if (cc < r || cc >= m) continue;
      out[(size_t)r * m + cc] = g[e];
      if (cc != r) out[(size_t)cc * m + r] = g[e];
    }
    return;
  }
  T* row = out + (size_t)r * m;
  if (vec && c + 1 < m) {
    using P = typename Pair<T>::type;
    P v;
    v.x = g0;
    v.y = g1;
    *reinterpret_cast<P*>(row + c) = v;
  } else {
    if (c < m) row[c] = g0;
    if (c + 1 < m) row[c + 1] = g1;
  }
  if (sym) {
    if (c < m) out[(size_t)c * m + r] = g0;
    if (c + 1 < m) out[(size_t)(c + 1) * m + r] = g1;
  }
}

// Slab q of the cell's x rows (row0 ..) and y rows (col0 ..) into the
// stage's tiles (leading dims ldl, ldr), by `Threads` threads.  The live
// values arrive by cp.async, 16 bytes a copy where Vec (d fills 16-byte
// rows, both bases 16-byte aligned), else one value a copy over the
// slab's first ceil(live / 16 bytes) chunks; rows past n, m and the chunks
// past d are stored as zeros directly.
template <typename T, bool Vec, int Threads, int Cell>
__device__ __forceinline__ void load_slab(T* ls, int ldl, T* rs, int ldr,
                                          const T* __restrict__ x,
                                          const T* __restrict__ y, int n,
                                          int m, int d, int row0, int col0,
                                          int q) {
  constexpr int kDepth = 128 / sizeof(T);
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kDepth / kVec;
  const int k0 = q * kDepth;
  auto at = [&](int r, int k) -> T* {
    return r < Cell ? ls + r * ldl + k : rs + (r - Cell) * ldr + k;
  };
  auto source = [&](int r, int k) -> const T* {
    const bool left = r < Cell;
    const int gr = left ? row0 + r : col0 + r - Cell;
    return gr < (left ? n : m) ? (left ? x : y) + (size_t)gr * d + k0 + k
                               : nullptr;
  };
  const int live = min(max(d - k0, 0), kDepth);   // live values of a row
  if constexpr (Vec) {
    for (int e = threadIdx.x; e < 2 * Cell * kChunks; e += Threads) {
      const int r = e / kChunks, k = (e % kChunks) * kVec;
      const T* src = source(r, k);
      if (src && k < live)
        cp_async_zfill<16>(at(r, k), src, 16);
      else
        *reinterpret_cast<uint4*>(at(r, k)) = make_uint4(0, 0, 0, 0);
    }
  } else {
    const int chunks = (live + kVec - 1) / kVec, width = chunks * kVec;
    for (int e = threadIdx.x; e < 2 * Cell * width; e += Threads) {
      const int r = e / width, k = e % width;
      const T* src = source(r, k);
      if (src && k < live)
        cp_async_zfill<static_cast<int>(sizeof(T))>(at(r, k), src,
                                                     sizeof(T));
      else
        *at(r, k) = T(0);
    }
    for (int e = threadIdx.x; e < 2 * Cell * (kChunks - chunks);
         e += Threads) {
      const int r = e / (kChunks - chunks);
      const int k = (chunks + e % (kChunks - chunks)) * kVec;
      *reinterpret_cast<uint4*>(at(r, k)) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// norm += the squares of a staged row, in k order, one 16-byte vector at
// a time.
__device__ __forceinline__ void add_squares(float& norm, const float* row) {
#pragma unroll
  for (int k = 0; k < 32; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + k);
    norm = fmaf(v.x, v.x, norm);
    norm = fmaf(v.y, v.y, norm);
    norm = fmaf(v.z, v.z, norm);
    norm = fmaf(v.w, v.w, norm);
  }
}
__device__ __forceinline__ void add_squares(double& norm, const double* row) {
#pragma unroll
  for (int k = 0; k < 16; k += 2) {
    const double2 v = *reinterpret_cast<const double2*>(row + k);
    norm = fma(v.x, v.x, norm);
    norm = fma(v.y, v.y, norm);
  }
}

// ------------------------------------------------ float32: CUDA-core FMAs
namespace fs {

constexpr int kCell = 32;             // output cells of 32 x 32, one a block
constexpr int kTx = 8;                // threads along a cell's columns
constexpr int kTy = 16;               // ... and along its rows
constexpr int kI = kCell / kTy;       // a thread's rows ...
constexpr int kJ = kCell / kTx;       // ... and columns: 2 x 4 entries
constexpr int kThreads = kTx * kTy;
constexpr int kDepth = 32;            // slab of d: one 128-byte row
constexpr int kLd = kDepth + 4;       // staged rows (16-byte aligned)
constexpr int kLdT = kCell + 4;       // the transposed tile of the mirror

struct Stage {
  float l[kCell * kLd];
  float r[kCell * kLd];
};
template <int S>
struct Smem {
  union {
    Stage st[S];
    float t[kCell * kLdT];            // t[c][r] = G[row0 + r, col0 + c]
  } u;
  float xn[kCell], yn[kCell];
};

// Thread (tx, ty) holds the entries of rows ty + 16 i, columns tx + 8 j of
// the cell.  S: slabs in flight (1 where d fills one).
template <bool Vec, int S>
__global__ void __launch_bounds__(kThreads)
rbf_gram_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ out, int n, int m, int d,
                    float inv_sigma, bool sym) {
  __shared__ __align__(16) Smem<S> sm;
  int I, J;
  cell_of(blockIdx.x, m, sym, kCell, I, J);
  const int row0 = I * kCell, col0 = J * kCell;
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int nr = threadIdx.x % kCell;
  const bool squares = threadIdx.x < 2 * kCell;
  const bool squares_x = threadIdx.x < kCell;
  const int slabs = cdiv(d, kDepth);

  float acc[kI][kJ];
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;
  float norm = 0.f;

  auto load = [&](int q) {
    if (q < slabs)
      load_slab<float, Vec, kThreads, kCell>(sm.u.st[q % S].l, kLd,
                                             sm.u.st[q % S].r, kLd, x, y, n,
                                             m, d, row0, col0, q);
    cp_async_commit();                 // possibly empty: keeps the count
  };
#pragma unroll
  for (int q = 0; q < S; ++q) load(q);
  for (int q = 0; q < slabs; ++q) {
    cp_async_wait<S - 1>();            // slabs 0 .. q have landed
    __syncthreads();                   // ... for every thread
    const float* ls = sm.u.st[q % S].l;
    const float* rs = sm.u.st[q % S].r;
    if (squares) add_squares(norm, (squares_x ? ls : rs) + nr * kLd);
    const int kend = min(d - q * kDepth, kDepth);
#pragma unroll
    for (int k = 0; k < kDepth; k += 4) {
      if (k >= kend) break;
      float4 a[kI], b[kJ];
#pragma unroll
      for (int i = 0; i < kI; ++i)
        a[i] = *reinterpret_cast<const float4*>(ls + (ty + kTy * i) * kLd +
                                                k);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        b[j] = *reinterpret_cast<const float4*>(rs + (tx + kTx * j) * kLd +
                                                k);
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
    if (q + S < slabs) __syncthreads();   // stage q is read
    load(q + S);
  }
  if (squares) (squares_x ? sm.xn : sm.yn)[nr] = norm;
  __syncthreads();                     // the norms; the stages are free

  const bool diag = sym && I == J;
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int rl = ty + kTy * i, cl = tx + kTx * j;
      const int r = row0 + rl, c = col0 + cl;
      const float g = gram_entry(acc[i][j], sm.xn[rl], sm.yn[cl], inv_sigma);
      if (r < n && c < m && (!diag || cl >= rl)) out[(size_t)r * m + c] = g;
      if (sym) sm.u.t[cl * kLdT + rl] = g;
    }
  if (!sym) return;
  __syncthreads();                     // the transposed tile is whole
  // The mirror: row c = col0 + cl of G gets columns row0 + rl .. + 3 from
  // t[cl][rl ..]; a diagonal cell only the entries below its diagonal
  // (rl < cl).  n = m here.
  const bool vec = m % 4 == 0;
  for (int e = threadIdx.x; e < kCell * kCell / 4; e += kThreads) {
    const int cl = e / (kCell / 4), rl = 4 * (e % (kCell / 4));
    const int c = col0 + cl, r = row0 + rl;
    if (c >= m || (diag && rl >= cl)) continue;
    const float4 v = *reinterpret_cast<const float4*>(sm.u.t + cl * kLdT +
                                                      rl);
    float* dst = out + (size_t)c * m + r;
    if (vec && r + 4 <= n && (!diag || rl + 3 < cl)) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float g[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4)
        if (r + e4 < n && (!diag || rl + e4 < cl)) dst[e4] = g[e4];
    }
  }
}

}  // namespace fs

// ------------------------------------------------- float64: DMMA product
namespace dm {

constexpr int kCell = 64;           // output cells of 64 x 64, one a block
constexpr int kThreads = 512;       // sixteen warps
constexpr int kDepth = 16;          // slab of d: 128 bytes of a row
constexpr int kLd = kDepth + 4;     // padded row (20 doubles)

struct Stage {
  double l[kCell * kLd];
  double r[kCell * kLd];
};
template <int S>
struct Smem {
  Stage st[S];
  double xn[kCell], yn[kCell];
};
template <int S>
constexpr size_t smem_bytes() { return sizeof(Smem<S>); }

// Sixteen warps of 16 x 16: warp w holds rows 16 (w % 4) .., columns
// 16 (w / 4) .. of the cell as two m16n8 fragments.  S: slabs in flight.
template <bool Vec, int S>
__global__ void __launch_bounds__(kThreads, 2)
rbf_gram_dmma_kernel(const double* __restrict__ x,
                     const double* __restrict__ y, double* __restrict__ out,
                     int n, int m, int d, double inv_sigma, bool sym) {
  extern __shared__ float4 smem4[];
  Smem<S>& sm = *reinterpret_cast<Smem<S>*>(smem4);
  int I, J;
  cell_of(blockIdx.x, m, sym, kCell, I, J);
  const int row0 = I * kCell, col0 = J * kCell;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = 16 * (warp % 4), wc = 16 * (warp / 4);   // warp's origin
  const int nr = threadIdx.x % kCell;
  const bool squares = threadIdx.x < 2 * kCell;
  const bool squares_x = threadIdx.x < kCell;
  const int slabs = cdiv(d, kDepth);

  double acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0;
  double norm = 0.0;

  auto load = [&](int q) {
    if (q < slabs)
      load_slab<double, Vec, kThreads, kCell>(sm.st[q % S].l, kLd,
                                              sm.st[q % S].r, kLd, x, y, n,
                                              m, d, row0, col0, q);
    cp_async_commit();
  };
#pragma unroll
  for (int q = 0; q < S; ++q) load(q);
  // Where every slab has a stage, one wait for all of them; else a ring.
  const bool ring = slabs > S;
  for (int q = 0; q < slabs; ++q) {
    if (ring) {
      cp_async_wait<S - 1>();          // slab q has landed
      __syncthreads();                 // ... for every thread
    } else if (q == 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    const double* ls = sm.st[q % S].l;
    const double* rs = sm.st[q % S].r;
#pragma unroll
    for (int kb = 0; kb < kDepth; kb += 8) {
      const double* ar = ls + (wr + g) * kLd + kb + t;
      const double af[4] = {ar[0], ar[8 * kLd], ar[4], ar[8 * kLd + 4]};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const double* br = rs + (wc + 8 * j + g) * kLd + kb + t;
        const double bf[2] = {br[0], br[4]};
        hw::dmma_m16n8k8(acc[j], af, bf);
      }
    }
    if (squares) add_squares(norm, (squares_x ? ls : rs) + nr * kLd);
    if (ring) {
      __syncthreads();                 // stage q is read
      load(q + S);
    }
  }
  if (squares) (squares_x ? sm.xn : sm.yn)[nr] = norm;
  __syncthreads();

  const bool diag = sym && I == J, vec = m % 2 == 0;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = wr + g + 8 * h, cc = wc + 8 * j + 2 * t;
      put_pair(out, n, m, sym, diag, vec, row0 + rr, col0 + cc,
               acc[j][2 * h], acc[j][2 * h + 1], sm.xn[rr], sm.yn[cc],
               sm.yn[cc + 1], inv_sigma);
    }
}

}  // namespace dm

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool Vec, int S>
cudaError_t run(const float* x, const float* y, float* out, int n, int m,
                int d, float inv_sigma, bool sym, cudaStream_t st) {
  fs::rbf_gram_f32_kernel<Vec, S>
      <<<cell_count(n, m, sym, fs::kCell), fs::kThreads, 0, st>>>(
          x, y, out, n, m, d, inv_sigma, sym);
  return cudaGetLastError();
}

template <bool Vec, int S>
cudaError_t run(const double* x, const double* y, double* out, int n, int m,
                int d, double inv_sigma, bool sym, cudaStream_t st) {
  static bool attr = false;
  const cudaError_t err = set_smem(dm::rbf_gram_dmma_kernel<Vec, S>,
                                   dm::smem_bytes<S>(), attr);
  if (err != cudaSuccess) return err;
  dm::rbf_gram_dmma_kernel<Vec, S>
      <<<cell_count(n, m, sym, dm::kCell), dm::kThreads, dm::smem_bytes<S>(),
         st>>>(x, y, out, n, m, d, inv_sigma, sym);
  return cudaGetLastError();
}

// One launch: 16-byte copies where d fills 16-byte rows and the operands
// and output start on 16 bytes; where d takes more than one slab, two
// (float32) or four (float64) slabs in flight, else one stage.
template <typename T>
int launch(const void* x, const void* y, void* out, int n, int m, int d,
           double sigma, int sym, void* stream) {
  if (n <= 0 || m <= 0) return static_cast<int>(cudaGetLastError());
  if (sym && n != m) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(out)) return static_cast<int>(cudaErrorMisalignedAddress);
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  T* o = static_cast<T*>(out);
  const T inv = T(1) / static_cast<T>(sigma);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % (16 / (int)sizeof(T)) == 0 && aligned16(x) &&
                   aligned16(y);
  constexpr int kDeep = sizeof(T) == 4 ? 2 : 4;
  const bool deep = d > 128 / (int)sizeof(T);
  const cudaError_t err =
      vec ? (deep ? run<true, kDeep>(xp, yp, o, n, m, d, inv, sym != 0, st)
                  : run<true, 1>(xp, yp, o, n, m, d, inv, sym != 0, st))
          : (deep ? run<false, kDeep>(xp, yp, o, n, m, d, inv, sym != 0, st)
                  : run<false, 1>(xp, yp, o, n, m, d, inv, sym != 0, st));
  return static_cast<int>(err);
}

}  // namespace

// sym: y is x (same storage, n == m); the kernel then computes one
// triangle and mirrors it.
extern "C" int rbf_gram_f32(const void* x, const void* y, void* out, int n,
                            int m, int d, double sigma, int sym,
                            void* stream) {
  return launch<float>(x, y, out, n, m, d, sigma, sym, stream);
}

extern "C" int rbf_gram_f64(const void* x, const void* y, void* out, int n,
                            int m, int d, double sigma, int sym,
                            void* stream) {
  return launch<double>(x, y, out, n, m, d, sigma, sym, stream);
}
