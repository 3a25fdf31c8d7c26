// Mamba-2 (SSD) intra-chunk term, backward: dc, db, dx and dcum of
//   y[g, t, h] = sum_{s <= t} (c_t . b_s) exp(cum_t[h] - cum_s[h]) x[g, s, h]
// from the operands and the output's gradient dy.
//
// Replaces no TPU kernel of its own.  The TPU kernel
//   src/repro/kernels/ssd_chunk/ssd_chunk.py::ssd_intra_chunk
//   (:48, pallas_call at :60)
// has no custom_vjp: the reference trains through its jnp scan
// (models/ssm.py _ssd_scan, under jax.checkpoint), which XLA
// differentiates.  The port trains through its forward kernel
// (ssd_intra_chunk.cu), so the gradient of that kernel is this one;
// ssd_chunk/ops.py binds the two as a torch.autograd.Function.
//
// Layout as the forward's: c, b, dc, db (G, Q, N); x, dy, dx (G, Q, H, P);
// cum, dcum (G, Q, H) float32; all row-major.  Q <= 256, P <= 64.
//
// The function, per chunk g and head h, with S = C B^T, D_h[t, s] =
// exp(cum_t - cum_s) for s <= t (0 above) and M_h = S o D_h:
//   dx_h = m_h^T dy_h, m_h = M_h rounded to x's type (as the forward
//     applies it);
//   dM_h = (dy_h x_h^T) masked to s <= t, rounded to x's type (the
//     gradient through the forward's cast of m);
//   dS = sum_h dM_h o D_h over all H heads;  dc = dS B;  db = dS^T C;
//   Z_h = dM_h o M_h;  dcum[t, h] = sum_s Z_h[t, s] - sum_t' Z_h[t', t].
// Every sum in float32; dc, db, dx rounded once to the operands' type,
// dcum float32 (ssd_chunk/ref.py ssd_intra_chunk_bwd_ref, the plain
// version, rounds at the same points).  The exponent is selected away for
// s > t BEFORE the exponential, as in the forward: cum falls with t, so
// exp(cum_t - cum_s) overflows above the diagonal, and a mask multiplied
// in afterwards would give inf * 0 = NaN in dcum.
//
// What bounds it on an H100: bytes.  At Jamba's widths (G = 16 chunks of
// Q = 256, N = 128, H = 256 heads of P = 64, bf16) the call reads c, b, x,
// dy and cum and writes dc, db, dx and dcum: 415 MB, 0.124 ms at 3.35
// TB/s, against ~1.9e10 flops for the causal half (0.02 ms at 989
// TFLOP/s).  This kernel is the simple one: SIMT, float32 sums on the CUDA
// cores (~67 TFLOP/s), the products dy x^T and m^T dy each formed per
// head, so it sits well above that bound (PERF.md row 9b).
//
// No atomics: each output entry, and each partial sum, is summed by one
// thread in a fixed order, so two runs agree bit for bit.  Three kernels,
// launched in this order by one C entry (the dQ / dK-dV split of
// flash_attention_bwd.cu, by t tile and by s tile):
//   1. ssd_bwd_pair_kernel: a block per (64-row t tile, 64-column s tile
//      at or below it, chunk) walks all H heads in order.  It computes its
//      S tile once (kept in registers, 4 x 4 a thread), then per head stages
//      dy_h's t rows and x_h's s rows, forms dM_h (K = P), and accumulates
//      dS += dM_h o D_h in registers: dS's head sum is complete in the
//      block.  Z_h's row sums over the tile's 64 columns (a half-warp
//      butterfly) and column sums over its 64 rows (through shared memory,
//      16 partials a column added in order) go to two float32 scratch
//      arrays, one slot per (s tile) and per (t tile).  It writes its dS
//      tile (G, Q, Q) float32 to scratch (zeros above the diagonal).
//   2. ssd_bwd_dx_kernel: a block per (group of 16 heads, 64-row s tile,
//      chunk), the forward's SIMT kernel with t and s exchanged: S^T for
//      its s rows against every t at or after them is computed once and
//      kept in shared memory (64 x 256 floats); per head and t tile it
//      forms m^T in shared memory and accumulates dx_h = m_h^T dy_h in
//      registers.  Then dcum of its rows: the row halves over the s tiles
//      at or below, less the column halves over the t tiles at or after,
//      each added in tile order.
//   3. ssd_bwd_dcdb_kernel: a block per (64-row tile, chunk, output):
//      dc = dS B over s <= t and db = dS^T C over t >= s, from the dS
//      scratch, N in 64-wide slabs.
// Scratch (the wrapper's): dS G Q^2 floats (4 MB at Jamba's widths) and the
// two Z partials, G ceil(Q/64) H Q floats each (16.8 MB).
#include "common.cuh"

namespace {

constexpr int kTQ = 64;                // rows and columns of a tile
constexpr int kSMax = 256;             // largest chunk Q
constexpr int kHG = 16;                // heads per dx block
constexpr int kLT = kTQ + 4;           // row stride of the 64-wide tiles
constexpr int kLS = kSMax + 4;         // row stride of the S^T tile
constexpr int kThreads = 256;

// 1: two 64 x 64 tiles, Z's column partials (16 x 64), cum at t and s.
constexpr size_t kSmemPair =
    sizeof(float) * (2 * kTQ * kLT + 16 * kTQ + 2 * kTQ);
// 2: S^T (64 x 256), two 64 x 64 tiles, cum at s and at every t.
constexpr size_t kSmemDx =
    sizeof(float) * (kTQ * kLS + 2 * kTQ * kLT + kTQ + kSMax);
// 3: two 64 x 64 tiles.
constexpr size_t kSmemDcdb = sizeof(float) * 2 * kTQ * kLT;

// dst[r][k] (row stride kLT) = src[r * stride + k] as float for r < rows,
// k < cols; zeros elsewhere in the 64 x 64 tile.
template <typename T>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           size_t stride, int rows,
                                           int cols) {
  for (int e = threadIdx.x; e < kTQ * kTQ; e += kThreads) {
    const int r = e / kTQ, k = e % kTQ;
    dst[r * kLT + k] = (r < rows && k < cols)
                           ? repro::to_float(src[(size_t)r * stride + k])
                           : 0.f;
  }
}

// acc[i][j] += sum_k A[4 ty + i][k] * B[tx + 16 j][k] over the 64 columns
// of two staged tiles (rows of A against rows of B), k in order.
__device__ __forceinline__ void rows_dot(const float* A, const float* B,
                                         float (&acc)[4][4], int tx,
                                         int ty) {
#pragma unroll 4
  for (int k = 0; k < kTQ; k += 4) {
    float4 a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(4 * ty + i) * kLT + k]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bb[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * kLT + k]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = acc[i][j];
        t = fmaf(a[i].x, bb[j].x, t);
        t = fmaf(a[i].y, bb[j].y, t);
        t = fmaf(a[i].z, bb[j].z, t);
        acc[i][j] = fmaf(a[i].w, bb[j].w, t);
      }
  }
}

// acc[i][j] += sum_k A[4 ty + i][k] * B[k][4 tx + j] over the 64 columns
// of A (a row-by-matrix product of two staged tiles), k in order.
__device__ __forceinline__ void rows_times(const float* A, const float* B,
                                           float (&acc)[4][4], int tx,
                                           int ty) {
#pragma unroll 4
  for (int k = 0; k < kTQ; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(4 * ty + i) * kLT + k]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 bv =
          *reinterpret_cast<const float4*>(&B[(k + u) * kLT + 4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = u == 0 ? a[i].x
                       : u == 1 ? a[i].y
                       : u == 2 ? a[i].z
                                : a[i].w;
        acc[i][0] = fmaf(av, bv.x, acc[i][0]);
        acc[i][1] = fmaf(av, bv.y, acc[i][1]);
        acc[i][2] = fmaf(av, bv.z, acc[i][2]);
        acc[i][3] = fmaf(av, bv.w, acc[i][3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// 1. dS, and Z's row and column sums, of one (t tile, s tile) pair.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pair_kernel(const T* __restrict__ c, const T* __restrict__ b,
                const T* __restrict__ x, const float* __restrict__ cum,
                const T* __restrict__ dy, float* __restrict__ dS,
                float* __restrict__ rowpart, float* __restrict__ colpart,
                int Q, int N, int H, int P) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);   // [kTQ][kLT] c / dy rows
  float* bs = as + kTQ * kLT;                    // [kTQ][kLT] b / x rows
  float* zs = bs + kTQ * kLT;                    // [16][kTQ] column partials
  float* cum_t = zs + 16 * kTQ;                  // [kTQ]
  float* cum_s = cum_t + kTQ;                    // [kTQ]
  const int nt = (Q + kTQ - 1) / kTQ;
  const int g = blockIdx.y;
  int st = blockIdx.x, tt = 0;                   // pairs (tt, st <= tt)
  while (st > tt) {
    st -= tt + 1;
    ++tt;
  }
  const int t0 = tt * kTQ, s0 = st * kTQ;
  const int t_rows = min(kTQ, Q - t0), s_rows = min(kTQ, Q - s0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  // S[t, s] of rows 4 ty + i, columns tx + 16 j.
  float sv[4][4];
  zero(sv);
  for (int n0 = 0; n0 < N; n0 += kTQ) {
    __syncthreads();
    stage_tile(as, c + ((size_t)g * Q + t0) * N + n0, N, t_rows,
               min(kTQ, N - n0));
    stage_tile(bs, b + ((size_t)g * Q + s0) * N + n0, N, s_rows,
               min(kTQ, N - n0));
    __syncthreads();
    rows_dot(as, bs, sv, tx, ty);
  }

  float ds[4][4];
  zero(ds);
  const size_t hp = (size_t)H * P;
  for (int h = 0; h < H; ++h) {
    __syncthreads();                 // last head's tiles and partials read
    stage_tile(as, dy + ((size_t)g * Q + t0) * hp + (size_t)h * P, hp,
               t_rows, P);
    stage_tile(bs, x + ((size_t)g * Q + s0) * hp + (size_t)h * P, hp,
               s_rows, P);
    if (threadIdx.x < kTQ) {
      const int r = threadIdx.x;
      cum_t[r] = r < t_rows ? cum[((size_t)g * Q + t0 + r) * H + h] : 0.f;
      cum_s[r] = r < s_rows ? cum[((size_t)g * Q + s0 + r) * H + h] : 0.f;
    }
    __syncthreads();
    float dm[4][4];
    zero(dm);
    rows_dot(as, bs, dm, tx, ty);    // dy_t . x_s over P
    float rz[4] = {0.f, 0.f, 0.f, 0.f}, cz[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ty + i, cc = tx + 16 * j;
        const bool live = s0 + cc <= t0 + r && t0 + r < Q;
        // select, then exponentiate
        const float d = live ? expf(cum_t[r] - cum_s[cc]) : 0.f;
        const float dmr = live ? repro::round_to<T>(dm[i][j]) : 0.f;
        ds[i][j] += dmr * d;
        const float z = dmr * (sv[i][j] * d);
        rz[i] += z;
        cz[j] += z;
      }
    const size_t slot = (size_t)g * nt * H + h;  // + tile * H, then * Q
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = repro::half_warp_sum(rz[i]);
      const int t = t0 + 4 * ty + i;
      if (tx == 0 && t < Q) rowpart[(slot + (size_t)st * H) * Q + t] = v;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) zs[ty * kTQ + tx + 16 * j] = cz[j];
    __syncthreads();
    if (threadIdx.x < s_rows) {
      float v = 0.f;
      for (int k = 0; k < 16; ++k) v += zs[k * kTQ + threadIdx.x];
      colpart[(slot + (size_t)tt * H) * Q + s0 + threadIdx.x] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= t_rows) continue;
    float* row = dS + ((size_t)g * Q + t0 + r) * Q + s0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (tx + 16 * j < s_rows) row[tx + 16 * j] = ds[i][j];
  }
}

// 2. dx of one (head group, s tile, chunk), and dcum of its rows.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dx_kernel(const T* __restrict__ c, const T* __restrict__ b,
              const float* __restrict__ cum, const T* __restrict__ dy,
              const float* __restrict__ rowpart,
              const float* __restrict__ colpart, T* __restrict__ dx,
              float* __restrict__ dcum, int Q, int N, int H, int P) {
  extern __shared__ float4 smem4[];
  float* ss = reinterpret_cast<float*>(smem4);   // [kTQ][kLS] S^T, t - s0
  float* as = ss + kTQ * kLS;                    // [kTQ][kLT] b / m^T
  float* bs = as + kTQ * kLT;                    // [kTQ][kLT] c / dy rows
  float* cum_s = bs + kTQ * kLT;                 // [kTQ]
  float* cum_t = cum_s + kTQ;                    // [kSMax], t - s0
  const int nt = (Q + kTQ - 1) / kTQ;
  const int g = blockIdx.z, st = blockIdx.y, s0 = st * kTQ;
  const int s_rows = min(kTQ, Q - s0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  // S^T[s, t] = b_s . c_t of rows 4 ty + i, columns t = tt 64 + tx + 16 j,
  // for every t tile at or after the block's s tile.
  for (int tt = st; tt < nt; ++tt) {
    const int t0 = tt * kTQ;
    float acc[4][4];
    zero(acc);
    for (int n0 = 0; n0 < N; n0 += kTQ) {
      __syncthreads();
      stage_tile(as, b + ((size_t)g * Q + s0) * N + n0, N, s_rows,
                 min(kTQ, N - n0));
      stage_tile(bs, c + ((size_t)g * Q + t0) * N + n0, N,
                 min(kTQ, Q - t0), min(kTQ, N - n0));
      __syncthreads();
      rows_dot(as, bs, acc, tx, ty);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ss[(4 * ty + i) * kLS + t0 - s0 + tx + 16 * j] = acc[i][j];
  }

  const size_t hp = (size_t)H * P;
  const int h_end = min((int)(blockIdx.x + 1) * kHG, H);
  for (int h = blockIdx.x * kHG; h < h_end; ++h) {
    __syncthreads();                 // S^T written; last head's tiles read
    for (int e = threadIdx.x; e < kTQ + Q - s0; e += kThreads) {
      if (e < kTQ)
        cum_s[e] = e < s_rows ? cum[((size_t)g * Q + s0 + e) * H + h] : 0.f;
      else
        cum_t[e - kTQ] = cum[((size_t)g * Q + s0 + e - kTQ) * H + h];
    }
    float acc[4][4];
    zero(acc);
    for (int tt = st; tt < nt; ++tt) {
      const int t0 = tt * kTQ;
      __syncthreads();               // cum staged; last tile's m, dy read
      for (int e = threadIdx.x; e < kTQ * kTQ; e += kThreads) {
        const int r = e / kTQ, cc = e % kTQ;   // s = s0 + r, t = t0 + cc
        const int s = s0 + r, t = t0 + cc;
        float mv = 0.f;
        if (s <= t && t < Q)         // select, then exponentiate
          mv = repro::round_to<T>(ss[r * kLS + t - s0] *
                                  expf(cum_t[t - s0] - cum_s[r]));
        as[r * kLT + cc] = mv;
      }
      stage_tile(bs, dy + ((size_t)g * Q + t0) * hp + (size_t)h * P, hp,
                 min(kTQ, Q - t0), P);
      __syncthreads();
      rows_times(as, bs, acc, tx, ty);   // m^T[s, t] dy[t, p] over t
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + 4 * ty + i;
      if (s >= Q) continue;
      T* row = dx + ((size_t)g * Q + s) * hp + (size_t)h * P;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * tx + j < P)
          row[4 * tx + j] = repro::from_float<T>(acc[i][j]);
    }
    if (threadIdx.x < s_rows) {
      const int s = s0 + threadIdx.x;
      const size_t slot = (size_t)g * nt * H + h;
      float row = 0.f, col = 0.f;
      for (int k = 0; k <= st; ++k)
        row += rowpart[(slot + (size_t)k * H) * Q + s];
      for (int k = st; k < nt; ++k)
        col += colpart[(slot + (size_t)k * H) * Q + s];
      dcum[((size_t)g * Q + s) * H + h] = row - col;
    }
  }
}

// 3. dc = dS B (blockIdx.z 0) or db = dS^T C (1) of one 64-row tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dcdb_kernel(const T* __restrict__ c, const T* __restrict__ b,
                const float* __restrict__ dS, T* __restrict__ dc,
                T* __restrict__ db, int Q, int N) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);   // [kTQ][kLT] dS rows
  float* bs = as + kTQ * kLT;                    // [kTQ][kLT] b / c rows
  const int g = blockIdx.y, r0 = blockIdx.x * kTQ;
  const bool is_dc = blockIdx.z == 0;
  const int rows = min(kTQ, Q - r0);
  // dc sums over s < min(r0 + 64, Q), db over t >= r0: the tiles that
  // ssd_bwd_pair_kernel wrote (zeros across the diagonal within them).
  const int k_beg = is_dc ? 0 : r0, k_end = is_dc ? r0 + rows : Q;
  const T* other = is_dc ? b : c;
  T* out = is_dc ? dc : db;
  const float* dSg = dS + (size_t)g * Q * Q;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int n0 = 0; n0 < N; n0 += kTQ) {
    const int cols = min(kTQ, N - n0);
    float acc[4][4];
    zero(acc);
    for (int k0 = k_beg; k0 < k_end; k0 += kTQ) {
      const int ks = min(kTQ, k_end - k0);
      __syncthreads();
      for (int e = threadIdx.x; e < kTQ * kTQ; e += kThreads) {
        // dc: dS[r0 + r][k0 + k];  db: dS[k0 + k][r0 + r] (r fastest)
        const int r = is_dc ? e / kTQ : e % kTQ;
        const int k = is_dc ? e % kTQ : e / kTQ;
        float v = 0.f;
        if (r < rows && k < ks)
          v = is_dc ? dSg[(size_t)(r0 + r) * Q + k0 + k]
                    : dSg[(size_t)(k0 + k) * Q + r0 + r];
        as[r * kLT + k] = v;
      }
      stage_tile(bs, other + ((size_t)g * Q + k0) * N + n0, N, ks, cols);
      __syncthreads();
      rows_times(as, bs, acc, tx, ty);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      if (r >= rows) continue;
      T* row = out + ((size_t)g * Q + r0 + r) * N + n0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * tx + j < cols)
          row[4 * tx + j] = repro::from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* c, const void* b, const void* x, const void* cum,
           const void* dy, void* dc, void* db, void* dx, void* dcum,
           void* dS, void* rowpart, void* colpart, int G, int Q, int N,
           int H, int P, void* stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_dx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemDx);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  if (G <= 0 || Q <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (Q + kTQ - 1) / kTQ;
  const T* ct = static_cast<const T*>(c);
  const T* bt = static_cast<const T*>(b);
  const T* dyt = static_cast<const T*>(dy);
  const float* cumf = static_cast<const float*>(cum);
  float* dSf = static_cast<float*>(dS);
  float* rowf = static_cast<float*>(rowpart);
  float* colf = static_cast<float*>(colpart);
  ssd_bwd_pair_kernel<T><<<dim3(nt * (nt + 1) / 2, G), kThreads,
                           kSmemPair, s>>>(
      ct, bt, static_cast<const T*>(x), cumf, dyt, dSf, rowf, colf, Q, N, H,
      P);
  ssd_bwd_dx_kernel<T><<<dim3((H + kHG - 1) / kHG, nt, G), kThreads,
                         kSmemDx, s>>>(ct, bt, cumf, dyt, rowf, colf,
                                       static_cast<T*>(dx),
                                       static_cast<float*>(dcum), Q, N, H, P);
  ssd_bwd_dcdb_kernel<T><<<dim3(nt, G, 2), kThreads, kSmemDcdb, s>>>(
      ct, bt, dSf, static_cast<T*>(dc), static_cast<T*>(db), Q, N);
  return static_cast<int>(cudaGetLastError());
}

int check(int Q, int N, int P) {
  return (Q > kSMax || N < 1 || P < 1 || P > kTQ)
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

}  // namespace

// dS (G, Q, Q), rowpart and colpart (G, ceil(Q/64), H, Q): float32
// scratch, unread before this call writes them.
extern "C" int ssd_intra_chunk_bwd_f32(const void* c, const void* b,
                                       const void* x, const void* cum,
                                       const void* dy, void* dc, void* db,
                                       void* dx, void* dcum, void* dS,
                                       void* rowpart, void* colpart, int G,
                                       int Q, int N, int H, int P,
                                       void* stream) {
  if (const int rc = check(Q, N, P)) return rc;
  return launch<float>(c, b, x, cum, dy, dc, db, dx, dcum, dS, rowpart,
                       colpart, G, Q, N, H, P, stream);
}

extern "C" int ssd_intra_chunk_bwd_bf16(const void* c, const void* b,
                                        const void* x, const void* cum,
                                        const void* dy, void* dc, void* db,
                                        void* dx, void* dcum, void* dS,
                                        void* rowpart, void* colpart, int G,
                                        int Q, int N, int H, int P,
                                        void* stream) {
  if (const int rc = check(Q, N, P)) return rc;
  return launch<__nv_bfloat16>(c, b, x, cum, dy, dc, db, dx, dcum, dS,
                               rowpart, colpart, G, Q, N, H, P, stream);
}
