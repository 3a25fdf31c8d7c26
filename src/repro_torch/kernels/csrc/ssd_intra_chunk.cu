// Mamba-2 (SSD) intra-chunk term: for every chunk g and head h,
//   y[g, t, h] = sum_{s <= t} (c_t . b_s) exp(cum_t[h] - cum_s[h]) x[g, s, h]
// with the (Q, Q) score and decay tiles kept on chip.
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd_chunk/ssd_chunk.py::ssd_intra_chunk
//   (pallas_call at :60, body _kernel :28).
// The reference's model computes the same term inline (models/ssm.py
// _ssd_scan, :81-85); the port's _ssd_scan takes it from this kernel, for
// all chunks of a call in one launch.
//
// c, b (G, Q, N) and x (G, Q, H, P) of one type (float or bf16), cum
// (G, Q, H) float32 (within-chunk cumulative log decay), y (G, Q, H, P) in
// x's type; all row-major.  Q <= 256, P <= 64.
//
// Numerics, as the TPU kernel does them: scores c_t . b_s summed in
// float32; the decay's exponent cum_t - cum_s in float32, selected away
// for s > t BEFORE the exponential (cum falls with t, so exp(cum_t - cum_s)
// overflows above the diagonal, and a mask multiplied in would give
// inf * 0 = NaN); m = scores * decay rounded to x's type; y summed in
// float32 and rounded to x's type.
//
// What bounds it on an H100: bytes.  At Jamba's widths (G = 16: one
// sequence of 4096 in chunks of 256; N = 128, H = 256, P = 64, bf16 x) the
// call reads c, b, x, cum and writes y: 275 MB, 0.082 ms at 3.35 TB/s,
// against ~1.7e10 flops for the causal half (0.017 ms at 989 TFLOP/s).
// This is masked linear attention: one query/key pair (c, b) per chunk
// shared by every head, a value per head.
//
// Two kernels, chosen by the operands' type (a dispatch by type; neither
// stands in for the other):
//
// bfloat16, the LM path's type: ssd_intra_chunk_kernel_wgmma, on the
// tensor cores (wgmma, TMA, mbarriers; hopper.cuh).  The reference's
// numerics are what wgmma computes: bf16 x bf16 products summed in f32.
//   * A block takes 64 rows t of one chunk (t tile j) and a group of 16
//     heads.  Its scores S = C_t B_s^T against every s tile at or below the
//     diagonal are computed once (wgmma m64n64k16, c and b both K-major in
//     shared memory, as Q K^T in attention; tile s on warpgroup s % 2) and
//     kept in shared memory in float32 (64 x 256, 66 KB): every head of
//     the group reads them (the TPU kernel recomputes C B^T per head).
//   * Two consumer warpgroups take the group's heads in pairs, one head
//     each.  Per s tile a thread forms m = bf16(S * exp(cum_t - cum_s)) of
//     its 32 entries straight into the A fragments of the apply (the
//     accumulator layout of S is the A layout lane for lane, as P in
//     attention), the exponent selected to -inf above the diagonal and on
//     rows past Q before the exponential.  cum is staged once per block
//     as cum log2(e), so an entry's exponential is exp2f of one
//     difference: the scaling's rounding moves it by ~|cum| 2^-24
//     relative, far inside the bf16 rounding of m the bound allows.
//     exp2f keeps subnormal results, as the plain version's exp does (the
//     SFU's ex2.approx.ftz alone is faster but flushes them; PERF.md,
//     Findings PR 18).  Then y_h += m x_h
//     by wgmma m64n64k16 with A from registers and x_h's (s, p) tile read
//     in its rows through the transposed-B form.  The (head pair, s tile)
//     steps run as one stream with the m fragments double-buffered (the
//     loop unrolled by two): step k + 1's are formed while step k's
//     product runs, also across a change of head.  y is summed in float32
//     registers over all s tiles, rounded to bf16, staged by each warp
//     through its own 16 rows of a shared tile (no barrier beyond the
//     warp) and stored as whole 128-byte rows.
//   * One producer warp feeds a ring of 4 stages of 16 KB by TMA
//     (128-byte swizzle, mbarriers: `full` counts a stage's bytes in,
//     `empty` one arrival per consumer warp out): first c and the b tiles,
//     then for each head pair and s tile both heads' x tiles, through a
//     4-d tensor map over (P, H, Q, G), so rows past Q (and heads past H)
//     arrive as zeros.
//   * The t tiles of one (chunk, head group) are adjacent in launch order,
//     the longest rows first: tile j re-reads x's s tiles 0..j, which its
//     neighbours have just brought into L2.
//   * What bounds it as built: HBM and the forming of m.  On an H100 a
//     stripped copy that only loads x and stores y takes most of the
//     kernel's time (x's and y's rows are 128-byte pieces 32 KB apart);
//     the rest is the work on m that the ring does not hide.
//   * TMA needs 16-byte strides and the wgmma tiles 64-wide rows: the
//     wrapper (ssd_chunk/ops.py) zero-pads N to 64 or 128 and P to 64
//     where they are not (the zeros add nothing to a score or to y, and y
//     is written at its own P); Jamba's N = 128, P = 64 pass as they are.
//     184 KB of shared memory: one block of 288 threads on each SM.
//
// float32: ssd_intra_chunk_kernel, a SIMT kernel on the float32 CUDA cores
// (TF32 would miss the float32 bars).  The whole (Q, Q) float32 tile is
// 256 KB and does not fit a block's 227 KB, so a block of 256 threads
// takes 64 rows t of one chunk: it computes their scores against every s
// at or below its diagonal once (64 x 256 floats, tiles with s > t
// skipped) and keeps them in shared memory, then applies them to a group
// of 16 heads in turn.  For each head and each 64-wide s tile it forms the
// m tile in shared memory and accumulates y in registers (4 x 4 per
// thread).  103 KB of shared memory: two blocks on each SM; blocks of the
// longest rows (the last t tiles) are scheduled first.
#include "common.cuh"
#include "hopper.cuh"

namespace {
namespace simt {

constexpr int kTQ = 64;                // rows t per block, columns s per tile
constexpr int kSMax = 256;             // largest chunk Q
constexpr int kSlab = 32;              // state columns staged at a time
constexpr int kHG = 16;                // heads per block
constexpr int kLS = kSMax + 4;         // row stride of the score tile
constexpr int kLN = kSlab + 4;         // row stride of the c, b slabs
constexpr int kLT = kTQ + 4;           // row stride of the m and x tiles
constexpr int kThreads = 256;
// scores, then the larger of (c slab, b slab) and (m tile, x tile), then
// cum at the block's rows and at every s.
constexpr size_t kSmem =
    sizeof(float) * (kTQ * kLS + 2 * kTQ * kLT + kTQ + kSMax);

__global__ void __launch_bounds__(kThreads, 2)
ssd_intra_chunk_kernel(const float* __restrict__ c,
                       const float* __restrict__ b,
                       const float* __restrict__ x,
                       const float* __restrict__ cum, float* __restrict__ y,
                       int Q, int N, int H, int P) {
  extern __shared__ float4 smem4[];
  float* ss = reinterpret_cast<float*>(smem4);   // [kTQ][kLS] scores
  float* cs = ss + kTQ * kLS;                    // [kTQ][kLN] c slab
  float* bs = cs + kTQ * kLN;                    // [kTQ][kLN] b slab
  float* ms = ss + kTQ * kLS;                    // [kTQ][kLT] m tile
  float* xs = ms + kTQ * kLT;                    // [kTQ][kLT] x tile
  float* cum_t = xs + kTQ * kLT;                 // [kTQ]
  float* cum_s = cum_t + kTQ;                    // [kSMax]
  const int g = blockIdx.z;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * kTQ;   // longest rows first
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int s_end = min(t0 + kTQ, Q);            // s < s_end can be live
  const float* cg = c + (size_t)g * Q * N;
  const float* bg = b + (size_t)g * Q * N;

  // 1. Scores of rows 4 ty + i against s = st + tx + 16 j, for every s
  //    tile at or below the diagonal.
  for (int st = 0; st < s_end; st += kTQ) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int n0 = 0; n0 < N; n0 += kSlab) {
      __syncthreads();
      for (int e = threadIdx.x; e < kTQ * kSlab; e += kThreads) {
        const int r = e / kSlab, n = n0 + e % kSlab;
        const bool nin = n < N;
        cs[r * kLN + e % kSlab] =
            (nin && t0 + r < Q) ? cg[(size_t)(t0 + r) * N + n] : 0.f;
        bs[r * kLN + e % kSlab] =
            (nin && st + r < Q) ? bg[(size_t)(st + r) * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < kSlab; n += 4) {
        float4 a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(&cs[(4 * ty + i) * kLN + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bb[j] =
              *reinterpret_cast<const float4*>(&bs[(tx + 16 * j) * kLN + n]);
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
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ss[(4 * ty + i) * kLS + st + tx + 16 * j] = acc[i][j];
  }

  // 2. Each head of the block's group: y rows 4 ty + i, columns 4 tx + j.
  const int h_end = min((int)(blockIdx.x + 1) * kHG, H);
  for (int h = blockIdx.x * kHG; h < h_end; ++h) {
    __syncthreads();                 // scores written; last head's tiles read
    for (int e = threadIdx.x; e < kTQ + s_end; e += kThreads) {
      if (e < kTQ)
        cum_t[e] = t0 + e < Q ? cum[((size_t)g * Q + t0 + e) * H + h] : 0.f;
      else
        cum_s[e - kTQ] = cum[((size_t)g * Q + e - kTQ) * H + h];
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int st = 0; st < s_end; st += kTQ) {
      __syncthreads();               // cum staged; last tile's m, x read
      for (int e = threadIdx.x; e < kTQ * kTQ; e += kThreads) {
        const int r = e / kTQ, cc = e % kTQ;
        const int t = t0 + r, s = st + cc;
        float mv = 0.f;
        if (s <= t && t < Q)         // select, then exponentiate
          mv = ss[r * kLS + s] * expf(cum_t[r] - cum_s[s]);
        ms[r * kLT + cc] = mv;
        const int sx = st + r;
        xs[r * kLT + cc] =
            (sx < Q && cc < P) ? x[(((size_t)g * Q + sx) * H + h) * P + cc]
                               : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kTQ; kk += 4) {
        float4 ma[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ma[i] = *reinterpret_cast<const float4*>(&ms[(4 * ty + i) * kLT + kk]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 xv =
              *reinterpret_cast<const float4*>(&xs[(kk + u) * kLT + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float mv = u == 0 ? ma[i].x
                           : u == 1 ? ma[i].y
                           : u == 2 ? ma[i].z
                                    : ma[i].w;
            acc[i][0] = fmaf(mv, xv.x, acc[i][0]);
            acc[i][1] = fmaf(mv, xv.y, acc[i][1]);
            acc[i][2] = fmaf(mv, xv.z, acc[i][2]);
            acc[i][3] = fmaf(mv, xv.w, acc[i][3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + 4 * ty + i;
      if (t >= Q) continue;
      float* yrow = y + (((size_t)g * Q + t) * H + h) * P;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * tx + j < P) yrow[4 * tx + j] = acc[i][j];
    }
  }
}

int launch(const void* c, const void* b, const void* x, const void* cum,
           void* y, int G, int Q, int N, int H, int P, void* stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  if (G > 0 && Q > 0 && H > 0) {
    const dim3 grid((H + kHG - 1) / kHG, (Q + kTQ - 1) / kTQ, G);
    ssd_intra_chunk_kernel<<<grid, kThreads, kSmem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(c), static_cast<const float*>(b),
        static_cast<const float*>(x), static_cast<const float*>(cum),
        static_cast<float*>(y), Q, N, H, P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---- bfloat16: the wgmma kernel (tensor cores) ----
namespace wg {

namespace hw = repro::hopper;

constexpr int kT = 64;              // rows t per block: one warpgroup's M
constexpr int kS = 64;              // columns s per tile
constexpr int kBox = 64;            // bf16 per 128-byte swizzled row
constexpr int kBoxBytes = 64 * kBox * 2;    // a 64-row box: 8 KB
constexpr int kSMax = 256;          // largest chunk Q: at most 4 s tiles
constexpr int kNMax = 128;          // largest (padded) state N: 2 boxes
constexpr int kHG = 16;             // heads per block
constexpr int kStages = 4;
constexpr int kConsumers = 256;     // two warpgroups, a head each
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kLS = kSMax + 8;      // row stride of the scores (floats)
constexpr int kLC = kSMax + 2;      // row stride of cum, one row a head
constexpr int kLY = kBox + 8;       // row stride of the y staging (bf16)
constexpr float kLog2e = 1.4426950408889634f;

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Keeps an A fragment live (and unmoved) until here: the wgmma that reads
// it runs asynchronously, and a register reused before its wait would be
// serialised (ptxas C7513).
__device__ __forceinline__ void fence_fragments(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[c][r]) :: "memory");
}

// Boxes start on 1024-byte boundaries (the 128-byte swizzle's period).
struct Smem {
  __nv_bfloat16 ring[kStages][2][kS * kBox];   // a b tile or two x tiles
  __nv_bfloat16 c[kNMax / kBox][kT * kBox];
  float S[kT * kLS];
  float cum[kHG * kLC];
  __nv_bfloat16 ys[2][kT * kLY];
  uint64_t cbar;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kSmem = sizeof(Smem) + 1024;   // room to align to 1024

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Accumulator fragments (wgmma m64n64, float32): in warpgroup thread
// (warp w, lane l) entry 4 c + 2 i + e is row 16 w + l / 4 + 8 i, column
// 8 c + 2 (l % 4) + e of the 64 x 64 tile; as the A fragment of the next
// product, entries (c, i, 0..1) are register 2 (c % 2) + i of k16 step
// c / 2.
__global__ void __launch_bounds__(kThreads, 1)
ssd_intra_chunk_kernel_wgmma(const __grid_constant__ CUtensorMap cmap,
                             const __grid_constant__ CUtensorMap bmap,
                             const __grid_constant__ CUtensorMap xmap,
                             const float* __restrict__ cum,
                             __nv_bfloat16* __restrict__ y, int Q, int N,
                             int H, int P) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int g = blockIdx.z;
  const int j = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int t0 = j * kT;
  const int s_end = t0 + kT;                    // s tiles 0 .. j
  const int h0 = blockIdx.y * kHG;
  const int nh = min(kHG, H - h0);
  const int pairs = (nh + 1) / 2;
  const int nb = N / kBox;                      // state boxes: 1 or 2
  if (threadIdx.x == 0) {
    hw::mbar_init(&sm.cbar, 1);
    for (int st = 0; st < kStages; ++st) {
      hw::mbar_init(&sm.full[st], 1);
      hw::mbar_init(&sm.empty[st], kConsumers / 32);   // one per warp
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {              // the producer warp
    if (threadIdx.x == kConsumers) {
      hw::mbar_expect_tx(&sm.cbar, nb * kBoxBytes);
      for (int x = 0; x < nb; ++x)
        hw::tma_load_3d(sm.c[x], &cmap, &sm.cbar, x * kBox, t0, g);
      // Ring load q: the b tiles of s tiles 0 .. j, then per head pair
      // and s tile both heads' x tiles.
      auto acquire = [&sm](int q) {
        const int st = q % kStages;
        if (q >= kStages)
          hw::mbar_wait(&sm.empty[st], ((q / kStages) - 1) & 1);
        return st;
      };
      int q = 0;
      for (int si = 0; si <= j; ++si, ++q) {
        const int st = acquire(q);
        hw::mbar_expect_tx(&sm.full[st], nb * kBoxBytes);
        for (int x = 0; x < nb; ++x)
          hw::tma_load_3d(sm.ring[st][x], &bmap, &sm.full[st], x * kBox,
                          si * kS, g);
      }
      for (int p = 0; p < pairs; ++p)
        for (int si = 0; si <= j; ++si, ++q) {
          const int st = acquire(q);
          hw::mbar_expect_tx(&sm.full[st], 2 * kBoxBytes);
          for (int w = 0; w < 2; ++w)
            hw::tma_load_4d(sm.ring[st][w], &xmap, &sm.full[st], 0,
                            h0 + 2 * p + w, si * kS, g);
        }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const int rr = 16 * warp + lane / 4;          // local rows rr, rr + 8
  // A warp's arrival on a stage's `empty` once its products are done.
  auto release = [lane, &sm](int st) {
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&sm.empty[st]);
  };

  // cum log2(e) of the group's heads at every s < s_end, zero past Q and
  // past H; a thread's loads are all issued before its stores.
  {
    constexpr int kPer = kHG * kSMax / kConsumers;
    float v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = threadIdx.x + u * kConsumers;
      const int hh = e % kHG, s = e / kHG;
      v[u] = (s < s_end && s < Q && hh < nh)
                 ? cum[((size_t)g * Q + s) * H + h0 + hh] * kLog2e
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = threadIdx.x + u * kConsumers;
      if (e / kHG < s_end) sm.cum[(e % kHG) * kLC + e / kHG] = v[u];
    }
  }

  // 1. Scores of the block's rows against s tile si, on warpgroup si % 2;
  //    k16 steps over N, each inside one box's swizzled 128-byte row.
  hw::mbar_wait(&sm.cbar, 0);
  const uint32_t c_base = hw::smem_u32(sm.c[0]);
  for (int si = wg; si <= j; si += 2) {
    hw::mbar_wait(&sm.full[si], 0);
    const uint32_t b_base = hw::smem_u32(sm.ring[si][0]);
    float d[32];
    hw::wgmma_fence();
    for (int kk = 0; kk < 4 * nb; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      hw::wgmma_m64n64k16_ss(d, hw::sw128_desc(c_base + off, 16, 1024),
                             hw::sw128_desc(b_base + off, 16, 1024), kk > 0);
    }
    hw::wgmma_commit();
    hw::wgmma_wait_all();
    hw::fence_operands(d);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(
            &sm.S[(rr + 8 * i) * kLS + si * kS + 8 * c + 2 * tq]) =
            make_float2(d[4 * c + 2 * i], d[4 * c + 2 * i + 1]);
  }
  for (int si = 0; si <= j; ++si) release(si);
  hw::named_sync(1, kConsumers);               // S and cum complete

  // 2. Heads 2 p + wg of the group: y = sum over s tiles of m x.  The
  //    (pair, s tile) steps run as one stream, step k = (k / tiles,
  //    k % tiles) in the producer's order, so that the next head's first
  //    fragments are formed while this head's last product runs.
  const int ta = t0 + rr, tb = ta + 8;
  const float neg_inf = __int_as_float(0xff800000);
  const int tiles = j + 1, steps = pairs * tiles;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  // m of step k's s tile as the apply's A fragments.  A row past Q takes
  // cum = -inf, so its exponent is -inf and its m 0; on the diagonal tile
  // the exponent of s > t is selected to -inf before the exponential.
  auto fragments = [&](int k, uint32_t (&f)[4][4]) {
    const int si = k % tiles;
    const float* cm = sm.cum + (2 * (k / tiles) + wg) * kLC;
    const float ct[2] = {ta < Q ? cm[ta] : neg_inf, tb < Q ? cm[tb] : neg_inf};
    auto tile = [&](auto diag) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int s = si * kS + 8 * c + 2 * tq;
        const float2 cs = *reinterpret_cast<const float2*>(cm + s);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 sc = *reinterpret_cast<const float2*>(
              &sm.S[(rr + 8 * i) * kLS + s]);
          float e0 = ct[i] - cs.x, e1 = ct[i] - cs.y;
          if constexpr (decltype(diag)::value) {
            const int t = (i ? tb : ta) - s;
            e0 = 0 <= t ? e0 : neg_inf;
            e1 = 1 <= t ? e1 : neg_inf;
          }
          f[c / 2][2 * (c % 2) + i] =
              pack_bf16(sc.x * exp2f(e0), sc.y * exp2f(e1));
        }
      }
    };
    if (si == j)
      tile(Flag<true>{});
    else
      tile(Flag<false>{});
  };
  // y of pair p's head, rounded to bf16: the warp's 16 rows staged in its
  // own part of the tile, then stored as whole 128-byte rows.
  __nv_bfloat16* ys = sm.ys[wg] + 16 * warp * kLY;
  auto store = [&](int p) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(
            &ys[(lane / 4 + 8 * i) * kLY + 8 * c + 2 * tq]) =
            pack_bf16(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
    __syncwarp();
    const int hh = 2 * p + wg;
    if (hh < nh) {
      const size_t row0 = ((size_t)g * Q + t0 + 16 * warp) * H + h0 + hh;
      if (P == kBox) {
#pragma unroll
        for (int e = lane; e < 16 * 8; e += 32) {
          const int r = e / 8, ch = e % 8;
          if (t0 + 16 * warp + r < Q)
            *reinterpret_cast<uint4*>(y + (row0 + (size_t)r * H) * P +
                                      8 * ch) =
                *reinterpret_cast<const uint4*>(&ys[r * kLY + 8 * ch]);
        }
      } else {
        for (int e = lane; e < 16 * P; e += 32) {
          const int r = e / P, pc = e % P;
          if (t0 + 16 * warp + r < Q)
            y[(row0 + (size_t)r * H) * P + pc] = ys[r * kLY + pc];
        }
      }
    }
    __syncwarp();                                // staging read
  };
  // Step k: its product from f (a head's first one overwriting acc), step
  // k + 1's fragments into nf while it runs, then the head's y once its
  // last s tile is in.
  auto step = [&](int k, uint32_t (&f)[4][4], uint32_t (&nf)[4][4]) {
    const int si = k % tiles;
    const int q = tiles + k, st = q % kStages;
    hw::mbar_wait(&sm.full[st], (q / kStages) & 1);
    const uint32_t xb = hw::smem_u32(sm.ring[st][wg]);
    hw::fence_operands(acc);
    hw::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      hw::wgmma_m64n64k16_rs(
          acc, f[kc], hw::sw128_desc(xb + kc * 16 * 128, kBoxBytes, 1024),
          si > 0 || kc > 0);
    hw::wgmma_commit();
    if (k + 1 < steps) fragments(k + 1, nf);
    hw::wgmma_wait_all();
    hw::fence_operands(acc);
    fence_fragments(f);
    release(st);
    if (si == j) store(k / tiles);
  };
  uint32_t fa[4][4], fb[4][4];
  fragments(0, fa);
  int k = 0;
  for (; k + 1 < steps; k += 2) {      // fragments alternate fa, fb
    step(k, fa, fb);
    step(k + 1, fb, fa);
  }
  if (k < steps) step(k, fa, fb);
}

// 3-d map over c or b (N, Q, G): boxes of 64 columns x 64 rows of one
// chunk.  4-d map over x (64, H, Q, G): boxes of 64 columns x 1 head x 64
// rows of one chunk.  128-byte swizzle; reads past the edges as zeros.
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint32_t* box) {
  const hw::EncodeTiled fn = hw::encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t strides[3];
  cuuint64_t stride = 2;
  for (int d = 0; d + 1 < rank; ++d) strides[d] = stride *= dims[d];
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(const void* c, const void* b, const void* x, const void* cum,
           void* y, int G, int Q, int N, int H, int P, void* stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel_wgmma,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  if (G <= 0 || Q <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (hw::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t cdims[3] = {(cuuint64_t)N, (cuuint64_t)Q, (cuuint64_t)G};
  const cuuint32_t cbox[3] = {kBox, kT, 1};
  const cuuint64_t xdims[4] = {(cuuint64_t)kBox, (cuuint64_t)H,
                               (cuuint64_t)Q, (cuuint64_t)G};
  const cuuint32_t xbox[4] = {kBox, 1, kS, 1};
  CUtensorMap cm, bm, xm;
  if (!encode(&cm, c, 3, cdims, cbox) || !encode(&bm, b, 3, cdims, cbox) ||
      !encode(&xm, x, 4, xdims, xbox))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Q + kT - 1) / kT, (H + kHG - 1) / kHG, G);
  ssd_intra_chunk_kernel_wgmma<<<grid, kThreads, kSmem,
                                 static_cast<cudaStream_t>(stream)>>>(
      cm, bm, xm, static_cast<const float*>(cum),
      static_cast<__nv_bfloat16*>(y), Q, N, H, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
}  // namespace

extern "C" int ssd_intra_chunk_f32(const void* c, const void* b,
                                   const void* x, const void* cum, void* y,
                                   int G, int Q, int N, int H, int P,
                                   void* stream) {
  return simt::launch(c, b, x, cum, y, G, Q, N, H, P, stream);
}

// c and b hold N padded to 64 or 128 (N is that width), x holds P padded
// to 64, as ssd_chunk/ops.py pads them; y holds P.  All 16-byte aligned.
extern "C" int ssd_intra_chunk_bf16(const void* c, const void* b,
                                    const void* x, const void* cum, void* y,
                                    int G, int Q, int N, int H, int P,
                                    void* stream) {
  if (N % wg::kBox != 0 || N < wg::kBox || N > wg::kNMax || P < 1 ||
      P > wg::kBox || Q > wg::kSMax)
    return static_cast<int>(cudaErrorInvalidValue);
  return wg::launch(c, b, x, cum, y, G, Q, N, H, P, stream);
}
