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
// Design: a simple SIMT kernel, no tensor cores yet.  The whole (Q, Q)
// float32 tile is 256 KB and does not fit a block's 227 KB, so a block of
// 256 threads takes 64 rows t of one chunk: it computes their scores
// against every s at or below its diagonal once (64 x 256 floats, tiles
// with s > t skipped) and keeps them in shared memory, then applies them
// to a group of 16 heads in turn (the TPU kernel recomputes C.B^T for
// every head: its grid is (G, H)).  For each head and each 64-wide s tile
// it forms the m tile in shared memory and accumulates y in registers
// (4 x 4 per thread).  103 KB of shared memory: two blocks on each SM;
// blocks of the longest rows (the last t tiles) are scheduled first.
#include "common.cuh"

namespace {

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

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_intra_chunk_kernel(const T* __restrict__ c, const T* __restrict__ b,
                       const T* __restrict__ x, const float* __restrict__ cum,
                       T* __restrict__ y, int Q, int N, int H, int P) {
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
  const T* cg = c + (size_t)g * Q * N;
  const T* bg = b + (size_t)g * Q * N;

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
            (nin && t0 + r < Q) ? repro::to_float(cg[(size_t)(t0 + r) * N + n])
                                : 0.f;
        bs[r * kLN + e % kSlab] =
            (nin && st + r < Q) ? repro::to_float(bg[(size_t)(st + r) * N + n])
                                : 0.f;
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
        ms[r * kLT + cc] = repro::round_to<T>(mv);
        const int sx = st + r;
        xs[r * kLT + cc] =
            (sx < Q && cc < P)
                ? repro::to_float(x[(((size_t)g * Q + sx) * H + h) * P + cc])
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
      T* yrow = y + (((size_t)g * Q + t) * H + h) * P;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * tx + j < P) yrow[4 * tx + j] = repro::from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* c, const void* b, const void* x, const void* cum,
           void* y, int G, int Q, int N, int H, int P, void* stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  if (G > 0 && Q > 0 && H > 0) {
    const dim3 grid((H + kHG - 1) / kHG, (Q + kTQ - 1) / kTQ, G);
    ssd_intra_chunk_kernel<T><<<grid, kThreads, kSmem,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(c), static_cast<const T*>(b),
        static_cast<const T*>(x), static_cast<const float*>(cum),
        static_cast<T*>(y), Q, N, H, P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_intra_chunk_f32(const void* c, const void* b,
                                   const void* x, const void* cum, void* y,
                                   int G, int Q, int N, int H, int P,
                                   void* stream) {
  return launch<float>(c, b, x, cum, y, G, Q, N, H, P, stream);
}

extern "C" int ssd_intra_chunk_bf16(const void* c, const void* b,
                                    const void* x, const void* cum, void* y,
                                    int G, int Q, int N, int H, int P,
                                    void* stream) {
  return launch<__nv_bfloat16>(c, b, x, cum, y, G, Q, N, H, P, stream);
}
