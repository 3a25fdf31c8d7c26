// Causal flash attention, backward: dQ, dK and dV of the prefill's softmax
// attention, from q, k, v, the forward's output o and its gradient dO.
//
// Replaces no TPU kernel of its own.  The TPU kernel
//   src/repro/kernels/flash_attn/flash_attn.py::flash_attention
//   (:73, pallas_call at :93)
// has no custom_vjp: the reference trains through its jnp attention
// (models/layers.py), which XLA differentiates.  The port trains through
// its forward kernel (flash_attention.cu), so the gradient of that kernel
// is this one; flash_attn/ops.py binds the two as a torch.autograd.Function.
//
// Layout as the model holds it: q, o, dO and dQ (B, T, H, hd); k, v, dK and
// dV (B, T, Hkv, hd), row-major, hd <= 128 unpadded.  Query head h reads kv
// head h / (H / Hkv).  lse and dsum are float32 (B, H, T) scratch the
// wrapper allocates.
//
// The function, with S = Q K^T / sqrt(hd) masked to s <= t:
//   P = exp(S - lse), lse the row's log-sum-exp;  D = rowsum(dO o o);
//   dV = P^T dO;  dP = dO V^T;  dS = P o (dP - D);
//   dQ = dS K / sqrt(hd);  dK = dS^T Q / sqrt(hd).
// dK and dV of kv head j sum over the H / Hkv query heads of its group.
//
// Two kernels, launched in this order by one C entry point:
//   1. bwd_dq_kernel: a block per (q head, 64 query rows, batch).  Pass 1
//      walks the key tiles at or below its diagonal for each row's running
//      max and sum (the forward's online softmax) and writes lse; it also
//      writes D from o and dO.  Pass 2 walks the tiles again: S and dP, P
//      and dS, then dQ += dS K.
//   2. bwd_dkdv_kernel: a block per (kv head, 64 keys, batch).  It keeps
//      its keys' K and V tiles in shared memory and dK, dV in registers,
//      and walks, for each query head of the group in order, the query
//      tiles at or after its keys: S^T and dP^T, P^T and dS^T from lse and
//      D, then dV += P^T dO and dK += dS^T Q.
// No atomics: each output entry is summed by one thread, over the group's
// heads and the query (or key) tiles in a fixed order, so two runs agree
// bit for bit.
//
// Numerics: operands read into float32 (bf16 exactly); every score,
// product and sum in float32; exp of S - lse with the causal mask selected
// before the exponential (a masked p is 0, no exp); outputs rounded to the
// operands' type once, at the end.  flash_attn/ref.py
// flash_attention_bwd_ref computes the same formula in plain PyTorch.
//
// What bounds it on an H100: operations.  The gradient needs five
// products of 2 hd flops per causal pair (S, dP, dV, dK, dQ): 10 hd flops
// a pair, 1.93e11 at MiniCPM-2B's B = 4, T = 2048, 36 heads, hd = 64
// (0.195 ms at 989 TFLOP/s bf16), against 113 MB of operands and outputs
// in bf16 (0.034 ms at 3.35 TB/s).  This first version runs on the float32
// CUDA cores (67 TFLOP/s) and forms S twice (pass 1 and each kernel's
// walk) and dP and dS in both kernels: eight products a pair, not five.
// Its tiles are the forward SIMT kernel's: 256 threads, each a 4 x 4
// tile of scores and a 4 x 8 tile of each accumulator, rows padded to 132
// floats in shared memory.  wgmma and TMA are later work.
#include "common.cuh"

namespace {

constexpr int kB = 64;                 // rows (queries or keys) per tile
constexpr int kHD = 128;               // largest head dim
constexpr int kLD = kHD + 4;           // row stride of the operand tiles
constexpr int kLP = kB + 4;            // row stride of the score tiles
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;      // the running max before any key
constexpr size_t kTile = (size_t)kB * kLD;
// dq: q, dO, k, v tiles and the dS tile.
constexpr size_t kSmemDq = sizeof(float) * (4 * kTile + kB * kLP);
// dkdv: k, v, q, dO tiles, the P^T and dS^T tiles, a tile's lse and D.
constexpr size_t kSmemDkdv =
    sizeof(float) * (4 * kTile + 2 * kB * kLP + 2 * kB);

// Rows [r0, r0 + 64) of a (T, stride) operand into a [64][kLD] float tile,
// zeros past T and past hd (up to hdl, hd rounded up to 4).
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      size_t stride, int r0, int t_len,
                                      int hd, int hdl) {
  for (int e = threadIdx.x; e < kB * hdl; e += kThreads) {
    const int r = e / hdl, d = e % hdl;
    const int t = r0 + r;
    dst[r * kLD + d] = (t < t_len && d < hd)
                           ? repro::to_float(src[(size_t)t * stride + d])
                           : 0.f;
  }
}

// s[i][j] = row (4 ty + i) of a . row (tx + 16 j) of b, over hdl columns.
__device__ __forceinline__ void dot_tile(float (&s)[4][4],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         int hdl, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < hdl; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(&a[(4 * ty + i) * kLD + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(&b[(tx + 16 * j) * kLD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(x[i].x, y[j].x, t);
        t = fmaf(x[i].y, y[j].y, t);
        t = fmaf(x[i].z, y[j].z, t);
        s[i][j] = fmaf(x[i].w, y[j].w, t);
      }
  }
}

// acc[i][c] += sum_r w[4 ty + i][r] * b[r][col c], over the 64 rows r of
// b; column c is 4 tx + c (c < 4) or 64 + 4 tx + (c - 4).
__device__ __forceinline__ void acc_tile(float (&acc)[4][8],
                                         const float* __restrict__ w,
                                         const float* __restrict__ b,
                                         int tx, int ty) {
  for (int kk = 0; kk < kB; kk += 4) {
    float4 wa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wa[i] = *reinterpret_cast<const float4*>(&w[(4 * ty + i) * kLP + kk]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(&b[(kk + u) * kLD + 4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b[(kk + u) * kLD + 64 + 4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = u == 0 ? wa[i].x
                      : u == 1 ? wa[i].y
                      : u == 2 ? wa[i].z
                               : wa[i].w;
        acc[i][0] = fmaf(p, b0.x, acc[i][0]);
        acc[i][1] = fmaf(p, b0.y, acc[i][1]);
        acc[i][2] = fmaf(p, b0.z, acc[i][2]);
        acc[i][3] = fmaf(p, b0.w, acc[i][3]);
        acc[i][4] = fmaf(p, b1.x, acc[i][4]);
        acc[i][5] = fmaf(p, b1.y, acc[i][5]);
        acc[i][6] = fmaf(p, b1.z, acc[i][6]);
        acc[i][7] = fmaf(p, b1.w, acc[i][7]);
      }
    }
  }
}

// Rows 4 ty + i of a 64-row accumulator tile, times `mul`, into rows
// r0 + 4 ty + i of a (T, stride) output; rows < T and columns < hd only.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ out,
                                           const float (&acc)[4][8],
                                           size_t stride, int r0, int t_len,
                                           int hd, float mul, int tx,
                                           int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = r0 + 4 * ty + i;
    if (t >= t_len) continue;
    T* row = out + (size_t)t * stride;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c < 4 ? 0 : 64) + 4 * tx + (c & 3);
      if (col < hd) row[col] = repro::from_float<T>(acc[i][c] * mul);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, T* __restrict__ dq,
              float* __restrict__ lse, float* __restrict__ dsum, int t_len,
              int H, int Hkv, int hd, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kB][kLD]
  float* dos = qs + kTile;                       // [kB][kLD]
  float* ks = dos + kTile;                       // [kB][kLD]
  float* vs = ks + kTile;                        // [kB][kLD]
  float* ds = vs + kTile;                        // [kB][kLP]
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;   // longest rows first
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int hdl = (hd + 3) & ~3;
  const size_t qstride = (size_t)H * hd, kstride = (size_t)Hkv * hd;
  const size_t qoff = (size_t)b * t_len * qstride + (size_t)h * hd;
  const size_t koff = (size_t)b * t_len * kstride + (size_t)hk * hd;
  const T* kb = k + koff;
  const T* vb = v + koff;

  stage(qs, q + qoff, qstride, q0, t_len, hd, hdl);
  stage(dos, dout + qoff, qstride, q0, t_len, hd, hdl);
  // D = rowsum(dO o o): a row's 16 lanes split its columns.
  float dvec[4], lvec[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    float acc = 0.f;
    if (t < t_len) {
      const size_t base = qoff + (size_t)t * qstride;
      for (int d = tx; d < hd; d += 16)
        acc = fmaf(repro::to_float(dout[base + d]),
                   repro::to_float(o[base + d]), acc);
    }
    dvec[i] = repro::half_warp_sum(acc);
  }

  // Pass 1: each row's log-sum-exp, by the forward's online softmax.
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int last = min(q0 + kB, t_len) - 1;     // the block's last row
  for (int s0 = 0; s0 <= last; s0 += kB) {
    __syncthreads();                 // the previous k tile is read
    stage(ks, kb, kstride, s0, t_len, hd, hdl);
    __syncthreads();
    float s[4][4];
    dot_tile(s, qs, ks, hdl, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s0 + tx + 16 * j <= t) mx = fmaxf(mx, s[i][j] * scale);
      const float m_new = fmaxf(m[i], repro::half_warp_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s0 + tx + 16 * j <= t) rs += expf(s[i][j] * scale - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + repro::half_warp_sum(rs);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    lvec[i] = m[i] + logf(fmaxf(l[i], 1e-30f));
    if (tx == 0 && t < t_len) {
      const size_t at = ((size_t)b * H + h) * t_len + t;
      lse[at] = lvec[i];
      dsum[at] = dvec[i];
    }
  }

  // Pass 2: dQ = dS K, dS = P o (dO V^T - D).
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  for (int s0 = 0; s0 <= last; s0 += kB) {
    __syncthreads();                 // the previous k, v and dS are read
    stage(ks, kb, kstride, s0, t_len, hd, hdl);
    stage(vs, vb, kstride, s0, t_len, hd, hdl);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile(s, qs, ks, hdl, tx, ty);
    dot_tile(dp, dos, vs, hdl, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = s0 + tx + 16 * j <= t && t < t_len;
        const float p = live ? expf(s[i][j] * scale - lvec[i]) : 0.f;
        ds[(4 * ty + i) * kLP + tx + 16 * j] = p * (dp[i][j] - dvec[i]);
      }
    }
    __syncthreads();                 // dS is complete
    acc_tile(acc, ds, ks, tx, ty);
  }
  store_tile(dq + qoff, acc, qstride, q0, t_len, hd, scale, tx, ty);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ dsum, T* __restrict__ dk,
                T* __restrict__ dv, int t_len, int H, int Hkv, int hd,
                float scale) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [kB][kLD]
  float* vs = ks + kTile;                        // [kB][kLD]
  float* qs = vs + kTile;                        // [kB][kLD]
  float* dos = qs + kTile;                       // [kB][kLD]
  float* pt = dos + kTile;                       // [kB][kLP]: P^T
  float* dst = pt + kB * kLP;                    // [kB][kLP]: dS^T
  float* lse_s = dst + kB * kLP;                 // [kB]
  float* d_s = lse_s + kB;                       // [kB]
  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * kB;                // most query tiles first
  const int groups = H / Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int hdl = (hd + 3) & ~3;
  const size_t qstride = (size_t)H * hd, kstride = (size_t)Hkv * hd;
  const size_t koff = (size_t)b * t_len * kstride + (size_t)hk * hd;

  stage(ks, k + koff, kstride, k0, t_len, hd, hdl);
  stage(vs, v + koff, kstride, k0, t_len, hd, hdl);
  float adk[4][8], adv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      adk[i][c] = 0.f;
      adv[i][c] = 0.f;
    }
  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const size_t qoff = (size_t)b * t_len * qstride + (size_t)h * hd;
    const float* lrow = lse + ((size_t)b * H + h) * t_len;
    const float* drow = dsum + ((size_t)b * H + h) * t_len;
    for (int q0 = k0; q0 < t_len; q0 += kB) {
      __syncthreads();               // the previous q, dO, P^T, dS^T read
      stage(qs, q + qoff, qstride, q0, t_len, hd, hdl);
      stage(dos, dout + qoff, qstride, q0, t_len, hd, hdl);
      if (threadIdx.x < kB) {
        const int t = q0 + threadIdx.x;
        lse_s[threadIdx.x] = t < t_len ? lrow[t] : 0.f;
        d_s[threadIdx.x] = t < t_len ? drow[t] : 0.f;
      }
      __syncthreads();
      // Rows are keys 4 ty + i, columns queries tx + 16 j.
      float s[4][4], dp[4][4];
      dot_tile(s, ks, qs, hdl, tx, ty);
      dot_tile(dp, vs, dos, hdl, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          const int t = q0 + col;
          const bool live = key <= t && t < t_len;
          const float p = live ? expf(s[i][j] * scale - lse_s[col]) : 0.f;
          pt[(4 * ty + i) * kLP + col] = p;
          dst[(4 * ty + i) * kLP + col] = p * (dp[i][j] - d_s[col]);
        }
      }
      __syncthreads();               // P^T and dS^T are complete
      acc_tile(adv, pt, dos, tx, ty);
      acc_tile(adk, dst, qs, tx, ty);
    }
  }
  store_tile(dk + koff, adk, kstride, k0, t_len, hd, scale, tx, ty);
  store_tile(dv + koff, adv, kstride, k0, t_len, hd, 1.f, tx, ty);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* dsum, int B, int t_len, int H, int Hkv, int hd,
           double scale, void* stream) {
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemDq);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(bwd_dkdv_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemDkdv);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  if (hd < 1 || hd > kHD || Hkv < 1 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && t_len > 0 && H > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int tiles = (t_len + kB - 1) / kB;
    bwd_dq_kernel<T><<<dim3(H, tiles, B), kThreads, kSmemDq, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), static_cast<T*>(dq),
        static_cast<float*>(lse), static_cast<float*>(dsum), t_len, H, Hkv,
        hd, static_cast<float>(scale));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_dkdv_kernel<T><<<dim3(Hkv, tiles, B), kThreads, kSmemDkdv, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(dsum),
        static_cast<T*>(dk), static_cast<T*>(dv), t_len, H, Hkv, hd,
        static_cast<float>(scale));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bwd_f32(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, void* dq, void* dk,
                                       void* dv, void* lse, void* dsum,
                                       int B, int t_len, int H, int Hkv,
                                       int hd, double scale, void* stream) {
  return launch<float>(q, k, v, o, dout, dq, dk, dv, lse, dsum, B, t_len, H,
                       Hkv, hd, scale, stream);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, void* dq, void* dk,
                                        void* dv, void* lse, void* dsum,
                                        int B, int t_len, int H, int Hkv,
                                        int hd, double scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, dsum, B,
                               t_len, H, Hkv, hd, scale, stream);
}
