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
// dV (B, T, Hkv, hd), row-major.  Query head h reads kv head h / (H / Hkv).
//
// The function, with S = Q K^T / sqrt(hd) masked to s <= t:
//   P = exp(S - lse), lse the row's log-sum-exp;  D = rowsum(dO o O);
//   dV = P^T dO;  dP = dO V^T;  dS = P o (dP - D);
//   dQ = dS K / sqrt(hd);  dK = dS^T Q / sqrt(hd).
// dK and dV of kv head j sum over the H / Hkv query heads of its group.
//
// What bounds it on an H100: operations.  The gradient needs five
// products of 2 hd flops per causal pair (S, dP, dV, dK, dQ): 10 hd flops
// a pair, 1.93e11 at MiniCPM-2B's B = 4, T = 2048, 36 heads, hd = 64
// (0.195 ms at 989 TFLOP/s bf16), against 113 MB of operands and outputs
// in bf16 (0.034 ms at 3.35 TB/s).
//
// No atomics in either route: each output entry is summed by one thread,
// over the group's heads and the query (or key) tiles in a fixed order, so
// two runs agree bit for bit.  Two routes, chosen by the operands' type:
//
// bfloat16, the LM path's type: three kernels on the tensor cores (wgmma,
// TMA, mbarriers; hopper.cuh), launched in this order by one C entry:
//   1. bwd_dsum_kernel: D = rowsum(dO o O), 16-byte loads, HD / 8 lanes a
//      row, into a float32 (B, H, T') array (T' = T rounded up to 64,
//      common.cuh lse_stride; zeros past T).  It reads O and dO once.
//   2. bwd_dkdv_kernel_wgmma: a block per (kv head, 128 keys, batch), two
//      warpgroups of 64 keys.  K and V come in once by TMA; dK and dV
//      accumulate in float32 registers.  The block walks, in a fixed order,
//      each query head of its group and each 64-row query tile at or after
//      its keys; the tile's Q, dO and its slices of lse and D arrive through
//      a three-stage TMA/mbarrier ring.  Per tile and warpgroup:
//        S^T = K Q^T and dP^T = V dO^T   (wgmma ss, both operands K-major);
//        P^T = exp2(S^T c - lse), the causal mask (and t < T) selected
//          before the exponential;  dS^T = P^T o (dP^T - D);
//        dV += bf16(P^T) dO and dK += bf16(dS^T) Q   (wgmma rs: the float32
//          accumulator fragment, rounded to bf16, is the A fragment lane
//          for lane, as the forward takes P; dO and Q are read in their
//          (T, hd) rows through wgmma's transposed-B form, as the forward
//          reads V).
//      dK is scaled by 1/sqrt(hd) once, at the end; rows past T are not
//      stored.
//   3. bwd_dq_kernel_wgmma: a block per (q head, 128 query rows, batch),
//      two warpgroups of 64 rows, longest rows first.  Q, dO and the rows'
//      lse and D come in once; the 64-key K and V tiles at or below the
//      diagonal pass through the ring.  S = Q K^T, dP = dO V^T (ss), dS as
//      above, dQ += bf16(dS) K (rs, K through the transposed-B form).
//   The lse is the forward's (flash_attention.cu writes it when a gradient
//   will be taken), in that kernel's base-2 units: scores carry the factor
//   c = log2(e) / sqrt(hd) and lse = m + log2(l), so P = exp2(S c - lse).
//   Seven products per causal pair (S and dP in both kernels, dV, dK, dQ)
//   against the function's five: a floor of 0.274 ms at MiniCPM-2B's
//   shape.  Two consumer warpgroups of 128 threads, one block per SM; a
//   thread of warpgroup 1 refills the ring.  TMA needs 16-byte strides and
//   64-column boxes: q, k, v, o and dO lie in memory with the head dim
//   padded to 64 or 128 (flash_attn/ops.py pads them), dQ, dK and dV
//   with the true hd.  TMA fills rows past T with zeros.
//   Each warpgroup runs a tile's products, waits, runs its exponentials,
//   then the next products; the two warpgroups overlap each other freely.
//   Taking turns at the tensor cores (the forward's named barriers) and
//   overlapping a warpgroup's exponentials with its own products (the
//   forward's pipeline, fragments in two sets) were both slower on an H100
//   (PERF.md, Findings).  P's exponential is one ex2.approx with subnormal
//   results flushed (exp2f adds a rescaling around it).
//   Numerics: P and dS are rounded to bf16 as wgmma's A operands (the
//   forward rounds P the same way); every product sums in float32.
//
// float32: two SIMT kernels on the float32 CUDA cores, launched in order:
//   1. bwd_dq_kernel: a block per (q head, 64 query rows, batch).  Pass 1
//      walks the key tiles at or below its diagonal for each row's running
//      max and sum (the forward's online softmax) and writes lse (natural
//      units) into wrapper scratch; it also writes D from o and dO.  Pass 2
//      walks the tiles again: S and dP, P and dS, then dQ += dS K.
//   2. bwd_dkdv_kernel: a block per (kv head, 64 keys, batch).  It keeps
//      its keys' K and V tiles in shared memory and dK, dV in registers,
//      and walks, for each query head of the group in order, the query
//      tiles at or after its keys: S^T and dP^T, P^T and dS^T from lse and
//      D, then dV += P^T dO and dK += dS^T Q.
//   Operands read into float32; every score, product and sum in float32;
//   exp of S - lse with the causal mask selected before the exponential;
//   outputs rounded once, at the end.  It forms eight products a pair on
//   the CUDA cores (67 TFLOP/s); its tiles are the forward SIMT kernel's:
//   256 threads, each a 4 x 4 tile of scores and a 4 x 8 tile of each
//   accumulator, rows padded to 132 floats in shared memory.
//
// flash_attn/ref.py flash_attention_bwd_ref computes the same formula in
// plain PyTorch.
#include "common.cuh"
#include "hopper.cuh"

namespace {
namespace simt {

// ---- float32: the SIMT kernels (f32 CUDA cores) ----

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

}  // namespace simt

// ---- bfloat16: the tensor-core kernels (wgmma, TMA) ----
namespace wg {

namespace hw = repro::hopper;

constexpr int kBox = 64;              // bf16 columns per TMA box: 128 bytes
constexpr int kRowBytes = kBox * 2;
constexpr int kBoxRows = 64;          // rows per TMA box
constexpr int kBoxBytes = kBoxRows * kRowBytes;   // 8 KB
constexpr int kBlockRows = 128;       // keys (dK/dV) or query rows (dQ)
constexpr int kTile = 64;             // query rows (dK/dV) or keys (dQ)
constexpr int kThreads = 256;         // two warpgroups
constexpr int kStages = 3;
static_assert(kTile == repro::kLseRows, "a query tile is one lse slice");

// A tile of R rows by HD columns lies in shared memory as HD / 64 column
// boxes of [R][64] bf16, each 128-byte swizzled by TMA and loaded as
// R / 64 boxes of 64 rows; every box starts on a 1024-byte boundary.
// `full` completes when a stage's bytes have landed, `empty` when the
// eight warps are done with it.
template <int HD>
struct SmemKV {                       // bwd_dkdv_kernel_wgmma
  static constexpr int kCB = HD / kBox;
  __nv_bfloat16 k[kCB][kBlockRows * kBox];
  __nv_bfloat16 v[kCB][kBlockRows * kBox];
  __nv_bfloat16 q[kStages][kCB][kTile * kBox];
  __nv_bfloat16 dout[kStages][kCB][kTile * kBox];
  float lse[kStages][kTile];
  float dsum[kStages][kTile];
  uint64_t kvbar;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <int HD>
struct SmemQ {                        // bwd_dq_kernel_wgmma
  static constexpr int kCB = HD / kBox;
  __nv_bfloat16 q[kCB][kBlockRows * kBox];
  __nv_bfloat16 dout[kCB][kBlockRows * kBox];
  __nv_bfloat16 k[kStages][kCB][kTile * kBox];
  __nv_bfloat16 v[kStages][kCB][kTile * kBox];
  uint64_t qbar;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <typename S>
constexpr size_t smem_bytes() {
  return sizeof(S) + 1024;            // room to align the base to 1024
}

template <typename S>
__device__ __forceinline__ S& smem_at(uint8_t* raw) {
  return *reinterpret_cast<S*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                               ~uintptr_t(1023));
}

// 2^x as one instruction of the special-function unit (ex2.approx, within
// 2 ulp as exp2f), results below 2^-126 flushed to zero; exp2f wraps the
// same instruction in a rescaling for subnormal results.  A P that small
// adds nothing a float32 sum keeps.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Rows [r0, r0 + rows) of one head of batch b into a tile of `rows` rows.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, int rows,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int head, int r0,
                                          int b) {
#pragma unroll
  for (int x = 0; x < HD / kBox; ++x)
    for (int r = 0; r < rows / kBoxRows; ++r)
      hw::tma_load_4d(tile + (x * rows + r * kBoxRows) * kBox, map, bar,
                      x * kBox, head, r0 + r * kBoxRows, b);
}

// d (64 x 64) = A B^T: A the 64 rows at `a` of a tile of a_rows rows, B the
// 64 rows of a tile at `b`, both K-major over HD: HD / 16 steps of k16,
// a step's 32 bytes inside one column box's swizzled 128-byte row.
template <int HD>
__device__ __forceinline__ void issue_nt(float (&d)[32], uint32_t a,
                                         int a_rows, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t ka = (kk / 4) * a_rows * kRowBytes + (kk % 4) * 32;
    const uint32_t kb = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    hw::wgmma_m64n64k16_ss(d, hw::sw128_desc(a + ka, 16, 1024),
                           hw::sw128_desc(b + kb, 16, 1024), kk > 0);
  }
}

// acc (64 x HD) += F B: F (64 x 64) as four k16 A fragments in registers,
// B the 64 rows of a tile at `b` read through the transposed-B form
// (reduction along its rows, N along hd): 4 steps of 16 rows (two 8-row
// groups of 1024 bytes), its hd columns across the column boxes.
template <int HD>
__device__ __forceinline__ void issue_rs(float (&acc)[HD / 2],
                                         const uint32_t (&f)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) {
    const uint64_t db =
        hw::sw128_desc(b + kc * 16 * kRowBytes, kBoxBytes, 1024);
    if constexpr (HD == 128)
      hw::wgmma_m64n128k16_rs(acc, f[kc], db, 1);
    else
      hw::wgmma_m64n64k16_rs(acc, f[kc], db, 1);
  }
}

// Accumulator fragments (wgmma m64nN, float32): in warpgroup thread
// (warp w, lane l) entry 4 c + 2 i + e is row 16 w + l / 4 + 8 i, column
// 8 c + 2 (l % 4) + e of the warpgroup's 64-row tile.  The A fragment of
// k16 step c / 2 takes entries 4 c + 2 i, 4 c + 2 i + 1 as its register
// 2 (c % 2) + i.
//
// dK/dV: rows are keys (key + 8 i), columns the tile's queries q0 + col.
// In place: s becomes P^T, dp becomes dS^T; pa and da their fragments.
// Masked: a tile that holds a query before one of its keys, or past T.
template <bool kMasked>
__device__ __forceinline__ void grads_t(float (&s)[32], float (&dp)[32],
                                        uint32_t (&pa)[4][4],
                                        uint32_t (&da)[4][4],
                                        const float* lse, const float* dsum,
                                        float c, int key, int q0, int cq,
                                        int t_len) {
#pragma unroll
  for (int cc = 0; cc < 8; ++cc) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * cc + cq);
    const float2 d2 = *reinterpret_cast<const float2*>(dsum + 8 * cc + cq);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * cc + 2 * i + e;
        const int t = q0 + 8 * cc + cq + e;
        const bool live = !kMasked || (key + 8 * i <= t && t < t_len);
        const float p = live ? exp2_ftz(s[x] * c - (e ? l2.y : l2.x)) : 0.f;
        dp[x] = p * (dp[x] - (e ? d2.y : d2.x));
        s[x] = p;
      }
      const int x = 4 * cc + 2 * i;
      pa[cc >> 1][2 * (cc & 1) + i] = pack_bf16(s[x], s[x + 1]);
      da[cc >> 1][2 * (cc & 1) + i] = pack_bf16(dp[x], dp[x + 1]);
    }
  }
}

// dQ: rows are queries (row + 8 i) with their lse and D, columns the
// tile's keys s0 + col.  da gets dS's fragments.  Masked: the tiles that
// hold a key past one of the warpgroup's rows.
template <bool kMasked>
__device__ __forceinline__ void grads(const float (&s)[32],
                                      const float (&dp)[32],
                                      uint32_t (&da)[4][4],
                                      const float (&lse)[2],
                                      const float (&dsum)[2], float c,
                                      int row, int s0, int cq) {
#pragma unroll
  for (int cc = 0; cc < 8; ++cc)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * cc + 2 * i + e;
        const bool live = !kMasked || s0 + 8 * cc + cq + e <= row + 8 * i;
        const float p = live ? exp2_ftz(s[x] * c - lse[i]) : 0.f;
        ds[e] = p * (dp[x] - dsum[i]);
      }
      da[cc >> 1][2 * (cc & 1) + i] = pack_bf16(ds[0], ds[1]);
    }
}

// Two float32 values of row `row` at columns col, col + 1 to bf16, columns
// < hd only.
__device__ __forceinline__ void store2(__nv_bfloat16* row, int col, int hd,
                                       float v0, float v1) {
  if ((hd & 1) == 0 && col + 1 < hd) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) =
        __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < hd) row[col] = __float2bfloat16(v0);
    if (col + 1 < hd) row[col + 1] = __float2bfloat16(v1);
  }
}

// D = rowsum(dO o O): HD / 8 lanes a row, each reading 16 bytes of O and
// of dO (32 / (HD / 8) rows a warp, consecutive rows (b, t, h) in memory
// order), into dsum[(b H + h) T' + t], 0 for T <= t < T'.  o and dO hold
// HD columns.
template <int HD>
__global__ void __launch_bounds__(kThreads)
bwd_dsum_kernel(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                float* __restrict__ dsum, int rows, int t_len, int t_pad,
                int H) {
  constexpr int kLanes = HD / 8;
  const int r = (blockIdx.x * kThreads + threadIdx.x) / kLanes;
  const int l = threadIdx.x % kLanes;
  const int h = r % H, t = (r / H) % t_pad, b = r / (H * t_pad);
  float acc = 0.f;
  if (r < rows && t < t_len) {
    const size_t at = (((size_t)b * t_len + t) * H + h) * HD + 8 * l;
    const uint4 x = *reinterpret_cast<const uint4*>(o + at);
    const uint4 y = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(xs[j]);
      const float2 c = __bfloat1622float2(ys[j]);
      acc = fmaf(a.x, c.x, acc);
      acc = fmaf(a.y, c.y, acc);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && l == 0) dsum[((size_t)b * H + h) * t_pad + t] = acc;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap dmap,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int t_len, int t_pad,
                      int H, int Hkv, int hd, float scale, float scale_log2) {
  using Sm = SmemKV<HD>;
  constexpr uint32_t kKVBytes = 2 * Sm::kCB * kBlockRows * kRowBytes;
  constexpr uint32_t kStageBytes =
      2 * Sm::kCB * kBoxBytes + 2 * kTile * sizeof(float);
  extern __shared__ uint8_t smem_raw[];
  Sm& sm = smem_at<Sm>(smem_raw);
  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * kBlockRows;        // most query tiles first
  const int groups = H / Hkv;
  const int n_qt = (t_len - k0 + kTile - 1) / kTile;   // tiles at or after
  const int n_it = groups * n_qt;                // (head, query tile) steps
  const bool leader = threadIdx.x == 0;
  // Refills the ring: a thread of warpgroup 1.
  const bool producer = threadIdx.x == 128;

  const CUtensorMap* qmp = &qmap;
  const CUtensorMap* dmp = &dmap;
  // Step `it`: query head hk * groups + it / n_qt, query tile it % n_qt.
  auto load = [&sm, qmp, dmp, lse, dsum, hk, groups, n_qt, k0, b, H,
               t_pad](int it) {
    const int st = it % kStages;
    const int h = hk * groups + it / n_qt;
    const int q0 = k0 + kTile * (it % n_qt);
    const size_t at = ((size_t)b * H + h) * t_pad + q0;
    hw::mbar_expect_tx(&sm.full[st], kStageBytes);
    load_tile<HD>(sm.q[st][0], kTile, qmp, &sm.full[st], h, q0, b);
    load_tile<HD>(sm.dout[st][0], kTile, dmp, &sm.full[st], h, q0, b);
    hw::bulk_load(sm.lse[st], lse + at, kTile * sizeof(float), &sm.full[st]);
    hw::bulk_load(sm.dsum[st], dsum + at, kTile * sizeof(float),
                  &sm.full[st]);
  };
  if (leader) {
    hw::mbar_init(&sm.kvbar, 1);
    for (int st = 0; st < kStages; ++st) {
      hw::mbar_init(&sm.full[st], 1);
      hw::mbar_init(&sm.empty[st], kThreads / 32);   // one arrival a warp
    }
    hw::mbar_fence_init();
  }
  __syncthreads();
  if (leader) {
    hw::mbar_expect_tx(&sm.kvbar, kKVBytes);
    load_tile<HD>(sm.k[0], kBlockRows, &kmap, &sm.kvbar, hk, k0, b);
    load_tile<HD>(sm.v[0], kBlockRows, &vmap, &sm.kvbar, hk, k0, b);
    for (int it = 0; it < kStages - 1 && it < n_it; ++it) load(it);
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int kw = k0 + 64 * wg;                   // the warpgroup's keys
  const int key = kw + 16 * warp + lane / 4;     // + 8 i
  const int cq = 2 * (lane % 4);
  const uint32_t k_base = hw::smem_u32(sm.k[0]) + wg * 64 * kRowBytes;
  const uint32_t v_base = hw::smem_u32(sm.v[0]) + wg * 64 * kRowBytes;
  float adk[HD / 2], adv[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) {
    adk[e] = 0.f;
    adv[e] = 0.f;
  }
  hw::mbar_wait(&sm.kvbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const int q0 = k0 + kTile * (it % n_qt);
    hw::mbar_wait(&sm.full[st], (it / kStages) & 1);
    if (kw < t_len && q0 + kTile > kw) {         // a query at or after a key
      const uint32_t q_base = hw::smem_u32(sm.q[st][0]);
      const uint32_t d_base = hw::smem_u32(sm.dout[st][0]);
      float s[32], dp[32];
      uint32_t pa[4][4], da[4][4];
      hw::wgmma_fence();
      issue_nt<HD>(s, k_base, kBlockRows, q_base);
      issue_nt<HD>(dp, v_base, kBlockRows, d_base);
      hw::wgmma_commit();
      hw::wgmma_wait_all();
      hw::fence_operands(s);
      hw::fence_operands(dp);
      if (q0 < kw + 64 || q0 + kTile > t_len)
        grads_t<true>(s, dp, pa, da, sm.lse[st], sm.dsum[st], scale_log2,
                      key, q0, cq, t_len);
      else
        grads_t<false>(s, dp, pa, da, sm.lse[st], sm.dsum[st], scale_log2,
                       key, q0, cq, t_len);
      hw::fence_operands(adv);
      hw::fence_operands(adk);
      hw::wgmma_fence();
      issue_rs<HD>(adv, pa, d_base);
      issue_rs<HD>(adk, da, q_base);
      hw::wgmma_commit();
      hw::wgmma_wait_all();
      hw::fence_operands(adv);
      hw::fence_operands(adk);
    }
    if (lane == 0) hw::mbar_arrive(&sm.empty[st]);
    // Step it + 2 goes into the stage of step it - 1 once all eight warps
    // have released it.
    if (producer && it + kStages - 1 < n_it) {
      if (it >= 1)
        hw::mbar_wait(&sm.empty[(it - 1) % kStages],
                      ((it - 1) / kStages) & 1);
      load(it + kStages - 1);
    }
    __syncwarp();
  }

  const size_t kstride = (size_t)Hkv * hd;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = key + 8 * i;
    if (t >= t_len) continue;
    const size_t at = ((size_t)b * t_len + t) * kstride + (size_t)hk * hd;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const int col = 8 * c + cq;
      store2(dk + at, col, hd, adk[4 * c + 2 * i] * scale,
             adk[4 * c + 2 * i + 1] * scale);
      store2(dv + at, col, hd, adv[4 * c + 2 * i], adv[4 * c + 2 * i + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap dmap,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dq, int t_len, int t_pad,
                    int H, int Hkv, int hd, float scale, float scale_log2) {
  using Sm = SmemQ<HD>;
  constexpr uint32_t kQBytes = 2 * Sm::kCB * kBlockRows * kRowBytes;
  constexpr uint32_t kStageBytes = 2 * Sm::kCB * kBoxBytes;
  extern __shared__ uint8_t smem_raw[];
  Sm& sm = smem_at<Sm>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // longest first
  const int hk = h / (H / Hkv);
  // Key tiles at or below the diagonal.
  const int n_it = (min(q0 + kBlockRows, t_len) + kTile - 1) / kTile;
  const bool leader = threadIdx.x == 0;
  const bool producer = threadIdx.x == 128;

  const CUtensorMap* kmp = &kmap;
  const CUtensorMap* vmp = &vmap;
  auto load = [&sm, kmp, vmp, hk, b](int it) {
    const int st = it % kStages;
    hw::mbar_expect_tx(&sm.full[st], kStageBytes);
    load_tile<HD>(sm.k[st][0], kTile, kmp, &sm.full[st], hk, it * kTile, b);
    load_tile<HD>(sm.v[st][0], kTile, vmp, &sm.full[st], hk, it * kTile, b);
  };
  if (leader) {
    hw::mbar_init(&sm.qbar, 1);
    for (int st = 0; st < kStages; ++st) {
      hw::mbar_init(&sm.full[st], 1);
      hw::mbar_init(&sm.empty[st], kThreads / 32);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();
  if (leader) {
    hw::mbar_expect_tx(&sm.qbar, kQBytes);
    load_tile<HD>(sm.q[0], kBlockRows, &qmap, &sm.qbar, h, q0, b);
    load_tile<HD>(sm.dout[0], kBlockRows, &dmap, &sm.qbar, h, q0, b);
    for (int it = 0; it < kStages - 1 && it < n_it; ++it) load(it);
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int qw = q0 + 64 * wg;                   // the warpgroup's rows
  const int row = qw + 16 * warp + lane / 4;     // + 8 i
  const int cq = 2 * (lane % 4);
  float lrow[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row + 8 * i;
    const size_t at = ((size_t)b * H + h) * t_pad + t;
    lrow[i] = t < t_len ? lse[at] : 0.f;
    drow[i] = t < t_len ? dsum[at] : 0.f;
  }
  const uint32_t q_base = hw::smem_u32(sm.q[0]) + wg * 64 * kRowBytes;
  const uint32_t d_base = hw::smem_u32(sm.dout[0]) + wg * 64 * kRowBytes;
  float acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
  hw::mbar_wait(&sm.qbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const int s0 = it * kTile;
    hw::mbar_wait(&sm.full[st], (it / kStages) & 1);
    if (qw < t_len && s0 <= qw + 63) {           // a key at or before a row
      const uint32_t k_st = hw::smem_u32(sm.k[st][0]);
      const uint32_t v_st = hw::smem_u32(sm.v[st][0]);
      float s[32], dp[32];
      uint32_t da[4][4];
      hw::wgmma_fence();
      issue_nt<HD>(s, q_base, kBlockRows, k_st);
      issue_nt<HD>(dp, d_base, kBlockRows, v_st);
      hw::wgmma_commit();
      hw::wgmma_wait_all();
      hw::fence_operands(s);
      hw::fence_operands(dp);
      if (s0 + 63 > qw)
        grads<true>(s, dp, da, lrow, drow, scale_log2, row, s0, cq);
      else
        grads<false>(s, dp, da, lrow, drow, scale_log2, row, s0, cq);
      hw::fence_operands(acc);
      hw::wgmma_fence();
      issue_rs<HD>(acc, da, k_st);
      hw::wgmma_commit();
      hw::wgmma_wait_all();
      hw::fence_operands(acc);
    }
    if (lane == 0) hw::mbar_arrive(&sm.empty[st]);
    if (producer && it + kStages - 1 < n_it) {
      if (it >= 1)
        hw::mbar_wait(&sm.empty[(it - 1) % kStages],
                      ((it - 1) / kStages) & 1);
      load(it + kStages - 1);
    }
    __syncwarp();
  }

  const size_t qstride = (size_t)H * hd;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row + 8 * i;
    if (t >= t_len) continue;
    __nv_bfloat16* out = dq + ((size_t)b * t_len + t) * qstride +
                         (size_t)h * hd;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      store2(out, 8 * c + cq, hd, acc[4 * c + 2 * i] * scale,
             acc[4 * c + 2 * i + 1] * scale);
  }
}

// A tensor map over a (B, T, heads, hdp) bf16 operand: dims innermost
// first, boxes of 64 columns x 1 head x 64 rows x 1 batch, 128-byte
// swizzle, rows past T read as zeros.
bool encode(CUtensorMap* map, const void* base, int B, int t_len, int heads,
            int hdp) {
  const hw::EncodeTiled fn = hw::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hdp, (cuuint64_t)heads,
                              (cuuint64_t)t_len, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hdp * 2,
                                 (cuuint64_t)heads * hdp * 2,
                                 (cuuint64_t)t_len * heads * hdp * 2};
  const cuuint32_t box[4] = {kBox, 1, kBoxRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, const void* lse,
           void* dsum, int B, int t_len, int H, int Hkv, int hd,
           double scale, void* stream) {
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv_kernel_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<SmemKV<HD>>());
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(bwd_dq_kernel_wgmma<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<SmemQ<HD>>());
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  if (B <= 0 || t_len <= 0 || H <= 0)
    return static_cast<int>(cudaGetLastError());
  if (hw::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm, dm;
  if (!encode(&qm, q, B, t_len, H, HD) || !encode(&km, k, B, t_len, Hkv, HD) ||
      !encode(&vm, v, B, t_len, Hkv, HD) ||
      !encode(&dm, dout, B, t_len, H, HD))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int t_pad = repro::lse_stride(t_len);
  const float sc = static_cast<float>(scale);
  const float sc_log2 = static_cast<float>(scale * 1.4426950408889634);
  const int rows = B * t_pad * H;
  constexpr int kRowsPerBlock = kThreads / (HD / 8);
  bwd_dsum_kernel<HD><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads,
                        0, st>>>(static_cast<const __nv_bfloat16*>(o),
                                 static_cast<const __nv_bfloat16*>(dout),
                                 static_cast<float*>(dsum), rows, t_len,
                                 t_pad, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (t_len + kBlockRows - 1) / kBlockRows;
  bwd_dkdv_kernel_wgmma<HD><<<dim3(Hkv, tiles, B), kThreads,
                              smem_bytes<SmemKV<HD>>(), st>>>(
      qm, km, vm, dm, static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), t_len, t_pad, H, Hkv, hd, sc, sc_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_kernel_wgmma<HD><<<dim3(H, tiles, B), kThreads,
                            smem_bytes<SmemQ<HD>>(), st>>>(
      qm, km, vm, dm, static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<__nv_bfloat16*>(dq),
      t_len, t_pad, H, Hkv, hd, sc, sc_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
}  // namespace

extern "C" int flash_attention_bwd_f32(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, void* dq, void* dk,
                                       void* dv, void* lse, void* dsum,
                                       int B, int t_len, int H, int Hkv,
                                       int hd, double scale, void* stream) {
  return simt::launch<float>(q, k, v, o, dout, dq, dk, dv, lse, dsum, B,
                             t_len, H, Hkv, hd, scale, stream);
}

// q, k, v, o and dout hold the head dim padded to 64 (hd <= 64) or 128
// (hd <= 128), as flash_attn/ops.py pads them; dq, dk and dv hold hd.  lse
// is the forward's (B, H, T') log-sum-exp in its base-2 units, dsum (B, H,
// T') scratch, T' = lse_stride(T).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, void* dq, void* dk,
                                        void* dv, void* lse, void* dsum,
                                        int B, int t_len, int H, int Hkv,
                                        int hd, double scale, void* stream) {
  if (hd < 1 || hd > 128 || Hkv < 1 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  return hd <= 64
             ? wg::launch<64>(q, k, v, o, dout, dq, dk, dv, lse, dsum, B,
                              t_len, H, Hkv, hd, scale, stream)
             : wg::launch<128>(q, k, v, o, dout, dq, dk, dv, lse, dsum, B,
                               t_len, H, Hkv, hd, scale, stream);
}
