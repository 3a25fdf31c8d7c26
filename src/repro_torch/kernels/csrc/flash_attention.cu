// Causal flash attention: the prefill's softmax attention, with the running
// max m, the running sum l and the float32 accumulator kept on chip.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attn/flash_attn.py::flash_attention
//   (pallas_call at :93, body _kernel :31).
// The reference's model computes the same function inline
// (models/layers.py _flash_attention and _naive_attention); the port's
// attention_apply calls this kernel for both attn_impl values.
//
// Layout as the model holds it: q (B, T, H, hd), k and v (B, T, Hkv, hd),
// row-major, out (B, T, H, hd).  Query head h reads kv head h / (H / Hkv),
// the mapping of the reference's jnp.repeat and its (kv, groups) reshape;
// k and v are neither copied out to H heads nor transposed.
//
// Numerics, as the TPU kernel does them: scores summed in float32 and
// scaled by 1/sqrt(hd) of the true hd; the causal mask selected before the
// exponential (a masked entry's p is 0, no exp of -inf, no 0 * inf); the
// running max and sum in float32; p rounded to v's type before the PV
// product (exact in float32: two bf16 values multiply exactly), the
// product summed in float32; out = acc / max(l, 1e-30) in q's type.
//
// What bounds it on an H100: operations.  The causal function needs
// 4 hd flops for each of a head's T (T + 1) / 2 pairs s <= t (QK^T and
// PV; 2.75e11 flops at B = 1, T = 4096, 64 heads, hd = 128: 0.278 ms at
// 989 TFLOP/s bf16), against
// 151 MB of q, k, v and out (0.045 ms at 3.35 TB/s).  Design: a simple
// SIMT kernel on the float32 CUDA cores (67 TFLOP/s), no tensor cores
// yet; wgmma, TMA and warp specialisation are later work.  A block of 256
// threads takes 64 query rows of one head; it loops over the 64-key tiles
// at or below its diagonal only (the TPU kernel visits the masked upper
// blocks too), staging k and then v of a tile through one shared buffer.
// The TPU's 512 x 512 blocks do not fit a block's 227 KB: here the q
// tile, one k/v tile (64 x 128 floats each, rows padded to 132) and the
// 64 x 64 probability tile take 85 KB, so two blocks run on each SM.
// Each thread holds a 4 x 4 tile of scores and a 4 x 8 tile of the
// accumulator for the same four rows, so a row's max and sum are reduced
// over the 16 lanes of a half warp.  Blocks of the longest rows (the last
// query tiles) are scheduled first.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;                // query rows per block
constexpr int kBK = 64;                // keys per tile
constexpr int kHD = 128;               // largest head dim
constexpr int kLD = kHD + 4;           // row stride of the q and k/v tiles
constexpr int kLP = kBK + 4;           // row stride of the p tile
constexpr int kThreads = 256;
constexpr size_t kSmem = sizeof(float) * (kBQ * kLD + kBK * kLD + kBQ * kLP);
constexpr float kNegInf = -1e30f;      // the running max before any key

// Rows [r0, r0 + 64) of a (T, stride) operand into a [64][kLD] float tile,
// zeros past T and past hd (up to hdl, hd rounded up to 4).
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      size_t stride, int r0, int t_len,
                                      int hd, int hdl) {
  for (int e = threadIdx.x; e < 64 * hdl; e += kThreads) {
    const int r = e / hdl, d = e % hdl;
    const int t = r0 + r;
    dst[r * kLD + d] = (t < t_len && d < hd)
                           ? repro::to_float(src[(size_t)t * stride + d])
                           : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int t_len, int H, int Hkv, int hd, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][kLD]
  float* kv = qs + kBQ * kLD;                    // [kBK][kLD]: k, then v
  float* ps = kv + kBK * kLD;                    // [kBQ][kLP]
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // longest rows first
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int hdl = (hd + 3) & ~3;
  const size_t qstride = (size_t)H * hd, kstride = (size_t)Hkv * hd;
  const T* qb = q + (size_t)b * t_len * qstride + (size_t)h * hd;
  const T* kb = k + (size_t)b * t_len * kstride + (size_t)hk * hd;
  const T* vb = v + (size_t)b * t_len * kstride + (size_t)hk * hd;

  stage(qs, qb, qstride, q0, t_len, hd, hdl);
  // Thread rows r_i = 4 ty + i; score columns tx + 16 j; accumulator
  // columns 4 tx + c and 64 + 4 tx + c.
  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }
  const int last = min(q0 + kBQ, t_len) - 1;     // the block's last row
  for (int s0 = 0; s0 <= last; s0 += kBK) {
    __syncthreads();                 // the previous v tile is read
    stage(kv, kb, kstride, s0, t_len, hd, hdl);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hdl; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&qs[(4 * ty + i) * kLD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(&kv[(tx + 16 * j) * kLD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, c[j].x, t);
          t = fmaf(a[i].y, c[j].y, t);
          t = fmaf(a[i].z, c[j].z, t);
          s[i][j] = fmaf(a[i].w, c[j].w, t);
        }
    }
    // Online softmax over this tile; key s0 + tx + 16 j is live for row t
    // where it is at or below the diagonal.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        if (s0 + tx + 16 * j <= t) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], repro::half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s0 + tx + 16 * j <= t) ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        ps[(4 * ty + i) * kLP + tx + 16 * j] = repro::round_to<T>(p);
      }
      l[i] = l[i] * corr + repro::half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
    }
    __syncthreads();                 // the k tile is read, p is complete
    stage(kv, vb, kstride, s0, t_len, hd, hdl);
    __syncthreads();
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&ps[(4 * ty + i) * kLP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 v0 =
            *reinterpret_cast<const float4*>(&kv[(kk + u) * kLD + 4 * tx]);
        const float4 v1 = *reinterpret_cast<const float4*>(
            &kv[(kk + u) * kLD + 64 + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pa[i].x
                        : u == 1 ? pa[i].y
                        : u == 2 ? pa[i].z
                                 : pa[i].w;
          acc[i][0] = fmaf(p, v0.x, acc[i][0]);
          acc[i][1] = fmaf(p, v0.y, acc[i][1]);
          acc[i][2] = fmaf(p, v0.z, acc[i][2]);
          acc[i][3] = fmaf(p, v0.w, acc[i][3]);
          acc[i][4] = fmaf(p, v1.x, acc[i][4]);
          acc[i][5] = fmaf(p, v1.y, acc[i][5]);
          acc[i][6] = fmaf(p, v1.z, acc[i][6]);
          acc[i][7] = fmaf(p, v1.w, acc[i][7]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= t_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)b * t_len + t) * qstride + (size_t)h * hd;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c < 4 ? 0 : 64) + 4 * tx + (c & 3);
      if (col < hd) orow[col] = repro::from_float<T>(acc[i][c] / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int t_len, int H, int Hkv, int hd, double scale, void* stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  if (B > 0 && t_len > 0 && H > 0) {
    const dim3 grid(H, (t_len + kBQ - 1) / kBQ, B);
    flash_attention_kernel<T><<<grid, kThreads, kSmem,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), t_len, H, Hkv, hd,
        static_cast<float>(scale));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int t_len,
                                   int H, int Hkv, int hd, double scale,
                                   void* stream) {
  return launch<float>(q, k, v, o, B, t_len, H, Hkv, hd, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int t_len,
                                    int H, int Hkv, int hd, double scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, t_len, H, Hkv, hd, scale,
                               stream);
}
