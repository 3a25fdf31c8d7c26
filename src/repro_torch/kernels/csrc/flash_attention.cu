// Causal flash attention: the prefill's softmax attention, with the running
// max m, the running sum l and the float32 accumulator kept on chip.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attn/flash_attn.py::flash_attention
//   (:73, pallas_call at :93, body _kernel :31).
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
// running max and sum in float32, l summed from the unrounded p; p rounded
// to v's type before the PV product (exact in float32: two bf16 values
// multiply exactly), the product summed in float32; out = acc /
// max(l, 1e-30) in q's type.
//
// What bounds it on an H100: operations.  The causal function needs
// 4 hd flops for each of a head's T (T + 1) / 2 pairs s <= t (QK^T and
// PV; 2.75e11 flops at B = 1, T = 4096, 64 heads, hd = 128: 0.278 ms at
// 989 TFLOP/s bf16), against 151 MB of q, k, v and out (0.045 ms at
// 3.35 TB/s).
//
// Two kernels, chosen by the operands' type (a dispatch by type; neither
// stands in for the other):
//
// bfloat16, the LM path's type: flash_attention_kernel_wgmma, on the
// tensor cores (wgmma, TMA, mbarriers; hopper.cuh).
//   * Both products are wgmma with bf16 inputs and float32 accumulators.
//     S = Q K^T reads Q and K from shared memory, both in their natural
//     rows (K-major).  O += P V takes P from registers: the S accumulator
//     fragment, rounded to bf16, is the A fragment lane for lane (no
//     shuffle).  V is read from shared memory in its (T, hd) rows through
//     wgmma's transposed-B form, so it is never transposed in memory.
//   * A block of 256 threads holds 128 query rows of one head as two
//     warpgroups of 64 rows; keys come in tiles of 128.  A thread keeps its
//     64 scores, hd/2 accumulators, two sets of P fragments and its two
//     rows' m and l in registers (244 at hd = 128); one block per SM.
//   * Loads are TMA, one 4-d tensor map per operand over (hd, heads, T, B)
//     with boxes of 64 columns (the 128-byte swizzle's row, the layout the
//     wgmma descriptors name) by 128 rows: two boxes per tile at hd = 128.
//     K and V pass through a ring of three stages (224 KB with Q at
//     hd = 128) on mbarriers: `full` counts a stage's bytes in, `empty`
//     one arrival per warpgroup out.  Thread 0 loads Q and the first two
//     tiles; in the loop a thread of warpgroup 1 (the one that runs
//     behind, so the stage is already free) loads tile j + 2 into the
//     stage of tile j - 1.  TMA fills rows past T with zeros; positions
//     mask the diagonal tile (the only one that holds keys past a row, or
//     past T), and the store writes rows < T and columns < hd only.
//   * Overlap.  Each warpgroup issues tile j's S together with tile
//     j - 1's P V, waits for S alone and runs tile j's softmax while its
//     P V is still on the tensor cores.  The two warpgroups take turns
//     issuing (two named barriers), so one's softmax also runs under the
//     other's products.
//   * The softmax is in base 2: scores and the running max carry the
//     factor log2(e) / sqrt(hd), so exp(x) is exp2f(x log2(e)).  Folding
//     log2(e) into the scale adds no rounding step (the scores are scaled
//     once either way); the readings against the bound are unchanged.
//   * TMA needs 16-byte global strides, and a box's row is 64 bf16: the
//     head dim lies in memory as 64 or 128.  The wrapper (flash_attn/ops.py)
//     zero-pads q, k and v to the next of them when hd is neither (hd = 32
//     -> 64, 100 -> 128: the zeros add nothing to a dot product) and the
//     scale stays 1/sqrt(true hd); hd = 64 and 128 pass as they are.
//   * The tensor maps are made on the host at each call and passed as
//     __grid_constant__ parameters.  cuTensorMapEncodeTiled lives in
//     libcuda; the runtime hands its address over (hopper.cuh), so the
//     build is nvcc alone (no -lcuda).
//   * The block loops over the key tiles at or below its diagonal only,
//     and the blocks of the last query tiles (the longest rows) are
//     scheduled first.
//   * Accumulation order: wgmma's within each product, and one rescale by
//     exp(m_old - m_new) per 128-key tile (kernels/checks.py's
//     flash_attention_tol allows one per 64 keys).
//   * When a gradient will be taken (flash_attn/ops.py passes the buffer
//     only then), each row t < T also writes its log-sum-exp into a float32
//     (B, H, T') array, T' = T rounded up to 64 (common.cuh lse_stride), in
//     the softmax's base-2 units: lse = m + log2(l), m the running max of
//     the scores times log2(e) / sqrt(hd), so that the backward's
//     P = exp2(S log2(e) / sqrt(hd) - lse) (flash_attention_bwd.cu).  The
//     write is a template parameter: the prefill's instantiation writes
//     nothing.
//
// float32: flash_attention_kernel, a SIMT kernel on the float32 CUDA cores
// (67 TFLOP/s; TF32 tensor cores would miss the float32 bars).  A block of
// 256 threads takes 64 query rows of one head; it loops over the 64-key
// tiles at or below its diagonal only (the TPU kernel visits the masked
// upper blocks too), staging k and then v of a tile through one shared
// buffer.  The TPU's 512 x 512 blocks do not fit a block's 227 KB: here
// the q tile, one k/v tile (64 x 128 floats each, rows padded to 132) and
// the 64 x 64 probability tile take 85 KB, so two blocks run on each SM.
// Each thread holds a 4 x 4 tile of scores and a 4 x 8 tile of the
// accumulator for the same four rows, so a row's max and sum are reduced
// over the 16 lanes of a half warp.  Blocks of the longest rows (the last
// query tiles) are scheduled first.
#include "common.cuh"
#include "hopper.cuh"

namespace {
namespace simt {

// ---- float32: the SIMT kernel (f32 CUDA cores) ----

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

}  // namespace simt

// ---- bfloat16: the wgmma kernel (tensor cores) ----
namespace wg {

namespace hw = repro::hopper;

constexpr int kBQ = 128;        // query rows per block: two warpgroups of 64
constexpr int kBK = 128;        // keys per tile
constexpr int kBox = 64;        // bf16 columns per TMA box: 128 bytes
constexpr int kThreads = 256;
constexpr int kRowBytes = kBox * 2;
constexpr int kBoxBytes = kBQ * kRowBytes;   // one 128-row box: 16 KB
constexpr float kNegInf = -1e30f;            // the running max before any key
static_assert(kBQ == kBK, "q, k and v boxes share one shape");

// Each tile is hd / 64 boxes of [128 rows][64 columns], 128-byte swizzled
// by TMA; every box starts on a 1024-byte boundary.  K and V have a ring
// of kStages stages: `full` completes when a stage's bytes have landed,
// `empty` when both warpgroups are done with it.
constexpr int kStages = 3;

template <int HD>
struct Smem {
  static constexpr int kBoxes = HD / kBox;
  __nv_bfloat16 q[kBoxes][kBQ * kBox];
  __nv_bfloat16 k[kStages][kBoxes][kBK * kBox];
  __nv_bfloat16 v[kStages][kBoxes][kBK * kBox];
  uint64_t qbar;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(Smem<HD>) + 1024;       // room to align the base to 1024
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The two warpgroups take turns at the tensor cores (named barriers 1 and
// 2, 256 threads each): warpgroup w waits for its turn before it issues a
// product and hands the turn over once it is issued, so one warpgroup's
// softmax runs while the other's products do.
__device__ __forceinline__ void take_turn(int wg) {
  hw::named_sync(1 + wg, 2 * 128);
}
__device__ __forceinline__ void pass_turn(int wg) {
  hw::named_arrive(2 - wg, 2 * 128);
}

// Online softmax over one tile of scores s (this thread's 64), in base 2:
// scores and the running max are scaled by log2(e) / sqrt(hd), so exp(x)
// is exp2f of x log2(e).  Returns the rows' rescale factors in corr and P,
// rounded to bf16, as the A fragments of the 8 k16 steps over the tile's
// keys.  Masked: the diagonal tile, the only one that holds keys past a
// row (and past T); a masked p is 0, with no exp.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&corr)[2],
                                             uint32_t (&pa)[8][4],
                                             float scale_log2, int s0,
                                             int row, int cq) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int i = (e >> 1) & 1;
    s[e] *= scale_log2;
    if (!kMasked || s0 + 8 * (e >> 2) + cq + (e & 1) <= row + 8 * i)
      mx[i] = fmaxf(mx[i], s[e]);
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m_run[i], quad_max(mx[i]));
    corr[i] = exp2f(m_run[i] - m_new);
    m_run[i] = m_new;
  }
#pragma unroll
  for (int e = 0; e < 64; e += 2) {
    const int i = (e >> 1) & 1;
    const int key = s0 + 8 * (e >> 2) + cq;
    const int t = row + 8 * i;
    const float p0 = (!kMasked || key <= t) ? exp2f(s[e] - m_run[i]) : 0.f;
    const float p1 =
        (!kMasked || key + 1 <= t) ? exp2f(s[e + 1] - m_run[i]) : 0.f;
    rs[i] += p0;
    rs[i] += p1;
    pa[e >> 3][(e >> 1) & 3] = pack_bf16(p0, p1);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * corr[i] + quad_sum(rs[i]);
}

__device__ __forceinline__ void fence_fragments(uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pa[c][r]) :: "memory");
}

// Accumulator fragments (wgmma m64nN, float32): in warpgroup thread
// (warp w, lane l) entry 4 c + 2 i + e is row 16 w + l / 4 + 8 i, column
// 8 c + 2 (l % 4) + e of the warpgroup's 64-row tile.
template <int HD, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse, int t_len, int H,
                             int Hkv, int hd, float scale_log2) {
  constexpr int kBoxes = HD / kBox;
  constexpr uint32_t kQBytes = kBoxes * kBoxBytes;
  constexpr uint32_t kKVBytes = 2 * kBoxes * kBoxBytes;
  constexpr int kAcc = HD / 2;           // accumulator entries per thread
  extern __shared__ uint8_t smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // longest rows first
  const int hk = h / (H / Hkv);
  const int n_tiles = q0 / kBK + 1;      // key tiles at or below the diagonal
  const bool leader = threadIdx.x == 0;
  // Issues the ring's loads inside the loop: a thread of warpgroup 1, the
  // one that runs behind, so a stage it refills is already free.
  const bool producer = threadIdx.x == 128;

  const CUtensorMap* kmp = &kmap;
  const CUtensorMap* vmp = &vmap;
  auto load_kv = [&sm, kmp, vmp, hk, b](int tile) {
    const int st = tile % kStages;
    hw::mbar_expect_tx(&sm.full[st], kKVBytes);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) {
      hw::tma_load_4d(sm.k[st][x], kmp, &sm.full[st], x * kBox, hk,
                      tile * kBK, b);
      hw::tma_load_4d(sm.v[st][x], vmp, &sm.full[st], x * kBox, hk,
                      tile * kBK, b);
    }
  };
  if (leader) {
    hw::mbar_init(&sm.qbar, 1);
    for (int st = 0; st < kStages; ++st) {
      hw::mbar_init(&sm.full[st], 1);
      hw::mbar_init(&sm.empty[st], 2);   // one arrival per warpgroup
    }
    hw::mbar_fence_init();
  }
  __syncthreads();
  if (leader) {
    hw::mbar_expect_tx(&sm.qbar, kQBytes);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x)
      hw::tma_load_4d(sm.q[x], &qmap, &sm.qbar, x * kBox, h, q0, b);
    for (int t = 0; t < kStages - 1 && t < n_tiles; ++t) load_kv(t);
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row = q0 + 64 * wg + 16 * warp + lane / 4;   // + 8 i
  const int cq = 2 * (lane % 4);
  // This warpgroup's 64 rows of each q box.
  const uint32_t q_base = hw::smem_u32(sm.q[0]) + wg * 64 * kRowBytes;
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  uint32_t pa[8][4];

  // S = Q K^T of tile j: hd / 16 steps of k16; a step's 32 bytes lie
  // inside one box's swizzled 128-byte row.
  auto issue_s = [&](float (&s)[64], int j) {
    const uint32_t k_base = hw::smem_u32(sm.k[j % kStages][0]);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      hw::wgmma_m64n128k16_ss(s, hw::sw128_desc(q_base + off, 16, 1024),
                              hw::sw128_desc(k_base + off, 16, 1024),
                              kk > 0);
    }
    hw::wgmma_commit();
  };
  // O += P V of tile j: 8 steps of k16 over its keys, V's rows 16 kc ..
  // 16 kc + 15 (two 8-row groups of 1024 bytes), its hd columns across
  // the boxes (16 KB apart).
  auto issue_pv = [&](const uint32_t (&p)[8][4], int j) {
    const uint32_t v_base = hw::smem_u32(sm.v[j % kStages][0]);
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint64_t dv =
          hw::sw128_desc(v_base + kc * 16 * kRowBytes, kBoxBytes, 1024);
      if constexpr (HD == 128)
        hw::wgmma_m64n128k16_rs(acc, p[kc], dv, 1);
      else
        hw::wgmma_m64n64k16_rs(acc, p[kc], dv, 1);
    }
    hw::wgmma_commit();
  };
  auto softmax = [&](float (&s)[64], float (&corr)[2], uint32_t (&p)[8][4],
                     int j) {
    if (j == n_tiles - 1)
      softmax_tile<true>(s, m_run, l_run, corr, p, scale_log2, j * kBK, row,
                         cq);
    else
      softmax_tile<false>(s, m_run, l_run, corr, p, scale_log2, j * kBK,
                          row, cq);
  };
  // Tile j + 2 goes into the stage of tile j - 1 once both warpgroups have
  // released it; the producer runs in the warpgroup that is behind.
  auto refill = [&](int j) {
    if (producer && j + kStages - 1 < n_tiles) {
      if (j >= 1) hw::mbar_wait(&sm.empty[(j - 1) % kStages],
                                ((j - 1) / kStages) & 1);
      load_kv(j + kStages - 1);
    }
    __syncwarp();
  };

  // Tile j's softmax overlaps tile j - 1's P V, issued with tile j's S:
  //   S_0; softmax_0;  [S_j, PV_{j-1}; softmax_j] for j >= 1;  PV_last.
  if (wg == 1) pass_turn(wg);            // warpgroup 0 goes first
  hw::mbar_wait(&sm.qbar, 0);
  {
    float s[64], corr[2];
    hw::mbar_wait(&sm.full[0], 0);
    take_turn(wg);
    hw::wgmma_fence();
    issue_s(s, 0);
    pass_turn(wg);
    hw::wgmma_wait_all();
    hw::fence_operands(s);
    softmax(s, corr, pa, 0);
    refill(0);
  }
  // One tile: P V of tile j - 1 from `p`, the new fragments into `pn`.
  auto step = [&](int j, uint32_t (&p)[8][4], uint32_t (&pn)[8][4]) {
    float s[64], corr[2];
    hw::mbar_wait(&sm.full[j % kStages], (j / kStages) & 1);
    hw::fence_operands(acc);
    take_turn(wg);
    hw::wgmma_fence();
    issue_s(s, j);
    issue_pv(p, j - 1);
    pass_turn(wg);
    hw::wgmma_wait_one();                // S_j; P V_{j-1} may still run
    hw::fence_operands(s);
    softmax(s, corr, pn, j);
    hw::wgmma_wait_all();                // P V_{j-1}
    hw::fence_operands(acc);
    fence_fragments(p);
    if (threadIdx.x % 128 == 0)
      hw::mbar_arrive(&sm.empty[(j - 1) % kStages]);
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] *= corr[(e >> 1) & 1];
    refill(j);
  };
  uint32_t pb[8][4];
  int j = 1;
  for (; j + 1 < n_tiles; j += 2) {      // fragments alternate pa, pb
    step(j, pa, pb);
    step(j + 1, pb, pa);
  }
  if (j < n_tiles) {
    step(j, pa, pb);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[c][r] = pb[c][r];
  }
  hw::fence_operands(acc);
  take_turn(wg);
  hw::wgmma_fence();
  issue_pv(pa, n_tiles - 1);
  pass_turn(wg);
  hw::wgmma_wait_all();
  hw::fence_operands(acc);
  fence_fragments(pa);
  if (wg == 0) take_turn(wg);            // warpgroup 1's last hand-over

  const size_t qstride = (size_t)H * hd;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row + 8 * i;
    if (t >= t_len) continue;
    const float den = fmaxf(l_run[i], 1e-30f);
    if constexpr (kLse) {
      if (cq == 0)
        lse[((size_t)b * H + h) * repro::lse_stride(t_len) + t] =
            m_run[i] + log2f(den);
    }
    __nv_bfloat16* orow = o + ((size_t)b * t_len + t) * qstride +
                          (size_t)h * hd;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const int col = 8 * c + cq;
      const float v0 = acc[4 * c + 2 * i] / den;
      const float v1 = acc[4 * c + 2 * i + 1] / den;
      if ((hd & 1) == 0 && col + 1 < hd) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < hd) orow[col] = __float2bfloat16(v0);
        if (col + 1 < hd) orow[col + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// A tensor map over a (B, T, heads, hdp) bf16 operand: dims innermost
// first, boxes of 64 columns x 1 head x 128 rows x 1 batch, 128-byte
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
  const cuuint32_t box[4] = {kBox, 1, kBQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int t_len, int H, int Hkv, int hd, double scale,
           void* stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel_wgmma<HD, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<HD>());
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  if (B <= 0 || t_len <= 0 || H <= 0)
    return static_cast<int>(cudaGetLastError());
  if (hw::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm;
  if (!encode(&qm, q, B, t_len, H, HD) || !encode(&km, k, B, t_len, Hkv, HD) ||
      !encode(&vm, v, B, t_len, Hkv, HD))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H, (t_len + kBQ - 1) / kBQ, B);
  flash_attention_kernel_wgmma<HD, kLse><<<grid, kThreads, smem_bytes<HD>(),
                                           static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      t_len, H, Hkv, hd,
      static_cast<float>(scale * 1.4426950408889634));   // log2(e)
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
}  // namespace


// lse: the bf16 kernel's log-sum-exp output; the float32 kernel writes none
// and refuses one (its backward computes its own).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int t_len, int H, int Hkv, int hd,
                                   double scale, void* stream) {
  if (lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return simt::launch<float>(q, k, v, o, B, t_len, H, Hkv, hd, scale,
                             stream);
}

// q, k and v hold the head dim padded to 64 (hd <= 64) or 128 (hd <= 128),
// as flash_attn/ops.py pads them; o holds hd.  lse is null (the prefill)
// or a float32 (B, H, lse_stride(T)) array for each row's log-sum-exp.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int t_len, int H, int Hkv, int hd,
                                    double scale, void* stream) {
  if (hd < 1 || hd > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (lse == nullptr)
    return hd <= 64 ? wg::launch<64, false>(q, k, v, o, lse, B, t_len, H,
                                            Hkv, hd, scale, stream)
                    : wg::launch<128, false>(q, k, v, o, lse, B, t_len, H,
                                             Hkv, hd, scale, stream);
  return hd <= 64 ? wg::launch<64, true>(q, k, v, o, lse, B, t_len, H, Hkv,
                                         hd, scale, stream)
                  : wg::launch<128, true>(q, k, v, o, lse, B, t_len, H, Hkv,
                                          hd, scale, stream);
}
