// Shared device helpers of the port's CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// The active count m, read by pointer from the state's 0-d int32 tensor
// and clamped to [0, n], so a launch never reads it back on the host.
__device__ __forceinline__ int active_count(const int* m_ptr, int n) {
  return min(max(*m_ptr, 0), n);
}

// Squared distance -> kernel value, term for term as
// repro_torch/core/kernels_fn.gram_block (and the reference's
// krow_fused.kernel_epilogue): kind 0 is RBF, kind 1 is Matern-3/2.
template <typename T>
__device__ __forceinline__ T kernel_epilogue(T d2, int kind, T sigma,
                                             T scale) {
  if (kind == 0) return scale * exp(-d2 / sigma);
  const T aa = T(1.7320508075688772) * sqrt(d2 + T(1e-30)) / sigma;
  return scale * (T(1) + aa) * exp(-aa);
}

// Sum of v over the 32 lanes of a warp (every lane gets the total).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Operand types of the LM kernels, read into and written from float.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);               // round to nearest even
}
// v rounded to T's precision (as torch's .to(T) rounds it), kept as float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// Largest (or sum) over the 16 lanes of a half warp (every lane of the
// half gets it): the lanes that hold one row of a 16-wide thread tile.
__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row stride of the bf16 attention's float32 (B, H, T) log-sum-exp and
// rowsum(dO o O) arrays: T rounded up to the backward's 64-row query tile,
// so a tile's slice is one aligned bulk copy (flash_attention.cu writes
// the lse, flash_attention_bwd.cu reads both; flash_attn/ops.py lse_len).
constexpr int kLseRows = 64;
__host__ __device__ __forceinline__ int lse_stride(int t_len) {
  return (t_len + kLseRows - 1) / kLseRows * kLseRows;
}

}  // namespace repro
