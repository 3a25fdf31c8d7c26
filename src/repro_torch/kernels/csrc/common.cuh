// Shared device helpers of the port's CUDA kernels.
#pragma once

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

}  // namespace repro
