// Pruned eigenbasis projection P = U^T V (Algorithm 2's second pair).
//
// Replaces the TPU kernel
//   src/repro/kernels/eigvec_update/eigvec_update.py::eigvec_project
//   (pallas_call at :272).
//
// U is (n, n) row-major, V is (n, ncol) with ncol <= 8, P is (n, ncol).
// Rows of V at or beyond the active count m (read by pointer) are masked:
// the row loop stops at m.  Output rows of P (columns of U) in slabs at or
// beyond ceil(m / 32) are exact zeros — their true value, since inactive
// U columns are identity columns supported on masked rows.
//
// What bounds it on an H100: bytes.  It reads the active m x m block of U
// once (4 MB at m = 1024 in f32) and does 2 * ncol flops per entry, far
// below the ridge.  Design: one block per 32-column slab of U; its 256
// threads are 32 columns x 8 row phases, so each warp reads 32 consecutive
// entries of one row (one coalesced 128-byte line in f32) and the V row it
// needs is a broadcast.  The 8 row phases are summed in shared memory.
// No atomics: each P entry is written by one block, so results do not
// depend on scheduling.
#include "common.cuh"

namespace {

constexpr int kSlab = 32;     // columns of U per block
constexpr int kPhases = 8;    // row phases per block
constexpr int kMaxCols = 8;   // NPROJ

template <typename T>
__global__ void __launch_bounds__(kSlab * kPhases)
eigvec_project_kernel(const T* __restrict__ u, const T* __restrict__ v,
                      const int* __restrict__ m_ptr, T* __restrict__ out,
                      int n, int ncol) {
  const int m = repro::active_count(m_ptr, n);
  const int c = threadIdx.x % kSlab;
  const int ph = threadIdx.x / kSlab;
  const int col = blockIdx.x * kSlab + c;
  const bool active = blockIdx.x * kSlab < m;   // slab < ceil(m / 32)

  T acc[kMaxCols];
#pragma unroll
  for (int q = 0; q < kMaxCols; ++q) acc[q] = T(0);
  if (active && col < n) {
    for (int i = ph; i < m; i += kPhases) {
      const T uv = u[(size_t)i * n + col];
#pragma unroll
      for (int q = 0; q < kMaxCols; ++q)
        if (q < ncol) acc[q] = fma(uv, v[(size_t)i * ncol + q], acc[q]);
    }
  }

  __shared__ T red[kPhases][kSlab][kMaxCols];
#pragma unroll
  for (int q = 0; q < kMaxCols; ++q) red[ph][c][q] = acc[q];
  __syncthreads();
  if (ph == 0 && col < n) {
    for (int q = 0; q < ncol; ++q) {
      T s = T(0);
#pragma unroll
      for (int p = 0; p < kPhases; ++p) s += red[p][c][q];
      out[(size_t)col * ncol + q] = s;
    }
  }
}

template <typename T>
int launch(const void* u, const void* v, const void* m, void* out, int n,
           int ncol, void* stream) {
  if (n > 0) {
    eigvec_project_kernel<T><<<(n + kSlab - 1) / kSlab, kSlab * kPhases, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const int*>(m), static_cast<T*>(out), n, ncol);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int eigvec_project_f32(const void* u, const void* v,
                                  const void* m, void* out, int n, int ncol,
                                  void* stream) {
  return launch<float>(u, v, m, out, n, ncol, stream);
}

extern "C" int eigvec_project_f64(const void* u, const void* v,
                                  const void* m, void* out, int n, int ncol,
                                  void* stream) {
  return launch<double>(u, v, m, out, n, ncol, stream);
}
