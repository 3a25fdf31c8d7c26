// Nystrom reconstruction K~ = B diag(s) B^T: the O(n^2 m) hot spot of the
// paper's section 4 evaluation (Fig. 2).
//
// Replaces the TPU kernel
//   src/repro/kernels/nystrom_recon/nystrom_recon.py::scaled_gram
//   (pallas_call at :49, body _kernel :21).
//
// B is (n, k) row-major (B = K_nm U, k the factor's width), s is (k,), the
// output (n, n) row-major.  The diagonal scale is fused into the left
// operand as the slab is staged (as the TPU kernel scales its left tile in
// VMEM), so the scaled copy of B never exists in device memory: B is read,
// K~ written.  Accumulates in T: float for f32, double for f64.  (The TPU
// kernel accumulates in float32 even for f64 B, preferred_element_type at
// :31; ROADMAP.md, "Faults found".)
//
// What bounds it on an H100: operations.  K~ is symmetric, so the function
// needs n (n + 1) k flops (8.6 GFLOP at n = 4096, k = 512) against
// 4 n k + 4 n^2 bytes, at the FP32 (or FP64) CUDA-core rate; TF32 tensor
// cores would miss the f32 tolerances.  This kernel does 2 n^2 k.  Design: the
// classic SIMT tiling, a TILE x TILE output tile per block of 256 threads
// (f32: 128 x 128, 8 x 8 per thread; f64: 64 x 64, 4 x 4), the reduction
// in 16-wide slabs of both operands staged in shared memory.  Both tiles
// of the full K~ are computed, though it is symmetric, as the TPU kernel
// does; wgmma and a triangular grid are later work.
#include "common.cuh"

namespace {

constexpr int kSlab = 16;

template <typename T, int TILE>
__global__ void __launch_bounds__(256)
scaled_gram_kernel(const T* __restrict__ b, const T* __restrict__ s,
                   T* __restrict__ out, int n, int k) {
  constexpr int TM = TILE / 16;             // outputs per thread per axis
  __shared__ T as[kSlab][TILE + 1];         // as[kk][i] = B[i0+i, k0+kk]*s
  __shared__ T bs[kSlab][TILE + 1];         // bs[kk][j] = B[j0+j, k0+kk]
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  T acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < k; k0 += kSlab) {
    // A warp reads 16 consecutive entries of two rows (coalesced).
    for (int e = threadIdx.x; e < TILE * kSlab; e += 256) {
      const int r = e / kSlab, kk = e % kSlab;
      const int gk = k0 + kk;
      const bool kin = gk < k;
      const int gi = i0 + r, gj = j0 + r;
      as[kk][r] = (kin && gi < n) ? b[(size_t)gi * k + gk] * s[gk] : T(0);
      bs[kk][r] = (kin && gj < n) ? b[(size_t)gj * k + gk] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      T a[TM], c[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TM; ++j) c[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fma(a[i], c[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = i0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = j0 + tx + 16 * j;
      if (r < n && c < n) out[(size_t)r * n + c] = acc[i][j];
    }
  }
}

template <typename T, int TILE>
int launch(const void* b, const void* s, void* out, int n, int k,
           void* stream) {
  if (n > 0) {
    const int tiles = (n + TILE - 1) / TILE;
    scaled_gram_kernel<T, TILE><<<dim3(tiles, tiles), 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(b), static_cast<const T*>(s),
        static_cast<T*>(out), n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scaled_gram_f32(const void* b, const void* s, void* out, int n,
                               int k, void* stream) {
  return launch<float, 128>(b, s, out, n, k, stream);
}

extern "C" int scaled_gram_f64(const void* b, const void* s, void* out, int n,
                               int k, void* stream) {
  return launch<double, 64>(b, s, out, n, k, stream);
}
