// Dense RBF gram G[i, j] = exp(-max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) / sigma)
// by the norm expansion, with the exp epilogue fused: G is written once and
// the distance matrix never exists in device memory.
//
// Replaces the TPU kernel
//   src/repro/kernels/rbf_gram/rbf_gram.py::rbf_gram
//   (pallas_call at :61, body _kernel :23).
//
// x is (n, d) and y (m, d), row-major; the output (n, m) row-major.  Unlike
// the TPU wrapper, which computes the row norms outside its pallas_call
// (:56-57) and pads n, m to 128 and d to a multiple of 8 with zeros, this
// kernel squares the staged tiles itself (one launch per call) and masks
// the ragged edges: rows and columns beyond n, m and features beyond d are
// staged as zeros, which add nothing to a norm or a dot product, and are
// never written.  Everything sums in T, and 1/sigma is formed in T: float
// for f32, double for f64.  (The TPU kernel sums in float32 even for f64
// operands and casts 1/sigma to float32, :35, :58, :73; ROADMAP.md,
// "Faults found".)  The library exp/expf, no fast math.
//
// What bounds it on an H100: at the roofline shape (n = m = 1024, d = 64,
// f32) operations, 2 n m (d + 2) flops against (2 n d + n m) 4 bytes, and a
// launch costs more than either; at Fig. 2's full gram (n = m = 4096,
// d = 10, f64) the bytes of G.  Design: the classic SIMT tiling, a 64 x 64
// output tile per block of 256 threads, 4 x 4 outputs per thread, the
// reduction over d in 16-wide slabs of both operands staged in shared
// memory.  Threads 0-63 square the staged x rows and 64-127 the y rows as
// the slabs pass, so each norm is summed once per block.  A warp writes two
// rows of 16 consecutive outputs.  Tensor cores (TF32 would miss the f32
// tolerances; f64 DMMA) are later work.
#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kSlab = 16;

template <typename T>
__global__ void __launch_bounds__(256)
rbf_gram_kernel(const T* __restrict__ x, const T* __restrict__ y,
                T* __restrict__ out, int n, int m, int d, double sigma) {
  constexpr int TM = kTile / 16;            // outputs per thread per axis
  __shared__ T xs[kSlab][kTile + 1];        // xs[kk][i] = x[i0+i, k0+kk]
  __shared__ T ys[kSlab][kTile + 1];        // ys[kk][j] = y[j0+j, k0+kk]
  __shared__ T xn[kTile], yn[kTile];
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int nr = threadIdx.x % kTile;       // the row this thread squares

  T acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = T(0);
  T norm = T(0);

  for (int k0 = 0; k0 < d; k0 += kSlab) {
    for (int e = threadIdx.x; e < kTile * kSlab; e += 256) {
      const int r = e / kSlab, kk = e % kSlab;
      const int gk = k0 + kk;
      const bool kin = gk < d;
      const int gi = i0 + r, gj = j0 + r;
      xs[kk][r] = (kin && gi < n) ? x[(size_t)gi * d + gk] : T(0);
      ys[kk][r] = (kin && gj < m) ? y[(size_t)gj * d + gk] : T(0);
    }
    __syncthreads();
    if (threadIdx.x < 2 * kTile) {
      const T (*src)[kTile + 1] = threadIdx.x < kTile ? xs : ys;
#pragma unroll
      for (int kk = 0; kk < kSlab; ++kk)
        norm = fma(src[kk][nr], src[kk][nr], norm);
    }
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      T a[TM], c[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TM; ++j) c[j] = ys[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fma(a[i], c[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (threadIdx.x < kTile) xn[nr] = norm;
  else if (threadIdx.x < 2 * kTile) yn[nr] = norm;
  __syncthreads();

  const T inv_sigma = T(1) / T(sigma);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int li = ty + 16 * i;
    const int r = i0 + li;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int lj = tx + 16 * j;
      const int c = j0 + lj;
      if (r < n && c < m) {
        const T d2 = max(xn[li] + yn[lj] - T(2) * acc[i][j], T(0));
        out[(size_t)r * m + c] = exp(-d2 * inv_sigma);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* out, int n, int m, int d,
           double sigma, void* stream) {
  if (n > 0 && m > 0) {
    const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
    rbf_gram_kernel<T><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<T*>(out), n, m, d, sigma);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rbf_gram_f32(const void* x, const void* y, void* out, int n,
                            int m, int d, double sigma, void* stream) {
  return launch<float>(x, y, out, n, m, d, sigma, stream);
}

extern "C" int rbf_gram_f64(const void* x, const void* y, void* out, int n,
                            int m, int d, double sigma, void* stream) {
  return launch<double>(x, y, out, n, m, d, sigma, stream);
}
