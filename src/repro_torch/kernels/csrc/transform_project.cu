// Fused batched transform: query kernel rows + component projection.
//
// Replaces the TPU kernel
//   src/repro/kernels/nystrom_recon/transform_batch.py::transform_project
//   (pallas_call at :123).
//
// For queries xq (nq, dim), stored points X (n, dim) and a projection
// S (n, ncomp) with ncomp <= 8 it computes, with Kq[i, j] = k(xq_i, X_j)
// masked to columns j < m (m read by pointer),
//   Y      = Kq @ S          (nq, ncomp)
//   rowsum = Kq @ 1          (nq,)
// in one pass: the query gram is never stored.  The epilogue and the norm
// expansion d2 = max(|xq_i|^2 + |X_j|^2 - 2 xq_i.X_j, 0) follow
// kernels_fn.gram_block term for term.
//
// What bounds it on an H100: at the service's shapes (nq = 64, m ~ 1000,
// dim = 16, ncomp = 8) it moves ~0.1 MB and does ~4 MFLOP, so the launch
// itself dominates; counted alone, the bytes bound it.  Design: one block
// per tile of 8 queries; its 256 threads stride over the active columns
// j < m, each thread computing its column's kernel values for the 8
// queries in registers and accumulating them times S[j, :] and into the
// row sums; a warp-shuffle then shared-memory reduction gives the block's
// 8 x (ncomp + 1) results.  Pruned columns (j >= m) are never visited.
#include "common.cuh"

namespace {

constexpr int kQueries = 8;    // queries per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxComp = 8;    // projection columns
constexpr int kOut = kQueries * (kMaxComp + 1);

template <typename T>
__global__ void __launch_bounds__(kThreads)
transform_project_kernel(const T* __restrict__ xq, const T* __restrict__ x,
                         const T* __restrict__ s,
                         const int* __restrict__ m_ptr, T* __restrict__ y,
                         T* __restrict__ rowsum, int nq, int n, int dim,
                         int ncomp, int kind, T sigma, T scale) {
  const int m = repro::active_count(m_ptr, n);
  const int q0 = blockIdx.x * kQueries;
  const int nqb = min(kQueries, nq - q0);

  __shared__ T qn[kQueries];                  // |xq_i|^2
  if (threadIdx.x < nqb) {
    T acc = T(0);
    for (int k = 0; k < dim; ++k) {
      const T v = xq[(size_t)(q0 + threadIdx.x) * dim + k];
      acc = fma(v, v, acc);
    }
    qn[threadIdx.x] = acc;
  }
  __syncthreads();

  T acc[kQueries][kMaxComp + 1];              // [.., ncomp] is the row sum
#pragma unroll
  for (int q = 0; q < kQueries; ++q)
#pragma unroll
    for (int c = 0; c <= kMaxComp; ++c) acc[q][c] = T(0);

  for (int j = threadIdx.x; j < m; j += kThreads) {
    T xn = T(0);
    for (int k = 0; k < dim; ++k) {
      const T v = x[(size_t)j * dim + k];
      xn = fma(v, v, xn);
    }
    T sj[kMaxComp];
#pragma unroll
    for (int c = 0; c < kMaxComp; ++c)
      sj[c] = c < ncomp ? s[(size_t)j * ncomp + c] : T(0);
#pragma unroll
    for (int q = 0; q < kQueries; ++q) {
      if (q < nqb) {
        T dot = T(0);
        for (int k = 0; k < dim; ++k)
          dot = fma(xq[(size_t)(q0 + q) * dim + k], x[(size_t)j * dim + k],
                    dot);
        const T d2 = max(qn[q] + xn - T(2) * dot, T(0));
        const T kq = repro::kernel_epilogue(d2, kind, sigma, scale);
#pragma unroll
        for (int c = 0; c < kMaxComp; ++c)
          acc[q][c] = fma(kq, sj[c], acc[q][c]);
        acc[q][kMaxComp] += kq;
      }
    }
  }

  __shared__ T red[kWarps][kOut];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int q = 0; q < kQueries; ++q)
#pragma unroll
    for (int c = 0; c <= kMaxComp; ++c) {
      const T v = repro::warp_sum(acc[q][c]);
      if (lane == 0) red[warp][q * (kMaxComp + 1) + c] = v;
    }
  __syncthreads();
  if (threadIdx.x < kOut) {
    const int q = threadIdx.x / (kMaxComp + 1);
    const int c = threadIdx.x % (kMaxComp + 1);
    T v = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
    if (q < nqb) {
      if (c == kMaxComp)
        rowsum[q0 + q] = v;
      else if (c < ncomp)
        y[(size_t)(q0 + q) * ncomp + c] = v;
    }
  }
}

template <typename T>
int launch(const void* xq, const void* x, const void* s, const void* m,
           void* y, void* rowsum, int nq, int n, int dim, int ncomp, int kind,
           double sigma, double scale, void* stream) {
  if (nq > 0) {
    transform_project_kernel<T><<<(nq + kQueries - 1) / kQueries, kThreads,
                                  0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(xq), static_cast<const T*>(x),
        static_cast<const T*>(s), static_cast<const int*>(m),
        static_cast<T*>(y), static_cast<T*>(rowsum), nq, n, dim, ncomp, kind,
        static_cast<T>(sigma), static_cast<T>(scale));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int transform_project_f32(const void* xq, const void* x,
                                     const void* s, const void* m, void* y,
                                     void* rowsum, int nq, int n, int dim,
                                     int ncomp, int kind, double sigma,
                                     double scale, void* stream) {
  return launch<float>(xq, x, s, m, y, rowsum, nq, n, dim, ncomp, kind, sigma,
                       scale, stream);
}

extern "C" int transform_project_f64(const void* xq, const void* x,
                                     const void* s, const void* m, void* y,
                                     void* rowsum, int nq, int n, int dim,
                                     int ncomp, int kind, double sigma,
                                     double scale, void* stream) {
  return launch<double>(xq, x, s, m, y, rowsum, nq, n, dim, ncomp, kind,
                        sigma, scale, stream);
}
