// Fused kernel row + eigenbasis projection: the ingest prologue.
//
// Replaces the TPU kernel
//   src/repro/kernels/rbf_gram/krow_fused.py::krow_project
//   (pallas_call at :174).
//
// For stored points X (n, dim), a new point x_new (dim,), eigenvectors
// U (n, n) row-major and aux (n, naux) with naux <= 7, it computes
//   a[i] = k(X[i], x_new) * [i < m]                      (n,)
//   P    = U^T [a | aux * [row < m]]                     (n, 1 + naux)
// with k the RBF or Matern-3/2 epilogue of common.cuh, on the norm
// expansion d2 = max(|X_i|^2 + |x_new|^2 - 2 X_i.x_new, 0) as
// kernels_fn.gram_block writes it.  The kernel row never goes to memory
// before it is contracted, and U is read once.
//
// Pruning: m is read by pointer; output rows of P in 32-column slabs at or
// beyond ceil(m / 32) are exact zeros (their true value: inactive U
// columns are identity columns on masked rows), and the row loop stops at
// m.  The block of slab 0 also writes a, zeros included.
//
// What bounds it on an H100: bytes — one read of the active block of U
// (4 MB at m = 1024, f32) against 2 (1 + naux) flops per entry.  Design:
// one block per 32-column slab; its 256 threads are 32 columns x 8 row
// phases (coalesced rows of U).  Each block walks the active rows in
// chunks of 256: first every thread evaluates one row of a (a dim-length
// dot product and the epilogue) into shared memory beside that row's aux
// entries, then the block contracts the chunk against its U columns.
// Recomputing a in every slab costs O(m dim) per block and needs no
// reduction across blocks (the TPU kernel carried it across the grid).
#include "common.cuh"

namespace {

constexpr int kSlab = 32;
constexpr int kPhases = 8;
constexpr int kThreads = kSlab * kPhases;
constexpr int kChunk = kThreads;   // rows of a per chunk: one per thread
constexpr int kCols = 8;           // NAUX: the kernel row + up to 7 aux

template <typename T>
__global__ void __launch_bounds__(kThreads)
krow_project_kernel(const T* __restrict__ u, const T* __restrict__ x,
                    const T* __restrict__ xq, const T* __restrict__ aux,
                    const int* __restrict__ m_ptr, T* __restrict__ a_out,
                    T* __restrict__ p_out, int n, int dim, int naux,
                    int kind, T sigma, T scale) {
  const int m = repro::active_count(m_ptr, n);
  const int ncol = 1 + naux;
  const int c = threadIdx.x % kSlab;
  const int ph = threadIdx.x / kSlab;
  const int col = blockIdx.x * kSlab + c;
  const bool active = blockIdx.x * kSlab < m;   // slab < ceil(m / 32)
  const bool writer = blockIdx.x == 0;          // also writes a

  T qn = T(0);                                  // |x_new|^2
  for (int k = 0; k < dim; ++k) qn = fma(xq[k], xq[k], qn);

  __shared__ T vs[kChunk][kCols];               // [a | aux] per chunk row
  T acc[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) acc[q] = T(0);

  const int rows = writer ? n : (active ? m : 0);
  for (int base = 0; base < rows; base += kChunk) {
    const int i = base + threadIdx.x;
    T ai = T(0);
    if (i < m) {
      T xn = T(0), dot = T(0);
      for (int k = 0; k < dim; ++k) {
        const T xv = x[(size_t)i * dim + k];
        xn = fma(xv, xv, xn);
        dot = fma(xv, xq[k], dot);
      }
      const T d2 = max(xn + qn - T(2) * dot, T(0));
      ai = repro::kernel_epilogue(d2, kind, sigma, scale);
    }
    vs[threadIdx.x][0] = ai;
    for (int q = 0; q < naux; ++q)
      vs[threadIdx.x][1 + q] = i < m ? aux[(size_t)i * naux + q] : T(0);
    if (writer && i < n) a_out[i] = ai;
    __syncthreads();
    if (active && col < n) {
      const int end = min(kChunk, m - base);
      for (int r = ph; r < end; r += kPhases) {
        const T uv = u[(size_t)(base + r) * n + col];
#pragma unroll
        for (int q = 0; q < kCols; ++q)
          if (q < ncol) acc[q] = fma(uv, vs[r][q], acc[q]);
      }
    }
    __syncthreads();
  }

  __shared__ T red[kPhases][kSlab][kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) red[ph][c][q] = acc[q];
  __syncthreads();
  if (ph == 0 && col < n) {
    for (int q = 0; q < ncol; ++q) {
      T s = T(0);
#pragma unroll
      for (int p = 0; p < kPhases; ++p) s += red[p][c][q];
      p_out[(size_t)col * ncol + q] = s;
    }
  }
}

template <typename T>
int launch(const void* u, const void* x, const void* xq, const void* aux,
           const void* m, void* a, void* p, int n, int dim, int naux,
           int kind, double sigma, double scale, void* stream) {
  if (n > 0) {
    krow_project_kernel<T><<<(n + kSlab - 1) / kSlab, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(x),
        static_cast<const T*>(xq), static_cast<const T*>(aux),
        static_cast<const int*>(m), static_cast<T*>(a), static_cast<T*>(p),
        n, dim, naux, kind, static_cast<T>(sigma), static_cast<T>(scale));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int krow_project_f32(const void* u, const void* x, const void* xq,
                                const void* aux, const void* m, void* a,
                                void* p, int n, int dim, int naux, int kind,
                                double sigma, double scale, void* stream) {
  return launch<float>(u, x, xq, aux, m, a, p, n, dim, naux, kind, sigma,
                       scale, stream);
}

extern "C" int krow_project_f64(const void* u, const void* x, const void* xq,
                                const void* aux, const void* m, void* a,
                                void* p, int n, int dim, int naux, int kind,
                                double sigma, double scale, void* stream) {
  return launch<double>(u, x, xq, aux, m, a, p, n, dim, naux, kind, sigma,
                        scale, stream);
}
