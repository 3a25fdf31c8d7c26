// Fused kernel row + eigenbasis projection: the ingest prologue.
//
// Replaces the TPU kernel
//   src/repro/kernels/rbf_gram/krow_fused.py::krow_project
//   (pallas_call at :174).
//
// U is a row block (R rows of n, row-major) whose first row is the state's
// row r0 (R = n and r0 = 0 for the whole state), X (R, dim) its stored
// points, x_new (dim,) the new point and aux (R, naux) with naux <= 7.
// With m the active count (read by pointer) it computes
//   a[i] = k(X[i], x_new) * [r0 + i < m]                 (R,)
//   P    = U^T [a | aux * [r0 + i < m]]                  (n, 1 + naux)
// with k the RBF or Matern-3/2 epilogue of common.cuh, on the norm
// expansion d2 = max(|X_i|^2 + |x_new|^2 - 2 X_i.x_new, 0) as
// kernels_fn.gram_block writes it.  The kernel row never goes to memory
// before it is contracted, and U is read once.  a is written for every
// row, the masked ones as exact zeros; output rows of P in 32-column slabs
// at or beyond ceil(m / 32) are exact zeros (their true value).
//
// What bounds it on an H100: bytes, one read of the active block of U
// (4 MB at m = 1000 in f32).  Design: eigvec_project's cluster projection
// (project_tile.cuh: 64-column slabs x 8 row ranks, one cluster per slab,
// 128 blocks at n = 1024; a chunk's U loads in flight before the first
// FMA; partials added in rank order over distributed shared memory, so
// the result does not depend on scheduling).  Its staging hook computes
// [a | aux] for the chunk's 128 rows instead of reading them: threads
// 0..127 each evaluate one row of a (X's row read 16 bytes at a time where
// its rows allow), threads 128..255 copy that row's aux entries, while the
// chunk's U loads are in flight.  Every slab recomputes a for its rows
// (16 m dim FMAs at n = 1024, X in L2): no second pass and no atomics;
// the ranks of slab 0 also write a.
//
// Tenants (the reference's pallas_call under jax.vmap): one launch serves
// nb tenants, each with operands of the single call's shape laid one after
// another (U by R x n, X by R x dim, x_new by dim, aux by R x naux, a by
// R, P by n x (1 + naux), m by one int).  The tenant is the grid's z axis,
// beside the cluster's y: it picks the rows a block reads, never the order
// of a sum, so tenant b of a launch equals a launch on its operands alone
// bit for bit.
#include "project_tile.cuh"

namespace {

namespace pj = repro::project;

static_assert(pj::kThreads == 2 * pj::kChunk, "a row and its aux a thread");

template <typename T, bool Vec>
__global__ void __cluster_dims__(1, pj::kCluster, 1)
    __launch_bounds__(pj::kThreads)
krow_project_kernel(const T* __restrict__ u, const T* __restrict__ x,
                    const T* __restrict__ xq, const T* __restrict__ aux,
                    const int* __restrict__ m_ptr, T* __restrict__ a_out,
                    T* __restrict__ p_out, int R, int n, int dim, int naux,
                    int r0, int kind, T sigma, T scale) {
  using P = pj::Pack<T, 16 / sizeof(T)>;
  constexpr int kUnit = 16 / sizeof(T);
  const int b = blockIdx.z;                     // the tenant
  u += (size_t)b * R * n;
  x += (size_t)b * R * dim;
  xq += (size_t)b * dim;
  aux += (size_t)b * R * naux;
  a_out += (size_t)b * R;
  p_out += (size_t)b * n * (1 + naux);
  const int m = repro::active_count(m_ptr + b, n);
  const int rows = pj::live_rows(m, r0, R);
  const bool writer = blockIdx.x == 0;          // slab 0's ranks write a
  if (writer)                                   // a's masked rows
    for (int i = rows + blockIdx.y * pj::kThreads + threadIdx.x; i < R;
         i += pj::kCluster * pj::kThreads)
      a_out[i] = T(0);
  const bool xvec = dim % kUnit == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(xq) % 16 == 0;

  pj::project<T, Vec>(u, n, 1 + naux, m, rows, p_out,
                      [&](T (*vs)[pj::kMaxCols], int base) {
    const int t = threadIdx.x % pj::kChunk;
    const int i = base + t;
    if (threadIdx.x >= pj::kChunk) {            // the row's aux entries
      for (int q = 0; q < naux; ++q)
        vs[t][1 + q] = i < rows ? aux[(size_t)i * naux + q] : T(0);
      return;
    }
    T ai = T(0);
    if (i < rows) {                             // one row of a
      const T* xr = x + (size_t)i * dim;
      T xn = T(0), qn = T(0), dot = T(0);
      if (xvec) {
        for (int k = 0; k < dim; k += kUnit) {
          const P xv = *reinterpret_cast<const P*>(xr + k);
          const P qv = *reinterpret_cast<const P*>(xq + k);
#pragma unroll
          for (int e = 0; e < kUnit; ++e) {
            xn = fma(xv.v[e], xv.v[e], xn);
            qn = fma(qv.v[e], qv.v[e], qn);
            dot = fma(xv.v[e], qv.v[e], dot);
          }
        }
      } else {
        for (int k = 0; k < dim; ++k) {
          const T xv = xr[k], qv = xq[k];
          xn = fma(xv, xv, xn);
          qn = fma(qv, qv, qn);
          dot = fma(xv, qv, dot);
        }
      }
      const T d2 = max(xn + qn - T(2) * dot, T(0));
      ai = repro::kernel_epilogue(d2, kind, sigma, scale);
      if (writer) a_out[i] = ai;
    }
    vs[t][0] = ai;
  });
}

template <typename T>
int launch(const void* u, const void* x, const void* xq, const void* aux,
           const void* m, void* a, void* p, int R, int n, int dim, int naux,
           int r0, int nb, int slabs, int ranks, int kind, double sigma,
           double scale, void* stream) {
  if (slabs != (n + pj::kCols - 1) / pj::kCols || ranks != pj::kCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && nb > 0) {
    const dim3 grid(slabs, ranks, nb);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* kernel = pj::vector_rows<T>(u, n) ? krow_project_kernel<T, true>
                                            : krow_project_kernel<T, false>;
    kernel<<<grid, pj::kThreads, 0, s>>>(
        static_cast<const T*>(u), static_cast<const T*>(x),
        static_cast<const T*>(xq), static_cast<const T*>(aux),
        static_cast<const int*>(m), static_cast<T*>(a), static_cast<T*>(p), R,
        n, dim, naux, r0, kind, static_cast<T>(sigma),
        static_cast<T>(scale));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int krow_project_f32(const void* u, const void* x, const void* xq,
                                const void* aux, const void* m, void* a,
                                void* p, int R, int n, int dim, int naux,
                                int r0, int nb, int slabs, int ranks,
                                int kind, double sigma, double scale,
                                void* stream) {
  return launch<float>(u, x, xq, aux, m, a, p, R, n, dim, naux, r0, nb,
                       slabs, ranks, kind, sigma, scale, stream);
}

extern "C" int krow_project_f64(const void* u, const void* x, const void* xq,
                                const void* aux, const void* m, void* a,
                                void* p, int R, int n, int dim, int naux,
                                int r0, int nb, int slabs, int ranks,
                                int kind, double sigma, double scale,
                                void* stream) {
  return launch<double>(u, x, xq, aux, m, a, p, R, n, dim, naux, r0, nb,
                        slabs, ranks, kind, sigma, scale, stream);
}
