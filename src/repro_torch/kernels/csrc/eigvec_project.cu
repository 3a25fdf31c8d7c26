// Pruned eigenbasis projection P = U^T V (Algorithm 2's second pair).
//
// Replaces the TPU kernel
//   src/repro/kernels/eigvec_update/eigvec_update.py::eigvec_project
//   (pallas_call at :272).
//
// U is a row block (R rows of n, row-major) whose first row is the
// state's row r0 (R = n and r0 = 0 for the whole state); V is (R, ncol)
// with ncol <= 8; P is the (n, ncol) partial of the block.  Rows of the
// block at or beyond the active count m (global index, read by pointer)
// are masked: the sum runs over rows r0 + i < m.  Output rows of P
// (columns of U) in slabs at or beyond ceil(m / 32) are exact zeros (32 is
// ops.PROJECT_SLAB).
//
// Tenants (the reference's pallas_call under jax.vmap): one launch serves
// nb tenants, each with operands of the single call's shape laid one after
// another (U by R x n, V by R x ncol, P by n x ncol, m by one int).  The
// tenant is the grid's z axis, beside the cluster's y: it picks the rows a
// block reads, never the order of a sum, so tenant b of a launch equals a
// launch on its operands alone bit for bit.
//
// What bounds it on an H100, and the design: project_tile.cuh (64-column
// slabs x 8 row ranks, one cluster per slab, the chunk's loads of U in
// flight before the first FMA, partials added in rank order through
// distributed shared memory).  Its staging hook here copies V's live
// columns of the chunk's rows from memory (one load a thread at ncol = 2),
// so V's loads are one trip to memory, alongside U's.
#include "project_tile.cuh"

namespace {

namespace pj = repro::project;

template <typename T, bool Vec>
__global__ void __cluster_dims__(1, pj::kCluster, 1)
    __launch_bounds__(pj::kThreads)
eigvec_project_kernel(const T* __restrict__ u,
                      const T* __restrict__ v, const int* __restrict__ m_ptr,
                      T* __restrict__ out, int R, int n, int ncol, int r0) {
  const int b = blockIdx.z;                  // the tenant
  u += (size_t)b * R * n;
  v += (size_t)b * R * ncol;
  out += (size_t)b * n * ncol;
  const int m = repro::active_count(m_ptr + b, n);
  const int rows = pj::live_rows(m, r0, R);
  pj::project<T, Vec>(u, n, ncol, m, rows, out,
                      [&](T (*vs)[pj::kMaxCols], int base) {
#pragma unroll 4
    for (int e = threadIdx.x; e < pj::kChunk * ncol; e += pj::kThreads) {
      const int i = e / ncol, q = e % ncol;
      vs[i][q] = base + i < rows ? v[(size_t)(base + i) * ncol + q] : T(0);
    }
  });
}

template <typename T>
int launch(const void* u, const void* v, const void* m, void* out, int R,
           int n, int r0, int ncol, int nb, void* stream) {
  if (n > 0 && ncol > 0 && nb > 0) {
    const dim3 grid((n + pj::kCols - 1) / pj::kCols, pj::kCluster, nb);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* kernel = pj::vector_rows<T>(u, n) ? eigvec_project_kernel<T, true>
                                            : eigvec_project_kernel<T, false>;
    kernel<<<grid, pj::kThreads, 0, s>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const int*>(m), static_cast<T*>(out), R, n, ncol, r0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int eigvec_project_f32(const void* u, const void* v,
                                  const void* m, void* out, int R, int n,
                                  int r0, int ncol, int nb, void* stream) {
  return launch<float>(u, v, m, out, R, n, r0, ncol, nb, stream);
}

extern "C" int eigvec_project_f64(const void* u, const void* v,
                                  const void* m, void* out, int R, int n,
                                  int r0, int ncol, int nb, void* stream) {
  return launch<double>(u, v, m, out, R, n, r0, ncol, nb, stream);
}
