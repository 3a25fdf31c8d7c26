// The register-blocked product tile of the rotation kernels (both of
// eigvec_rotate2.cu's products and eigvec_rotate.cu's float64 one): one
// block computes a 128 x 64 tile of
// C = A[:, :kmax] @ B[:kmax, :] on the CUDA cores (float32 or float64
// FMA), summing over k in order.
//
//   * 256 threads, 16 x 16; thread (tx, ty) holds rows 8 ty .. 8 ty + 7
//     and four columns (tile_col below) in registers.
//   * The reduction runs in slabs of 128 bytes of A's row (32 floats or
//     16 doubles), in a ring of three stages in shared memory filled by
//     cp.async: the loads of slabs s + 1 and s + 2 are in flight while
//     slab s is multiplied.  Bytes
//     past kmax, A's rows past a_rows and B's columns past b_cols arrive
//     as zeros (the copies' zero fill), so a ragged edge costs no branch
//     in the product.
//   * A thread reads each A value as part of a 16-byte vector along k
//     (float4 / double2) and each B value as part of a 16-byte vector
//     along its columns: 12 shared loads of 16 bytes per 128 FMAs in
//     float32, all without bank conflicts beyond the minimum.
// At a capacity of 1024 the grid is 8 x 16 = 128 blocks: one wave on the
// 132 SMs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {
namespace tile {

constexpr int kRows = 128;           // tile rows
constexpr int kCols = 64;            // tile columns
constexpr int kThreads = 256;

constexpr int kStages = 3;           // slabs in shared memory at once

template <typename T>
struct Shape {
  static constexpr int kVec = 16 / sizeof(T);        // values per 16 bytes
  static constexpr int kDepth = 128 / sizeof(T);     // slab depth (k)
  static constexpr int kLdA = kDepth + kVec;          // A row stride, padded
  static constexpr int kStage = kRows * kLdA + kDepth * kCols;
  static constexpr size_t kSmem = kStages * kStage * sizeof(T);
};

// Column j (0..3) of thread tx within the tile: four adjacent columns in
// float32, two pairs 32 apart in float64, so a warp's 16-byte loads of a
// B row are contiguous.
template <typename T>
__device__ __forceinline__ int tile_col(int tx, int j) {
  constexpr int kVec = Shape<T>::kVec;
  return (j / kVec) * (16 * kVec) + kVec * tx + (j % kVec);
}

// dst[0 .. bytes) = src, the rest of the `size` bytes zero (`size` is
// 16 for a vector copy, sizeof(T) for one value).
template <int Size>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (Size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(Size), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Slab k0 .. k0 + kDepth of A (rows row0 ..) and B (columns col0 ..) into
// one stage.  Vec: 16-byte copies (the leading dims are multiples of 16
// bytes); else one value per copy.
template <typename T, bool Vec>
__device__ __forceinline__ void load_slab(T* as, T* bs,
                                          const T* __restrict__ a, int lda,
                                          int a_rows,
                                          const T* __restrict__ b, int ldb,
                                          int b_cols, int kmax, int row0,
                                          int col0, int k0) {
  using S = Shape<T>;
  constexpr int kUnit = Vec ? S::kVec : 1;             // values per copy
  constexpr int kA = kRows * S::kDepth / kUnit / kThreads;
  constexpr int kB = S::kDepth * kCols / kUnit / kThreads;
#pragma unroll
  for (int q = 0; q < kA; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e / (S::kDepth / kUnit);
    const int k = (e % (S::kDepth / kUnit)) * kUnit;
    const int gr = row0 + r, gk = k0 + k;
    const int live = gr < a_rows ? min(kUnit, max(kmax - gk, 0)) : 0;
    cp_async_zfill<static_cast<int>(kUnit * sizeof(T))>(
        as + r * S::kLdA + k, live ? a + (size_t)gr * lda + gk : a,
        live * (int)sizeof(T));
  }
#pragma unroll
  for (int q = 0; q < kB; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int k = e / (kCols / kUnit);
    const int c = (e % (kCols / kUnit)) * kUnit;
    const int gk = k0 + k, gc = col0 + c;
    const int live = gk < kmax ? min(kUnit, max(b_cols - gc, 0)) : 0;
    cp_async_zfill<static_cast<int>(kUnit * sizeof(T))>(
        bs + k * kCols + c, live ? b + (size_t)gk * ldb + gc : b,
        live * (int)sizeof(T));
  }
}

template <typename T>
struct alignas(16) Vec16 {
  T v[Shape<T>::kVec];
};

// acc[i][j] += sum over the stage's slab of A[8 ty + i, k] B[k, col(j)].
template <typename T>
__device__ __forceinline__ void slab_fma(const T* as, const T* bs,
                                         T (&acc)[8][4], int tx, int ty) {
  using S = Shape<T>;
  constexpr int kVec = S::kVec;
#pragma unroll
  for (int k = 0; k < S::kDepth; k += kVec) {
    Vec16<T> av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const Vec16<T>*>(as + (8 * ty + i) * S::kLdA +
                                                 k);
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      T bv[4];
#pragma unroll
      for (int jv = 0; jv < 4 / kVec; ++jv) {
        const Vec16<T> w = *reinterpret_cast<const Vec16<T>*>(
            bs + (k + u) * kCols + tile_col<T>(tx, jv * kVec));
#pragma unroll
        for (int x = 0; x < kVec; ++x) bv[jv * kVec + x] = w.v[x];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fma(av[i].v[u], bv[j], acc[i][j]);
    }
  }
}

// acc = A[row0 .., :kmax] @ B[:kmax, col0 ..] for this block's tile; `smem`
// holds kStages stages (Shape<T>::kSmem bytes).  Slabs are loaded two
// ahead: the one __syncthreads per slab both publishes slab s and frees the
// stage of slab s - 1, which the loads of slab s + 2 then refill.
template <typename T, bool Vec>
__device__ __forceinline__ void product(T (&acc)[8][4], T* smem,
                                        const T* __restrict__ a, int lda,
                                        int a_rows,
                                        const T* __restrict__ b, int ldb,
                                        int b_cols, int kmax, int row0,
                                        int col0) {
  using S = Shape<T>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
  const int slabs = (kmax + S::kDepth - 1) / S::kDepth;
  auto load = [&](int slab) {
    if (slab < slabs) {
      T* st = smem + (slab % kStages) * S::kStage;
      load_slab<T, Vec>(st, st + kRows * S::kLdA, a, lda, a_rows, b, ldb,
                        b_cols, kmax, row0, col0, slab * S::kDepth);
    }
    cp_async_commit();               // possibly empty: keeps the count
  };
  load(0);
  load(1);
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait_one();             // slab s has landed
    __syncthreads();                 // ... for every thread; s - 1 is done
    load(s + 2);
    const T* cur = smem + (s % kStages) * S::kStage;
    slab_fma<T>(cur, cur + kRows * S::kLdA, acc, tx, ty);
  }
}

// Writes the tile of C (leading dim ldc, rows x cols): entries at or beyond
// live_rows or live_cols as exact zeros, the others times scale[column]
// where `scale` is given; nothing at or beyond rows or cols.  Vec: 16-byte
// stores (ldc and cols multiples of 16 bytes).
template <typename T, bool Vec>
__device__ __forceinline__ void store(const T (&acc)[8][4],
                                      T* __restrict__ c, int ldc, int rows,
                                      int cols, int live_rows, int live_cols,
                                      int row0, int col0,
                                      const T* __restrict__ scale) {
  constexpr int kVec = Shape<T>::kVec;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  T sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + tile_col<T>(tx, j);
    sc[j] = (scale != nullptr && col < cols) ? scale[col] : T(1);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + 8 * ty + i;
    if (r >= rows) continue;
    T* crow = c + (size_t)r * ldc;
#pragma unroll
    for (int jv = 0; jv < 4 / kVec; ++jv) {
      const int col = col0 + tile_col<T>(tx, jv * kVec);
      T w[kVec];
#pragma unroll
      for (int x = 0; x < kVec; ++x) {
        const int j = jv * kVec + x;
        const bool live = r < live_rows && col + x < live_cols;
        w[x] = live ? (scale != nullptr ? acc[i][j] * sc[j] : acc[i][j])
                    : T(0);
      }
      if constexpr (Vec) {
        if (col >= cols) continue;
        Vec16<T> v;
#pragma unroll
        for (int x = 0; x < kVec; ++x) v.v[x] = w[x];
        *reinterpret_cast<Vec16<T>*>(crow + col) = v;
      } else {
#pragma unroll
        for (int x = 0; x < kVec; ++x)
          if (col + x < cols) crow[col + x] = w[x];
      }
    }
  }
}

// The zeros of a pruned tile.
template <typename T>
__device__ __forceinline__ void store_zeros(T* __restrict__ c, int ldc,
                                            int rows, int cols, int row0,
                                            int col0) {
  for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
    const int r = row0 + e / kCols, col = col0 + e % kCols;
    if (r < rows && col < cols) c[(size_t)r * ldc + col] = T(0);
  }
}

}  // namespace tile
}  // namespace repro
