// The even-odd sweeps of a cell line in registers, with the 1-D factors as launch parameters
// (the constant bank), shared by cell_elasticity.cu and cell_laplace.cu; and the 4- and 8-byte
// cp.async gathers both kernels stage their next group of cells with.
//
// S [q][i], the values of the nodal basis at the Gauss points, and D = Dc S, its derivatives
// there, satisfy S[N-1-i][N-1-j] = S[i][j] and D[N-1-i][N-1-j] = -D[i][j] on the symmetric Gauss
// points and nodes (their transposes alike), so a sweep forms the sums and differences of the
// mirrored inputs and takes (N/2 + N%2) (N/2) + (N/2)^2 products, not N^2 (13, not 25, at p=4).
// The host packs each factor's even and odd halves (kernels/_even_odd.py: factor_tables).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace eo {

// A 1-D factor M [N][N] (row: output point or node) split even-odd: with M[N-1-i][N-1-j] =
// s M[i][j] (s = +1 for S and S^T, -1 for D and D^T), for rows i < (N+1)/2
//   A[i][j] = (M[i][j] + M[i][N-1-j]) / 2,  B[i][j] = (M[i][j] - M[i][N-1-j]) / 2  (j < N/2),
//   C[i] = M[i][N/2] (odd N; zero for even N),
// _even_odd.factor_tables' packing, value for value.
template <typename T, int N>
struct Fac1 {
  static constexpr int H = N / 2, HH = (N + 1) / 2;
  T A[HH][H];
  T B[HH][H];
  T C[HH];
};

constexpr int FS = 0, FD = 1, FST = 2, FDT = 3;  // S, D = Dc S, S^T, D^T

template <typename T, int N>
struct Factors {
  Fac1<T, N> m[4];
};

// out = M in on a line in registers (in and out distinct), M's mirror sign SIGN
template <typename T, int N, int SIGN>
__device__ __forceinline__ void mat(const Fac1<T, N>& M, const T (&in)[N], T (&out)[N]) {
  constexpr int H = N / 2;
  T e[H], o[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    e[j] = in[j] + in[N - 1 - j];
    o[j] = in[j] - in[N - 1 - j];
  }
#pragma unroll
  for (int i = 0; i < H; ++i) {
    T E = M.A[i][0] * e[0], O = M.B[i][0] * o[0];
#pragma unroll
    for (int j = 1; j < H; ++j) {
      E += M.A[i][j] * e[j];
      O += M.B[i][j] * o[j];
    }
    if constexpr (N % 2 == 1) E += M.C[i] * in[H];
    out[i] = E + O;
    out[N - 1 - i] = SIGN > 0 ? E - O : O - E;
  }
  if constexpr (N % 2 == 1) {  // the middle row: even for SIGN +1, odd for -1
    if constexpr (SIGN > 0) {
      T E = M.C[H] * in[H];
#pragma unroll
      for (int j = 0; j < H; ++j) E += M.A[H][j] * e[j];
      out[H] = E;
    } else {
      T O = M.B[H][0] * o[0];
#pragma unroll
      for (int j = 1; j < H; ++j) O += M.B[H][j] * o[j];
      out[H] = O;
    }
  }
}

template <typename T, int N, int STRIDE>
__device__ __forceinline__ void load(const T* p, T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = p[i * STRIDE];
}

template <typename T, int N, int STRIDE>
__device__ __forceinline__ void store(T* p, const T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) p[i * STRIDE] = r[i];
}

// the launch parameters' factors from the host's float64 tables (factor_tables' order)
template <typename T, int N>
Factors<T, N> factors_from(const double* host) {
  Factors<T, N> f;
  T* dst = reinterpret_cast<T*>(&f);
  static_assert(sizeof(Factors<T, N>) % sizeof(T) == 0, "factor tables hold T values only");
  for (size_t i = 0; i < sizeof(Factors<T, N>) / sizeof(T); ++i) dst[i] = static_cast<T>(host[i]);
  return f;
}

// cp.async copies of sizeof(T) bytes into shared memory
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

}  // namespace eo
