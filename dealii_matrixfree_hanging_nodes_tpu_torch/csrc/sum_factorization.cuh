// The cell stiffness by sum factorization, shared by cell_apply.cu and hn_cell.cu: a group of G
// cells (n = p+1, n_loc = n^3 local nodes each, x fastest) goes through the 7 sweeps of the 1-D
// factors K1 and M1 of
//   K = Mz (x) My (x) K1x + Mz (x) K1y (x) Mx + K1z (x) My (x) Mx   (M = M1 on each axis)
// in two shared-memory scratch buffers of G n_loc values, one line of n values per thread:
//     x, line (g, z, y):  a = M1 x,          b = K1 x        (x read by the caller)
//     y, line (g, z, x):  c1 = M1 b + K1 a,  c2 = M1 a
//     z, line (g, y, x):  out = scale (M1 c1 + K1 c2)
// A thread holds its line in registers and writes its results back over the line it read, so
// each sweep needs a barrier after it and no third buffer. K1 and M1 travel with the launch as
// its parameters (the constant bank): with the loops unrolled, every factor entry is an operand
// of its FMA, with no load. The 2-D form (two sweeps, sweep_x and sweep_y2) follows the 3-D one.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace sf {

constexpr int round4(int x) { return (x + 3) / 4 * 4; }

template <int P>
struct Cfg {
  static constexpr int N = P + 1;
  static constexpr int N2 = N * N;
  static constexpr int NL = N2 * N;
  static constexpr int G = P == 4 ? 16 : 8;  // cells per group; G * N2 lines per sweep
  static constexpr int THREADS = (G * N2 + 31) / 32 * 32;
  static constexpr int SCR = round4(G * NL);  // one scratch buffer
  static_assert(G * NL % 4 == 0, "a full tile of rows is whole 16-byte words");
};

template <typename T, int N>
struct Factors {
  T K[N * N];
  T M[N * N];
};

// n values of one line, at stride S, into registers
template <typename T, int N, int S>
__device__ __forceinline__ void load_line(const T* p, T (&r)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = p[k * S];
}

// Copy `count` values between device and shared memory with 16-byte accesses where both sides
// allow them; the vector tail may touch values past `count`, up to the next 16 bytes (the
// callers' rows are padded that far, or the tile is whole words).
template <typename T>
__device__ __forceinline__ void copy_block(T* __restrict__ dst, const T* __restrict__ src,
                                           int count, bool vec) {
  if (vec) {
    constexpr int VW = 16 / sizeof(T);
    const int nv = (count + VW - 1) / VW;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < nv; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  }
}

// x sweep of line l = (g, z, y), its n values r already in registers: a into sa, b into sb at
// the line's place
template <typename T, int N>
__device__ __forceinline__ void sweep_x(const Factors<T, N>& f, const T (&r)[N], T* sa, T* sb,
                                        int l) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T a = T(0), b = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a += f.M[i * N + j] * r[j];
      b += f.K[i * N + j] * r[j];
    }
    sa[l * N + i] = a;
    sb[l * N + i] = b;
  }
}

// y sweep of line l = (g, z, x), stride N: c1 over b in sb, c2 over a in sa
template <typename T, int N>
__device__ __forceinline__ void sweep_y(const Factors<T, N>& f, T* sa, T* sb, int l) {
  constexpr int N2 = N * N, NL = N2 * N;
  const int g = l / N2, z = (l / N) % N, x = l % N;
  const int o = g * NL + z * N2 + x;
  T a[N], b[N];
  load_line<T, N, N>(sa + o, a);
  load_line<T, N, N>(sb + o, b);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T c1 = T(0), c2 = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c1 += f.M[i * N + j] * b[j] + f.K[i * N + j] * a[j];
      c2 += f.M[i * N + j] * a[j];
    }
    sb[o + i * N] = c1;
    sa[o + i * N] = c2;
  }
}

// z sweep of line l = (g, y, x), stride N^2: s (M1 c1 + K1 c2) to dst[i * N^2], i = 0..n-1.
// dst may be the line's own place in sa or sb: both lines are in registers before any store.
template <typename T, int N>
__device__ __forceinline__ void sweep_z(const Factors<T, N>& f, const T* sa, const T* sb, int l,
                                        T s, T* dst) {
  constexpr int N2 = N * N, NL = N2 * N;
  const int g = l / N2, yx = l - g * N2;
  T c1[N], c2[N];
  load_line<T, N, N2>(sb + g * NL + yx, c1);
  load_line<T, N, N2>(sa + g * NL + yx, c2);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) acc += f.M[i * N + j] * c1[j] + f.K[i * N + j] * c2[j];
    dst[i * N2] = s * acc;
  }
}

// ---- 2-D ---------------------------------------------------------------------------------
// A 2-D cell holds n^2 values (x fastest) and K = My (x) K1x + K1y (x) Mx takes two sweeps, one
// line of n values a thread:
//     x, line (g, y):  a = M1 x,  b = K1 x        (sweep_x: the line sits at l n, as in 3-D)
//     y, line (g, x):  out = scale (M1 b + K1 a)  (sweep_y2)
// Line l of the y sweep is (g, x) = (l / n, l % n), its values n apart.

// y sweep of 2-D line l = (g, x): s (M1 b + K1 a) to dst[i * N], i = 0..n-1, b in sb and a in sa
// at the line's place. dst may be the line's own place in sa or sb: both lines are in registers
// before any store.
template <typename T, int N>
__device__ __forceinline__ void sweep_y2(const Factors<T, N>& f, const T* sa, const T* sb, int l,
                                         T s, T* dst) {
  const int g = l / N, x = l - g * N;
  T a[N], b[N];
  load_line<T, N, N>(sa + g * N * N + x, a);
  load_line<T, N, N>(sb + g * N * N + x, b);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) acc += f.M[i * N + j] * b[j] + f.K[i * N + j] * a[j];
    dst[i * N] = s * acc;
  }
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` once per device: `done` (a static of
// the caller's instantiation) keeps one bit per device, so the launches after the first make
// no attribute call.
template <typename K>
inline cudaError_t allow_smem_once(K kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace sf
