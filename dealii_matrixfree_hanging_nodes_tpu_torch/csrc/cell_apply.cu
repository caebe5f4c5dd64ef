// cell_apply: out[r] = scale[r] * (K x_r) for every cell row r, with n = p+1, n_loc = n^3
// local nodes per row (x fastest) and K the Kronecker sum of the 1-D factors
//   K = Mz (x) My (x) K1x + Mz (x) K1y (x) Mx + K1z (x) My (x) Mx   (M = M1 on each axis).
// Two input modes, chosen by B:
//   B > 0 (from bricks): x_r are the nodes of cell r read from its brick: cell r is slot
//     r % B^3 (x fastest) of brick r / B^3 of src [m, N3p], its node (ix, iy, iz) sits at
//     brick node ((sz*p + iz)*NB + sy*p + iy)*NB + sx*p + ix, NB = B*p + 1;
//   B == 0 (from rows): x_r = src[r, :], src [rows, n_loc].
//
// Replaces: BrickLaplaceMM._extract_cols (dealii_matrixfree_hanging_nodes_tpu/bricks.py:
//   2178-2194) fused with the local stiffness apply `cols @ K.T * geo_cell_sub`
//   (bricks.py:2449-2453), and `u_hat @ K.T * geo_cell_sub[hn_sub]` (bricks.py:2469-2471).
//   The TPU side ran these as XLA conv-patch extraction and dense MXU matmuls with the
//   125 x 125 K (no Pallas kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32: memory, in both modes. Sum
//   factorization needs 7 sweeps of 2 n^4 operations plus the scale, 8,875 a row against
//   the dense product's 31,250. From bricks (1,025 bricks -> 65,600 rows): 53.6 MB read
//   once and written once, 16 us at 3.35 TB/s, against 0.58 GFLOP (8.7 us at 67 TFLOP/s f32
//   outside the tensor cores); from rows (16,744 rows): 16.9 MB, 5.0 us, against 0.15 GFLOP
//   (2.2 us). The tensor cores are not the tool: TF32 keeps about three digits, which fails
//   the 1e-5 bar of the f32 path, and after the cut the bytes bound anyway.
//
// Design: the 7 sweeps of the 1-D factors, in shared memory.
//   From bricks, one block per brick: the brick (NB^3 values, 19.7 KB in f32 at p=4) is
//   staged into shared memory once with coalesced 16-byte loads, then its B^3 cells go
//   through the sweeps in groups of G (16 at p=4, 8 = B^3 at p >= 5), one line per thread:
//     x, line (cell, z, y):  a = M1 x,          b = K1 x        (read from the staged brick)
//     y, line (cell, z, x):  c1 = M1 b + K1 a,  c2 = M1 a
//     z, line (cell, y, x):  out = scale (M1 c1 + K1 c2)
//   a thread holds its line in registers and writes its results back in place over the
//   line it read, so two scratch buffers of G n^3 values suffice; the z sweep stores to
//   out directly (a warp's lanes write the n^2 contiguous values of one output plane of
//   a cell, or of two), so a group costs 3 barriers. From rows, one block per G
//   contiguous rows: the tile is loaded (16-byte loads) into the first scratch buffer and
//   the x sweep reads it there. K1 and M1 travel with the launch as its parameters (the
//   constant bank), so every factor entry
//   is an operand of its FMA; held in shared memory instead, they cost a load per FMA and
//   the shared-memory issue limited the kernel. p and B are template parameters, so
//   every loop unrolls and the index arithmetic is shifts and multiplies. Absent cells are
//   computed like any other (corr_compact overwrites them).
//   Resources (ptxas, sm_90a, CUDA 12.8; no spills, no stack in any instantiation):
//   f32 p=4: 32 registers, 416 threads, 35.7 KB of shared memory from bricks (4 blocks an
//   SM) and 16.0 KB from rows; f64 p=4: 44 / 32 registers, 71.3 / 32.0 KB; f64 p=6: 48
//   registers, 416 threads, 61.5 / 43.9 KB (above 48 KB as dynamic shared memory).
//   What holds it back at p=4 f32: the sweeps, not the bytes. Per group a warp issues
//   ~250 instructions (175 FMAs, 50 shared-memory accesses): by estimate ~15 us for the
//   launch at 4 instructions a clock an SM, about the time of its bytes, and the 3
//   barriers a group keep the rate well below that; the brick's load and the sweeps of
//   one block do not overlap (a block has one brick).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

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

// K1 and M1 travel with the launch as its parameters, in the constant bank: with the
// loops unrolled, every factor entry is an operand of its FMA, with no load.
template <typename T, int N>
struct Factors {
  T K[N * N];
  T M[N * N];
};

// n values of one line, at stride S, into registers
template <typename T, int N, int S>
__device__ __forceinline__ void load_line(const T* __restrict__ p, T (&r)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = p[k * S];
}

// Stage `count` values into shared memory with 16-byte loads where both sides allow
// them; the vector tail may read past `count`, up to the next 16 bytes (the callers' rows
// are padded that far).
template <typename T>
__device__ __forceinline__ void stage(T* __restrict__ dst, const T* __restrict__ src,
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

template <typename T, int P, int B>
__global__ void __launch_bounds__(Cfg<P>::THREADS)
cell_apply_kernel(const T* __restrict__ src, const Factors<T, P + 1> f,
                  const T* __restrict__ scale, T* __restrict__ out, int rows, int N3p,
                  int vec_ok) {
  using S = Cfg<P>;
  constexpr int N = S::N, N2 = S::N2, NL = S::NL, G = S::G;
  constexpr int NB = B * P + 1;
  constexpr int C = B * B * B;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sb = sa + S::SCR;
  T* sbrick = sb + S::SCR;  // B > 0 only

  int row_base, n_groups;
  if constexpr (B > 0) {  // one brick, C rows
    const T* ub = src + static_cast<size_t>(blockIdx.x) * N3p;
    const bool vec = vec_ok && (reinterpret_cast<uintptr_t>(ub) % 16 == 0);
    stage(sbrick, ub, NB * NB * NB, vec);
    row_base = blockIdx.x * C;
    n_groups = C / G;
  } else {  // G contiguous rows
    row_base = blockIdx.x * G;
    n_groups = 1;
  }

  const int l = threadIdx.x;
  const bool active = l < G * N2;
  for (int grp = 0; grp < n_groups; ++grp) {
    const int row0 = row_base + grp * G;
    const int nrows = min(G, rows - row0);
    const T s = active && l / N2 < nrows ? scale[row0 + l / N2] : T(0);  // line l's cell
    if constexpr (B == 0) {
      const T* tile = src + static_cast<size_t>(row0) * NL;
      const bool vec = vec_ok && (reinterpret_cast<uintptr_t>(tile) % 16 == 0);
      stage(sa, tile, nrows * NL, vec && nrows == G);  // a full tile is whole 16-byte words
    }
    __syncthreads();

    // x sweep: line (g, z, y)
    if (active) {
      const int g = l / N2, z = (l / N) % N, y = l % N;
      T r[N];
      if constexpr (B > 0) {
        const int slot = grp * G + g;
        const int sx = slot % B, sy = (slot / B) % B, sz = slot / (B * B);
        load_line<T, N, 1>(sbrick + ((sz * P + z) * NB + sy * P + y) * NB + sx * P, r);
      } else {
        load_line<T, N, 1>(sa + l * N, r);
      }
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
    __syncthreads();

    // y sweep: line (g, z, x), stride N
    if (active) {
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
    __syncthreads();

    // z sweep: line (g, y, x), stride N^2; the scaled results go straight to out
    if (active && l / N2 < nrows) {
      const int g = l / N2, yx = l - g * N2;
      T c1[N], c2[N];
      load_line<T, N, N2>(sb + g * NL + yx, c1);
      load_line<T, N, N2>(sa + g * NL + yx, c2);
      T* dst = out + static_cast<size_t>(row0 + g) * NL + yx;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < N; ++j) acc += f.M[i * N + j] * c1[j] + f.K[i * N + j] * c2[j];
        dst[i * N2] = s * acc;
      }
    }
  }
}

template <typename T, int P, int B>
int launch(const void* src, const void* K1, const void* M1, const void* scale, void* out,
           int rows, int N3p, cudaStream_t stream) {
  using S = Cfg<P>;
  constexpr int NB = B * P + 1;
  constexpr int brick = B > 0 ? round4(NB * NB * NB) : 0;
  const int smem = static_cast<int>((2 * S::SCR + brick) * sizeof(T));
  Factors<T, P + 1> f;
  std::memcpy(f.K, K1, sizeof(f.K));
  std::memcpy(f.M, M1, sizeof(f.M));
  auto kernel = cell_apply_kernel<T, P, B>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte loads of the bricks need 16-byte rows
  const int vec_ok = B == 0 || (N3p * sizeof(T)) % 16 == 0;
  int blocks;
  if constexpr (B > 0) {
    blocks = rows / (B * B * B);
  } else {
    blocks = (rows + S::G - 1) / S::G;
  }
  if (blocks > 0) {
    kernel<<<blocks, S::THREADS, smem, stream>>>(static_cast<const T*>(src), f,
                                                 static_cast<const T*>(scale),
                                                 static_cast<T*>(out), rows, N3p, vec_ok);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P, int BB>
int modes(const void* src, const void* K1, const void* M1, const void* scale, void* out,
          int rows, int B, int N3p, cudaStream_t stream) {
  if (B == 0) return launch<T, P, 0>(src, K1, M1, scale, out, rows, N3p, stream);
  if (B == BB) return launch<T, P, BB>(src, K1, M1, scale, out, rows, N3p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// (p, B) as the brick size rule gives them: B = 4 at p = 4, B = 2 at p = 5..8
template <typename T>
int dispatch(const void* src, const void* K1, const void* M1, const void* scale, void* out,
             int rows, int p, int B, int N3p, cudaStream_t stream) {
  switch (p) {
    case 4: return modes<T, 4, 4>(src, K1, M1, scale, out, rows, B, N3p, stream);
    case 5: return modes<T, 5, 2>(src, K1, M1, scale, out, rows, B, N3p, stream);
    case 6: return modes<T, 6, 2>(src, K1, M1, scale, out, rows, B, N3p, stream);
    case 7: return modes<T, 7, 2>(src, K1, M1, scale, out, rows, B, N3p, stream);
    case 8: return modes<T, 8, 2>(src, K1, M1, scale, out, rows, B, N3p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int cell_apply_f32(const void* src, const void* K1, const void* M1, const void* scale,
                   void* out, int rows, int p, int B, int N3p, void* stream) {
  return dispatch<float>(src, K1, M1, scale, out, rows, p, B, N3p,
                         static_cast<cudaStream_t>(stream));
}

int cell_apply_f64(const void* src, const void* K1, const void* M1, const void* scale,
                   void* out, int rows, int p, int B, int N3p, void* stream) {
  return dispatch<double>(src, K1, M1, scale, out, rows, p, B, N3p,
                          static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
