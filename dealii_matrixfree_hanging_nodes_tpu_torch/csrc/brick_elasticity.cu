// brick_elasticity: linear elasticity's coupled brick operator times the brick's geometry factor,
// on component brick vectors u [3, nb, N3p] (node (z, y, x) of a brick at (z*NB + y)*NB + x,
// N3 = NB^3 nodes, padded to N3p, component-major):
//   v_c,b = geo_b sum_k A_ck u_k,b,
//   A_cc = mu sum_a K_a + (mu + lam) K_c          (K_a: Kb along axis a, Mb along the others)
//   A_ck = M_m (x) (mu G_k GT_c + lam G_c GT_k)    (k != c, m the third axis; G_a: Gb along a)
// with the brick-assembled 1-D factors Kb = D^T W D, Mb = S^T W S, Gb = D^T W S (cell blocks
// summed along the brick, elasticity_bricks.py:105-122) and Gb^T; and on the first m bricks, as
// an epilogue, the overlap-add of each component's cell rows: v_c,b[node] += the 1-8 entries
// dcols[c][b*B^3 + slot, j] of the (cell slot, local node) pairs on that node (dcols [3, m*B^3,
// n_loc], n_loc = (p+1)^3, NB = B*p + 1, slots and local nodes x fastest), as brick_apply.cu.
//
// Replaces: BrickElasticity._main_apply (dealii_matrixfree_hanging_nodes_tpu/models/
//   elasticity_bricks.py:184-213: per output component and input component the precombined
//   [NB^2, NB^2] plane operators el_P{c}{k}_{z} on the MXU, then the z factors el_z_*) times geo
//   (216-222), and, in the epilogue, _scatter_cols with _subset_scatter_add_multi
//   (elasticity_bricks.py:250-254; bricks.py:3350, 2196-2241). XLA dots on the TPU (no Pallas
//   kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (4400 bricks, NB=17, N3p=4992, 1025 bricks
//   with cell rows; brick_elasticity.bytes_and_flops): bytes. u's 3 N3 nodes are read once
//   (259.5 MB), v is written once with its padding (263.6 MB), the cell rows read once
//   (98.4 MB): 621.4 MB, 0.1855 ms at 3.35 TB/s. The least sum-factorized schedule applies a
//   factor (97 structural nonzeros a line at p=4) to every line 45 times a brick (along x each
//   input's 4 distinct factors, along y its 7 distinct (x, y) pairs, along z each output's 4
//   distinct factors with its terms grouped across inputs; brick_elasticity.least_schedule):
//   12.1 GFLOP, 0.181 ms at 67 TFLOP/s (f32 outside the tensor cores), under the bytes' time.
//   The sweeps below take 57 applications a brick (19 an output component: 7 for the diagonal
//   block, 6 for each other), 14.4 GFLOP.
//
// Design: brick_apply.cu's, one block per (brick, output component), blocks of a brick adjacent
//   (blockIdx = 3 b + c), so the three read the brick's components close in time and L2 serves
//   two of the three reads. For each input component k the block stages u_k's brick in shared
//   memory (cp.async) and runs three rounds of 1-D sweeps, one line per thread (NB^2 lines):
//     x round, line (z, y): a = X_a u, b = X_b u          (in place over u, and a second buffer)
//     y round, line (z, x): c1 = s_a Y_1a a + s_b Y_1b b, c2 = Y_2 b   (in place)
//     z round, line (y, x): acc += t_1 Z_1 c1 + t_2 Z_2 c2 (acc in registers across the k's)
//   with, for k == c: X = (K, M), c1 = alpha_x M a + alpha_y K b, c2 = M b, acc += M c1 +
//   alpha_z K c2 (alpha_a = mu, plus mu + lam on axis c); for k != c with F1 (mu's term: G on k,
//   GT on c, M on m) and F2 (lam's: G on c, GT on k): X = (F1_x, F2_x), c1 = F1_y a, c2 = F2_y b,
//   acc += mu F1_z c1 + lam F2_z c2. After the three k's: v = geo acc plus the cell rows'
//   entries (summed in brick_apply's fixed order, read from device memory), stored coalesced.
//   The (c, k) pairs are template parameters, so each pair's factor choice folds at compile
//   time: the structural nonzeros of Kb, Mb, Gb and Gb^T, packed row by row on the host, travel
//   with the launch as its parameters (the constant bank; 6.2 KB in f64 at p=8, past 4 KB:
//   CUDA 12.1 or later), every factor entry an operand of its FMA.
//   Resources (ptxas, sm_90a; chip_smoke.py phase 2 prints every instance's): 2 buffers of N3
//   values (39.3 KB in f32, 78.6 KB in f64 at NB=17), 320 threads; the launch bounds ask for 3
//   blocks an SM in f32 (64 registers at p=4, no spills) and 2 in f64 (96). Left to itself ptxas
//   took 116 and 168 registers, one block an SM: 1.375 ms at quadrant nref=7 p=4 f32 on an H100
//   against 0.730 ms now (chip_smoke.py), the same results bit for bit.
//   What holds it back: each of a brick's three blocks stages the brick's three components and
//   sweeps them (a block for all three outputs would share the x and y rounds of an input);
//   the cell rows are read from device memory, not staged.
//
// 2-D (brick_elasticity2_kernel; the reference's 2-D branch, models/elasticity_bricks.py:205-213,
// one dense [NB^2, NB^2] el_A{c}{k} a block on the MXU): two components on bricks of NB^2 nodes
// (node (y, x) at y*NB + x), B = 16 at p = 1..3, 8 at p = 4..6,
//   A_cc = (mu + [c == 0](mu + lam)) My (x) Kx + (mu + [c == 1](mu + lam)) Ky (x) Mx,
//   A_ck = mu F1y (x) F1x + lam F2y (x) F2x   (k != c; F1: G on k, GT on c; F2: G on c, GT on k),
// computed as brick_apply2_kernel computes the Laplace, not as the dense product: a block takes
// G bricks (about 256 lines, its shared memory at most 96 KB) and one output component c
// (blockIdx = 2 group + c), stages both input components of its bricks (cp.async), and runs
//   x round, line (g, y), for each input k: a_k = XA_k u_k, b_k = XB_k u_k (XA, XB the x factors
//     of block (c, k): K, M on the diagonal; F1x, F2x off it), the line in registers, a_k
//     written back over u_k, b_k into a second buffer;
//   y round, line (g, x): v_c = geo (sum over k of cA_k YA_k a_k + cB_k YB_k b_k) plus the cell
//     rows' 1-4 entries (y cells outer, then x), straight to device memory;
// 16 factor applications a brick and output pair, the least schedule's (least_schedule(2)). The
// rows and each row's band are written out at compile time (brick_band.cuh's each_row, band, as
// brick_apply.cu's 2-D rounds: left to #pragma unroll the NB = 33..49 band loops stay rolled),
// four sums a row in the y round, combined with the coefficients at the row's end.
// Bound at 2-D quadrant nref=11 p=4 f32 (16,646 bricks, NB=33, N3p=1152, 517 bricks with cell
//   rows; brick_elasticity.bytes_and_flops): bytes. u's 2 NB^2 nodes read once, v written with
//   its padding, the cell rows: 305.1 MB, 0.091 ms at 3.35 TB/s; the least schedule's 3.72 GFLOP,
//   0.056 ms at 67 TFLOP/s.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "brick_band.cuh"

namespace {

constexpr int FK = 0, FM = 1, FG = 2, FGT = 3, NONE = -1;

template <typename T, int NB, int P>
struct Cfg {
  static constexpr int B = (NB - 1) / P;
  static constexpr int N2 = NB * NB;
  static constexpr int N3 = N2 * NB;
  static constexpr int VW = 16 / sizeof(T);
  static constexpr int N3R = (N3 + VW - 1) / VW * VW;
  static constexpr int NL = (P + 1) * (P + 1) * (P + 1);
  static constexpr int DC = B * B * B * NL;  // a brick's cell rows of one component
  static constexpr int NNZ = row_offset<NB, P>(NB);
  static constexpr int THREADS = (N2 + 31) / 32 * 32;
  // blocks an SM the registers must allow (ptxas caps them): at NB=17, 3 in f32 (64 registers),
  // 2 in f64 (96); left to itself ptxas takes 116 and 168, one block an SM
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 3 : 2;
  static_assert(NNZ == 1 + B * P * (P + 2), "packed factor size");
};

// The structural nonzeros of Kb, Mb, Gb and Gb^T (FK, FM, FG, FGT), packed row by row.
template <typename T, int NNZ>
struct Factors {
  T F[4][NNZ];
};

// the factor of axis ax in the mu term (F1: G on k, GT on c) and the lam term (F2: G on c, GT on
// k) of an off-diagonal block (c, k), M on the third axis
__host__ __device__ constexpr int f1(int ax, int c, int k) {
  return ax == k ? FG : ax == c ? FGT : FM;
}
__host__ __device__ constexpr int f2(int ax, int c, int k) {
  return ax == c ? FG : ax == k ? FGT : FM;
}

// row i of factor F (packed) times the line r
template <typename T, int NB, int P, int F, int NNZ>
__device__ __forceinline__ T row_dot(const Factors<T, NNZ>& f, const T (&r)[NB], int i) {
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j >= lo<NB, P>(i) && j <= hi<NB, P>(i))
      acc += f.F[F][row_offset<NB, P>(i) + j - lo<NB, P>(i)] * r[j];
  }
  return acc;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ void stage(T* __restrict__ dst, const T* __restrict__ src, int count,
                                      bool vec) {
  if (vec) {
    constexpr int VW = 16 / sizeof(T);
    for (int i = threadIdx.x; i * VW < count; i += blockDim.x)
      cp_async16(dst + i * VW, src + i * VW);
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  }
}

// The 1-2 (cell, local node) pairs of coordinate c along one axis (brick_apply.cu's).
template <int NB, int P>
__device__ __forceinline__ int axis_terms(int c, int cell_stride, int loc_stride, int (&off)[2]) {
  const int q = c / P, r = c - q * P;
  if (c == NB - 1) {
    off[0] = (q - 1) * cell_stride + P * loc_stride;
    return 1;
  }
  if (r == 0 && c > 0) {
    off[0] = (q - 1) * cell_stride + P * loc_stride;
    off[1] = q * cell_stride;
    return 2;
  }
  off[0] = q * cell_stride + r * loc_stride;
  return 1;
}

// The rounds of block (C, K) on the staged u_K (s0), accumulating into acc (line (y, x) = l).
// Every thread calls it (it holds the barriers).
template <typename T, int NB, int P, int C, int K>
__device__ __forceinline__ void pair(const Factors<T, Cfg<T, NB, P>::NNZ>& f, T* s0, T* s1,
                                     T (&acc)[NB], T mu, T lam, bool active) {
  using S = Cfg<T, NB, P>;
  constexpr int N2 = S::N2, NNZ = S::NNZ;
  constexpr bool DIAG = C == K;
  constexpr int XA = DIAG ? FK : f1(0, C, K), XB = DIAG ? FM : f2(0, C, K);
  constexpr int Y1A = DIAG ? FM : f1(1, C, K), Y1B = DIAG ? FK : NONE;
  constexpr int Y2B = DIAG ? FM : f2(1, C, K);
  constexpr int Z1 = DIAG ? FM : f1(2, C, K), Z2 = DIAG ? FK : f2(2, C, K);
  // coefficients: the diagonal block's alpha_a = mu (+ mu + lam on axis C)
  const T al[3] = {C == 0 ? 2 * mu + lam : mu, C == 1 ? 2 * mu + lam : mu,
                   C == 2 ? 2 * mu + lam : mu};
  const T s1a = DIAG ? al[0] : T(1), s1b = DIAG ? al[1] : T(0);
  const T t1 = DIAG ? T(1) : mu, t2 = DIAG ? al[2] : lam;
  const int l = threadIdx.x;

  // x round: line l = (z, y), contiguous
  if (active) {
    T r[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) r[j] = s0[l * NB + j];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const T a = row_dot<T, NB, P, XA, NNZ>(f, r, i);
      const T b = row_dot<T, NB, P, XB, NNZ>(f, r, i);
      s0[l * NB + i] = a;
      s1[l * NB + i] = b;
    }
  }
  __syncthreads();
  // y round: line l = (z, x), stride NB
  if (active) {
    const int z = l / NB;
    const int o = z * N2 + (l - z * NB);
    T a[NB], b[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      a[j] = s0[o + j * NB];
      b[j] = s1[o + j * NB];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      T c1 = s1a * row_dot<T, NB, P, Y1A, NNZ>(f, a, i);
      if constexpr (Y1B != NONE) c1 += s1b * row_dot<T, NB, P, Y1B, NNZ>(f, b, i);
      const T c2 = row_dot<T, NB, P, Y2B, NNZ>(f, b, i);
      s0[o + i * NB] = c1;
      s1[o + i * NB] = c2;
    }
  }
  __syncthreads();
  // z round: line l = (y, x), stride N2, into the accumulators
  if (active) {
    T c1[NB], c2[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      c1[j] = s0[l + j * N2];
      c2[j] = s1[l + j * N2];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i)
      acc[i] += t1 * row_dot<T, NB, P, Z1, NNZ>(f, c1, i) + t2 * row_dot<T, NB, P, Z2, NNZ>(f, c2, i);
  }
  __syncthreads();  // s0, s1 free for the next input component
}

template <typename T, int NB, int P, int C>
__device__ __forceinline__ void component(const T* __restrict__ u, long long cstride,
                                          const Factors<T, Cfg<T, NB, P>::NNZ>& f, T* s0, T* s1,
                                          T (&acc)[NB], T mu, T lam, int b, int N3p, bool vec,
                                          bool active) {
  using S = Cfg<T, NB, P>;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    stage(s0, u + k * cstride + static_cast<size_t>(b) * N3p, S::N3, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (k == 0) pair<T, NB, P, C, 0>(f, s0, s1, acc, mu, lam, active);
    if (k == 1) pair<T, NB, P, C, 1>(f, s0, s1, acc, mu, lam, active);
    if (k == 2) pair<T, NB, P, C, 2>(f, s0, s1, acc, mu, lam, active);
  }
}

template <typename T, int NB, int P>
__global__ void __launch_bounds__(Cfg<T, NB, P>::THREADS, Cfg<T, NB, P>::MIN_BLOCKS)
brick_elasticity_kernel(const T* __restrict__ u, const Factors<T, Cfg<T, NB, P>::NNZ> f,
                        const T* __restrict__ geo, const T* __restrict__ dcols,
                        T* __restrict__ v, T mu, T lam, int nb, int m, int N3p, int vec_u) {
  using S = Cfg<T, NB, P>;
  constexpr int N2 = S::N2, N3 = S::N3, N = P + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const s0 = reinterpret_cast<T*>(smem_raw);  // u_k, then a, then c1
  T* const s1 = s0 + S::N3R;                     // b, then c2

  const int b = blockIdx.x / 3, c = blockIdx.x - 3 * b;
  const long long cstride = static_cast<long long>(nb) * N3p;
  T* const vb = v + c * cstride + static_cast<size_t>(b) * N3p;
  for (int i = N3 + threadIdx.x; i < N3p; i += blockDim.x) vb[i] = T(0);
  const int l = threadIdx.x;
  const bool active = l < N2;
  T acc[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) acc[i] = T(0);
  if (c == 0) component<T, NB, P, 0>(u, cstride, f, s0, s1, acc, mu, lam, b, N3p, vec_u, active);
  if (c == 1) component<T, NB, P, 1>(u, cstride, f, s0, s1, acc, mu, lam, b, N3p, vec_u, active);
  if (c == 2) component<T, NB, P, 2>(u, cstride, f, s0, s1, acc, mu, lam, b, N3p, vec_u, active);
  if (!active) return;

  // v = geo acc, plus the cell rows' entries on the first m bricks
  const bool rows = b < m;
  const T* const dr = dcols + (static_cast<size_t>(c) * m + b) * S::DC;
  int oy[2] = {0, 0}, ox[2] = {0, 0};
  const int ny = axis_terms<NB, P>(l / NB, S::B * S::NL, N, oy);
  const int nx = axis_terms<NB, P>(l % NB, S::NL, 1, ox);
  const T g = geo[b];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    T out = g * acc[i];
    if (rows) {
      int oz[2] = {0, 0};
      const int nz = axis_terms<NB, P>(i, S::B * S::B * S::NL, N * N, oz);
      T corr = T(0);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
            if (a < nz && bb < ny && cc < nx) corr += dr[oz[a] + oy[bb] + ox[cc]];
      out += corr;
    }
    vb[l + i * N2] = out;
  }
}

template <typename T, int NB, int P>
int launch(const void* u, const void* packed, const void* geo, const void* dcols, void* v,
           double mu, double lam, int nb, int m, int N3p, int* info, cudaStream_t stream) {
  using S = Cfg<T, NB, P>;
  const int smem = static_cast<int>(2 * S::N3R * sizeof(T));
  auto kernel = brick_elasticity_kernel<T, NB, P>;
  static unsigned long long done = 0;  // bit d: the shared-memory limit raised on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(done & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    done |= bit;
  }
  if (info) {  // a dry run: threads, shared memory and blocks per SM, launch nothing
    info[0] = S::THREADS;
    info[1] = smem;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, S::THREADS, smem));
  }
  Factors<T, S::NNZ> f;
  std::memcpy(f.F, packed, sizeof(f.F));
  const int vec_u = reinterpret_cast<uintptr_t>(u) % 16 == 0 && (N3p * sizeof(T)) % 16 == 0;
  if (nb > 0) {
    kernel<<<3 * nb, S::THREADS, smem, stream>>>(
        static_cast<const T*>(u), f, static_cast<const T*>(geo), static_cast<const T*>(dcols),
        static_cast<T*>(v), static_cast<T>(mu), static_cast<T>(lam), nb, m, N3p, vec_u);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- 2-D --------------------------------------------------------------------------------------
template <typename T, int NB, int P>
struct Cfg2 {
  static constexpr int B = (NB - 1) / P;
  static constexpr int N2 = NB * NB;
  static constexpr int N2R = (N2 + 3) / 4 * 4;  // a brick buffer, 16-byte aligned
  static constexpr int NL = (P + 1) * (P + 1);
  static constexpr int DC = B * B * NL;  // a brick's cell rows of one component
  static constexpr int NNZ = row_offset<NB, P>(NB);
  static constexpr int BYTES = 4 * N2R * static_cast<int>(sizeof(T));  // u_k, b_k (k = 0, 1)
  static constexpr int G0 = 256 / NB;
  static constexpr int G_SMEM = 96 * 1024 / BYTES > 0 ? 96 * 1024 / BYTES : 1;
  static constexpr int G = G0 * BYTES <= 96 * 1024 ? G0 : G_SMEM;  // bricks a block
  static constexpr int THREADS = (G * NB + 31) / 32 * 32;
  static_assert(NNZ == 1 + B * P * (P + 2), "packed factor size");
};

// The x factors (XA, XB) and y factors (YA, YB) of block (C, K) in 2-D
template <int C, int K>
struct Pair2 {
  static constexpr bool DIAG = C == K;
  static constexpr int XA = DIAG ? FK : f1(0, C, K), XB = DIAG ? FM : f2(0, C, K);
  static constexpr int YA = DIAG ? FM : f1(1, C, K), YB = DIAG ? FK : f2(1, C, K);
};

// x round of input K for output C: line (g, y) of the staged u_K (su) -> a over it, b into sb
template <typename T, int NB, int P, int C, int K>
__device__ __forceinline__ void x_round2(const Factors<T, Cfg2<T, NB, P>::NNZ>& f, T* su, T* sb) {
  using Pr = Pair2<C, K>;
  T r[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) r[j] = su[j];
  each_row<NB>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    T a = T(0), b = T(0);
    band<NB, P, i>([&](auto e, auto j) {
      a += f.F[Pr::XA][decltype(e)::value] * r[decltype(j)::value];
      b += f.F[Pr::XB][decltype(e)::value] * r[decltype(j)::value];
    });
    su[i] = a;
    sb[i] = b;
  });
}

// The two rounds of output C on the G bricks staged in s0 (u_0, u_1 by brick) and s1 (b_0, b_1),
// line (g, c) of thread l; the y round stores v_C straight to device memory.
template <typename T, int NB, int P, int C>
__device__ __forceinline__ void output2(const Factors<T, Cfg2<T, NB, P>::NNZ>& f, T* s0, T* s1,
                                        const T* __restrict__ geo, const T* __restrict__ dcols,
                                        T* __restrict__ vc, T mu, T lam, int b0, int nbk, int m,
                                        int N3p) {
  using S = Cfg2<T, NB, P>;
  using P0 = Pair2<C, 0>;
  using P1 = Pair2<C, 1>;
  constexpr int N = P + 1;
  const int l = threadIdx.x, g = l / NB, c = l - g * NB;
  const bool active = g < nbk;
  T* const u0 = s0 + (2 * g) * S::N2R;  // u_0 then a_0
  T* const u1 = u0 + S::N2R;            // u_1 then a_1
  T* const w0 = s1 + (2 * g) * S::N2R;  // b_0
  T* const w1 = w0 + S::N2R;            // b_1
  if (active) {
    x_round2<T, NB, P, C, 0>(f, u0 + c * NB, w0 + c * NB);
    x_round2<T, NB, P, C, 1>(f, u1 + c * NB, w1 + c * NB);
  }
  __syncthreads();
  if (!active) return;
  // the coefficients of the four sums: a diagonal block's alpha (mu, plus mu + lam on axis C)
  const T al_x = C == 0 ? 2 * mu + lam : mu, al_y = C == 1 ? 2 * mu + lam : mu;
  const T cA0 = P0::DIAG ? al_x : mu, cB0 = P0::DIAG ? al_y : lam;
  const T cA1 = P1::DIAG ? al_x : mu, cB1 = P1::DIAG ? al_y : lam;
  const int brick = b0 + g;
  const T gb = geo[brick];
  const bool rows = brick < m;
  int ox[2] = {0, 0};
  const int nx = axis_terms<NB, P>(c, S::NL, 1, ox);
  const T* const db = dcols + (static_cast<size_t>(C) * m + brick) * S::DC;
  T* const vb = vc + static_cast<size_t>(brick) * N3p + c;
  each_row<NB>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    T sA0 = T(0), sB0 = T(0), sA1 = T(0), sB1 = T(0);
    band<NB, P, i>([&](auto e, auto j) {
      constexpr int o = decltype(j)::value * NB;
      sA0 += f.F[P0::YA][decltype(e)::value] * u0[o + c];
      sB0 += f.F[P0::YB][decltype(e)::value] * w0[o + c];
      sA1 += f.F[P1::YA][decltype(e)::value] * u1[o + c];
      sB1 += f.F[P1::YB][decltype(e)::value] * w1[o + c];
    });
    T out = gb * (cA0 * sA0 + cB0 * sB0 + cA1 * sA1 + cB1 * sB1);
    if (rows) {
      int oy[2] = {0, 0};
      const int ny = axis_terms<NB, P>(i, S::B * S::NL, N, oy);
      T corr = T(0);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (a < ny && q < nx) corr += __ldg(db + oy[a] + ox[q]);
      out += corr;
    }
    vb[i * NB] = out;
  });
}

template <typename T, int NB, int P>
__global__ void __launch_bounds__(Cfg2<T, NB, P>::THREADS)
brick_elasticity2_kernel(const T* __restrict__ u, const Factors<T, Cfg2<T, NB, P>::NNZ> f,
                         const T* __restrict__ geo, const T* __restrict__ dcols,
                         T* __restrict__ v, T mu, T lam, int nb, int m, int N3p, int vec_u) {
  using S = Cfg2<T, NB, P>;
  constexpr int N2 = S::N2, G = S::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const s0 = reinterpret_cast<T*>(smem_raw);  // [G][2][N2R] u_0, u_1 of each brick
  T* const s1 = s0 + 2 * G * S::N2R;             // [G][2][N2R] b_0, b_1

  const int grp = blockIdx.x / 2, c = blockIdx.x - 2 * grp;
  const int b0 = grp * G;
  const int nbk = min(G, nb - b0);
  const long long cstride = static_cast<long long>(nb) * N3p;
  for (int g = 0; g < nbk; ++g)
    for (int k = 0; k < 2; ++k)
      stage(s0 + (2 * g + k) * S::N2R, u + k * cstride + static_cast<size_t>(b0 + g) * N3p, N2,
            vec_u);
  cp_async_commit();
  T* const vc = v + c * cstride;
  for (int g = 0; g < nbk; ++g) {  // the padding
    T* const vp = vc + static_cast<size_t>(b0 + g) * N3p;
    for (int i = N2 + threadIdx.x; i < N3p; i += S::THREADS) vp[i] = T(0);
  }
  cp_async_wait_all();
  __syncthreads();
  if (c == 0) output2<T, NB, P, 0>(f, s0, s1, geo, dcols, vc, mu, lam, b0, nbk, m, N3p);
  if (c == 1) output2<T, NB, P, 1>(f, s0, s1, geo, dcols, vc, mu, lam, b0, nbk, m, N3p);
}

template <typename T, int NB, int P>
int launch2(const void* u, const void* packed, const void* geo, const void* dcols, void* v,
            double mu, double lam, int nb, int m, int N3p, int* info, cudaStream_t stream) {
  using S = Cfg2<T, NB, P>;
  const int smem = S::G * S::BYTES;
  auto kernel = brick_elasticity2_kernel<T, NB, P>;
  static unsigned long long done = 0;  // bit d: the shared-memory limit raised on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(done & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    done |= bit;
  }
  if (info) {  // a dry run: threads, shared memory and blocks per SM, launch nothing
    info[0] = S::THREADS;
    info[1] = smem;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, S::THREADS, smem));
  }
  Factors<T, S::NNZ> f;
  std::memcpy(f.F, packed, sizeof(f.F));
  // 16-byte copies need 16-byte rows; a brick's whole words stay inside its row
  const int vec_u = reinterpret_cast<uintptr_t>(u) % 16 == 0 && (N3p * sizeof(T)) % 16 == 0 &&
                    S::N2R <= N3p;
  const int groups = (nb + S::G - 1) / S::G;
  if (groups > 0) {
    kernel<<<2 * groups, S::THREADS, smem, stream>>>(
        static_cast<const T*>(u), f, static_cast<const T*>(geo), static_cast<const T*>(dcols),
        static_cast<T*>(v), static_cast<T>(mu), static_cast<T>(lam), nb, m, N3p, vec_u);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* u, const void* packed, const void* geo, const void* dcols, void* v,
             double mu, double lam, int nb, int m, int NB, int p, int N3p, int* info, int dim,
             cudaStream_t stream) {
  // 2-D: B = 16 at p = 1..3, 8 at p = 4..6
#define EL_CASE2(nb_, p_) \
  if (dim == 2 && NB == nb_ && p == p_) \
    return launch2<T, nb_, p_>(u, packed, geo, dcols, v, mu, lam, nb, m, N3p, info, stream);
  EL_CASE2(17, 1)
  EL_CASE2(33, 2)
  EL_CASE2(49, 3)
  EL_CASE2(33, 4)
  EL_CASE2(41, 5)
  EL_CASE2(49, 6)
#undef EL_CASE2
  if (dim != 3) return static_cast<int>(cudaErrorInvalidValue);
#define EL_CASE(nb_, p_) \
  if (NB == nb_ && p == p_) \
    return launch<T, nb_, p_>(u, packed, geo, dcols, v, mu, lam, nb, m, N3p, info, stream);
  EL_CASE(17, 1)
  EL_CASE(17, 2)
  EL_CASE(13, 3)
  EL_CASE(17, 4)
  EL_CASE(11, 5)
  EL_CASE(13, 6)
  EL_CASE(15, 7)
  EL_CASE(17, 8)
#undef EL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// packed: host pointer to [4][NNZ] (Kb, Mb, Gb, Gb^T packed row by row), copied into the launch's
// parameters. info: null to launch; else [threads, shared-memory bytes, blocks per SM], not
// launched. dim: 3 (u, v [3][nb][N3p], dcols [3][m*B^3][(p+1)^3]) or 2 ([2][nb][N3p],
// [2][m*B^2][(p+1)^2]).
int brick_elasticity_f32(const void* u, const void* packed, const void* geo, const void* dcols,
                         void* v, double mu, double lam, int nb, int m, int NB, int p, int N3p,
                         int* info, int dim, void* stream) {
  return dispatch<float>(u, packed, geo, dcols, v, mu, lam, nb, m, NB, p, N3p, info, dim,
                         static_cast<cudaStream_t>(stream));
}

int brick_elasticity_f64(const void* u, const void* packed, const void* geo, const void* dcols,
                         void* v, double mu, double lam, int nb, int m, int NB, int p, int N3p,
                         int* info, int dim, void* stream) {
  return dispatch<double>(u, packed, geo, dcols, v, mu, lam, nb, m, NB, p, N3p, info, dim,
                          static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
