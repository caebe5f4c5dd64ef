// cell_apply: out[r] = scale[r] * (K x_r) for every cell row r of the subset bricks, with n = p+1,
// n_loc = n^3 local nodes per row (x fastest) and K the Kronecker sum of the 1-D factors
//   K = Mz (x) My (x) K1x + Mz (x) K1y (x) Mx + K1z (x) My (x) Mx   (M = M1 on each axis).
// x_r are the nodes of cell r read from its brick: cell r is slot r % B^3 (x fastest) of brick
// r / B^3 of src [m, N3p], its node (ix, iy, iz) sits at brick node
// ((sz*p + iz)*NB + sy*p + iy)*NB + sx*p + ix, NB = B*p + 1. (The constrained rows' product,
// once this kernel's row mode, runs inside hn_cell.cu.)
// With a right-hand-side axis (BrickLaplaceMM.vmult_multi: src [k, m, N3p], its RHS src_stride
// values apart, e.g. the subset view bvk[:, :n_sub] of the k-major brick vectors; out
// [k, m*B^3, n_loc] contiguous) grid.y is the RHS, whose blocks offset src and out by it: each RHS
// is bit-identical to a launch on it alone.
// The deformed mode (cell_apply_deformed_kernel, a deformed mapping) replaces K by each row's own
// stiffness at its Gauss points: the sweeps of S and Dc and the packed metric geo[r] [n_loc][6]
// (w detJ J^-1 J^-T, zero at absent slots, so their rows are exact zeros), laplace_quad.cuh's
// quadrature, with no scale: out[r] = K_r x_r.
//
// Replaces: BrickLaplaceMM._extract_cols (dealii_matrixfree_hanging_nodes_tpu/bricks.py:
//   2178-2194) fused with the local stiffness apply `cols @ K.T * geo_cell_sub`
//   (bricks.py:2449-2453). The TPU side ran these as XLA conv-patch extraction and a dense MXU
//   matmul with the 125 x 125 K (no Pallas kernel). With a RHS axis: _extract_cols and
//   `cols_u @ K.T * geo` on the k-major layout of _vmult_multi_impl (bricks.py:3470-3477).
//   The deformed mode: `_deformed_cell_apply(cols_u, Gq_sub)` (bricks.py:2444-2447, 2959-2976),
//   XLA einsums on the TPU.
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32: memory. Sum factorization needs 7 sweeps
//   of 2 n^4 operations plus the scale, 8,875 a row against the dense product's 31,250. 1,025
//   bricks -> 65,600 rows: 53.6 MB read once and written once, 16 us at 3.35 TB/s, against
//   0.58 GFLOP (8.7 us at 67 TFLOP/s f32 outside the tensor cores). The tensor cores are not
//   the tool: TF32 keeps about three digits, which fails the 1e-5 bar of the f32 path, and
//   after the cut the bytes bound anyway.
//
// Design: the 7 sweeps of the 1-D factors, in shared memory (sum_factorization.cuh).
//   One block per brick: the brick (NB^3 values, 19.7 KB in f32 at p=4) is staged into shared
//   memory once with coalesced 16-byte loads, then its B^3 cells go through the sweeps in
//   groups of G (16 at p=4, 8 = B^3 at p >= 5), one line per thread; the x sweep reads its
//   line from the staged brick and the z sweep stores to out directly (a warp's lanes write
//   the n^2 contiguous values of one output plane of a cell, or of two), so a group costs 3
//   barriers. p and B are template parameters, so every loop unrolls and the index arithmetic
//   is shifts and multiplies. Absent cells are computed like any other (corr_compact
//   overwrites them). The shared-memory limit is raised once per device, not on every launch.
//   2-D (cell_apply2_kernel; p = 4..6 at B = 8, 64 cells a brick): one block per brick, all 64
//   cells at once (64 n lines a sweep: 320, 384, 448 threads), the brick (NB^2 values) staged,
//   the x sweep into two scratch buffers, the y sweep (sweep_y2) straight to out: 2 barriers.
//   Bound at 2-D quadrant nref=11, p=4, f32 (517 subset bricks, 33,088 rows): memory, 5.8 MB,
//   0.0017 ms; the launch is a few microseconds of fixed cost.
//   Resources (ptxas, sm_90a, CUDA 12.8; no spills, no stack in any instantiation):
//   f32 p=4: 32 registers, 416 threads, 35.7 KB of shared memory (4 blocks an SM); f64 p=4:
//   44 registers, 71.3 KB; f64 p=6: 48 registers, 416 threads, 61.5 KB (above 48 KB as
//   dynamic shared memory).
//   What holds it back at p=4 f32: the sweeps, not the bytes. Per group a warp issues
//   ~250 instructions (175 FMAs, 50 shared-memory accesses): by estimate ~15 us for the
//   launch at 4 instructions a clock an SM, about the time of its bytes, and the 3
//   barriers a group keep the rate well below that; the brick's load and the sweeps of
//   one block do not overlap (a block has one brick).
//   The deformed mode: one block per brick as above, its cells G at a time (hn_interp's Cfg: 32,
//   16, 16, 16, 8, 8 at p = 1..6) gathered from the staged brick into shared memory, then
//   laplace_quad.cuh's 12 sweeps with the rows' metric read at the points, the rows stored. Bound
//   at quadrant nref=7, p=4, f32: memory, the subset bricks (20.1 MB), the rows' metric (196.8
//   MB) and the rows (32.8 MB), 250 MB, 0.075 ms at 3.35 TB/s.
//   The deformed mode in 2-D (cell_apply_deformed2_kernel; B = 16 at p = 1..3, 8 at p = 4..6):
//   the same, a brick of NB^2 nodes staged, its B^2 cells in groups of laplace_quad.cuh's
//   Cells2 (128, 64, 64, 32, 32, 32), one line of a cell a thread, the 2-D quadrature
//   (laplace_cells2 with the metric's 3 values a point). Bound at 2-D quadrant nref=11, p=4,
//   f32 (517 subset bricks, 33,088 rows): the bricks (2.4 MB), the rows' metric (9.9 MB) and
//   the rows (3.3 MB), 15.6 MB, 0.0047 ms.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "laplace_quad.cuh"
#include "sum_factorization.cuh"

namespace {

using sf::Cfg;
using sf::Factors;

template <typename T, int P, int B>
__global__ void __launch_bounds__(Cfg<P>::THREADS)
cell_apply_kernel(const T* __restrict__ src, const Factors<T, P + 1> f,
                  const T* __restrict__ scale, T* __restrict__ out, int rows, int N3p,
                  long long src_stride, int vec_ok) {
  using S = Cfg<P>;
  constexpr int N = S::N, N2 = S::N2, NL = S::NL, G = S::G;
  constexpr int NB = B * P + 1;
  constexpr int C = B * B * B;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sb = sa + S::SCR;
  T* sbrick = sb + S::SCR;

  // one brick of one RHS, C rows
  const size_t rhs = blockIdx.y;
  out += rhs * rows * NL;
  const T* ub = src + rhs * src_stride + static_cast<size_t>(blockIdx.x) * N3p;
  sf::copy_block(sbrick, ub, NB * NB * NB,
                 vec_ok && (reinterpret_cast<uintptr_t>(ub) % 16 == 0));
  const int row_base = blockIdx.x * C;

  const int l = threadIdx.x;
  const bool active = l < G * N2;
  for (int grp = 0; grp < C / G; ++grp) {
    const int row0 = row_base + grp * G;
    const int nrows = min(G, rows - row0);
    const T s = active && l / N2 < nrows ? scale[row0 + l / N2] : T(0);  // line l's cell
    __syncthreads();

    // x sweep: line (g, z, y), read from the staged brick
    if (active) {
      const int g = l / N2, z = (l / N) % N, y = l % N;
      const int slot = grp * G + g;
      const int sx = slot % B, sy = (slot / B) % B, sz = slot / (B * B);
      T r[N];
      sf::load_line<T, N, 1>(sbrick + ((sz * P + z) * NB + sy * P + y) * NB + sx * P, r);
      sf::sweep_x(f, r, sa, sb, l);
    }
    __syncthreads();
    if (active) sf::sweep_y(f, sa, sb, l);
    __syncthreads();
    // z sweep: the scaled results go straight to out
    if (active && l / N2 < nrows) {
      const int g = l / N2;
      sf::sweep_z(f, sa, sb, l, s, out + static_cast<size_t>(row0 + g) * NL + (l - g * N2));
    }
  }
}

template <typename T, int P, int B>
int launch(const void* src, const void* K1, const void* M1, const void* scale, void* out,
           int rows, int N3p, int k, long long src_stride, cudaStream_t stream) {
  using S = Cfg<P>;
  constexpr int NB = B * P + 1;
  const int smem = static_cast<int>((2 * S::SCR + sf::round4(NB * NB * NB)) * sizeof(T));
  auto kernel = cell_apply_kernel<T, P, B>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  Factors<T, P + 1> f;
  std::memcpy(f.K, K1, sizeof(f.K));
  std::memcpy(f.M, M1, sizeof(f.M));
  // 16-byte loads of the bricks need 16-byte rows
  const int vec_ok = (N3p * sizeof(T)) % 16 == 0;
  const int blocks = rows / (B * B * B);
  if (blocks > 0 && k > 0) {
    kernel<<<dim3(blocks, k), S::THREADS, smem, stream>>>(static_cast<const T*>(src), f,
                                                          static_cast<const T*>(scale),
                                                          static_cast<T*>(out), rows, N3p,
                                                          src_stride, vec_ok);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- 2-D: a brick of NB^2 nodes holds C = B^2 cells of n^2 values, K = My (x) K1x + K1y (x) Mx.
// One block per brick, all its cells in one group: the brick staged in shared memory, the x
// sweep (line (g, y) read from the staged brick) into two scratch buffers, the y sweep (line
// (g, x)) straight to out.
template <int P, int B>
struct Cfg2 {
  static constexpr int N = P + 1;
  static constexpr int NL = N * N;
  static constexpr int C = B * B;                  // cells a brick, all in one group
  static constexpr int NB = B * P + 1;
  static constexpr int THREADS = (C * N + 31) / 32 * 32;  // one line a thread
  static constexpr int SCR = sf::round4(C * NL);
};

template <typename T, int P, int B>
__global__ void __launch_bounds__(Cfg2<P, B>::THREADS)
cell_apply2_kernel(const T* __restrict__ src, const Factors<T, P + 1> f,
                   const T* __restrict__ scale, T* __restrict__ out, int rows, int N3p,
                   long long src_stride, int vec_ok) {
  using S = Cfg2<P, B>;
  constexpr int N = S::N, NL = S::NL, C = S::C, NB = S::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sb = sa + S::SCR;
  T* sbrick = sb + S::SCR;

  const size_t rhs = blockIdx.y;
  out += rhs * rows * NL;
  const T* ub = src + rhs * src_stride + static_cast<size_t>(blockIdx.x) * N3p;
  sf::copy_block(sbrick, ub, NB * NB, vec_ok && (reinterpret_cast<uintptr_t>(ub) % 16 == 0));
  const int row0 = blockIdx.x * C;
  const int l = threadIdx.x, g = l / N;
  const bool active = l < C * N;
  const T s = active ? scale[row0 + g] : T(0);
  __syncthreads();
  // x sweep: line (g, y) of cell slot g, read from the staged brick
  if (active) {
    const int y = l - g * N, sx = g % B, sy = g / B;
    T r[N];
    sf::load_line<T, N, 1>(sbrick + (sy * P + y) * NB + sx * P, r);
    sf::sweep_x(f, r, sa, sb, l);
  }
  __syncthreads();
  // y sweep: line (g, x), the scaled results straight to out
  if (active) sf::sweep_y2(f, sa, sb, l, s, out + static_cast<size_t>(row0 + g) * NL + (l - g * N));
}

template <typename T, int P, int B>
int launch2(const void* src, const void* K1, const void* M1, const void* scale, void* out,
            int rows, int N3p, int k, long long src_stride, cudaStream_t stream) {
  using S = Cfg2<P, B>;
  const int smem = static_cast<int>((2 * S::SCR + sf::round4(S::NB * S::NB)) * sizeof(T));
  auto kernel = cell_apply2_kernel<T, P, B>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  Factors<T, P + 1> f;
  std::memcpy(f.K, K1, sizeof(f.K));
  std::memcpy(f.M, M1, sizeof(f.M));
  const int vec_ok = (N3p * sizeof(T)) % 16 == 0;
  const int blocks = rows / S::C;
  if (blocks > 0 && k > 0) {
    kernel<<<dim3(blocks, k), S::THREADS, smem, stream>>>(static_cast<const T*>(src), f,
                                                          static_cast<const T*>(scale),
                                                          static_cast<T*>(out), rows, N3p,
                                                          src_stride, vec_ok);
  }
  return static_cast<int>(cudaGetLastError());
}

// The deformed mode: every cell row of the bricks through the quadrature with its own metric
template <typename T, int P, int B>
__global__ void __launch_bounds__(hn::Cfg<P>::THREADS)
cell_apply_deformed_kernel(const T* __restrict__ src, const T* __restrict__ geo,
                           const T* __restrict__ S, const T* __restrict__ Dc, T* __restrict__ out,
                           int N3p, int vec_ok) {
  using H = hn::Cfg<P>;
  constexpr int N = H::N, N2 = H::N2, NL = H::NL, G = H::G;
  constexpr int NB = B * P + 1;
  constexpr int C = B * B * B;
  static_assert(C % G == 0, "a brick is whole groups of cells");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sbrick = reinterpret_cast<T*>(smem_raw);  // [NB^3, whole 16-byte words] the brick
  T* V = sbrick + (NB * NB * NB + 3) / 4 * 4;    // [G NL] the group's rows
  T* G0 = V + G * NL;                            // [3][G NL] their gradients
  T* G1 = G0 + G * NL;
  T* G2 = G1 + G * NL;
  T* sS = G2 + G * NL;  // [N N]
  T* sD = sS + N * N;   // [N N]

  const T* ub = src + static_cast<size_t>(blockIdx.x) * N3p;
  sf::copy_block(sbrick, ub, NB * NB * NB,
                 vec_ok && (reinterpret_cast<uintptr_t>(ub) % 16 == 0));
  lq::stage_factors<T, N>(sS, sD, S, Dc);
  const size_t row_base = static_cast<size_t>(blockIdx.x) * C;
  const int l = threadIdx.x, g = l / N2, j = l - g * N2;
  const bool active = l < G * N2;
  for (int s0 = 0; s0 < C; s0 += G) {
    __syncthreads();  // the brick staged; the previous group's rows stored
    for (int t = threadIdx.x; t < G * NL; t += H::THREADS) {
      const int k = t / NL, jj = t - k * NL, s = s0 + k;
      const int sx = s % B, sy = (s / B) % B, sz = s / (B * B);
      const int ix = jj % N, iy = (jj / N) % N, iz = jj / N2;
      V[t] = sbrick[((sz * P + iz) * NB + sy * P + iy) * NB + sx * P + ix];
    }
    __syncthreads();
    const T* mg = geo + (row_base + s0 + g) * NL * 6;
    lq::laplace_cells<T, N>(V + g * NL, G0 + g * NL, G1 + g * NL, G2 + g * NL, sS, sD, j, active,
                            [=](T* x, T* y, T* z) { lq::metric_line<T, N>(mg, x, y, z, j); });
    T* dst = out + (row_base + s0) * NL;  // the group's rows are contiguous
    for (int t = threadIdx.x; t < G * NL; t += H::THREADS) dst[t] = V[t];
  }
}

template <typename T, int P, int B>
int launch_deformed(const void* src, const void* geo, const void* S, const void* Dc, void* out,
                    int rows, int N3p, cudaStream_t stream) {
  using H = hn::Cfg<P>;
  constexpr int NB = B * P + 1;
  const int smem = static_cast<int>(
      (4 * H::G * H::NL + 2 * H::N * H::N + sf::round4(NB * NB * NB)) * sizeof(T));
  auto kernel = cell_apply_deformed_kernel<T, P, B>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte loads of the bricks need 16-byte rows
  const int vec_ok = (N3p * sizeof(T)) % 16 == 0;
  const int blocks = rows / (B * B * B);
  if (blocks > 0) {
    kernel<<<blocks, H::THREADS, smem, stream>>>(
        static_cast<const T*>(src), static_cast<const T*>(geo), static_cast<const T*>(S),
        static_cast<const T*>(Dc), static_cast<T*>(out), N3p, vec_ok);
  }
  return static_cast<int>(cudaGetLastError());
}

// The deformed mode in 2-D: every cell row of the NB^2-node bricks through the 2-D quadrature
template <typename T, int P, int B>
__global__ void __launch_bounds__(lq::Cells2<P>::THREADS)
cell_apply_deformed2_kernel(const T* __restrict__ src, const T* __restrict__ geo,
                            const T* __restrict__ S, const T* __restrict__ Dc,
                            T* __restrict__ out, int N3p, int vec_ok) {
  using H = lq::Cells2<P>;
  constexpr int N = H::N, NL = H::NL, G = H::G;
  constexpr int NB = B * P + 1;
  constexpr int C = B * B;
  static_assert(C % G == 0, "a brick is whole groups of cells");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sbrick = reinterpret_cast<T*>(smem_raw);  // [NB^2, whole 16-byte words] the brick
  T* V = sbrick + (NB * NB + 3) / 4 * 4;       // [G NL] the group's rows
  T* G0 = V + G * NL;                          // [2][G NL] their gradients
  T* G1 = G0 + G * NL;
  T* sS = G1 + G * NL;  // [N N]
  T* sD = sS + N * N;   // [N N]

  const T* ub = src + static_cast<size_t>(blockIdx.x) * N3p;
  sf::copy_block(sbrick, ub, NB * NB, vec_ok && (reinterpret_cast<uintptr_t>(ub) % 16 == 0));
  lq::stage_factors<T, N>(sS, sD, S, Dc);
  const size_t row_base = static_cast<size_t>(blockIdx.x) * C;
  const int l = threadIdx.x, g = l / N, j = l - g * N;
  const bool active = l < G * N;
  for (int s0 = 0; s0 < C; s0 += G) {
    __syncthreads();  // the brick staged; the previous group's rows stored
    for (int t = threadIdx.x; t < G * NL; t += H::THREADS) {
      const int k = t / NL, jj = t - k * NL, s = s0 + k;
      V[t] = sbrick[((s / B) * P + jj / N) * NB + (s % B) * P + jj % N];
    }
    __syncthreads();
    const T* mg = geo + (row_base + s0 + (active ? g : 0)) * NL * 3;
    lq::laplace_cells2<T, N>(V + g * NL, G0 + g * NL, G1 + g * NL, sS, sD, j, active,
                             [=](T* x, T* y) { lq::metric_line2<T, N>(mg, x, y, j); });
    T* dst = out + (row_base + s0) * NL;  // the group's rows are contiguous
    for (int t = threadIdx.x; t < G * NL; t += H::THREADS) dst[t] = V[t];
  }
}

template <typename T, int P, int B>
int launch_deformed2(const void* src, const void* geo, const void* S, const void* Dc, void* out,
                     int rows, int N3p, cudaStream_t stream) {
  using H = lq::Cells2<P>;
  constexpr int NB = B * P + 1;
  const int smem = static_cast<int>(
      (3 * H::G * H::NL + 2 * H::N * H::N + sf::round4(NB * NB)) * sizeof(T));
  auto kernel = cell_apply_deformed2_kernel<T, P, B>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_ok = (N3p * sizeof(T)) % 16 == 0;
  const int blocks = rows / (B * B);
  if (blocks > 0) {
    kernel<<<blocks, H::THREADS, smem, stream>>>(
        static_cast<const T*>(src), static_cast<const T*>(geo), static_cast<const T*>(S),
        static_cast<const T*>(Dc), static_cast<T*>(out), N3p, vec_ok);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_deformed(const void* src, const void* geo, const void* S, const void* Dc, void* out,
                      int rows, int p, int B, int N3p, int dim, cudaStream_t stream) {
#define DEF_CASE2(p_, b_) \
  if (dim == 2 && p == p_ && B == b_) \
    return launch_deformed2<T, p_, b_>(src, geo, S, Dc, out, rows, N3p, stream);
  DEF_CASE2(1, 16)
  DEF_CASE2(2, 16)
  DEF_CASE2(3, 16)
  DEF_CASE2(4, 8)
  DEF_CASE2(5, 8)
  DEF_CASE2(6, 8)
#undef DEF_CASE2
  if (dim != 3) return static_cast<int>(cudaErrorInvalidValue);
#define DEF_CASE(p_, b_) \
  if (p == p_ && B == b_) \
    return launch_deformed<T, p_, b_>(src, geo, S, Dc, out, rows, N3p, stream);
  DEF_CASE(1, 16)
  DEF_CASE(2, 8)
  DEF_CASE(3, 4)
  DEF_CASE(4, 4)
  DEF_CASE(5, 2)
  DEF_CASE(6, 2)
#undef DEF_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// (p, B) as the brick size rule gives them: B = 16, 8, 4, 4 at p = 1..4, B = 2 at p = 5..8; in
// 2-D B = 16 at p = 1..3, 8 at p = 4..6 (p <= 3: the distributed brick step's subset rows; the
// single-device engine's degree <= 3 schedule reads no plain rows)
template <typename T>
int dispatch(const void* src, const void* K1, const void* M1, const void* scale, void* out,
             int rows, int p, int B, int N3p, int k, long long src_stride, int dim,
             cudaStream_t stream) {
#define CELL_CASE2(p_, b_) \
  if (dim == 2 && p == p_ && B == b_) \
    return launch2<T, p_, b_>(src, K1, M1, scale, out, rows, N3p, k, src_stride, stream);
  CELL_CASE2(1, 16)
  CELL_CASE2(2, 16)
  CELL_CASE2(3, 16)
  CELL_CASE2(4, 8)
  CELL_CASE2(5, 8)
  CELL_CASE2(6, 8)
#undef CELL_CASE2
  if (dim != 3) return static_cast<int>(cudaErrorInvalidValue);
#define CELL_CASE(p_, b_) \
  if (p == p_ && B == b_) \
    return launch<T, p_, b_>(src, K1, M1, scale, out, rows, N3p, k, src_stride, stream);
  CELL_CASE(1, 16)
  CELL_CASE(2, 8)
  CELL_CASE(3, 4)
  CELL_CASE(4, 4)
  CELL_CASE(5, 2)
  CELL_CASE(6, 2)
  CELL_CASE(7, 2)
  CELL_CASE(8, 2)
#undef CELL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// rows: the cell rows of one RHS; k right-hand sides, src_stride values apart in src (rows * n_loc
// apart in out); dim: 2 or 3, the bricks' dimension
int cell_apply_f32(const void* src, const void* K1, const void* M1, const void* scale,
                   void* out, int rows, int p, int B, int N3p, int k, long long src_stride,
                   int dim, void* stream) {
  return dispatch<float>(src, K1, M1, scale, out, rows, p, B, N3p, k, src_stride, dim,
                         static_cast<cudaStream_t>(stream));
}

int cell_apply_f64(const void* src, const void* K1, const void* M1, const void* scale,
                   void* out, int rows, int p, int B, int N3p, int k, long long src_stride,
                   int dim, void* stream) {
  return dispatch<double>(src, K1, M1, scale, out, rows, p, B, N3p, k, src_stride, dim,
                          static_cast<cudaStream_t>(stream));
}

// The deformed mode: src [rows / B^3][N3p], geo [rows][(p+1)^3][6], S, Dc [(p+1)^2] -> out
// [rows][(p+1)^3], one RHS; dim = 2: src [rows / B^2][N3p], geo [rows][(p+1)^2][3], out
// [rows][(p+1)^2]
int cell_apply_deformed_f32(const void* src, const void* geo, const void* S, const void* Dc,
                            void* out, int rows, int p, int B, int N3p, int dim, void* stream) {
  return dispatch_deformed<float>(src, geo, S, Dc, out, rows, p, B, N3p, dim,
                                  static_cast<cudaStream_t>(stream));
}

int cell_apply_deformed_f64(const void* src, const void* geo, const void* S, const void* Dc,
                            void* out, int rows, int p, int B, int N3p, int dim, void* stream) {
  return dispatch_deformed<double>(src, geo, S, Dc, out, rows, p, B, N3p, dim,
                                   static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
