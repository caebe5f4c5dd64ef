// brick_deformed: the Laplace under a deformed (high-order) mapping on every brick b of a
// [n_bricks, N3p] vector (node (z, y, x) at (z*NB + y)*NB + x, NB = B*p + 1, N3 = NB^3 nodes,
// padded to N3p),
//   v_b = sum over the present cells c of b of E_c^T K_c E_c u_b,
// K_c the cell's stiffness at its Gauss points with its packed metric geo[b*B^3 + c] [N^3][6]
// (w detJ J^-1 J^-T, as cell_laplace's deformed mode reads it), E_c the gather of cell c's
// N^3 = (p+1)^3 nodes (cell slots and local nodes x fastest); present[b] holds a bit a cell
// slot (bit s % 32 of word s / 32). On the first m bricks the overlap-add of their cell rows
// dcols [m*B^3, N^3] follows, as in brick_apply's epilogue; the padded tail N3..N3p is written
// as zeros.
//
// Replaces: BrickLaplaceMM._deformed_brick_apply (dealii_matrixfree_hanging_nodes_tpu/bricks.py:
//   2978-3032): whole-brick sweeps of the block-diagonal quadrature operators (Sqb [Q, NB],
//   Dqb [Q, Q], Q = B (p+1)) with the metric on the brick-quad lattice Gqb, zero at absent
//   slots, which the TPU side ran as XLA einsums (no Pallas kernel); and, in the epilogue,
//   _scatter_cols of the subset rows' deltas (bricks.py:2196-2241) with the merge
//   v.at[:n_sub].add(corr) (bricks.py:2553-2559). Per cell the same function as
//   _deformed_cell_apply (2959-2976) summed over the present cells (bricks.py:2985-2989).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (4400 bricks, 269,991 present cells, 1025
//   bricks with cell rows): memory. The metric of the present cells (810 MB), u's N3 nodes
//   (86.5 MB), v with its padding (87.9 MB) and the cell rows (32.8 MB): ~1.02 GB, 0.30 ms at
//   3.35 TB/s; the 12 sweeps of 2 n^4 and the 15 operations a point a cell are ~4.9 GFLOP,
//   0.07 ms at 67 TFLOP/s (f32 outside the tensor cores). The absent slots' metric is not read.
//
// Design: one block per brick, which owns the brick's nodes, so no atomics (masked_quad's
//   shape):
//   - the brick's u is staged in shared memory once (16-byte loads) and its sum lives there
//     too (acc, N3 values, zeroed first);
//   - the cells go through the quadrature G at a time (G consecutive slots: 64, 32, 16, 16, 8, 8
//     at p = 1..6, one line of a cell a thread), laplace_quad.cuh's sweeps, the metric read
//     from device memory at the points (24-byte rows, neighbouring threads on neighbouring
//     points); an absent cell's threads idle and read nothing;
//   - a group's rows are added into acc one parity class of cells after another (x%2, y%2,
//     z%2 of the slot; one barrier a class), so no two threads add into one node and a node's
//     1-8 cells add in a fixed order: deterministic, bit-identical calls;
//   - at the end each node is stored once: acc plus, on the first m bricks, its 1-8 cell-row
//     entries summed z cells outer, then y, then x (brick_apply's epilogue order).
//
// 2-D (brick_deformed2_kernel; the reference's 2-D branch, bricks.py:3009-3020): bricks of NB^2
// nodes (node (y, x) at y*NB + x), B^2 cells of N^2 nodes, the metric [N^2][3] a cell (xx, xy,
// yy); B = 16 at p = 1..3, 8 at p = 4..6. The same design: one block a brick, its u and sum in
// shared memory (2 x 2,401 values at NB = 49), groups of G2 cells (128 at p = 1, 64 at p = 2, 3,
// 32 at p = 4..6; one line of a cell a thread, N lines a cell) through laplace_quad.cuh's 2-D
// sweeps (laplace_cells2, metric_line2), 4 parity classes of cells (x%2, y%2) into the sum, one
// barrier a class, then the store with the 1-4 cell-row entries (y cells outer, then x).
// Bound at 2-D quadrant nref=11 p=4 f32 (16,646 bricks, 1,051,669 present cells, 517 bricks with
//   cell rows; brick_deformed.bytes_and_flops): memory, the present cells' metric (315.5 MB),
//   u's NB^2 nodes (72.5 MB), v with its padding (76.7 MB) and the cell rows (3.3 MB): ~468 MB,
//   0.14 ms at 3.35 TB/s; 8 sweeps of 2 n^3 and 8 operations a point a cell, 2.3 GFLOP, 0.03 ms.

#include <cuda_runtime.h>

#include <cstdint>

#include "laplace_quad.cuh"
#include "sum_factorization.cuh"

namespace {

template <int P>
struct Cfg {
  static constexpr int N = P + 1;
  static constexpr int N2 = N * N;
  static constexpr int NL = N2 * N;
  static constexpr int G = P == 1 ? 64 : P == 2 ? 32 : P <= 4 ? 16 : 8;  // cells a group
  static constexpr int THREADS = (G * N2 + 31) / 32 * 32;
  static constexpr int SCR = G * NL;
};

// A group of G consecutive slots, GX x GY x GZ cells (x fastest); its first slot has even x
// and y (G is a multiple of 2 B where GZ = 1), so parity class (px, py, pz) holds CX x CY x CZ
// of its cells, the cells 2 k + (px, py, pz).
template <int B, int G>
struct Group {
  static constexpr int GX = B < G ? B : G;
  static constexpr int GY = B < G / GX ? B : G / GX;
  static constexpr int GZ = G / (GX * GY);
  static constexpr int CX = GX / 2, CY = GY / 2, CZ = GZ > 1 ? GZ / 2 : 1;
  static constexpr int NZ = GZ > 1 ? 2 : 1;  // z parities in a group
  static_assert(GX * GY * GZ == G && GX % 2 == 0 && GY % 2 == 0 && (GZ == 1 || GZ % 2 == 0),
                "a group is whole pairs of cells along x and y");
};

// The cells holding node coordinate c (0 .. B P) along one axis, with the node's local index in
// each: one cell inside it, two on an interior cell boundary (the cell before at local P first)
template <int P, int B>
__device__ __forceinline__ int axis_cells(int c, int (&cell)[2], int (&loc)[2]) {
  if (c == B * P) {
    cell[0] = B - 1;
    loc[0] = P;
    return 1;
  }
  const int q = c / P, r = c - q * P;
  if (r == 0 && q > 0) {
    cell[0] = q - 1;
    loc[0] = P;
    cell[1] = q;
    loc[1] = 0;
    return 2;
  }
  cell[0] = q;
  loc[0] = r;
  return 1;
}

template <typename T, int P, int B>
__global__ void __launch_bounds__(Cfg<P>::THREADS)
brick_deformed_kernel(const T* __restrict__ u, const T* __restrict__ geo,
                      const int* __restrict__ present, const T* __restrict__ S,
                      const T* __restrict__ Dc, const T* __restrict__ dcols, T* __restrict__ v,
                      int m, int N3p, int vec_u) {
  using F = Cfg<P>;
  using Gr = Group<B, F::G>;
  constexpr int N = F::N, N2 = F::N2, NL = F::NL, G = F::G;
  constexpr int NB = B * P + 1, N3 = NB * NB * NB, N3R = (N3 + 3) / 4 * 4;  // whole 16 bytes
  constexpr int C = B * B * B, W = (C + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* su = reinterpret_cast<T*>(smem_raw);  // [N3R] the brick's u
  T* acc = su + N3R;                       // [N3R] its sum
  T* V = acc + N3R;                        // [G NL] the group's rows
  T* G0 = V + F::SCR;                      // [3][G NL] their gradients
  T* G1 = G0 + F::SCR;
  T* G2 = G1 + F::SCR;
  T* sS = G2 + F::SCR;  // [N N]
  T* sD = sS + N * N;   // [N N]
  __shared__ unsigned s_bits[W];

  const int tid = threadIdx.x;
  const size_t brick = blockIdx.x;
  const T* ub = u + brick * N3p;
  sf::copy_block(su, ub, N3, vec_u && (reinterpret_cast<uintptr_t>(ub) % 16 == 0));
  for (int i = tid; i < N3; i += F::THREADS) acc[i] = T(0);
  lq::stage_factors<T, N>(sS, sD, S, Dc);
  for (int i = tid; i < W; i += F::THREADS) s_bits[i] = __ldg(present + brick * W + i);
  __syncthreads();

  auto is_present = [&](int s) { return (s_bits[s >> 5] >> (s & 31)) & 1u; };
  // the brick node of local index jj in the cell at slot s
  auto node = [](int s, int jj) {
    const int sx = s % B, sy = (s / B) % B, sz = s / (B * B);
    const int ix = jj % N, iy = (jj / N) % N, iz = jj / N2;
    return ((sz * P + iz) * NB + sy * P + iy) * NB + sx * P + ix;
  };
  const int l = tid, g = l / N2, j = l - g * N2;
  T* cell = V + g * NL;

  for (int s0 = 0; s0 < C; s0 += G) {
    // the group's present cells from the staged brick (absent ones stay unread)
    for (int t = tid; t < G * NL; t += F::THREADS) {
      const int k = t / NL, s = s0 + k;
      V[t] = is_present(s) ? su[node(s, t - k * NL)] : T(0);
    }
    const bool active = l < G * N2 && is_present(s0 + g);
    if (!__syncthreads_or(active)) continue;  // also the barrier after the gather
    const T* mg = geo + (brick * C + s0 + g) * NL * 6;
    lq::laplace_cells<T, N>(cell, G0 + g * NL, G1 + g * NL, G2 + g * NL, sS, sD, j, active,
                            [=](T* x, T* y, T* z) { lq::metric_line<T, N>(mg, x, y, z, j); });
    // into acc, one parity class after another
#pragma unroll 1
    for (int cls = 0; cls < 4 * Gr::NZ; ++cls) {
      const int px = cls & 1, py = (cls >> 1) & 1, pz = cls >> 2;
      constexpr int NC = Gr::CX * Gr::CY * Gr::CZ * NL;
      for (int t = tid; t < NC; t += F::THREADS) {
        const int k = t / NL, jj = t - k * NL;
        const int kx = k % Gr::CX, ky = (k / Gr::CX) % Gr::CY, kz = k / (Gr::CX * Gr::CY);
        const int gk = 2 * kx + px + Gr::GX * (2 * ky + py + Gr::GY * (2 * kz + pz));
        const int s = s0 + gk;
        if (is_present(s)) acc[node(s, jj)] += V[gk * NL + jj];
      }
      __syncthreads();
    }
  }

  // store: acc, plus each node's cell-row entries on the first m bricks
  T* vb = v + brick * N3p;
  const T* db = dcols + brick * C * NL;
  const bool rows = static_cast<int>(brick) < m;
  for (int i = tid; i < N3p; i += F::THREADS) {
    if (i >= N3) {
      vb[i] = T(0);
      continue;
    }
    T out = acc[i];
    if (rows) {
      const int x = i % NB, y = (i / NB) % NB, z = i / (NB * NB);
      int cx[2], lx[2], cy[2], ly[2], cz[2], lz[2];
      const int nx = axis_cells<P, B>(x, cx, lx);
      const int ny = axis_cells<P, B>(y, cy, ly);
      const int nz = axis_cells<P, B>(z, cz, lz);
      T corr = T(0);
      for (int a = 0; a < nz; ++a)
        for (int b = 0; b < ny; ++b)
          for (int c = 0; c < nx; ++c) {
            const int s = (cz[a] * B + cy[b]) * B + cx[c];
            corr += __ldg(db + static_cast<size_t>(s) * NL + (lz[a] * N + ly[b]) * N + lx[c]);
          }
      out += corr;
    }
    vb[i] = out;
  }
}

// ---- 2-D --------------------------------------------------------------------------------------
// A group of G consecutive slots, GX x GY cells (x fastest), its first slot at even x and y;
// parity class (px, py) holds CX x CY of its cells, the cells 2 k + (px, py).
template <int B, int G>
struct Group2 {
  static constexpr int GX = B < G ? B : G;
  static constexpr int GY = G / GX;
  static constexpr int CX = GX / 2, CY = GY / 2;
  static_assert(GX * GY == G && GX % 2 == 0 && GY % 2 == 0 && (B * B) % G == 0,
                "a group is whole pairs of cells along x and y");
};

template <typename T, int P, int B>
__global__ void __launch_bounds__(lq::Cells2<P>::THREADS)
brick_deformed2_kernel(const T* __restrict__ u, const T* __restrict__ geo,
                       const int* __restrict__ present, const T* __restrict__ S,
                       const T* __restrict__ Dc, const T* __restrict__ dcols, T* __restrict__ v,
                       int m, int N3p, int vec_u) {
  using F = lq::Cells2<P>;
  using Gr = Group2<B, F::G>;
  constexpr int N = F::N, NL = F::NL, G = F::G, SCR = G * NL;
  constexpr int NB = B * P + 1, N2 = NB * NB, N2R = (N2 + 3) / 4 * 4;
  constexpr int C = B * B, W = (C + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* su = reinterpret_cast<T*>(smem_raw);  // [N2R] the brick's u
  T* acc = su + N2R;                       // [N2R] its sum
  T* V = acc + N2R;                        // [G NL] the group's rows
  T* G0 = V + SCR;                         // [2][G NL] their gradients
  T* G1 = G0 + SCR;
  T* sS = G1 + SCR;  // [N N]
  T* sD = sS + N * N;   // [N N]
  __shared__ unsigned s_bits[W];

  const int tid = threadIdx.x;
  const size_t brick = blockIdx.x;
  const T* ub = u + brick * N3p;
  sf::copy_block(su, ub, N2, vec_u && (reinterpret_cast<uintptr_t>(ub) % 16 == 0));
  for (int i = tid; i < N2; i += F::THREADS) acc[i] = T(0);
  lq::stage_factors<T, N>(sS, sD, S, Dc);
  for (int i = tid; i < W; i += F::THREADS) s_bits[i] = __ldg(present + brick * W + i);
  __syncthreads();

  auto is_present = [&](int s) { return (s_bits[s >> 5] >> (s & 31)) & 1u; };
  // the brick node of local index jj in the cell at slot s
  auto node = [](int s, int jj) {
    return ((s / B) * P + jj / N) * NB + (s % B) * P + jj % N;
  };
  const int l = tid, g = l / N, j = l - g * N;
  T* cell = V + g * NL;

  for (int s0 = 0; s0 < C; s0 += G) {
    for (int t = tid; t < G * NL; t += F::THREADS) {
      const int k = t / NL, s = s0 + k;
      V[t] = is_present(s) ? su[node(s, t - k * NL)] : T(0);
    }
    const bool active = l < G * N && is_present(s0 + g);
    if (!__syncthreads_or(active)) continue;  // also the barrier after the gather
    const T* mg = geo + (brick * C + s0 + (g < G ? g : 0)) * NL * 3;
    lq::laplace_cells2<T, N>(cell, G0 + g * NL, G1 + g * NL, sS, sD, j, active,
                             [=](T* x, T* y) { lq::metric_line2<T, N>(mg, x, y, j); });
#pragma unroll 1
    for (int cls = 0; cls < 4; ++cls) {
      const int px = cls & 1, py = cls >> 1;
      constexpr int NC = Gr::CX * Gr::CY * NL;
      for (int t = tid; t < NC; t += F::THREADS) {
        const int k = t / NL, jj = t - k * NL;
        const int gk = 2 * (k % Gr::CX) + px + Gr::GX * (2 * (k / Gr::CX) + py);
        const int s = s0 + gk;
        if (is_present(s)) acc[node(s, jj)] += V[gk * NL + jj];
      }
      __syncthreads();
    }
  }

  // store: acc, plus each node's cell-row entries on the first m bricks
  T* vb = v + brick * N3p;
  const T* db = dcols + brick * C * NL;
  const bool rows = static_cast<int>(brick) < m;
  for (int i = tid; i < N3p; i += F::THREADS) {
    if (i >= N2) {
      vb[i] = T(0);
      continue;
    }
    T out = acc[i];
    if (rows) {
      int cx[2], lx[2], cy[2], ly[2];
      const int nx = axis_cells<P, B>(i % NB, cx, lx);
      const int ny = axis_cells<P, B>(i / NB, cy, ly);
      T corr = T(0);
      for (int b = 0; b < ny; ++b)
        for (int c = 0; c < nx; ++c)
          corr += __ldg(db + static_cast<size_t>(cy[b] * B + cx[c]) * NL + ly[b] * N + lx[c]);
      out += corr;
    }
    vb[i] = out;
  }
}

template <typename T, int P, int B>
int launch2(const void* u, const void* geo, const void* present, const void* S, const void* Dc,
            const void* dcols, void* v, int nb, int m, int N3p, int* info, cudaStream_t stream) {
  using F = lq::Cells2<P>;
  constexpr int NB = B * P + 1;
  const int smem = static_cast<int>(
      (2 * sf::round4(NB * NB) + 3 * F::G * F::NL + 2 * F::N * F::N) * sizeof(T));
  auto kernel = brick_deformed2_kernel<T, P, B>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info) {  // a dry run: threads, shared memory and blocks per SM, launch nothing
    info[0] = F::THREADS;
    info[1] = smem;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, F::THREADS, smem));
  }
  const int vec_u = (N3p * sizeof(T)) % 16 == 0;
  if (nb > 0) {
    kernel<<<nb, F::THREADS, smem, stream>>>(
        static_cast<const T*>(u), static_cast<const T*>(geo), static_cast<const int*>(present),
        static_cast<const T*>(S), static_cast<const T*>(Dc), static_cast<const T*>(dcols),
        static_cast<T*>(v), m, N3p, vec_u);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P, int B>
int launch(const void* u, const void* geo, const void* present, const void* S, const void* Dc,
           const void* dcols, void* v, int nb, int m, int N3p, int* info, cudaStream_t stream) {
  using F = Cfg<P>;
  constexpr int NB = B * P + 1;
  const int smem = static_cast<int>(
      (2 * sf::round4(NB * NB * NB) + 4 * F::SCR + 2 * F::N * F::N) * sizeof(T));
  auto kernel = brick_deformed_kernel<T, P, B>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info) {  // a dry run: threads, shared memory and blocks per SM, launch nothing
    info[0] = F::THREADS;
    info[1] = smem;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, F::THREADS, smem));
  }
  // 16-byte loads of the bricks need 16-byte rows
  const int vec_u = (N3p * sizeof(T)) % 16 == 0;
  if (nb > 0) {
    kernel<<<nb, F::THREADS, smem, stream>>>(
        static_cast<const T*>(u), static_cast<const T*>(geo), static_cast<const int*>(present),
        static_cast<const T*>(S), static_cast<const T*>(Dc), static_cast<const T*>(dcols),
        static_cast<T*>(v), m, N3p, vec_u);
  }
  return static_cast<int>(cudaGetLastError());
}

// (p, B) as the brick size rule gives them: 3-D B = 16, 8, 4 at p = 1, 2, 3 and 4; B = 2 at
// p = 5, 6; 2-D B = 16 at p = 1..3, 8 at p = 4..6
template <typename T>
int dispatch(const void* const* a, void* v, int nb, int m, int p, int B, int N3p, int* info,
             int dim, cudaStream_t stream) {
#define BD_CASE2(p_, b_) \
  if (dim == 2 && p == p_ && B == b_) \
    return launch2<T, p_, b_>(a[0], a[1], a[2], a[3], a[4], a[5], v, nb, m, N3p, info, stream);
  BD_CASE2(1, 16)
  BD_CASE2(2, 16)
  BD_CASE2(3, 16)
  BD_CASE2(4, 8)
  BD_CASE2(5, 8)
  BD_CASE2(6, 8)
#undef BD_CASE2
  if (dim != 3) return static_cast<int>(cudaErrorInvalidValue);
#define BD_CASE(p_, b_) \
  if (p == p_ && B == b_) \
    return launch<T, p_, b_>(a[0], a[1], a[2], a[3], a[4], a[5], v, nb, m, N3p, info, stream);
  BD_CASE(1, 16)
  BD_CASE(2, 8)
  BD_CASE(3, 4)
  BD_CASE(4, 4)
  BD_CASE(5, 2)
  BD_CASE(6, 2)
#undef BD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// a: device pointers, in order: u [nb][N3p], geo [nb*B^3][(p+1)^3][6], present [nb][ceil(B^3/32)]
// int32, S, Dc [(p+1)^2], dcols [m*B^3][(p+1)^3] (unread when m = 0); dim = 2: geo
// [nb*B^2][(p+1)^2][3], present [nb][ceil(B^2/32)], dcols [m*B^2][(p+1)^2]. info: null to launch;
// else [threads, shared-memory bytes, blocks per SM], not launched.
int brick_deformed_f32(const void* const* a, void* v, int nb, int m, int p, int B, int N3p,
                       int* info, int dim, void* stream) {
  return dispatch<float>(a, v, nb, m, p, B, N3p, info, dim, static_cast<cudaStream_t>(stream));
}

int brick_deformed_f64(const void* const* a, void* v, int nb, int m, int p, int B, int N3p,
                       int* info, int dim, void* stream) {
  return dispatch<double>(a, v, nb, m, p, B, N3p, info, dim, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
