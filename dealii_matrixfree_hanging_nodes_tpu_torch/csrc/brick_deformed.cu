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
// Design: one block a brick, which owns the brick's nodes, so no atomics:
//   - the brick's u is staged in shared memory by 16-byte cp.async copies and copied from there
//     into the rows of the present cells (kind 0 of every cell of the chunk, below; absent slots
//     stay unread), after which u's space holds the group's kinds 1 and 2;
//   - the cells go through the Laplace G at a time (G consecutive slots: 64, 32, 16, 16, 8, 8 at
//     p = 1..6), a z-column of a cell a thread, in laplace_cols.cuh's five phases with S,
//     D = Dc S and their transposes as even-odd launch parameters (cell_laplace's layout); each
//     thread reads its y-line's metric from device memory at the points, a point's 24-byte row
//     in 3 loads of 8 bytes (f64: 3 of 16; the table so aligned), neighbouring threads on
//     neighbouring points, so each present cell's metric is read once, in whole sectors across
//     a warp; an absent cell's threads idle and read nothing;
//   - every result stays in its cell's row, and one ordered pass over the brick's nodes, a
//     (y, x) column of nodes a thread (its 1-4 cells a layer found once), then sums each node's
//     1-8 present cells, z cells outer, then y, then x, from shared memory, adds on the first m
//     bricks its 1-8 cell-row entries in the same order (brick_apply's epilogue order), and
//     stores it once: a fixed order a node, bit-identical calls.
//   Barriers: 2 before the first group (the staging, the rows), 4 a group (z1, x1, y, x2; the
//   next group's z1 touches only its own thread's columns of the scratch z2 read), 1 before the
//   node pass: 19 a brick at p=4, where the earlier design (a line of a cell a thread in the
//   collocation form, 9 quadrature barriers and 8 parity classes of cells summed into the
//   brick, one barrier each, a group of 16) took 73. At p=4 f32: 416 threads, 51,664 bytes of
//   shared memory, 3 blocks an SM (48 registers).
//   The rows of a brick's cells are B^3 N^3 values (32 KB at p=4 f32); where they would take
//   more than 64 KB (p=1 B=16, and p=2 in f64) the cells go by chunks of whole z-layers of
//   cells, u staying beside them, and a chunk's top node plane carries its partial sums to the
//   next (two planes, in turn), which adds its own cells after them: the same order a node.
//   At quadrant nref=7 p=4 f32 on an H100 80GB HBM3 at 700 W (kernel_ab.py, one process):
//   0.4805-0.4816 ms with the cell rows, where the earlier design took 0.7655-0.7665. Tried and
//   slower in one process: the group's metric by cp.async into shared memory during z1 and x1
//   (0.75 ms at 16 cells a group, 0.82 at 32: the 48 KB a group cost blocks), L2-only metric
//   loads (0.94: the loads of a point share sectors through L1), the next group's metric
//   prefetched into L2 (0.50), two aligned float4 a point (equal), z1 reading u in place
//   without the rows' copy (0.55: its 16 KB more shared memory take L1 from the metric), 32
//   cells a group (0.49), 4 blocks an SM at 32 registers (0.63). The metric's loads set the
//   time: on the in-place layout 0.55 ms, 0.285 without them and 0.15 without the phases.
//
// 2-D (brick_deformed2_kernel; the reference's 2-D branch, bricks.py:3009-3020): bricks of NB^2
// nodes (node (y, x) at y*NB + x), B^2 cells of N^2 nodes, the metric [N^2][3] a cell (xx, xy,
// yy); B = 16 at p = 1..3, 8 at p = 4..6. The same design, but each thread's y-column read in
// place from the staged brick (no rows' copy: the rows of all B^2 cells, u and the group's kind
// 1 take 12.8 KB at p=4 f32), groups of G cells (256 at p = 1, 128 at p = 2, 3, 64 at
// p = 4..6: one group a brick at p >= 4), a y-column of a cell a thread in laplace_cols.cuh's
// three phases, then the ordered node pass (y cells outer, then x), a node a thread: 4 barriers
// a brick at p=4 (320 threads, 6 blocks an SM); at nref=11 p=4 f32 0.1800-0.1824 ms, where the
// earlier design (4 parity classes) took 0.3570-0.3602 (kernel_ab.py).
// Bound at 2-D quadrant nref=11 p=4 f32 (16,646 bricks, 1,051,669 present cells, 517 bricks with
//   cell rows; brick_deformed.bytes_and_flops): memory, the present cells' metric (315.5 MB),
//   u's NB^2 nodes (72.5 MB), v with its padding (76.7 MB) and the cell rows (3.3 MB): ~468 MB,
//   0.14 ms at 3.35 TB/s; 8 sweeps of 2 n^3 and 8 operations a point a cell, 2.3 GFLOP, 0.03 ms.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "laplace_cols.cuh"
#include "sum_factorization.cuh"

namespace {

constexpr int ROWS_BYTES = 65536;  // the most that a chunk's cell rows take of shared memory
constexpr int SM_BYTES = 233472;   // shared memory an SM holds

constexpr int max_i(int a, int b) { return a > b ? a : b; }
constexpr int min_i(int a, int b) { return a < b ? a : b; }

// the z-layers of cells a chunk: the most that divides B, whose rows fit ROWS_BYTES and that
// holds whole groups
constexpr int chunk_layers(int B, int layer_bytes, int layer_cells, int G) {
  int k = B;
  while (k > 1 && (B % k != 0 || k * layer_bytes > ROWS_BYTES || (k * layer_cells) % G != 0)) {
    --k;
  }
  return k;
}

// blocks an SM the registers must allow (as cell_laplace's columns kernel: in f32 1600 threads
// in 3-D and 2048 in 2-D up to p = 4, 768 above; in f64 512, 384 above), no more than the
// shared memory holds
template <typename T, int DIM, int P, int THREADS, int BYTES>
constexpr int min_blocks() {
  constexpr int threads = sizeof(T) == 4 ? (P <= 4 ? (DIM == 3 ? 1600 : 2048) : 768)
                                         : (P <= 4 ? 512 : 384);
  return max_i(1, min_i(threads / THREADS, SM_BYTES / (BYTES + 1024)));
}

template <typename T, int P, int B>
struct Cfg3 {
  static constexpr int N = P + 1, N2 = N * N, NL = N2 * N;
  static constexpr int NB = B * P + 1, NN = NB * NB, N3 = NN * NB;
  static constexpr int C = B * B * B, W = (C + 31) / 32, LAYER = B * B;
  static constexpr int G = P == 1 ? 64 : P == 2 ? 32 : P <= 4 ? 16 : 8;
  static constexpr int THREADS = (G * N2 + 31) / 32 * 32;
  static constexpr int K = chunk_layers(B, LAYER * NL * static_cast<int>(sizeof(T)), LAYER, G);
  static constexpr int CH = K * LAYER, CHUNKS = B / K;  // cells a chunk, chunks a brick
  static constexpr int ROWS = sf::round4(CH * NL);
  static constexpr int U = sf::round4(N3), SCR = sf::round4(2 * G * NL), NNR = sf::round4(NN);
  // one chunk: the group's kinds 1 and 2 in u's place once the rows are copied; more: u stays,
  // the kinds and the two carry planes beside it
  static constexpr int REGION = CHUNKS == 1 ? max_i(U, SCR) : U + SCR + 2 * NNR;
  static constexpr int BYTES = (ROWS + REGION) * static_cast<int>(sizeof(T));
  static constexpr int MIN_BLOCKS = min_blocks<T, 3, P, THREADS, BYTES>();
  // the node pass: a (y, x) column of nodes a thread, its planes in ZPARTS ranges of ZLEN
  static constexpr int ZN = K * P, ZPARTS = max_i(1, THREADS / NN);
  static constexpr int ZLEN = (ZN + 1 + ZPARTS - 1) / ZPARTS;
  static_assert(B % K == 0 && CH % G == 0, "a chunk is whole z-layers of cells, whole groups");
};

template <typename T, int P, int B>
struct Cfg2 {
  static constexpr int N = P + 1, NL = N * N;
  static constexpr int NB = B * P + 1, NN = NB * NB;
  static constexpr int C = B * B, W = (C + 31) / 32;
  static constexpr int G = P == 1 ? 256 : P <= 3 ? 128 : 64;
  static constexpr int THREADS = (G * N + 31) / 32 * 32;
  static constexpr int ROWS = sf::round4(C * NL);
  static constexpr int U = sf::round4(NN), SCR = sf::round4(G * NL);
  static constexpr int BYTES = (ROWS + U + SCR) * static_cast<int>(sizeof(T));
  static constexpr int MIN_BLOCKS = min_blocks<T, 2, P, THREADS, BYTES>();
  static_assert(C % G == 0 && ROWS * static_cast<int>(sizeof(T)) <= ROWS_BYTES, "whole groups");
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

// the brick's count values of src into dst: 16-byte cp.async copies (vec: both 16-byte aligned,
// the row readable up to the next 16 bytes), else one value a thread at a time
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int count, bool vec) {
  if (vec) {
    constexpr int VW = 16 / sizeof(T);
    for (int i = threadIdx.x; i * VW < count; i += blockDim.x) {
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + i * VW));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + i * VW)
                   : "memory");
    }
    eo::cp_async_commit();
    eo::cp_async_wait<0>();
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  }
}

// the packed metric (xx, xy, xz, yy, yz, zz; x the fastest axis) at the points m + 6 N i of a
// y-line times the gradients there, each point's 6 values in 3 loads of 2 (8 bytes in f32, 16
// in f64: a point's row is 24 or 48 bytes, so the pairs are aligned where the table is; the
// wrapper checks it)
template <typename T, int N>
__device__ __forceinline__ void metric3_pairs(const T* __restrict__ m, T (&gx)[N], T (&gy)[N],
                                              T (&gz)[N]) {
  using T2 = std::conditional_t<sizeof(T) == 4, float2, double2>;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T2* mi = reinterpret_cast<const T2*>(m + i * N * 6);
    const T2 a = __ldg(mi), b = __ldg(mi + 1), c = __ldg(mi + 2);
    const T x = gx[i], y = gy[i], z = gz[i];
    gx[i] = a.x * x + a.y * y + b.x * z;
    gy[i] = a.y * x + b.y * y + c.x * z;
    gz[i] = b.x * x + c.x * y + c.y * z;
  }
}

template <typename T, int P, int B>
__global__ void __launch_bounds__(Cfg3<T, P, B>::THREADS, Cfg3<T, P, B>::MIN_BLOCKS)
brick_deformed_kernel(const T* __restrict__ u, const T* __restrict__ geo,
                      const int* __restrict__ present, const T* __restrict__ dcols,
                      T* __restrict__ v, const eo::Factors<T, P + 1> f, int m, int N3p,
                      int vec_u) {
  using F = Cfg3<T, P, B>;
  constexpr int N = F::N, N2 = F::N2, NL = F::NL, NB = F::NB, NN = F::NN, N3 = F::N3;
  constexpr int C = F::C, W = F::W, G = F::G, K = F::K, CH = F::CH, CHUNKS = F::CHUNKS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const rows = reinterpret_cast<T*>(smem_raw);  // [CH][NL] the chunk's cells (kind 0)
  T* const su = rows + F::ROWS;                    // [N3] the brick's u
  T* const k1 = CHUNKS == 1 ? su : su + F::U;      // [G][NL] the group's kind 1
  T* const k2 = k1 + G * NL;                       // [G][NL] its kind 2
  T* const carry = k1 + F::SCR;                    // [2][NNR] (more than one chunk)
  __shared__ unsigned s_bits[W];

  const int tid = threadIdx.x;
  const size_t brick = blockIdx.x;
  const T* ub = u + brick * N3p;
  for (int i = tid; i < W; i += F::THREADS) s_bits[i] = __ldg(present + brick * W + i);
  stage(su, ub, N3, vec_u && (reinterpret_cast<uintptr_t>(ub) % 16 == 0));
  __syncthreads();

  auto is_present = [&](int s) { return (s_bits[s >> 5] >> (s & 31)) & 1u; };
  const int g = tid / N2, j = tid - g * N2;
  const bool lane = tid < G * N2;
  const T* const gb = geo + brick * C * static_cast<size_t>(NL) * 6;
  T* const vb = v + brick * N3p;
  const T* const db = dcols + brick * C * static_cast<size_t>(NL);
  const bool with_rows = static_cast<int>(brick) < m;

  for (int ch = 0; ch < CHUNKS; ++ch) {
    const int c0 = ch * CH;  // the chunk's first slot
    // the rows of the chunk's present cells, from the staged brick
    for (int t = tid; t < CH * NL; t += F::THREADS) {
      const int k = t / NL, s = c0 + k, jj = t - k * NL;
      if (is_present(s)) {
        const int sx = s % B, sy = (s / B) % B, sz = s / (B * B);
        rows[t] = su[((sz * P + jj / N2) * NB + sy * P + (jj / N) % N) * NB + sx * P + jj % N];
      }
    }
    __syncthreads();
    // the chunk's cells, G at a time
    for (int s0 = c0; s0 < c0 + CH; s0 += G) {
      const int s = s0 + g;
      const bool active = lane && is_present(s);
      T* const k0 = rows + (s - c0) * NL;
      const T* mg = gb + s * static_cast<size_t>(NL) * 6;
      lc::laplace3<T, N, N2>(k0 + j, k0, k1 + g * NL, k2 + g * NL, f, j, active,
                             [&](T(&gx)[N], T(&gy)[N], T(&gz)[N], int o) {
                               metric3_pairs<T, N>(mg + o * 6, gx, gy, gz);
                             });
    }
    __syncthreads();

    // the chunk's node planes z0 .. z0 + ZN, a (y, x) column of them a thread: each node's
    // present cells of the chunk in order (after the carried sum of the chunk below), then its
    // cell-row entries; the top plane of a chunk but the last is carried instead
    const int z0 = ch * F::ZN;
    const bool last = ch + 1 == CHUNKS;
    for (int item = tid; item < NN * F::ZPARTS; item += F::THREADS) {
      const int part = item / NN, yx = item - part * NN, y = yx / NB, x = yx - y * NB;
      int cx[2] = {}, lx[2] = {}, cy[2] = {}, ly[2] = {};
      const int nx = axis_cells<P, B>(x, cx, lx);
      const int ny = axis_cells<P, B>(y, cy, ly);
      int sxy[4], oxy[4];  // the column's 1-4 cells in a layer: slot and row offset, y outer
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // (b, c) = (q / 2, q % 2), the first cell past the last
        const bool b = q / 2 == 1 && ny > 1, c = q % 2 == 1 && nx > 1;
        sxy[q] = (b ? cy[1] : cy[0]) * B + (c ? cx[1] : cx[0]);
        oxy[q] = (b ? ly[1] : ly[0]) * N + (c ? lx[1] : lx[0]);
      }
      const int zl_end = min((part + 1) * F::ZLEN, F::ZN + 1);
      for (int zl = part * F::ZLEN; zl < zl_end; ++zl) {
        int cz[2] = {}, lz[2] = {};
        const int nz = axis_cells<P, B>(z0 + zl, cz, lz);
        T out = T(0);
        if constexpr (CHUNKS > 1) {
          if (ch > 0 && zl == 0) out = carry[((ch - 1) & 1) * F::NNR + yx];
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          if (a >= nz || (CHUNKS > 1 && (cz[a] < ch * K || cz[a] >= (ch + 1) * K))) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q / 2 >= ny || q % 2 >= nx) continue;
            const int s = cz[a] * B * B + sxy[q];
            if (is_present(s)) out += rows[(s - c0) * NL + lz[a] * N2 + oxy[q]];
          }
        }
        if constexpr (CHUNKS > 1) {
          if (!last && zl == F::ZN) {
            carry[(ch & 1) * F::NNR + yx] = out;
            continue;
          }
        }
        if (with_rows) {
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            if (a >= nz) continue;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (q / 2 >= ny || q % 2 >= nx) continue;
              const int s = cz[a] * B * B + sxy[q];
              out += __ldg(db + static_cast<size_t>(s) * NL + lz[a] * N2 + oxy[q]);
            }
          }
        }
        vb[(z0 + zl) * NN + yx] = out;
      }
    }
    if (!last) __syncthreads();
  }
  for (int i = N3 + tid; i < N3p; i += F::THREADS) vb[i] = T(0);
}

template <typename T, int P, int B>
__global__ void __launch_bounds__(Cfg2<T, P, B>::THREADS, Cfg2<T, P, B>::MIN_BLOCKS)
brick_deformed2_kernel(const T* __restrict__ u, const T* __restrict__ geo,
                       const int* __restrict__ present, const T* __restrict__ dcols,
                       T* __restrict__ v, const eo::Factors<T, P + 1> f, int m, int N3p,
                       int vec_u) {
  using F = Cfg2<T, P, B>;
  constexpr int N = F::N, NL = F::NL, NB = F::NB, NN = F::NN, C = F::C, W = F::W, G = F::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const rows = reinterpret_cast<T*>(smem_raw);  // [C][NL] the brick's cells (kind 0)
  T* const su = rows + F::ROWS;                    // [NN] the brick's u
  T* const k1 = su + F::U;                         // [G][NL] the group's kind 1
  __shared__ unsigned s_bits[W];

  const int tid = threadIdx.x;
  const size_t brick = blockIdx.x;
  const T* ub = u + brick * N3p;
  for (int i = tid; i < W; i += F::THREADS) s_bits[i] = __ldg(present + brick * W + i);
  stage(su, ub, NN, vec_u && (reinterpret_cast<uintptr_t>(ub) % 16 == 0));
  __syncthreads();

  auto is_present = [&](int s) { return (s_bits[s >> 5] >> (s & 31)) & 1u; };
  const int g = tid / N, j = tid - g * N;
  const bool lane = tid < G * N;
  const T* const gb = geo + brick * C * static_cast<size_t>(NL) * 3;
  for (int s0 = 0; s0 < C; s0 += G) {
    const int s = s0 + g;
    const bool active = lane && is_present(s);
    const T* mg = gb + s * static_cast<size_t>(NL) * 3;
    lc::laplace2<T, N, NB>(su + (s / B) * P * NB + (s % B) * P + j, rows + s * NL, k1 + g * NL,
                           f, j, active, [&](T(&gx)[N], T(&gy)[N], int o) {
                             lc::metric2<T, N>(mg + o * 3, gx, gy);
                           });
  }
  __syncthreads();

  // each node: its present cells in order (y cells outer, then x), then its cell-row entries
  T* const vb = v + brick * N3p;
  const T* const db = dcols + brick * C * static_cast<size_t>(NL);
  const bool with_rows = static_cast<int>(brick) < m;
  for (int i = tid; i < N3p; i += F::THREADS) {
    if (i >= NN) {
      vb[i] = T(0);
      continue;
    }
    int cx[2] = {}, lx[2] = {}, cy[2] = {}, ly[2] = {};
    const int nx = axis_cells<P, B>(i % NB, cx, lx);
    const int ny = axis_cells<P, B>(i / NB, cy, ly);
    T out = T(0);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int s = cy[b] * B + cx[c];
        if (b < ny && c < nx && is_present(s)) out += rows[s * NL + ly[b] * N + lx[c]];
      }
    }
    if (with_rows) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (b < ny && c < nx) {
            out += __ldg(db + static_cast<size_t>(cy[b] * B + cx[c]) * NL + ly[b] * N + lx[c]);
          }
        }
      }
    }
    vb[i] = out;
  }
}

template <typename T, typename F, typename Kernel>
int run(Kernel kernel, const void* const* a, void* v, int nb, int m, int N3p, int* info,
        cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, F::BYTES, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info) {  // a dry run: threads, shared memory and blocks per SM, launch nothing
    info[0] = F::THREADS;
    info[1] = F::BYTES;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, F::THREADS, F::BYTES));
  }
  const double* fac = static_cast<const double*>(a[6]);
  if (fac == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_u = (N3p * sizeof(T)) % 16 == 0;  // 16-byte loads of the bricks: 16-byte rows
  if (nb > 0) {
    kernel<<<nb, F::THREADS, F::BYTES, stream>>>(
        static_cast<const T*>(a[0]), static_cast<const T*>(a[1]), static_cast<const int*>(a[2]),
        static_cast<const T*>(a[5]), static_cast<T*>(v), eo::factors_from<T, F::N>(fac), m, N3p,
        vec_u);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DIM, int P, int B>
int launch(const void* const* a, void* v, int nb, int m, int N3p, int* info,
           cudaStream_t stream) {
  if constexpr (DIM == 3) {
    return run<T, Cfg3<T, P, B>>(brick_deformed_kernel<T, P, B>, a, v, nb, m, N3p, info, stream);
  } else {
    return run<T, Cfg2<T, P, B>>(brick_deformed2_kernel<T, P, B>, a, v, nb, m, N3p, info,
                                 stream);
  }
}

// (p, B) as the brick size rule gives them: 3-D B = 16, 8, 4 at p = 1, 2, 3 and 4; B = 2 at
// p = 5, 6; 2-D B = 16 at p = 1..3, 8 at p = 4..6
template <typename T>
int dispatch(const void* const* a, void* v, int nb, int m, int p, int B, int N3p, int* info,
             int dim, cudaStream_t stream) {
#define BD_CASE(d_, p_, b_) \
  if (dim == d_ && p == p_ && B == b_) return launch<T, d_, p_, b_>(a, v, nb, m, N3p, info, stream);
  BD_CASE(2, 1, 16)
  BD_CASE(2, 2, 16)
  BD_CASE(2, 3, 16)
  BD_CASE(2, 4, 8)
  BD_CASE(2, 5, 8)
  BD_CASE(2, 6, 8)
  BD_CASE(3, 1, 16)
  BD_CASE(3, 2, 8)
  BD_CASE(3, 3, 4)
  BD_CASE(3, 4, 4)
  BD_CASE(3, 5, 2)
  BD_CASE(3, 6, 2)
#undef BD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// a: device pointers, in order: u [nb][N3p], geo [nb*B^3][(p+1)^3][6], present [nb][ceil(B^3/32)]
// int32, S, Dc [(p+1)^2] (unread: the factors below carry them), dcols [m*B^3][(p+1)^3] (unread
// when m = 0); then the host float64 tables of S, D = Dc S, S^T, D^T, each its even-odd split
// (_even_odd.factor_tables; copied into the launch's parameters). dim = 2: geo
// [nb*B^2][(p+1)^2][3], present [nb][ceil(B^2/32)], dcols [m*B^2][(p+1)^2]. info: null to
// launch; else [threads, shared-memory bytes, blocks per SM], not launched (no tables read).
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
