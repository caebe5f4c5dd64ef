// The Laplace of a group of cells at their Gauss points, in shared memory, shared by
// cell_laplace.cu, brick_deformed.cu and the deformed modes of cell_apply.cu and hn_cell.cu: the
// collocation form of the reference (ops/sum_factorization.py:57-89, models/laplace.py:20-49,
// bricks.py:2959-2976). A cell's N^3 values (N = p+1, x fastest) sit in `cell`, its three
// gradient components in g0, g1, g2 (scratch of N^3 values each); thread j of the cell handles
// line j (0 .. N^2-1) of each sweep (hanging_nodes.cuh's convention):
//   values at the Gauss points: S along x, y, z (in place);
//   the reference gradient, component t: Dc along t;
//   the geometry at each point (a callable on the line's N points j + k N^2): the Cartesian
//     factors times the weights, or the packed symmetric metric (metric_line);
//   the transposes: Dc^T on component t along t, their sum, S^T along z, y, x, into `cell`.
// S and Dc are [N][N] in shared memory, read by every thread of a warp at once (broadcasts).
// The 2-D forms (laplace_cells2, cell_laplace's dim=2 instances) follow the 3-D ones.

#pragma once

#include <cuda_runtime.h>

#include "hanging_nodes.cuh"

namespace lq {

// g <- G_q g at point q of a cell: the packed upper triangle (xx, xy, xz, yy, yz, zz; component
// 0 is x, the fastest axis) of w detJ J^-1 J^-T, its six values m in device memory
template <typename T>
__device__ __forceinline__ void metric_point(const T* __restrict__ m, T* g0, T* g1, T* g2,
                                             int q) {
  const T x = g0[q], y = g1[q], z = g2[q];
  const T m0 = __ldg(m + 0), m1 = __ldg(m + 1), m2 = __ldg(m + 2), m3 = __ldg(m + 3),
          m4 = __ldg(m + 4), m5 = __ldg(m + 5);
  g0[q] = m0 * x + m1 * y + m2 * z;
  g1[q] = m1 * x + m3 * y + m4 * z;
  g2[q] = m2 * x + m4 * y + m5 * z;
}

// the metric on the N points of line j (j + k N^2) of a cell whose metric is geo [N^3][6]
template <typename T, int N>
__device__ __forceinline__ void metric_line(const T* __restrict__ geo, T* g0, T* g1, T* g2,
                                            int j) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int q = j + k * N * N;
    metric_point(geo + q * 6, g0, g1, g2, q);
  }
}

// transposed z sweep of the sum of the three gradient components (line j along z), into out
template <typename T, int N>
__device__ __forceinline__ void sum_sweep_z(const T* g0, const T* g1, const T* g2, T* out,
                                            const T* M, int j) {
  int ca, cb;
  const int base = hn::line_base<N, 2>(j, ca, cb);
  constexpr int S = N * N;
  T r[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int o = base + k * S;
    r[k] = g0[o] + g1[o] + g2[o];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) acc += M[k * N + i] * r[k];
    out[base + i * S] = acc;
  }
}

// The Laplace of the cells of a block, line j of `cell` on each active thread: values in, the
// cell's stiffness times them out, in place; `point(g0, g1, g2)` applies the geometry on the
// line's points. Every thread of the block calls it (it holds the 9 barriers, the last after the
// results are in place); the values must be in place before the call (a barrier).
template <typename T, int N, typename Point>
__device__ __forceinline__ void laplace_cells(T* cell, T* g0, T* g1, T* g2, const T* sS,
                                              const T* sD, int j, bool active, Point point) {
  // values at the Gauss points
  if (active) hn::sweep_line<T, N, 0, false>(cell, cell, sS, j);
  __syncthreads();
  if (active) hn::sweep_line<T, N, 1, false>(cell, cell, sS, j);
  __syncthreads();
  if (active) hn::sweep_line<T, N, 2, false>(cell, cell, sS, j);
  __syncthreads();
  // the reference gradient, component t along t
  if (active) {
    hn::sweep_line<T, N, 0, false>(cell, g0, sD, j);
    hn::sweep_line<T, N, 1, false>(cell, g1, sD, j);
    hn::sweep_line<T, N, 2, false>(cell, g2, sD, j);
  }
  __syncthreads();
  if (active) point(g0, g1, g2);
  __syncthreads();
  // the transposes: Dc^T on each component along its axis, the sum, S^T along z, y, x
  if (active) {
    hn::sweep_line<T, N, 0, true>(g0, g0, sD, j);
    hn::sweep_line<T, N, 1, true>(g1, g1, sD, j);
    hn::sweep_line<T, N, 2, true>(g2, g2, sD, j);
  }
  __syncthreads();
  if (active) sum_sweep_z<T, N>(g0, g1, g2, cell, sS, j);
  __syncthreads();
  if (active) hn::sweep_line<T, N, 1, true>(cell, cell, sS, j);
  __syncthreads();
  if (active) hn::sweep_line<T, N, 0, true>(cell, cell, sS, j);
  __syncthreads();
}

// ---- 2-D (cell_laplace's dim=2 instances; the 3-D forms above are unchanged) ---------------
// A cell's N^2 values (x fastest) in `cell`, its two gradient components in g0, g1; thread j of
// the cell handles line j (0 .. N-1) of each sweep (hanging_nodes.cuh's 2-D convention) and, at
// the point step, the points j + k N (k = 0 .. N-1): line j along y.

// g <- G_q g at point q: the packed upper triangle (xx, xy, yy) of w detJ J^-1 J^-T
// (mapping.py: np.triu_indices(2)), its three values m in device memory
template <typename T>
__device__ __forceinline__ void metric_point2(const T* __restrict__ m, T* g0, T* g1, int q) {
  const T x = g0[q], y = g1[q];
  const T m0 = __ldg(m + 0), m1 = __ldg(m + 1), m2 = __ldg(m + 2);
  g0[q] = m0 * x + m1 * y;
  g1[q] = m1 * x + m2 * y;
}

// the metric on the N points of line j (j + k N) of a cell whose metric is geo [N^2][3]
template <typename T, int N>
__device__ __forceinline__ void metric_line2(const T* __restrict__ geo, T* g0, T* g1, int j) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int q = j + k * N;
    metric_point2(geo + q * 3, g0, g1, q);
  }
}

// The 2-D Laplace of the cells of a block, as laplace_cells: S along x, y; Dc along x into g0,
// along y into g1; `point(g0, g1)` on the line's points; Dc^T on each along its axis, their sum
// with S^T along y, S^T along x, into `cell`. 7 barriers, the last after the results are in
// place; the values must be in place before the call.
template <typename T, int N, typename Point>
__device__ __forceinline__ void laplace_cells2(T* cell, T* g0, T* g1, const T* sS, const T* sD,
                                               int j, bool active, Point point) {
  if (active) hn::sweep_line2<T, N, 0, false>(cell, cell, sS, j);
  __syncthreads();
  if (active) hn::sweep_line2<T, N, 1, false>(cell, cell, sS, j);
  __syncthreads();
  if (active) {
    hn::sweep_line2<T, N, 0, false>(cell, g0, sD, j);
    hn::sweep_line2<T, N, 1, false>(cell, g1, sD, j);
  }
  __syncthreads();
  if (active) point(g0, g1);
  __syncthreads();
  if (active) {
    hn::sweep_line2<T, N, 0, true>(g0, g0, sD, j);
    hn::sweep_line2<T, N, 1, true>(g1, g1, sD, j);
  }
  __syncthreads();
  if (active) hn::sum_sweep_y2<T, N>(g0, g1, cell, sS, j);
  __syncthreads();
  if (active) hn::sweep_line2<T, N, 0, true>(cell, cell, sS, j);
  __syncthreads();
}

// The 2-D deformed brick kernels' cell groups (brick_deformed's and cell_apply's, hn_cell's
// rows): G cells a group, a divisor of a brick's B^2 cells (B = 16 at p <= 3, 8 at p = 4..6),
// one line of a cell a thread, 128-256 lines.
template <int P>
struct Cells2 {
  static constexpr int N = P + 1;
  static constexpr int NL = N * N;
  static constexpr int G = P == 1 ? 128 : P <= 3 ? 64 : 32;
  static constexpr int THREADS = (G * N + 31) / 32 * 32;
};

// S and Dc ([N][N] each, device memory) into shared memory; the caller's barrier follows
template <typename T, int N>
__device__ __forceinline__ void stage_factors(T* sS, T* sD, const T* __restrict__ S,
                                              const T* __restrict__ Dc) {
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    sS[i] = __ldg(S + i);
    sD[i] = __ldg(Dc + i);
  }
}

}  // namespace lq
