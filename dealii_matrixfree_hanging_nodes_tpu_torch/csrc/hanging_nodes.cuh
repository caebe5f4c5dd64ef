// The index engine's per-cell line work, shared by hn_interp.cu and cell_laplace.cu (and the
// other kernels that sweep cell lines): a group of cells sits in shared memory, N^3 values a
// cell (N = p+1, x fastest: node (ix, iy, iz) at ix + N iy + N^2 iz), and thread j of a cell
// handles line j (0 .. N^2-1) along the axis t of a sweep: its two other coordinates (axes
// a < b) are j % N and j / N, its nodes stride N^t apart. A thread reads its whole line into
// registers before it writes the line back, and no other thread touches that line in the
// sweep, so a sweep works in place with one barrier after it.
//
// The hanging-node interpolation (the reference's ops/hanging_nodes.py:87-154): the 9-bit mask
// holds the subcell bits (0-2), the constrained faces (3-5) and edges (6-8). Sweep t replaces
// the nodes on a constrained face with normal d != t (coordinate d at the constrained side
// sub_d * p) and on a constrained edge along t (both other coordinates at their sides). That
// set depends only on the coordinates other than t, so a line along t is replaced whole (by
// P_{sub_t} x, or P_{sub_t}^T x transposed) or not at all. The 2-D forms (N^2 values a cell,
// N lines a sweep, no edges) follow the 3-D ones below, and Shape / interp_cells_d pick either.

#pragma once

#include <cuda_runtime.h>

namespace hn {

template <int N, int t>
struct Axes {
  static constexpr int a = t == 0 ? 1 : 0;  // the two other axes, a < b
  static constexpr int b = t == 2 ? 1 : 2;
  static constexpr int SA = a == 0 ? 1 : N;  // their strides (a is 0 or 1, b is 1 or 2)
  static constexpr int SB = b == 1 ? N : N * N;
  static constexpr int S = t == 0 ? 1 : t == 1 ? N : N * N;
};

// line j along t: its other two coordinates and its first node
template <int N, int t>
__device__ __forceinline__ int line_base(int j, int& ca, int& cb) {
  using A = Axes<N, t>;
  ca = j % N;
  cb = j / N;
  return ca * A::SA + cb * A::SB;
}

// out line = M in line (M [q][i], row-major N x N), or M^T in line when TR; in == out allowed
template <typename T, int N, int t, bool TR>
__device__ __forceinline__ void sweep_line(const T* in, T* out, const T* M, int j) {
  int ca, cb;
  const int base = line_base<N, t>(j, ca, cb);
  constexpr int S = Axes<N, t>::S;
  T r[N];
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = in[base + k * S];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) acc += (TR ? M[k * N + i] : M[i * N + k]) * r[k];
    out[base + i * S] = acc;
  }
}

// is line (ca, cb) along t replaced under mask?
template <int N, int t>
__device__ __forceinline__ bool line_masked(int mask, int ca, int cb) {
  using A = Axes<N, t>;
  constexpr int P = N - 1;
  const bool on_a = ca == ((mask >> A::a) & 1) * P;
  const bool on_b = cb == ((mask >> A::b) & 1) * P;
  return (((mask >> (3 + A::a)) & 1) && on_a) || (((mask >> (3 + A::b)) & 1) && on_b) ||
         (((mask >> (6 + t)) & 1) && on_a && on_b);
}

// sweep t of the interpolation on line j of one cell (P2: [2][N][N], the two subface matrices)
template <typename T, int N, int t, bool TR>
__device__ __forceinline__ void interp_line(T* cell, const T* P2, int mask, int j) {
  int ca, cb;
  line_base<N, t>(j, ca, cb);
  if (line_masked<N, t>(mask, ca, cb)) {
    sweep_line<T, N, t, TR>(cell, cell, P2 + ((mask >> t) & 1) * N * N, j);
  }
}

// The three sweeps on the cells of a block (t = 0, 1, 2; transposed 2, 1, 0). Every thread of
// the block calls it (it holds the barriers); a thread with work handles line j of `cell`.
template <typename T, int N, bool TR>
__device__ __forceinline__ void interp_cells(T* cell, const T* P2, int mask, int j, bool work) {
  if (TR) {
    if (work) interp_line<T, N, 2, true>(cell, P2, mask, j);
    __syncthreads();
    if (work) interp_line<T, N, 1, true>(cell, P2, mask, j);
    __syncthreads();
    if (work) interp_line<T, N, 0, true>(cell, P2, mask, j);
    __syncthreads();
  } else {
    if (work) interp_line<T, N, 0, false>(cell, P2, mask, j);
    __syncthreads();
    if (work) interp_line<T, N, 1, false>(cell, P2, mask, j);
    __syncthreads();
    if (work) interp_line<T, N, 2, false>(cell, P2, mask, j);
    __syncthreads();
  }
}

// cells per block and threads per block: one line a thread, G N^2 lines
template <int P>
struct Cfg {
  static constexpr int N = P + 1;
  static constexpr int N2 = N * N;
  static constexpr int NL = N2 * N;
  static constexpr int G = P == 1 ? 32 : P <= 4 ? 16 : 8;
  static constexpr int THREADS = (G * N2 + 31) / 32 * 32;
};

// ---- 2-D ---------------------------------------------------------------------------------
// A cell holds N^2 values (node (ix, iy) at ix + N iy), and thread j of a cell handles line j
// (0 .. N-1) along the axis t of a sweep: its other coordinate (axis a = 1 - t) is j, its nodes
// stride N^t apart. The 2-D mask holds the subcell bits 0-1 and the constrained faces 2-3, and
// no edge bits (the reference's constraints.py:47-53, ops/hanging_nodes.py:123-154 with edge
// None): sweep t replaces the line whose other coordinate sits at the constrained side
// sub_a * p of a constrained face with normal a. A 3-D decoder would read face bit 2 as a sub
// bit; these functions read the 2-D layout only.

template <int N, int t>
struct Axes2 {
  static constexpr int a = 1 - t;             // the other axis
  static constexpr int SA = a == 0 ? 1 : N;   // its stride
  static constexpr int S = t == 0 ? 1 : N;    // the stride along the line
};

// out line = M in line (M [q][i], row-major N x N), or M^T in line when TR; in == out allowed
template <typename T, int N, int t, bool TR>
__device__ __forceinline__ void sweep_line2(const T* in, T* out, const T* M, int j) {
  const int base = j * Axes2<N, t>::SA;
  constexpr int S = Axes2<N, t>::S;
  T r[N];
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = in[base + k * S];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) acc += (TR ? M[k * N + i] : M[i * N + k]) * r[k];
    out[base + i * S] = acc;
  }
}

// transposed y sweep of the sum of two lines (line j along y), into out (may be one of them)
template <typename T, int N>
__device__ __forceinline__ void sum_sweep_y2(const T* g0, const T* g1, T* out, const T* M,
                                             int j) {
  T r[N];
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = g0[j + k * N] + g1[j + k * N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) acc += M[k * N + i] * r[k];
    out[j + i * N] = acc;
  }
}

// is line j (other coordinate j) along t replaced under a 2-D mask?
template <int N, int t>
__device__ __forceinline__ bool line_masked2(int mask, int j) {
  constexpr int a = Axes2<N, t>::a;
  return ((mask >> (2 + a)) & 1) && j == ((mask >> a) & 1) * (N - 1);
}

// sweep t of the 2-D interpolation on line j of one cell (P2: [2][N][N])
template <typename T, int N, int t, bool TR>
__device__ __forceinline__ void interp_line2(T* cell, const T* P2, int mask, int j) {
  if (line_masked2<N, t>(mask, j)) {
    sweep_line2<T, N, t, TR>(cell, cell, P2 + ((mask >> t) & 1) * N * N, j);
  }
}

// The two sweeps on the cells of a block (t = 0, 1; transposed 1, 0), as interp_cells
template <typename T, int N, bool TR>
__device__ __forceinline__ void interp_cells2(T* cell, const T* P2, int mask, int j, bool work) {
  if (TR) {
    if (work) interp_line2<T, N, 1, true>(cell, P2, mask, j);
    __syncthreads();
    if (work) interp_line2<T, N, 0, true>(cell, P2, mask, j);
    __syncthreads();
  } else {
    if (work) interp_line2<T, N, 0, false>(cell, P2, mask, j);
    __syncthreads();
    if (work) interp_line2<T, N, 1, false>(cell, P2, mask, j);
    __syncthreads();
  }
}

// ---- either dimension ----------------------------------------------------------------------
// A block's shape in DIM dimensions: LINES lines of N values a cell along each axis (N^2 in
// 3-D, N in 2-D), NL values a cell, G cells, one line a thread. The 3-D shape is Cfg's; a 2-D
// cell has only N lines, so a block takes G = 256 / N cells (at least 128 threads: 128 cells
// at p=1, 51 at p=4, 36 at p=6).
template <int DIM, int P>
struct Shape {
  static_assert(DIM == 2 || DIM == 3, "2-D or 3-D cells");
  static constexpr int N = P + 1;
  static constexpr int LINES = DIM == 3 ? N * N : N;
  static constexpr int NL = LINES * N;
  static constexpr int G = DIM == 3 ? Cfg<P>::G : 256 / N;
  static constexpr int THREADS = (G * LINES + 31) / 32 * 32;
};

// the interpolation's sweeps in DIM dimensions (interp_cells or interp_cells2)
template <typename T, int DIM, int N, bool TR>
__device__ __forceinline__ void interp_cells_d(T* cell, const T* P2, int mask, int j,
                                               bool work) {
  if constexpr (DIM == 3) {
    interp_cells<T, N, TR>(cell, P2, mask, j, work);
  } else {
    interp_cells2<T, N, TR>(cell, P2, mask, j, work);
  }
}

}  // namespace hn
