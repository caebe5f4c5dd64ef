// The GMG transfers' embedding sweeps, shared by cell_transfer.cu and brick_transfer.cu. A group
// of cells sits in shared memory, N^3 values a cell (N = p+1, x fastest), with each cell's
// embedding E [3][N][N] (one matrix an axis, x first; models/multigrid.py:covering_embedding):
//   forward (prolongation):  E[0] along x, then E[1] along y, then E[2] along z;
//   transposed (restriction): E[2]^T along z, then E[1]^T along y, then E[0]^T along x,
// the reference's Transfer._embed / _embed_t (models/multigrid.py:253-271). Thread j of a cell
// handles line j (0 .. N^2-1) of each sweep in place, as hanging_nodes.cuh's sweep_line does for
// the hanging-node interpolation (one barrier a sweep). embed_sweeps2 is the 2-D form
// (cell_transfer's dim=2 instances). cell_transfer's restrict takes whole families a block
// (Families, below); brick_transfer sweeps any number of cells a block, several lines a
// thread (embed_rows_from, embed_rows_t, below).

#pragma once

#include <cuda_runtime.h>

#include "hanging_nodes.cuh"

namespace xfer {

// The three sweeps on the cells of a block. Every thread of the block calls it (it holds the
// barriers); a thread with `active` set handles line j of `cell` with the cell's E.
template <typename T, int N, bool TR>
__device__ __forceinline__ void embed_sweeps(T* cell, const T* E, int j, bool active) {
  constexpr int NN = N * N;
  if (!TR) {
    if (active) hn::sweep_line<T, N, 0, false>(cell, cell, E, j);
    __syncthreads();
    if (active) hn::sweep_line<T, N, 1, false>(cell, cell, E + NN, j);
    __syncthreads();
    if (active) hn::sweep_line<T, N, 2, false>(cell, cell, E + 2 * NN, j);
    __syncthreads();
  } else {
    if (active) hn::sweep_line<T, N, 2, true>(cell, cell, E + 2 * NN, j);
    __syncthreads();
    if (active) hn::sweep_line<T, N, 1, true>(cell, cell, E + NN, j);
    __syncthreads();
    if (active) hn::sweep_line<T, N, 0, true>(cell, cell, E, j);
    __syncthreads();
  }
}

// The two sweeps in 2-D (N^2 values a cell, E [2][N][N], thread j on line j of N:
// hanging_nodes.cuh's 2-D convention): E[0] along x then E[1] along y; transposed E[1]^T along
// y then E[0]^T along x.
template <typename T, int N, bool TR>
__device__ __forceinline__ void embed_sweeps2(T* cell, const T* E, int j, bool active) {
  constexpr int NN = N * N;
  if (!TR) {
    if (active) hn::sweep_line2<T, N, 0, false>(cell, cell, E, j);
    __syncthreads();
    if (active) hn::sweep_line2<T, N, 1, false>(cell, cell, E + NN, j);
    __syncthreads();
  } else {
    if (active) hn::sweep_line2<T, N, 1, true>(cell, cell, E + NN, j);
    __syncthreads();
    if (active) hn::sweep_line2<T, N, 0, true>(cell, cell, E, j);
    __syncthreads();
  }
}

// the cells a block handles together: about 256 lines a sweep (N^2 lines a cell in 3-D, N in
// 2-D)
template <int N, int DIM = 3>
struct Group {
  static constexpr int LINES = DIM == 3 ? N * N : N;
  static constexpr int G = (256 / LINES) > 0 ? 256 / LINES : 1;
  static constexpr int THREADS = (G * LINES + 31) / 32 * 32;
};

// ---- whole families (cell_transfer) --------------------------------------------------------
// A block of cell_transfer's restrict takes whole families: coarse cells with all their fine
// children (1, or 2^DIM where the coarse cell is refined). Its line budget is the most refined
// families within 256 lines, at least one (3-D p=4: 200 lines, 224 threads; p=5: 288; p=6:
// 392, 416 threads: such a block takes more threads, one a line, not two rounds; 2-D p=4: 12
// families, 240 lines). MAXF fine cells at most a block (the host schedule,
// cell_transfer.schedule, packs by the same numbers).
template <int N, int DIM>
struct Families {
  static constexpr int LINES = DIM == 3 ? N * N : N;
  static constexpr int FAMILY = (1 << DIM) * LINES;
  static constexpr int BUDGET = FAMILY * (256 / FAMILY > 1 ? 256 / FAMILY : 1);
  static constexpr int MAXF = BUDGET / LINES;
  static constexpr int THREADS = (MAXF * LINES + 31) / 32 * 32;
};

// ---- any number of cells a block (brick_transfer) ------------------------------------------
// Sweep t (TR: transposed) on `rows` cells of a block in either dimension, the lines dealt out
// to the THREADS threads in turn (thread i takes lines i, i + THREADS, ...), then one barrier.
// Cell k sits at buf + k NL with its E at e + k EL (EL = DIM N^2). With src, line j of cell k is
// read from cell slot[k] of src (its parent, which several cells may share) and written into
// buf; without, the sweep works in place. Each line goes through hn::sweep_line(2) as in
// embed_sweeps, so a cell's values are the same bits.
template <typename T, int DIM, int N, int t, bool TR, int THREADS>
__device__ __forceinline__ void sweep_rows(const T* src, const int* slot, T* buf, const T* e,
                                           int rows) {
  constexpr int LINES = DIM == 3 ? N * N : N, NL = LINES * N, NN = N * N, EL = DIM * NN;
  for (int i = threadIdx.x; i < rows * LINES; i += THREADS) {
    const int k = i / LINES, j = i - k * LINES;
    const T* in = src ? src + slot[k] * NL : buf + k * NL;
    if constexpr (DIM == 3) {
      hn::sweep_line<T, N, t, TR>(in, buf + k * NL, e + k * EL + t * NN, j);
    } else {
      hn::sweep_line2<T, N, t, TR>(in, buf + k * NL, e + k * EL + t * NN, j);
    }
  }
  __syncthreads();
}

// prolongation: E[0] along x from the parents into buf, then E[1] along y (then E[2] along z)
template <typename T, int DIM, int N, int THREADS>
__device__ __forceinline__ void embed_rows_from(const T* src, const int* slot, T* buf,
                                                const T* e, int rows) {
  sweep_rows<T, DIM, N, 0, false, THREADS>(src, slot, buf, e, rows);
  sweep_rows<T, DIM, N, 1, false, THREADS>(nullptr, nullptr, buf, e, rows);
  if constexpr (DIM == 3) sweep_rows<T, DIM, N, 2, false, THREADS>(nullptr, nullptr, buf, e, rows);
}

// restriction: (E[2]^T along z, then) E[1]^T along y, then E[0]^T along x, in place
template <typename T, int DIM, int N, int THREADS>
__device__ __forceinline__ void embed_rows_t(T* buf, const T* e, int rows) {
  if constexpr (DIM == 3) sweep_rows<T, DIM, N, 2, true, THREADS>(nullptr, nullptr, buf, e, rows);
  sweep_rows<T, DIM, N, 1, true, THREADS>(nullptr, nullptr, buf, e, rows);
  sweep_rows<T, DIM, N, 0, true, THREADS>(nullptr, nullptr, buf, e, rows);
}

}  // namespace xfer
