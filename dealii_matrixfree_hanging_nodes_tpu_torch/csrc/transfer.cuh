// The GMG transfers' embedding sweeps, shared by cell_transfer.cu and brick_transfer.cu. A group
// of cells sits in shared memory, N^3 values a cell (N = p+1, x fastest), with each cell's
// embedding E [3][N][N] (one matrix an axis, x first; models/multigrid.py:covering_embedding):
//   forward (prolongation):  E[0] along x, then E[1] along y, then E[2] along z;
//   transposed (restriction): E[2]^T along z, then E[1]^T along y, then E[0]^T along x,
// the reference's Transfer._embed / _embed_t (models/multigrid.py:253-271). Thread j of a cell
// handles line j (0 .. N^2-1) of each sweep in place, as hanging_nodes.cuh's sweep_line does for
// the hanging-node interpolation (one barrier a sweep).

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

// the cells a block handles together: about 256 lines a sweep
template <int N>
struct Group {
  static constexpr int G = (256 / (N * N)) > 0 ? 256 / (N * N) : 1;
  static constexpr int THREADS = (G * N * N + 31) / 32 * 32;
};

}  // namespace xfer
