// hn_interp: the index engine's hanging-node interpolation on cell rows values [m, N^3], in
// place. Item i (0 .. n_items-1) works on row rows[i] (or first + i where rows is null):
//   sweeps (Q null): codes[i] the row's 9-bit mask (0: no work); for t = 0, 1, 2 (2, 1, 0
//     transposed) every masked line along t becomes P_s x (P_s^T x), hanging_nodes.cuh;
//   matrix (Q [nQ, N^3, N^3]): codes[i] the row's group (-1: no work); row <- row @ Q[g]
//     (row @ Q[g]^T transposed).
// MatrixFree's runners are these arguments: all (every row, its mask), sorted (the tail from the
// first constrained row of the mask-sorted cells), compact (the list hn_idx with its masks),
// matrix (hn_idx with each one's group).
//
// Replaces: ops/hanging_nodes.py:apply_hanging_node_constraints (dealii_matrixfree_hanging_nodes_
//   tpu/ops/hanging_nodes.py:87-154: per sweep a node mask, a batched einsum with P[sub] and a
//   where) and the runners of MatrixFree.apply_hanging_node_constraints (matrix_free.py:211-248:
//   gather hn_idx and set back; every row; the sorted tail; one dense Q per distinct mask). XLA
//   on the TPU (no Pallas kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (hn_interp.bytes_and_flops): the sweeps,
//   memory: the 16,744 constrained rows read and written once (16.7 MB, 5 us at 3.35 TB/s), the
//   codes (and rows) read once, 2 N^2 operations a masked line. The matrix runner, operations:
//   2 N^6 a row, 0.52 GFLOP (7.8 us at 67 TFLOP/s f32 outside the tensor cores).
//
// Design: a block takes G consecutive items (16 at p <= 4, 8 at p = 5, 6, 32 at p = 1), one
//   thread a line of a cell (G N^2 threads); a block whose items all pass through returns after
//   one __syncthreads_or (the all runner's unconstrained rows cost a read of their codes). The
//   rows that change are staged in shared memory with coalesced row reads, swept in place with
//   a barrier a sweep (P in shared memory, read by every thread of a warp at once), and written
//   back; the matrix runner multiplies each row by its Q from device memory (25 Q's of 62.5 KB
//   at p=4 f32, resident in L2). Each row is written by its block alone: no atomics.

#include <cuda_runtime.h>

#include <cstddef>

#include "hanging_nodes.cuh"

namespace {

// The matrix runner on the cells of a block: cell <- cell @ Q[group] (cell @ Q[group]^T when
// tr), Q [nQ][N^3][N^3] row-major in device memory (hn_composite_matrix: forward(u) = u @ Q).
// Thread j of a cell computes outputs j, j + N^2, ... into tmp, then copies them back after a
// barrier. Every thread of the block calls it.
template <typename T, int N>
__device__ __forceinline__ void matrix_cells(T* cell, T* tmp, const T* __restrict__ Q, int group,
                                             int j, bool work, bool tr) {
  constexpr int N2 = N * N, NL = N2 * N;
  if (work) {
    const T* q = Q + static_cast<size_t>(group) * NL * NL;
    for (int i = j; i < NL; i += N2) {
      T acc = T(0);
      if (tr) {
        for (int m = 0; m < NL; ++m) acc += cell[m] * __ldg(q + i * NL + m);
      } else {
        for (int m = 0; m < NL; ++m) acc += cell[m] * __ldg(q + m * NL + i);
      }
      tmp[i] = acc;
    }
  }
  __syncthreads();
  if (work) {
    for (int i = j; i < NL; i += N2) cell[i] = tmp[i];
  }
  __syncthreads();
}

template <typename T>
struct Args {
  T* values;
  const int* rows;   // may be null
  const int* codes;
  const T* P;        // [2][N][N]
  const T* Q;        // [nQ][N^3][N^3] or null
};

template <typename T, int P>
__global__ void __launch_bounds__(hn::Cfg<P>::THREADS)
hn_interp_kernel(const Args<T> a, int n_items, int first, int transpose) {
  using C = hn::Cfg<P>;
  constexpr int N = C::N, N2 = C::N2, NL = C::NL, G = C::G;
  __shared__ T sP[2 * N * N];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cells = reinterpret_cast<T*>(smem_raw);
  T* tmp = cells + G * NL;
  const bool matrix = a.Q != nullptr;
  const int item0 = blockIdx.x * G;
  for (int i = threadIdx.x; i < 2 * N * N; i += blockDim.x) sP[i] = a.P[i];

  const int l = threadIdx.x, g = l / N2, j = l - g * N2, item = item0 + g;
  const bool active = l < G * N2 && item < n_items;
  const int code = active ? __ldg(a.codes + item) : (matrix ? -1 : 0);
  const bool work = active && (matrix ? code >= 0 : code != 0);
  if (!__syncthreads_or(work)) return;

  auto row_of = [&](int it) -> size_t {
    return static_cast<size_t>(a.rows ? __ldg(a.rows + it) : first + it) * NL;
  };
  auto changes = [&](int it) {
    const int c = __ldg(a.codes + it);
    return matrix ? c >= 0 : c != 0;
  };
  for (int idx = threadIdx.x; idx < G * NL; idx += blockDim.x) {
    const int it = item0 + idx / NL;
    if (it < n_items && changes(it)) cells[idx] = a.values[row_of(it) + idx % NL];
  }
  __syncthreads();
  T* cell = cells + g * NL;
  if (matrix) {
    matrix_cells<T, N>(cell, tmp + g * NL, a.Q, code, j, work, transpose != 0);
  } else if (transpose) {
    hn::interp_cells<T, N, true>(cell, sP, code, j, work);
  } else {
    hn::interp_cells<T, N, false>(cell, sP, code, j, work);
  }
  for (int idx = threadIdx.x; idx < G * NL; idx += blockDim.x) {
    const int it = item0 + idx / NL;
    if (it < n_items && changes(it)) a.values[row_of(it) + idx % NL] = cells[idx];
  }
}

template <typename T, int P>
int launch(const Args<T>& a, int n_items, int first, int transpose, cudaStream_t stream) {
  using C = hn::Cfg<P>;
  const int smem = static_cast<int>(2 * C::G * C::NL * sizeof(T));
  const int blocks = (n_items + C::G - 1) / C::G;
  if (blocks > 0) {
    hn_interp_kernel<T, P><<<blocks, C::THREADS, smem, stream>>>(a, n_items, first, transpose);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* const* p, int n_items, int first, int degree, int transpose,
             cudaStream_t stream) {
  const Args<T> a{static_cast<T*>(const_cast<void*>(p[0])), static_cast<const int*>(p[1]),
                  static_cast<const int*>(p[2]), static_cast<const T*>(p[3]),
                  static_cast<const T*>(p[4])};
  switch (degree) {
    case 1: return launch<T, 1>(a, n_items, first, transpose, stream);
    case 2: return launch<T, 2>(a, n_items, first, transpose, stream);
    case 3: return launch<T, 3>(a, n_items, first, transpose, stream);
    case 4: return launch<T, 4>(a, n_items, first, transpose, stream);
    case 5: return launch<T, 5>(a, n_items, first, transpose, stream);
    case 6: return launch<T, 6>(a, n_items, first, transpose, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int hn_interp_f32(const void* const* ptrs, int n_items, int first, int degree, int transpose,
                  void* stream) {
  return dispatch<float>(ptrs, n_items, first, degree, transpose,
                         static_cast<cudaStream_t>(stream));
}

int hn_interp_f64(const void* const* ptrs, int n_items, int first, int degree, int transpose,
                  void* stream) {
  return dispatch<double>(ptrs, n_items, first, degree, transpose,
                          static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
