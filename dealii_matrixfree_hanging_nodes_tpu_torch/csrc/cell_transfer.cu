// cell_transfer: the index engine's GMG transfer between two levels of global coarsening, on cell
// rows of N^DIM values (N = p+1, x fastest; DIM 3 or 2). Fine cell f is covered by the coarse
// cell cover[f] and embeds it with E[f] [DIM][N][N]; own[f][j] marks the one owner (f, j) of each
// fine DoF.
//   prolongate: x the coarse rows [n_c][N^DIM] (read_dof_values of the coarse vector), out the fine
//     DoF vector [n_fine_dofs]: u_f = sweeps of E[f] on x[cover[f]]; out[cdf[f][j]] = u_f[j]
//     where own[f][j]. Every fine DoF has one owner, so every entry is written once.
//   restrict: x the fine DoF vector, out the coarse rows [n_c][N^DIM]: row c = the sum over its
//     fine cells child[child_ptr[c] .. child_ptr[c+1]] (ascending) of the transposed sweeps of
//     own[f] * x[cdf[f]]; a coarse cell without children gets 0.
//
// Replaces: Transfer.prolongate and Transfer.restrict (dealii_matrixfree_hanging_nodes_tpu/
//   models/multigrid.py:274-296): the cover gather, the _embed / _embed_t einsums (253-271),
//   .at[cdf].add and .at[cover].add; XLA on the TPU (no Pallas kernel).
//
// Bound on an H100 SXM (cell_transfer.bytes_and_flops): memory. x read once, out written once,
//   E (DIM N^2 values a fine cell), cdf (int32) and own (a bit a slot) read once; the DIM sweeps
//   (2 DIM N^(DIM+1) flops a fine cell) are small beside those bytes; the same holds for the
//   dim=2 instances (chip_smoke phase 14 prints both at the 2-D GMG's finest transfer).
//
// Design: one thread a line of a cell, G cells a block (transfer.cuh: about 256 lines; in 2-D,
//   N lines a cell, 256 / N cells), the cells and their E in shared memory, the sweeps in place
//   (transfer.cuh: embed_sweeps, embed_sweeps2 in 2-D). Prolongate: a block
//   takes G fine cells, gathers their coarse rows (row reads, coalesced) and writes its owned
//   slots straight into out (one writer a DoF: no atomics, no memset). Restrict: a block takes G
//   coarse cells and walks their children in step (child i of every cell at once, up to the
//   block's largest count); each thread keeps its x-line of the cell's sum in registers, adding
//   the children in ascending order, and writes the row once at the end. Fixed order, no
//   atomics: two calls give the same bits.

#include <cuda_runtime.h>

#include <cstddef>

#include "transfer.cuh"

namespace {

// the embedding sweeps in DIM dimensions
template <typename T, int DIM, int N, bool TR>
__device__ __forceinline__ void sweeps(T* cell, const T* E, int j, bool active) {
  if constexpr (DIM == 3) {
    xfer::embed_sweeps<T, N, TR>(cell, E, j, active);
  } else {
    xfer::embed_sweeps2<T, N, TR>(cell, E, j, active);
  }
}

template <typename T, int DIM, int P, bool RESTRICT>
__global__ void __launch_bounds__(xfer::Group<P + 1, DIM>::THREADS)
cell_transfer_kernel(const T* __restrict__ x, const T* __restrict__ E, const int* __restrict__ cdf,
                     const unsigned char* __restrict__ own, const int* __restrict__ cover,
                     const int* __restrict__ child_ptr, const int* __restrict__ child,
                     T* __restrict__ out, int n_f, int n_c) {
  using Gr = xfer::Group<P + 1, DIM>;
  constexpr int N = P + 1, NN = Gr::LINES, NL = NN * N, EL = DIM * N * N;
  constexpr int G = Gr::G, THREADS = Gr::THREADS;
  __shared__ T buf[G * NL];
  __shared__ T e[G * EL];
  const int tid = threadIdx.x;
  const int k = min(tid / NN, G - 1), j = tid - (tid / NN) * NN;

  if (!RESTRICT) {
    const int f0 = blockIdx.x * G;
    const int ng = min(G, n_f - f0);
    for (int t = tid; t < G * NL; t += THREADS) {
      const int c = t / NL;
      buf[t] = c < ng ? x[static_cast<size_t>(cover[f0 + c]) * NL + (t - c * NL)] : T(0);
    }
    for (int t = tid; t < G * EL; t += THREADS) {
      e[t] = t < ng * EL ? E[static_cast<size_t>(f0) * EL + t] : T(0);
    }
    __syncthreads();
    sweeps<T, DIM, N, false>(buf + k * NL, e + k * EL, j, tid < ng * NN);
    for (int t = tid; t < ng * NL; t += THREADS) {
      const size_t s = static_cast<size_t>(f0) * NL + t;
      if (own[s]) out[cdf[s]] = buf[t];
    }
    return;
  }

  __shared__ int s_ptr[G + 1];
  __shared__ int s_max;
  const int c0 = blockIdx.x * G;
  const int ng = min(G, n_c - c0);
  if (tid <= ng) s_ptr[tid] = child_ptr[c0 + tid];
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int c = 0; c < ng; ++c) m = max(m, s_ptr[c + 1] - s_ptr[c]);
    s_max = m;
  }
  __syncthreads();
  const bool line = tid < ng * NN;
  const int cnt = line ? s_ptr[k + 1] - s_ptr[k] : 0;
  const int base = j * N;  // this thread's x-line after the sweeps (line_base<N, 0> in 3-D)
  T acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = T(0);
  for (int i = 0; i < s_max; ++i) {
    for (int t = tid; t < G * NL; t += THREADS) {
      const int c = t / NL;
      T v = T(0);
      if (c < ng && i < s_ptr[c + 1] - s_ptr[c]) {
        const size_t s = static_cast<size_t>(child[s_ptr[c] + i]) * NL + (t - c * NL);
        if (own[s]) v = x[cdf[s]];
      }
      buf[t] = v;
    }
    for (int t = tid; t < G * EL; t += THREADS) {
      const int c = t / EL;
      e[t] = c < ng && i < s_ptr[c + 1] - s_ptr[c]
                 ? E[static_cast<size_t>(child[s_ptr[c] + i]) * EL + (t - c * EL)]
                 : T(0);
    }
    __syncthreads();
    const bool active = line && i < cnt;
    sweeps<T, DIM, N, true>(buf + k * NL, e + k * EL, j, active);
    if (active) {
#pragma unroll
      for (int q = 0; q < N; ++q) acc[q] += buf[k * NL + base + q];
    }
    __syncthreads();
  }
  if (line) {
    T* row = out + static_cast<size_t>(c0 + k) * NL + base;
#pragma unroll
    for (int q = 0; q < N; ++q) row[q] = acc[q];
  }
}

template <typename T, int DIM, int P>
int launch(const void* const* a, void* out, int n_f, int n_c, int restrict_, cudaStream_t stream) {
  using Gr = xfer::Group<P + 1, DIM>;
  const T* x = static_cast<const T*>(a[0]);
  const T* E = static_cast<const T*>(a[1]);
  const int* cdf = static_cast<const int*>(a[2]);
  const auto* own = static_cast<const unsigned char*>(a[3]);
  const int* cover = static_cast<const int*>(a[4]);
  const int* child_ptr = static_cast<const int*>(a[5]);
  const int* child = static_cast<const int*>(a[6]);
  const int n = restrict_ ? n_c : n_f;
  const int blocks = (n + Gr::G - 1) / Gr::G;
  if (blocks > 0) {
    if (restrict_) {
      cell_transfer_kernel<T, DIM, P, true><<<blocks, Gr::THREADS, 0, stream>>>(
          x, E, cdf, own, cover, child_ptr, child, static_cast<T*>(out), n_f, n_c);
    } else {
      cell_transfer_kernel<T, DIM, P, false><<<blocks, Gr::THREADS, 0, stream>>>(
          x, E, cdf, own, cover, child_ptr, child, static_cast<T*>(out), n_f, n_c);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DIM>
int by_degree(const void* const* a, void* out, int n_f, int n_c, int p, int restrict_,
              cudaStream_t stream) {
  switch (p) {
    case 1: return launch<T, DIM, 1>(a, out, n_f, n_c, restrict_, stream);
    case 2: return launch<T, DIM, 2>(a, out, n_f, n_c, restrict_, stream);
    case 3: return launch<T, DIM, 3>(a, out, n_f, n_c, restrict_, stream);
    case 4: return launch<T, DIM, 4>(a, out, n_f, n_c, restrict_, stream);
    case 5: return launch<T, DIM, 5>(a, out, n_f, n_c, restrict_, stream);
    case 6: return launch<T, DIM, 6>(a, out, n_f, n_c, restrict_, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* const* a, void* out, int n_f, int n_c, int p, int restrict_, int dim,
             cudaStream_t stream) {
  if (dim == 3) return by_degree<T, 3>(a, out, n_f, n_c, p, restrict_, stream);
  if (dim == 2) return by_degree<T, 2>(a, out, n_f, n_c, p, restrict_, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// x, E, cdf, own, cover, child_ptr, child, out: device pointers; n_fine_dofs is checked by the
// wrapper (every fine DoF has one owner); dim: 3 or 2
int cell_transfer_f32(const void* x, const void* E, const void* cdf, const void* own,
                      const void* cover, const void* child_ptr, const void* child, void* out,
                      int n_f, int n_c, int n_fine_dofs, int p, int restrict_, int dim,
                      void* stream) {
  const void* a[7] = {x, E, cdf, own, cover, child_ptr, child};
  (void)n_fine_dofs;
  return dispatch<float>(a, out, n_f, n_c, p, restrict_, dim, static_cast<cudaStream_t>(stream));
}

int cell_transfer_f64(const void* x, const void* E, const void* cdf, const void* own,
                      const void* cover, const void* child_ptr, const void* child, void* out,
                      int n_f, int n_c, int n_fine_dofs, int p, int restrict_, int dim,
                      void* stream) {
  const void* a[7] = {x, E, cdf, own, cover, child_ptr, child};
  (void)n_fine_dofs;
  return dispatch<double>(a, out, n_f, n_c, p, restrict_, dim, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
