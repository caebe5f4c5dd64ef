// cell_laplace: the index engine's cell kernel, from a global vector src through a DoF map (or
// from cell rows, the DG path, where dofmap is null) to cell rows out [n_cells, N^3], N = p+1.
// For each cell, in one launch:
//   1. read src[dofmap[c]] (or the row src[c]);
//   2. with codes and flag HN_IN: the hanging-node interpolation, by the cell's mask through the
//      sweeps (hanging_nodes.cuh; mask 0: none). All four runners of MatrixFree (compact, all,
//      sorted, matrix) compute this one function, so their vmults share this one kernel;
//   3. with flag QUAD: the Laplace by sum factorization in the collocation form of the
//      reference: values at the Gauss points by three sweeps of S, the reference gradient
//      component t by a sweep of Dc along t; at each point g_d * geo[c, d] * w (Cartesian geo
//      [n_cells, 3], quadrature weights w [N^3]) or the packed symmetric metric times g
//      (DEFORMED: geo [n_cells, N^3, 6], which holds w detJ J^-1 J^-T); then the transposes:
//      Dc^T along t on component t, their sum, S^T along z, y, x;
//   4. with codes and flag HN_OUT: the transposed interpolation (reversed sweeps, P^T);
//   5. write the row.
//
// Replaces: MatrixFree.read_dof_values(_plain) (dealii_matrixfree_hanging_nodes_tpu/
//   matrix_free.py:270-279: the dofmap gather and the forward runner),
//   models/laplace.py:laplace_cell_kernel (20-49; evaluate_gradients / integrate_gradients,
//   ops/sum_factorization.py:57-89) and the transposed runner of distribute_local_to_global
//   (matrix_free.py:295). XLA gathers and batched einsums on the TPU (no Pallas kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (cell_laplace.bytes_and_flops): memory. The
//   distinct DoFs the map names read once (17.55 M, 70 MB), the dofmap (269,991 x 125 int32,
//   135 MB) and geo read once, the rows written once (135 MB): ~0.10 ms at 3.35 TB/s, against
//   12 sweeps of 2 N^4 a cell (4.1 GFLOP, 0.061 ms at 67 TFLOP/s f32 outside the tensor cores).
//   The brick engine moves neither the dofmap nor the cell rows (PERF.md compares the two).
//
// Design: one thread a line of a cell, G cells a block (16 at p <= 4, 8 at p = 5, 6, 32 at p = 1;
//   G N^2 threads). The block's G cells are gathered into shared memory (the dofmap read
//   coalesced, src gathered), then every step is a sweep over the cells' lines in place in
//   shared memory, one barrier a sweep: values in V, the three gradient components in G0..G2.
//   S, Dc, P and w are staged in shared memory once a block;
//   every thread of a warp reads one factor entry at a time (a broadcast). A block with no
//   constrained cell skips the interpolation (one __syncthreads_or). Each row is written by its
//   block alone and every sum runs in a fixed order: no atomics, bit-identical calls. The
//   scatter-add is dof_scatter's launch (fusing it needs a coloring or atomics).

#include <cuda_runtime.h>

#include <cstddef>

#include "hanging_nodes.cuh"
#include "sum_factorization.cuh"

namespace {

constexpr int HN_IN = 1, QUAD = 2, HN_OUT = 4, DEFORMED = 8;

template <typename T>
struct Args {
  const T* src;
  const int* dofmap;  // [n_cells][N^3] or null (src holds the rows)
  const int* codes;   // [n_cells] masks, or null
  const T* P;         // [2][N][N]
  const T* S;         // [N][N]
  const T* Dc;        // [N][N]
  const T* w;         // [N^3]
  const T* geo;       // [n_cells][3] or [n_cells][N^3][6]
  T* out;
};

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

template <typename T, int P>
constexpr int smem_values() {
  using C = hn::Cfg<P>;
  return 4 * C::G * C::NL + 4 * C::N * C::N + C::NL;
}

template <typename T, int P>
__global__ void __launch_bounds__(hn::Cfg<P>::THREADS)
cell_laplace_kernel(const Args<T> a, int n_cells, int flags) {
  using C = hn::Cfg<P>;
  constexpr int N = C::N, N2 = C::N2, NL = C::NL, G = C::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* V = reinterpret_cast<T*>(smem_raw);
  T* G0 = V + G * NL;
  T* G1 = G0 + G * NL;
  T* G2 = G1 + G * NL;
  T* sP = G2 + G * NL;
  T* sS = sP + 2 * N * N;
  T* sD = sS + N * N;
  T* sW = sD + N * N;
  const bool quad = flags & QUAD, deformed = flags & DEFORMED;

  for (int i = threadIdx.x; i < 2 * N * N; i += blockDim.x) sP[i] = __ldg(a.P + i);
  if (quad) {
    for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
      sS[i] = __ldg(a.S + i);
      sD[i] = __ldg(a.Dc + i);
    }
    if (!deformed) {
      for (int i = threadIdx.x; i < NL; i += blockDim.x) sW[i] = __ldg(a.w + i);
    }
  }
  const int c0 = blockIdx.x * G;
  const size_t row0 = static_cast<size_t>(c0) * NL;
  const int n_vals = min(G, n_cells - c0) * NL;
  for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) {
    V[idx] = a.dofmap ? __ldg(a.src + __ldg(a.dofmap + row0 + idx)) : __ldg(a.src + row0 + idx);
  }

  const int l = threadIdx.x, g = l / N2, j = l - g * N2, c = c0 + g;
  const bool active = l < G * N2 && c < n_cells;
  const int code = (a.codes && active) ? __ldg(a.codes + c) : 0;
  const bool hn_work = active && code != 0;
  const bool any_hn = __syncthreads_or(hn_work);  // also the barrier after the gather
  T* cell = V + g * NL;

  if ((flags & HN_IN) && any_hn) hn::interp_cells<T, N, false>(cell, sP, code, j, hn_work);

  if (quad) {
    T* g0 = G0 + g * NL;
    T* g1 = G1 + g * NL;
    T* g2 = G2 + g * NL;
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
    // the geometry at each point: points j, j + N^2, ...
    if (active) {
      if (deformed) {
        const T* m = a.geo + static_cast<size_t>(c) * NL * 6;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int q = j + k * N2;
          const T* mq = m + q * 6;
          const T x = g0[q], y = g1[q], z = g2[q];
          g0[q] = __ldg(mq + 0) * x + __ldg(mq + 1) * y + __ldg(mq + 2) * z;
          g1[q] = __ldg(mq + 1) * x + __ldg(mq + 3) * y + __ldg(mq + 4) * z;
          g2[q] = __ldg(mq + 2) * x + __ldg(mq + 4) * y + __ldg(mq + 5) * z;
        }
      } else {
        const T gx = __ldg(a.geo + 3 * c), gy = __ldg(a.geo + 3 * c + 1),
                gz = __ldg(a.geo + 3 * c + 2);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int q = j + k * N2;
          g0[q] = g0[q] * gx * sW[q];
          g1[q] = g1[q] * gy * sW[q];
          g2[q] = g2[q] * gz * sW[q];
        }
      }
    }
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

  if ((flags & HN_OUT) && any_hn) hn::interp_cells<T, N, true>(cell, sP, code, j, hn_work);
  for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) a.out[row0 + idx] = V[idx];
}

template <typename T, int P>
int launch(const Args<T>& a, int n_cells, int flags, cudaStream_t stream) {
  using C = hn::Cfg<P>;
  const int smem = static_cast<int>(smem_values<T, P>() * sizeof(T));
  auto kernel = cell_laplace_kernel<T, P>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_cells + C::G - 1) / C::G;
  if (blocks > 0) kernel<<<blocks, C::THREADS, smem, stream>>>(a, n_cells, flags);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* const* p, int n_cells, int degree, int flags, cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(p[0]), static_cast<const int*>(p[1]),
                  static_cast<const int*>(p[2]), static_cast<const T*>(p[3]),
                  static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
                  static_cast<const T*>(p[6]), static_cast<const T*>(p[7]),
                  static_cast<T*>(const_cast<void*>(p[8]))};
  switch (degree) {
    case 1: return launch<T, 1>(a, n_cells, flags, stream);
    case 2: return launch<T, 2>(a, n_cells, flags, stream);
    case 3: return launch<T, 3>(a, n_cells, flags, stream);
    case 4: return launch<T, 4>(a, n_cells, flags, stream);
    case 5: return launch<T, 5>(a, n_cells, flags, stream);
    case 6: return launch<T, 6>(a, n_cells, flags, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int cell_laplace_f32(const void* const* ptrs, int n_cells, int degree, int flags, void* stream) {
  return dispatch<float>(ptrs, n_cells, degree, flags, static_cast<cudaStream_t>(stream));
}

int cell_laplace_f64(const void* const* ptrs, int n_cells, int degree, int flags, void* stream) {
  return dispatch<double>(ptrs, n_cells, degree, flags, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
