// cell_laplace: the index engine's cell kernel, from a global vector src through a DoF map (or
// from cell rows, the DG path, where dofmap is null) to cell rows out [n_cells, N^DIM], N = p+1,
// DIM 3 or 2 (the dim=2 instances: N^2 values a cell, two sweeps a direction, the 2-D masks).
// For each cell, in one launch:
//   1. read src[dofmap[c]] (or the row src[c]);
//   2. with codes and flag HN_IN: the hanging-node interpolation, by the cell's mask through the
//      sweeps (hanging_nodes.cuh; mask 0: none). All four runners of MatrixFree (compact, all,
//      sorted, matrix) compute this one function, so their vmults share this one kernel;
//   3. with flag QUAD: the Laplace by sum factorization in the collocation form of the
//      reference: values at the Gauss points by DIM sweeps of S, the reference gradient
//      component t by a sweep of Dc along t; at each point g_d * geo[c, d] * w (Cartesian geo
//      [n_cells, DIM], quadrature weights w [N^DIM]) or the packed symmetric metric times g
//      (DEFORMED: geo [n_cells, N^DIM, 6 or 3], which holds w detJ J^-1 J^-T; xx, xy, yy in
//      2-D); then the transposes: Dc^T along t on component t, their sum, S^T along z, y, x;
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
//   The dim=2 instances at quadrant nref=11, p=4, f32: the distinct DoFs (16.84 M, 67 MB), the
//   dofmap (1,051,669 x 25 int32, 105 MB), geo (8.4 MB) and the rows (105 MB): ~286 MB,
//   ~0.085 ms at 3.35 TB/s; 8 sweeps of 2 N^3 a cell (2.1 GFLOP) are far below.
//
// Design: one thread a line of a cell, G cells a block (16 at p <= 4, 8 at p = 5, 6, 32 at p = 1;
//   G N^2 threads; in 2-D a cell has N lines, so G = 256 / N cells, 128 at p = 1 and 51 at
//   p = 4, keep a block at >= 128 threads). The block's G cells are gathered into shared memory
//   (the dofmap read
//   coalesced, src gathered), then every step is a sweep over the cells' lines in place in
//   shared memory, one barrier a sweep: values in V, the gradient components in G0..G2 (G0, G1
//   in 2-D; the quadrature in laplace_quad.cuh, shared with the brick engine's deformed
//   kernels, whose 3-D forms the 2-D ones stand beside).
//   S, Dc, P and w are staged in shared memory once a block;
//   every thread of a warp reads one factor entry at a time (a broadcast). A block with no
//   constrained cell skips the interpolation (one __syncthreads_or). Each row is written by its
//   block alone and every sum runs in a fixed order: no atomics, bit-identical calls. The
//   scatter-add is dof_scatter's launch (fusing it needs a coloring or atomics).

#include <cuda_runtime.h>

#include <cstddef>

#include "laplace_quad.cuh"
#include "sum_factorization.cuh"

namespace {

constexpr int HN_IN = 1, QUAD = 2, HN_OUT = 4, DEFORMED = 8;

template <typename T>
struct Args {
  const T* src;
  const int* dofmap;  // [n_cells][N^DIM] or null (src holds the rows)
  const int* codes;   // [n_cells] masks, or null
  const T* P;         // [2][N][N]
  const T* S;         // [N][N]
  const T* Dc;        // [N][N]
  const T* w;         // [N^DIM]
  const T* geo;       // [n_cells][DIM] or [n_cells][N^DIM][DIM (DIM+1) / 2]
  T* out;
};

// the values a block keeps in shared memory: V and the DIM gradient components, P, S, Dc, w
template <typename T, int DIM, int P>
constexpr int smem_values() {
  using C = hn::Shape<DIM, P>;
  return (DIM + 1) * C::G * C::NL + 4 * C::N * C::N + C::NL;
}

template <typename T, int DIM, int P>
__global__ void __launch_bounds__(hn::Shape<DIM, P>::THREADS)
cell_laplace_kernel(const Args<T> a, int n_cells, int flags) {
  using C = hn::Shape<DIM, P>;
  constexpr int N = C::N, LINES = C::LINES, NL = C::NL, G = C::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* V = reinterpret_cast<T*>(smem_raw);
  T* G0 = V + G * NL;
  T* G1 = G0 + G * NL;
  T* sP = G0 + DIM * G * NL;  // after G0 .. G(DIM-1)
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

  const int l = threadIdx.x, g = l / LINES, j = l - g * LINES, c = c0 + g;
  const bool active = l < G * LINES && c < n_cells;
  const int code = (a.codes && active) ? __ldg(a.codes + c) : 0;
  const bool hn_work = active && code != 0;
  const bool any_hn = __syncthreads_or(hn_work);  // also the barrier after the gather
  T* cell = V + g * NL;

  if ((flags & HN_IN) && any_hn) {
    hn::interp_cells_d<T, DIM, N, false>(cell, sP, code, j, hn_work);
  }

  if constexpr (DIM == 2) {
    if (quad) {
      T* g0 = G0 + g * NL;
      T* g1 = G1 + g * NL;
      if (deformed) {  // the packed metric (xx, xy, yy) of cell c at each point
        const T* m = a.geo + static_cast<size_t>(c) * NL * 3;
        lq::laplace_cells2<T, N>(cell, g0, g1, sS, sD, j, active, [=](T* x, T* y) {
          lq::metric_line2<T, N>(m, x, y, j);
        });
      } else {  // the Cartesian factors of cell c times the weights: points j, j + N, ...
        lq::laplace_cells2<T, N>(cell, g0, g1, sS, sD, j, active, [=](T* x, T* y) {
          const T gx = __ldg(a.geo + 2 * c), gy = __ldg(a.geo + 2 * c + 1);
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const int q = j + k * N;
            x[q] = x[q] * gx * sW[q];
            y[q] = y[q] * gy * sW[q];
          }
        });
      }
    }
  } else if (quad) {
    T* G2 = G1 + G * NL;
    T* g0 = G0 + g * NL;
    T* g1 = G1 + g * NL;
    T* g2 = G2 + g * NL;
    if (deformed) {  // the packed metric of cell c at each point
      const T* m = a.geo + static_cast<size_t>(c) * NL * 6;
      lq::laplace_cells<T, N>(cell, g0, g1, g2, sS, sD, j, active, [=](T* x, T* y, T* z) {
        lq::metric_line<T, N>(m, x, y, z, j);
      });
    } else {  // the Cartesian factors of cell c times the weights: points j, j + N^2, ...
      lq::laplace_cells<T, N>(cell, g0, g1, g2, sS, sD, j, active, [=](T* x, T* y, T* z) {
        const T gx = __ldg(a.geo + 3 * c), gy = __ldg(a.geo + 3 * c + 1),
                gz = __ldg(a.geo + 3 * c + 2);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int q = j + k * LINES;
          x[q] = x[q] * gx * sW[q];
          y[q] = y[q] * gy * sW[q];
          z[q] = z[q] * gz * sW[q];
        }
      });
    }
  }

  if ((flags & HN_OUT) && any_hn) {
    hn::interp_cells_d<T, DIM, N, true>(cell, sP, code, j, hn_work);
  }
  for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) a.out[row0 + idx] = V[idx];
}

template <typename T, int DIM, int P>
int launch(const Args<T>& a, int n_cells, int flags, cudaStream_t stream) {
  using C = hn::Shape<DIM, P>;
  const int smem = static_cast<int>(smem_values<T, DIM, P>() * sizeof(T));
  auto kernel = cell_laplace_kernel<T, DIM, P>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_cells + C::G - 1) / C::G;
  if (blocks > 0) kernel<<<blocks, C::THREADS, smem, stream>>>(a, n_cells, flags);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DIM>
int by_degree(const Args<T>& a, int n_cells, int degree, int flags, cudaStream_t stream) {
  switch (degree) {
    case 1: return launch<T, DIM, 1>(a, n_cells, flags, stream);
    case 2: return launch<T, DIM, 2>(a, n_cells, flags, stream);
    case 3: return launch<T, DIM, 3>(a, n_cells, flags, stream);
    case 4: return launch<T, DIM, 4>(a, n_cells, flags, stream);
    case 5: return launch<T, DIM, 5>(a, n_cells, flags, stream);
    case 6: return launch<T, DIM, 6>(a, n_cells, flags, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* const* p, int n_cells, int degree, int flags, int dim,
             cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(p[0]), static_cast<const int*>(p[1]),
                  static_cast<const int*>(p[2]), static_cast<const T*>(p[3]),
                  static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
                  static_cast<const T*>(p[6]), static_cast<const T*>(p[7]),
                  static_cast<T*>(const_cast<void*>(p[8]))};
  if (dim == 3) return by_degree<T, 3>(a, n_cells, degree, flags, stream);
  if (dim == 2) return by_degree<T, 2>(a, n_cells, degree, flags, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dim: 3 or 2 (the rows' N^dim values, the masks' layout and geo's width)
int cell_laplace_f32(const void* const* ptrs, int n_cells, int degree, int flags, int dim,
                     void* stream) {
  return dispatch<float>(ptrs, n_cells, degree, flags, dim, static_cast<cudaStream_t>(stream));
}

int cell_laplace_f64(const void* const* ptrs, int n_cells, int degree, int flags, int dim,
                     void* stream) {
  return dispatch<double>(ptrs, n_cells, degree, flags, dim, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
