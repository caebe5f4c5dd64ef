// cell_laplace: the index engine's cell kernel, from a global vector src through a DoF map (or
// from cell rows, the DG path, where dofmap is null) to cell rows out [n_cells, N^DIM], N = p+1,
// DIM 3 or 2 (the dim=2 instances: N^2 values a cell, two sweeps a direction, the 2-D masks).
// For each cell, in one launch:
//   1. read src[dofmap[c]] (or the row src[c]);
//   2. with codes and flag HN_IN: the hanging-node interpolation, by the cell's mask through the
//      sweeps (hanging_nodes.cuh; mask 0: none). All four runners of MatrixFree (compact, all,
//      sorted, matrix) compute this one function, so their vmults share this one kernel;
//   3. with flag QUAD: the Laplace by sum factorization: the reference gradients at the Gauss
//      points, at each point g_d * geo[c, d] * w (Cartesian geo [n_cells, DIM], quadrature
//      weights w [N^DIM]) or the packed symmetric metric times g (DEFORMED: geo [n_cells,
//      N^DIM, 6 or 3], which holds w detJ J^-1 J^-T; xx, xy, yy in 2-D), integrated back. The
//      reference's collocation form (values by S, gradients by Dc, ops/sum_factorization.py)
//      is the plain version's; the kernel computes the same operator with D = Dc S (below);
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
//   the collocation form's 12 sweeps of 2 N^4 a cell (4.1 GFLOP, 0.061 ms at 67 TFLOP/s f32
//   outside the tensor cores). The brick engine moves neither the dofmap nor the cell rows.
//   The dim=2 instances at quadrant nref=11, p=4, f32: the distinct DoFs (16.84 M, 67 MB), the
//   dofmap (1,051,669 x 25 int32, 105 MB), geo (8.4 MB) and the rows (105 MB): ~286 MB,
//   ~0.085 ms at 3.35 TB/s; 8 sweeps of 2 N^3 a cell (2.1 GFLOP) are far below.
//
// Design: with QUAD (cell_laplace_col_kernel), the layout of Kronbichler and Ljungkvist (2019),
//   deal.II's CUDA matrix-free path, as cell_elasticity.cu's, for one component. A thread owns a
//   z-column (x, y) of a cell, N^2 threads a cell, G cells a group (Col3: G N^2 close to a
//   multiple of 32); the group's values sit in shared memory in regions of G N^3 values (kinds
//   0, 1, 2), and the operator runs in five phases (laplace_cols.cuh, shared with
//   brick_deformed.cu), a thread's lines in registers, one barrier after each:
//     z1, its column:     a = S_z u, c = D_z u                                 (kinds 0, 2)
//     x1, x-line (y, z):  a' = S_x a, b = D_x a, c' = S_x c                    (kinds 0, 1, 2)
//     y,  y-line (x, z):  the gradients S_y b, D_y a', S_y c'; the geometry at the line's N
//                         points (geo w, w folded in, or the metric read from device memory);
//                         P = D_y^T o_y, Q = S_y^T o_x, R = S_y^T o_z         (kinds 0, 1, 2)
//     x2, x-line:         T1 = D_x^T Q + S_x^T P, T2 = S_x^T R                 (kinds 0, 2)
//     z2, its column:     S_z^T T1 + D_z^T T2                                  (kind 0)
//   16 sweeps of a line where the collocation form takes 12, but 5 barriers where the earlier
//   design (a line of a cell a thread, every value in shared memory, S, Dc and w staged there
//   and read by every FMA) took 9 and 12 sweeps. S, D and their transposes ride the launch as
//   its parameters (the constant bank), each sweep even-odd (even_odd.cuh, shared with
//   cell_elasticity.cu: 13 products a sweep at p=4, not 25). A block takes one group: its
//   dofmap entries are read first, all in flight, then its src values gathered by cp.async
//   (the rows path, dofmap null, copies its rows the same way) while each thread reads its
//   weights, code and geo. 2-D (Col2): a y-column of a cell a thread, N
//   threads a cell, G = 256 / N cells a group, three phases: y1 (a = S_y u, c = D_y u), x (the
//   gradients D_x a, S_x c; the geometry; Q = D_x^T o_x, R = S_x^T o_y), y2 (S_y^T Q + D_y^T R):
//   8 sweeps, 3 barriers. The interpolation (blocks with a constrained cell only) sweeps lines in
//   shared memory with P staged there (hanging_nodes.cuh; a thread's index in its cell is the
//   line it sweeps), 3 barriers each way (2-D: 2). At quadrant nref=7 p=4 f32 on an H100 80GB
//   HBM3 at 700 W (kernel_ab.py, one process): 0.2485-0.2516 ms with the cells' codes, where
//   the earlier design took 0.5427-0.5446; deformed at nref=6 0.0647-0.0663 (0.0979-0.0990);
//   2-D nref=11 0.1504-0.1511 (0.2724-0.2736), deformed 0.2092-0.2098 (0.3283-0.3296). Tried
//   and slower in one process: two to eight groups a block with the next group's gather in
//   flight (cell_elasticity's index mode; 2-10 %), the collocation form on this layout (13
//   sweeps, 8 barriers; 6 % in 3-D), 10 cells a 3-D block (9 %). The gather and write alone
//   take 0.17 ms of the 3-D 0.25.
// Without QUAD (cell_laplace_read_kernel): one thread a line of a cell, the block's cells
//   gathered into shared memory, the interpolation's sweeps there, the rows written.
// Each row is written by its block alone and every sum runs in a fixed order: no atomics,
//   bit-identical calls. The scatter-add is dof_scatter's launch (fusing it needs a coloring or
//   atomics).

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "even_odd.cuh"
#include "hanging_nodes.cuh"
#include "laplace_cols.cuh"
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

// The read kernel (no QUAD: read_dof_values, the transposed runner of distribute_local_to_global
// and the distributed GMG's reads): one thread a line of a cell, G cells a block (hn::Shape).
// The block's cells are gathered into shared memory (the dofmap read coalesced, src gathered),
// then each interpolation asked for sweeps their lines in place (hanging_nodes.cuh; P staged in
// shared memory), and the rows are written. A block with no constrained cell skips the sweeps
// (one __syncthreads_or).
template <typename T, int DIM, int P>
__global__ void __launch_bounds__(hn::Shape<DIM, P>::THREADS)
cell_laplace_read_kernel(const Args<T> a, int n_cells, int flags) {
  using C = hn::Shape<DIM, P>;
  constexpr int N = C::N, LINES = C::LINES, NL = C::NL, G = C::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* V = reinterpret_cast<T*>(smem_raw);
  T* sP = V + G * NL;

  for (int i = threadIdx.x; i < 2 * N * N; i += blockDim.x) sP[i] = __ldg(a.P + i);
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
  if ((flags & HN_IN) && any_hn) hn::interp_cells_d<T, DIM, N, false>(cell, sP, code, j, hn_work);
  if ((flags & HN_OUT) && any_hn) hn::interp_cells_d<T, DIM, N, true>(cell, sP, code, j, hn_work);
  for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) a.out[row0 + idx] = V[idx];
}

// ---- the columns design (QUAD): a z-column (2-D: a y-column) of a cell a thread --------------
using eo::Factors;

// 3-D: N^2 threads a cell, G cells a block (G N^2 close to a multiple of 32), three regions of
// G N^3 values (kinds 0, 1, 2)
template <int P>
struct Col3 {
  static constexpr int N = P + 1, N2 = N * N, NL = N2 * N, LINES = N2;
  static constexpr int G = P == 1 ? 32 : P == 2 ? 14 : P == 3 ? 8 : P == 4 ? 5 : P == 5 ? 7 : 5;
  static constexpr int THREADS = (G * N2 + 31) / 32 * 32;
  static constexpr int R = G * NL;
  static constexpr int VALUES = 3 * R;
};

// 2-D: N threads a cell, G = 256 / N cells a block, two regions of G N^2 values (kinds 0, 1)
template <int P>
struct Col2 {
  static constexpr int N = P + 1, NL = N * N, LINES = N;
  static constexpr int G = 256 / N;
  static constexpr int THREADS = (G * N + 31) / 32 * 32;
  static constexpr int R = G * NL;
  static constexpr int VALUES = 2 * R;
};

template <int DIM, int P>
using Col = std::conditional_t<DIM == 3, Col3<P>, Col2<P>>;

// the packed symmetric metric (xx, xy, xz, yy, yz, zz; x the fastest axis) of w detJ J^-1 J^-T
// at the points m + 6 N i of a y-line (device memory), times the gradients there
template <typename T, int N>
__device__ __forceinline__ void metric3(const T* __restrict__ m, T (&gx)[N], T (&gy)[N],
                                        T (&gz)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T* mi = m + i * N * 6;
    const T m0 = __ldg(mi), m1 = __ldg(mi + 1), m2 = __ldg(mi + 2), m3 = __ldg(mi + 3),
            m4 = __ldg(mi + 4), m5 = __ldg(mi + 5);
    const T x = gx[i], y = gy[i], z = gz[i];
    gx[i] = m0 * x + m1 * y + m2 * z;
    gy[i] = m1 * x + m3 * y + m4 * z;
    gz[i] = m2 * x + m4 * y + m5 * z;
  }
}

// blocks an SM the registers must allow: in f32 up to p = 4, 1536 threads in 3-D (40 registers)
// and 2048 in 2-D (32), 768 above; 512 in f64 up to p = 4 (128), 384 above. At p = 4 f32 3-D
// 1024 threads measured 1-5 % slower and 2048 2-10 %, 2-D 1536 4-7 % slower (kernel_ab.py)
template <typename T, int DIM, int P>
constexpr int min_blocks() {
  constexpr int threads = sizeof(T) == 4 ? (P <= 4 ? (DIM == 3 ? 1536 : 2048) : 768)
                                         : (P <= 4 ? 512 : 384);
  return threads / Col<DIM, P>::THREADS > 0 ? threads / Col<DIM, P>::THREADS : 1;
}

// issue the cp.async gather of the block's cells from c0 into dst: src[dofmap] (the indices
// read first, all in flight together), or the rows src[c] (dofmap null)
template <typename T, int DIM, int P>
__device__ __forceinline__ void gather(const Args<T>& a, T* dst, int c0, int n_cells) {
  using C = Col<DIM, P>;
  constexpr int NL = C::NL;
  const int n_vals = min(C::G, n_cells - c0) * NL;
  const size_t row0 = static_cast<size_t>(c0) * NL;
  if (a.dofmap == nullptr) {
    for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) {
      eo::cp_async(dst + idx, a.src + row0 + idx);
    }
  } else {
    constexpr int K = (C::G * NL + C::THREADS - 1) / C::THREADS;
    int d[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int idx = threadIdx.x + q * C::THREADS;
      d[q] = idx < n_vals ? __ldg(a.dofmap + row0 + idx) : 0;
    }
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int idx = threadIdx.x + q * C::THREADS;
      if (idx < n_vals) eo::cp_async(dst + idx, a.src + d[q]);
    }
  }
  eo::cp_async_commit();
}

// The columns kernel (flag QUAD): gather, HN, the Laplace in five phases (2-D: three), HN^T,
// write, for the block's G cells.
template <typename T, int DIM, int P>
__global__ void __launch_bounds__(Col<DIM, P>::THREADS, (min_blocks<T, DIM, P>()))
cell_laplace_col_kernel(const Args<T> a, const Factors<T, P + 1> f, int n_cells, int flags) {
  using C = Col<DIM, P>;
  constexpr int N = C::N, NL = C::NL, G = C::G, R = C::R, LINES = C::LINES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  T* sP = buf + C::VALUES;
  const bool deformed = flags & DEFORMED;
  const bool hn_in = (flags & HN_IN) && a.codes, hn_out = (flags & HN_OUT) && a.codes;

  if (a.codes) {
    for (int i = threadIdx.x; i < 2 * N * N; i += blockDim.x) sP[i] = __ldg(a.P + i);
  }
  const int c0 = blockIdx.x * G;
  gather<T, DIM, P>(a, buf, c0, n_cells);
  const int l = threadIdx.x, g = l / LINES, j = l - g * LINES;
  const int jx = j % N, jz = j / N;  // 3-D: the column's (x, y); the y-line's (x, z)
  T wq[N];  // Cartesian: the weights at the points of the thread's y-line (2-D: x-line y = j)
  if (!deformed && l < G * LINES) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      wq[i] = DIM == 3 ? __ldg(a.w + jx + N * i + N * N * jz) : __ldg(a.w + i + N * j);
    }
  }
  const size_t row0 = static_cast<size_t>(c0) * NL;
  const int n_vals = min(G, n_cells - c0) * NL;
  const int cell = c0 + g;
  const bool active = l < G * LINES && cell < n_cells;
  const int code = (a.codes && active) ? __ldg(a.codes + cell) : 0;
  T geo[DIM] = {};  // Cartesian: the cell's factors
  if (active && !deformed) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) geo[d] = __ldg(a.geo + DIM * cell + d);
  }
  const bool hn_work = active && code != 0;
  eo::cp_async_wait<0>();
  const bool any_hn = __syncthreads_or(hn_work);  // also the barrier after the gather
  const int go = (active ? g : 0) * NL;
  T* const k0 = buf + go;
  T* const k1 = buf + R + go;

  if (hn_in && any_hn) hn::interp_cells_d<T, DIM, N, false>(k0, sP, code, j, hn_work);
  if constexpr (DIM == 3) {
    T* const k2 = buf + 2 * R + go;
    lc::laplace3<T, N, N * N>(k0 + j, k0, k1, k2, f, j, active,
                              [&](T(&gx)[N], T(&gy)[N], T(&gz)[N], int o) {
                                if (deformed) {  // the cell's metric at the points o + N i
                                  metric3<T, N>(a.geo + (static_cast<size_t>(cell) * NL + o) * 6,
                                                gx, gy, gz);
                                } else {
#pragma unroll
                                  for (int i = 0; i < N; ++i) {
                                    gx[i] = gx[i] * geo[0] * wq[i];
                                    gy[i] = gy[i] * geo[1] * wq[i];
                                    gz[i] = gz[i] * geo[2] * wq[i];
                                  }
                                }
                              });
  } else {
    lc::laplace2<T, N, N>(k0 + j, k0, k1, f, j, active, [&](T(&gx)[N], T(&gy)[N], int o) {
      if (deformed) {  // the cell's metric (xx, xy, yy) at the points N j + i
        lc::metric2<T, N>(a.geo + (static_cast<size_t>(cell) * NL + o) * 3, gx, gy);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          gx[i] = gx[i] * geo[0] * wq[i];
          gy[i] = gy[i] * geo[1] * wq[i];
        }
      }
    });
  }
  __syncthreads();
  if (hn_out && any_hn) hn::interp_cells_d<T, DIM, N, true>(k0, sP, code, j, hn_work);
  for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) a.out[row0 + idx] = buf[idx];
}

template <typename T, int DIM, int P>
int launch_col(const Args<T>& a, const double* fac, int n_cells, int flags,
               cudaStream_t stream) {
  using C = Col<DIM, P>;
  const int smem = static_cast<int>((C::VALUES + 2 * C::N * C::N) * sizeof(T));
  auto kernel = cell_laplace_col_kernel<T, DIM, P>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_cells + C::G - 1) / C::G;
  if (blocks > 0) {
    kernel<<<blocks, C::THREADS, smem, stream>>>(a, eo::factors_from<T, P + 1>(fac), n_cells,
                                                 flags);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DIM, int P>
int launch_read(const Args<T>& a, int n_cells, int flags, cudaStream_t stream) {
  using C = hn::Shape<DIM, P>;
  const int smem = static_cast<int>((C::G * C::NL + 2 * C::N * C::N) * sizeof(T));
  auto kernel = cell_laplace_read_kernel<T, DIM, P>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_cells + C::G - 1) / C::G;
  if (blocks > 0) kernel<<<blocks, C::THREADS, smem, stream>>>(a, n_cells, flags);
  return static_cast<int>(cudaGetLastError());
}

// the columns kernel with QUAD (its factors from fac), the read kernel without
template <typename T, int DIM, int P>
int launch_any(const Args<T>& a, const double* fac, int n_cells, int flags,
               cudaStream_t stream) {
  if (flags & QUAD) {
    if (fac == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_col<T, DIM, P>(a, fac, n_cells, flags, stream);
  }
  return launch_read<T, DIM, P>(a, n_cells, flags, stream);
}

template <typename T, int DIM>
int by_degree(const Args<T>& a, const double* fac, int n_cells, int degree, int flags,
              cudaStream_t stream) {
  switch (degree) {
    case 1: return launch_any<T, DIM, 1>(a, fac, n_cells, flags, stream);
    case 2: return launch_any<T, DIM, 2>(a, fac, n_cells, flags, stream);
    case 3: return launch_any<T, DIM, 3>(a, fac, n_cells, flags, stream);
    case 4: return launch_any<T, DIM, 4>(a, fac, n_cells, flags, stream);
    case 5: return launch_any<T, DIM, 5>(a, fac, n_cells, flags, stream);
    case 6: return launch_any<T, DIM, 6>(a, fac, n_cells, flags, stream);
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
  const double* fac = static_cast<const double*>(p[9]);
  if (dim == 3) return by_degree<T, 3>(a, fac, n_cells, degree, flags, stream);
  if (dim == 2) return by_degree<T, 2>(a, fac, n_cells, degree, flags, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// ptrs: src, dofmap, codes, P, S, Dc, w, geo, out (device pointers; dofmap null: src holds the
// rows; codes null: no HN), then the host float64 tables of S, D = Dc S, S^T, D^T, each its
// even-odd split (_even_odd.factor_tables; read with QUAD only, and copied into the launch's
// parameters). dim: 3 or 2 (the rows' N^dim values, the masks' layout and geo's width)
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
