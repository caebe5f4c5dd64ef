// cell_elasticity: linear elasticity's cell operator on cell rows, out [3, n_cells, N^3] (N = p+1;
// component-major rows), a(u, v) = int 2 mu eps(u):eps(v) + lam div u div v on cube cells, in one
// launch, in one of two modes (and the index mode in 2-D, below):
//   index (dofmap given): for each cell c, read the three components src[dofmap[c, j] * 3 + comp]
//     of a global vector [n_dofs, 3] (DoF-major: the transpose to component-major rides the
//     gather); with codes, the hanging-node interpolation of each component by the
//     cell's mask (hanging_nodes.cuh; mask 0: none); the coupled operator (elasticity.cuh) with
//     the cell's geo[c, 0..2]; with codes, the transposed interpolation;
//   bricks (dofmap null): cell r is slot r % B^3 (x fastest) of brick r / B^3 of the component
//     brick vectors src + comp * cstride ([*, N3p] each; node (ix, iy, iz) of the cell at brick
//     node ((sz p + iz) NB + sy p + iy) NB + sx p + ix, NB = B p + 1), scaled by geo[r] on every
//     axis: every subset cell's geo_c Kel u_c, the reference's plain3.
// Then write the rows. The dim=2 instances (p = 1..6) write out [2, n_cells, N^2], the same steps
// on 2-D cells: the index mode reads the two components of a global vector [n_dofs, 2], the
// bricks mode the two component brick vectors of NB^2-node bricks (cell r slot r % B^2 of brick
// r / B^2, node (ix, iy) at brick node (sy p + iy) NB + sx p + ix), scaled by geo[r].
//
// Replaces: models/elasticity.py:kernel (dealii_matrixfree_hanging_nodes_tpu/models/
//   elasticity.py:44-79) with the component-wise read_dof_values(_plain) and the transposed
//   runner of distribute_local_to_global in its _vmult (81-98; the scatter-add is dof_scatter's);
//   and BrickElasticity's _extract_cols / _take_sub_multi with the el_Kel einsum
//   (models/elasticity_bricks.py:229-240; bricks.py:3373, 2178). XLA gathers and batched einsums
//   on the TPU (no Pallas kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (cell_elasticity.bytes_and_flops), index
//   mode: the distinct DoFs the map names read once (3 x 17.55 M values, 211 MB), the dofmap
//   (269,991 x 125 int32, 135 MB), codes and geo, the rows written once (3 x 135 MB = 405 MB):
//   ~0.75 GB, 0.22 ms at 3.35 TB/s; against 36 sweeps of 2 N^4 a cell and ~40 operations a
//   point (12.4 GFLOP, 0.19 ms at 67 TFLOP/s f32 outside the tensor cores). No single PyTorch
//   call computes the index mode (the gather, the per-mask interpolation and the quadrature),
//   as none computes cell_laplace. The bricks mode composed into one map from the bricks to the
//   rows is a dense coupled Kel [375, 375] a subset cell: 65,600 x 375^2 = 9.2 G nonzeros,
//   73.8 GB as CSR with f32 values and int32 indices, next to the card's 80 GB. So neither
//   mode has a library yardstick. The dim=2 index instances at quadrant nref=11, p=4, f32: the
//   DoFs twice (135 MB), the dofmap (105 MB), the rows written twice (210 MB): ~0.45 GB,
//   0.13 ms; the coupled map composed is 50^2 = 2,500 nonzeros a cell, 2.63 G in all: past
//   int32 indices, and cuSPARSE's SpMV raised an internal error on it with int64 indices
//   (31.6 GB, H100), so it has no library yardstick either.
//
// Design: cell_laplace.cu's, one thread a line of a cell, G cells a block (elasticity.cuh's Cfg:
//   32 at p = 1, 16 at p = 2, 3, 8 at p = 4, 4 at p = 5, 6, 2 at p = 7, 8), with three components
//   a cell: nine regions of G N^3 values in shared memory (elasticity.cuh), three times the
//   Laplace's a cell. S, Dc, P and the weights are staged in shared memory once a block; the
//   block's cells are gathered into U (the dofmap read once for the three components, their
//   values three neighbours in src), every step is a sweep of each component's lines in place,
//   one barrier a sweep (10 for the operator, 3 for each direction of the interpolation, skipped
//   by a block with no constrained cell). Each row is written by its block alone and every sum
//   runs in a fixed order: no atomics, bit-identical calls.
//   Resources at p=4 (ptxas, sm_90a; cell_elasticity.plan): 224 threads, 32 registers in f32
//   (40 in f64), 36.9 KB of shared memory in f32 (73.8 KB in f64): 6 blocks an SM in f32, 3 in
//   f64. No spills but 4 bytes at p=5 in f64.
//   What holds it back (1.569 ms index mode against 0.224, 0.375 ms bricks mode against 0.049 at
//   quadrant nref=7 p=4 f32, H100): the 10 + 6 barriers of a group of 8 cells, each sweep a
//   short chain of shared-memory loads and FMAs, and 8 cells a block do not hide them.
//   2-D (elasticity.cuh's Cfg2): 256 / N cells a block, one thread a line (N lines a cell),
//   four regions of G N^2 values (58 KB in f64 at p = 6), 8 barriers, 2 a direction of the
//   interpolation. The bricks mode in 2-D (the reference's 2-D el_Kel einsum on the subset's
//   cell rows, models/elasticity_bricks.py:229-240) at 2-D quadrant nref=11 p=4 f32 (517 subset
//   bricks, 33,088 rows): the bricks' nodes twice (4.5 MB), the rows twice (6.6 MB) and geo,
//   ~11 MB, 0.0034 ms; its map composed is a dense coupled [50, 50] block a row, 82.7 M
//   nonzeros.

#include <cuda_runtime.h>

#include <cstddef>

#include "elasticity.cuh"
#include "hanging_nodes.cuh"
#include "sum_factorization.cuh"

namespace {

template <typename T>
struct Args {
  const T* src;       // [n_dofs][3] (index) or component bricks at src + comp * cstride
  const int* dofmap;  // [n_cells][N^3], or null: the bricks mode
  const int* codes;   // [n_cells] masks, or null
  const T* P;         // [2][N][N] (index mode with codes)
  const T* S;         // [N][N]
  const T* Dc;        // [N][N]
  const T* w;         // [N^3]
  const T* geo;       // [n_cells][3] (index) or [n_cells] (bricks)
  T* out;             // [3][n_cells][N^3]
  T mu, lam;
  long long cstride;  // bricks: values between the components' brick vectors
  int B, N3p;         // bricks: cells a brick side, a brick's padded length
};

template <typename T, int P>
constexpr int smem_values() {
  using C = el::Cfg<P>;
  return C::VALUES + 2 * C::N * C::N + 2 * C::N * C::N + C::NL;
}

template <typename T, int P>
__global__ void __launch_bounds__(el::Cfg<P>::THREADS)
cell_elasticity_kernel(const Args<T> a, int n_cells) {
  using C = el::Cfg<P>;
  constexpr int N = C::N, N2 = C::N2, NL = C::NL, G = C::G, R = C::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  T* sP = buf + C::VALUES;
  T* sS = sP + 2 * N * N;
  T* sD = sS + N * N;
  T* sW = sD + N * N;
  __shared__ long long s_base[G];  // bricks mode: each cell's first node in a component
  const bool bricks = a.dofmap == nullptr;

  if (a.codes) {
    for (int i = threadIdx.x; i < 2 * N * N; i += blockDim.x) sP[i] = __ldg(a.P + i);
  }
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    sS[i] = __ldg(a.S + i);
    sD[i] = __ldg(a.Dc + i);
  }
  for (int i = threadIdx.x; i < NL; i += blockDim.x) sW[i] = __ldg(a.w + i);
  const int c0 = blockIdx.x * G;
  const int nrows = min(G, n_cells - c0);
  const size_t row0 = static_cast<size_t>(c0) * NL;
  const int n_vals = nrows * NL;
  if (bricks) {
    if (threadIdx.x < nrows) {
      const int cell = c0 + threadIdx.x, CB = a.B * a.B * a.B, NB = a.B * P + 1;
      const int brick = cell / CB, slot = cell - brick * CB;
      const int sx = slot % a.B, sy = (slot / a.B) % a.B, sz = slot / (a.B * a.B);
      s_base[threadIdx.x] = static_cast<long long>(brick) * a.N3p +
                            (sz * P * NB + sy * P) * NB + sx * P;
    }
    __syncthreads();
    const int NB = a.B * P + 1;
    for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) {
      const int g = idx / NL, j = idx - g * NL;
      const int ix = j % N, iy = (j / N) % N, iz = j / N2;
      const T* s = a.src + s_base[g] + (iz * NB + iy) * NB + ix;
#pragma unroll
      for (int c = 0; c < 3; ++c) buf[c * R + idx] = __ldg(s + c * a.cstride);
    }
  } else {
    for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) {
      const T* s = a.src + 3 * static_cast<size_t>(__ldg(a.dofmap + row0 + idx));
#pragma unroll
      for (int c = 0; c < 3; ++c) buf[c * R + idx] = __ldg(s + c);
    }
  }

  const int l = threadIdx.x, g = l / N2, j = l - g * N2, c = c0 + g;
  const bool active = l < G * N2 && c < n_cells;
  const int code = (a.codes && active) ? __ldg(a.codes + c) : 0;
  const bool hn_work = active && code != 0;
  const bool any_hn = __syncthreads_or(hn_work);  // also the barrier after the gather

  if (any_hn) el::interp3<T, P, false>(buf, sP, code, g, j, hn_work);
  T geo[3] = {T(0), T(0), T(0)};
  if (active) {
    if (bricks) {
      geo[0] = geo[1] = geo[2] = __ldg(a.geo + c);
    } else {
#pragma unroll
      for (int d = 0; d < 3; ++d) geo[d] = __ldg(a.geo + 3 * c + d);
    }
  }
  el::apply<T, P>(buf, sS, sD, sW, a.mu, a.lam, geo, g, j, active);
  if (any_hn) el::interp3<T, P, true>(buf, sP, code, g, j, hn_work);

#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
    T* dst = a.out + static_cast<size_t>(comp) * n_cells * NL + row0;
    for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) dst[idx] = buf[comp * R + idx];
  }
}

template <typename T, int P>
constexpr int smem_values2() {
  using C = el::Cfg2<P>;
  return C::VALUES + 2 * C::N * C::N + 2 * C::N * C::N + C::NL;
}

// 2-D: two components of N^2 values a cell; the index mode's geo [n_cells][2], the bricks
// mode's [n_cells]
template <typename T, int P>
__global__ void __launch_bounds__(el::Cfg2<P>::THREADS)
cell_elasticity2_kernel(const Args<T> a, int n_cells) {
  using C = el::Cfg2<P>;
  constexpr int N = C::N, NL = C::NL, G = C::G, R = C::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  T* sP = buf + C::VALUES;
  T* sS = sP + 2 * N * N;
  T* sD = sS + N * N;
  T* sW = sD + N * N;

  if (a.codes) {
    for (int i = threadIdx.x; i < 2 * N * N; i += blockDim.x) sP[i] = __ldg(a.P + i);
  }
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    sS[i] = __ldg(a.S + i);
    sD[i] = __ldg(a.Dc + i);
  }
  for (int i = threadIdx.x; i < NL; i += blockDim.x) sW[i] = __ldg(a.w + i);
  const int c0 = blockIdx.x * G;
  const int nrows = min(G, n_cells - c0);
  const size_t row0 = static_cast<size_t>(c0) * NL;
  const int n_vals = nrows * NL;
  __shared__ long long s_base[G];  // bricks mode: each cell's first node in a component
  const bool bricks = a.dofmap == nullptr;
  if (bricks) {
    if (threadIdx.x < nrows) {
      const int cell = c0 + threadIdx.x, CB = a.B * a.B, NB = a.B * P + 1;
      const int brick = cell / CB, slot = cell - brick * CB;
      s_base[threadIdx.x] = static_cast<long long>(brick) * a.N3p +
                            (slot / a.B) * P * NB + (slot % a.B) * P;
    }
    __syncthreads();
    const int NB = a.B * P + 1;
    for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) {
      const int g = idx / NL, j = idx - g * NL;
      const T* s = a.src + s_base[g] + (j / N) * NB + j % N;
      buf[idx] = __ldg(s);
      buf[R + idx] = __ldg(s + a.cstride);
    }
  } else {
    for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) {
      const T* s = a.src + 2 * static_cast<size_t>(__ldg(a.dofmap + row0 + idx));
      buf[idx] = __ldg(s);
      buf[R + idx] = __ldg(s + 1);
    }
  }

  const int l = threadIdx.x, g = l / N, j = l - g * N, c = c0 + g;
  const bool active = l < G * N && c < n_cells;
  const int code = (a.codes && active) ? __ldg(a.codes + c) : 0;
  const bool hn_work = active && code != 0;
  const bool any_hn = __syncthreads_or(hn_work);  // also the barrier after the gather

  if (any_hn) el::interp2<T, P, false>(buf, sP, code, g, j, hn_work);
  T geo[2] = {T(0), T(0)};
  if (active) {
    geo[0] = __ldg(a.geo + (bricks ? c : 2 * c));
    geo[1] = __ldg(a.geo + (bricks ? c : 2 * c + 1));
  }
  el::apply2<T, P>(buf, sS, sD, sW, a.mu, a.lam, geo, g, j, active);
  if (any_hn) el::interp2<T, P, true>(buf, sP, code, g, j, hn_work);

#pragma unroll
  for (int comp = 0; comp < 2; ++comp) {
    T* dst = a.out + static_cast<size_t>(comp) * n_cells * NL + row0;
    for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) dst[idx] = buf[comp * R + idx];
  }
}

template <typename T, int P>
int launch2(const Args<T>& a, int n_cells, int* info, cudaStream_t stream) {
  using C = el::Cfg2<P>;
  const int smem = static_cast<int>(smem_values2<T, P>() * sizeof(T));
  auto kernel = cell_elasticity2_kernel<T, P>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info) {  // a dry run: threads, shared memory and blocks per SM, launch nothing
    info[0] = C::THREADS;
    info[1] = smem;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, C::THREADS, smem));
  }
  const int blocks = (n_cells + C::G - 1) / C::G;
  if (blocks > 0) kernel<<<blocks, C::THREADS, smem, stream>>>(a, n_cells);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch(const Args<T>& a, int n_cells, int* info, cudaStream_t stream) {
  using C = el::Cfg<P>;
  const int smem = static_cast<int>(smem_values<T, P>() * sizeof(T));
  auto kernel = cell_elasticity_kernel<T, P>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info) {  // a dry run: threads, shared memory and blocks per SM, launch nothing
    info[0] = C::THREADS;
    info[1] = smem;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, C::THREADS, smem));
  }
  const int blocks = (n_cells + C::G - 1) / C::G;
  if (blocks > 0) kernel<<<blocks, C::THREADS, smem, stream>>>(a, n_cells);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* const* p, double mu, double lam, long long cstride, int B, int N3p,
             int n_cells, int degree, int dim, int* info, cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(p[0]), static_cast<const int*>(p[1]),
                  static_cast<const int*>(p[2]), static_cast<const T*>(p[3]),
                  static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
                  static_cast<const T*>(p[6]), static_cast<const T*>(p[7]),
                  static_cast<T*>(const_cast<void*>(p[8])), static_cast<T>(mu),
                  static_cast<T>(lam), cstride, B, N3p};
  if (dim == 2) {
    switch (degree) {
      case 1: return launch2<T, 1>(a, n_cells, info, stream);
      case 2: return launch2<T, 2>(a, n_cells, info, stream);
      case 3: return launch2<T, 3>(a, n_cells, info, stream);
      case 4: return launch2<T, 4>(a, n_cells, info, stream);
      case 5: return launch2<T, 5>(a, n_cells, info, stream);
      case 6: return launch2<T, 6>(a, n_cells, info, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dim != 3) return static_cast<int>(cudaErrorInvalidValue);
  switch (degree) {
    case 1: return launch<T, 1>(a, n_cells, info, stream);
    case 2: return launch<T, 2>(a, n_cells, info, stream);
    case 3: return launch<T, 3>(a, n_cells, info, stream);
    case 4: return launch<T, 4>(a, n_cells, info, stream);
    case 5: return launch<T, 5>(a, n_cells, info, stream);
    case 6: return launch<T, 6>(a, n_cells, info, stream);
    case 7: return launch<T, 7>(a, n_cells, info, stream);
    case 8: return launch<T, 8>(a, n_cells, info, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// ptrs: src, dofmap, codes, P, S, Dc, w, geo, out (device pointers; dofmap null: the bricks
// mode). dim: 3 or 2. info: null to launch; else [threads, shared-memory bytes, blocks
// per SM], not launched.
int cell_elasticity_f32(const void* const* ptrs, double mu, double lam, long long cstride, int B,
                        int N3p, int n_cells, int degree, int dim, int* info, void* stream) {
  return dispatch<float>(ptrs, mu, lam, cstride, B, N3p, n_cells, degree, dim, info,
                         static_cast<cudaStream_t>(stream));
}

int cell_elasticity_f64(const void* const* ptrs, double mu, double lam, long long cstride, int B,
                        int N3p, int n_cells, int degree, int dim, int* info, void* stream) {
  return dispatch<double>(ptrs, mu, lam, cstride, B, N3p, n_cells, degree, dim, info,
                          static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
