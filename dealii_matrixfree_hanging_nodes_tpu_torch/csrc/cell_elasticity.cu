// cell_elasticity: linear elasticity's cell operator on cell rows, out [3, n_cells, N^3] (N = p+1;
// component-major rows), a(u, v) = int 2 mu eps(u):eps(v) + lam div u div v on cube cells, in one
// launch, in one of two modes (and the index mode in 2-D, below):
//   index (dofmap given): for each cell c, read the three components src[dofmap[c, j] * 3 + comp]
//     of a global vector [n_dofs, 3] (DoF-major: the transpose to component-major rides the
//     gather); with codes, the hanging-node interpolation of each component by the
//     cell's mask (hanging_nodes.cuh; mask 0: none); the coupled operator with the cell's
//     geo[c, 0..2]; with codes, the transposed interpolation;
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
// The operator. With S [q][i] the values of the nodal basis at the Gauss points and D = Dc S its
// derivatives there, the reference gradients at the points are
//   d_x u = S_z S_y D_x u,  d_y u = S_z D_y S_x u,  d_z u = D_z S_y S_x u
// (M_a: the 1-D factor M along axis a), the point operator (elasticity.cuh's point) gives
// out[c][a], what multiplies d_a v_c, and the result is the adjoint sum
//   S_z^T S_y^T D_x^T out[c][x] + S_z^T D_y^T S_x^T out[c][y] + D_z^T S_y^T S_x^T out[c][z].
// On cube cells (equal geo_a, which the callers check) with p+1 Gauss points this is the
// reference's cell matrix el_Kel times geo (models/elasticity_bricks.py:137-143) up to rounding.
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (cell_elasticity.bytes_and_flops), index
//   mode: the distinct DoFs the map names read once (3 x 17.55 M values, 211 MB), the dofmap
//   (269,991 x 125 int32, 135 MB), codes and geo, the rows written once (3 x 135 MB = 405 MB):
//   ~0.75 GB, 0.22 ms at 3.35 TB/s; against the 16 even-odd sweeps of a cell line below and ~40
//   operations a point (10.4 GFLOP, 0.16 ms at 67 TFLOP/s f32 outside the tensor cores). No
//   single PyTorch call computes the index mode (the gather, the per-mask interpolation and the
//   quadrature), as none computes cell_laplace. The bricks mode composed into one map from the
//   bricks to the rows is a dense coupled Kel [375, 375] a subset cell: 65,600 x 375^2 = 9.2 G
//   nonzeros, 73.8 GB as CSR with f32 values and int32 indices, next to the card's 80 GB. So
//   neither mode has a library yardstick. The dim=2 index instances at quadrant nref=11, p=4,
//   f32: the DoFs twice (135 MB), the dofmap (105 MB), the rows written twice (210 MB): ~0.45 GB,
//   0.13 ms; the coupled map composed is 50^2 = 2,500 nonzeros a cell, 2.63 G in all: past int32
//   indices, and cuSPARSE's SpMV raised an internal error on it with int64 indices (31.6 GB,
//   H100), so it has no library yardstick either.
//
// Design: the layout of Kronbichler and Ljungkvist (2019), deal.II's CUDA matrix-free path. A
//   thread owns one z-column (x, y) of a cell, N^2 threads a cell, G cells a block (Cfg: G N^2
//   close to a multiple of 32 threads). The gathered cells sit in shared memory in regions of
//   G N^3 values (kind k, component c at region 3k + c), and the operator runs in five
//   phases, each a thread's lines in registers for all three components, one barrier after each:
//     z1, its column:         a = S_z u, c = D_z u                        (kinds 0, 2)
//     x1, x-line (y, z):      a' = S_x a, b = D_x a, c' = S_x c          (kinds 0, 1, 2)
//     y,  y-line (x, z):      the gradients D_y a', S_y b, S_y c'; the point operator on all
//                             nine at the line's N points; P = D_y^T o_y, Q = S_y^T o_x,
//                             R = S_y^T o_z                               (kinds 0, 1, 2)
//     x2, x-line:             T1 = D_x^T Q + S_x^T P, T2 = S_x^T R        (kinds 0, 2)
//     z2, its column:         S_z^T T1 + D_z^T T2                         (kind 0)
//   16 sweeps of a line a component (the collocation form of hn_cell's elastic mode takes 12,
//   but 10 barriers where these take 5, and its z sweeps cross threads). S, D and their
//   transposes travel with the launch as its parameters (the constant bank), so every factor
//   entry is an operand of its FMA and no shared-memory load is spent on a factor. Each sweep
//   runs even-odd: S[N-1-i][N-1-j] = S[i][j] and D[N-1-i][N-1-j] =
//   -D[i][j] on the symmetric Gauss points and nodes, so a sweep forms the sums and differences
//   of the mirrored inputs and takes (N/2 + N%2) (N/2) + (N/2)^2 products, not N^2 (13 not 25 at
//   p=4; the sweeps and their tables in even_odd.cuh, shared with cell_laplace.cu; the tables
//   from _even_odd.factor_tables) (whole
//   sweeps measured 0.7904-0.7967, 0.1676-0.1703 and 0.3378-0.3409 ms against the even-odd
//   0.7574-0.7646, 0.1569-0.1596 and 0.2950-0.3020 in the 3-D index, 3-D bricks and 2-D index
//   modes at quadrant nref=7 p=4 f32, 2-D nref=11, H100 80GB HBM3 at 700 W). In the index mode
//   a block takes GPB = 4 groups of G cells in turn: the next group's dofmap entries are loaded
//   first and its src values gathered by cp.async into a second kind-0 buffer (twelve regions,
//   not nine; at p=4 f32 still 6 blocks an SM, which the registers set) while the current
//   group computes: 0.7121-0.7150 ms against 0.7580-0.7588 with the blocking gather
//   (kernel_ab.py, same card). The bricks mode keeps one group a block (a small grid: four
//   measured 0.1783-0.1785 ms against 0.1569-0.1573) and its gather by cp.async. The
//   interpolation (blocks with a constrained cell only) sweeps lines in shared memory with P
//   staged there (hanging_nodes.cuh), 3 barriers each way. Each row is written by its block
//   alone and every sum runs in a fixed order: no atomics, bit-identical calls.
//   2-D: a thread owns a y-column of a cell (N threads a cell, G = 256 / N cells a block), four
//   regions of G N^2 values, three phases:
//     y1, its column:  a = S_y u, c = D_y u;
//     x,  x-line y:    d_x = D_x a, d_y = S_x c; the point operator; Q = D_x^T o_x, R = S_x^T o_y;
//     y2, its column:  S_y^T Q + D_y^T R;
//   10 sweeps of a line a component, 3 barriers (2 each way for the interpolation).
//   The bricks mode in 2-D (the reference's 2-D el_Kel einsum on the subset's cell rows,
//   models/elasticity_bricks.py:229-240) at 2-D quadrant nref=11 p=4 f32 (517 subset bricks,
//   33,088 rows): the bricks' nodes twice (4.5 MB), the rows twice (6.6 MB) and geo, ~11 MB,
//   0.0034 ms; its map composed is a dense coupled [50, 50] block a row, 82.7 M nonzeros.

#include <cuda_runtime.h>

#include <cstddef>

#include "elasticity.cuh"
#include "even_odd.cuh"
#include "hanging_nodes.cuh"
#include "sum_factorization.cuh"

namespace {

using eo::Factors;
using eo::FD;
using eo::FDT;
using eo::FS;
using eo::FST;
using eo::cp_async;
using eo::cp_async_commit;
using eo::cp_async_wait;
using eo::factors_from;
using eo::load;
using eo::mat;
using eo::store;

template <typename T>
struct Args {
  const T* src;       // [n_dofs][dim] (index) or component bricks at src + comp * cstride
  const int* dofmap;  // [n_cells][N^dim], or null: the bricks mode
  const int* codes;   // [n_cells] masks, or null
  const T* P;         // [2][N][N] (index mode with codes)
  const T* w;         // [N^dim]
  const T* geo;       // [n_cells][dim] (index) or [n_cells] (bricks)
  T* out;             // [dim][n_cells][N^dim]
  T mu, lam;
  long long cstride;  // bricks: values between the components' brick vectors
  int B, N3p;         // bricks: cells a brick side, a brick's padded length
};

// cells a block and its layout: a z-column a thread (N^2 threads a cell), G N^2 close to a
// multiple of 32; twelve regions of G N^3 values (at most 161 KB in f64, at p = 6): kinds 0,
// 1, 2 and the second buffer of kind 0
template <int P>
struct Cfg {
  static constexpr int N = P + 1, N2 = N * N, NL = N2 * N;
  static constexpr int G = P == 1 ? 32 : P == 2 ? 14 : P == 3 ? 8 : P == 4 ? 5 : P == 5 ? 7
                           : P == 6 ? 5 : 2;
  static constexpr int THREADS = (G * N2 + 31) / 32 * 32;
  static constexpr int R = G * NL;  // one region
  static constexpr int VALUES = 12 * R;
};

// blocks an SM the registers must allow: 768 threads in f32 up to p = 6 (85 registers), 512
// in f64 up to p = 4 (128); above those half as many, where the lines' registers would spill
template <typename T, int P>
constexpr int min_blocks() {
  constexpr int threads = sizeof(T) == 4 ? (P <= 6 ? 768 : 384) : (P <= 4 ? 512 : 256);
  return threads / Cfg<P>::THREADS > 0 ? threads / Cfg<P>::THREADS : 1;
}

// The interpolation of the three components (at cell + c R) of one cell, forward (x, y, z) or
// transposed (z, y, x); every thread calls it (it holds the barriers), a thread with work
// sweeps line j.
template <typename T, int N, int R, bool TR>
__device__ __forceinline__ void interp3(T* cell, const T* P2, int mask, int j, bool work) {
  if (work) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (TR) hn::interp_line<T, N, 2, true>(cell + c * R, P2, mask, j);
      else hn::interp_line<T, N, 0, false>(cell + c * R, P2, mask, j);
    }
  }
  __syncthreads();
  if (work) {
#pragma unroll
    for (int c = 0; c < 3; ++c) hn::interp_line<T, N, 1, TR>(cell + c * R, P2, mask, j);
  }
  __syncthreads();
  if (work) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (TR) hn::interp_line<T, N, 0, true>(cell + c * R, P2, mask, j);
      else hn::interp_line<T, N, 2, false>(cell + c * R, P2, mask, j);
    }
  }
  __syncthreads();
}

// groups of G cells a block in the index mode, in turn, the next one's gather in flight (the
// bricks mode: one)
constexpr int GPB = 4;

// issue the cp.async gather of the G cells from c0 into dst's three component regions; the
// bricks mode reads each cell's first node in a component from s_base
template <typename T, int P>
__device__ __forceinline__ void gather(const Args<T>& a, T* dst, int c0, int n_cells,
                                       const long long* s_base) {
  using C = Cfg<P>;
  constexpr int N = C::N, N2 = C::N2, NL = C::NL, R = C::R;
  const int n_vals = min(C::G, n_cells - c0) * NL;
  if (a.dofmap == nullptr) {
    const int NB = a.B * P + 1;
    for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) {
      const int g = idx / NL, j = idx - g * NL;
      const int ix = j % N, iy = (j / N) % N, iz = j / N2;
      const T* s = a.src + s_base[g] + (iz * NB + iy) * NB + ix;
#pragma unroll
      for (int c = 0; c < 3; ++c) cp_async(dst + c * R + idx, s + c * a.cstride);
    }
  } else {
    // the indices first, all loads in flight together, then the copies
    constexpr int K = (C::G * NL + C::THREADS - 1) / C::THREADS;
    const size_t row0 = static_cast<size_t>(c0) * NL;
    int d[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int idx = threadIdx.x + q * C::THREADS;
      d[q] = idx < n_vals ? __ldg(a.dofmap + row0 + idx) : 0;
    }
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int idx = threadIdx.x + q * C::THREADS;
      if (idx < n_vals) {
        const T* s = a.src + 3 * static_cast<size_t>(d[q]);
#pragma unroll
        for (int c = 0; c < 3; ++c) cp_async(dst + c * R + idx, s + c);
      }
    }
  }
  cp_async_commit();
}

template <typename T, int P>
__global__ void __launch_bounds__(Cfg<P>::THREADS, min_blocks<T, P>())
cell_elasticity_kernel(const Args<T> a, const Factors<T, P + 1> f, int n_cells) {
  using C = Cfg<P>;
  constexpr int N = C::N, N2 = C::N2, NL = C::NL, G = C::G, R = C::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [kind 0, buffer 0][kind 1][kind 2][kind 0, buffer 1], three component regions each
  T* buf = reinterpret_cast<T*>(smem_raw);
  T* sP = buf + C::VALUES;
  const bool bricks = a.dofmap == nullptr;

  if (a.codes) {
    for (int i = threadIdx.x; i < 2 * N * N; i += blockDim.x) sP[i] = __ldg(a.P + i);
  }
  const int gpb = bricks ? 1 : GPB;
  const int first = blockIdx.x * gpb * G;
  __shared__ long long s_base[G];  // bricks mode: each cell's first node in a component
  if (bricks) {
    if (threadIdx.x < min(G, n_cells - first)) {
      const int cell = first + threadIdx.x, CB = a.B * a.B * a.B, NB = a.B * P + 1;
      const int brick = cell / CB, slot = cell - brick * CB;
      const int sx = slot % a.B, sy = (slot / a.B) % a.B, sz = slot / (a.B * a.B);
      s_base[threadIdx.x] = static_cast<long long>(brick) * a.N3p +
                            (sz * P * NB + sy * P) * NB + sx * P;
    }
    __syncthreads();
  }
  gather<T, P>(a, buf, first, n_cells, s_base);
  const int l = threadIdx.x, g = l / N2, j = l - g * N2;
  const int jx = j % N, jz = j / N;
  for (int it = 0; it < gpb; ++it) {
    const int c0 = first + it * G;
    if (c0 >= n_cells) break;
    T* const cur = buf + (it % 2 ? 9 * R : 0);
    const bool next = it + 1 < gpb && c0 + G < n_cells;
    if (next) gather<T, P>(a, buf + (it % 2 ? 0 : 9 * R), c0 + G, n_cells, s_base);
    if (next) cp_async_wait<1>();
    else cp_async_wait<0>();

    const int nrows = min(G, n_cells - c0);
    const size_t row0 = static_cast<size_t>(c0) * NL;
    const int n_vals = nrows * NL;
    const int cell = c0 + g;
    const bool active = l < G * N2 && cell < n_cells;
    const int code = (a.codes && active) ? __ldg(a.codes + cell) : 0;
    const bool hn_work = active && code != 0;
    const bool any_hn = __syncthreads_or(hn_work);  // also the barrier after the gather
    const int go = (active ? g : 0) * NL;
    T* const k0 = cur + go;            // kind 0, component c at k0 + c R
    T* const k1 = buf + 3 * R + go;    // kind 1
    T* const k2 = buf + 6 * R + go;    // kind 2

    if (any_hn) interp3<T, N, R, false>(k0, sP, code, j, hn_work);
    T geo[3] = {T(0), T(0), T(0)};
    T wq[N];  // the weights at the points of y-line (x, z) = (j % N, j / N)
    if (active) {
      if (bricks) {
        geo[0] = geo[1] = geo[2] = __ldg(a.geo + cell);
      } else {
#pragma unroll
        for (int d = 0; d < 3; ++d) geo[d] = __ldg(a.geo + 3 * cell + d);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) wq[i] = __ldg(a.w + jx + N * i + N2 * jz);
    }
    // z1: column (x, y) = (j % N, j / N), nodes N^2 apart
    if (active) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T u[N], r[N];
        load<T, N, N2>(k0 + c * R + j, u);
        mat<T, N, 1>(f.m[FS], u, r);
        store<T, N, N2>(k0 + c * R + j, r);
        mat<T, N, -1>(f.m[FD], u, r);
        store<T, N, N2>(k2 + c * R + j, r);
      }
    }
    __syncthreads();
    // x1: x-line (y, z) = (j % N, j / N) at N j, contiguous
    if (active) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T v[N], r[N];
        load<T, N, 1>(k0 + c * R + N * j, v);
        mat<T, N, 1>(f.m[FS], v, r);
        store<T, N, 1>(k0 + c * R + N * j, r);
        mat<T, N, -1>(f.m[FD], v, r);
        store<T, N, 1>(k1 + c * R + N * j, r);
        load<T, N, 1>(k2 + c * R + N * j, v);
        mat<T, N, 1>(f.m[FS], v, r);
        store<T, N, 1>(k2 + c * R + N * j, r);
      }
    }
    __syncthreads();
    // y: y-line (x, z) at x + N^2 z, nodes N apart: the gradients, the point operator, and the
    // first transposed sweeps
    if (active) {
      const int o = jx + N2 * jz;
      T gx[3][N], gy[3][N], gz[3][N];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T v[N];
        load<T, N, N>(k0 + c * R + o, v);
        mat<T, N, -1>(f.m[FD], v, gy[c]);
        load<T, N, N>(k1 + c * R + o, v);
        mat<T, N, 1>(f.m[FS], v, gx[c]);
        load<T, N, N>(k2 + c * R + o, v);
        mat<T, N, 1>(f.m[FS], v, gz[c]);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const T gw[3] = {geo[0] * wq[i], geo[1] * wq[i], geo[2] * wq[i]};
        T gr[3][3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          gr[c][0] = gx[c][i];
          gr[c][1] = gy[c][i];
          gr[c][2] = gz[c][i];
        }
        el::point(gr, a.mu, a.lam, gw);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          gx[c][i] = gr[c][0];
          gy[c][i] = gr[c][1];
          gz[c][i] = gr[c][2];
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T r[N];
        mat<T, N, -1>(f.m[FDT], gy[c], r);
        store<T, N, N>(k0 + c * R + o, r);
        mat<T, N, 1>(f.m[FST], gx[c], r);
        store<T, N, N>(k1 + c * R + o, r);
        mat<T, N, 1>(f.m[FST], gz[c], r);
        store<T, N, N>(k2 + c * R + o, r);
      }
    }
    __syncthreads();
    // x2: x-line (y, z)
    if (active) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T v[N], r[N], s[N];
        load<T, N, 1>(k1 + c * R + N * j, v);
        mat<T, N, -1>(f.m[FDT], v, r);
        load<T, N, 1>(k0 + c * R + N * j, v);
        mat<T, N, 1>(f.m[FST], v, s);
#pragma unroll
        for (int i = 0; i < N; ++i) r[i] += s[i];
        store<T, N, 1>(k0 + c * R + N * j, r);
        load<T, N, 1>(k2 + c * R + N * j, v);
        mat<T, N, 1>(f.m[FST], v, r);
        store<T, N, 1>(k2 + c * R + N * j, r);
      }
    }
    __syncthreads();
    // z2: column (x, y)
    if (active) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T v[N], r[N], s[N];
        load<T, N, N2>(k0 + c * R + j, v);
        mat<T, N, 1>(f.m[FST], v, r);
        load<T, N, N2>(k2 + c * R + j, v);
        mat<T, N, -1>(f.m[FDT], v, s);
#pragma unroll
        for (int i = 0; i < N; ++i) r[i] += s[i];
        store<T, N, N2>(k0 + c * R + j, r);
      }
    }
    __syncthreads();
    if (any_hn) interp3<T, N, R, true>(k0, sP, code, j, hn_work);

#pragma unroll
    for (int comp = 0; comp < 3; ++comp) {
      T* dst = a.out + static_cast<size_t>(comp) * n_cells * NL + row0;
      for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) dst[idx] = cur[comp * R + idx];
    }
    __syncthreads();  // cur is the next gather's buffer after the next
  }
}

// 2-D: a y-column a thread (N threads a cell), G = 256 / N cells a block (at least 128 threads),
// four regions of G N^2 values (kind k, component c at region 2k + c; 58 KB in f64 at p = 6)
template <int P>
struct Cfg2 {
  static constexpr int N = P + 1, NL = N * N;
  static constexpr int G = 256 / N;
  static constexpr int THREADS = (G * N + 31) / 32 * 32;
  static constexpr int R = G * NL;
  static constexpr int VALUES = 4 * R;
};

// The 2-D interpolation of the two components (at cell + c R), forward (x, y) or transposed
// (y, x), as interp3
template <typename T, int N, int R, bool TR>
__device__ __forceinline__ void interp2(T* cell, const T* P2, int mask, int j, bool work) {
  if (work) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (TR) hn::interp_line2<T, N, 1, true>(cell + c * R, P2, mask, j);
      else hn::interp_line2<T, N, 0, false>(cell + c * R, P2, mask, j);
    }
  }
  __syncthreads();
  if (work) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (TR) hn::interp_line2<T, N, 0, true>(cell + c * R, P2, mask, j);
      else hn::interp_line2<T, N, 1, false>(cell + c * R, P2, mask, j);
    }
  }
  __syncthreads();
}

// 2-D: two components of N^2 values a cell; the index mode's geo [n_cells][2], the bricks
// mode's [n_cells]
template <typename T, int P>
__global__ void __launch_bounds__(Cfg2<P>::THREADS)
cell_elasticity2_kernel(const Args<T> a, const Factors<T, P + 1> f, int n_cells) {
  using C = Cfg2<P>;
  constexpr int N = C::N, NL = C::NL, G = C::G, R = C::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  T* sP = buf + C::VALUES;

  if (a.codes) {
    for (int i = threadIdx.x; i < 2 * N * N; i += blockDim.x) sP[i] = __ldg(a.P + i);
  }
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

  const int l = threadIdx.x, g = l / N, j = l - g * N, cell = c0 + g;
  const bool active = l < G * N && cell < n_cells;
  const int code = (a.codes && active) ? __ldg(a.codes + cell) : 0;
  const bool hn_work = active && code != 0;
  const bool any_hn = __syncthreads_or(hn_work);  // also the barrier after the gather
  T* const cb = buf + (active ? g : 0) * NL;      // kind k, component c at cb + (2k + c) R

  if (any_hn) interp2<T, N, R, false>(cb, sP, code, j, hn_work);
  T geo[2] = {T(0), T(0)};
  T wq[N];  // the weights at the points of x-line y = j
  if (active) {
    geo[0] = __ldg(a.geo + (bricks ? cell : 2 * cell));
    geo[1] = __ldg(a.geo + (bricks ? cell : 2 * cell + 1));
#pragma unroll
    for (int i = 0; i < N; ++i) wq[i] = __ldg(a.w + i + N * j);
  }
  // y1: column x = j, nodes N apart
  if (active) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      T u[N], r[N];
      load<T, N, N>(cb + c * R + j, u);
      mat<T, N, 1>(f.m[FS], u, r);
      store<T, N, N>(cb + c * R + j, r);
      mat<T, N, -1>(f.m[FD], u, r);
      store<T, N, N>(cb + (2 + c) * R + j, r);
    }
  }
  __syncthreads();
  // x: x-line y = j at N j: the gradients, the point operator, the first transposed sweeps
  if (active) {
    T gx[2][N], gy[2][N];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      T v[N];
      load<T, N, 1>(cb + c * R + N * j, v);
      mat<T, N, -1>(f.m[FD], v, gx[c]);
      load<T, N, 1>(cb + (2 + c) * R + N * j, v);
      mat<T, N, 1>(f.m[FS], v, gy[c]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T gw[2] = {geo[0] * wq[i], geo[1] * wq[i]};
      T gr[2][2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        gr[c][0] = gx[c][i];
        gr[c][1] = gy[c][i];
      }
      el::point(gr, a.mu, a.lam, gw);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        gx[c][i] = gr[c][0];
        gy[c][i] = gr[c][1];
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      T r[N];
      mat<T, N, -1>(f.m[FDT], gx[c], r);
      store<T, N, 1>(cb + c * R + N * j, r);
      mat<T, N, 1>(f.m[FST], gy[c], r);
      store<T, N, 1>(cb + (2 + c) * R + N * j, r);
    }
  }
  __syncthreads();
  // y2: column x = j
  if (active) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      T v[N], r[N], s[N];
      load<T, N, N>(cb + c * R + j, v);
      mat<T, N, 1>(f.m[FST], v, r);
      load<T, N, N>(cb + (2 + c) * R + j, v);
      mat<T, N, -1>(f.m[FDT], v, s);
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] += s[i];
      store<T, N, N>(cb + c * R + j, r);
    }
  }
  __syncthreads();
  if (any_hn) interp2<T, N, R, true>(cb, sP, code, j, hn_work);

#pragma unroll
  for (int comp = 0; comp < 2; ++comp) {
    T* dst = a.out + static_cast<size_t>(comp) * n_cells * NL + row0;
    for (int idx = threadIdx.x; idx < n_vals; idx += blockDim.x) dst[idx] = buf[comp * R + idx];
  }
}

template <typename T, int P, typename C, typename K>
int run(K kernel, const Args<T>& a, const double* fac, int n_cells, int* info,
        cudaStream_t stream, unsigned long long& smem_set, int gpb = 1) {
  const int smem = static_cast<int>((C::VALUES + 2 * C::N * C::N) * sizeof(T));
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info) {  // a dry run: threads, shared memory and blocks per SM, launch nothing
    info[0] = C::THREADS;
    info[1] = smem;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, C::THREADS, smem));
  }
  const int blocks = (n_cells + gpb * C::G - 1) / (gpb * C::G);
  if (blocks > 0) {
    kernel<<<blocks, C::THREADS, smem, stream>>>(a, factors_from<T, P + 1>(fac), n_cells);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch(const Args<T>& a, const double* fac, int n_cells, int* info, cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  return run<T, P, Cfg<P>>(cell_elasticity_kernel<T, P>, a, fac, n_cells, info, stream,
                           smem_set, a.dofmap ? GPB : 1);
}

template <typename T, int P>
int launch2(const Args<T>& a, const double* fac, int n_cells, int* info, cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  return run<T, P, Cfg2<P>>(cell_elasticity2_kernel<T, P>, a, fac, n_cells, info, stream,
                            smem_set);
}

template <typename T>
int dispatch(const void* const* p, const double* fac, double mu, double lam, long long cstride,
             int B, int N3p, int n_cells, int degree, int dim, int* info, cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(p[0]), static_cast<const int*>(p[1]),
                  static_cast<const int*>(p[2]), static_cast<const T*>(p[3]),
                  static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
                  static_cast<T*>(const_cast<void*>(p[6])), static_cast<T>(mu),
                  static_cast<T>(lam), cstride, B, N3p};
  if (dim == 2) {
    switch (degree) {
      case 1: return launch2<T, 1>(a, fac, n_cells, info, stream);
      case 2: return launch2<T, 2>(a, fac, n_cells, info, stream);
      case 3: return launch2<T, 3>(a, fac, n_cells, info, stream);
      case 4: return launch2<T, 4>(a, fac, n_cells, info, stream);
      case 5: return launch2<T, 5>(a, fac, n_cells, info, stream);
      case 6: return launch2<T, 6>(a, fac, n_cells, info, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dim != 3) return static_cast<int>(cudaErrorInvalidValue);
  switch (degree) {
    case 1: return launch<T, 1>(a, fac, n_cells, info, stream);
    case 2: return launch<T, 2>(a, fac, n_cells, info, stream);
    case 3: return launch<T, 3>(a, fac, n_cells, info, stream);
    case 4: return launch<T, 4>(a, fac, n_cells, info, stream);
    case 5: return launch<T, 5>(a, fac, n_cells, info, stream);
    case 6: return launch<T, 6>(a, fac, n_cells, info, stream);
    case 7: return launch<T, 7>(a, fac, n_cells, info, stream);
    case 8: return launch<T, 8>(a, fac, n_cells, info, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// ptrs: src, dofmap, codes, P, w, geo, out (device pointers; dofmap null: the bricks mode).
// factors: host float64 tables of S, D = Dc S, S^T, D^T, each its even-odd split A, B
// [(N+1)/2][N/2] and C [(N+1)/2] (cell_elasticity.factor_tables), copied into the launch's
// parameters. dim: 3 or 2. info: null to launch; else [threads, shared-memory
// bytes, blocks per SM], not launched.
int cell_elasticity_f32(const void* const* ptrs, const double* factors, double mu, double lam,
                        long long cstride, int B, int N3p, int n_cells, int degree, int dim,
                        int* info, void* stream) {
  return dispatch<float>(ptrs, factors, mu, lam, cstride, B, N3p, n_cells, degree, dim, info,
                         static_cast<cudaStream_t>(stream));
}

int cell_elasticity_f64(const void* const* ptrs, const double* factors, double mu, double lam,
                        long long cstride, int B, int N3p, int n_cells, int degree, int dim,
                        int* info, void* stream) {
  return dispatch<double>(ptrs, factors, mu, lam, cstride, B, N3p, n_cells, degree, dim, info,
                          static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
