// Linear elasticity's cell work, shared by cell_elasticity.cu and hn_cell.cu: a group of G cells
// in shared memory, three displacement components a cell (N = p+1, N^3 values a component, x
// fastest), one thread a line of a cell (N^2 lines), as in hanging_nodes.cuh. The operator
//   a(u, v) = int 2 mu eps(u):eps(v) + lam div u div v
// in the collocation form of the Laplace kernel (cell_laplace.cu): values at the Gauss points by
// three sweeps of S, the reference gradient d_a u_c by a sweep of Dc along a; at each point the
// coupled operator (point) gives what multiplies each test gradient d_a v_c,
//   out[c][a] = (mu (d_a u_c + d_c u_a) + [c == a] lam div u) geo_a w,
// and the transposes integrate it back: Dc^T along a on out[c][a], the sum, S^T along z, y, x.
// On cube cells (equal geo_a, which the callers check) this is the reference's elasticity kernel
// (dealii_matrixfree_hanging_nodes_tpu/models/elasticity.py:44-79) and, with p+1 Gauss points
// integrating it exactly, its cell matrix el_Kel (models/elasticity_bricks.py:137-143).
//
// The block's buffer holds nine regions of G N^3 values, region kind*3 + c (kind 0: U, 1: X,
// 2: Y; c the component), so the G rows of a component are contiguous in U (coalesced copies in
// and out). U_c holds the nodal values, then the values at the points and d_z u_c (swept in
// place), X_c and Y_c hold d_x u_c and d_y u_c; after the point operator they hold out[c][.],
// and the integration leaves row c of the result in U_c. 10 barriers a cell group. The 2-D
// forms (Cfg2, interp2, apply2: two components of N^2 values, cell_elasticity's dim=2 index
// mode) follow the 3-D ones.

#pragma once

#include <cuda_runtime.h>

#include "hanging_nodes.cuh"

namespace el {

// cells per block: nine regions of G N^3 values stay at or below ~105 KB in f64, one line a
// thread (G N^2 lines)
template <int P>
struct Cfg {
  static constexpr int N = P + 1;
  static constexpr int N2 = N * N;
  static constexpr int NL = N2 * N;
  static constexpr int G = P == 1 ? 32 : P <= 3 ? 16 : P == 4 ? 8 : P <= 6 ? 4 : 2;
  static constexpr int THREADS = (G * N2 + 31) / 32 * 32;
  static constexpr int R = G * NL;  // one region
  static constexpr int VALUES = 9 * R;
};

// The coupled operator at one point in D dimensions (3, or 2 for the 2-D index mode): g[c][a] =
// d_a u_c in, out[c][a] (what multiplies d_a v_c) out, in place; gw[a] = geo_a w at the point.
template <typename T, int D>
__device__ __forceinline__ void point(T (&g)[D][D], T mu, T lam, const T (&gw)[D]) {
  T div = g[0][0];
#pragma unroll
  for (int c = 1; c < D; ++c) div += g[c][c];
  T o[D][D];
#pragma unroll
  for (int c = 0; c < D; ++c)
#pragma unroll
    for (int a = 0; a < D; ++a) o[c][a] = mu * (g[c][a] + g[a][c]) * gw[a];
#pragma unroll
  for (int c = 0; c < D; ++c) o[c][c] += lam * div * gw[c];
#pragma unroll
  for (int c = 0; c < D; ++c)
#pragma unroll
    for (int a = 0; a < D; ++a) g[c][a] = o[c][a];
}

// transposed z sweep of the sum of three lines (line j along z), into out (may be one of them)
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

// The hanging-node interpolation of the three components of cell g (P2 [2][N][N], mask its
// code), forward (sweeps along x, y, z) or transposed (z, y, x). Every thread of the block calls
// it (it holds the barriers); a thread with work handles line j.
template <typename T, int P, bool TR>
__device__ __forceinline__ void interp3(T* buf, const T* P2, int mask, int g, int j, bool work) {
  using C = Cfg<P>;
  constexpr int N = C::N;
  T* u = buf + g * C::NL;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    if (work) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T* uc = u + c * C::R;
        if (TR) {
          if (s == 0) hn::interp_line<T, N, 2, true>(uc, P2, mask, j);
          if (s == 1) hn::interp_line<T, N, 1, true>(uc, P2, mask, j);
          if (s == 2) hn::interp_line<T, N, 0, true>(uc, P2, mask, j);
        } else {
          if (s == 0) hn::interp_line<T, N, 0, false>(uc, P2, mask, j);
          if (s == 1) hn::interp_line<T, N, 1, false>(uc, P2, mask, j);
          if (s == 2) hn::interp_line<T, N, 2, false>(uc, P2, mask, j);
        }
      }
    }
    __syncthreads();
  }
}

// The operator on the G cells of the block: U (regions 0..2) holds each cell's nodal values in,
// its result out. S, D: [N][N] interpolation and collocation derivative; w [N^3] the tensor
// quadrature weights; gw3 the cell's geo_a (a = 0, 1, 2). Every thread calls it (it holds the
// barriers); an active thread handles line j of cell g.
template <typename T, int P>
__device__ __forceinline__ void apply(T* buf, const T* S, const T* D, const T* w, T mu, T lam,
                                      const T (&geo)[3], int g, int j, bool active) {
  using C = Cfg<P>;
  constexpr int N = C::N, N2 = C::N2, R = C::R;
  T* U = buf + g * C::NL;
  T* X = U + 3 * R;
  T* Y = U + 6 * R;
  // values at the Gauss points
  if (active) {
#pragma unroll
    for (int c = 0; c < 3; ++c) hn::sweep_line<T, N, 0, false>(U + c * R, U + c * R, S, j);
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int c = 0; c < 3; ++c) hn::sweep_line<T, N, 1, false>(U + c * R, U + c * R, S, j);
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int c = 0; c < 3; ++c) hn::sweep_line<T, N, 2, false>(U + c * R, U + c * R, S, j);
  }
  __syncthreads();
  // the reference gradients: d_x into X, d_y into Y, then d_z over U in place
  if (active) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      hn::sweep_line<T, N, 0, false>(U + c * R, X + c * R, D, j);
      hn::sweep_line<T, N, 1, false>(U + c * R, Y + c * R, D, j);
    }
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int c = 0; c < 3; ++c) hn::sweep_line<T, N, 2, false>(U + c * R, U + c * R, D, j);
  }
  __syncthreads();
  // the coupled operator at the points j, j + N^2, ...
  if (active) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int q = j + k * N2;
      const T wq = w[q];
      const T gw[3] = {geo[0] * wq, geo[1] * wq, geo[2] * wq};
      T gr[3][3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        gr[c][0] = X[c * R + q];
        gr[c][1] = Y[c * R + q];
        gr[c][2] = U[c * R + q];
      }
      point(gr, mu, lam, gw);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        X[c * R + q] = gr[c][0];
        Y[c * R + q] = gr[c][1];
        U[c * R + q] = gr[c][2];
      }
    }
  }
  __syncthreads();
  // the transposes: Dc^T on each along its axis, the sum with S^T along z, then y, x
  if (active) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      hn::sweep_line<T, N, 0, true>(X + c * R, X + c * R, D, j);
      hn::sweep_line<T, N, 1, true>(Y + c * R, Y + c * R, D, j);
      hn::sweep_line<T, N, 2, true>(U + c * R, U + c * R, D, j);
    }
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int c = 0; c < 3; ++c) sum_sweep_z<T, N>(X + c * R, Y + c * R, U + c * R, U + c * R, S, j);
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int c = 0; c < 3; ++c) hn::sweep_line<T, N, 1, true>(U + c * R, U + c * R, S, j);
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int c = 0; c < 3; ++c) hn::sweep_line<T, N, 0, true>(U + c * R, U + c * R, S, j);
  }
  __syncthreads();
}

// ---- 2-D (cell_elasticity's index mode at dim=2) -----------------------------------------
// Two components a cell, N^2 values each; one thread a line of a cell (N lines),
// hanging_nodes.cuh's 2-D convention. The buffer holds four regions of G N^2 values, region kind*2 + c (kind 0: U,
// 1: X): U_c the nodal values, then the values at the points and d_y u_c (swept in place), X_c
// d_x u_c; after the point operator they hold out[c][.], and the integration leaves row c of
// the result in U_c. In 2-D geo_a = h^(dim-2) = 1 on every cell (models/elasticity.py:57), but
// the kernel reads it as in 3-D. 8 barriers a cell group.
template <int P>
struct Cfg2 {
  static constexpr int N = P + 1;
  static constexpr int NL = N * N;
  static constexpr int G = 256 / N;  // cells a block, >= 128 threads
  static constexpr int THREADS = (G * N + 31) / 32 * 32;
  static constexpr int R = G * NL;  // one region
  static constexpr int VALUES = 4 * R;
};

// the 2-D interpolation of the two components of cell g, forward (x, y) or transposed (y, x)
template <typename T, int P, bool TR>
__device__ __forceinline__ void interp2(T* buf, const T* P2, int mask, int g, int j, bool work) {
  using C = Cfg2<P>;
  constexpr int N = C::N;
  T* u = buf + g * C::NL;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (work) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        T* uc = u + c * C::R;
        if (TR) {
          if (s == 0) hn::interp_line2<T, N, 1, true>(uc, P2, mask, j);
          if (s == 1) hn::interp_line2<T, N, 0, true>(uc, P2, mask, j);
        } else {
          if (s == 0) hn::interp_line2<T, N, 0, false>(uc, P2, mask, j);
          if (s == 1) hn::interp_line2<T, N, 1, false>(uc, P2, mask, j);
        }
      }
    }
    __syncthreads();
  }
}

// The 2-D operator on the G cells of the block, as apply: U (regions 0, 1) holds each cell's
// nodal values in, its result out; w [N^2]; geo the cell's geo_a (a = 0, 1).
template <typename T, int P>
__device__ __forceinline__ void apply2(T* buf, const T* S, const T* D, const T* w, T mu, T lam,
                                       const T (&geo)[2], int g, int j, bool active) {
  using C = Cfg2<P>;
  constexpr int N = C::N, R = C::R;
  T* U = buf + g * C::NL;
  T* X = U + 2 * R;
  // values at the Gauss points
  if (active) {
#pragma unroll
    for (int c = 0; c < 2; ++c) hn::sweep_line2<T, N, 0, false>(U + c * R, U + c * R, S, j);
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int c = 0; c < 2; ++c) hn::sweep_line2<T, N, 1, false>(U + c * R, U + c * R, S, j);
  }
  __syncthreads();
  // the reference gradients: d_x into X, then d_y over U in place
  if (active) {
#pragma unroll
    for (int c = 0; c < 2; ++c) hn::sweep_line2<T, N, 0, false>(U + c * R, X + c * R, D, j);
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int c = 0; c < 2; ++c) hn::sweep_line2<T, N, 1, false>(U + c * R, U + c * R, D, j);
  }
  __syncthreads();
  // the coupled operator at the points j, j + N, ... (line j along y)
  if (active) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int q = j + k * N;
      const T wq = w[q];
      const T gw[2] = {geo[0] * wq, geo[1] * wq};
      T gr[2][2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        gr[c][0] = X[c * R + q];
        gr[c][1] = U[c * R + q];
      }
      point(gr, mu, lam, gw);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        X[c * R + q] = gr[c][0];
        U[c * R + q] = gr[c][1];
      }
    }
  }
  __syncthreads();
  // the transposes: Dc^T on each along its axis, the sum with S^T along y, then S^T along x
  if (active) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      hn::sweep_line2<T, N, 0, true>(X + c * R, X + c * R, D, j);
      hn::sweep_line2<T, N, 1, true>(U + c * R, U + c * R, D, j);
    }
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int c = 0; c < 2; ++c) hn::sum_sweep_y2<T, N>(X + c * R, U + c * R, U + c * R, S, j);
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int c = 0; c < 2; ++c) hn::sweep_line2<T, N, 0, true>(U + c * R, U + c * R, S, j);
  }
  __syncthreads();
}

}  // namespace el
