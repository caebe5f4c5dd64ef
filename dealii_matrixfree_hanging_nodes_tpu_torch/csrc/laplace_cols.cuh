// The Laplace of a cell in columns, shared by cell_laplace.cu and brick_deformed.cu: the layout
// of Kronbichler and Ljungkvist (2019), deal.II's CUDA matrix-free path. A thread owns a
// z-column (x, y) = (j % N, j / N) of a cell (2-D: a y-column x = j), N^2 threads a cell (2-D:
// N); the cell's values sit in shared memory in regions of N^3 values (kinds 0, 1, 2; 2-D: N^2
// values, kinds 0, 1), x fastest, and the operator runs in five phases (2-D: three), a thread's
// lines in registers, one barrier after each but the last:
//   z1, its column:     a = S_z u, c = D_z u                                   (kinds 0, 2)
//   x1, x-line (y, z):  a' = S_x a, b = D_x a, c' = S_x c                      (kinds 0, 1, 2)
//   y,  y-line (x, z):  the gradients S_y b, D_y a', S_y c'; the geometry at the line's N
//                       points (the caller's `point`); P = D_y^T o_y, Q = S_y^T o_x,
//                       R = S_y^T o_z                                          (kinds 0, 1, 2)
//   x2, x-line:         T1 = D_x^T Q + S_x^T P, T2 = S_x^T R                   (kinds 0, 2)
//   z2, its column:     S_z^T T1 + D_z^T T2                                    (kind 0)
// 2-D: y1 (a = S_y u, c = D_y u), x (the gradients D_x a, S_x c; the geometry; Q = D_x^T o_x,
// R = S_x^T o_y), y2 (S_y^T Q + D_y^T R). S, D = Dc S and their transposes come as even-odd
// launch parameters (even_odd.cuh): 16 sweeps of a line (2-D: 8), each 13 products at p=4.
// The last phase writes only the thread's own column of kind 0 after reading its own column
// of kinds 0 and 2 (2-D: 0 and 1), so no barrier follows it here: the caller places one where
// other threads read the result.

#pragma once

#include <cuda_runtime.h>

#include "even_odd.cuh"

namespace lc {

using eo::Factors;
using eo::FD;
using eo::FDT;
using eo::FS;
using eo::FST;
using eo::load;
using eo::mat;
using eo::store;

// 3-D, on the regions k0 (the result out), k1, k2 of the thread's cell, the values in from the
// thread's column u (its N values ZS apart: k0 + j with ZS = N^2 where k0 holds them); every
// thread of the block calls it (its 4 barriers), active ones work. point(gx, gy, gz, o) maps the
// reference gradients at the points o + N i (i < N) of the thread's y-line, o = x + N^2 z.
template <typename T, int N, int ZS, typename Point>
__device__ __forceinline__ void laplace3(const T* u_col, T* k0, T* k1, T* k2,
                                         const Factors<T, N>& f, int j, bool active,
                                         Point point) {
  constexpr int N2 = N * N;
  // z1: column (x, y) = (j % N, j / N), nodes N^2 apart: a = S_z u, c = D_z u
  if (active) {
    T u[N], r[N];
    load<T, N, ZS>(u_col, u);
    mat<T, N, 1>(f.m[FS], u, r);
    store<T, N, N2>(k0 + j, r);
    mat<T, N, -1>(f.m[FD], u, r);
    store<T, N, N2>(k2 + j, r);
  }
  __syncthreads();
  // x1: x-line (y, z) = (j % N, j / N) at N j: a' = S_x a, b = D_x a, c' = S_x c
  if (active) {
    T v[N], r[N];
    load<T, N, 1>(k0 + N * j, v);
    mat<T, N, 1>(f.m[FS], v, r);
    store<T, N, 1>(k0 + N * j, r);
    mat<T, N, -1>(f.m[FD], v, r);
    store<T, N, 1>(k1 + N * j, r);
    load<T, N, 1>(k2 + N * j, v);
    mat<T, N, 1>(f.m[FS], v, r);
    store<T, N, 1>(k2 + N * j, r);
  }
  __syncthreads();
  // y: y-line (x, z) at x + N^2 z, nodes N apart: the gradients S_y b, D_y a', S_y c'; the
  // geometry at the line's points; D_y^T o_y, S_y^T o_x, S_y^T o_z
  if (active) {
    const int o = j % N + N2 * (j / N);
    T gx[N], gy[N], gz[N], v[N];
    load<T, N, N>(k1 + o, v);
    mat<T, N, 1>(f.m[FS], v, gx);
    load<T, N, N>(k0 + o, v);
    mat<T, N, -1>(f.m[FD], v, gy);
    load<T, N, N>(k2 + o, v);
    mat<T, N, 1>(f.m[FS], v, gz);
    point(gx, gy, gz, o);
    mat<T, N, -1>(f.m[FDT], gy, v);
    store<T, N, N>(k0 + o, v);
    mat<T, N, 1>(f.m[FST], gx, v);
    store<T, N, N>(k1 + o, v);
    mat<T, N, 1>(f.m[FST], gz, v);
    store<T, N, N>(k2 + o, v);
  }
  __syncthreads();
  // x2: x-line: T1 = D_x^T Q + S_x^T P, T2 = S_x^T R
  if (active) {
    T v[N], r[N], s[N];
    load<T, N, 1>(k1 + N * j, v);
    mat<T, N, -1>(f.m[FDT], v, r);
    load<T, N, 1>(k0 + N * j, v);
    mat<T, N, 1>(f.m[FST], v, s);
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] += s[i];
    store<T, N, 1>(k0 + N * j, r);
    load<T, N, 1>(k2 + N * j, v);
    mat<T, N, 1>(f.m[FST], v, r);
    store<T, N, 1>(k2 + N * j, r);
  }
  __syncthreads();
  // z2: column: S_z^T T1 + D_z^T T2
  if (active) {
    T v[N], r[N], s[N];
    load<T, N, N2>(k0 + j, v);
    mat<T, N, 1>(f.m[FST], v, r);
    load<T, N, N2>(k2 + j, v);
    mat<T, N, -1>(f.m[FDT], v, s);
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] += s[i];
    store<T, N, N2>(k0 + j, r);
  }
}

// 2-D, on the regions k0 (the result out) and k1 of the thread's cell, the values in from the
// thread's column u (its N values YS apart: k0 + j with YS = N where k0 holds them); every
// thread of the block calls it (its 2 barriers). point(gx, gy, o) maps the reference gradients
// at the points o + i (i < N) of the thread's x-line y = j, o = N j.
template <typename T, int N, int YS, typename Point>
__device__ __forceinline__ void laplace2(const T* u_col, T* k0, T* k1, const Factors<T, N>& f,
                                         int j, bool active, Point point) {
  // y1: column x = j, nodes N apart: a = S_y u, c = D_y u
  if (active) {
    T u[N], r[N];
    load<T, N, YS>(u_col, u);
    mat<T, N, 1>(f.m[FS], u, r);
    store<T, N, N>(k0 + j, r);
    mat<T, N, -1>(f.m[FD], u, r);
    store<T, N, N>(k1 + j, r);
  }
  __syncthreads();
  // x: x-line y = j at N j: the gradients D_x a, S_x c; the geometry at the line's points;
  // D_x^T o_x, S_x^T o_y
  if (active) {
    T gx[N], gy[N], v[N];
    load<T, N, 1>(k0 + N * j, v);
    mat<T, N, -1>(f.m[FD], v, gx);
    load<T, N, 1>(k1 + N * j, v);
    mat<T, N, 1>(f.m[FS], v, gy);
    point(gx, gy, N * j);
    mat<T, N, -1>(f.m[FDT], gx, v);
    store<T, N, 1>(k0 + N * j, v);
    mat<T, N, 1>(f.m[FST], gy, v);
    store<T, N, 1>(k1 + N * j, v);
  }
  __syncthreads();
  // y2: column x = j: S_y^T Q + D_y^T R
  if (active) {
    T v[N], r[N], s[N];
    load<T, N, N>(k0 + j, v);
    mat<T, N, 1>(f.m[FST], v, r);
    load<T, N, N>(k1 + j, v);
    mat<T, N, -1>(f.m[FDT], v, s);
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] += s[i];
    store<T, N, N>(k0 + j, r);
  }
}

// the packed symmetric metric (xx, xy, yy; x the fastest axis) of w detJ J^-1 J^-T at the points
// m + 3 i of an x-line (device memory), times the gradients there
template <typename T, int N>
__device__ __forceinline__ void metric2(const T* __restrict__ m, T (&gx)[N], T (&gy)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T m0 = __ldg(m + 3 * i), m1 = __ldg(m + 3 * i + 1), m2 = __ldg(m + 3 * i + 2);
    const T x = gx[i], y = gy[i];
    gx[i] = m0 * x + m1 * y;
    gy[i] = m1 * x + m2 * y;
  }
}

}  // namespace lc
