// hn_cell: the constrained rows of the vmult, from the subset bricks to HN^T, in one launch.
// Row h is cell c = hn_sub[h] of the subset bricks u [n_sub, N3p] (brick c / B^3, slot c % B^3,
// x fastest; its node (ix, iy, iz) at brick node ((sz*p + iz)*NB + sy*p + iy)*NB + sx*p + ix,
// NB = B*p + 1). With n = p+1, n_loc = n^3 and Q_h the composite hanging-node matrix of row h
// (q_of_row[h] < 0: the identity):
//   1. fill:  filled[h, j] = (keep[h, j] ? u(c, j) : 0) + sum of u_flat[ent_src[e]] over the
//             entries e of row h (row_ptr[h] .. row_ptr[h+1], sorted by slot) with
//             ent_slot[e] == j: the fill chain, composed on the host;
//   2. Q:     u_hat = filled @ Q_h, from the lists of Q by output slot (fwd_ptr, fwd_col, fwd_w);
//   3. K:     own = scale[h] * (K u_hat), K the Kronecker sum of the 1-D factors K1, M1;
//   4. Q^T:   out = own @ Q_h^T, from the lists of Q^T (bwd_ptr, bwd_col, bwd_w).
// The fill mode (FILL) stops after step 2 and writes u_hat (refill's input).
// With a right-hand-side axis (both modes; BrickLaplaceMM.vmult_multi: u [k, n_sub, N3p], its RHS
// u_stride values apart, the subset view bvk[:, :n_sub]; out [k, n_hn, n_loc]) grid.y is the RHS,
// whose blocks offset u and out by it (ent_src indexes one RHS's subset bricks, contiguous): each
// RHS is bit-identical to a launch on it alone, and the lists and Q's are read by all k.
// The elastic mode (hn_cell_elastic_kernel) runs the three components of component brick vectors
// (u + comp * cstride) through steps 1 and 2, then linear elasticity's coupled operator times
// scale[h] on every axis (elasticity.cuh) in place of step 3, then step 4 on each component:
// out [3, n_hn, n_loc], component-major, in one launch.
// The deformed mode (a deformed mapping) replaces step 3 by the row's own stiffness at its Gauss
// points: laplace_quad.cuh's sweeps of S and Dc with the packed metric geo[hn_sub[h]] [n_loc][6]
// (w detJ J^-1 J^-T; the subset bricks' cell rows lead geo's brick-cell rows), no scale.
//
// Replaces: BrickLaplaceMM._fill_rows (dealii_matrixfree_hanging_nodes_tpu/bricks.py:2687-2694:
//   _fill_hn_compact, 2728-2773, fed by _extract_cols, 2178-2194, then _hn_apply forward,
//   2244-2258), the constrained rows' `u_hat @ K.T * geo_cell_sub[hn_sub]` (2469-2471) and the
//   transposed _hn_apply (2474). The TPU side ran these as XLA gathers, one-hot MXU matmuls,
//   scatters and one dense [n_loc, n_loc] matmul per mask range and direction (no Pallas
//   kernel). The elastic mode: BrickElasticity's _fill_rows -> el_Kel -> _hn_apply(transpose)
//   (models/elasticity_bricks.py:241-248). The deformed mode: _fill_rows ->
//   _deformed_cell_apply(u_hat, Gq_hn) -> _hn_apply(transpose) (bricks.py:2466-2474,
//   2959-2976). With a RHS axis: _fill_rows -> K -> _hn_apply^T on
//   the [n_hn, k, n_loc] rows of _vmult_multi_impl (bricks.py:3478-3482) and _hn_ids2 (3386).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (16,744 rows, 426,424 fill entries, 25 Q's
//   of 137-881 nonzeros): memory. The distinct brick nodes the rows read, out written once
//   (8.4 MB), the fill lists, keep at one bit a slot and the Q lists: 17.5 MB, 5.2 us at
//   3.35 TB/s (hn_cell.bytes_and_flops); the adds of the entries, the multiply-adds of Q and
//   Q^T and the 7 sweeps (8,875 operations a row) are 0.175 GFLOP, 2.6 us at 67 TFLOP/s.
//
// Design: one block per G contiguous rows (G = 16 at p = 4, 8 at p = 5..8, as cell_apply's
//   groups), the rows held in two shared-memory buffers of G n_loc values from the gather to
//   the write, so no intermediate row goes through device memory:
//   - fill: the block's threads write the masked own nodes into buffer A, each thread's keep
//     flags and then its nodes loaded together (reads along x contiguous); the block's entries
//     are one contiguous range (row_ptr[h0] .. row_ptr[h0+G]), and the thread holding a run's
//     first entry (one row, one slot) sums the run in order and adds it into the slot after
//     the barrier that ends the base write, so no two threads write one slot and no atomics
//     are needed (as fill_hn did, one warp a row). A thread's first run is loaded before that
//     barrier, its checks and first source together, so the two gathers overlap;
//   - Q and Q^T: output (g, j) goes to thread t with g = t % G, j = t / G, so a warp's lanes take
//     one or two slots of all G rows: they walk one entry list (rows of one mask range share
//     their Q; rows are sorted by mask, so a block holds one Q or two) and the list's loads are
//     broadcasts through the read-only path (__ldg), with the row reads spread over the banks
//     (row stride n_loc, odd at p = 4). One thread a (row, slot), as hn_apply did, diverged
//     across a warp's 32 slots of 1 to ~25 entries;
//   - K: cell_apply's 7 sweeps (sum_factorization.cuh), carried over as they are, the rows'
//     scales loaded with the block's tables; the z sweep writes over its own line, so buffer
//     B holds own;
//   - out: Q^T writes into buffer A and the block stores it with 16-byte stores, coalesced.
//   8 barriers a block (4 in the fill mode). The shared-memory limit (above 48 KB at p = 8 in
//   f64) is raised once per device, not on every launch.
//   The elastic mode runs the same phases on three components a row, G rows a block as
//   elasticity.cuh's Cfg gives them (8 at p = 4), in its nine regions: the fill into X, Q into
//   U, the coupled operator on U (X and Y its scratch), Q^T into X, stored; S, Dc and the
//   weights are staged in shared memory (17 barriers a block and 3 a component for the fill).
//   At p=4: 224 threads, 32 registers, 36.7 KB of shared memory in f32 (6 blocks an SM), 73.4 KB
//   in f64 (3); 0.210 ms for 16,744 rows at quadrant nref=7 f32 on an H100 (bound 0.014).
//   Resources (ptxas, sm_90a, CUDA 12.8; no spills, no stack in any instantiation): f32: 32
//   registers at every degree; f64: 32 registers at p = 4, 66 at p = 8; p=4 f32: 416
//   threads, 16.3 KB of shared memory, 4 blocks an SM (the thread limit).
//   What holds it back: a block's phases run one after another, each a short chain of
//   dependent loads (the fill's gathers, the Q lists through L1) or of sweeps, and 4 blocks an
//   SM do not hide them. Tried on the card and not kept (none faster, most slower): staging
//   the block's Q lists in shared memory, 8 rows a block at p = 4 (9 blocks an SM), the Q
//   loops unrolled, each thread's Q ranges loaded ahead, the last product stored straight to
//   device memory, the fill started without the setup barrier.
//   2-D (hn_cell2_kernel, the full and fill modes at p = 1..6): G = 32 rows a block, the same
//   four steps (the fill's base one value a thread in a loop, its runs as above, Q and Q^T
//   by apply_q), K by the two 2-D sweeps on 32 n lines (at least 128 threads). Bound at 2-D
//   quadrant nref=11, p=4, f32 (4,110 rows): memory, 0.9 MB, 0.0003 ms: launch-bound.
//   2-D, the deformed mode: the same kernel with a third row buffer (the second gradient) and S,
//   Dc staged; in place of K's two sweeps, laplace_quad.cuh's 2-D quadrature (laplace_cells2,
//   the metric's 3 values a point read at the points). 2-D, the elastic mode
//   (hn_cell_elastic2_kernel): two components a row, elasticity.cuh's Cfg2 rows a block (256 / n:
//   51 at p = 4), its four regions: the fill into X, Q into U, apply2 on U (X its scratch), Q^T
//   into X, stored. Bound at 2-D quadrant nref=11, p=4, f32 (4,110 rows): memory, ~1-2 MB, a
//   few microseconds: launch-bound.
//   The deformed mode runs the same phases with two more row buffers (the gradients' scratch)
//   and S, Dc staged in shared memory; in place of K's 7 sweeps, laplace_quad.cuh's 12 with the
//   metric read at the points (12 barriers a block). Bound at quadrant nref=7, p=4, f32: memory,
//   the full mode's 17.5 MB less scale plus the rows' metric (50.2 MB), ~68 MB, 0.020 ms.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "elasticity.cuh"
#include "laplace_quad.cuh"
#include "sum_factorization.cuh"

namespace {

using sf::Cfg;
using sf::Factors;

// dst[g, j] = src[g, :] @ Q_g[:, j] for the G rows of the block, Q_g from lists by output slot
// (q[g] < 0: a copy)
template <typename T, int NL, int G, int THREADS>
__device__ __forceinline__ void apply_q(const T* src, T* dst, const int* s_q,
                                        const int* __restrict__ ptr, const int* __restrict__ col,
                                        const T* __restrict__ w) {
  for (int t = threadIdx.x; t < G * NL; t += THREADS) {
    const int j = t / G, g = t % G;
    const int q = s_q[g];
    const T* x = src + g * NL;
    T acc;
    if (q < 0) {
      acc = x[j];
    } else {
      const int* pq = ptr + q * (NL + 1) + j;
      const int e1 = __ldg(pq + 1);
      acc = T(0);
      for (int e = __ldg(pq); e < e1; ++e) acc += __ldg(w + e) * x[__ldg(col + e)];
    }
    dst[g * NL + j] = acc;
  }
}

// The sum of u_flat[ent_src[k]] over the run of entries that starts at e (one row g, one slot
// s; entries sorted by row, then slot), in entry order, with dst = g * NL + s; dst = -1 and 0
// where e is not the first entry of its run.
template <typename T, int G, int NL>
__device__ __forceinline__ T run_sum(int e, const int* s_rp, const int* __restrict__ ent_slot,
                                     const int* __restrict__ ent_src, const T* __restrict__ u,
                                     int& dst) {
  int g = 0;  // the row of entry e: the last g with s_rp[g] <= e
#pragma unroll
  for (int k = 1; k < G; ++k) g += s_rp[k] <= e;
  // the checks and the first source are loaded together: most runs hold one entry
  const int r_end = s_rp[g + 1];
  const int s = ent_slot[e];
  const int prev = e > s_rp[g] ? ent_slot[e - 1] : -1;
  const int next = e + 1 < r_end ? ent_slot[e + 1] : -1;
  const T first = u[ent_src[e]];
  dst = -1;
  if (prev == s) return T(0);  // not the first entry of its run
  T acc = first;
  if (next == s)
    for (int k = e + 1; k < r_end && ent_slot[k] == s; ++k) acc += u[ent_src[k]];
  dst = g * NL + s;
  return acc;
}

// where the deformed mode's scratch starts in shared memory, in values of T: after the two row
// buffers, the scales and the G-row int tables, rounded up to 16 bytes
template <typename T, int P>
__host__ __device__ constexpr int deformed_offset() {
  using S = Cfg<P>;
  constexpr int bytes = (2 * S::SCR + S::G) * sizeof(T) + (4 * S::G + 1) * sizeof(int);
  return (bytes + 15) / 16 * 16 / sizeof(T);
}

// the modes of hn_cell_kernel: the stiffness by K1, M1 times scale; the fill alone; the
// stiffness by the rows' metric
constexpr int FULL = 0, FILL = 1, DEFORMED = 2;

template <typename T, int P, int B, int MODE>
__global__ void __launch_bounds__(Cfg<P>::THREADS)
hn_cell_kernel(const T* __restrict__ u, const int* __restrict__ hn_sub,
               const bool* __restrict__ keep, const int* __restrict__ row_ptr,
               const int* __restrict__ ent_slot, const int* __restrict__ ent_src,
               const int* __restrict__ q_of_row, const int* __restrict__ fwd_ptr,
               const int* __restrict__ fwd_col, const T* __restrict__ fwd_w,
               const int* __restrict__ bwd_ptr, const int* __restrict__ bwd_col,
               const T* __restrict__ bwd_w, const Factors<T, P + 1> f,
               const T* __restrict__ scale, const T* __restrict__ geo,
               const T* __restrict__ Sg, const T* __restrict__ Dg, T* __restrict__ out,
               int n_hn, int N3p, long long u_stride) {
  using S = Cfg<P>;
  constexpr int N = S::N, N2 = S::N2, NL = S::NL, G = S::G;
  constexpr int NB = B * P + 1;
  constexpr int C = B * B * B;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);  // buffer A
  T* sb = sa + S::SCR;                     // buffer B
  T* s_scale = sb + S::SCR;                         // [G] each row's scale (full mode)
  int* s_rp = reinterpret_cast<int*>(s_scale + G);  // [G + 1] the block's row_ptr
  int* s_q = s_rp + G + 1;                          // [G] each row's Q
  int* s_base = s_q + G;                            // [G] each row's cell origin in u
  int* s_cell = s_base + G;                         // [G] each row's cell (deformed mode)
  // the deformed mode's gradient scratch and factors, after the tables (16-byte aligned)
  T* sc = reinterpret_cast<T*>(smem_raw) + deformed_offset<T, P>();
  T* sd = sc + S::SCR;
  T* sS = sd + S::SCR;
  T* sD = sS + S::N * S::N;

  const size_t rhs = blockIdx.y;  // its subset bricks and rows
  u += rhs * u_stride;
  out += rhs * n_hn * NL;
  const int tid = threadIdx.x;
  const int h0 = blockIdx.x * G;
  const int nrows = min(G, n_hn - h0);
  if (tid <= G) s_rp[tid] = row_ptr[min(h0 + tid, n_hn)];
  if (tid < G) {
    int q = -1, base = 0, cell = 0;
    if (tid < nrows) {
      cell = hn_sub[h0 + tid];
      const int brick = cell / C, slot = cell % C;
      const int sx = slot % B, sy = (slot / B) % B, sz = slot / (B * B);
      q = q_of_row[h0 + tid];
      base = brick * N3p + (sz * P * NB + sy * P) * NB + sx * P;
    }
    s_q[tid] = q;
    s_base[tid] = base;
    s_cell[tid] = cell;
    if constexpr (MODE == FULL) s_scale[tid] = tid < nrows ? scale[h0 + tid] : T(0);
  }
  if constexpr (MODE == DEFORMED) lq::stage_factors<T, S::N>(sS, sD, Sg, Dg);
  __syncthreads();

  // 1. fill: the masked own nodes into buffer A; each run of entries (one row, one slot) summed
  //    by the thread holding its first entry. A thread's first run is loaded before the
  //    barrier that ends the base write, so the two gathers overlap; it is added after it.
  const int e0 = s_rp[0] + tid, e_end = s_rp[G];
  int run_dst = -1;
  T acc = e0 < e_end ? run_sum<T, G, NL>(e0, s_rp, ent_slot, ent_src, u, run_dst) : T(0);
  {  // all of a thread's keep flags, then all its nodes, in flight together
    constexpr int IT = (G * NL + S::THREADS - 1) / S::THREADS;
    const bool* kb = keep + static_cast<size_t>(h0) * NL;
    bool kept[IT];
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int t = tid + i * S::THREADS;
      kept[i] = t < nrows * NL && kb[t];
    }
    T v[IT];
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int t = tid + i * S::THREADS, g = t / NL, j = t - g * NL;
      const int ix = j % N, iy = (j / N) % N, iz = j / N2;
      v[i] = kept[i] ? u[s_base[g] + (iz * NB + iy) * NB + ix] : T(0);
    }
#pragma unroll
    for (int i = 0; i < IT; ++i)
      if (tid + i * S::THREADS < G * NL) sa[tid + i * S::THREADS] = v[i];
  }
  __syncthreads();
  if (run_dst >= 0) sa[run_dst] += acc;
  for (int e = e0 + S::THREADS; e < e_end; e += S::THREADS) {  // blocks of many entries
    acc = run_sum<T, G, NL>(e, s_rp, ent_slot, ent_src, u, run_dst);
    if (run_dst >= 0) sa[run_dst] += acc;
  }
  __syncthreads();

  // 2. Q: u_hat into buffer B
  apply_q<T, S::NL, S::G, S::THREADS>(sa, sb, s_q, fwd_ptr, fwd_col, fwd_w);
  __syncthreads();
  T* res = sb;
  if constexpr (MODE == DEFORMED) {
    // 3. the row's stiffness by its metric on buffer B, A, C and D the gradients; own in B
    const int l = tid, g = l / N2, j = l - g * N2;
    const bool active = l < G * N2 && g < nrows;
    const T* mg = geo + static_cast<size_t>(s_cell[g < G ? g : 0]) * NL * 6;
    lq::laplace_cells<T, N>(sb + g * NL, sa + g * NL, sc + g * NL, sd + g * NL, sS, sD, j,
                            active,
                            [=](T* x, T* y, T* z) { lq::metric_line<T, N>(mg, x, y, z, j); });
    // 4. Q^T: out into buffer A
    apply_q<T, S::NL, S::G, S::THREADS>(sb, sa, s_q, bwd_ptr, bwd_col, bwd_w);
    __syncthreads();
    res = sa;
  }
  if constexpr (MODE == FULL) {
    // 3. K: the sweeps on buffer B with A as scratch; own lands in B
    const int l = tid;
    const bool active = l < G * N2;
    if (active) {
      T r[N];
      sf::load_line<T, N, 1>(sb + l * N, r);
      sf::sweep_x(f, r, sb, sa, l);
    }
    __syncthreads();
    if (active) sf::sweep_y(f, sb, sa, l);
    __syncthreads();
    if (active) {
      const int g = l / N2;
      sf::sweep_z(f, sb, sa, l, s_scale[g], sb + g * NL + (l - g * N2));
    }
    __syncthreads();
    // 4. Q^T: out into buffer A
    apply_q<T, S::NL, S::G, S::THREADS>(sb, sa, s_q, bwd_ptr, bwd_col, bwd_w);
    __syncthreads();
    res = sa;
  }
  // the block's rows are contiguous in out: a full tile is whole 16-byte words
  T* dst = out + static_cast<size_t>(h0) * NL;
  sf::copy_block(dst, res, nrows * NL,
                 nrows == G && reinterpret_cast<uintptr_t>(dst) % 16 == 0);
}

// ---- 2-D: constrained rows of n^2 values (x fastest) in bricks of NB^2 nodes (cell slot
// (sx, sy), node (ix, iy) at (sy*p + iy)*NB + sx*p + ix); the full, fill and deformed modes. The
// same four steps with G = 32 rows a block and K's two 2-D sweeps (sweep_x, sweep_y2, 32 n lines)
// or, in the deformed mode, the 2-D quadrature with each row's metric.
template <int P>
struct Cfg2 {
  static constexpr int N = P + 1;
  static constexpr int NL = N * N;
  static constexpr int G = 32;  // rows a block
  static constexpr int LINES = G * N;
  static constexpr int THREADS = LINES < 128 ? 128 : (LINES + 31) / 32 * 32;
  static constexpr int SCR = sf::round4(G * NL);
};

template <typename T, int P, int B, int MODE>
__global__ void __launch_bounds__(Cfg2<P>::THREADS)
hn_cell2_kernel(const T* __restrict__ u, const int* __restrict__ hn_sub,
                const bool* __restrict__ keep, const int* __restrict__ row_ptr,
                const int* __restrict__ ent_slot, const int* __restrict__ ent_src,
                const int* __restrict__ q_of_row, const int* __restrict__ fwd_ptr,
                const int* __restrict__ fwd_col, const T* __restrict__ fwd_w,
                const int* __restrict__ bwd_ptr, const int* __restrict__ bwd_col,
                const T* __restrict__ bwd_w, const Factors<T, P + 1> f,
                const T* __restrict__ scale, const T* __restrict__ geo,
                const T* __restrict__ Sg, const T* __restrict__ Dg, T* __restrict__ out, int n_hn,
                int N3p, long long u_stride) {
  using S = Cfg2<P>;
  constexpr int N = S::N, NL = S::NL, G = S::G;
  constexpr int NB = B * P + 1;
  constexpr int C = B * B;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);  // buffer A
  T* sb = sa + S::SCR;                     // buffer B
  T* sc = sb + S::SCR;                     // buffer C (deformed mode)
  T* sS = sc + S::SCR;                     // [N N] (deformed mode)
  T* sD = sS + N * N;                      // [N N]
  __shared__ T s_scale[G];
  __shared__ int s_rp[G + 1], s_q[G], s_base[G], s_cell[G];

  const size_t rhs = blockIdx.y;
  u += rhs * u_stride;
  out += rhs * n_hn * NL;
  const int tid = threadIdx.x;
  const int h0 = blockIdx.x * G;
  const int nrows = min(G, n_hn - h0);
  if (tid <= G) s_rp[tid] = row_ptr[min(h0 + tid, n_hn)];
  if (tid < G) {
    int q = -1, base = 0, cell = 0;
    if (tid < nrows) {
      cell = hn_sub[h0 + tid];
      const int brick = cell / C, slot = cell % C;
      q = q_of_row[h0 + tid];
      base = brick * N3p + (slot / B) * P * NB + (slot % B) * P;
    }
    s_q[tid] = q;
    s_base[tid] = base;
    s_cell[tid] = cell;
    if constexpr (MODE == FULL) s_scale[tid] = tid < nrows ? scale[h0 + tid] : T(0);
  }
  if constexpr (MODE == DEFORMED) lq::stage_factors<T, N>(sS, sD, Sg, Dg);
  __syncthreads();

  // 1. fill: the masked own nodes into buffer A, then each run of entries (one row, one slot)
  //    summed by the thread holding its first entry and added after the barrier
  for (int t = tid; t < G * NL; t += S::THREADS) {
    const int g = t / NL, j = t - g * NL;
    const bool kept = t < nrows * NL && keep[static_cast<size_t>(h0) * NL + t];
    sa[t] = kept ? u[s_base[g] + (j / N) * NB + j % N] : T(0);
  }
  __syncthreads();
  for (int e = s_rp[0] + tid; e < s_rp[G]; e += S::THREADS) {
    int dst;
    const T acc = run_sum<T, G, NL>(e, s_rp, ent_slot, ent_src, u, dst);
    if (dst >= 0) sa[dst] += acc;
  }
  __syncthreads();

  // 2. Q: u_hat into buffer B
  apply_q<T, NL, G, S::THREADS>(sa, sb, s_q, fwd_ptr, fwd_col, fwd_w);
  __syncthreads();
  T* res = sb;
  if constexpr (MODE == FULL) {
    // 3. K: the two sweeps on buffer B with A as scratch; own lands in B
    const int l = tid;
    const bool active = l < S::LINES;
    if (active) {
      T r[N];
      sf::load_line<T, N, 1>(sb + l * N, r);
      sf::sweep_x(f, r, sb, sa, l);
    }
    __syncthreads();
    if (active) {
      const int g = l / N;
      sf::sweep_y2(f, sb, sa, l, s_scale[g], sb + g * NL + (l - g * N));
    }
    __syncthreads();
    // 4. Q^T: out into buffer A
    apply_q<T, NL, G, S::THREADS>(sb, sa, s_q, bwd_ptr, bwd_col, bwd_w);
    __syncthreads();
    res = sa;
  }
  if constexpr (MODE == DEFORMED) {
    // 3. the row's stiffness by its metric on buffer B, A and C the gradients; own in B
    const int l = tid, g = l / N, j = l - g * N;
    const bool active = l < S::LINES && g < nrows;
    const T* mg = geo + static_cast<size_t>(s_cell[g < G ? g : 0]) * NL * 3;
    lq::laplace_cells2<T, N>(sb + g * NL, sa + g * NL, sc + g * NL, sS, sD, j, active,
                             [=](T* x, T* y) { lq::metric_line2<T, N>(mg, x, y, j); });
    // 4. Q^T: out into buffer A
    apply_q<T, NL, G, S::THREADS>(sb, sa, s_q, bwd_ptr, bwd_col, bwd_w);
    __syncthreads();
    res = sa;
  }
  T* dst = out + static_cast<size_t>(h0) * NL;
  for (int t = tid; t < nrows * NL; t += S::THREADS) dst[t] = res[t];
}

template <typename T, int P, int B, int MODE>
int launch2(const void* const* a, const void* K1, const void* M1, void* out, int n_hn, int N3p,
            int k, long long u_stride, cudaStream_t stream) {
  using S = Cfg2<P>;
  const int smem = static_cast<int>(
      (MODE == DEFORMED ? 3 * S::SCR + 2 * S::N * S::N : 2 * S::SCR) * sizeof(T));
  auto kernel = hn_cell2_kernel<T, P, B, MODE>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  Factors<T, P + 1> f{};
  if (MODE == FULL) {
    std::memcpy(f.K, K1, sizeof(f.K));
    std::memcpy(f.M, M1, sizeof(f.M));
  }
  const int blocks = (n_hn + S::G - 1) / S::G;
  if (blocks > 0 && k > 0) {
    kernel<<<dim3(blocks, k), S::THREADS, smem, stream>>>(
        static_cast<const T*>(a[0]), static_cast<const int*>(a[1]),
        static_cast<const bool*>(a[2]), static_cast<const int*>(a[3]),
        static_cast<const int*>(a[4]), static_cast<const int*>(a[5]),
        static_cast<const int*>(a[6]), static_cast<const int*>(a[7]),
        static_cast<const int*>(a[8]), static_cast<const T*>(a[9]),
        static_cast<const int*>(a[10]), static_cast<const int*>(a[11]),
        static_cast<const T*>(a[12]), f, static_cast<const T*>(a[13]),
        static_cast<const T*>(a[14]), static_cast<const T*>(a[15]),
        static_cast<const T*>(a[16]), static_cast<T*>(out), n_hn, N3p, u_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// The elastic mode: the three components of each constrained row through the fill and Q, the
// coupled operator times scale[h], Q^T; out [3][n_hn][NL].
template <typename T, int P, int B>
__global__ void __launch_bounds__(el::Cfg<P>::THREADS)
hn_cell_elastic_kernel(const T* __restrict__ u, const int* __restrict__ hn_sub,
                       const bool* __restrict__ keep, const int* __restrict__ row_ptr,
                       const int* __restrict__ ent_slot, const int* __restrict__ ent_src,
                       const int* __restrict__ q_of_row, const int* __restrict__ fwd_ptr,
                       const int* __restrict__ fwd_col, const T* __restrict__ fwd_w,
                       const int* __restrict__ bwd_ptr, const int* __restrict__ bwd_col,
                       const T* __restrict__ bwd_w, const T* __restrict__ scale,
                       const T* __restrict__ Sg, const T* __restrict__ Dg,
                       const T* __restrict__ wg, T mu, T lam, T* __restrict__ out, int n_hn,
                       int N3p, long long cstride) {
  using E = el::Cfg<P>;
  constexpr int N = E::N, N2 = E::N2, NL = E::NL, G = E::G, R = E::R, THREADS = E::THREADS;
  constexpr int NB = B * P + 1;
  constexpr int C = B * B * B;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // el's nine regions: U (0..2), X (3..5), Y (6..8)
  T* sS = buf + E::VALUES;
  T* sD = sS + N * N;
  T* sW = sD + N * N;
  __shared__ T s_scale[G];
  __shared__ int s_rp[G + 1], s_q[G], s_base[G];

  const int tid = threadIdx.x;
  const int h0 = blockIdx.x * G;
  const int nrows = min(G, n_hn - h0);
  for (int i = tid; i < N * N; i += THREADS) {
    sS[i] = __ldg(Sg + i);
    sD[i] = __ldg(Dg + i);
  }
  for (int i = tid; i < NL; i += THREADS) sW[i] = __ldg(wg + i);
  if (tid <= G) s_rp[tid] = row_ptr[min(h0 + tid, n_hn)];
  if (tid < G) {
    int q = -1, base = 0;
    if (tid < nrows) {
      const int cell = hn_sub[h0 + tid];
      const int brick = cell / C, slot = cell % C;
      const int sx = slot % B, sy = (slot / B) % B, sz = slot / (B * B);
      q = q_of_row[h0 + tid];
      base = brick * N3p + (sz * P * NB + sy * P) * NB + sx * P;
    }
    s_q[tid] = q;
    s_base[tid] = base;
    s_scale[tid] = tid < nrows ? scale[h0 + tid] : T(0);
  }
  __syncthreads();

  // 1. fill, a component at a time: the masked own nodes into X_c, then each run of entries
  //    (one row, one slot) summed by the thread holding its first entry and added after the
  //    barrier that ends the base write
  T* X = buf + 3 * R;
  const bool* kb = keep + static_cast<size_t>(h0) * NL;
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    const T* uc = u + c * cstride;
    T* xc = X + c * R;
    for (int t = tid; t < G * NL; t += THREADS) {
      const int g = t / NL, j = t - g * NL;
      const int ix = j % N, iy = (j / N) % N, iz = j / N2;
      xc[t] = t < nrows * NL && kb[t] ? uc[s_base[g] + (iz * NB + iy) * NB + ix] : T(0);
    }
    __syncthreads();
    for (int e = s_rp[0] + tid; e < s_rp[G]; e += THREADS) {
      int dst;
      const T acc = run_sum<T, G, NL>(e, s_rp, ent_slot, ent_src, uc, dst);
      if (dst >= 0) xc[dst] += acc;
    }
  }
  __syncthreads();

  // 2. Q: u_hat into U_c
#pragma unroll 1
  for (int c = 0; c < 3; ++c)
    apply_q<T, NL, G, THREADS>(X + c * R, buf + c * R, s_q, fwd_ptr, fwd_col, fwd_w);
  __syncthreads();

  // 3. the coupled operator times scale on U (X and Y its scratch)
  const int l = tid, g = l / N2, j = l - g * N2;
  const bool active = l < G * N2 && g < nrows;
  const T sc = active ? s_scale[g] : T(0);
  const T geo[3] = {sc, sc, sc};
  el::apply<T, P>(buf, sS, sD, sW, mu, lam, geo, g, j, active);

  // 4. Q^T into X_c, then the rows stored, a component at a time
#pragma unroll 1
  for (int c = 0; c < 3; ++c)
    apply_q<T, NL, G, THREADS>(buf + c * R, X + c * R, s_q, bwd_ptr, bwd_col, bwd_w);
  __syncthreads();
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    T* dst = out + (static_cast<size_t>(c) * n_hn + h0) * NL;
    sf::copy_block(dst, X + c * R, nrows * NL,
                   nrows == G && reinterpret_cast<uintptr_t>(dst) % 16 == 0 && (G * NL) % 4 == 0);
  }
}

template <typename T, int P, int B>
int launch_elastic(const void* const* a, double mu, double lam, long long cstride, void* out,
                   int n_hn, int N3p, int* info, cudaStream_t stream) {
  using E = el::Cfg<P>;
  const int smem = static_cast<int>((E::VALUES + 2 * E::N * E::N + E::NL) * sizeof(T));
  auto kernel = hn_cell_elastic_kernel<T, P, B>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info) {  // a dry run: threads, shared memory and blocks per SM, launch nothing
    info[0] = E::THREADS;
    info[1] = smem;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, E::THREADS, smem));
  }
  const int blocks = (n_hn + E::G - 1) / E::G;
  if (blocks > 0) {
    kernel<<<blocks, E::THREADS, smem, stream>>>(
        static_cast<const T*>(a[0]), static_cast<const int*>(a[1]),
        static_cast<const bool*>(a[2]), static_cast<const int*>(a[3]),
        static_cast<const int*>(a[4]), static_cast<const int*>(a[5]),
        static_cast<const int*>(a[6]), static_cast<const int*>(a[7]),
        static_cast<const int*>(a[8]), static_cast<const T*>(a[9]),
        static_cast<const int*>(a[10]), static_cast<const int*>(a[11]),
        static_cast<const T*>(a[12]), static_cast<const T*>(a[13]),
        static_cast<const T*>(a[14]), static_cast<const T*>(a[15]),
        static_cast<const T*>(a[16]), static_cast<T>(mu), static_cast<T>(lam),
        static_cast<T*>(out), n_hn, N3p, cstride);
  }
  return static_cast<int>(cudaGetLastError());
}

// The elastic mode in 2-D: the two components of each constrained row through the fill and Q,
// the 2-D coupled operator times scale[h], Q^T; out [2][n_hn][NL]. elasticity.cuh's Cfg2 rows a
// block in its four regions: U (0, 1), X (2, 3).
template <typename T, int P, int B>
__global__ void __launch_bounds__(el::Cfg2<P>::THREADS)
hn_cell_elastic2_kernel(const T* __restrict__ u, const int* __restrict__ hn_sub,
                        const bool* __restrict__ keep, const int* __restrict__ row_ptr,
                        const int* __restrict__ ent_slot, const int* __restrict__ ent_src,
                        const int* __restrict__ q_of_row, const int* __restrict__ fwd_ptr,
                        const int* __restrict__ fwd_col, const T* __restrict__ fwd_w,
                        const int* __restrict__ bwd_ptr, const int* __restrict__ bwd_col,
                        const T* __restrict__ bwd_w, const T* __restrict__ scale,
                        const T* __restrict__ Sg, const T* __restrict__ Dg,
                        const T* __restrict__ wg, T mu, T lam, T* __restrict__ out, int n_hn,
                        int N3p, long long cstride) {
  using E = el::Cfg2<P>;
  constexpr int N = E::N, NL = E::NL, G = E::G, R = E::R, THREADS = E::THREADS;
  constexpr int NB = B * P + 1;
  constexpr int C = B * B;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // el's four regions: U (0, 1), X (2, 3)
  T* sS = buf + E::VALUES;
  T* sD = sS + N * N;
  T* sW = sD + N * N;
  __shared__ T s_scale[G];
  __shared__ int s_rp[G + 1], s_q[G], s_base[G];

  const int tid = threadIdx.x;
  const int h0 = blockIdx.x * G;
  const int nrows = min(G, n_hn - h0);
  for (int i = tid; i < N * N; i += THREADS) {
    sS[i] = __ldg(Sg + i);
    sD[i] = __ldg(Dg + i);
  }
  for (int i = tid; i < NL; i += THREADS) sW[i] = __ldg(wg + i);
  if (tid <= G) s_rp[tid] = row_ptr[min(h0 + tid, n_hn)];
  if (tid < G) {
    int q = -1, base = 0;
    if (tid < nrows) {
      const int cell = hn_sub[h0 + tid];
      const int brick = cell / C, slot = cell % C;
      q = q_of_row[h0 + tid];
      base = brick * N3p + (slot / B) * P * NB + (slot % B) * P;
    }
    s_q[tid] = q;
    s_base[tid] = base;
    s_scale[tid] = tid < nrows ? scale[h0 + tid] : T(0);
  }
  __syncthreads();

  // 1. fill, a component at a time, into X_c (as hn_cell_elastic_kernel)
  T* X = buf + 2 * R;
  const bool* kb = keep + static_cast<size_t>(h0) * NL;
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    const T* uc = u + c * cstride;
    T* xc = X + c * R;
    for (int t = tid; t < G * NL; t += THREADS) {
      const int g = t / NL, j = t - g * NL;
      xc[t] = t < nrows * NL && kb[t] ? uc[s_base[g] + (j / N) * NB + j % N] : T(0);
    }
    __syncthreads();
    for (int e = s_rp[0] + tid; e < s_rp[G]; e += THREADS) {
      int dst;
      const T acc = run_sum<T, G, NL>(e, s_rp, ent_slot, ent_src, uc, dst);
      if (dst >= 0) xc[dst] += acc;
    }
  }
  __syncthreads();

  // 2. Q: u_hat into U_c
#pragma unroll 1
  for (int c = 0; c < 2; ++c)
    apply_q<T, NL, G, THREADS>(X + c * R, buf + c * R, s_q, fwd_ptr, fwd_col, fwd_w);
  __syncthreads();

  // 3. the 2-D coupled operator times scale on U (X its scratch)
  const int l = tid, g = l / N, j = l - g * N;
  const bool active = l < G * N && g < nrows;
  const T sc = active ? s_scale[g] : T(0);
  const T geo[2] = {sc, sc};
  el::apply2<T, P>(buf, sS, sD, sW, mu, lam, geo, g, j, active);

  // 4. Q^T into X_c, then the rows stored, a component at a time
#pragma unroll 1
  for (int c = 0; c < 2; ++c)
    apply_q<T, NL, G, THREADS>(buf + c * R, X + c * R, s_q, bwd_ptr, bwd_col, bwd_w);
  __syncthreads();
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    T* dst = out + (static_cast<size_t>(c) * n_hn + h0) * NL;
    for (int t = tid; t < nrows * NL; t += THREADS) dst[t] = X[c * R + t];
  }
}

template <typename T, int P, int B>
int launch_elastic2(const void* const* a, double mu, double lam, long long cstride, void* out,
                    int n_hn, int N3p, int* info, cudaStream_t stream) {
  using E = el::Cfg2<P>;
  const int smem = static_cast<int>((E::VALUES + 2 * E::N * E::N + E::NL) * sizeof(T));
  auto kernel = hn_cell_elastic2_kernel<T, P, B>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info) {  // a dry run: threads, shared memory and blocks per SM, launch nothing
    info[0] = E::THREADS;
    info[1] = smem;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, E::THREADS, smem));
  }
  const int blocks = (n_hn + E::G - 1) / E::G;
  if (blocks > 0) {
    kernel<<<blocks, E::THREADS, smem, stream>>>(
        static_cast<const T*>(a[0]), static_cast<const int*>(a[1]),
        static_cast<const bool*>(a[2]), static_cast<const int*>(a[3]),
        static_cast<const int*>(a[4]), static_cast<const int*>(a[5]),
        static_cast<const int*>(a[6]), static_cast<const int*>(a[7]),
        static_cast<const int*>(a[8]), static_cast<const T*>(a[9]),
        static_cast<const int*>(a[10]), static_cast<const int*>(a[11]),
        static_cast<const T*>(a[12]), static_cast<const T*>(a[13]),
        static_cast<const T*>(a[14]), static_cast<const T*>(a[15]),
        static_cast<const T*>(a[16]), static_cast<T>(mu), static_cast<T>(lam),
        static_cast<T*>(out), n_hn, N3p, cstride);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_elastic(const void* const* a, double mu, double lam, long long cstride, void* out,
                     int n_hn, int p, int B, int N3p, int* info, int dim, cudaStream_t stream) {
#define EL_CASE2(p_, b_) \
  if (dim == 2 && p == p_ && B == b_) \
    return launch_elastic2<T, p_, b_>(a, mu, lam, cstride, out, n_hn, N3p, info, stream);
  EL_CASE2(1, 16)
  EL_CASE2(2, 16)
  EL_CASE2(3, 16)
  EL_CASE2(4, 8)
  EL_CASE2(5, 8)
  EL_CASE2(6, 8)
#undef EL_CASE2
  if (dim != 3) return static_cast<int>(cudaErrorInvalidValue);
#define EL_CASE(p_, b_) \
  if (p == p_ && B == b_) \
    return launch_elastic<T, p_, b_>(a, mu, lam, cstride, out, n_hn, N3p, info, stream);
  EL_CASE(1, 16)
  EL_CASE(2, 8)
  EL_CASE(3, 4)
  EL_CASE(4, 4)
  EL_CASE(5, 2)
  EL_CASE(6, 2)
  EL_CASE(7, 2)
  EL_CASE(8, 2)
#undef EL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int P, int B, int MODE>
int launch(const void* const* a, const void* K1, const void* M1, void* out, int n_hn, int N3p,
           int k, long long u_stride, cudaStream_t stream) {
  using S = Cfg<P>;
  // the rows' two buffers and their scales, then row_ptr, q, the cell origins and the cells;
  // in the deformed mode two more buffers and S, Dc after them
  const int smem = MODE == DEFORMED
                       ? static_cast<int>((deformed_offset<T, P>() + 2 * S::SCR +
                                           2 * S::N * S::N) * sizeof(T))
                       : static_cast<int>(deformed_offset<T, P>() * sizeof(T));
  auto kernel = hn_cell_kernel<T, P, B, MODE>;
  static unsigned long long smem_set = 0;
  cudaError_t err = sf::allow_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  Factors<T, P + 1> f{};
  if (MODE == FULL) {
    std::memcpy(f.K, K1, sizeof(f.K));
    std::memcpy(f.M, M1, sizeof(f.M));
  }
  const int blocks = (n_hn + S::G - 1) / S::G;
  if (blocks > 0 && k > 0) {
    kernel<<<dim3(blocks, k), S::THREADS, smem, stream>>>(
        static_cast<const T*>(a[0]), static_cast<const int*>(a[1]),
        static_cast<const bool*>(a[2]), static_cast<const int*>(a[3]),
        static_cast<const int*>(a[4]), static_cast<const int*>(a[5]),
        static_cast<const int*>(a[6]), static_cast<const int*>(a[7]),
        static_cast<const int*>(a[8]), static_cast<const T*>(a[9]),
        static_cast<const int*>(a[10]), static_cast<const int*>(a[11]),
        static_cast<const T*>(a[12]), f, static_cast<const T*>(a[13]),
        static_cast<const T*>(a[14]), static_cast<const T*>(a[15]),
        static_cast<const T*>(a[16]), static_cast<T*>(out), n_hn, N3p, u_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// (p, B) as the brick size rule gives them: B = 16, 8, 4 at p = 1, 2, 3 and 4; B = 2 at p = 5..8
template <typename T>
int dispatch(const void* const* a, const void* K1, const void* M1, void* out, int n_hn, int p,
             int B, int N3p, int mode, int k, long long u_stride, int dim, cudaStream_t stream) {
  // 2-D, the full, fill and deformed modes: B = 16 at p = 1..3, B = 8 at p = 4..6
#define HN_CASE2(p_, b_)                                                                      \
  if (dim == 2 && p == p_ && B == b_)                                                         \
    return mode == FILL                                                                       \
               ? launch2<T, p_, b_, FILL>(a, K1, M1, out, n_hn, N3p, k, u_stride, stream)     \
           : mode == DEFORMED                                                                 \
               ? launch2<T, p_, b_, DEFORMED>(a, K1, M1, out, n_hn, N3p, k, u_stride, stream) \
               : launch2<T, p_, b_, FULL>(a, K1, M1, out, n_hn, N3p, k, u_stride, stream);
  HN_CASE2(1, 16)
  HN_CASE2(2, 16)
  HN_CASE2(3, 16)
  HN_CASE2(4, 8)
  HN_CASE2(5, 8)
  HN_CASE2(6, 8)
#undef HN_CASE2
  if (dim != 3) return static_cast<int>(cudaErrorInvalidValue);
#define HN_CASE(p_, b_)                                                                     \
  if (p == p_ && B == b_)                                                                   \
    return mode == FILL                                                                     \
               ? launch<T, p_, b_, FILL>(a, K1, M1, out, n_hn, N3p, k, u_stride, stream)    \
           : mode == DEFORMED                                                               \
               ? launch<T, p_, b_, DEFORMED>(a, K1, M1, out, n_hn, N3p, k, u_stride, stream) \
               : launch<T, p_, b_, FULL>(a, K1, M1, out, n_hn, N3p, k, u_stride, stream);
  HN_CASE(1, 16)
  HN_CASE(2, 8)
  HN_CASE(3, 4)
  HN_CASE(4, 4)
  HN_CASE(5, 2)
  HN_CASE(6, 2)
  HN_CASE(7, 2)
  HN_CASE(8, 2)
#undef HN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// a: device pointers, in order: u, hn_sub, keep, row_ptr, ent_slot, ent_src, q_of_row, fwd_ptr,
// fwd_col, fwd_w, bwd_ptr, bwd_col, bwd_w, scale, geo, S, Dc (bwd_* unread in the fill mode,
// scale read in the full mode only, geo, S and Dc in the deformed mode only).
// K1, M1: host pointers to the 1-D factors (copied into the launch's parameters; read in the
// full mode only). mode: 0 full, 1 fill, 2 deformed. k right-hand sides, u_stride values apart
// in u (n_hn * n_loc apart in out). dim: 3, or 2 (rows of (p+1)^2 values in NB^2-node bricks;
// geo [n_rows][(p+1)^2][3] in the deformed mode).
int hn_cell_f32(const void* const* a, const void* K1, const void* M1, void* out, int n_hn,
                int p, int B, int N3p, int mode, int k, long long u_stride, int dim,
                void* stream) {
  return dispatch<float>(a, K1, M1, out, n_hn, p, B, N3p, mode, k, u_stride, dim,
                         static_cast<cudaStream_t>(stream));
}

int hn_cell_f64(const void* const* a, const void* K1, const void* M1, void* out, int n_hn,
                int p, int B, int N3p, int mode, int k, long long u_stride, int dim,
                void* stream) {
  return dispatch<double>(a, K1, M1, out, n_hn, p, B, N3p, mode, k, u_stride, dim,
                          static_cast<cudaStream_t>(stream));
}

// The elastic mode. a: device pointers, in order: u (component 0 of component brick vectors
// cstride values apart), hn_sub, keep, row_ptr, ent_slot, ent_src, q_of_row, fwd_ptr, fwd_col,
// fwd_w, bwd_ptr, bwd_col, bwd_w, scale, S, Dc, w. info: null to launch; else [threads,
// shared-memory bytes, blocks per SM], not launched. dim: 3 (three components of (p+1)^3
// values) or 2 (two of (p+1)^2).
int hn_cell_elastic_f32(const void* const* a, double mu, double lam, long long cstride,
                        void* out, int n_hn, int p, int B, int N3p, int* info, int dim,
                        void* stream) {
  return dispatch_elastic<float>(a, mu, lam, cstride, out, n_hn, p, B, N3p, info, dim,
                                 static_cast<cudaStream_t>(stream));
}

int hn_cell_elastic_f64(const void* const* a, double mu, double lam, long long cstride,
                        void* out, int n_hn, int p, int B, int N3p, int* info, int dim,
                        void* stream) {
  return dispatch_elastic<double>(a, mu, lam, cstride, out, n_hn, p, B, N3p, info, dim,
                                  static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
