// brick_elasticity: linear elasticity's coupled brick operator times the brick's geometry factor,
// on component brick vectors u [3, nb, N3p] (node (z, y, x) of a brick at (z*NB + y)*NB + x,
// N3 = NB^3 nodes, padded to N3p, component-major):
//   v_c,b = geo_b sum_k A_ck u_k,b,
//   A_cc = mu sum_a K_a + (mu + lam) K_c          (K_a: Kb along axis a, Mb along the others)
//   A_ck = M_m (x) (mu G_k GT_c + lam G_c GT_k)    (k != c, m the third axis; G_a: Gb along a)
// with the brick-assembled 1-D factors Kb = D^T W D, Mb = S^T W S, Gb = D^T W S (cell blocks
// summed along the brick, elasticity_bricks.py:105-122) and Gb^T; and on the first m bricks, as
// an epilogue, the overlap-add of each component's cell rows: v_c,b[node] += the 1-8 entries
// dcols[c][b*B^3 + slot, j] of the (cell slot, local node) pairs on that node (dcols [3, m*B^3,
// n_loc], n_loc = (p+1)^3, NB = B*p + 1, slots and local nodes x fastest), as brick_apply.cu.
//
// Replaces: BrickElasticity._main_apply (dealii_matrixfree_hanging_nodes_tpu/models/
//   elasticity_bricks.py:184-213: per output component and input component the precombined
//   [NB^2, NB^2] plane operators el_P{c}{k}_{z} on the MXU, then the z factors el_z_*) times geo
//   (216-222), and, in the epilogue, _scatter_cols with _subset_scatter_add_multi
//   (elasticity_bricks.py:250-254; bricks.py:3350, 2196-2241). XLA dots on the TPU (no Pallas
//   kernel).
//
// Bound on an H100 SXM at quadrant nref=7, p=4, f32 (4400 bricks, NB=17, N3p=4992, 1025 bricks
//   with cell rows; brick_elasticity.bytes_and_flops): bytes. u's 3 N3 nodes are read once
//   (259.5 MB), v is written once with its padding (263.6 MB), the cell rows read once
//   (98.4 MB): 621.4 MB, 0.1855 ms at 3.35 TB/s. The least sum-factorized schedule applies a
//   factor (97 structural nonzeros a line at p=4) to every line 45 times a brick (along x each
//   input's 4 distinct factors, along y its 7 distinct (x, y) pairs, along z each output's 4
//   distinct factors with its terms grouped across inputs; brick_elasticity.least_schedule):
//   12.1 GFLOP, 0.181 ms at 67 TFLOP/s (f32 outside the tensor cores), under the bytes' time.
//
// Design: one block per (brick, output component c), blocks of a brick adjacent (blockIdx =
//   3 b + c), so the three read the brick's components close in time and L2 serves two of the
//   three reads. For each input component k the block stages u_k's brick in shared memory
//   (cp.async) and runs three rounds of 1-D sweeps, one line per thread (NB^2 lines):
//     x round, line (z, y): a = X_a u, b = X_b u          (in place over u, and a second buffer)
//     y round, line (z, x): c1 = s_a Y_1a a + s_b Y_1b b, c2 = Y_2 b   (in place)
//     z round, line (y, x): acc += t_1 Z_1 c1 + t_2 Z_2 c2 (acc in registers across the k's)
//   with, for k == c: X = (K, M), c1 = alpha_x M a + alpha_y K b, c2 = M b, acc += M c1 +
//   alpha_z K c2 (alpha_a = mu, plus mu + lam on axis c); for k != c with F1 (mu's term: G on k,
//   GT on c, M on m) and F2 (lam's: G on c, GT on k): X = (F1_x, F2_x), c1 = F1_y a, c2 = F2_y b,
//   acc += mu F1_z c1 + lam F2_z c2. Where both terms of an off-diagonal block have M along x
//   (the blocks (1, 2), (2, 1)) the x round sweeps u once (b = a); where they have M along z
//   ((0, 1), (1, 0)) the z round sweeps mu c1 + lam c2 once: 53 line applications a brick,
//   against the 57 of the same schedule without the merges (and the least schedule's 45).
//   After the three k's: v = geo acc plus the cell rows' entries (summed in brick_apply's fixed
//   order, read from device memory), stored coalesced. The (c, k) pairs are template
//   parameters, so each pair's factor choice folds at compile time. The factors travel with
//   the launch as its parameters (the constant bank), every entry an operand of its FMA, and
//   as the 1-D cell factors K1, M1, G1, G1^T the brick's factors are assembled from (the
//   operator's cell_factor_tables, passed by the wrapper): a row of a brick factor is a cell
//   block's row, or two on a cell boundary (cell_dot), written out at compile time. So a sweep
//   reads (p+1)^2 constants a factor, not the brick band's 1 + B p (p+2) (97 at p=4, 193 in
//   2-D at NB=33): with the band's entries as its constants the constant cache missed, and
//   this kernel took 0.7093-0.7155 ms, the 2-D one 0.4852-0.4965, against 0.5705-0.5756 and 0.3381-0.3394 with the cell factors
//   (A/B timings, both builds in one process, as kernel_ab.py times a variant; quadrant
//   nref=7 p=4 f32 and 2-D nref=11, H100 80GB HBM3 at 700 W).
//   Resources (ptxas, sm_90a; chip_smoke.py phase 2 prints every instance's): 2 buffers of N3
//   values (39.3 KB in f32, 78.6 KB in f64 at NB=17), 320 threads; the launch bounds ask for 3
//   blocks an SM in f32 (64 registers at p=4, no spills).
//   Designs measured and not kept (A/B timings of working versions of this source, quadrant
//   nref=7 p=4 f32, H100 80GB HBM3 at 700 W; the design above, still on the band's constants,
//   0.7093-0.7155 ms, without the shared sweeps 0.7356-0.7428 ms in the same calls): one block a
//   brick for all three outputs on the least schedule, the brick streamed plane by plane in z
//   (x and y rounds a plane, the z round into a register window by the cell factors),
//   2.7256-2.7396 ms; a cluster of the brick's three blocks each staging one input and the
//   others reading it through distributed shared memory, 2.6667-2.6773 ms reading lines in
//   place and 0.8337-0.8372 ms copying the brick first; each input prefetched by cp.async
//   while the last one computes, 0.7523-0.7590 ms; one block a brick for its three outputs
//   with the inputs in turn (49 line applications, the x round's four factors and one y round
//   a group of terms in shared memory, the outputs' accumulators in registers),
//   9.9609-9.9643 ms. The plane and per-input designs run more, shorter rounds a brick with a
//   barrier each.
//
// 2-D (brick_elasticity2_kernel; the reference's 2-D branch, models/elasticity_bricks.py:205-213,
// one dense [NB^2, NB^2] el_A{c}{k} a block on the MXU): two components on bricks of NB^2 nodes
// (node (y, x) at y*NB + x), B = 16 at p = 1..3, 8 at p = 4..6,
//   A_cc = (mu + [c == 0](mu + lam)) My (x) Kx + (mu + [c == 1](mu + lam)) Ky (x) Mx,
//   A_ck = mu F1y (x) F1x + lam F2y (x) F2x   (k != c; F1: G on k, GT on c; F2: G on c, GT on k),
// computed as brick_apply2_kernel computes the Laplace, not as the dense product: a block takes
// G bricks (Cfg2; its shared memory about 110 KB at most: 3 bricks in f32 at NB=33) and both
// outputs, stages both inputs (cp.async), and runs
//   x round, line (k, g, y): X_kf = F_x u_k for the four x factors of input k (X_kK over u_k);
//   y round, line (c, g, x): v_c = geo (sum of the output's four terms coef F_y X_kf) plus the
//     cell rows' 1-4 entries (y cells outer, then x), straight to device memory;
// 16 factor applications a brick, the least schedule's (least_schedule(2)), each input's x round
// once for both outputs (the design it replaces took a block per output and swept each input's
// x round for each: 0.5517-0.5627 ms against 0.4852-0.4965 at 2-D quadrant nref=11 p=4 f32,
// both on the band's constants; 0.3381-0.3394 on the cell factors; A/B timings, H100).
// Threads take their lines output-major, so a warp straddles the two outputs' code in one
// place only; 1 and 2 bricks a block measured 0.5273-0.5323 and 0.4988-0.5080 ms. The rows
// are written out at compile time (brick_band.cuh's each_row: left to #pragma unroll the
// NB = 33..49 loops stay rolled).
// Bound at 2-D quadrant nref=11 p=4 f32 (16,646 bricks, NB=33, N3p=1152, 517 bricks with cell
//   rows; brick_elasticity.bytes_and_flops): bytes. u's 2 NB^2 nodes read once, v written with
//   its padding, the cell rows: 305.1 MB, 0.091 ms at 3.35 TB/s; the least schedule's 3.72 GFLOP,
//   0.056 ms at 67 TFLOP/s.

#include <cuda_runtime.h>

#include <cstdint>

#include "brick_band.cuh"


namespace {

constexpr int FK = 0, FM = 1, FG = 2, FGT = 3;

// the factor along axis ax of D_a^T W D_b (brick_elasticity.axis_factors)
__host__ __device__ constexpr int axis_factor(int ax, int a, int b) {
  return ax == a && ax == b ? FK : ax == a ? FG : ax == b ? FGT : FM;
}

// A 2-D Kronecker term of an output: input k, its x factor, coefficient cmu mu + clam lam
struct Term {
  int k, fx, cmu, clam;
};
struct Terms {
  Term t[4];
  int n;
};

// add the term (coefficient cmu mu + clam lam) D_a^T W D_b of input k to L if its factor along
// y is fy; a term with the same factors adds to the coefficient
__host__ __device__ constexpr void add_term(Terms& L, int fy, int k, int a, int b, int cmu,
                                            int clam) {
  if (axis_factor(1, a, b) != fy) return;
  const int fx = axis_factor(0, a, b);
  for (int i = 0; i < L.n; ++i) {
    if (L.t[i].k == k && L.t[i].fx == fx) {
      L.t[i].cmu += cmu;
      L.t[i].clam += clam;
      return;
    }
  }
  L.t[L.n++] = Term{k, fx, cmu, clam};
}

// The 2-D terms of output c whose y factor is fy, over the inputs k (brick_elasticity.terms: mu
// along each axis on the diagonal block, mu D_k^T W D_c and lam D_c^T W D_k)
__host__ __device__ constexpr Terms terms_of(int c, int fy) {
  Terms L{};
  for (int k = 0; k < 2; ++k) {
    if (k == c) {
      for (int ax = 0; ax < 2; ++ax) add_term(L, fy, k, ax, ax, 1, 0);
    }
    add_term(L, fy, k, k, c, 1, 0);
    add_term(L, fy, k, c, k, 0, 1);
  }
  return L;
}

// cp.async 16-byte copies into shared memory
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ void stage(T* __restrict__ dst, const T* __restrict__ src, int count,
                                      bool vec) {
  if (vec) {
    constexpr int VW = 16 / sizeof(T);
    for (int i = threadIdx.x; i * VW < count; i += blockDim.x)
      cp_async16(dst + i * VW, src + i * VW);
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  }
}

// The 1-2 (cell, local node) pairs of coordinate c along one axis (brick_apply.cu's).
template <int NB, int P>
__device__ __forceinline__ int axis_terms(int c, int cell_stride, int loc_stride, int (&off)[2]) {
  const int q = c / P, r = c - q * P;
  if (c == NB - 1) {
    off[0] = (q - 1) * cell_stride + P * loc_stride;
    return 1;
  }
  if (r == 0 && c > 0) {
    off[0] = (q - 1) * cell_stride + P * loc_stride;
    off[1] = q * cell_stride;
    return 2;
  }
  off[0] = q * cell_stride + r * loc_stride;
  return 1;
}

// Row I of the brick factor FI times the line r, from its cell factor F1[FI] (the brick factor
// is F1's blocks summed along the brick): a node inside cell q = I / P takes row I - q P of F1
// on the cell's p+1 nodes; a node on the boundary of cells q-1 and q takes row P on cell q-1's
// nodes, then row 0 on cell q's. The constants are F1's (p+1)^2 a factor, not the brick band's.
template <typename T, int NB, int P, int FI, int I, typename Fac>
__device__ __forceinline__ T cell_dot(const Fac& f, const T (&r)[NB]) {
  constexpr int B = (NB - 1) / P, q = I / P, s = I - q * P;
  T a = T(0);
  if constexpr (s == 0 && q > 0) {
#pragma unroll
    for (int j = 0; j <= P; ++j) a += f.F1[FI][P][j] * r[(q - 1) * P + j];
  }
  if constexpr (q < B) {
#pragma unroll
    for (int j = 0; j <= P; ++j) a += f.F1[FI][s][j] * r[q * P + j];
  }
  return a;
}

// out[i * OS] = row i of factor FI times r, for every row i
template <typename T, int NB, int P, int FI, int OS, typename Fac>
__device__ __forceinline__ void factor_rows(const Fac& f, const T (&r)[NB], T* out) {
  each_row<NB>([&](auto ic) {
    out[decltype(ic)::value * OS] = cell_dot<T, NB, P, FI, decltype(ic)::value>(f, r);
  });
}

// The 1-D cell factors K1, M1, G1, G1^T (FK, FM, FG, FGT) of a brick's factors, the kernels'
// launch parameters.
template <typename T, int P>
struct Factors {
  T F1[4][P + 1][P + 1];
};

// F1 from the host's float64 cell factors [4][P+1][P+1] (brick_elasticity.cell_factor_tables)
template <typename T, int P>
Factors<T, P> factors_from(const double* host) {
  Factors<T, P> f;
  for (int fi = 0; fi < 4; ++fi)
    for (int i = 0; i <= P; ++i)
      for (int j = 0; j <= P; ++j)
        f.F1[fi][i][j] = static_cast<T>(host[(fi * (P + 1) + i) * (P + 1) + j]);
  return f;
}

template <typename T, int NB, int P>
struct Cfg {
  static constexpr int B = (NB - 1) / P;
  static constexpr int N2 = NB * NB;
  static constexpr int N3 = N2 * NB;
  static constexpr int VW = 16 / sizeof(T);
  static constexpr int N3R = (N3 + VW - 1) / VW * VW;
  static constexpr int NL = (P + 1) * (P + 1) * (P + 1);
  static constexpr int DC = B * B * B * NL;  // a brick's cell rows of one component
  static constexpr int THREADS = (N2 + 31) / 32 * 32;
  // blocks an SM the registers must allow in f32: 3 at NB=17 (64 registers; 2 blocks, 96
  // registers, measured 0.608 ms against 0.571; left to itself ptxas took 116 registers, one
  // block an SM); f64 takes the registers its lines need (at 2 blocks, 96, it spilled)
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 3 : 1;
};


// the factor of axis ax in the mu term (F1: G on k, GT on c) and the lam term (F2: G on c, GT on
// k) of an off-diagonal block (c, k), M on the third axis
__host__ __device__ constexpr int f1(int ax, int c, int k) { return axis_factor(ax, k, c); }
__host__ __device__ constexpr int f2(int ax, int c, int k) { return axis_factor(ax, c, k); }

// The rounds of block (C, K) on input K's brick, staged in s0, accumulating into acc (line
// (y, x) = l). Every thread calls it (it holds the barriers).
template <typename T, int NB, int P, int C, int K, typename Fac>
__device__ __forceinline__ void pair(const Fac& f, T* s0, T* s1, T (&acc)[NB], T mu, T lam,
                                     bool active) {
  using S = Cfg<T, NB, P>;
  constexpr int N2 = S::N2;
  constexpr bool DIAG = C == K;
  constexpr int XA = DIAG ? FK : f1(0, C, K), XB = DIAG ? FM : f2(0, C, K);
  constexpr int Y1A = DIAG ? FM : f1(1, C, K), Y1B = DIAG ? FK : -1;
  constexpr int Y2B = DIAG ? FM : f2(1, C, K);
  constexpr int Z1 = DIAG ? FM : f1(2, C, K), Z2 = DIAG ? FK : f2(2, C, K);
  // coefficients: the diagonal block's alpha_a = mu (+ mu + lam on axis C)
  const T al[3] = {C == 0 ? 2 * mu + lam : mu, C == 1 ? 2 * mu + lam : mu,
                   C == 2 ? 2 * mu + lam : mu};
  const T s1a = DIAG ? al[0] : T(1), s1b = DIAG ? al[1] : T(0);
  const T t1 = DIAG ? T(1) : mu, t2 = DIAG ? al[2] : lam;
  const int l = threadIdx.x;

  // blocks whose two terms share the x factor (the third axis x: (1, 2), (2, 1)) sweep it once
  constexpr bool SAME_X = XA == XB;
  // and whose two terms share the z factor (the third axis z: (0, 1), (1, 0)) sum before it
  constexpr bool SAME_Z = Z1 == Z2;

  // x round: line l = (z, y), contiguous
  if (active) {
    T r[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) r[j] = s0[l * NB + j];
    factor_rows<T, NB, P, XA, 1>(f, r, s0 + l * NB);
    if constexpr (!SAME_X) factor_rows<T, NB, P, XB, 1>(f, r, s1 + l * NB);
  }
  __syncthreads();
  // y round: line l = (z, x), stride NB
  if (active) {
    const int z = l / NB;
    const int o = z * N2 + (l - z * NB);
    T a[NB], b[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      a[j] = s0[o + j * NB];
      b[j] = SAME_X ? a[j] : s1[o + j * NB];
    }
    each_row<NB>([&](auto ic) {
      constexpr int i = decltype(ic)::value;
      T c1 = s1a * cell_dot<T, NB, P, Y1A, i>(f, a);
      if constexpr (Y1B >= 0) c1 += s1b * cell_dot<T, NB, P, Y1B, i>(f, b);
      s0[o + i * NB] = c1;
      s1[o + i * NB] = cell_dot<T, NB, P, Y2B, i>(f, b);
    });
  }
  __syncthreads();
  // z round: line l = (y, x), stride N2, into the accumulators
  if (active) {
    T c1[NB], c2[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      c1[j] = s0[l + j * N2];
      c2[j] = s1[l + j * N2];
    }
    if constexpr (SAME_Z) {
#pragma unroll
      for (int j = 0; j < NB; ++j) c1[j] = t1 * c1[j] + t2 * c2[j];
      each_row<NB>([&](auto ic) {
        constexpr int i = decltype(ic)::value;
        acc[i] += cell_dot<T, NB, P, Z1, i>(f, c1);
      });
    } else {
      each_row<NB>([&](auto ic) {
        constexpr int i = decltype(ic)::value;
        acc[i] += t1 * cell_dot<T, NB, P, Z1, i>(f, c1) + t2 * cell_dot<T, NB, P, Z2, i>(f, c2);
      });
    }
  }
  __syncthreads();  // s0, s1 free for the next input component
}

// output C's rounds over the three inputs, each staged into s0 (cp.async) in turn
template <typename T, int NB, int P, int C, typename Fac>
__device__ __forceinline__ void output(const Fac& f, const T* ub, long long cstride, T* s0, T* s1,
                                       T (&acc)[NB], T mu, T lam, bool vec, bool active) {
  each_row<3>([&](auto kc) {
    stage(s0, ub + decltype(kc)::value * cstride, Cfg<T, NB, P>::N3, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    pair<T, NB, P, C, decltype(kc)::value>(f, s0, s1, acc, mu, lam, active);
  });
}

template <typename T, int NB, int P>
__global__ void __launch_bounds__(Cfg<T, NB, P>::THREADS, Cfg<T, NB, P>::MIN_BLOCKS)
brick_elasticity_kernel(const T* __restrict__ u, const Factors<T, P> f,
                        const T* __restrict__ geo, const T* __restrict__ dcols,
                        T* __restrict__ v, T mu, T lam, int nb, int m, int N3p, int vec_u) {
  using S = Cfg<T, NB, P>;
  constexpr int N2 = S::N2, N3 = S::N3, N = P + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const s0 = reinterpret_cast<T*>(smem_raw);  // u_k, then a, then c1
  T* const s1 = s0 + S::N3R;                      // b, then c2

  const int b = blockIdx.x / 3, c = blockIdx.x - 3 * b;
  const long long cstride = static_cast<long long>(nb) * N3p;
  T* const vb = v + c * cstride + static_cast<size_t>(b) * N3p;
  for (int i = N3 + threadIdx.x; i < N3p; i += blockDim.x) vb[i] = T(0);
  const int l = threadIdx.x;
  const bool active = l < N2;
  T acc[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) acc[i] = T(0);
  const T* const ub = u + static_cast<size_t>(b) * N3p;
  if (c == 0) output<T, NB, P, 0>(f, ub, cstride, s0, s1, acc, mu, lam, vec_u, active);
  if (c == 1) output<T, NB, P, 1>(f, ub, cstride, s0, s1, acc, mu, lam, vec_u, active);
  if (c == 2) output<T, NB, P, 2>(f, ub, cstride, s0, s1, acc, mu, lam, vec_u, active);
  if (!active) return;

  // v = geo acc, plus the cell rows' entries on the first m bricks
  const bool rows = b < m;
  const T* const dr = dcols + (static_cast<size_t>(c) * m + b) * S::DC;
  int oy[2] = {0, 0}, ox[2] = {0, 0};
  const int ny = axis_terms<NB, P>(l / NB, S::B * S::NL, N, oy);
  const int nx = axis_terms<NB, P>(l % NB, S::NL, 1, ox);
  const T g = geo[b];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    T out = g * acc[i];
    if (rows) {
      int oz[2] = {0, 0};
      const int nz = axis_terms<NB, P>(i, S::B * S::B * S::NL, N * N, oz);
      T corr = T(0);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
            if (a < nz && bb < ny && cc < nx) corr += dr[oz[a] + oy[bb] + ox[cc]];
      out += corr;
    }
    vb[l + i * N2] = out;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(done & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done |= bit;
  }
  return cudaSuccess;
}

template <typename T, int NB, int P>
int launch(const void* u, const double* factors, const void* geo, const void* dcols, void* v,
           double mu, double lam, int nb, int m, int N3p, int* info, cudaStream_t stream) {
  using S = Cfg<T, NB, P>;
  const int smem = static_cast<int>(2 * S::N3R * sizeof(T));
  auto kernel = brick_elasticity_kernel<T, NB, P>;
  static unsigned long long done = 0;  // bit d: the shared-memory limit raised on device d
  const cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info) {  // a dry run: threads, shared memory and blocks per SM, launch nothing
    info[0] = S::THREADS;
    info[1] = smem;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, S::THREADS, smem));
  }
  const Factors<T, P> f = factors_from<T, P>(factors);
  const int vec_u = reinterpret_cast<uintptr_t>(u) % 16 == 0 && (N3p * sizeof(T)) % 16 == 0;
  if (nb > 0) {
    kernel<<<3 * nb, S::THREADS, smem, stream>>>(
        static_cast<const T*>(u), f, static_cast<const T*>(geo), static_cast<const T*>(dcols),
        static_cast<T*>(v), static_cast<T>(mu), static_cast<T>(lam), nb, m, N3p, vec_u);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- 2-D --------------------------------------------------------------------------------------
template <typename T, int NB, int P>
struct Cfg2 {
  static constexpr int B = (NB - 1) / P;
  static constexpr int N2 = NB * NB;
  static constexpr int N2R = (N2 + 3) / 4 * 4;  // a brick plane, 16-byte aligned
  static constexpr int NL = (P + 1) * (P + 1);
  static constexpr int DC = B * B * NL;  // a brick's cell rows of one component
  static constexpr int BRICK = 8 * N2R * static_cast<int>(sizeof(T));  // X_kf, k = 0, 1
  // bricks a block: at most 8, about 110 KB of shared memory, at most 512 threads
  static constexpr int G_SMEM = 110 * 1024 / BRICK > 0 ? 110 * 1024 / BRICK : 1;
  static constexpr int G_THREADS = 256 / NB;  // 2 G NB threads at most 512
  static constexpr int G = G_SMEM < G_THREADS ? (G_SMEM < 8 ? G_SMEM : 8)
                                              : (G_THREADS < 8 ? G_THREADS : 8);
  static constexpr int THREADS = (2 * G * NB + 31) / 32 * 32;
};


// 2-D x round, line (k, y) of brick g: u_k's line y (over X_kK) through the four x factors
template <typename T, int NB, int P, typename Fac>
__device__ __forceinline__ void x_line2(const Fac& f, T* Xg, int k, int y) {
  using S = Cfg2<T, NB, P>;
  T* const base = Xg + 4 * k * S::N2R + y * NB;
  T r[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) r[j] = base[j];
  factor_rows<T, NB, P, FK, 1>(f, r, base);
  factor_rows<T, NB, P, FM, 1>(f, r, base + S::N2R);
  factor_rows<T, NB, P, FG, 1>(f, r, base + 2 * S::N2R);
  factor_rows<T, NB, P, FGT, 1>(f, r, base + 3 * S::N2R);
}

// 2-D y round of output C on column x of brick g: the output's terms summed down the column,
// times geo, plus the cell rows, to v_C's brick row
template <typename T, int NB, int P, int C, typename Fac>
__device__ __forceinline__ void y_line2(const Fac& f, const T* Xg, T* __restrict__ vb,
                                        const T* __restrict__ db, int x, T gb, T mu, T lam,
                                        bool rows) {
  using S = Cfg2<T, NB, P>;
  constexpr int N = P + 1;
  T o[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) o[i] = T(0);
  each_row<4>([&](auto fc) {  // the terms by their y factor
    constexpr Terms L = terms_of(C, decltype(fc)::value);
    each_row<L.n>([&](auto tc) {
      constexpr Term tm = L.t[decltype(tc)::value];
      const T coef = T(tm.cmu) * mu + T(tm.clam) * lam;
      T col[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) col[j] = Xg[(4 * tm.k + tm.fx) * S::N2R + j * NB + x];
      each_row<NB>([&](auto ic) {
        constexpr int i = decltype(ic)::value;
        o[i] += coef * cell_dot<T, NB, P, decltype(fc)::value, i>(f, col);
      });
    });
  });
  int ox[2] = {0, 0};
  const int nx = rows ? axis_terms<NB, P>(x, S::NL, 1, ox) : 0;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    T out = gb * o[i];
    if (rows) {
      int oy[2] = {0, 0};
      const int ny = axis_terms<NB, P>(i, S::B * S::NL, N, oy);
      T corr = T(0);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (a < ny && q < nx) corr += __ldg(db + oy[a] + ox[q]);
      out += corr;
    }
    vb[i * NB + x] = out;
  }
}

template <typename T, int NB, int P>
__global__ void __launch_bounds__(Cfg2<T, NB, P>::THREADS)
brick_elasticity2_kernel(const T* __restrict__ u, const Factors<T, P> f,
                         const T* __restrict__ geo, const T* __restrict__ dcols,
                         T* __restrict__ v, T mu, T lam, int nb, int m, int N3p, int vec_u) {
  using S = Cfg2<T, NB, P>;
  constexpr int N2 = S::N2, G = S::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const X = reinterpret_cast<T*>(smem_raw);  // [G][2][4][N2R]: X_kf of each brick

  const int b0 = blockIdx.x * G;
  const int nbk = min(G, nb - b0);
  const long long cstride = static_cast<long long>(nb) * N3p;
  for (int g = 0; g < nbk; ++g)
    for (int k = 0; k < 2; ++k)
      stage(X + (8 * g + 4 * k) * S::N2R, u + k * cstride + static_cast<size_t>(b0 + g) * N3p,
            N2, vec_u);
  cp_async_commit();
  for (int g = 0; g < nbk; ++g) {  // the padding
    for (int c = 0; c < 2; ++c) {
      T* const vp = v + c * cstride + static_cast<size_t>(b0 + g) * N3p;
      for (int i = N2 + threadIdx.x; i < N3p; i += S::THREADS) vp[i] = T(0);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // thread l: input (x round) and output (y round) kc, brick g, line: kc outermost, so a warp's
  // lines share their output's code but where it straddles the two
  const int l = threadIdx.x, kc = l / (G * NB), rem = l - kc * G * NB, g = rem / NB;
  const int line = rem - g * NB;
  const bool active = l < 2 * G * NB && g < nbk;
  T* const Xg = X + 8 * (active ? g : 0) * S::N2R;
  if (active) x_line2<T, NB, P>(f, Xg, kc, line);  // input kc, line y
  __syncthreads();
  if (!active) return;
  const int brick = b0 + g;
  const bool rows = brick < m;
  T* const vb = v + kc * cstride + static_cast<size_t>(brick) * N3p;  // output kc, column x
  const T* const db = dcols + (static_cast<size_t>(kc) * m + brick) * S::DC;
  if (kc == 0) y_line2<T, NB, P, 0>(f, Xg, vb, db, line, geo[brick], mu, lam, rows);
  else y_line2<T, NB, P, 1>(f, Xg, vb, db, line, geo[brick], mu, lam, rows);
}

template <typename T, int NB, int P>
int launch2(const void* u, const double* factors, const void* geo, const void* dcols, void* v,
            double mu, double lam, int nb, int m, int N3p, int* info, cudaStream_t stream) {
  using S = Cfg2<T, NB, P>;
  const int smem = S::G * S::BRICK;
  auto kernel = brick_elasticity2_kernel<T, NB, P>;
  static unsigned long long done = 0;  // bit d: the shared-memory limit raised on device d
  const cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info) {  // a dry run: threads, shared memory and blocks per SM, launch nothing
    info[0] = S::THREADS;
    info[1] = smem;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, S::THREADS, smem));
  }
  const Factors<T, P> f = factors_from<T, P>(factors);
  // 16-byte copies need 16-byte rows; a brick's whole words stay inside its row
  const int vec_u = reinterpret_cast<uintptr_t>(u) % 16 == 0 && (N3p * sizeof(T)) % 16 == 0 &&
                    S::N2R <= N3p;
  const int groups = (nb + S::G - 1) / S::G;
  if (groups > 0) {
    kernel<<<groups, S::THREADS, smem, stream>>>(
        static_cast<const T*>(u), f, static_cast<const T*>(geo), static_cast<const T*>(dcols),
        static_cast<T*>(v), static_cast<T>(mu), static_cast<T>(lam), nb, m, N3p, vec_u);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* u, const double* factors, const void* geo, const void* dcols, void* v,
             double mu, double lam, int nb, int m, int NB, int p, int N3p, int* info, int dim,
             cudaStream_t stream) {
  // 2-D: B = 16 at p = 1..3, 8 at p = 4..6
#define EL_CASE2(nb_, p_) \
  if (dim == 2 && NB == nb_ && p == p_) \
    return launch2<T, nb_, p_>(u, factors, geo, dcols, v, mu, lam, nb, m, N3p, info, stream);
  EL_CASE2(17, 1)
  EL_CASE2(33, 2)
  EL_CASE2(49, 3)
  EL_CASE2(33, 4)
  EL_CASE2(41, 5)
  EL_CASE2(49, 6)
#undef EL_CASE2
  if (dim != 3) return static_cast<int>(cudaErrorInvalidValue);
#define EL_CASE(nb_, p_) \
  if (NB == nb_ && p == p_) \
    return launch<T, nb_, p_>(u, factors, geo, dcols, v, mu, lam, nb, m, N3p, info, stream);
  EL_CASE(17, 1)
  EL_CASE(17, 2)
  EL_CASE(13, 3)
  EL_CASE(17, 4)
  EL_CASE(11, 5)
  EL_CASE(13, 6)
  EL_CASE(15, 7)
  EL_CASE(17, 8)
#undef EL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// factors: host pointer to the float64 cell factors [4][p+1][p+1] (K1, M1, G1, G1^T) the brick
// factors are assembled from (brick_elasticity.cell_factor_tables), copied into the launch's
// parameters. info: null to launch; else [threads, shared-memory bytes, blocks per SM], not
// launched. dim: 3 (u, v [3][nb][N3p], dcols [3][m*B^3][(p+1)^3]) or 2 ([2][nb][N3p],
// [2][m*B^2][(p+1)^2]).
int brick_elasticity_f32(const void* u, const double* factors, const void* geo,
                         const void* dcols, void* v, double mu, double lam, int nb, int m,
                         int NB, int p, int N3p, int* info, int dim, void* stream) {
  return dispatch<float>(u, factors, geo, dcols, v, mu, lam, nb, m, NB, p, N3p, info, dim,
                         static_cast<cudaStream_t>(stream));
}

int brick_elasticity_f64(const void* u, const double* factors, const void* geo,
                         const void* dcols, void* v, double mu, double lam, int nb, int m,
                         int NB, int p, int N3p, int* info, int dim, void* stream) {
  return dispatch<double>(u, factors, geo, dcols, v, mu, lam, nb, m, NB, p, N3p, info, dim,
                          static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
